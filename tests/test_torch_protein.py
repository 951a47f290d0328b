"""The protein half of the port's model zoo and K9's blocked wide form
against the JAX package, float64 on the CPU.

PAML .dat parsing and EmpiricalProtein (Q, stationary vector, spectral
and chain transitions, +f) to 1e-12; `simulate_on_tree` genomes equal
to JAX's at the same seed and parameters; the plain versions of K9
blocked -- the rank update, its backward from saved children and its
backward re-gathering the children, with (K, G, A, A) transitions at
A = 20 -- against JAX's references at G = 4, at G = 5 with the +I
identity block and in the all-planes-tied case (1e-12); the card's
routing rule against JAX's `wide_rank_kernel` plus the port's 128-plane
limit; the protein+G4 and .dat+f+g4 sweeps under injected decisions
(ELBO 1e-9) and their manual-VJP gradients through the saved (K9bs) and
the re-gather (K9b) routes (1e-8 against jax.grad); and one CPU epoch of
`runner.run` for each on a small protein FASTA."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.dataio.simulate import simulate_on_tree as j_simulate
from phylo_tpu.models import empirical as jemp
from phylo_tpu.models.branches import init_branch_params as j_branches
from phylo_tpu.models.substitution import get_model as j_get_model
from phylo_tpu.pruning import kernels as jk
from phylo_tpu.smc.sweep import SweepConfig as JConfig
from phylo_tpu.smc.sweep import sample_phylogenies as j_sample
from phylo_tpu_torch.cli import runner
from phylo_tpu_torch.dataio.alphabets import PROTEIN_ALPHABET
from phylo_tpu_torch.dataio.simulate import simulate_on_tree
from phylo_tpu_torch.models import empirical as temp
from phylo_tpu_torch.models.substitution import GammaSites, get_model
from phylo_tpu_torch.params import params_from_numpy, params_to_numpy
from phylo_tpu_torch.pruning import kernels as tk
from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies

from test_empirical_protein import _synthetic_dat
from test_torch_blocked import _close, _j, _rank_case, _t
from test_torch_sweep import make_decisions, torch_decisions

torch.set_num_threads(1)


def _dat_text(seed):
    """A PAML .dat text with exchangeabilities and frequencies drawn from
    `seed` (lognormal exchangeabilities, frequencies in [0.5, 1.5]
    normalized), then a line of notes."""
    rng = np.random.default_rng(seed)
    rows = [" ".join(f"{x:.9f}" for x in rng.lognormal(0.0, 1.0, i))
            for i in range(1, 20)]
    f = rng.random(20) + 0.5
    return "\n".join(rows + ["", " ".join(f"{x:.12f}" for x in f / f.sum()),
                             "", "notes: drawn from a seed"])


@pytest.mark.parametrize("spectral,plus_f", [(True, False), (True, True),
                                             (False, False), (False, True)])
def test_empirical_protein_matches_jax(tmp_path, spectral, plus_f):
    path = tmp_path / "synth.dat"
    text = _synthetic_dat()[0] if plus_f else _dat_text(1)
    path.write_text(text)
    for got, want in zip(temp.load_paml_dat(str(path)),
                         jemp.load_paml_dat(str(path))):
        _close([got], [want])
    jm = jemp.EmpiricalProtein.from_paml(str(path), plus_f=plus_f)
    tm = temp.EmpiricalProtein.from_paml(str(path), plus_f=plus_f)
    jm.spectral = tm.spectral = spectral
    assert tm.name == jm.name == "synth" and tm.A == 20
    init_j = jm.init_params(jnp.float64)
    init_t = tm.init_params(torch.float64)
    assert sorted(init_t) == sorted(init_j)
    for k in init_j:
        _close([init_t[k]], [init_j[k]])
    rng = np.random.default_rng(2)
    tree = {k: np.asarray(v) + 0.2 * rng.normal(size=np.shape(v))
            for k, v in init_j.items()}
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    tp = {k: torch.tensor(v) for k, v in tree.items()}
    b = rng.exponential(0.2, (2, 3))
    _close([tm.Q(tp), tm.stationary(tp),
            tm.transition(tp, torch.tensor(b))],
           [jm.Q(jp), jm.stationary(jp), jm.transition(jp, jnp.asarray(b))])


def test_paml_dat_errors_match_jax(tmp_path):
    text = _dat_text(3)
    bad_freqs = text.replace("\n\n", "\n\n2.0 ", 1)      # sums far from 1
    cases = [str(tmp_path / "missing.dat"), "1.0 2.0\n3.0",
             text.split("\n\n")[0] + "\nx 1.0", bad_freqs]
    for src in cases:
        with pytest.raises(Exception) as want:
            jemp.load_paml_dat(src)
        with pytest.raises(want.type, match=re.escape(str(want.value)[:30])):
            temp.load_paml_dat(src)


def test_spec_parser_resolves_dat_bases(tmp_path):
    path = tmp_path / "lg.dat"
    path.write_text(_dat_text(4))
    m = get_model(f"{path}+f+g4", A=20)
    assert isinstance(m, GammaSites) and m.blocks == (4, 20)
    assert isinstance(m.base, temp.EmpiricalProtein) and m.base.plus_f
    jm = j_get_model(f"{path}+f+g4", A=20)
    assert m.base._exch == jm.base._exch and m.base._freqs == jm.base._freqs
    assert not get_model(str(path)).plus_f


def _random_record(rng, N):
    """A random rooted binary tree over N leaves as a merge record."""
    active = list(range(N))
    merges = []
    for q in range(N - 1):
        i, j = rng.choice(len(active), 2, replace=False)
        merges.append((active[i], active[j]))
        active = [x for x in active if x not in merges[-1]] + [N + q]
    return {"merges": np.asarray(merges),
            "branches": rng.exponential(0.2, (N - 1, 2))}


@pytest.mark.parametrize("kind", ["empirical", "reference"])
def test_simulate_on_tree_matches_jax(kind):
    rng = np.random.default_rng(5)
    record = _random_record(rng, 6)
    if kind == "empirical":
        exch, freqs = temp.load_paml_dat(_dat_text(6))
        jm = jemp.EmpiricalProtein(exch, freqs)
        tm = temp.EmpiricalProtein(exch, freqs)
        tree = {}
    else:
        jm = j_get_model("reference", A=20)
        tm = get_model("reference", A=20)
        tree = jax.tree.map(lambda x: np.asarray(x) + 0.2 * rng.normal(
            size=np.shape(x)), jm.init_params(jnp.float64))
    want = j_simulate(record, jm, {"model": jax.tree.map(jnp.asarray, tree)},
                      30, seed=7)
    got = simulate_on_tree(record, tm, params_from_numpy({"model": tree}),
                           30, seed=7)
    assert got.name == want.name and got.taxa == want.taxa
    np.testing.assert_array_equal(got.genome, want.genome)
    assert got.genome.shape == (6, 30, tm.A)


@pytest.mark.parametrize("G,ties", [(4, None), (5, "rate0"), (4, "max")])
def test_blocked_wide_refs_match_jax(G, ties):
    """K9f blocked (saving the children), K9bs blocked and K9b blocked
    plain versions against JAX's references at A = 20; K9b's equals
    K9bs's on the same children; dP keeps the (K, G, A, A) shape."""
    c = _rank_case(G, 20, seed=70 + G, K=4, S=16, ties=ties)
    t, j = _t(c), _j(c)
    want = jax.jit(jk._fused_rank_ref, static_argnames="save_children")(
        j["leaves"], j["buf"], j["idx"], jnp.asarray([c["outc"]]), j["P_l"],
        j["P_r"], j["pi"], j["w"], save_children=True)
    buf = t["buf"].clone()
    got = tk._fused_rank_ref(t["leaves"], buf, t["idx"], c["outc"],
                             t["P_l"], t["P_r"], t["pi"], t["w"],
                             save_children=True)
    _close([buf] + list(got), want)
    cts = ("gm", "gr", "gl", "P_l", "P_r", "pi", "w")
    want_b = jax.jit(jk._fused_rank_bwd_ref)(j["leaves"], j["buf"], j["idx"],
                                             *(j[k] for k in cts))
    got_b = tk._fused_rank_bwd_ref(t["leaves"], t["buf"], t["idx"],
                                   *(t[k] for k in cts))
    _close(got_b, want_b)
    m1, m2 = got[2], got[3]
    got_s = tk._fused_rank_bwd_saved_ref(m1, m2, *(t[k] for k in cts))
    _close(got_s, jax.jit(jk._fused_rank_bwd_saved_ref)(
        jnp.asarray(m1.numpy()), jnp.asarray(m2.numpy()),
        *(j[k] for k in cts)))
    for a, b in zip(got_b, got_s):
        assert torch.equal(a, b)
    assert got_s[2].shape == (4, G, 20, 20)
    if ties == "max":
        # at every site the A planes of the block holding the max tie
        assert torch.all((buf[:, c["outc"]] == 1.0).sum(dim=1) >= 20)


def test_blocked_wide_routing():
    """A > 8 takes K9 (JAX's rule: G A^2 > 64), dense or blocked, up to
    128 states a block and 32 blocks (in block groups where one does not
    fit: GY94 + Gamma4's 244 planes included); blocked A <= 8 stays on K10
    (G <= 32); more blocks or wider ones raise, naming the ROADMAP."""
    for G in range(1, 9):
        for A in range(1, 65):
            P = torch.zeros((2, G, A, A) if G > 1 else (2, A, A))
            wide = tk.wide_rank(P, G * A)
            assert wide == (A > 8)
            if A > 8:
                assert jk.wide_rank_kernel(G, A)
    assert tk.wide_rank(torch.zeros((2, 4, 20, 20)), 80)
    assert tk.wide_planes(4, 61, blocked=True)
    assert tk.wide_planes(8, 20, blocked=True)
    for G, A in ((33, 20), (4, 129), (1, 129)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tk.wide_planes(G, A, blocked=G > 1)


# ------------------------------------------------------------- the sweep
def _protein_genome(seed, N=5, S=16):
    rng = np.random.default_rng(seed)
    g = np.eye(20)[rng.integers(0, 20, (N, S))]
    g[0, :2] = 1.0                                 # missing residues
    return g


@functools.lru_cache(maxsize=None)
def _jax_case(spec_kind):
    genome = _protein_genome(80)
    N = genome.shape[0]
    K = 4
    rng = np.random.default_rng(81)
    spec = "reference+g4"
    if spec_kind == "dat":
        import os
        import tempfile

        path = os.path.join(tempfile.mkdtemp(), "prot.dat")
        with open(path, "w") as f:
            f.write(_dat_text(82))
        spec = f"{path}+f+g4"
    jmodel = j_get_model(spec, A=20)
    tree = jax.tree.map(np.asarray, {
        "model": jmodel.init_params(jnp.float64),
        "branches": j_branches(N, dtype=jnp.float64)})
    tree = jax.tree.map(lambda x: x + rng.normal(0.0, 0.3, np.shape(x)),
                        tree)
    dec = make_decisions(rng, N, K, np.exp(tree["branches"]["log_rates_l"]),
                         np.exp(tree["branches"]["log_rates_r"]))
    leaves = jnp.asarray(jmodel.expand_leaves(genome))

    def elbo(p):
        # JAX's dense-merge route (blocked_merge=False) computes the same
        # function as its default blocked one (to 2e-16 here) without
        # tracing the A^2 multiply-adds its blocked contraction unrolls
        # in Python (16 s to compile at A = 20 against 3)
        return j_sample(jax.random.PRNGKey(0), leaves, jmodel, p,
                        JConfig(K=K, blocked_merge=False),
                        decisions=jax.tree.map(jnp.asarray, dec)).elbo

    val, grad = jax.jit(jax.value_and_grad(elbo))(
        jax.tree.map(jnp.asarray, tree))
    return (spec, genome, tree, dec, K, float(val),
            jax.tree.map(np.asarray, grad))


@pytest.mark.parametrize("route", ["saved", "regather"])
@pytest.mark.parametrize("spec_kind", ["reference", "dat"])
def test_protein_sweep_and_gradients_match_jax(spec_kind, route,
                                               monkeypatch):
    """ELBO to 1e-9 and every gradient (alpha, the base model's
    parameters, branch rates) to 1e-8 through K9bs blocked's plain
    version (children saved) and K9b blocked's (SAVE_CHILDREN_CAP forced
    to 0); the .dat model's spectral transitions take the gradient's
    scale as a floor, as in tests/test_torch_wide.py."""
    spec, genome, tree, dec, K, want_elbo, want_grad = _jax_case(spec_kind)
    if route == "regather":
        monkeypatch.setattr(tk, "SAVE_CHILDREN_CAP", 0)
    calls = {"saved": 0, "regather": 0}
    for name, key in (("fused_rank_bwd_saved", "saved"),
                      ("fused_rank_bwd", "regather")):
        fn = getattr(tk, name)

        def counted(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)
        monkeypatch.setattr(f"phylo_tpu_torch.smc.sweep_vjp.{name}", counted)
    model = get_model(spec, A=20)
    params = params_from_numpy(tree)
    res = sample_phylogenies(None, torch.tensor(model.expand_leaves(genome)),
                             model, params, SweepConfig(K=K),
                             decisions=torch_decisions(dec))
    np.testing.assert_allclose(float(res.elbo.detach()), want_elbo,
                               rtol=1e-9)
    res.elbo.backward()
    R = genome.shape[0] - 1
    assert calls == {"saved": R * (route == "saved"),
                     "regather": R * (route == "regather")}
    got = params_to_numpy(jax.tree.map(lambda t: t.grad, params,
                                       is_leaf=torch.is_tensor))
    floor = 1e-8 if spec_kind == "dat" else 1e-12
    for path, w in jax.tree_util.tree_leaves_with_path(want_grad):
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g, w, rtol=1e-8,
                                   atol=floor * max(1.0, np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))
        assert np.any(g != 0.0), jax.tree_util.keystr(path)


@pytest.mark.parametrize("dat", [False, True])
def test_runner_trains_protein_gamma_on_cpu(tmp_path, dat):
    """One epoch through runner.run on the CPU on a protein FASTA: the
    alignment reaches ReferenceQ(A=20) (or the .dat model with +F) under
    GammaSites G=4, and every gradient is finite and non-zero."""
    rng = np.random.default_rng(83)
    fasta = tmp_path / "prot.fa"
    seqs = ["".join(rng.choice(list(PROTEIN_ALPHABET), 12)) for _ in range(5)]
    fasta.write_text("".join(f">t{i}\n{s}\n" for i, s in enumerate(seqs)))
    argv = [f"--dataset={fasta}", "--gamma_categories=4", "--n_particles=4",
            "--batch_size=6", "--num_epoch=1", "--no_artifacts",
            "--device=cpu"]
    if dat:
        path = tmp_path / "prot.dat"
        path.write_text(_dat_text(84))
        argv += [f"--paml_dat={path}", "--plus_f=True"]
    res = runner.run(argv)
    assert np.isfinite(res.elbo)
    base = res.params["model"]["base"]
    assert sorted(base) == (["y_station"] if dat else ["y_q", "y_station"])
    assert res.history["Qmatrices"][-1].shape == (80, 80)
    for group in ("model", "branches"):
        for t in jax.tree.leaves(res.params[group]):
            assert t.grad is not None and bool(torch.isfinite(t.grad).all())
            assert bool((t.grad != 0).any())


def test_paml_dat_checks_match_jax(tmp_path):
    """JAX's init_params checks: a .dat model on a DNA alignment, and a
    rate mixture given both in the spec and by the flags."""
    path = tmp_path / "prot.dat"
    path.write_text(_dat_text(85))
    base = ["--dataset=load_strings", "--n_particles=4", "--num_epoch=1",
            "--no_artifacts", "--device=cpu"]
    with pytest.raises(ValueError, match="A=20 states but the dataset"):
        runner.run(base + [f"--paml_dat={path}"])
    with pytest.raises(ValueError, match="already includes"):
        runner.run(base + [f"--model={path}+g4", "--gamma_categories=4"])
