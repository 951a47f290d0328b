"""The wide (dense A > 8) rank path of the port against the JAX package,
float64 on the CPU.

The plain versions of K9's three kernels -- the rank update, its
backward from saved children and its backward re-gathering the children
-- against JAX's references `_fused_rank_ref`, `_fused_rank_bwd_saved_ref`
and `_fused_rank_bwd_ref` at A = 16 and 61 (1e-12), the all-planes-tied
case included; the routing rule against JAX's `wide_rank_kernel`; the
GY94+F codon sweep under injected decisions (ELBO 1e-9) and its
manual-VJP gradients (1e-8 against jax.grad) through the saved and the
re-gather routes and through plain autograd; and one CPU epoch of
`runner.run(["--codons=True", ...])` on a small FASTA alignment."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.models.branches import init_branch_params as j_branches
from phylo_tpu.models.codon import GY94 as JGY94
from phylo_tpu.pruning import kernels as jk
from phylo_tpu.smc.sweep import SweepConfig as JConfig
from phylo_tpu.smc.sweep import sample_phylogenies as j_sample
from phylo_tpu_torch.cli import runner
from phylo_tpu_torch.dataio.codons import empirical_codon_frequencies
from phylo_tpu_torch.models.codon import GY94
from phylo_tpu_torch.params import params_from_numpy, params_to_numpy
from phylo_tpu_torch.pruning import kernels as tk
from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies

from test_torch_blocked import _close, _j, _rank_case, _t
from test_torch_sweep import make_decisions, torch_decisions

torch.set_num_threads(1)


def _dense_case(A, seed, ties=None):
    c = _rank_case(1, A, seed, K=4, S=24, ties=ties)
    c["P_l"], c["P_r"] = c["P_l"][:, 0], c["P_r"][:, 0]
    return c


@pytest.mark.parametrize("A,ties", [(16, None), (61, None), (61, "max")])
def test_wide_refs_match_jax(A, ties):
    """K9f (saving the children), K9bs and K9b plain versions against
    JAX's references; K9b's equals K9bs's on the same children."""
    c = _dense_case(A, seed=50 + A, ties=ties)
    t, j = _t(c), _j(c)
    want = jk._fused_rank_ref(j["leaves"], j["buf"], j["idx"],
                              jnp.asarray([c["outc"]]), j["P_l"], j["P_r"],
                              j["pi"], j["w"], save_children=True)
    buf = t["buf"].clone()
    got = tk._fused_rank_ref(t["leaves"], buf, t["idx"], c["outc"],
                             t["P_l"], t["P_r"], t["pi"], t["w"],
                             save_children=True)
    _close([buf] + list(got), want)
    cts = ("gm", "gr", "gl", "P_l", "P_r", "pi", "w")
    want_b = jk._fused_rank_bwd_ref(j["leaves"], j["buf"], j["idx"],
                                    *(j[k] for k in cts))
    got_b = tk._fused_rank_bwd_ref(t["leaves"], t["buf"], t["idx"],
                                   *(t[k] for k in cts))
    _close(got_b, want_b)
    m1, m2 = got[2], got[3]
    want_s = jk._fused_rank_bwd_saved_ref(
        jnp.asarray(m1.numpy()), jnp.asarray(m2.numpy()),
        *(j[k] for k in cts))
    got_s = tk._fused_rank_bwd_saved_ref(m1, m2, *(t[k] for k in cts))
    _close(got_s, want_s)
    for a, b in zip(got_b, got_s):
        assert torch.equal(a, b)
    if ties == "max":
        # every plane ties at every site's max
        w = tk._ref_impl(m1, m2, t["P_l"], t["P_r"], t["pi"], t["w"])[0]
        assert torch.all(w == 1.0)


def test_wide_routing_matches_jax_rule():
    for A in range(1, 129):
        P = torch.zeros((2, A, A))
        assert tk.wide_rank(P, A) == jk.wide_rank_kernel(1, A)
    assert not tk.wide_rank(torch.zeros((2, 5, 4, 4)), 20)
    # GY94 + Gamma4 (4 blocks of 61): the wide kernels in block groups
    assert tk.wide_rank(torch.zeros((2, 4, 61, 61)), 244)
    with pytest.raises(NotImplementedError, match="K9 blocked"):
        tk.wide_rank(torch.zeros((2, 33, 9, 9)), 297)
    with pytest.raises(NotImplementedError, match="at most 128 states"):
        tk.wide_rank(torch.zeros((2, 129, 129)), 129)


# ------------------------------------------------------------- the sweep
def _codon_genome(seed, N=5, S=12):
    rng = np.random.default_rng(seed)
    g = np.eye(61)[rng.integers(0, 61, (N, S))]
    g[0, :2] = 1.0                                 # missing codons
    g[1, 3, rng.integers(0, 61, 3)] = 1.0          # an ambiguous codon
    return g


@functools.lru_cache(maxsize=None)
def _jax_case():
    genome = _codon_genome(60)
    N = genome.shape[0]
    K = 4
    rng = np.random.default_rng(61)
    freqs = empirical_codon_frequencies(genome)
    jmodel = JGY94(freqs, plus_f=True)
    tree = jax.tree.map(np.asarray, {
        "model": jmodel.init_params(jnp.float64),
        "branches": j_branches(N, dtype=jnp.float64)})
    tree = jax.tree.map(lambda x: x + rng.normal(0.0, 0.3, np.shape(x)),
                        tree)
    dec = make_decisions(rng, N, K, np.exp(tree["branches"]["log_rates_l"]),
                         np.exp(tree["branches"]["log_rates_r"]))

    def elbo(p):
        return j_sample(jax.random.PRNGKey(0), jnp.asarray(genome), jmodel,
                        p, JConfig(K=K),
                        decisions=jax.tree.map(jnp.asarray, dec)).elbo

    val, grad = jax.jit(jax.value_and_grad(elbo))(
        jax.tree.map(jnp.asarray, tree))
    return (genome, freqs, tree, dec, K, float(val),
            jax.tree.map(np.asarray, grad))


@pytest.mark.parametrize("route", ["saved", "regather", "autograd"])
def test_gy94_sweep_and_gradients_match_jax(route, monkeypatch):
    """ELBO to 1e-9 and every gradient (log_kappa, log_omega, y_station,
    branch rates) to 1e-8: the manual VJP through K9bs's plain version
    (children saved), through K9b's (SAVE_CHILDREN_CAP forced to 0), and
    plain autograd (manual_vjp=False, whose wide merge is plain torch)."""
    genome, freqs, tree, dec, K, want_elbo, want_grad = _jax_case()
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
    model = GY94(freqs, plus_f=True)
    params = params_from_numpy(tree)
    res = sample_phylogenies(
        None, torch.tensor(genome), model, params,
        SweepConfig(K=K, manual_vjp=route != "autograd"),
        decisions=torch_decisions(dec))
    np.testing.assert_allclose(float(res.elbo.detach()), want_elbo,
                               rtol=1e-9)
    res.elbo.backward()
    R = genome.shape[0] - 1
    assert calls == {"saved": R * (route == "saved"),
                     "regather": R * (route == "regather")}
    got = params_to_numpy(jax.tree.map(lambda t: t.grad, params,
                                       is_leaf=torch.is_tensor))
    for path, w in jax.tree_util.tree_leaves_with_path(want_grad):
        g = got
        for p in path:
            g = g[p.key]
        # relative to each gradient's scale: the spectral transitions'
        # float64 rounding (entries near 1e-4 reconstructed from O(1)
        # eigen-sums) moves every gradient by ~1e-9 of its largest entry,
        # manual VJP against the port's own autograd too
        np.testing.assert_allclose(g, w, rtol=1e-8,
                                   atol=1e-8 * max(1.0, np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))
        assert np.any(g != 0.0), jax.tree_util.keystr(path)


def test_runner_trains_gy94_on_codons_on_cpu(tmp_path):
    """One epoch of `--codons=True` through runner.run on the CPU: the
    model defaults to GY94 with the alignment's F61 frequencies, and
    every gradient is finite and non-zero."""
    rng = np.random.default_rng(62)
    fasta = tmp_path / "codons.fa"
    seqs = ["".join(rng.choice(list("ACGT"), 24)) for _ in range(5)]
    fasta.write_text("".join(f">t{i}\n{s}\n" for i, s in enumerate(seqs)))
    res = runner.run([f"--dataset={fasta}", "--codons=True",
                      "--n_particles=4", "--batch_size=4", "--num_epoch=1",
                      "--no_artifacts", "--device=cpu"])
    assert np.isfinite(res.elbo)
    assert sorted(res.params["model"]) == ["log_kappa", "log_omega"]
    for group in ("model", "branches"):
        for name, t in res.params[group].items():
            assert t.grad is not None and bool(torch.isfinite(t.grad).all())
            assert bool((t.grad != 0).any()), name


def test_gy94_needs_a_codon_dataset():
    with pytest.raises(ValueError, match="codon-encoded"):
        runner.run(["--dataset=load_strings", "--model=gy94",
                    "--n_particles=4", "--num_epoch=1", "--no_artifacts",
                    "--device=cpu"])
