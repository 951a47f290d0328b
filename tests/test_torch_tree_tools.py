"""The port's tree tools against the JAX package's (float64, CPU):
Newick parsing, fixed-tree scores and their gradients, the Adam fits,
ancestral marginals, neighbour-joining, model selection, bootstrap
supports, the CSMC oracle at a fixed seed, and the four CLIs."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.models import substitution as jsub
from phylo_tpu.pruning import ancestral as janc
from phylo_tpu.pruning import fixed_tree as jft
from phylo_tpu.search import nj as jnj
from phylo_tpu.smc.csmc import CSMC as JCSMC
from phylo_tpu.viz import trees as jtrees
from phylo_tpu_torch.models.substitution import get_model
from phylo_tpu_torch.params import params_from_numpy
from phylo_tpu_torch.pruning import ancestral, fixed_tree
from phylo_tpu_torch.search import nj
from phylo_tpu_torch.smc.csmc import CSMC

torch.set_num_threads(1)

NWK = "((S0:0.11,S1:0.07):0.3,((S2:0.05,S3:0.21):0.09,S4:0.4):0.06);"
TAXA = [f"S{i}" for i in range(5)]


def genome(seed, N, S, A=4):
    rng = np.random.default_rng(seed)
    g = np.eye(A)[rng.integers(0, A, (N, S))]
    g[0, :3] = 1.0                                # a few missing sites
    g[2, 5] = [0.5, 0.5, 0.0, 0.0]                # an ambiguity code
    return g


def case(spec, seed=3, N=5, S=48):
    """(JAX model, port model, leaves (N, S, A'), numpy model params moved
    off their symmetric start)."""
    jm = jsub.get_model(spec, A=4)
    tm = get_model(spec, A=4)
    g = genome(seed, N, S)
    if hasattr(jm, "expand_leaves"):
        g = np.asarray(jm.expand_leaves(g))
    rng = np.random.default_rng(seed + 1)
    p = jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.3, np.shape(a)),
                     jm.init_params(jnp.float64))
    return jm, tm, g, p


def port_params(p, requires_grad=False):
    return {"model": params_from_numpy({"model": p},
                                       requires_grad=requires_grad)["model"]}


def leaves_of(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves_of(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def assert_trees_close(got, want, rtol):
    want = leaves_of(want)
    got = leaves_of(got)
    assert got.keys() == want.keys()
    for k in want:
        g = got[k].detach().numpy() if isinstance(got[k], torch.Tensor) \
            else np.asarray(got[k])
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=rtol,
                                   atol=rtol * 1e-2, err_msg=k)


@pytest.mark.parametrize("text,kw", [
    (NWK, {}),
    ("((A:0.1,B:0.2):0.05,(C:0.1,D:0.3));", {"taxa": ["D", "C", "B", "A"]}),
    ("(('x y':1,B:2):3,\n  (C:4, D:5)inner:6);", {}),
    ("((A,B),(C,D));", {}),
    ("((A:-0.1,B:0.2):0.05,C:0.1);", {"clamp_negative": True}),
    ("(A:1,B:1,C:1);", {}),
    ("((A:1,B:1):1,(C:1,A:1):1);", {}),
])
def test_parse_newick_equal_records(text, kw):
    try:
        want = jft.parse_newick(text, **kw)
    except ValueError as e:
        with pytest.raises(ValueError,
                           match=re.escape(str(e).split("\n")[0][:30])):
            fixed_tree.parse_newick(text, **kw)
        return
    got = fixed_tree.parse_newick(text, **kw)
    assert got[0] == want[0]
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k])
        assert got[1][k].dtype == want[1][k].dtype


_JAX_LL = {}


def jax_value_and_grad(spec):
    """jax.value_and_grad of JAX's tree_log_likelihood in (model params,
    branches), jitted once per spec with the site weights an argument
    (all ones scores as no weights: multiplying by 1.0 is exact)."""
    if spec not in _JAX_LL:
        jm = case(spec)[0]
        _, rec = jft.parse_newick(NWK, taxa=TAXA)

        def jll(mp, b, g, w):
            return jft.tree_log_likelihood(g, jm, {"model": mp}, rec,
                                           branches=b, site_weights=w)

        _JAX_LL[spec] = jax.jit(jax.value_and_grad(jll, argnums=(0, 1)))
    return _JAX_LL[spec]


@pytest.mark.parametrize("spec", ["jc69", "gtr", "gtr+g4"])
@pytest.mark.parametrize("weighted", [False, True])
def test_tree_log_likelihood_and_gradients_match_jax(spec, weighted):
    jm, tm, g, p = case(spec)
    _, rec = jft.parse_newick(NWK, taxa=TAXA)
    w = (np.random.default_rng(5).integers(0, 3, g.shape[1]).astype(float)
         if weighted else None)
    want, (want_p, want_b) = jax_value_and_grad(spec)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(rec["branches"]),
        jnp.asarray(g), jnp.ones(g.shape[1]) if w is None else jnp.asarray(w))
    params = port_params(p, requires_grad=True)
    b = torch.tensor(rec["branches"], requires_grad=True)
    got = fixed_tree.tree_log_likelihood(
        torch.tensor(g), tm, params, rec, branches=b,
        site_weights=None if w is None else torch.tensor(w))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-10)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want_b),
                               rtol=1e-10, atol=1e-12)
    assert_trees_close({k: t.grad for k, t in leaves_of(
        params["model"]).items()}, leaves_of(want_p), 1e-10)
    # the record's own lengths give the same value without branches=
    again = fixed_tree.tree_log_likelihood(torch.tensor(g), tm, params, rec,
                                           site_weights=None if w is None
                                           else torch.tensor(w))
    assert again.item() == got.item()


def test_optimize_tree_and_branch_lengths_match_jax():
    """5 Adam steps (the joint fit under GTR, lengths alone under JC69):
    torch.optim.Adam(lr, eps=1e-8) is optax.adam's update."""
    jm, tm, g, p = case("gtr")
    _, rec = jft.parse_newick(NWK, taxa=TAXA)
    rec = dict(rec, branches=rec["branches"] * [[1.0, 0.0]] + 0.2)
    jp, jb, jll = jft.optimize_tree(jnp.asarray(g), jm,
                                    {"model": jax.tree.map(jnp.asarray, p)},
                                    rec, steps=5, learning_rate=0.1)
    tp, tb, tll = fixed_tree.optimize_tree(torch.tensor(g), tm,
                                           port_params(p), rec, steps=5,
                                           learning_rate=0.1)
    np.testing.assert_allclose(float(tll), float(jll), rtol=1e-8)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-8)
    assert_trees_close(tp["model"], jax.tree.map(np.asarray, jp["model"]),
                       1e-8)
    jm, tm, g, p = case("jc69")
    jb2, jll2 = jft.optimize_branch_lengths(
        jnp.asarray(g), jm, {"model": {}}, rec, steps=5, learning_rate=0.1)
    tb2, tll2 = fixed_tree.optimize_branch_lengths(
        torch.tensor(g), tm, {"model": {}}, rec, steps=5, learning_rate=0.1)
    np.testing.assert_allclose(float(tll2), float(jll2), rtol=1e-8)
    np.testing.assert_allclose(tb2.numpy(), np.asarray(jb2), rtol=1e-8)
    assert float(tll2) > float(fixed_tree.tree_log_likelihood(
        torch.tensor(g), tm, {"model": {}}, rec))


@pytest.mark.parametrize("spec", ["gtr", "gtr+g4"])
def test_ancestral_marginals_match_jax(spec):
    jm, tm, g, p = case(spec, S=20)
    _, rec = jft.parse_newick(NWK, taxa=TAXA)
    want, want_ll = jax.jit(lambda mp: janc.ancestral_marginals(
        jnp.asarray(g), jm, {"model": mp}, rec))(
            jax.tree.map(jnp.asarray, p))
    got, ll = ancestral.ancestral_marginals(torch.tensor(g), tm,
                                            port_params(p), rec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(float(ll), float(want_ll), rtol=1e-10)
    if spec == "gtr+g4":
        for a, b in zip(ancestral.collapse_categories(got, 4),
                        janc.collapse_categories(want, 4)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-10, atol=1e-14)
        got = ancestral.collapse_categories(got, 4)[0]
        want = janc.collapse_categories(want, 4)[0]
    assert ancestral.decode_states(got) == janc.decode_states(want)


def test_nj_equal_to_jax():
    g = genome(7, 8, 60)
    g[3, 10:14] = 1.0                             # gaps
    w = np.random.default_rng(8).integers(0, 3, 60).astype(float)
    for sw in (None, w):
        for fn in ("p_distance_matrix", "jc_distance_matrix"):
            np.testing.assert_array_equal(
                getattr(nj, fn)(g, site_weights=sw),
                getattr(jnj, fn)(g, site_weights=sw))
    D = nj.jc_distance_matrix(g)
    for clamp in (True, False):
        got = nj.neighbor_joining(D, clamp_negative=clamp)
        want = jnj.neighbor_joining(D, clamp_negative=clamp)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_select_model_matches_jax():
    from phylo_tpu.models.selection import select_model as jselect
    from phylo_tpu_torch.models.selection import (
        n_free_parameters,
        select_model,
    )

    g = genome(9, 5, 40)
    cands = ["jc69", "jc69+i", "hky"]
    want = jselect(g, candidates=cands, steps=10, learning_rate=0.1)
    got = select_model(g, candidates=cands, steps=10, learning_rate=0.1,
                       device="cpu")
    assert [f.spec for f in got] == [f.spec for f in want]
    for a, b in zip(got, want):
        assert (a.k_model, a.k_branches, a.n_sites) == (
            b.k_model, b.k_branches, b.n_sites)
        for key in ("log_likelihood", "aic", "aicc", "bic"):
            np.testing.assert_allclose(getattr(a, key), getattr(b, key),
                                       rtol=1e-8, err_msg=key)
        np.testing.assert_allclose(a.branches, b.branches, rtol=1e-8)
    for spec in ("jc69", "hky", "gtr", "reference", "jc69+g4+i",
                 "gtr+g4", "jc69+r3"):
        from phylo_tpu.models.selection import n_free_parameters as jn

        assert n_free_parameters(get_model(spec)) == jn(
            jsub.get_model(spec, A=4))


def seeded_sweep(N, K, seed):
    """A valid (ancestors, merged_nodes, log_w) of a sweep: each
    particle's forest resampled and merged rank by rank."""
    rng = np.random.default_rng(seed)
    R = N - 1
    ancestors = np.zeros((R, K), dtype=np.int32)
    merged = np.zeros((R, K, 2), dtype=np.int32)
    roots = [list(range(N)) for _ in range(K)]
    for r in range(R):
        idx = np.arange(K) if r == 0 else rng.integers(0, K, K)
        ancestors[r] = idx
        roots = [list(roots[i]) for i in idx]
        for k in range(K):
            i, j = sorted(rng.choice(len(roots[k]), 2, replace=False))
            merged[r, k] = roots[k][i], roots[k][j]
            roots[k] = [x for x in roots[k] if x not in merged[r, k]] + [
                N + r]
    return ancestors, merged, rng.normal(0, 2.0, K)


@pytest.mark.parametrize("map_tree", [False, True])
def test_bootstrap_supports_equal_jax_helpers(map_tree):
    """One replicate's supports and the consensus built from them are
    those of the JAX package's estimator (its _clade_sets over the
    decoded particles, consensus_from_supports)."""
    from phylo_tpu_torch.smc.bootstrap import replicate_supports
    from phylo_tpu_torch.viz.trees import consensus_from_supports

    N, K = 5, 12
    ancestors, merged, log_w = seeded_sweep(N, K, 3)
    want = {}
    w = np.exp(log_w - log_w.max())
    w = w / w.sum()
    if map_tree:
        w = np.eye(K)[int(log_w.argmax())]
    for k, rec in enumerate(jtrees.decode_genealogy(ancestors, merged)):
        if w[k] == 0.0:
            continue
        for clade, _ in set(jtrees._clade_sets(TAXA, rec)):
            want[clade] = want.get(clade, 0.0) + w[k]
    got = replicate_supports(TAXA, ancestors, merged, log_w,
                             map_tree=map_tree)
    assert got == want
    assert consensus_from_supports(TAXA, got) == \
        jtrees.consensus_from_supports(TAXA, want)


def _signal_case(S):
    from phylo_tpu_torch.dataio.simulate import simulate_on_tree
    from phylo_tpu_torch.models.branches import init_branch_params

    taxa, rec = fixed_tree.parse_newick(
        "((A:0.06,B:0.06):0.30,(C:0.06,D:0.06):0.30);")
    m = get_model("jc69")
    ds = simulate_on_tree(rec, m, {"model": {}}, S, seed=4, taxa=taxa)
    params = {"model": {},
              "branches": init_branch_params(ds.N, dtype=torch.float64)}
    return taxa, ds, m, params, torch.tensor(np.asarray(ds.genome))


def test_bootstrap_recovers_true_clades_and_repeats():
    from phylo_tpu_torch.smc.bootstrap import bootstrap_supports
    from phylo_tpu_torch.smc.sweep import SweepConfig

    taxa, ds, m, params, leaves = _signal_case(160)
    res = bootstrap_supports(0, leaves, m, params, SweepConfig(K=16),
                             n_replicates=8, taxa=taxa)
    assert res.counts.shape == (8, ds.S)
    np.testing.assert_array_equal(res.counts.sum(axis=1), ds.S)
    assert np.isfinite(res.elbos).all()
    for c, s in res.supports.items():
        assert 0.0 <= s <= 1.0 + 1e-12, (c, s)
    ab = res.supports.get(frozenset({"A", "B"}), 0.0)
    cd = res.supports.get(frozenset({"C", "D"}), 0.0)
    assert ab > 0.7 and cd > 0.7, (ab, cd)
    assert "(A,B)" in res.consensus and res.consensus.endswith(";")
    again = bootstrap_supports(0, leaves, m, params, SweepConfig(K=16),
                               n_replicates=8, taxa=taxa)
    assert again.supports == res.supports
    np.testing.assert_array_equal(again.elbos, res.elbos)
    other = bootstrap_supports(1, leaves, m, params, SweepConfig(K=16),
                               n_replicates=8, taxa=taxa)
    assert not np.array_equal(other.counts, res.counts)
    one = bootstrap_supports(0, leaves, m, params, SweepConfig(K=16),
                             n_replicates=8, taxa=taxa, map_tree=True)
    assert all(abs(s * 8 - round(s * 8)) < 1e-9
               for s in one.supports.values())


@pytest.mark.parametrize("resampling", [False, True])
@pytest.mark.parametrize("data", ["strings", "random"])
def test_csmc_equals_jax_at_a_seed(resampling, data):
    from phylo_tpu.dataio import dataset_from_strings

    if data == "strings":
        ds = dataset_from_strings(["ACTTTGAGAG", "ACTTTGACAG", "ACTTTGACTG",
                                   "ACTTTGACTC", "ACTTCGACTG"])
        d = {"taxa": ds.taxa, "genome": np.asarray(ds.genome)}
    else:
        d = {"taxa": TAXA, "genome": genome(11, 5, 30)}
    want = JCSMC(d, seed=4).sample_phylogenies(K=9, resampling=resampling)
    got = CSMC(d, seed=4, device="cpu").sample_phylogenies(
        K=9, resampling=resampling)
    for k in ("merged_nodes", "ancestors"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["log_weights"], want["log_weights"],
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got["norm"], want["norm"], rtol=1e-10)
    assert [k for _, k in got["tree_probabilities"]] == [
        k for _, k in want["tree_probabilities"]]
    np.testing.assert_allclose([p for p, _ in got["tree_probabilities"]],
                               [p for p, _ in want["tree_probabilities"]],
                               rtol=1e-10)
    with pytest.raises(ValueError, match="A=4"):
        CSMC(d, Q=np.eye(6), device="cpu")


def test_cli_score_tree_and_model_select(tmp_path, capsys):
    from phylo_tpu_torch.cli import model_select, score_tree
    from phylo_tpu_torch.dataio import load_dataset

    best = model_select.main(["--dataset=primates_small",
                              "--candidates=jc69,hky", "--steps=5",
                              f"--out={tmp_path}/best.nwk", "--device=cpu"])
    assert best in ("jc69", "hky")
    assert "ranking by BIC" in capsys.readouterr().out
    ll = score_tree.main(["--dataset=primates_small", "--model=gtr+g4",
                          f"--newick={tmp_path}/best.nwk", "--device=cpu"])
    ds = load_dataset("primates_small")
    taxa, rec = fixed_tree.parse_newick(open(tmp_path / "best.nwk").read(),
                                        taxa=list(ds.taxa))
    m = get_model("gtr+g4")
    want = fixed_tree.tree_log_likelihood(
        torch.tensor(m.expand_leaves(ds.genome)), m,
        {"model": m.init_params(torch.float64)}, rec)
    assert ll == want.item()
    ll_nni = score_tree.main([
        "--dataset=primates_small", "--model=jc69",
        f"--newick={tmp_path}/best.nwk", "--nni", "--nni_iters=1",
        "--nni_branch_steps=1", "--optimize_branches", "--steps=2",
        f"--ancestral={tmp_path}/anc.fasta", f"--out={tmp_path}/o.nwk",
        "--device=cpu"])
    assert np.isfinite(ll_nni)
    text = open(tmp_path / "anc.fasta").read()
    assert text.count(">") == 2 * 9 - 1 and ">root" in text
    assert os.path.exists(tmp_path / "o.nwk")


def test_cli_bootstrap_and_csmc(tmp_path):
    from phylo_tpu_torch.cli import bootstrap, csmc

    res = bootstrap.main(["--dataset=primates_small", "--n_particles=8",
                          "--n_replicates=2", "--device=cpu",
                          f"--out={tmp_path}/c.nwk"])
    assert all(0.0 <= s <= 1.0 + 1e-12 for s in res.supports.values())
    assert open(tmp_path / "c.nwk").read().strip() == res.consensus
    out = csmc.main(["--dataset=primates_small", "--n_particles=4",
                     "--resampling=true", "--device=cpu"])
    from phylo_tpu.cli import csmc as jcsmc

    want = jcsmc.main(["--dataset=primates_small", "--n_particles=4",
                       "--resampling=true"])
    np.testing.assert_array_equal(out["merged_nodes"], want["merged_nodes"])
