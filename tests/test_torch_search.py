"""The port's tree search against the JAX package's: NNI / SPR
neighbours, merge records as injected decisions, batched tree scores,
their gradient in the injected branch lengths (the manual sweep VJP's
decision cotangents, and plain autograd) against jax.grad, and the
NNI / SPR hill climbs with and without branch refits (float64, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.models import substitution as jsub
from phylo_tpu.models.branches import init_branch_params as j_branches
from phylo_tpu.search import nni as jnni
from phylo_tpu.search import spr as jspr
from phylo_tpu.smc.sweep import SweepConfig as JConfig
from phylo_tpu.smc.sweep import sample_phylogenies as j_sample
from phylo_tpu_torch.models.substitution import get_model
from phylo_tpu_torch.params import params_from_numpy
from phylo_tpu_torch.search import nni, spr
from phylo_tpu_torch.smc import twist as tw
from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies

torch.set_num_threads(1)


def random_record(rng, N):
    active = list(range(N))
    merges, branches = [], []
    for r in range(N - 1):
        i, j = sorted(rng.choice(len(active), size=2, replace=False))
        u, v = active[i], active[j]
        merges.append((u, v))
        branches.append(rng.exponential(0.2, size=2))
        active = [x for x in active if x != u and x != v] + [N + r]
    return {"merges": np.asarray(merges, np.int32),
            "branches": np.asarray(branches)}


def genome(seed, N, S, A=4):
    rng = np.random.default_rng(seed)
    g = np.eye(A)[rng.integers(0, A, (N, S))]
    g[0, :3] = 1.0                                # a few missing sites
    return g


def models(spec, N, seed):
    """(jax model, port model, numpy params with branch rates): the
    JAX model's initial parameters moved off their symmetric start."""
    jm = jsub.get_model(spec, A=4)
    tm = get_model(spec, A=4)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, {
        "model": jm.init_params(jnp.float64),
        "branches": j_branches(N, dtype=jnp.float64)})
    tree = jax.tree.map(lambda a: a + rng.normal(0, 0.2, np.shape(a)), tree)
    return jm, tm, tree


def same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["merges"], w["merges"])
        np.testing.assert_array_equal(g["branches"], w["branches"])


@pytest.mark.parametrize("N", [3, 4, 6, 7])
def test_neighbors_equal_jax(N):
    rng = np.random.default_rng(N)
    for _ in range(3):
        rec = random_record(rng, N)
        same_records(nni.nni_neighbors(rec, N), jnni.nni_neighbors(rec, N))
        same_records(spr.spr_neighbors(rec, N), jspr.spr_neighbors(rec, N))
    assert spr.spr_neighborhood_size(N) == jspr.spr_neighborhood_size(N)


def test_records_to_decisions_equal_jax():
    rng = np.random.default_rng(1)
    N = 6
    recs = [random_record(rng, N) for _ in range(5)]
    got = nni.records_to_decisions(recs, N)
    want = jnni.records_to_decisions(recs, N)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


_JAX = {}


def jax_case(spec):
    """(genome, port model, numpy params, records, particle weights,
    site weights, and from one jitted JAX call: log_likelihood_R without
    and with the site weights, and jax.grad of sum_k w_k
    log_likelihood_R[k] in (params, branches_l, branches_r)), computed
    once per spec."""
    if spec not in _JAX:
        N, S = 4, 16
        g = genome(5, N, S)
        jm, tm, tree = models(spec, N, 6)
        if hasattr(jm, "expand_leaves"):
            g = np.asarray(jm.expand_leaves(g))
        rng = np.random.default_rng(7)
        recs = [random_record(rng, N) for _ in range(3)]
        dec = jnni.records_to_decisions(recs, N)
        wk = np.array([1.0, -0.5, 2.0])
        ws = rng.integers(0, 3, S).astype(np.float64)

        def ll_R(p, bl, br, site_weights=None):
            d = dict(dec, branches_l=bl, branches_r=br)
            return j_sample(jax.random.PRNGKey(0), jnp.asarray(g), jm, p,
                            JConfig(K=3), decisions=d,
                            site_weights=site_weights).log_likelihood_R

        def outs(p, bl, br):
            grads = jax.grad(lambda *a: jnp.sum(ll_R(*a) * wk),
                             argnums=(0, 1, 2))(p, bl, br)
            return (ll_R(p, bl, br), ll_R(p, bl, br, jnp.asarray(ws)),
                    grads)

        got = jax.jit(outs)(jax.tree.map(jnp.asarray, tree),
                            dec["branches_l"], dec["branches_r"])
        _JAX[spec] = (g, tm, tree, recs, wk, ws,
                      jax.tree.map(np.asarray, got))
    return _JAX[spec]


@pytest.mark.parametrize("spec", ["reference", "gtr+g4"])
@pytest.mark.parametrize("weighted", [False, True])
def test_batch_scores_match_jax(spec, weighted):
    g, tm, tree, recs, _, ws, (want, want_w, _) = jax_case(spec)
    got = nni.tree_log_likelihoods_batch(
        torch.tensor(g), tm, params_from_numpy(tree, requires_grad=False),
        recs, site_weights=torch.tensor(ws) if weighted else None)
    np.testing.assert_allclose(got.numpy(), want_w if weighted else want,
                               rtol=1e-9)


def leaves_of(tree, prefix=""):
    """{path: leaf} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves_of(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("spec", ["reference", "gtr+g4"])
@pytest.mark.parametrize("manual", [True, False])
@pytest.mark.parametrize("param_grads", [False, True])
def test_branch_length_gradient_matches_jax_grad(spec, manual, param_grads):
    """d sum_k w_k log_likelihood_R[k] / d injected branch lengths (and the
    parameters' gradients alongside): the manual VJP returns the lengths'
    cotangents (K1 / K10 forward, K2 / K3 reverse, K4 in the prologue on
    the card), as plain autograd does; both equal jax.grad."""
    g, tm, tree, recs, wk, _, (_, _, (want_p, want_l, want_r)) = \
        jax_case(spec)
    params = params_from_numpy(tree, requires_grad=param_grads)
    d = nni.records_to_decisions(recs, g.shape[0])
    for k in ("branches_l", "branches_r"):
        d[k].requires_grad_(True)
    res = sample_phylogenies(None, torch.tensor(g), tm, params,
                             SweepConfig(K=3, manual_vjp=manual),
                             decisions=d)
    assert res.log_likelihood_R.grad_fn is not None
    torch.sum(res.log_likelihood_R * torch.tensor(wk)).backward()
    for t, w in ((d["branches_l"], want_l), (d["branches_r"], want_r)):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-9, atol=1e-12)
    if param_grads:
        want = leaves_of(want_p)
        for path, t in leaves_of(params).items():
            np.testing.assert_allclose(t.grad.numpy(), want[path],
                                       rtol=1e-9, atol=1e-12, err_msg=path)


def test_manual_vjp_refuses_leaf_and_site_weight_gradients():
    """Leaf and site-weight gradients (once refused) come from the manual
    VJP equal to plain autograd's with the same draws."""
    N, S = 4, 8
    out = []
    for manual in (True, False):
        g = torch.tensor(genome(8, N, S), requires_grad=True)
        w = torch.linspace(0.5, 1.5, S, dtype=torch.float64,
                           requires_grad=True)
        params = params_from_numpy(models("jc69", N, 9)[2])
        res = sample_phylogenies(torch.Generator().manual_seed(0), g,
                                 get_model("jc69"), params,
                                 SweepConfig(K=2, manual_vjp=manual),
                                 site_weights=w)
        res.elbo.backward()
        out.append((g.grad.numpy(), w.grad.numpy()))
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
        assert np.any(a != 0.0)


def test_twist_pool_gradient_manual_matches_autograd():
    """Under twist the injected branch pools carry a gradient through the
    manual VJP (the candidates' pair log-liks, the scalar replay and the
    chosen merges' transitions) equal to plain autograd's."""
    N, S, K, M = 5, 12, 3, 2
    g = torch.tensor(genome(10, N, S))
    tm = get_model("reference")
    tree = models("reference", N, 11)[2]
    rng = np.random.default_rng(12)
    R = N - 1
    lex = np.asarray([(i, j) for i in range(N) for j in range(i + 1, N)])
    P = len(lex)
    # lexicographic flat choices pair * M + m on the pairs active at rank r
    choice = np.stack([
        rng.choice(np.flatnonzero(lex[:, 1] < N - r), K) * M
        + rng.integers(0, M, K) for r in range(R)])
    dec = dict(
        ancestors=torch.as_tensor(rng.integers(0, K, (R, K))),
        twist_pool_l=torch.as_tensor(rng.exponential(0.1, (R, P, M, K))),
        twist_pool_r=torch.as_tensor(rng.exponential(0.1, (R, P, M, K))),
        twist_choice=torch.as_tensor(choice))
    grads = []
    for manual in (True, False):
        d = {k: v.clone() for k, v in dec.items()}
        for k in ("twist_pool_l", "twist_pool_r"):
            d[k].requires_grad_(True)
        params = params_from_numpy(tree)
        res = sample_phylogenies(
            None, g, tm, params,
            SweepConfig(K=K, manual_vjp=manual, twist=tw.TwistConfig(M=M)),
            decisions=d)
        res.elbo.backward()
        grads.append([d["twist_pool_l"].grad, d["twist_pool_r"].grad,
                      params["model"]["y_q"].grad])
    for a, b in zip(*grads):
        assert torch.any(b != 0)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12)


def _search_case():
    from phylo_tpu.dataio.simulate import simulate_on_tree
    from phylo_tpu.pruning.fixed_tree import parse_newick

    true_nwk = "(((A:0.08,B:0.08):0.12,(C:0.08,D:0.08):0.12):0.10,E:0.3);"
    taxa, true_rec = parse_newick(true_nwk)
    ds = simulate_on_tree(true_rec, jsub.JC69(A=4), {"model": {}}, 120,
                          seed=11, taxa=taxa)
    _, start = parse_newick(
        "((((A:0.2,E:0.2):0.2,C:0.2):0.2,B:0.2):0.2,D:0.2);", taxa=taxa)
    return np.asarray(ds.genome, np.float64), start


@pytest.mark.parametrize("kind,steps,iters", [
    ("nni", 0, 20), ("spr", 0, 20), ("nni", 2, 1), ("spr", 2, 1)])
def test_search_matches_jax(kind, steps, iters):
    """The same accepted trees and log-likelihoods: exactly the same
    records without refits; with 2 Adam refit steps a search (one
    iteration) holds the JAX search's lengths and score to 1e-7."""
    g, start = _search_case()
    jm, tm = jsub.JC69(A=4), get_model("jc69")
    N = g.shape[0]
    jfn = jnni.nni_search if kind == "nni" else jspr.spr_search
    tfn = nni.nni_search if kind == "nni" else spr.spr_search
    kw = dict(max_iters=iters, branch_opt_steps=steps, learning_rate=0.1)
    want = jfn(jnp.asarray(g), jm, {"model": {}}, start, **kw)
    got = tfn(torch.tensor(g), tm, {"model": {}}, start, **kw)
    assert got.iterations == want.iterations
    np.testing.assert_array_equal(got.record["merges"],
                                  want.record["merges"])
    tol = 1e-9 if steps == 0 else 1e-7
    np.testing.assert_allclose(got.record["branches"],
                               want.record["branches"], rtol=tol)
    np.testing.assert_allclose(got.log_likelihood, want.log_likelihood,
                               rtol=tol)
    np.testing.assert_allclose(got.history, want.history, rtol=tol)
    if steps == 0 and kind == "nni":
        assert got.log_likelihood > float(nni.tree_log_likelihoods_batch(
            torch.tensor(g), tm, {"model": {}}, [start])[0])
    assert N == 5


def test_chunked_search_matches_unchunked():
    g, start = _search_case()
    tm = get_model("jc69")
    full = spr.spr_search(torch.tensor(g), tm, {"model": {}}, start,
                          max_iters=3)
    chunked = spr.spr_search(torch.tensor(g), tm, {"model": {}}, start,
                             max_iters=3, max_particles=7)
    np.testing.assert_array_equal(full.record["merges"],
                                  chunked.record["merges"])
    np.testing.assert_allclose(full.log_likelihood, chunked.log_likelihood,
                               rtol=1e-12)
