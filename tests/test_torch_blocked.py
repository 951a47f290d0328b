"""Blocked (rate-mixture) rank kernels and sweep of the port against the
JAX package, float64 on the CPU.

The plain versions of K1 and K10 (forward), K2 and its blocked form
(backward from saved children) and K3 (backward re-gathering the
children) against JAX's references with blocked (K, G, A, A)
transitions, to 1e-12; K3's plain version against K2's on the same
children; and the sweep for gtr+g4, gtr+g4+i and jc69+r3 under injected
decisions (ELBO to 1e-9, manual-VJP gradients to 1e-8 against
jax.grad), once with SAVE_CHILDREN_CAP forced to 0 so the reverse pass
runs the re-gather route (K3), once with the cap as it is (K2)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.models.substitution import get_model as j_get_model
from phylo_tpu.pruning import kernels as jk
from phylo_tpu.smc.sweep import SweepConfig as JConfig
from phylo_tpu.smc.sweep import sample_phylogenies as j_sample
from phylo_tpu_torch.models.substitution import get_model
from phylo_tpu_torch.params import params_from_numpy, params_to_numpy
from phylo_tpu_torch.pruning import kernels as tk
from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies

from test_torch_sweep import make_decisions, random_genome, torch_decisions

torch.set_num_threads(1)


def _rank_case(G, A, seed, K=6, N=5, R=4, S=20, ties=None):
    """Leaves, buffer, child index, blocked transitions and cotangents of
    one rank, as numpy.  ties="rate0": one-hot leaves read by every
    particle and an identity block (the +I rate-0 category), so the
    merged planes of that block are products of leaf codes and tie
    exactly; ties="max": JAX's test_fused_rank_bwd_handles_max_ties
    case, every P column the same and pi uniform, so all G*A planes tie
    at the max."""
    rng = np.random.default_rng(seed)
    GA = G * A
    leaves = rng.uniform(0.1, 1.0, (N, GA, S))
    if ties == "rate0":
        codes = np.eye(A)[rng.integers(0, A, (N, S))].transpose(0, 2, 1)
        leaves = np.tile(codes, (1, G, 1))
    buf = rng.uniform(0.1, 1.0, (K, R, GA, S))
    outc = R - 1
    hi = N if ties == "rate0" else N + outc
    idx = np.stack([rng.integers(0, K, K), rng.integers(0, hi, K),
                    rng.integers(0, K, K), rng.integers(0, hi, K)])
    P_l = rng.uniform(0.05, 1.0, (K, G, A, A))
    P_r = rng.uniform(0.05, 1.0, (K, G, A, A))
    pi = rng.uniform(0.1, 1.0, GA)
    pi /= pi.sum()
    if ties == "rate0":
        P_l[:, 0] = P_r[:, 0] = np.eye(A)
    elif ties == "max":
        col = rng.uniform(0.05, 1.0, (K, 1, A, 1))
        P_l = P_r = np.broadcast_to(col, (K, G, A, A)).copy()
        pi = np.full(GA, 1.0 / GA)
    w = rng.uniform(0.5, 1.5, S)
    gm = rng.normal(size=(K, GA, S))
    gr = rng.normal(size=K)
    gl = rng.normal(size=K)
    return dict(leaves=leaves, buf=buf, idx=idx.astype(np.int32), outc=outc,
                P_l=P_l, P_r=P_r, pi=pi, w=w, gm=gm, gr=gr, gl=gl)


def _t(c):
    return {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
            for k, v in c.items()}


def _j(c):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in c.items()}


def _close(got, want, rtol=1e-12):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=rtol,
                                   atol=rtol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("G,ties", [(4, None), (5, "rate0")])
@pytest.mark.parametrize("save", [False, True])
def test_blocked_rank_update_ref_matches_jax(G, ties, save):
    c = _rank_case(G, 4, seed=10 + G, ties=ties)
    t, j = _t(c), _j(c)
    want = jax.jit(jk._fused_rank_ref, static_argnames="save_children")(
        j["leaves"], j["buf"], j["idx"], jnp.asarray([c["outc"]]), j["P_l"],
        j["P_r"], j["pi"], j["w"], save_children=save)
    buf = t["buf"].clone()
    got = tk._fused_rank_ref(t["leaves"], buf, t["idx"], c["outc"],
                             t["P_l"], t["P_r"], t["pi"], t["w"],
                             save_children=save)
    _close([buf] + list(got), want)


@pytest.mark.parametrize("G,ties", [(1, None), (4, None), (5, "rate0"),
                                    (1, "max"), (4, "max")])
def test_blocked_rank_bwd_refs_match_jax(G, ties):
    """K2 / K10-backward (saved children) and K3 (re-gather) plain
    versions against JAX's vjp references; K3's equals K2's on the same
    children.  G=1 passes dense (K, A, A) transitions."""
    c = _rank_case(G, 4, seed=20 + G, ties=ties)
    if G == 1:
        c["P_l"], c["P_r"] = c["P_l"][:, 0], c["P_r"][:, 0]
    t, j = _t(c), _j(c)
    cts = ("gm", "gr", "gl", "P_l", "P_r", "pi", "w")
    want3 = jax.jit(jk._fused_rank_bwd_ref)(j["leaves"], j["buf"], j["idx"],
                                            *(j[k] for k in cts))
    got3 = tk._fused_rank_bwd_ref(t["leaves"], t["buf"], t["idx"],
                                  *(t[k] for k in cts))
    _close(got3, want3)
    m1, m2 = tk.gather_children(t["leaves"], t["buf"], t["idx"])
    want2 = jax.jit(jk._fused_rank_bwd_saved_ref)(
        jnp.asarray(m1.numpy()), jnp.asarray(m2.numpy()),
        *(j[k] for k in cts))
    got2 = tk._fused_rank_bwd_saved_ref(m1, m2, *(t[k] for k in cts))
    _close(got2, want2)
    for a, b in zip(got3, got2):
        assert torch.equal(a, b)
    assert got2[2].shape == c["P_l"].shape


def test_blockdiag_dense_matches_jax():
    P = np.random.default_rng(3).normal(size=(2, 3, 5, 4, 4))
    np.testing.assert_array_equal(tk.blockdiag_dense(torch.tensor(P)),
                                  np.asarray(jk.blockdiag_dense(
                                      jnp.asarray(P))))


@pytest.mark.parametrize("G,ties", [(4, None), (5, "rate0")])
def test_blocked_refs_match_dense_refs(G, ties):
    """The blocked forms equal the dense ones on the block-diagonal
    (GA, GA) transitions: K10's forward and the backward, whose blocked
    dP is the dense dP's diagonal blocks."""
    c = _t(_rank_case(G, 4, seed=30 + G, ties=ties))
    K, A = c["P_l"].shape[0], 4
    dense = {k: tk.blockdiag_dense(c[k]) for k in ("P_l", "P_r")}
    outs = []
    for P in ({k: c[k] for k in dense}, dense):
        buf = c["buf"].clone()
        fwd = tk._fused_rank_ref(c["leaves"], buf, c["idx"], c["outc"],
                                 P["P_l"], P["P_r"], c["pi"], c["w"],
                                 save_children=True)
        bwd = tk._fused_rank_bwd_ref(c["leaves"], c["buf"], c["idx"], c["gm"],
                                     c["gr"], c["gl"], P["P_l"], P["P_r"],
                                     c["pi"], c["w"])
        outs.append([buf, *fwd, *bwd])
    blocked, want = outs
    for i in (7, 8):    # dP_l, dP_r: the diagonal blocks of the dense ones
        want[i] = torch.diagonal(want[i].reshape(K, G, A, G, A), dim1=1,
                                 dim2=3).permute(0, 3, 1, 2)
    _close(blocked, want)


def test_save_children_rule_matches_jax():
    # DS1 (N=27) at K=2048, GammaSites G=4 (16 planes), site batch 256
    assert not tk.save_children_ok(26, 2048, 16, 256, 4)
    # primate (N=12) at K=2048, A=4, site batch 256: 184 MB, saved
    assert tk.save_children_ok(11, 2048, 4, 256, 4)
    assert tk.SAVE_CHILDREN_CAP == jk.SAVE_CHILDREN_CAP == 2 ** 28


# ------------------------------------------------------------- the sweep
def _perturbed(tree, rng):
    """Every parameter moved off its initial value (FreeRates' logits and
    +I's logit included), so no gradient is zero by symmetry."""
    def move(x):
        x = np.asarray(x)
        return x + rng.normal(0.0, 0.3, x.shape)
    return jax.tree.map(move, tree)


@functools.lru_cache(maxsize=None)
def _jax_case(spec):
    genome = random_genome(40 + len(spec), N=5, S=24)
    N, _, A = genome.shape
    K = 5
    rng = np.random.default_rng(41 + len(spec))
    jmodel = j_get_model(spec, A=A)
    from phylo_tpu.models.branches import init_branch_params

    tree = _perturbed(jax.tree.map(np.asarray, {
        "model": jmodel.init_params(jnp.float64),
        "branches": init_branch_params(N, dtype=jnp.float64)}), rng)
    dec = make_decisions(rng, N, K, np.exp(tree["branches"]["log_rates_l"]),
                         np.exp(tree["branches"]["log_rates_r"]))
    leaves = jnp.asarray(jmodel.expand_leaves(genome))

    def elbo(p):
        return j_sample(jax.random.PRNGKey(0), leaves, jmodel, p,
                        JConfig(K=K), decisions=jax.tree.map(jnp.asarray,
                                                             dec)).elbo

    val, grad = jax.jit(jax.value_and_grad(elbo))(
        jax.tree.map(jnp.asarray, tree))
    return (genome, tree, dec, K, float(val),
            jax.tree.map(np.asarray, grad))


@pytest.mark.parametrize("cap", ["zero", "default"])
@pytest.mark.parametrize("spec", ["gtr+g4", "gtr+g4+i", "jc69+r3"])
def test_mixture_sweep_and_manual_vjp_match_jax(spec, cap, monkeypatch):
    if cap == "zero":
        monkeypatch.setattr(tk, "SAVE_CHILDREN_CAP", 0)
    genome, tree, dec, K, want_elbo, want_grad = _jax_case(spec)
    model = get_model(spec, A=genome.shape[2])
    leaves = torch.tensor(model.expand_leaves(genome))
    params = params_from_numpy(tree)
    calls = {"saved": 0, "regather": 0}
    for name, key in (("fused_rank_bwd_saved", "saved"),
                      ("fused_rank_bwd", "regather")):
        fn = getattr(tk, name)

        def counted(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)
        monkeypatch.setattr(f"phylo_tpu_torch.smc.sweep_vjp.{name}", counted)
    res = sample_phylogenies(None, leaves, model, params, SweepConfig(K=K),
                             decisions=torch_decisions(dec))
    np.testing.assert_allclose(float(res.elbo.detach()), want_elbo,
                               rtol=1e-9)
    res.elbo.backward()
    R = genome.shape[0] - 1
    assert calls == ({"saved": 0, "regather": R} if cap == "zero"
                     else {"saved": R, "regather": 0})
    got = params_to_numpy(jax.tree.map(lambda t: t.grad, params,
                                       is_leaf=torch.is_tensor))
    flat_w = jax.tree_util.tree_leaves_with_path(want_grad)
    for path, w in flat_w:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g, w, rtol=1e-8,
                                   atol=1e-12 * max(1.0, np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))
        assert np.any(g != 0.0), jax.tree_util.keystr(path)


def test_autograd_mixture_route_matches_jax():
    """manual_vjp=False: the blocked merge as plain torch ops (no kernel),
    differentiated by autograd."""
    genome, tree, dec, K, want_elbo, want_grad = _jax_case("gtr+g4")
    model = get_model("gtr+g4")
    params = params_from_numpy(tree)
    res = sample_phylogenies(None, torch.tensor(model.expand_leaves(genome)),
                             model, params, SweepConfig(K=K, manual_vjp=False),
                             decisions=torch_decisions(dec))
    np.testing.assert_allclose(float(res.elbo.detach()), want_elbo,
                               rtol=1e-9)
    res.elbo.backward()
    g = params["model"]["log_alpha"].grad
    np.testing.assert_allclose(float(g), want_grad["model"]["log_alpha"],
                               rtol=1e-8)
