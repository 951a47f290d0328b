"""The wide rank kernels over rate mixtures wider than 128 planes
(protein+Gamma8: 8 blocks of 20 states; GY94+Gamma4: 4 blocks of 61),
float64 on the CPU.

* The launch plans: K9f's and K9bs / K9b's launches at every shape
  below 128 planes that chip_smoke.py times, as literals (the plans the
  one-group bodies had before the block-group forms); the one-group or
  group choice, shared memory, threads and dP tiles a thread at 8 x 20,
  4 x 61, 16 x 20 and 32 x 20; every group whole blocks, spread evenly,
  within a block's threads and shared memory for every G <= 32, A <=
  128.
* `smc.sweep.card_refusals`: GammaSites G=8 over a 20-state Q and GY94 +
  Gamma4 run on the card; 33 blocks, or a block of more than 128 states,
  raise.
* The port's protein+Gamma8 VCSMC sweep (5 taxa, 16 sites) under
  injected decisions against the JAX sweep (its dense-merge route,
  `blocked_merge=False`, the same function): the ELBO to 1e-9 and the
  manual-VJP gradients through the blocked plain K9bs and K9b to 1e-8;
  VNCSMC protein+Gamma8 (4 taxa, K=2, M=2) likewise, its chosen merges'
  reverse pass (K11a) on the mixture's blocks.
The CUDA kernels are held against the plain versions on the card by
chip_smoke.py and tools/torch_k9_groups.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.models.branches import init_branch_params as j_branches
from phylo_tpu.models.substitution import get_model as j_get_model
from phylo_tpu.pruning import kernels as jk
from phylo_tpu.smc.sweep import SweepConfig as JConfig
from phylo_tpu.smc.sweep import sample_phylogenies as j_sample
from phylo_tpu.smc.twist import TwistConfig as JTwist
from phylo_tpu_torch.models.substitution import get_model
from phylo_tpu_torch.params import params_from_numpy, params_to_numpy
from phylo_tpu_torch.pruning import kernels as tk
from phylo_tpu_torch.smc import twist as tw
from phylo_tpu_torch.smc.sweep import (
    SweepConfig,
    card_refusals,
    sample_phylogenies,
)

from test_torch_sweep import make_decisions, torch_decisions
from test_torch_twist_mixture_wide import _jax_ll_einsum
from test_twist import make_twist_decisions

torch.set_num_threads(1)

# (K, G, A, S): K9f's and K9bs / K9b's plans before the group forms
ONE_GROUP = {
    (128, 1, 61, 256): ((64, 2, 256, 256, 72256),
                        (32, 2, 128, 4, 256, 76672)),
    (128, 1, 61, 1086): ((64, 2, 256, 256, 72256),
                         (32, 2, 128, 4, 256, 76672)),
    (256, 4, 20, 256): ((32, 1, 160, 256, 37632),
                        (32, 1, 160, 2, 256, 66816)),
    (256, 4, 20, 500): ((32, 1, 160, 256, 37632),
                        (32, 1, 160, 2, 256, 66816)),
    (64, 4, 20, 256): ((32, 4, 160, 256, 37632),
                       (32, 2, 160, 2, 128, 66816)),
    (256, 5, 20, 256): ((32, 1, 224, 256, 47184),
                        (32, 1, 224, 2, 256, 82336)),
    (32, 1, 16, 256): ((64, 4, 64, 128, 12160), (32, 8, 32, 1, 256, 16640)),
    (32, 4, 20, 256): ((32, 8, 160, 256, 37632),
                       (32, 4, 160, 2, 128, 66816)),
    (8, 1, 100, 70): ((32, 2, 224, 16, 111184), (32, 3, 224, 8, 24, 146336)),
}


@pytest.mark.parametrize("shape", sorted(ONE_GROUP))
def test_plans_below_128_planes_unchanged(shape):
    fwd, bwd = ONE_GROUP[shape]
    assert tk.wide_fwd_group(*shape) == shape[1]
    assert tk.wide_bwd_group(*shape) == shape[1]
    assert tk.wide_fwd_plan(*shape) == fwd
    assert tk.wide_bwd_plan(*shape) == bwd


# (K, G, A, S): (K9f's blocks a group, its plan), (K9bs / K9b's)
WIDE = {
    # protein + Gamma8: one group each (16-site chunks, 160 threads)
    (256, 8, 20, 256): ((8, (16, 1, 160, 256, 52608)),
                        (8, (16, 1, 160, 4, 256, 83008))),
    (32, 8, 20, 256): ((8, (16, 8, 160, 256, 52608)),
                       (8, (16, 4, 160, 4, 128, 83008))),
    # GY94 + Gamma4: K9f one group (174 KB, a block an SM); the backward
    # in 2 groups of 2 blocks (one group would need dpt 8 at 16 sites)
    (128, 4, 61, 1086): ((4, (16, 1, 256, 128, 174160)),
                         (2, (32, 1, 256, 4, 128, 143856))),
    # 16 x 20: K9f one group at 8 sites a chunk; the backward's 320
    # threads do not fit: 3 groups of 6, 6 and 4 blocks
    (256, 16, 20, 256): ((16, (8, 1, 160, 256, 83616)),
                         (6, (32, 1, 256, 4, 256, 93120))),
    # 32 x 20: 160 plane tiles, 325 KB: 6 groups of 6 (the last of 2)
    (256, 32, 20, 256): ((6, (32, 1, 256, 256, 56352)),
                         (6, (32, 1, 256, 4, 256, 93120))),
}


@pytest.mark.parametrize("shape", sorted(WIDE))
def test_wide_plans(shape):
    (fgb, fplan), (bgb, bplan) = WIDE[shape]
    assert tk.wide_fwd_group(*shape) == fgb
    assert tk.wide_fwd_plan(*shape) == fplan
    assert tk.wide_bwd_group(*shape) == bgb
    assert tk.wide_bwd_plan(*shape) == bplan


def _one_group_fits_bwd(G, A):
    nst, threads, dpt = tk._wide_one_bwd(G, A)
    return (threads <= tk._wide_max_threads(nst)
            and dpt <= (8 if nst == 8 else 4)
            and tk.wide_bwd_smem(G, A, nst) <= tk.SMEM_LIMIT)


@pytest.mark.parametrize("A", [9, 20, 33, 61, 64, 97, 128])
def test_group_plans_every_block_count(A):
    """Every G <= 32 blocks of A states: whole blocks a group, as few
    groups as the most blocks a group allows, filled evenly (the last
    holds the rest), the group's tiles within a block's threads and its
    layout within the shared memory; the one-group form wherever it
    fits."""
    npt = -(-A // 4)
    for G in range(1, tk.MAX_G + 1):
        for K, S in ((16, 70), (256, 256)):
            gb = tk.wide_bwd_group(K, G, A, S)
            sc, cluster, threads, dpt, blocks, smem = tk.wide_bwd_plan(
                K, G, A, S)
            assert 1 <= gb <= G and smem <= tk.SMEM_LIMIT
            assert 1 <= cluster <= min(tk.MAX_CLUSTER, -(-S // sc))
            assert blocks == cluster * K
            if gb == G:
                assert _one_group_fits_bwd(G, A)
            else:
                assert not _one_group_fits_bwd(G, A)
                assert (sc, dpt) == (4 * tk.WIDE_GROUP_NST,
                                     tk.WIDE_GROUP_DPT)
                assert gb * npt * tk.WIDE_GROUP_NST <= threads \
                    <= tk.WIDE_BWD_THREADS
                assert smem == tk.wide_bwd_group_smem(gb, A)
                # as few groups as the most blocks a group allows
                groups = -(-G // gb)
                assert -(-G // groups) == gb
            gf = tk.wide_fwd_group(K, G, A, S)
            sc, cluster, threads, blocks, smem = tk.wide_fwd_plan(K, G, A,
                                                                  S)
            assert 1 <= gf <= G and smem <= tk.SMEM_LIMIT
            assert threads % 32 == 0 and threads % sc == 0
            assert threads <= tk.WIDE_FWD_THREADS
            assert cluster & (cluster - 1) == 0
            if gf < G:
                assert sc == 4 * tk.WIDE_GROUP_NST
                assert gf * npt * tk.WIDE_GROUP_NST <= threads
                assert smem == tk.wide_fwd_group_smem(gf, A, sc, threads)


def test_plans_outside_the_contract():
    for G, A in ((33, 20), (4, 129), (1, 129), (0, 20)):
        for plan in (tk.wide_fwd_plan, tk.wide_bwd_plan):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                plan(64, G, A, 256)


# ------------------------------------------------------------ refusals
def test_card_takes_gamma8_and_gy94_gamma4():
    for spec, A in (("reference+g8", 20), ("gy94+g4", 61)):
        model = get_model(spec, A=A)
        planes = model.blocks[0] * A
        for cfg in (SweepConfig(K=4), SweepConfig(
                K=4, twist=tw.TwistConfig(M=2))):
            card_refusals(cfg, model, planes)
    assert get_model("reference+g8", A=20).blocks == (8, 20)


@pytest.mark.parametrize("G,A", [(33, 20), (4, 129), (2, 200)])
def test_card_refuses_beyond_the_contract(G, A):
    class Mixture:
        blocks = (G, A)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        card_refusals(SweepConfig(K=4), Mixture(), G * A)


# ------------------------------------------------------- the sweeps
def _genome(seed, N, S):
    rng = np.random.default_rng(seed)
    g = np.eye(20)[rng.integers(0, 20, (N, S))]
    g[0, :2] = 1.0                                 # missing residues
    return g


def _tree(jmodel, N, rng):
    return jax.tree.map(lambda x: np.asarray(x) + rng.normal(
        0.0, 0.3, np.shape(x)), {"model": jmodel.init_params(jnp.float64),
                                 "branches": j_branches(N, dtype=jnp.float64)})


@functools.lru_cache(maxsize=None)
def _jax_vcsmc():
    genome, K = _genome(300, 5, 16), 4
    rng = np.random.default_rng(301)
    jmodel = j_get_model("reference+g8", A=20)
    tree = _tree(jmodel, 5, rng)
    dec = make_decisions(rng, 5, K, np.exp(tree["branches"]["log_rates_l"]),
                         np.exp(tree["branches"]["log_rates_r"]))
    leaves = jnp.asarray(jmodel.expand_leaves(genome))

    def elbo(p):
        return j_sample(jax.random.PRNGKey(0), leaves, jmodel, p,
                        JConfig(K=K, blocked_merge=False),
                        decisions=jax.tree.map(jnp.asarray, dec)).elbo

    val, grad = jax.jit(jax.value_and_grad(elbo))(
        jax.tree.map(jnp.asarray, tree))
    return genome, tree, dec, K, float(val), jax.tree.map(np.asarray, grad)


def _check_grads(params, want_grad):
    got = params_to_numpy(jax.tree.map(lambda t: t.grad, params,
                                       is_leaf=torch.is_tensor))
    for path, w in jax.tree_util.tree_leaves_with_path(want_grad):
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g, w, rtol=1e-8,
                                   atol=1e-12 * max(1.0, np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))
        assert np.any(g != 0.0), jax.tree_util.keystr(path)


def _counting(monkeypatch, module, names):
    """Counts the calls of `names` in `module` and the rank of their P."""
    calls = {n: [] for n in names}
    for name in names:
        def counted(*a, _fn=getattr(module, name), _n=name, **kw):
            calls[_n].append(a[2].ndim if _n == "merge_bwd" else
                             a[-4].ndim)
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("route", ["saved", "regather"])
def test_protein_g8_sweep_matches_jax(route, monkeypatch):
    """protein+Gamma8 VCSMC: the ELBO to 1e-9, the manual VJP's gradients
    through the blocked plain K9bs (children saved) or K9b
    (SAVE_CHILDREN_CAP 0) to 1e-8 against jax.grad."""
    from phylo_tpu_torch.smc import sweep_vjp

    genome, tree, dec, K, want, want_grad = _jax_vcsmc()
    if route == "regather":
        monkeypatch.setattr(tk, "SAVE_CHILDREN_CAP", 0)
    calls = _counting(monkeypatch, sweep_vjp,
                      ("fused_rank_bwd_saved", "fused_rank_bwd"))
    model = get_model("reference+g8", A=20)
    params = params_from_numpy(tree)
    res = sample_phylogenies(None, torch.tensor(model.expand_leaves(genome)),
                             model, params, SweepConfig(K=K),
                             decisions=torch_decisions(dec))
    np.testing.assert_allclose(float(res.elbo.detach()), want, rtol=1e-9)
    res.elbo.backward()
    R = genome.shape[0] - 1
    used = "fused_rank_bwd_saved" if route == "saved" else "fused_rank_bwd"
    assert calls[used] == [4] * R           # (K, G, A, A) blocks
    assert len(calls) == 2 and sum(map(len, calls.values())) == R
    _check_grads(params, want_grad)


def test_vncsmc_protein_g8_matches_jax(monkeypatch):
    """VNCSMC protein+Gamma8 (4 taxa, K=2, M=2): the ELBO to 1e-9 and the
    manual VJP's gradients to 1e-8 against jax.grad of the JAX twist
    sweep (its dense 160-state enumeration, `_pair_ll_ref` as an einsum
    of the same function); the twist takes the blocks, and so does K11a
    for the chosen merges."""
    from phylo_tpu_torch.smc import sweep_vjp

    N, S, K, M = 4, 8, 2, 2
    genome = _genome(310, N, S)
    rng = np.random.default_rng(311)
    jmodel = j_get_model("reference+g8", A=20)
    tree = _tree(jmodel, N, rng)
    dec = jax.tree.map(np.asarray, make_twist_decisions(
        rng, N, K, M, np.exp(tree["branches"]["log_rates_l"]),
        np.exp(tree["branches"]["log_rates_r"])))
    leaves = jnp.asarray(jmodel.expand_leaves(genome))
    cfg = JConfig(K=K, twist=JTwist(M=M, remat=False), blocked_merge=False)

    def elbo(p):
        return j_sample(jax.random.PRNGKey(0), leaves, jmodel, p, cfg,
                        decisions=jax.tree.map(jnp.asarray, dec)).elbo

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jk, "_pair_ll_ref", _jax_ll_einsum)
        want, want_grad = jax.jit(jax.value_and_grad(elbo))(
            jax.tree.map(jnp.asarray, tree))
    calls = _counting(monkeypatch, sweep_vjp, ("merge_bwd",))
    model = get_model("reference+g8", A=20)
    assert tk.twist_blocks(model) == (8, 20)
    params = params_from_numpy(tree)
    res = sample_phylogenies(
        None, torch.tensor(model.expand_leaves(genome)), model, params,
        SweepConfig(K=K, twist=tw.TwistConfig(M=M)),
        decisions={k: torch.tensor(v) for k, v in dec.items()})
    np.testing.assert_allclose(float(res.elbo.detach()), float(want),
                               rtol=1e-9)
    res.elbo.backward()
    assert calls["merge_bwd"] == [4] * (N - 1)
    _check_grads(params, jax.tree.map(np.asarray, want_grad))
