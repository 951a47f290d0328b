"""The twist's blocked pair-loglik route, held in float64 on the CPU.

A rate mixture's twist scores its candidates through per-category
transitions (M, K, G, A_b, A_b) and the blocked forms of the pair-loglik
kernels (K11b blocked, K7 wide blocked on the card), where the JAX package
enumerates the dense (G A_b)-state block-diagonal transitions.  The
blocked plain versions drop only exact zero terms of the dense ones, so
they are held to them at 1e-13:
* the plain blocked forward (K11b's plain version) and VJP (K7 wide's)
  against the dense ones on `blockdiag_dense` inputs (G = 4 and 5 blocks
  of 4: GTR+G4 and GTR+G4+I), dP against the dense dP's diagonal blocks;
* the plain blocked forward against JAX's `_pair_ll_ref` on the dense
  form (G = 2 blocks of 4);
* `smc.twist.chunk_loglik` on GammaSites: the blocked route against the
  dense one in values and in gradients to the model's parameters, with
  `transition_blocks` taking the place of `transition` under either
  backward;
* K7 wide's and K11b's launch plans for every plane count the kernels
  take in one block group.
The CUDA kernels are held against these plain versions on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.pruning import kernels as jk
from phylo_tpu_torch import _ext
from phylo_tpu_torch.models.substitution import GammaSites, get_model
from phylo_tpu_torch.pruning import kernels as tk
from phylo_tpu_torch.smc import twist as tw

torch.set_num_threads(1)

NAMES = ("dm1", "dm2", "dP_l", "dP_r", "dpi", "dw")


def _inputs(seed, G, Ab, Kc=3, S=11, M=2):
    rng = np.random.default_rng(seed)
    A = G * Ab
    args = (rng.uniform(0.05, 1.0, (Kc, A, S)),
            rng.uniform(0.05, 1.0, (Kc, A, S)),
            rng.uniform(0.05, 1.0, (M, Kc, G, Ab, Ab)),
            rng.uniform(0.05, 1.0, (M, Kc, G, Ab, Ab)),
            rng.dirichlet(np.ones(A)), rng.uniform(0.5, 2.0, (S,)))
    return (tuple(torch.tensor(x) for x in args),
            torch.tensor(rng.normal(0.0, 1.0, (M, Kc))))


def _dense(args):
    return args[:2] + tuple(tk.blockdiag_dense(P) for P in args[2:4]) \
        + args[4:]


def _diag_blocks(P, G, Ab):
    return torch.stack([P[..., j * Ab:(j + 1) * Ab, j * Ab:(j + 1) * Ab]
                        for j in range(G)], dim=-3)


def _close(got, want, name, rtol=1e-13):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=rtol, atol=1e-300, err_msg=name)


@pytest.mark.parametrize("G", [4, 5])
def test_plain_blocked_fwd_equals_dense(G):
    """K11b's plain version on blocks against its dense form; the CPU
    wrapper runs it and launches nothing."""
    args, _ = _inputs(100 + G, G, 4)
    want = tk._pair_ll_ref(*_dense(args))
    before = dict(_ext.LAUNCHES)
    got = tk.pair_ll_fwd(*args)
    assert dict(_ext.LAUNCHES) == before
    _close(got, want, "ll")
    _close(tk._pair_ll_ref(*args), want, "ll (plain)")


@pytest.mark.parametrize("G", [4, 5])
def test_plain_blocked_vjp_equals_dense(G):
    """K7 wide's plain version on blocks against the dense VJP: dm1, dm2,
    dpi, dw, and dP (in P's blocked shape) against the dense dP's
    diagonal blocks."""
    args, g = _inputs(110 + G, G, 4)
    got = tk.pair_ll_bwd(*args, g)
    want = tk.pair_ll_bwd(*_dense(args), g)
    assert got[2].shape == args[2].shape and got[3].shape == args[3].shape
    for name, a, b in zip(NAMES, got, want):
        if name.startswith("dP"):
            b = _diag_blocks(b, G, 4)
        _close(a, b, name)


def test_plain_blocked_fwd_matches_jax():
    """The blocked plain forward against JAX's `_pair_ll_ref` on the
    dense block-diagonal form (G = 2 blocks of 4)."""
    args, _ = _inputs(120, 2, 4)
    want = jk._pair_ll_ref(*(jnp.asarray(x.numpy()) for x in _dense(args)))
    np.testing.assert_allclose(tk._pair_ll_ref(*args).numpy(),
                               np.asarray(want), rtol=1e-13)


@pytest.mark.parametrize("fused", [False, True])
def test_blocked_autograd_rule(fused):
    """`pair_loglik` / `fused_pair_loglik` on blocked P: the gradients of
    its autograd rule equal plain autograd of `_pair_ll_ref`, dP in P's
    own blocked shape."""
    args, g = _inputs(130, 4, 4)
    ins = [t.clone().requires_grad_(True) for t in args]
    fn = tk.fused_pair_loglik if fused else tk.pair_loglik
    got = torch.autograd.grad(fn(*ins), ins, g)
    ref = [t.clone().requires_grad_(True) for t in args]
    want = torch.autograd.grad(tk._pair_ll_ref(*ref), ref, g)
    for name, a, b in zip(("m1", "m2", "P_l", "P_r", "pi", "w"), got, want):
        assert a.shape == b.shape, name
        _close(a, b, name, rtol=1e-12)


def _chunk_case(seed, C=3, M=2, K=2, S=9):
    rng = np.random.default_rng(seed)
    model = get_model("gtr+g4", A=4)
    params = model.init_params(torch.float64)
    with torch.no_grad():
        for leaf in (params["base"][k] for k in sorted(params["base"])):
            leaf += torch.tensor(rng.normal(0.0, 0.3, tuple(leaf.shape)))
        params["log_alpha"] += 0.4
    A = model.A
    m_l, m_r = (torch.tensor(rng.uniform(0.05, 1.0, (K * C, A, S)))
                for _ in range(2))
    bl, br = (torch.tensor(rng.exponential(0.1, (C, M, K)))
              for _ in range(2))
    w = torch.tensor(rng.uniform(0.5, 2.0, (S,)))
    return model, params, m_l, m_r, bl, br, w


def _chunk_ll(model, params, m_l, m_r, bl, br, w, M=2):
    leaves = [params["log_alpha"]] + [params["base"][k]
                                      for k in sorted(params["base"])]
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    p = {"log_alpha": leaves[0],
         "base": dict(zip(sorted(params["base"]), leaves[1:]))}
    m_l, m_r = (t.clone().requires_grad_(True) for t in (m_l, m_r))
    pi = model.stationary(p, dtype=torch.float64)
    ll = tw.chunk_loglik(tw.TwistConfig(M=M), model, p, pi, w, m_l, m_r,
                         bl, br)
    g = torch.tensor(np.random.default_rng(7).normal(size=tuple(ll.shape)))
    grads = torch.autograd.grad(ll, leaves + [m_l, m_r], g)
    return ll.detach(), grads


@pytest.mark.parametrize("bwd_v2", [False, True])
def test_chunk_loglik_blocked_route(bwd_v2, monkeypatch):
    """GammaSites (GTR+G4): chunk_loglik takes `transition_blocks` in
    place of `transition` (blocked K11b / K7 wide on the card, and under
    TWIST_BWD_V2 blocked K11c); the blocked route equals the dense one
    in values and in gradients to log_alpha, the base model's parameters
    and the messages."""
    monkeypatch.setattr(tk, "TWIST_BWD_V2", bwd_v2)
    case = _chunk_case(140)
    model = case[0]
    calls = {"transition": 0, "transition_blocks": 0}
    for name in calls:
        def counted(*a, _fn=getattr(model, name), _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(model, name, counted)
    assert tk.twist_blocks(model) == (4, 4)
    got, got_g = _chunk_ll(*case)
    assert calls["transition"] == 0
    assert calls["transition_blocks"] == 1
    monkeypatch.setattr(tw, "twist_blocks", lambda model: None)
    want, want_g = _chunk_ll(*case)
    _close(got, want, "ll", rtol=1e-12)
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        _close(a, b, f"gradient {i}", rtol=1e-10)
        assert bool((a != 0).any())


def test_twist_blocks_rule():
    """The blocked route takes every rate mixture of 2 <= G <= 32 blocks
    of up to 64 states (protein + Gamma3, 60 planes, too: the register
    tile no longer decides); models without blocks stay dense."""
    assert tk.twist_blocks(get_model("gtr+g4", A=4)) == (4, 4)
    assert tk.twist_blocks(get_model("gtr+g4+i", A=4)) == (5, 4)
    assert tk.twist_blocks(get_model("jc69+r3", A=4)) == (3, 4)
    assert tk.twist_blocks(get_model("gtr", A=4)) is None
    assert tk.twist_blocks(GammaSites(get_model("reference", A=20), G=2)) \
        == (2, 20)
    assert tk.twist_blocks(GammaSites(get_model("reference", A=20), G=3)) \
        == (3, 20)


def test_launch_plans():
    """K7 wide: SC >= 32 sites a chunk, a multiple of 32, at most 256;
    shared memory within a block's 227 KB; enough threads for one (4
    planes x 4 sites) tile each; and one chunk at the training shape
    (S = 256) for up to 8 plane groups, so dP is written once per (m,
    row) there.  K11b: its tiles cover S with at most 256 threads, one
    tile per row at S = 256.  For every G <= 32 blocks of A_b states in
    at most 64 planes and S up to 1949: all in one block group of each
    kernel (tests/test_torch_twist_mixture_wide.py holds the plans over
    several groups)."""
    for G in range(1, 33):
        for Ab in range(1, 64 // G + 1):
            NGT = G * -(-Ab // 4)
            fits = G == 1 or tk._pow2(max(Ab, 4)) * tk._pow2(G) <= 64
            if fits:
                assert tk.twist_fwd_group(G, Ab)[2] == 1
            for S in (1, 31, 32, 70, 256, 300, 898, 1949):
                if NGT <= 16:
                    assert tk.twist_bwd_group(G, Ab, S) == G
                sc, threads, smem = tk.twist_bwd_plan(G, Ab, S, gb=G)
                assert 32 <= sc <= 256 and sc % 32 == 0, (G, Ab, S, sc)
                assert smem <= tk.SMEM_LIMIT <= 227 * 1024, (G, Ab, S, smem)
                assert NGT * sc // 4 <= threads <= 512 and threads % 32 == 0
                if S <= 256 and NGT <= 8:
                    assert sc >= S, (G, Ab, S, sc)
                if fits:
                    spt, nthr, tiles = tk.twist_fwd_plan(G, Ab, S)
                    assert 32 <= nthr <= 256 and nthr % 32 == 0
                    assert spt * nthr * tiles >= S > spt * nthr * (tiles - 1)
                    if S <= 256:
                        assert tiles == 1
    assert tk.twist_bwd_plan(4, 4, 256)[:2] == (256, 256)
    assert tk.twist_fwd_plan(4, 4, 256) == (2, 128, 1)
