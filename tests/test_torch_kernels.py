"""Plain versions of the port's kernels against the JAX package's Pallas
kernels run in interpret mode (K1 fused_rank_update, K2
fused_rank_bwd_saved, K7 the pair-loglik backward, K8
fused_merge_loglik, float64), and the plain K5 (Philox Gumbel-max)
against its own specification: Random123 known answers, a chi-square,
and numpy's argmax on the same uniforms.  The CUDA kernels themselves are
held against these plain versions on the card by chip_smoke.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.pruning import kernels as jkernels
from phylo_tpu_torch import _ext
from phylo_tpu_torch.pruning import kernels as tkernels
from phylo_tpu_torch.smc import resample_kernel as rk

torch.set_num_threads(1)

K, R, N, A, S = 8, 5, 6, 4, 40


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jkernels, "TKF", 4)
    jkernels.INTERPRET = True
    yield
    jkernels.INTERPRET = False


def _rank_inputs(rng, ties=False):
    buf = rng.uniform(0.05, 1.0, (K, R, A, S))
    leaves = rng.uniform(0.05, 1.0, (N, A, S))
    nodes = rng.integers(0, N + R - 1, (2, K))      # never column R-1
    rows = rng.integers(0, K, (2, K))
    idx = np.stack([rows[0], nodes[0], rows[1], nodes[1]]).astype(np.int32)
    P_l = rng.uniform(0.05, 1.0, (K, A, A))
    P_r = rng.uniform(0.05, 1.0, (K, A, A))
    pi = rng.uniform(0.1, 1.0, (A,))
    pi = pi / pi.sum()
    if ties:
        # identical columns + uniform pi: every plane ties at the max
        P_l[:] = P_l[:, :, :1]
        P_r[:] = P_r[:, :, :1]
        pi[:] = 1.0 / A
    w = rng.uniform(0.5, 2.0, (S,))
    return buf, leaves, idx, P_l, P_r, pi, w


def _t(*xs):
    return [torch.tensor(x) for x in xs]


def test_fused_rank_update_matches_pallas_interpret(interpret_mode, rng):
    buf, leaves, idx, P_l, P_r, pi, w = _rank_inputs(rng)
    outc = R - 1
    want = jkernels.fused_rank_update(
        jnp.asarray(leaves), jnp.asarray(buf), jnp.asarray(idx),
        jnp.asarray([outc], jnp.int32), jnp.asarray(P_l), jnp.asarray(P_r),
        jnp.asarray(pi), jnp.asarray(w), save_children=True)
    tbuf = torch.tensor(buf)
    before = dict(_ext.LAUNCHES)
    got = tkernels.fused_rank_update(
        torch.tensor(leaves), tbuf, torch.tensor(idx), outc,
        *_t(P_l, P_r, pi, w), save_children=True)
    assert dict(_ext.LAUNCHES) == before      # CPU: plain version only
    pairs = [(tbuf, want[0])] + list(zip(got, want[1:]))
    for name, (a, b) in zip(["buf", "rootll", "logscale", "child_l",
                             "child_r"], pairs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("ties", [False, True])
def test_fused_rank_bwd_saved_matches_pallas_interpret(interpret_mode, rng,
                                                       ties):
    buf, leaves, idx, P_l, P_r, pi, w = _rank_inputs(rng, ties=ties)
    m1, m2 = (t.numpy() for t in tkernels.gather_children(
        *_t(leaves, buf), torch.tensor(idx)))
    gm = rng.normal(0, 1.0, (K, A, S))
    gr = rng.normal(0, 1.0, (K,))
    gl = rng.normal(0, 1.0, (K,))
    args = (m1, m2, gm, gr, gl, P_l, P_r, pi, w)
    want = jkernels.fused_rank_bwd_saved(*map(jnp.asarray, args))
    got = tkernels.fused_rank_bwd_saved(*_t(*args))
    for name, a, b in zip(["dm1", "dm2", "dPl", "dPr", "dpi", "dw"], got,
                          want):
        a, b = a.numpy(), np.asarray(b)
        if name in ("dpi", "dw"):          # per-block partials: compare sums
            a, b = a.sum(0), b.sum(0)
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12,
                                   err_msg=name)


def test_fused_rank_bwd_saved_matches_autograd(rng):
    """The explicit K2 math equals torch autograd through the plain
    forward (amax splits ties evenly, clamp_min at equality halves)."""
    buf, leaves, idx, P_l, P_r, pi, w = _rank_inputs(rng)
    m1, m2 = tkernels.gather_children(*_t(leaves, buf), torch.tensor(idx))
    ins = [t.clone().requires_grad_(True)
           for t in (m1, m2, *_t(P_l, P_r, pi, w))]
    outs = tkernels._ref_impl(*ins)
    cts = [torch.tensor(rng.normal(0, 1.0, o.shape)) for o in outs]
    want = torch.autograd.grad(outs, ins, cts)
    got = tkernels.fused_rank_bwd_saved(m1, m2, *cts, *_t(P_l, P_r, pi, w))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.reshape(b.shape).numpy(), b.numpy(),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("ties", [False, True])
def test_fused_merge_loglik_matches_pallas_interpret(interpret_mode, rng,
                                                     ties):
    """K8's plain version against the Pallas kernel (forward) and the
    JAX package's VJP (backward), with forced max ties; the backward
    also equals K2's plain version, which the card runs for it."""
    import jax

    buf, leaves, idx, P_l, P_r, pi, w = _rank_inputs(rng, ties=ties)
    m1, m2 = (t.numpy() for t in tkernels.gather_children(
        *_t(leaves, buf), torch.tensor(idx)))
    args = (m1, m2, P_l, P_r, pi, w)
    want, vjp = jax.vjp(jkernels.fused_merge_loglik, *map(jnp.asarray, args))
    cts = [rng.normal(0, 1.0, np.shape(o)) for o in want]
    want_g = vjp(tuple(map(jnp.asarray, cts)))
    ins = [t.requires_grad_(True) for t in _t(*args)]
    before = dict(_ext.LAUNCHES)
    got = tkernels.fused_merge_loglik(*ins)
    got_g = torch.autograd.grad(got, ins, _t(*cts))
    assert dict(_ext.LAUNCHES) == before      # CPU: plain version only
    k2 = tkernels._fused_rank_bwd_saved_ref(*_t(m1, m2, *cts, P_l, P_r,
                                                 pi, w))
    k2 = list(k2[:4]) + [k2[4].sum(0), k2[5].sum(0)]
    for name, a, b in zip(["merged", "rootll", "logscale"], got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    for name, a, b, c in zip(["dm1", "dm2", "dPl", "dPr", "dpi", "dw"],
                             got_g, want_g, k2):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12, err_msg=name)
        np.testing.assert_allclose(c.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12, err_msg=f"K2 {name}")


@pytest.mark.parametrize("Kc,S,M", [(12, 40, 3), (20, 33, 10)])
def test_pair_ll_bwd_matches_pallas_interpret(interpret_mode, rng, Kc, S, M):
    """K7's plain version (the autograd VJP of the plain forward) against
    the Pallas backward kernel `_kernel_ll_bwd`, and the autograd rule of
    `pair_loglik` against both."""
    m1 = rng.uniform(0.05, 1.0, (Kc, A, S))
    m2 = rng.uniform(0.05, 1.0, (Kc, A, S))
    P_l = rng.uniform(0.05, 1.0, (M, Kc, A, A))
    P_r = rng.uniform(0.05, 1.0, (M, Kc, A, A))
    pi = rng.uniform(0.1, 1.0, (A,))
    pi = pi / pi.sum()
    w = rng.uniform(0.5, 2.0, (S,))
    g = rng.normal(0, 1.0, (M, Kc))
    args = (m1, m2, P_l, P_r, pi, w)
    want = jkernels._pair_ll_bwd_pallas(*map(jnp.asarray, args),
                                        jnp.asarray(g))
    got = tkernels.pair_ll_bwd(*_t(*args, g))
    ins = [t.requires_grad_(True) for t in _t(*args)]
    ll = tkernels.pair_loglik(*ins)
    np.testing.assert_allclose(
        ll.detach().numpy(), np.asarray(jkernels.pair_loglik(
            *map(jnp.asarray, args))), rtol=1e-12)
    via_autograd = torch.autograd.grad(ll, ins, torch.tensor(g))
    for name, a, b, c in zip(["dm1", "dm2", "dPl", "dPr", "dpi", "dw"], got,
                             want, via_autograd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-12, err_msg=name)
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=1e-12,
                                   atol=1e-14, err_msg=f"autograd {name}")


def test_pair_ll_bwd_dpi_identity(rng):
    """The card's dpi (sum dP_l P_l / pi, outside the kernel) equals the
    plain VJP's dpi."""
    Kc, S, M = 6, 17, 4
    args = _t(rng.uniform(0.05, 1.0, (Kc, A, S)),
              rng.uniform(0.05, 1.0, (Kc, A, S)),
              rng.uniform(0.05, 1.0, (M, Kc, A, A)),
              rng.uniform(0.05, 1.0, (M, Kc, A, A)),
              rng.dirichlet(np.ones(A)), rng.uniform(0.5, 2.0, (S,)),
              rng.normal(0, 1.0, (M, Kc)))
    _, _, dPl, _, dpi, _ = tkernels._pair_ll_bwd_plain(*args)
    P_l, pi = args[2], args[4]
    np.testing.assert_allclose((torch.sum(dPl * P_l, dim=(0, 1, 2)) / pi)
                               .numpy(), dpi.numpy(), rtol=1e-12)


def test_philox_known_answers():
    # Random123's published Philox4x32-10 test vectors
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        t = [torch.tensor([c], dtype=torch.int64) for c in ctr]
        k = [torch.tensor(x, dtype=torch.int64) for x in key]
        got = rk.philox4x32(*t, *k)
        assert [int(g) for g in got] == list(want)


def test_categorical_plain_chi_square():
    Kc, rounds = 64, 200
    rng = np.random.default_rng(3)
    logits = torch.tensor(rng.normal(size=Kc), dtype=torch.float32)
    p = torch.softmax(logits.double(), 0).numpy()
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(Kc)
    for _ in range(rounds):
        idx = rk.categorical(logits, rk.draw_seed(gen, "cpu"))
        assert idx.dtype == torch.int32
        counts += np.bincount(idx.numpy(), minlength=Kc)
    n = rounds * Kc
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    z = (chi2 - (Kc - 1)) / math.sqrt(2 * (Kc - 1))
    assert abs(z) < 4.0, z
