"""K7 (the DNA twist pair-loglik backward) and the rank backward's dense
form (K2, K3 and K11a at A <= 8), held on the CPU.

* `twist_narrow_plan` and `rank_bwd_plan` at G = 1: every (m, row, site)
  or (particle, site) covered exactly once, shared memory within a
  block's 227 KB, and a grid of at least 8 warps an SM of the H100's 132
  at the main paths' shapes (primate rank 0: M = 10, KC = 2112, S = 256;
  VCSMC K = 2048 at S = 256 and 898), or else every chunk of a row its
  own warp (K11a's K = 32, the twist's later ranks); the forms the plans
  pick at those shapes, the quickest on the card
  (tools/torch_k7_forms.py).
* A float32 emulation of each kernel's sum order against the float64
  plain version, to phase 2's tolerance (1e-4 relative): K7's per-lane
  FMA chains (u, v, the site sum, dm over m and b, dP over a lane's
  sites), the warp's transpose_sum (a butterfly over lanes), the chunks
  in order on a warp's slot and the warps in order; the dense rank
  backward's chains, the same butterfly and orders, the all-planes-tied
  case included.
* The wrappers on CPU tensors with want_dw, and the former dense body's
  removal from the sources.
The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py."""

import os

import numpy as np
import pytest
import torch

from phylo_tpu_torch.pruning import kernels as tk

torch.set_num_threads(1)

TOL = 1e-4
CSRC = os.path.join(os.path.dirname(tk.__file__), os.pardir, "csrc")
# (KC, M, A, S) of K7: primate rank 0 (and ragged S), the last rank, small
K7_SHAPES = [(2112, 10, 4, 256), (2112, 10, 4, 300), (2112, 10, 4, 70),
             (32, 10, 4, 256), (32, 10, 4, 300), (5, 3, 3, 70),
             (64, 10, 8, 256)]
# (K, A, S) of the dense rank backward: VCSMC primate, K11a, ragged
DENSE_SHAPES = [(2048, 4, 256), (2048, 4, 898), (32, 4, 256), (2048, 4, 70),
                (2048, 4, 300), (32, 4, 300), (7, 3, 31)]


def _fma(x, y, z):
    """float32 fused multiply-add: the product is exact in float64."""
    return (np.asarray(x, np.float64) * y + z).astype(np.float32)


def _butterfly(x, axis):
    """The warp's xor-16, 8, 4, 2, 1 pair sums over 32 lanes on `axis`."""
    x = np.moveaxis(x, axis, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = (x[:h] + x[h:]).astype(np.float32)
    return x[0]


def _warp_order(red, warps):
    """Chunk sums red[c] onto warp c % warps's slot in chunk order, then
    the slots in warp order."""
    tot = None
    for wq in range(warps):
        slot = red[wq]
        for c in range(wq + warps, red.shape[0], warps):
            slot = (slot + red[c]).astype(np.float32)
        tot = slot if tot is None else (tot + slot).astype(np.float32)
    return tot


def _lanes(x, spl, chunks):
    """(..., S) -> (..., chunks, SPL, 32), zero-padded: lane l of chunk c
    holds site c 32 SPL + 32 j + l as its j-th."""
    pad = np.zeros(x.shape[:-1] + (chunks * 32 * spl,), np.float32)
    pad[..., :x.shape[-1]] = x
    return pad.reshape(x.shape[:-1] + (chunks, spl, 32))


def _sites_of(plan_warps, chunks, spl, S):
    """Times each site is taken by the warps' chunks w, w + warps, ..."""
    count = np.zeros(S, dtype=int)
    for wq in range(plan_warps):
        for c in range(wq, chunks, plan_warps):
            s = c * 32 * spl + 32 * np.arange(spl)[:, None] + np.arange(32)
            np.add.at(count, s[s < S], 1)
    return count


# ------------------------------------------------------------ launch plans
@pytest.mark.parametrize("KC,M,A,S", K7_SHAPES)
def test_twist_narrow_plan_covers_each_site_once(KC, M, A, S):
    spl, warps, chunks, blocks, smem = tk.twist_narrow_plan(KC, M, A, S)
    assert blocks == KC and spl in (1, 2, 4)
    assert 1 <= warps <= min(chunks, tk.K7_MAX_WARPS)
    assert smem == tk.k7_smem(M, A, warps) <= tk.SMEM_LIMIT
    # a block a row loops over every m for each of its warps' chunks
    count = np.zeros((M, S), dtype=int)
    for m in range(M):
        count[m] = _sites_of(warps, chunks, spl, S)
    assert (count == 1).all()


@pytest.mark.parametrize("KC,M,A,S", K7_SHAPES)
def test_twist_narrow_plan_fills_the_card(KC, M, A, S):
    spl, warps, chunks, blocks, _ = tk.twist_narrow_plan(KC, M, A, S)
    # 8 warps an SM, or every chunk of a row its own warp
    assert blocks * warps >= tk.GRID_WARPS // 2 or (
        warps == min(chunks, tk.K7_MAX_WARPS))
    # as few warps a row as give 16 an SM
    assert warps == min(chunks, tk.K7_MAX_WARPS, -(-tk.GRID_WARPS // KC))
    if (KC, S) in ((2112, 256), (2112, 300)):    # rank 0: a warp a row
        assert (spl, warps) == (2, 1)
    if KC == 32:                                 # the last rank
        assert (spl, warps) == (1, 8)


@pytest.mark.parametrize("K,A,S", DENSE_SHAPES)
def test_dense_rank_bwd_plan_covers_each_site_once(K, A, S):
    spl, warps, chunks, blocks, smem = tk.rank_bwd_plan(K, 1, A, S)
    assert blocks == K and spl in (1, 2)
    assert 1 <= warps <= min(chunks, tk.BWD_MAX_WARPS)
    # the dense form stages nothing: transitions, pi, the warps' slots
    assert smem == 4 * (2 * A * A + A) * (1 + warps) <= tk.SMEM_LIMIT
    assert (_sites_of(warps, chunks, spl, S) == 1).all()


@pytest.mark.parametrize("K,A,S", DENSE_SHAPES)
def test_dense_rank_bwd_plan_fills_the_card(K, A, S):
    spl, warps, chunks, blocks, _ = tk.rank_bwd_plan(K, 1, A, S)
    assert blocks * warps >= tk.GRID_WARPS // 2 or (
        warps == min(chunks, tk.BWD_MAX_WARPS))
    if K == 2048:               # a full grid: two chunks a warp or more
        assert spl == tk.DENSE_BWD_SPL
        assert warps == min(tk.DENSE_BWD_WARPS, -(-chunks // 2))
    if (K, S) == (2048, 256):
        assert (spl, warps) == (2, 2)
    if (K, S) == (2048, 898):
        assert (spl, warps) == (2, 4)
    if (K, S) == (32, 256):     # K11a: 256 warps, one a 32-site chunk
        assert (spl, warps, blocks) == (1, 8, 32)


def test_blocked_plan_unchanged_by_the_dense_form():
    # G > 1 keeps its staged chunks of 32 sites (K3 blocked, K10 bwd)
    spl, warps, chunks, blocks, smem = tk.rank_bwd_plan(2048, 4, 4, 256)
    assert (spl, warps, chunks, blocks) == (1, 8, 8, 2048)
    assert smem == 4 * (2 * 64 + 16 + 8 * 4 * 36 + 8 * 3 * 16 * 32)


# ----------------------------------------------------- the kernels' sums
def _twist_inputs(rng, KC, M, A, S):
    m1 = rng.uniform(0.05, 1.0, (KC, A, S)).astype(np.float32)
    m2 = rng.uniform(0.05, 1.0, (KC, A, S)).astype(np.float32)
    Pl = rng.uniform(0.05, 1.0, (M, KC, A, A)).astype(np.float32)
    Pr = rng.uniform(0.05, 1.0, (M, KC, A, A)).astype(np.float32)
    pi = rng.uniform(0.1, 1.1, A).astype(np.float32)
    pi = (pi / pi.sum()).astype(np.float32)
    w = rng.uniform(0.5, 2.0, S).astype(np.float32)
    g = rng.standard_normal((M, KC)).astype(np.float32)
    return m1, m2, Pl, Pr, pi, w, g


def _emulate_k7(m1, m2, Pl, Pr, pi, w, g, spl, warps):
    """dm1, dm2 (KC, A, S), dP_l, dP_r (M, KC, A, A) in the order of
    pair_ll_bwd_narrow_kernel: u, v chains over a (the first term a
    product), the site sum a chain over b, gsite = (g w) / site (0 on a
    masked site), dm a chain over m then b, each lane's dP a chain over
    its SPL sites, transpose_sum, the chunks in order on the warp's slot,
    the warps in order."""
    KC, A, S = m1.shape
    chunks = -(-S // (32 * spl))
    Sp = chunks * 32 * spl
    ok = np.arange(Sp) < S
    x1, x2 = (np.pad(x, ((0, 0), (0, 0), (0, Sp - S))) for x in (m1, m2))
    ws = np.pad(w, (0, Sp - S))

    def merge(x, P):                  # (M, KC, A, Sp)
        u = (x[None, :, 0, None, :] * P[:, :, 0, :, None]).astype(np.float32)
        for a in range(1, A):
            u = _fma(x[None, :, a, None, :], P[:, :, a, :, None], u)
        return u

    u, v = merge(x1, Pl), merge(x2, Pr)
    site = np.zeros(u.shape[:2] + (Sp,), np.float32)
    for b in range(A):
        site = _fma((u[:, :, b] * v[:, :, b]).astype(np.float32), pi[b], site)
    with np.errstate(invalid="ignore", divide="ignore"):
        gsite = np.where(ok, ((g[:, :, None] * ws).astype(np.float32)
                              / site).astype(np.float32), np.float32(0))
    du = (gsite[:, :, None] * (v * pi[:, None]).astype(np.float32)).astype(
        np.float32)
    dv = (gsite[:, :, None] * (u * pi[:, None]).astype(np.float32)).astype(
        np.float32)
    dms = []
    for P, d in ((Pl, du), (Pr, dv)):
        dm = np.zeros((KC, A, Sp), np.float32)
        for m in range(P.shape[0]):
            for b in range(A):
                dm = _fma(d[m, :, None, b, :], P[m, :, :, b, None], dm)
        dms.append(dm[..., :S])
    dPs = []
    for x, d in ((x1, du), (x2, dv)):
        xl, dl = _lanes(x, spl, chunks), _lanes(d, spl, chunks)
        # acc (M, KC, chunks, 32, A, A): a lane's chain over its sites
        acc = np.zeros(d.shape[:2] + (chunks, 32, A, A), np.float32)
        for j in range(spl):
            xj = np.moveaxis(xl[..., j, :], 1, 3)       # (KC, chunks, 32, A)
            dj = np.moveaxis(dl[..., j, :], 2, 4)       # (M, KC, chunks, 32, A)
            acc = _fma(xj[None, ..., :, None], dj[..., None, :], acc)
        red = np.moveaxis(_butterfly(acc, 3), 2, 0)   # (chunks, M, KC, A, A)
        dPs.append(_warp_order(red, warps))
    return dms[0], dms[1], dPs[0], dPs[1]


def _plain_k7(args):
    t = [torch.tensor(x, dtype=torch.float64) for x in args]
    return [o.numpy() for o in tk._pair_ll_bwd_plain(*t)]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("KC,M,A,S,spl", [(3, 4, 4, 256, 2), (3, 4, 4, 300, 4),
                                          (3, 4, 4, 300, 1), (2, 3, 3, 70, 2),
                                          (2, 2, 8, 40, 1)])
def test_k7_sum_order_matches_plain(rng, KC, M, A, S, spl):
    args = _twist_inputs(rng, KC, M, A, S)
    _, warps, _, _, _ = tk.twist_narrow_plan(KC, M, A, S, spl=spl)
    got = _emulate_k7(*args, spl, warps)
    want = _plain_k7(args)
    for x, ref in zip(got, want[:4]):
        assert _rel(x, ref) <= TOL
    # dpi, as the wrapper forms it from the kernel's dP_l
    dpi = np.sum(got[2] * args[2], axis=(0, 1, 2)) / args[4]
    assert _rel(dpi, want[4]) <= TOL


def _rank_inputs(rng, K, A, S, ties=False):
    m1 = rng.uniform(0.05, 1.0, (K, A, S)).astype(np.float32)
    m2 = rng.uniform(0.05, 1.0, (K, A, S)).astype(np.float32)
    Pl = rng.uniform(0.05, 1.0, (K, A, A)).astype(np.float32)
    Pr = rng.uniform(0.05, 1.0, (K, A, A)).astype(np.float32)
    pi = rng.uniform(0.1, 1.1, A).astype(np.float32)
    if ties:        # one P column shared by every state, pi uniform
        col = rng.uniform(0.05, 1.0, (K, A, 1)).astype(np.float32)
        Pl = Pr = np.broadcast_to(col, (K, A, A)).copy()
        pi = np.ones(A, np.float32)
    pi = (pi / pi.sum()).astype(np.float32)
    gm = rng.standard_normal((K, A, S)).astype(np.float32)
    gr = rng.standard_normal(K).astype(np.float32)
    gl = rng.standard_normal(K).astype(np.float32)
    w = rng.uniform(0.5, 2.0, S).astype(np.float32)
    return m1, m2, gm, gr, gl, Pl, Pr, pi, w


def _emulate_dense(m1, m2, gm, gr, gl, Pl, Pr, pi, w, spl, warps):
    """dm1, dm2, dP_l, dP_r, dpi in the order of the rank backward's dense
    form (fused_rank_bwd_blocked_kernel<A, Gather, SPL, true>): the merge
    once (u, v chains over a), the site and cotangent sums chains over
    the planes, the max and its ties; dm a chain over b from a product;
    each lane's dP and dpi terms chains over its SPL sites, transpose_sum,
    the chunks in order on the warp's slot, the warps in order."""
    K, A, S = m1.shape
    chunks = -(-S // (32 * spl))
    tiny = np.float32(np.finfo(np.float32).tiny)

    def merge(x, P):
        u = (x[:, :1] * P[:, 0, :, None]).astype(np.float32)
        for a in range(1, A):
            u = _fma(x[:, a:a + 1], P[:, a, :, None], u)
        return u

    u, v = merge(m1, Pl), merge(m2, Pr)
    wp = (u * v).astype(np.float32)
    site = np.zeros((K, S), np.float32)
    gsum = np.zeros((K, S), np.float32)
    for p in range(A):
        site = _fma(wp[:, p], pi[p], site)
        gsum = _fma(gm[:, p], wp[:, p], gsum)
    raw = wp.max(axis=1)
    neq = (wp == raw[:, None]).sum(axis=1).astype(np.float32)
    scale = np.maximum(raw, tiny)
    inv = np.float32(1) / scale
    dsite = (gr[:, None] * w) / site
    dscale = (gl[:, None] * w) / scale - gsum * (inv * inv)
    draw = dscale * ((raw > tiny).astype(np.float32)
                     + np.float32(0.5) * (raw == tiny))
    eq = (wp == raw[:, None]).astype(np.float32)
    dwp = (gm * inv[:, None] + dsite[:, None] * pi[None, :, None]
           + draw[:, None] * (eq / neq[:, None]))
    du, dv = (dwp * v).astype(np.float32), (dwp * u).astype(np.float32)
    out = []
    for P, d in ((Pl, du), (Pr, dv)):                   # y = P d
        y = (P[:, :, 0, None] * d[:, None, 0]).astype(np.float32)
        for b in range(1, A):
            y = _fma(P[:, :, b, None], d[:, None, b], y)
        out.append(y)
    for x, d in ((m1, du), (m2, dv)):
        xl, dl = _lanes(x, spl, chunks), _lanes(d, spl, chunks)
        acc = np.zeros((K, chunks, 32, A, A), np.float32)
        for j in range(spl):
            acc = _fma(np.moveaxis(xl[..., j, :], 1, 3)[..., :, None],
                       np.moveaxis(dl[..., j, :], 1, 3)[..., None, :], acc)
        out.append(_warp_order(np.moveaxis(_butterfly(acc, 2), 1, 0), warps))
    sl = _lanes(np.broadcast_to(dsite[:, None], (K, A, S)), spl, chunks)
    wl = _lanes(wp, spl, chunks)
    acc = np.zeros((K, chunks, 32, A), np.float32)
    for j in range(spl):
        acc = _fma(np.moveaxis(sl[..., j, :], 1, 3),
                   np.moveaxis(wl[..., j, :], 1, 3), acc)
    red = np.moveaxis(_butterfly(acc, 2), 1, 0)         # (chunks, K, A)
    out.append(_warp_order(red, warps).sum(0))
    return out


def _plain_rank(args):
    t = [torch.tensor(x, dtype=torch.float64) for x in args]
    return [o.numpy() for o in tk._fused_rank_bwd_saved_ref(*t)]


@pytest.mark.parametrize("S,spl", [(256, 2), (898, 2), (300, 1), (70, 2)])
@pytest.mark.parametrize("ties", [False, True])
def test_dense_rank_bwd_sum_order_matches_plain(rng, S, spl, ties):
    args = _rank_inputs(rng, 3, 4, S, ties)
    _, warps, _, _, _ = tk.rank_bwd_plan(3, 1, 4, S, spl=spl)
    got = _emulate_dense(*args, spl, warps)
    want = _plain_rank(args)
    for x, ref in zip(got, want[:4] + [want[4][0]]):
        assert _rel(x, ref) <= TOL


# ----------------------------------------------------- the CPU wrappers
def test_cpu_wrappers_keep_dw_with_want_dw(rng):
    """On the CPU the plain versions run whatever want_dw says (the card
    leaves dw out without it), as pair_ll_bwd does."""
    K, N, S = 3, 4, 37
    m1, m2, gm, gr, gl, Pl, Pr, pi, w = (torch.tensor(x, dtype=torch.float64)
                                         for x in _rank_inputs(rng, K, 4, S))
    leaves = torch.tensor(rng.uniform(0.05, 1, (N, 4, S)))
    buf = torch.tensor(rng.uniform(0.05, 1, (K, N - 1, 4, S)))
    idx = torch.tensor([[0, 1, 2], [0, 4, 5], [2, 0, 1], [1, 2, 3]],
                       dtype=torch.int32)
    cts = (gm, gr, gl, Pl, Pr, pi, w)
    for got, want in (
            (tk.fused_rank_bwd_saved(m1, m2, *cts, want_dw=False),
             tk._fused_rank_bwd_saved_ref(m1, m2, *cts)),
            (tk.fused_rank_bwd(leaves, buf, idx, *cts, want_dw=False),
             tk._fused_rank_bwd_ref(leaves, buf, idx, *cts)),
            (tk.merge_bwd(m1, m2, Pl, Pr, pi, w, gm, gr, gl, want_dw=False),
             tk._merge_bwd_ref(m1, m2, Pl, Pr, pi, w, gm, gr, gl))):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_former_dense_body_is_gone():
    with open(os.path.join(CSRC, "rank_kernels.cu")) as fh:
        rank = fh.read()
    with open(os.path.join(CSRC, "twist_kernels.cu")) as fh:
        twist = fh.read()
    assert "fused_rank_bwd_kernel" not in rank
    assert "launch_fused_rank_bwd_saved(" not in rank
    assert "launch_fused_rank_bwd(" not in rank
    assert "pair_ll_bwd_kernel" not in twist
    assert not hasattr(tk, "BWD_PARTICLES_PER_BLOCK")
    # the plans' limits mirror the sources'
    assert f"kK7MaxWarps = {tk.K7_MAX_WARPS};" in twist
    assert f"kBwdMaxWarps = {tk.BWD_MAX_WARPS};" in rank
