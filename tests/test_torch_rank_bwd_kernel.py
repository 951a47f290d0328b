"""The rank backwards' launch plans and sum orders, held on the CPU.

* `rank_bwd_plan` (K3 blocked and K10's backward) and `wide_bwd_plan`
  (K9bs, K9b and K11a above 8 states): every (particle, site) covered
  exactly once, shared memory within a block's 227 KB, a cluster of at
  most 8 blocks, and a grid that fills the H100's 132 SMs at the main
  paths' shapes.
* A float32 emulation of each kernel's order of the dP, dpi and site
  sums (FMA chains per lane or tile, the warp's butterfly, the fixed
  order over warps, chunks and cluster ranks) against the float64 plain
  version, at S = 256 and 1949, the all-planes-tied case included, to
  phase 2's tolerance (1e-4 relative).
* The wrappers on CPU tensors: the plain versions, with one partial row
  of dpi and dw.
The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from phylo_tpu_torch.pruning import kernels as tk

torch.set_num_threads(1)

TOL = 1e-4
# (K, G, A, S) of the rank backwards on the main paths and phase 3
RANK_SHAPES = [(2048, 4, 4, 256), (2048, 4, 4, 1949), (128, 4, 4, 1949),
               (512, 4, 4, 256), (2048, 5, 4, 256)]
WIDE_SHAPES = [(128, 1, 61, 256), (128, 1, 61, 1086), (32, 1, 16, 256),
               (256, 4, 20, 256), (64, 4, 20, 256), (256, 4, 20, 500)]


def _fma(x, y, z):
    """float32 fused multiply-add: the product is exact in float64."""
    return (x.astype(np.float64) * y + z).astype(np.float32)


# ------------------------------------------------------------ launch plans
@pytest.mark.parametrize("K,G,A,S", RANK_SHAPES + [(8, 32, 8, 70),
                                                   (3, 2, 3, 31)])
def test_rank_bwd_plan_covers_each_site_once(K, G, A, S):
    spl, warps, chunks, blocks, smem = tk.rank_bwd_plan(K, G, A, S)
    assert blocks == K and 1 <= warps <= tk.BWD_MAX_WARPS
    assert smem <= tk.SMEM_LIMIT
    ch = 32 * spl
    count = np.zeros(S, dtype=int)
    for w in range(warps):
        for c in range(w, chunks, warps):
            s = c * ch + 32 * np.arange(spl)[:, None] + np.arange(32)
            np.add.at(count, s[s < S], 1)
    assert (count == 1).all()


@pytest.mark.parametrize("K,G,A,S", RANK_SHAPES)
def test_rank_bwd_plan_fills_the_card(K, G, A, S):
    _, warps, _, blocks, _ = tk.rank_bwd_plan(K, G, A, S)
    # DS1's step: 16,384 warps (formerly 256 blocks of 4); phase 3's K=128
    # over all 1949 sites: 1,024
    assert blocks * warps >= (8192 if K == 2048 else 1024)


@pytest.mark.parametrize("K,G,A,S", WIDE_SHAPES + [
    (8, 1, 100, 70), (4, 1, 128, 40), (256, 6, 20, 256), (4, 1, 9, 10),
    (2, 14, 9, 600)])
def test_wide_bwd_plan_covers_each_site_once(K, G, A, S):
    sc, cluster, threads, dpt, blocks, smem = tk.wide_bwd_plan(K, G, A, S)
    npt, nst = -(-A // 4), sc // 4
    assert 1 <= cluster <= tk.MAX_CLUSTER and blocks == cluster * K
    assert smem <= tk.SMEM_LIMIT
    assert sc in (16, 32) and threads % 32 == 0
    assert G * npt * nst <= threads <= tk.WIDE_BWD_THREADS
    assert dpt in (1, 2, 4, 8) and dpt * threads >= 2 * G * npt * npt
    chunks = -(-S // sc)
    assert cluster <= chunks
    count = np.zeros((G * npt * 4, S), dtype=int)      # padded planes
    for r in range(cluster):
        for c in range(r, chunks, cluster):
            for t in range(G * npt * nst):              # (plane, site) tiles
                pt, st = divmod(t, nst)
                s = c * sc + st * 4 + np.arange(4)
                count[pt * 4:pt * 4 + 4, s[s < S]] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("K,G,A,S", WIDE_SHAPES)
def test_wide_bwd_plan_fills_the_card(K, G, A, S):
    sc, cluster, threads, _, blocks, smem = tk.wide_bwd_plan(K, G, A, S)
    # formerly one block a particle (128 at GY94, 32 at K11a); now the
    # largest cluster whose grid is one wave (a 128-block grid leaves 4 of
    # the 132 SMs idle)
    per_sm = min(tk.SMEM_LIMIT // smem, 65536 // (255 * threads))
    assert blocks >= 0.95 * tk.SMS
    assert blocks <= tk.SMS * per_sm or cluster == 1
    assert cluster == tk.MAX_CLUSTER or cluster == -(-S // sc) or \
        K * (cluster + 1) > tk.SMS * per_sm


# ----------------------------------------------------- the kernels' sums
def _inputs(rng, K, G, A, S, ties=False):
    GA = G * A
    m1 = rng.uniform(0.05, 1.0, (K, GA, S)).astype(np.float32)
    m2 = rng.uniform(0.05, 1.0, (K, GA, S)).astype(np.float32)
    Pl = rng.uniform(0.05, 1.0, (K, G, A, A)).astype(np.float32)
    Pr = rng.uniform(0.05, 1.0, (K, G, A, A)).astype(np.float32)
    pi = rng.uniform(0.1, 1.1, GA).astype(np.float32)
    if ties:        # identical blocks, one P column, pi uniform
        m1 = np.tile(m1[:, :A], (1, G, 1))
        m2 = np.tile(m2[:, :A], (1, G, 1))
        col = rng.uniform(0.05, 1.0, (K, 1, A, 1)).astype(np.float32)
        Pl = Pr = np.broadcast_to(col, (K, G, A, A)).copy()
        pi = np.ones(GA, np.float32)
    pi = (pi / pi.sum()).astype(np.float32)
    gm = rng.standard_normal((K, GA, S)).astype(np.float32)
    gr = rng.standard_normal(K).astype(np.float32)
    gl = rng.standard_normal(K).astype(np.float32)
    w = rng.uniform(0.5, 2.0, S).astype(np.float32)
    return m1, m2, gm, gr, gl, Pl, Pr, pi, w


def _merge(m, P, G, A):
    """u[k, g*A + b, s]: one FMA chain over a ascending, the first term a
    product (rank_kernels.cu `block_merge`; the wide body's chain starts
    from 0, which gives the same first rounding)."""
    K, GA, S = m.shape
    mb = m.reshape(K, G, A, S)
    u = (mb[:, :, :1, :] * P[:, :, 0, :, None]).astype(np.float32)
    for a in range(1, A):
        u = _fma(mb[:, :, a:a + 1, :], P[:, :, a, :, None], u)
    return u.reshape(K, GA, S)


def _site_scalars(wp, gm, gr, gl, pi, w, site, gsum):
    """1/scale, dsite, dscale's max share, tie count and max per (k, s),
    in float32, as both kernels form them from the site sums."""
    tiny = np.float32(np.finfo(np.float32).tiny)
    raw = wp.max(axis=1)
    neq = (wp == raw[:, None]).sum(axis=1).astype(np.float32)
    scale = np.maximum(raw, tiny)
    inv = np.float32(1) / scale
    ws = w[None]
    dsite = (gr[:, None] * ws) / site
    dscale = (gl[:, None] * ws) / scale - gsum * (inv * inv)
    draw = dscale * ((raw > tiny).astype(np.float32)
                     + np.float32(0.5) * (raw == tiny))
    return inv, dsite, draw, neq, raw


def _cotangents(u, v, wp, gm, pi, inv, dsite, draw, neq, raw):
    eq = (wp == raw[:, None]).astype(np.float32)
    dwp = (gm * inv[:, None] + dsite[:, None] * pi[None, :, None]
           + draw[:, None] * (eq / neq[:, None]))
    return (dwp * v).astype(np.float32), (dwp * u).astype(np.float32)


def _butterfly(x, axis):
    """The warp's xor-16, 8, 4, 2, 1 pair sums over 32 lanes on `axis`."""
    x = np.moveaxis(x, axis, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = (x[:h] + x[h:]).astype(np.float32)
    return x[0]


def _emulate_k3_blocked(m1, m2, gm, gr, gl, Pl, Pr, pi, w):
    """dP_l, dP_r (K, G, A, A) and dpi (GA,) in the order of
    fused_rank_bwd_blocked_kernel: per lane an FMA chain over its SPL
    sites of a chunk, transpose_sum (a butterfly over the lanes), the
    warp's chunks added in order onto its slot, the slots in warp order;
    the site sums are FMA chains over all planes in order."""
    K, GA, S = m1.shape
    G, A = Pl.shape[1], Pl.shape[-1]
    spl, warps, chunks, _, _ = tk.rank_bwd_plan(K, G, A, S)
    u, v = _merge(m1, Pl, G, A), _merge(m2, Pr, G, A)
    wp = (u * v).astype(np.float32)
    site = np.zeros((K, S), np.float32)
    gsum = np.zeros((K, S), np.float32)
    for p in range(GA):
        site = _fma(wp[:, p], pi[p], site)
        gsum = _fma(gm[:, p], wp[:, p], gsum)
    scal = _site_scalars(wp, gm, gr, gl, pi, w, site, gsum)
    du, dv = _cotangents(u, v, wp, gm, pi, *scal)
    dsite = scal[1]

    def lanes(x):       # (K, GA, S) -> (chunks, SPL, 32, K, GA), zero-padded
        pad = np.zeros((K, GA, chunks * 32 * spl), np.float32)
        pad[..., :S] = x
        return np.moveaxis(pad.reshape(K, GA, chunks, spl, 32), (2, 3, 4),
                           (0, 1, 2))

    sides = []
    for mm, dd in ((m1, du), (m2, dv)):
        x, d = lanes(mm).reshape(chunks, spl, 32, K, G, A), \
            lanes(dd).reshape(chunks, spl, 32, K, G, A)
        acc = np.zeros((chunks, 32, K, G, A, A), np.float32)
        for j in range(spl):
            acc = _fma(x[:, j, ..., :, None], d[:, j, ..., None, :], acc)
        sides.append(_butterfly(acc, 1))                 # (chunks, K, G, A, A)
    xs = lanes(np.broadcast_to(dsite[:, None], (K, GA, S)))
    acc = np.zeros((chunks, 32, K, GA), np.float32)
    for j in range(spl):
        acc = _fma(xs[:, j], lanes(wp)[:, j], acc)
    sides.append(_butterfly(acc, 1))                     # (chunks, K, GA)
    out = []
    for red in sides:
        slots = []
        for wq in range(warps):
            slot = red[wq]
            for c in range(wq + warps, chunks, warps):
                slot = (slot + red[c]).astype(np.float32)
            slots.append(slot)
        tot = slots[0]
        for slot in slots[1:]:
            tot = (tot + slot).astype(np.float32)
        out.append(tot)
    return out[0], out[1], out[2].sum(0)


def _emulate_wide(m1, m2, gm, gr, gl, Pl, Pr, pi, w):
    """dm1, dm2, dP_l, dP_r in the order of wide_rank_bwd_kernel: u, v
    FMA chains from 0; each site's pi- and gm-sums as FMA chains over the
    planes of each 4-plane tile, the warp's four tiles as (t0 + t1) +
    (t2 + t3), the warps in order; dm chains over b; dP per cluster rank
    a chain over its chunks' sites in order, the ranks summed in order."""
    K, GA, S = m1.shape
    G, A = Pl.shape[1], Pl.shape[-1]
    sc, cluster, *_ = tk.wide_bwd_plan(K, G, A, S)
    nst, npt = sc // 4, -(-A // 4)
    u, v = _merge(m1, Pl, G, A), _merge(m2, Pr, G, A)
    wp = (u * v).astype(np.float32)
    tiles = G * npt
    per_warp = 32 // nst
    ntile = -(-tiles // per_warp) * per_warp
    ps = np.zeros((ntile, K, S), np.float32)
    pg = np.zeros((ntile, K, S), np.float32)
    for t in range(tiles):
        g, ti = divmod(t, npt)
        for i in range(4):
            if ti * 4 + i < A:
                p = g * A + ti * 4 + i
                ps[t] = _fma(wp[:, p], pi[p], ps[t])
                pg[t] = _fma(gm[:, p], wp[:, p], pg[t])

    def combine(x):
        x = x.reshape(-1, per_warp, K, S)
        step = 1
        while step < per_warp:   # xor NST, 2 NST, ...: adjacent tiles first
            x = x.reshape(x.shape[0], -1, 2, K, S)
            x = (x[:, :, 0] + x[:, :, 1]).astype(np.float32)
            step *= 2
        tot = np.zeros((K, S), np.float32)
        for q in range(x.shape[0]):
            tot = (tot + x[q, 0]).astype(np.float32)
        return tot

    site, gsum = combine(ps), combine(pg)
    du, dv = _cotangents(u, v, wp, gm, pi,
                         *_site_scalars(wp, gm, gr, gl, pi, w, site, gsum))
    out = []
    for P, d in ((Pl, du), (Pr, dv)):                    # dm = P d
        db = d.reshape(K, G, A, S)
        dm = np.zeros((K, G, A, S), np.float32)
        for b in range(A):
            dm = _fma(P[:, :, :, b, None], db[:, :, None, b, :], dm)
        out.append(dm.reshape(K, GA, S))
    for mm, d in ((m1, du), (m2, dv)):                   # dP = m d^T
        mb, db = mm.reshape(K, G, A, S), d.reshape(K, G, A, S)
        tot = np.zeros((K, G, A, A), np.float32)
        for r in range(cluster):
            acc = np.zeros((K, G, A, A), np.float32)
            for c in range(r, -(-S // sc), cluster):
                for s in range(c * sc, min(S, c * sc + sc)):
                    acc = _fma(mb[..., :, None, s], db[..., None, :, s], acc)
            tot = (tot + acc).astype(np.float32)
        out.append(tot)
    return out


def _plain(args):
    t = [torch.tensor(x, dtype=torch.float64) for x in args]
    out = tk._fused_rank_bwd_saved_ref(*t)
    return [o.numpy() for o in out]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("S", [256, 1949])
@pytest.mark.parametrize("ties", [False, True])
def test_k3_blocked_sum_order_matches_plain(rng, S, ties):
    args = _inputs(rng, 3, 4, 4, S, ties)
    dPl, dPr, dpi = _emulate_k3_blocked(*args)
    want = _plain(args)
    for got, ref in ((dPl, want[2]), (dPr, want[3]), (dpi, want[4][0])):
        assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("G,A,S,ties", [(1, 61, 256, False),
                                        (1, 61, 1949, False),
                                        (1, 61, 256, True),
                                        (4, 20, 256, True),
                                        (1, 16, 1949, False)])
def test_wide_sum_order_matches_plain(rng, G, A, S, ties):
    args = _inputs(rng, 2, G, A, S, ties)
    dm1, dm2, dPl, dPr = _emulate_wide(*args)
    want = _plain(args)
    for got, ref in zip((dm1, dm2, dPl, dPr), want[:4]):
        assert _rel(got, ref.reshape(got.shape)) <= TOL


# ----------------------------------------------------- the CPU wrappers
@pytest.mark.parametrize("G,A", [(4, 4), (1, 61), (4, 20)])
def test_cpu_wrappers_run_the_plain_versions(rng, G, A):
    K, N, S = 3, 4, 37
    GA = G * A
    leaves = torch.tensor(rng.uniform(0.05, 1, (N, GA, S)))
    buf = torch.tensor(rng.uniform(0.05, 1, (K, N - 1, GA, S)))
    idx = torch.tensor([[0, 1, 2], [0, 4, 5], [2, 0, 1], [1, 2, 3]],
                       dtype=torch.int32)
    m1, m2, gm, gr, gl, Pl, Pr, pi, w = (torch.tensor(x, dtype=torch.float64)
                                         for x in _inputs(rng, K, G, A, S))
    if G == 1:
        Pl, Pr = Pl[:, 0], Pr[:, 0]
    cts = (gm, gr, gl, Pl, Pr, pi, w)
    for got, want in (
            (tk.fused_rank_bwd_saved(m1, m2, *cts),
             tk._fused_rank_bwd_saved_ref(m1, m2, *cts)),
            (tk.fused_rank_bwd(leaves, buf, idx, *cts),
             tk._fused_rank_bwd_ref(leaves, buf, idx, *cts))):
        assert got[4].shape == (1, GA) and got[5].shape == (1, S)
        assert got[2].shape == Pl.shape
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    if G == 1:
        got = tk.merge_bwd(m1, m2, Pl, Pr, pi, w, gm, gr, gl)
        assert got[4].shape == (GA,) and got[5].shape == (S,)
