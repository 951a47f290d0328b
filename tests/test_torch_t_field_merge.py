"""K11c (the T-field twist backward: K7's bodies in their T-field form)
and K8 (the merge on explicit children), held on the CPU without JAX.

* The launch plans: K11c's at A = 4 (`twist_narrow_plan(t_field=True)`)
  and 16 (`twist_bwd_plan(1, 16, S, t_field=True)`), each (m, row,
  site) covered once, shared memory within a block's 227 KB, a grid that
  fills the H100; K8's (`merge_ll_plan`) at K = 32 with S = 256 and 898
  and beyond: every site once, at most 1024 threads (512 above 4
  states), a block a particle.
* A float32 emulation of each kernel's sum order against the float64
  plain version: K11c's T partials (a lane's chain over its sites, the
  warp's butterfly, the chunks on a warp's slot and the warps in order;
  above 8 states a KS-lane tile's chain and butterfly and the chunks in
  order), dm as K7's, and dP from T in the kernel, at ragged S, M = 1
  and 10, A = 4 and 16, to 1e-4 relative (phase 2's tolerance); K8's
  chains and its site-sum tree (a thread's sites, the warp's butterfly,
  the warps' butterfly) to 1e-5.
* The CPU route of `pair_ll_bwd` under TWIST_BWD_V2, bit-identical to
  the plain T-field version as it stood before the kernels formed dP.
* The former tile body's removal from the sources.
The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py."""

import os

import numpy as np
import pytest
import torch

from phylo_tpu_torch.models.expm import exact_matmul
from phylo_tpu_torch.pruning import kernels as tk

torch.set_num_threads(1)

TOL, K8_TOL = 1e-4, 1e-5
CSRC = os.path.join(os.path.dirname(tk.__file__), os.pardir, "csrc")
F32 = np.float32


def _src(name):
    with open(os.path.join(CSRC, name + ".cu")) as fh:
        return fh.read()


def _fma(x, y, z):
    """float32 fused multiply-add: the product is exact in float64."""
    return (np.asarray(x, np.float64) * y + z).astype(F32)


def _butterfly(x, axis):
    """Pair sums (l, l + h) for h = n/2, n/4, ... 1 over `axis`: a warp's
    xor or shfl_down tree, as lane 0 (or every lane) sees it."""
    x = np.moveaxis(x, axis, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = (x[:h] + x[h:]).astype(F32)
    return x[0]


def _lanes(x, spl, chunks):
    """(..., S) -> (..., chunks, SPL, 32), zero-padded: lane l of chunk c
    holds site c 32 SPL + 32 j + l as its j-th."""
    pad = np.zeros(x.shape[:-1] + (chunks * 32 * spl,), F32)
    pad[..., :x.shape[-1]] = x
    return pad.reshape(x.shape[:-1] + (chunks, spl, 32))


def _warp_order(red, warps):
    """Chunk sums red[c] onto warp c % warps's slot in chunk order, then
    the slots in warp order."""
    tot = None
    for wq in range(warps):
        slot = red[wq]
        for c in range(wq + warps, red.shape[0], warps):
            slot = (slot + red[c]).astype(F32)
        tot = slot if tot is None else (tot + slot).astype(F32)
    return tot


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ launch plans
# (KC, M, S) of K11c at A = 4 (primate rank 0, ragged S, later ranks) and
# at 16 dense states (DS1's KC = 896 and rank 0's 11,232, ragged S)
NARROW_SHAPES = [(2112, 10, 256), (2112, 10, 300), (480, 10, 256),
                 (32, 10, 256), (2112, 1, 70), (5, 3, 33)]
WIDE_SHAPES = [(896, 10, 256), (11232, 10, 256), (896, 10, 300),
               (896, 1, 1949), (15, 3, 70)]


@pytest.mark.parametrize("KC,M,S", NARROW_SHAPES)
def test_k11c_narrow_plan(KC, M, S):
    spl, warps, chunks, blocks, smem = tk.twist_narrow_plan(
        KC, M, 4, S, t_field=True)
    # the same sites, warps and grid as K7's plan, half its slots
    assert (spl, warps, chunks, blocks) == tk.twist_narrow_plan(
        KC, M, 4, S)[:4]
    assert smem == tk.k7_smem(M, 4, warps, t_field=True) <= tk.SMEM_LIMIT
    assert smem < tk.k7_smem(M, 4, warps)
    count = np.zeros(S, dtype=int)
    for wq in range(warps):
        for c in range(wq, chunks, warps):
            s = c * 32 * spl + 32 * np.arange(spl)[:, None] + np.arange(32)
            np.add.at(count, s[s < S], 1)
    assert (count == 1).all()       # for every m: the m loop is inside
    # 8 warps an SM, or every chunk of a row its own warp
    assert blocks * warps >= tk.GRID_WARPS // 2 or (
        warps == min(chunks, tk.K7_MAX_WARPS))
    if KC == 2112 and S == 256:     # primate rank 0: a warp a row
        assert (spl, warps) == (2, 1)


@pytest.mark.parametrize("KC,M,S", WIDE_SHAPES)
def test_k11c_wide_plan(KC, M, S):
    A = 16
    sc, threads, smem = tk.twist_bwd_plan(1, A, S, t_field=True)
    k7 = tk.twist_bwd_plan(1, A, S)
    # K7 wide's chunk and threads, plus the staged T (A x ABP floats)
    assert (sc, threads) == k7[:2]
    assert smem == k7[2] + 4 * A * 4 * -(-A // 4) <= tk.SMEM_LIMIT
    NGT, SG = -(-A // 4), sc // 4
    assert NGT * SG <= threads <= tk.BWD_MAX_THREADS and threads % 32 == 0
    # thread t < NGT SG owns planes 4 (t // SG) .. + 3 and sites 4 (t % SG)
    # .. + 3 of each chunk s0 = 0, SC, ...
    count = np.zeros((A, S), dtype=int)
    for s0 in range(0, S, sc):
        for t in range(NGT * SG):
            q, sg = divmod(t, SG)
            for i in range(4):
                a = 4 * q + i
                s = s0 + 4 * sg + np.arange(4)
                if a < A:
                    np.add.at(count[a], s[s < S], 1)
    assert (count == 1).all()
    # a block a row: the row counts the twist launches fill 132 SMs
    if KC >= 896:
        assert KC >= tk.SMS * 6
    # the T tiles: NPG^2 of them, KS threads each, in one pass
    TC, KS = NGT * NGT, 1
    while KS < 32 and 2 * KS * TC <= threads:
        KS *= 2
    assert TC * KS <= threads


@pytest.mark.parametrize("A", [20, 61, 64])
def test_k11c_wide_plan_fits_every_width(A):
    for S in (1, 70, 256, 300, 1086):
        sc, threads, smem = tk.twist_bwd_plan(1, A, S, t_field=True)
        assert 32 <= sc <= 256 and smem <= tk.SMEM_LIMIT
        assert -(-A // 4) * sc // 4 <= threads <= tk.BWD_MAX_THREADS


def _k8_sites(S, threads):
    """Times each site is written under K8's mapping: thread t owns t + i
    threads, one a pass."""
    count = np.zeros(S, dtype=int)
    for s0 in range(0, S, threads):
        s = s0 + np.arange(threads)
        np.add.at(count, s[s < S], 1)
    return count


@pytest.mark.parametrize("A", [4, 8])
@pytest.mark.parametrize("S", [256, 898, 1, 33, 1949, 5000])
def test_k8_plan(S, A):
    threads = tk.merge_ll_plan(S, A)
    top = 1024 if A <= 4 else 512
    assert 32 <= threads <= top and threads % 32 == 0
    assert tk.MERGE_MAX_THREADS == 1024
    assert (_k8_sites(S, threads) == 1).all()
    if S <= top:             # the VNCSMC path's 256 and 898: no walk
        assert S <= threads < S + 32
    else:                    # as many threads as allowed, then passes
        assert threads == top


def test_plans_mirror_the_sources():
    twist = _src("twist_kernels")
    assert f"kK8MaxThreads = {tk.MERGE_MAX_THREADS};" in twist
    assert "A <= 4 ? kK8MaxThreads : kK8MaxThreads / 2" in twist
    assert f"kK7MaxWarps = {tk.K7_MAX_WARPS};" in twist
    # K8's cluster form (b) lost to one block a particle and is gone
    for gone in ("cooperative_groups", "ClusterDimension", "map_shared_rank"):
        assert gone not in twist
    # and so is its form of two sites a thread a pass: one instance an A
    assert "merge_loglik_kernel<AA><<<K, threads, 0, st>>>" in twist
    assert "SPT" not in twist


# ----------------------------------------------------- the kernels' sums
def _twist_inputs(rng, KC, M, A, S):
    m1 = rng.uniform(0.05, 1.0, (KC, A, S)).astype(F32)
    m2 = rng.uniform(0.05, 1.0, (KC, A, S)).astype(F32)
    Pl = rng.uniform(0.05, 1.0, (M, KC, A, A)).astype(F32)
    Pr = rng.uniform(0.05, 1.0, (M, KC, A, A)).astype(F32)
    pi = rng.uniform(0.1, 1.1, A).astype(F32)
    pi = (pi / pi.sum()).astype(F32)
    w = rng.uniform(0.5, 2.0, S).astype(F32)
    g = rng.standard_normal((M, KC)).astype(F32)
    return m1, m2, Pl, Pr, pi, w, g


def _merge(x, P):
    """u[m, k, b, s] = sum_a x[k, a, s] P[m, k, a, b]: a chain over a
    from a product."""
    A = x.shape[1]
    u = (x[None, :, 0, None, :] * P[:, :, 0, :, None]).astype(F32)
    for a in range(1, A):
        u = _fma(x[None, :, a, None, :], P[:, :, a, :, None], u)
    return u


def _dm(P, d):
    """dm[k, a, s] = sum_m sum_b d[m, k, b, s] P[m, k, a, b]: a chain over
    m, then b (both bodies keep dm in registers across all M)."""
    M, KC, A = P.shape[:3]
    dm = np.zeros((KC, A, d.shape[-1]), F32)
    for m in range(M):
        for b in range(A):
            dm = _fma(d[m, :, None, b, :], P[m, :, :, b, None], dm)
    return dm


def _dp_from_t(T, Pl, Pr, pi):
    """dP_l[a, b] = pi_b sum_a' T[a, a'] P_r[a', b], dP_r[a', b] = pi_b
    sum_a T[a, a'] P_l[a, b]: chains over a' (a) from a product, then the
    product with pi_b (both bodies)."""
    A = T.shape[-1]
    dl = (T[..., :, 0, None] * Pr[..., 0, None, :]).astype(F32)
    dr = (T[..., 0, :, None] * Pl[..., 0, None, :]).astype(F32)
    for q in range(1, A):
        dl = _fma(T[..., :, q, None], Pr[..., q, None, :], dl)
        dr = _fma(T[..., q, :, None], Pl[..., q, None, :], dr)
    return (dl * pi).astype(F32), (dr * pi).astype(F32)


def _emulate_t_narrow(m1, m2, Pl, Pr, pi, w, g, spl, warps):
    """dm1, dm2, dP_l, dP_r in the order of pair_ll_bwd_t_narrow_kernel
    (K7's body, T_FIELD): u, v and the site sum as K7, gsite = (g w) /
    site (0 on a masked site); T[a, a'] a lane's chain over its SPL sites
    of fma(gsite m1[a], m2[a'], .), transpose_sum (a butterfly over
    lanes), the chunks in order on the warp's slot, the warps in order;
    then dP from T."""
    KC, A, S = m1.shape
    chunks = -(-S // (32 * spl))
    Sp = chunks * 32 * spl
    ok = np.arange(Sp) < S
    x1, x2 = (np.pad(x, ((0, 0), (0, 0), (0, Sp - S))) for x in (m1, m2))
    ws = np.pad(w, (0, Sp - S))
    u, v = _merge(x1, Pl), _merge(x2, Pr)
    site = np.zeros(u.shape[:2] + (Sp,), F32)
    for b in range(A):
        site = _fma((u[:, :, b] * v[:, :, b]).astype(F32), pi[b], site)
    with np.errstate(invalid="ignore", divide="ignore"):
        gsite = np.where(ok, ((g[:, :, None] * ws).astype(F32)
                              / site).astype(F32), F32(0))
    du = (gsite[:, :, None] * (v * pi[:, None]).astype(F32)).astype(F32)
    dv = (gsite[:, :, None] * (u * pi[:, None]).astype(F32)).astype(F32)
    gx = (gsite[:, :, None, :] * x1[None]).astype(F32)  # (M, KC, A, Sp)
    gl, xl = _lanes(gx, spl, chunks), _lanes(x2, spl, chunks)
    acc = np.zeros(gx.shape[:2] + (chunks, 32, A, A), F32)
    for j in range(spl):
        gj = np.moveaxis(gl[..., j, :], 2, 4)         # (M, KC, chunks, 32, A)
        xj = np.moveaxis(xl[..., j, :], 1, 3)         # (KC, chunks, 32, A)
        acc = _fma(gj[..., :, None], xj[None, ..., None, :], acc)
    red = np.moveaxis(_butterfly(acc, 3), 2, 0)       # (chunks, M, KC, A, A)
    T = _warp_order(red, warps)
    dPl, dPr = _dp_from_t(T, Pl, Pr, pi)
    return _dm(Pl, du)[..., :S], _dm(Pr, dv)[..., :S], dPl, dPr


def _emulate_t_wide(m1, m2, Pl, Pr, pi, w, g, sc, threads):
    """dm1, dm2, dP_l, dP_r in the order of pair_ll_bwd_t_wide_kernel (K7
    wide's body at G = 1, T_FIELD), chunk by chunk of SC sites: u, v
    chains over a; the site sum a chain over each group of 4 planes, the
    groups added in order; gsite = (g w) / site; dm as K7; T[a, a'] over
    the chunk by KS lanes a tile, lane kl taking the site quads kl, kl +
    KS, ... as fma(m1[a], gsite m2[a'], .), then a butterfly over the KS
    lanes; dP from the chunk's T, added onto the earlier chunks' in
    order."""
    KC, A, S = m1.shape
    NPG = -(-A // 4)
    TC, KS = NPG * NPG, 1
    while KS < 32 and 2 * KS * TC <= threads:
        KS *= 2
    nq = -(-sc // (4 * KS))             # a lane's site quads a chunk
    scp = nq * 4 * KS                   # lanes past SC take no quad
    dm1 = np.zeros_like(m1)
    dm2 = np.zeros_like(m2)
    dPl = dPr = None
    for s0 in range(0, S, sc):
        n = min(sc, S - s0)
        x1, x2 = (np.pad(x[..., s0:s0 + n], ((0, 0), (0, 0), (0, sc - n)))
                  for x in (m1, m2))
        ws = np.pad(w[s0:s0 + n], (0, sc - n))
        u, v = _merge(x1, Pl), _merge(x2, Pr)
        site = None
        for q in range(NPG):
            part = np.zeros(u.shape[:2] + (sc,), F32)
            for b in range(4 * q, min(A, 4 * q + 4)):
                part = _fma((u[:, :, b] * v[:, :, b]).astype(F32), pi[b], part)
            site = part if site is None else (site + part).astype(F32)
        with np.errstate(invalid="ignore", divide="ignore"):
            gsite = np.where(np.arange(sc) < n, ((g[:, :, None] * ws)
                                                 .astype(F32) / site)
                             .astype(F32), F32(0))
        du = (gsite[:, :, None] * (v * pi[:, None]).astype(F32)).astype(F32)
        dv = (gsite[:, :, None] * (u * pi[:, None]).astype(F32)).astype(F32)
        dm1[..., s0:s0 + n] = _dm(Pl, du)[..., :n]
        dm2[..., s0:s0 + n] = _dm(Pr, dv)[..., :n]
        dd = (gsite[:, :, None, :] * x2[None]).astype(F32)  # (M, KC, A, sc)
        # sites as (quad i, lane kl, jj): s = (i KS + kl) 4 + jj
        xq = np.pad(x1, ((0, 0), (0, 0), (0, scp - sc))).reshape(
            KC, A, nq, KS, 4)
        dq = np.pad(dd, ((0, 0),) * 3 + ((0, scp - sc),)).reshape(
            dd.shape[:3] + (nq, KS, 4))
        acc = np.zeros(dd.shape[:2] + (KS, A, A), F32)
        for i in range(nq):
            for jj in range(4):
                xa = np.moveaxis(xq[:, :, i, :, jj], 1, 2)      # (KC, KS, A)
                da = np.moveaxis(dq[:, :, :, i, :, jj], 2, 3)   # (M,KC,KS,A)
                acc = _fma(xa[None, ..., :, None], da[..., None, :], acc)
        T = _butterfly(acc, 2)                              # (M, KC, A, A)
        cl, cr = _dp_from_t(T, Pl, Pr, pi)
        if dPl is None:
            dPl, dPr = cl, cr
        else:
            dPl, dPr = (dPl + cl).astype(F32), (dPr + cr).astype(F32)
    return dm1, dm2, dPl, dPr


def _plain_t(args):
    t = [torch.tensor(x, dtype=torch.float64) for x in args]
    return [o.numpy() for o in tk._pair_ll_bwd_t_ref(*t)]


def _check_t(got, args, want):
    for x, ref in zip(got, want[:4]):
        assert _rel(x, ref) <= TOL
    # dpi, as the wrapper forms it from the kernel's dP_l
    dpi = np.sum(got[2] * args[2], axis=(0, 1, 2)) / args[4]
    assert _rel(dpi, want[4]) <= TOL


@pytest.mark.parametrize("KC,M,A,S,spl", [
    (3, 10, 4, 256, 2), (3, 10, 4, 300, 2), (3, 1, 4, 300, 4),
    (2, 10, 4, 70, 1), (2, 3, 3, 70, 2), (2, 2, 8, 40, 1)])
def test_k11c_narrow_sum_order_matches_plain(rng, KC, M, A, S, spl):
    args = _twist_inputs(rng, KC, M, A, S)
    warps = tk.twist_narrow_plan(KC, M, A, S, spl=spl, t_field=True)[1]
    got = _emulate_t_narrow(*args, spl, warps)
    _check_t(got, args, _plain_t(args))
    # several warps a row sum their slots in warp order
    if -(-S // (32 * spl)) > 1:
        _check_t(_emulate_t_narrow(*args, spl, 2), args, _plain_t(args))


@pytest.mark.parametrize("KC,M,A,S", [(2, 10, 16, 256), (2, 10, 16, 300),
                                      (2, 1, 16, 600), (2, 3, 20, 70),
                                      (1, 2, 61, 40)])
def test_k11c_wide_sum_order_matches_plain(rng, KC, M, A, S):
    args = _twist_inputs(rng, KC, M, A, S)
    sc, threads, _ = tk.twist_bwd_plan(1, A, S, t_field=True)
    _check_t(_emulate_t_wide(*args, sc, threads), args, _plain_t(args))


def _emulate_k8(m1, m2, Pl, Pr, pi, w, threads):
    """merged, rootll, logscale in the order of merge_loglik_kernel: u, v
    chains over a, w = u v, the site sum a chain over b, merged = w /
    max(max_b w, tiny); the two log sums a chain over a thread's sites
    (fma(log x, w_s, .)), lane 0's shfl_down tree over the warp and the
    warps' totals by the same tree."""
    K, A, S = m1.shape
    u = _merge(m1, Pl[None])[0]
    v = _merge(m2, Pr[None])[0]
    wv = (u * v).astype(F32)
    raw = wv.max(axis=1)
    scale = np.maximum(raw, F32(np.finfo(F32).tiny))
    site = (wv[:, 0] * pi[0]).astype(F32)
    for b in range(1, A):
        site = _fma(wv[:, b], pi[b], site)
    merged = (wv / scale[:, None]).astype(F32)
    npass, nw = -(-S // threads), threads // 32
    out = []
    for x in (np.log(site), np.log(scale)):
        lx = np.zeros((K, npass * threads), F32)
        lx[:, :S] = x
        wp = np.zeros(npass * threads, F32)
        wp[:S] = w
        # (K, pass, warp, lane): thread t's i-th site i threads + t
        lx = lx.reshape(K, npass, nw, 32)
        wp = wp.reshape(npass, nw, 32)
        acc = np.zeros((K, nw, 32), F32)
        for i in range(npass):
            acc = _fma(lx[:, i], wp[i], acc)
        pad = np.zeros((K, 32), F32)
        pad[:, :nw] = _butterfly(acc, 2)                # (K, warps)
        out.append(_butterfly(pad, 1))
    return merged, out[0], out[1]


@pytest.mark.parametrize("S", [256, 898, 70, 1500, 2600])
@pytest.mark.parametrize("A", [4, 7])
def test_k8_sum_order_matches_plain(rng, S, A):
    K = 5
    m1, m2 = (rng.uniform(0.05, 1.0, (K, A, S)).astype(F32)
              for _ in range(2))
    Pl, Pr = (rng.uniform(0.05, 1.0, (K, A, A)).astype(F32)
              for _ in range(2))
    pi = rng.uniform(0.1, 1.1, A).astype(F32)
    pi = (pi / pi.sum()).astype(F32)
    w = rng.uniform(0.5, 2.0, S).astype(F32)
    got = _emulate_k8(m1, m2, Pl, Pr, pi, w, tk.merge_ll_plan(S, A))
    want = [o.numpy() for o in tk._ref_impl(*(torch.tensor(
        x, dtype=torch.float64) for x in (m1, m2, Pl, Pr, pi, w)))]
    assert float(np.abs(got[0] - want[0]).max()) <= K8_TOL
    assert _rel(got[1], want[1]) <= K8_TOL
    assert _rel(got[2], want[2]) <= K8_TOL


# ----------------------------------------------------- the CPU route
def _t_ref_as_it_stood(m1, m2, P_l, P_r, pi, weights, g):
    """The plain T-field version, verbatim as the wrapper's CPU route ran
    it before K11c formed dP in its kernel."""
    u = tk._apply_t(m1[None], P_l)
    v = tk._apply_t(m2[None], P_r)
    pu = u * pi[:, None]
    pv = v * pi[:, None]
    site = torch.sum(u * pv, dim=-2)
    gsite = (g[:, :, None] * weights) / site
    T = exact_matmul(gsite[:, :, None, :] * m1[None],
                     m2[None].transpose(-1, -2))
    dm1 = torch.sum(gsite[:, :, None, :] * exact_matmul(P_l, pv), dim=0)
    dm2 = torch.sum(gsite[:, :, None, :] * exact_matmul(P_r, pu), dim=0)
    dPl, dPr = (exact_matmul(T, P_r) * pi,
                exact_matmul(T.transpose(-1, -2), P_l) * pi)
    dpi = torch.sum(dPl * P_l, dim=(0, 1, 2)) / pi
    return dm1, dm2, dPl, dPr, dpi, tk._dw_ref(m1, m2, P_l, P_r, pi, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("A", [4, 16])
def test_cpu_route_under_twist_bwd_v2_is_unchanged(rng, monkeypatch, dtype,
                                                   A):
    args = [torch.tensor(x, dtype=dtype)
            for x in _twist_inputs(rng, 3, 4, A, 37)]
    monkeypatch.setattr(tk, "TWIST_BWD_V2", True)
    got = tk.pair_ll_bwd(*args)
    for a, b in zip(got, _t_ref_as_it_stood(*args)):
        assert torch.equal(a, b)
    for a, b in zip(got, tk._pair_ll_bwd_t_ref(*args)):
        assert torch.equal(a, b)


def test_t_field_route_is_dense_only(rng, monkeypatch):
    """The T-field route is no longer dense only: under TWIST_BWD_V2 a
    blocked P takes the blocked T-field plain version (K11c blocked on
    the card), which equals the plain K7 VJP, and `twist_blocks` keeps
    rate mixtures on the blocked route."""
    m1, m2, _, _, pi, w, g = (torch.tensor(x, dtype=torch.float64) for x in
                              _twist_inputs(rng, 3, 4, 8, 37))
    Pb = torch.tensor(rng.uniform(0.05, 1.0, (4, 3, 2, 4, 4)))
    monkeypatch.setattr(tk, "TWIST_BWD_V2", True)
    got = tk.pair_ll_bwd(m1, m2, Pb, Pb, pi, w, g)
    for a, b in zip(got, tk._pair_ll_bwd_t_ref(m1, m2, Pb, Pb, pi, w, g)):
        assert torch.equal(a, b)
    for a, b in zip(got, tk._pair_ll_bwd_plain(m1, m2, Pb, Pb, pi, w, g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-300)

    class Mixture:
        blocks = (4, 4)
    assert tk.twist_blocks(Mixture()) == (4, 4)


# ------------------------------------------------------- the sources
def test_former_tile_body_is_gone():
    wide, narrow = _src("twist_wide_kernels"), _src("twist_kernels")
    for gone in ("pair_ll_bwd_t_kernel", "run_bwd_t", "kTThreads", "kTile",
                 "kPitch"):
        assert gone not in wide and gone not in narrow
    # K11c is K7's bodies in their T-field form, under the launcher's name
    assert "pair_ll_bwd_t_narrow_kernel" in narrow
    assert "k7_body<A, SPL, true>" in narrow
    assert "pair_ll_bwd_t_wide_kernel" in wide
    assert "bwd_wide_body<FIXED_AB, true>" in wide
    assert 'extern "C" int launch_pair_ll_bwd_t(' in narrow
    assert 'extern "C" int launch_pair_ll_bwd_t(' in wide
    # no T buffer, no _dp_from_t on the card's route
    import inspect
    src = inspect.getsource(tk.pair_ll_bwd)
    assert "_dp_from_t" not in src
