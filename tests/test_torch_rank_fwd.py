"""The rank forward (K1, and K10's forward: csrc/rank_kernels.cu's
`fused_rank_fwd_kernel`), held on the CPU.

* `rank_fwd_plan` and `fwd_blocks` (the register form up to 4 blocks of
  4 states, else the staged form): every (particle, site) covered
  exactly once, shared memory within a block's 227 KB at every G <= 32
  blocks of A <= 8 states, and a grid of at least 8 warps an SM of the
  H100's 132 at the main paths' shapes (primate K = 2048 at S = 256 and
  898, DS1 GTR+G4 K = 2048 at S = 256 and 1949), with the forms the
  plan picks there.
* A float32 emulation of the kernel's order against the float64 plain
  version `_fused_rank_ref`, to phase 2's tolerances (the column 1e-5
  abs, rootll and logscale 1e-5 rel): block_merge's chains, the site sum
  a chain over the planes, the column w times one reciprocal of the
  scale a site from the one pass, each lane's log terms a chain over its
  sites, the warp's butterfly and the warps in order; dense (G = 1),
  blocked (G = 4), G = 5 with block 0 the identity (+I) and the
  all-planes-tied case.
* The wrapper on CPU tensors is the plain version, and the former bodies
  and launchers are gone from the sources.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""

import os

import numpy as np
import pytest
import torch

from phylo_tpu_torch.pruning import kernels as tk

torch.set_num_threads(1)

TOL = 1e-5
CSRC = os.path.join(os.path.dirname(tk.__file__), os.pardir, "csrc")
# (K, G, A, S): primate VCSMC, DS1 GTR+G4 and +I, short grids (GTR+G4 at
# K = 512 and 128, K11a's K = 32), ragged and the widest blocks
PLAN_SHAPES = [(2048, 1, 4, 256), (2048, 1, 4, 898), (2048, 4, 4, 256),
               (2048, 4, 4, 1949), (2048, 5, 4, 256), (512, 4, 4, 256),
               (128, 4, 4, 1949), (32, 1, 4, 256), (3, 1, 4, 70),
               (7, 3, 3, 31), (2048, 32, 8, 256), (64, 20, 7, 1000)]
MAIN_SHAPES = [(2048, 1, 4, 256), (2048, 1, 4, 898), (2048, 4, 4, 256),
               (2048, 4, 4, 1949)]


def _fma(x, y, z):
    """float32 fused multiply-add: the product is exact in float64."""
    return (np.asarray(x, np.float64) * y + z).astype(np.float32)


def _chunks_of(warp, warps, chunks):
    """Warp w's chunks: w, w + warps, ..."""
    return range(warp, chunks, warps)


def _sites_of(warps, chunks, spl, S):
    """Times each site is taken by the warps' chunks."""
    count = np.zeros(S, dtype=int)
    for wq in range(warps):
        for c in _chunks_of(wq, warps, chunks):
            s = c * 32 * spl + 32 * np.arange(spl)[:, None] + np.arange(32)
            np.add.at(count, s[s < S], 1)
    return count


# ------------------------------------------------------------ launch plan
@pytest.mark.parametrize("K,G,A,S", PLAN_SHAPES)
def test_rank_fwd_plan_covers_each_site_once(K, G, A, S):
    spl, warps, chunks, blocks, smem = tk.rank_fwd_plan(K, G, A, S)
    assert blocks == K
    assert spl in ((1, 2) if G == 1 else (1,))   # the launcher's instances
    assert 1 <= warps <= min(chunks, tk.FWD_MAX_WARPS)
    assert chunks == -(-S // (32 * spl))
    assert smem == tk.rank_fwd_smem(G, A, warps, spl) <= tk.SMEM_LIMIT
    assert (_sites_of(warps, chunks, spl, S) == 1).all()


@pytest.mark.parametrize("A", range(1, tk.MAX_A + 1))
def test_rank_fwd_plan_fits_shared_memory(A):
    for G in range(1, tk.MAX_G + 1):
        for K, S in ((2048, 256), (2048, 1949), (32, 5000)):
            spl, warps, _, _, smem = tk.rank_fwd_plan(K, G, A, S)
            ng = tk.fwd_blocks(G, A)
            assert smem <= tk.SMEM_LIMIT, (G, A, K, S)
            if ng == 0:     # the stage, the transitions and pi, the sums
                assert smem == 4 * (2 * G * A * A + G * A + warps * (
                    2 + 2 * G * A * 32 * spl))
            elif G > 1:     # the register form: transitions, pi, sums
                assert smem == 4 * (2 * G * A * A + G * A + 2 * warps)
            else:           # the dense form: the sums alone
                assert smem == 8 * warps


@pytest.mark.parametrize("K,G,A,S", MAIN_SHAPES)
def test_rank_fwd_plan_fills_the_card(K, G, A, S):
    spl, warps, chunks, blocks, _ = tk.rank_fwd_plan(K, G, A, S)
    assert blocks * warps >= tk.GRID_WARPS // 2
    # about FWD_WARP_CHUNKS chunks a warp, at most FWD_MAX_WARPS
    assert spl == (tk.FWD_SPL if G == 1 else 1)
    assert warps == min(tk.FWD_MAX_WARPS, -(-chunks // tk.FWD_WARP_CHUNKS))
    if G > 1:
        assert tk.fwd_blocks(G, A) == 4       # DS1's G = 4 in registers
    # the forms the plan picks: K1 S=256 / 898, K10 S=256 / 1949
    assert warps == {(1, 256): 1, (1, 898): 2, (4, 256): 1, (4, 1949): 8}[
        (G, S)]


@pytest.mark.parametrize("K,G,A,S,warps", [(512, 4, 4, 256, 3),
                                           (128, 4, 4, 1949, 8),
                                           (2048, 5, 4, 256, 8),
                                           (2048, 4, 8, 256, 8)])
def test_rank_fwd_plan_keeps_the_grid(K, G, A, S, warps):
    # a short grid keeps 8 warps an SM; the staged form a warp a chunk
    assert tk.rank_fwd_plan(K, G, A, S)[1] == warps


@pytest.mark.parametrize("G,A,ng", [(1, 4, 1), (1, 8, 1), (2, 4, 4),
                                    (3, 4, 4), (4, 4, 4), (4, 1, 4),
                                    (5, 4, 0), (8, 1, 0), (2, 5, 0),
                                    (32, 8, 0)])
def test_fwd_blocks_picks_the_form(G, A, ng):
    # the register form: one instance of 4 blocks of 4 states (16 planes)
    # for any G <= 4, the padded blocks skipped
    assert tk.fwd_blocks(G, A) == ng


def test_rank_fwd_plan_short_grid_halves_the_sites():
    # K11a's K = 32 at S = 256: a site a lane, every chunk its own warp
    spl, warps, chunks, _, _ = tk.rank_fwd_plan(32, 1, 4, 256)
    assert (spl, warps, chunks) == (1, 8, 8)


# --------------------------------------------------- the kernel's order
def _inputs(rng, K, G, A, S, kind="plain"):
    """One rank's inputs (numpy float32): leaves (N, GA, S), buf (K, R,
    GA, S), idx (4, K) mixing leaves and columns of other rows, P (K, A,
    A) or (K, G, A, A), pi, weights.  kind "plus_i": block 0 the identity
    (chip_smoke.py's G = 5); "tied": identical blocks, one P column for
    every state and block, pi uniform (all G A planes tie)."""
    N, R = 5, 4
    GA = G * A
    leaves = rng.uniform(0.05, 1.0, (N, GA, S)).astype(np.float32)
    buf = rng.uniform(0.05, 1.0, (K, R, GA, S)).astype(np.float32)
    pshape = (K, A, A) if G == 1 else (K, G, A, A)
    Pl = rng.uniform(0.05, 1.0, pshape).astype(np.float32)
    Pr = rng.uniform(0.05, 1.0, pshape).astype(np.float32)
    pi = rng.uniform(0.1, 1.1, GA).astype(np.float32)
    if kind == "plus_i":
        Pl[:, 0] = Pr[:, 0] = np.eye(A, dtype=np.float32)
    if kind == "tied":
        leaves = np.tile(leaves[:, :A], (1, G, 1))
        buf = np.tile(buf[:, :, :A], (1, 1, G, 1))
        col = rng.uniform(0.05, 1.0, (K,) + (1,) * (len(pshape) - 3)
                          + (A, 1)).astype(np.float32)
        Pl = Pr = np.broadcast_to(col, pshape).copy()
        pi = np.ones(GA, np.float32)
    pi = (pi / pi.sum()).astype(np.float32)
    w = rng.uniform(0.5, 2.0, S).astype(np.float32)
    rows = rng.integers(0, K, (2, K))
    nodes = rng.integers(0, N + R - 1, (2, K))     # column R - 1 is outc
    idx = np.stack([rows[0], nodes[0], rows[1], nodes[1]]).astype(np.int32)
    return leaves, buf, idx, R - 1, Pl, Pr, pi, w


def _gather(leaves, buf, idx):
    N = leaves.shape[0]
    out = []
    for j in range(2):
        row, node = idx[2 * j], idx[2 * j + 1]
        out.append(np.stack([leaves[n] if n < N else buf[r, n - N]
                             for r, n in zip(row, node)]))
    return out


def _emulate(leaves, buf, idx, outc, Pl, Pr, pi, w, spl, warps):
    """(column (K, GA, S), rootll, logscale) in the kernel's order."""
    m1, m2 = _gather(leaves, buf, idx)
    K, GA, S = m1.shape
    Pb_l = Pl if Pl.ndim == 4 else Pl[:, None]
    Pb_r = Pr if Pr.ndim == 4 else Pr[:, None]
    G, A = Pb_l.shape[1], Pb_l.shape[-1]
    planes = []
    for g in range(G):                              # block_merge
        x1, x2 = m1[:, g * A:(g + 1) * A], m2[:, g * A:(g + 1) * A]
        for b in range(A):
            u = (x1[:, 0] * Pb_l[:, g, 0, b, None]).astype(np.float32)
            v = (x2[:, 0] * Pb_r[:, g, 0, b, None]).astype(np.float32)
            for a in range(1, A):
                u = _fma(x1[:, a], Pb_l[:, g, a, b, None], u)
                v = _fma(x2[:, a], Pb_r[:, g, a, b, None], v)
            planes.append((u * v).astype(np.float32))
    wp = np.stack(planes, axis=1)                   # (K, GA, S)
    site = np.zeros((K, S), np.float32)
    for p in range(GA):
        site = _fma(wp[:, p], pi[p], site)
    scale = np.maximum(wp.max(axis=1), np.finfo(np.float32).tiny)
    inv = (np.float32(1) / scale).astype(np.float32)   # one a site
    col = (wp * inv[:, None]).astype(np.float32)
    terms = (np.log(site), np.log(scale))
    sums = []
    chunks = -(-S // (32 * spl))
    for t in terms:
        tot = None
        for wq in range(warps):                     # the warps in order
            acc = np.zeros((K, 32), np.float32)     # a lane's chain
            for c in _chunks_of(wq, warps, chunks):
                for j in range(spl):
                    s = c * 32 * spl + 32 * j + np.arange(32)
                    ok = s < S
                    x = np.zeros((K, 32), np.float32)
                    x[:, ok] = _fma(t[:, s[ok]], w[s[ok]], acc[:, ok])
                    acc = np.where(ok, x, acc)
            while acc.shape[1] > 1:                 # the butterfly
                h = acc.shape[1] // 2
                acc = (acc[:, :h] + acc[:, h:]).astype(np.float32)
            tot = acc[:, 0] if tot is None else (tot + acc[:, 0]).astype(
                np.float32)
        sums.append(tot)
    return col, sums[0], sums[1]


def _plain(args):
    leaves, buf, idx, outc, Pl, Pr, pi, w = args
    t = [torch.tensor(x, dtype=torch.float64) for x in (leaves, buf)]
    b = t[1].clone()
    rootll, logscale = tk._fused_rank_ref(
        t[0], b, torch.tensor(idx), outc,
        *(torch.tensor(x, dtype=torch.float64) for x in (Pl, Pr, pi, w)))
    return b[:, outc].numpy(), rootll.numpy(), logscale.numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("G,S,kind", [
    (1, 256, "plain"), (1, 898, "plain"), (1, 70, "plain"),
    (1, 256, "tied"), (4, 256, "plain"), (4, 300, "plain"),
    (5, 256, "plus_i"), (4, 256, "tied"), (5, 256, "tied")])
def test_rank_fwd_order_matches_plain(rng, G, S, kind):
    A, K = 4, 3
    args = _inputs(rng, K, G, A, S, kind)
    # the plan of the main paths' grid (K = 2048) on three particles
    spl, warps = tk.rank_fwd_plan(2048, G, A, S)[:2]
    col, rootll, logscale = _emulate(*args, spl, warps)
    want = _plain(args)
    assert np.abs(col - want[0]).max() <= TOL
    assert _rel(rootll, want[1]) <= TOL
    assert _rel(logscale, want[2]) <= TOL
    if kind == "tied":          # every plane is the max: the column ties
        assert (col == col[:, :1]).all() and (want[0] == 1).all()


@pytest.mark.parametrize("spl,warps", [(1, 1), (1, 8), (2, 3), (2, 6),
                                       (1, 5)])
def test_rank_fwd_order_any_form(rng, spl, warps):
    """The forms the forms tool times: the same values at any (spl,
    warps), ragged S."""
    args = _inputs(rng, 2, 4, 4, 333)
    want = _plain(args)
    col, rootll, logscale = _emulate(*args, spl, warps)
    assert np.abs(col - want[0]).max() <= TOL
    assert _rel(rootll, want[1]) <= TOL and _rel(logscale, want[2]) <= TOL


# ----------------------------------------------- the wrapper and sources
@pytest.mark.parametrize("G,save", [(1, False), (1, True), (4, True)])
def test_cpu_wrapper_is_the_plain_version(rng, G, save):
    leaves, buf, idx, outc, Pl, Pr, pi, w = (
        torch.tensor(x) if isinstance(x, np.ndarray) else x
        for x in _inputs(rng, 3, G, 4, 50))
    b1, b2 = buf.clone(), buf.clone()
    got = tk.fused_rank_update(leaves, b1, idx, outc, Pl, Pr, pi, w,
                               save_children=save)
    want = tk._fused_rank_ref(leaves, b2, idx, outc, Pl, Pr, pi, w,
                              save_children=save)
    assert torch.equal(b1, b2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_former_forward_bodies_are_gone():
    with open(os.path.join(CSRC, "rank_kernels.cu")) as fh:
        rank = fh.read()
    with open(tk.__file__) as fh:
        wrapper = fh.read()
    for gone in ("fused_rank_kernel", "fused_rank_blocked_kernel",
                 "launch_fused_rank(", "launch_fused_rank_blocked(",
                 "block_sum"):
        assert gone not in rank
    assert '"launch_fused_rank"' not in wrapper
    assert '"launch_fused_rank_blocked"' not in wrapper
    assert "fused_rank_fwd_kernel" in rank
    assert 'extern "C" int launch_fused_rank_fwd(' in rank
    # the plan's limits mirror the source's
    assert f"kFwdMaxWarps = {tk.FWD_MAX_WARPS};" in rank
    assert f"kFwdRegBlocks = {tk.FWD_REG_BLOCKS};" in rank
    assert f"kFwdRegStates = {tk.FWD_REG_STATES};" in rank
