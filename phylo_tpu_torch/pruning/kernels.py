"""Kernels K1, K2, K3 and K10: the fused rank update, its backward from
saved children and its backward that re-gathers the children (port of
phylo_tpu/pruning/kernels.py::fused_rank_update, ::fused_rank_bwd_saved
and ::fused_rank_bwd), dense and blocked (K10, rate mixtures: G > 1);
further down K8, the same merge on explicit children
(::fused_merge_loglik), and K11a, its backward (::_merge_bwd_pallas);
the VNCSMC pair log-likelihoods' forward K11b (::fused_pair_loglik) and
backwards K7 / K7 wide and K11c (::pair_loglik's `_pair_ll_bwd_pallas`,
its T-field form under PHYLO_TWIST_BWD_V2: K7's and K7 wide's bodies in
their T_FIELD form on the card, dP formed from T in the kernel).

One rank of the sweep, per particle k:

    m1, m2 = children (leaves[node] if node < N else buf[k', node - N])
    u = P_l^T m1,  v = P_r^T m2,  w = u * v            (A x S)
    scale_s = max(max_a w[a, s], tiny)
    buf[k, r] = w / scale                               (in place)
    rootll_k   = sum_s weight_s log(sum_a pi_a w[a, s])
    logscale_k = sum_s weight_s log(scale_s)

Blocked (GammaSites / FreeRates): messages carry G*A planes, P is
(K, G, A, A) and u, v contract within each block; the max and the root
sum run over all G*A planes.  The JAX kernel aliased the buffer
(input_output_aliases); the port updates column r of the buffer in
place.  K2 is the reverse of that op from the saved children, K3 the
same from children re-gathered by the rank's index, with reduce-max's
cotangent split among ties and the max(raw, tiny) clamp's half-split,
exactly as `_rank_bwd_core`.  The sweep saves the children, and so takes
K2, while 2 R K GA S itemsize <= SAVE_CHILDREN_CAP (JAX's value and
rule), and K3 above it.

CUDA tensors launch csrc/rank_kernels.cu, or csrc/wide_kernels.cu for
messages of 8 < A <= 128 states per block and G <= 32 blocks (K9, the
wide bodies: JAX's `wide_rank_kernel` rule, G A^2 > 64, and its per-block
limit of 128 states; dense, G = 1, for codon GY94's A = 61, blocked, "K9
blocked", for a rate mixture over a wide base such as protein + Gamma4,
G = 4 x A = 20, protein + Gamma8, 8 x 20, or GY94 + Gamma4, 4 x 61, in
block groups where one block of threads does not hold every plane:
`wide_fwd_group`, `wide_bwd_group`); CPU tensors run the plain versions
`_fused_rank_ref` / `_fused_rank_bwd_saved_ref` / `_fused_rank_bwd_ref`
below, at any A.  A blocked model with A <= 8 states per block runs on
K10 (G <= 32 blocks).  K1 and K10's forward are one
body on the card, `fused_rank_fwd_kernel` (one pass: each child value
read once), in its dense form for G = 1, launched on `rank_fwd_plan`;
K2, K3 (A <= 8) and K10's backward are one body,
`fused_rank_bwd_blocked_kernel`, in its dense form for G = 1, on
`rank_bwd_plan`.  K1, K2, K3 and K9 have no
autograd rule: only the manual whole-sweep VJP (smc.sweep_vjp) and the
no-grad sweep call them.  K7 and K11c (dense A <= 8) and K8 live in
csrc/twist_kernels.cu, K7 wide, K11b and K11c (dense 8 < A <= 64, and
blocked: G <= 32 blocks of A_b <= 64 states, in block groups where they do
not fit at once) in csrc/twist_wide_kernels.cu; K11a is a named entry over
K2's body (A <= 8) and K9bs's (dense A <= 128, or a wide mixture's
blocks).  The twist's pair
log-likelihoods take P dense (M, K, A, A) or, for a rate mixture
(`twist_blocks`), blocked (M, K, G, A_b, A_b): the wrappers dispatch on
P's rank, and the gradient comes back in P's own shape.
`fused_merge_loglik`, `pair_loglik` and `fused_pair_loglik` carry
torch.autograd.Functions.
"""

from __future__ import annotations

import os

import torch

from phylo_tpu_torch import _ext
from phylo_tpu_torch.models.expm import exact_matmul

MAX_A = 8                       # states per block of K1-K3, K7, K8, K10
MAX_TWIST_A = 64                # K7 wide, K11b, K11c: dense A, or A_b
TWIST_FWD_TILE = 64             # K11b: padded planes of one group at most
TWIST_FWD_GROUP = 32            # K11b: padded planes a group over several
BWD_ONE_PASS_SC = 128           # K7 wide / K11c: one group's least chunk
MERGE_MAX_THREADS = 1024        # K8: threads a block at most (A <= 4)
FWD_MAX_THREADS = 256           # K11b: threads per CUDA block
BWD_MAX_THREADS = 512           # K7 wide: threads per CUDA block
BWD_MAX_SC = 256                # K7 wide: sites per chunk
SMEM_LIMIT = 232448             # shared-memory bytes of a block (H100)
MAX_G = 32                      # rate-category blocks on the card
MAX_WIDE_A = 128                # K9: states a block at most
WIDE_FWD_THREADS = 256          # K9f: threads a block at most
WIDE_GROUP_NST = 8              # K9's group forms: site tiles of 4 a chunk
WIDE_GROUP_DPT = 4              # K9bs / K9b groups: dP tiles a thread a round
FWD_SPL = 2                     # K1: a lane's sites a chunk at most
FWD_WARP_CHUNKS = 8             # K1 / K10: chunks a warp on a full grid
FWD_MAX_WARPS = 8               # the rank forward: warps (chunks) a block
FWD_REG_BLOCKS = 4              # K10's register form: rate blocks at most
FWD_REG_STATES = 4              # K10's register form: states a block
BWD_SITES_PER_LANE = 1          # K3 blocked / K10 bwd: a lane's sites a chunk
DENSE_BWD_SPL = 2               # K2 / K3 / K11a (A <= 8): a lane's sites at most
DENSE_BWD_WARPS = 4             # K2 / K3 / K11a: warps a particle on a full grid
BWD_MAX_WARPS = 8               # the rank backward: warps (chunks) a block
K7_SPL = 2                      # K7: a lane's sites a chunk at most (A <= 4)
K7_MAX_WARPS = 8                # K7: warps (chunks) a row
WIDE_BWD_SITE_TILES = 8         # K9bs / K9b: site tiles of 4 a chunk (32 sites)
WIDE_BWD_THREADS = 256          # K9bs / K9b: threads a block at most
MAX_CLUSTER = 8                 # K9f / K9bs / K9b: blocks a particle
SMS = 132                       # streaming multiprocessors of an H100
GRID_WARPS = 16 * SMS           # K7, K2 / K3 dense: warps a full grid holds
# bytes of the (R, K, 2, G*A, S) child residuals the manual-VJP forward
# may save for K2; above it the reverse pass re-gathers through K3
SAVE_CHILDREN_CAP = 2 ** 28
# the T-field twist backward K11c in place of K7 / K7 wide (the JAX
# package's PHYLO_TWIST_BWD_V2 knob and default)
TWIST_BWD_V2 = os.environ.get("PHYLO_TWIST_BWD_V2", "0") == "1"


def save_children_ok(R, K, GA, S, itemsize):
    """JAX's rule: save the children when 2 R K GA S itemsize <= cap."""
    return 2 * R * K * GA * S * itemsize <= SAVE_CHILDREN_CAP


def alloc_rank_buffer(K, R, A, S, dtype, device):
    """The write-once (K, R, A, S) internal-message buffer (K6's
    counterpart).  On the card it is an uninitialised torch.empty: every
    column is written before it is read and children are exact slabs.
    The CPU gets zeros, as the JAX package's non-TPU path does."""
    if torch.device(device).type == "cuda":
        return torch.empty((K, R, A, S), dtype=dtype, device=device)
    return torch.zeros((K, R, A, S), dtype=dtype, device=device)


def blockdiag_dense(P):
    """(..., G, A, A) block transitions -> dense (..., G*A, G*A) block-
    diagonal matrices; the zero off-block entries make the dense merge
    equal the blocked one."""
    G, A = P.shape[-3], P.shape[-1]
    out = P.new_zeros(P.shape[:-3] + (G * A, G * A))
    for g in range(G):
        out[..., g * A:(g + 1) * A, g * A:(g + 1) * A] = P[..., g, :, :]
    return out


def _apply_t(m, P):
    """u[..., b, s] = sum_a m[..., a, s] P[..., a, b] for states-major
    messages m (..., A, S) and transitions P (..., A, A), as one batched
    product (full float32 on the card).  Its accumulation over a runs in
    the same order for every output plane, so planes that tie in exact
    arithmetic tie here too, as the kernels' FMA chains do (the
    all-planes-tied cases of the tests and of chip_smoke.py hold this;
    a torch.sum over a broke such ties at A = 61 on the CPU)."""
    return exact_matmul(P.transpose(-1, -2), m)


def _ref_impl(m1, m2, P_l, P_r, pi, weights):
    """Plain merge + rescale + root log-lik on states-major (K, A, S)
    children.  Returns (merged_scaled, rootll (K,), logscale (K,))."""
    u = _apply_t(m1, P_l)
    v = _apply_t(m2, P_r)
    w = u * v
    scale = torch.clamp(torch.amax(w, dim=-2),
                        min=torch.finfo(w.dtype).tiny)          # (K, S)
    merged = w / scale[:, None, :]
    site_ll = torch.log(torch.sum(w * pi[None, :, None], dim=1))
    rootll = torch.sum(site_ll * weights[None, :], dim=-1)
    logscale = torch.sum(torch.log(scale) * weights[None, :], dim=-1)
    return merged, rootll, logscale


def gather_children(leaves, buf, idx):
    """(m1, m2) for idx (4, K) = [row1, node1, row2, node2]: node < N
    reads leaves[node], else buf[row, node - N]."""
    N = leaves.shape[0]
    R = buf.shape[1]
    idx = idx.long()
    ms = []
    for j in range(2):
        node = idx[2 * j + 1]
        row = idx[2 * j]
        is_leaf = node < N
        leaf_part = leaves[torch.clamp(node, 0, N - 1)]
        int_part = buf[row, torch.clamp(node - N, 0, R - 1)]
        ms.append(torch.where(is_leaf[:, None, None], leaf_part, int_part))
    return ms[0], ms[1]


def _fused_rank_ref(leaves, buf, idx, outc, P_l, P_r, pi, weights,
                    save_children=False):
    """Plain version of K1 / K10: writes buf[:, outc] in place and
    returns (rootll, logscale[, m1, m2]).  Blocked transitions go through
    their dense block-diagonal form, as in the JAX package."""
    if P_l.ndim == 4:
        P_l, P_r = blockdiag_dense(P_l), blockdiag_dense(P_r)
    m1, m2 = gather_children(leaves, buf, idx)
    merged, rootll, logscale = _ref_impl(m1, m2, P_l, P_r, pi, weights)
    buf[:, outc] = merged
    if save_children:
        return rootll, logscale, m1, m2
    return rootll, logscale


def _blocks(P_l, GA):
    """(G, A) of transitions (K, A, A) (G = 1) or (K, G, A, A)."""
    G = P_l.shape[1] if P_l.ndim == 4 else 1
    A = P_l.shape[-1]
    if G * A != GA:
        raise ValueError(f"transitions {tuple(P_l.shape)} do not match "
                         f"{GA} message planes")
    return G, A


def wide_planes(G, A, blocked):
    """True when a rank of G blocks of A states takes the wide kernels K9
    on the card: 8 < A <= 128 states a block, dense (G = 1) or blocked (K9
    blocked, G <= 32 blocks: protein + Gamma8's 8 x 20 and GY94 +
    Gamma4's 4 x 61 too, in block groups where one group does not fit).
    JAX's `wide_rank_kernel` rule (G A^2 > 64) agrees for dense
    transitions and for blocked ones with A > 8, and so does its limit of
    128 states a block (JAX's G is unbounded; the card's is MAX_G); a
    blocked model with A <= 8 runs on K10 (JAX's wide bodies take those
    with G A^2 > 64, such as GTR+G4+I).
    Raises where the card has no kernel."""
    if A <= MAX_A:
        if blocked:
            _check_a(A, G)
        return False
    check_wide(G, A)
    return True


def check_wide(G, A):
    """Raises outside K9's contract: 1 <= G <= MAX_G blocks of 1 <= A <=
    MAX_WIDE_A states (dense: G = 1)."""
    if not (1 <= A <= MAX_WIDE_A and 1 <= G <= MAX_G):
        raise NotImplementedError(
            f"the wide CUDA rank kernels (K9, K9 blocked) take at most "
            f"{MAX_G} rate-category blocks of at most {MAX_WIDE_A} states, "
            f"got G={G} x A={A} (ROADMAP.md Queue 3: paths the card "
            "refuses)")


def wide_rank(P_l, GA):
    """`wide_planes` for transitions P_l (K, A, A) or (K, G, A, A) of a
    rank with GA message planes."""
    G, A = _blocks(P_l, GA)
    return wide_planes(G, A, P_l.ndim == 4)


def fused_rank_update(leaves, buf, idx, outc, P_l, P_r, pi, weights,
                      save_children=False):
    """One full rank update, in place: child gather + transitions +
    merge + rescale + root log-lik + write of column `outc` of `buf`.

    leaves (N, GA, S) shared leaf messages; buf (K, R, GA, S) write-once
    buffer (node N+q lives in column q), contiguous or the trailing R
    columns of a wider contiguous buffer (the kernels take its particle
    stride in columns); idx (4, K) int32; outc int (the
    rank, never among the children read); P_l, P_r (K, A, A), or
    (K, G, A, A) blocked (K10); pi (GA,); weights (S,).  Returns (rootll
    (K,), logscale (K,)) and, with save_children, the gathered children
    (K, GA, S) twice.  On the card: K1 (dense, A <= 8) or K10 (blocked,
    A <= 8), one body on `rank_fwd_plan`'s launch, K9f (A > 8) or K9f
    blocked (A > 8, G > 1), one kernel launch each."""
    if not buf.is_cuda:
        return _fused_rank_ref(leaves, buf, idx, outc, P_l, P_r, pi,
                               weights, save_children)
    K, R, GA, S = buf.shape
    N = leaves.shape[0]
    G, A = _blocks(P_l, GA)
    wide = wide_rank(P_l, GA)
    blocked = P_l.ndim == 4
    f32 = torch.float32
    _ext.require(leaves, "leaves", f32, shape=(N, GA, S))
    _ext.require(buf[0], "buf", f32)
    Rs = buf.stride(0) // (GA * S)          # columns a particle
    if buf.stride(0) != Rs * GA * S or Rs < R:
        raise ValueError(f"buf: particle stride {buf.stride(0)} is not a "
                         "whole number of its columns")
    _ext.require(idx, "idx", torch.int32, shape=(4, K))
    pshape = (K, G, A, A) if blocked else (K, A, A)
    _ext.require(P_l, "P_l", f32, shape=pshape)
    _ext.require(P_r, "P_r", f32, shape=pshape)
    _ext.require(pi, "pi", f32, shape=(GA,))
    _ext.require(weights, "weights", f32, shape=(S,))
    if not 0 <= outc < R:
        raise ValueError(f"output column {outc} outside [0, {R})")
    dev = buf.device
    sums = torch.empty((2, K), dtype=f32, device=dev)   # rootll, logscale
    if save_children:
        m1 = torch.empty((K, GA, S), dtype=f32, device=dev)
        m2 = torch.empty((K, GA, S), dtype=f32, device=dev)
        p1, p2 = m1.data_ptr(), m2.data_ptr()
    else:
        p1 = p2 = None
    ptrs = (leaves.data_ptr(), buf.data_ptr(), idx.data_ptr(),
            P_l.data_ptr(), P_r.data_ptr(), pi.data_ptr(),
            weights.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(), p1,
            p2)
    if wide:
        gb = wide_fwd_group(K, G, A, S)
        sc, cluster, threads, _, _ = wide_fwd_plan(
            K, G, A, S, max_cluster=MAX_CLUSTER, gb=gb)
        name = "fused_rank_update_wide" + ("_blocked" if blocked else "")
        _ext.LAUNCHES[name] += 1
        if gb == G:
            fn = _ext.bind("wide_kernels", "launch_wide_rank", 11, 10)
            code = fn(*ptrs, K, Rs, N, G, A, S, outc, sc, cluster, threads,
                      _ext.stream_ptr(dev))
        else:
            # each site's running max and pi-sum over the groups
            scr = torch.empty((K, 2, _ceil(S, sc) * sc), dtype=f32,
                              device=dev)
            fn = _ext.bind("wide_kernels", "launch_wide_rank_group", 12, 11)
            code = fn(*ptrs, scr.data_ptr(), K, Rs, N, G, A, S, outc, sc,
                      cluster, threads, gb, _ext.stream_ptr(dev))
    else:
        spl, warps, _, _, _ = rank_fwd_plan(K, G, A, S)
        fn = _ext.bind("rank_kernels", "launch_fused_rank_fwd", 11, 9)
        name = "fused_rank_update" + ("_blocked" if blocked else "")
        _ext.LAUNCHES[name] += 1
        code = fn(*ptrs, K, Rs, N, G, A, S, outc, spl, warps,
                  _ext.stream_ptr(dev))
    _ext.check(code, name)
    rootll, logscale = sums
    if save_children:
        return rootll, logscale, m1, m2
    return rootll, logscale


def _fused_rank_bwd_saved_ref(m1, m2, gm, gr, gl, P_l, P_r, pi, weights):
    """Plain version of K2 (and of K10's backward), term for term the
    math of the JAX kernel's `_rank_bwd_core`.  Returns (dm1, dm2
    (K, GA, S), dP_l, dP_r (K, A, A) or (K, G, A, A), dpi (1, GA),
    dw (1, S))."""
    dtype = m1.dtype
    tiny = torch.finfo(dtype).tiny
    K, GA, S = m1.shape
    blocked = P_l.ndim == 4
    Pl = P_l if blocked else P_l[:, None]                # (K, G, A, A)
    Pr = P_r if blocked else P_r[:, None]
    G, A = Pl.shape[1], Pl.shape[-1]
    mb1 = m1.reshape(K, G, A, S)
    mb2 = m2.reshape(K, G, A, S)
    u = _apply_t(mb1, Pl)
    v = _apply_t(mb2, Pr)
    u = u.reshape(K, GA, S)
    v = v.reshape(K, GA, S)
    wp = u * v                                           # (K, GA, S)
    site = torch.sum(wp * pi[None, :, None], dim=1)      # (K, S)
    raw = torch.amax(wp, dim=1)
    scale = torch.clamp(raw, min=tiny)
    w = weights[None, :]
    gr = gr[:, None]
    gl = gl[:, None]
    dsite = (gr * w) / site
    inv = 1.0 / scale
    dscale = (gl * w) / scale - torch.sum(gm * wp, dim=1) * (inv * inv)
    draw = dscale * ((raw > tiny).to(dtype) + 0.5 * (raw == tiny).to(dtype))
    eq = (wp == raw[:, None, :]).to(dtype)
    neq = torch.sum(eq, dim=1)
    dwp = (gm * inv[:, None, :] + dsite[:, None, :] * pi[None, :, None]
           + draw[:, None, :] * eq / neq[:, None, :])
    du = (dwp * v).reshape(K, G, A, S)
    dv = (dwp * u).reshape(K, G, A, S)
    # dm = P du and dP = m du^T as batched products (no (K, G, A, A, S)
    # intermediate at wide A; full float32 on the card)
    dm1 = exact_matmul(Pl, du)
    dm2 = exact_matmul(Pr, dv)
    dPl = exact_matmul(mb1, du.transpose(-1, -2))
    dPr = exact_matmul(mb2, dv.transpose(-1, -2))
    dpi = torch.sum(dsite[:, None, :] * wp, dim=(0, 2))
    dw = torch.sum(gr * torch.log(site) + gl * torch.log(scale), dim=0)
    if not blocked:
        dPl, dPr = dPl[:, 0], dPr[:, 0]
    return (dm1.reshape(K, GA, S), dm2.reshape(K, GA, S), dPl, dPr,
            dpi[None], dw[None])


def _fused_rank_bwd_ref(leaves, buf, idx, gm, gr, gl, P_l, P_r, pi,
                        weights):
    """Plain version of K3: the children resolved by idx as the forward
    resolved them, then `_fused_rank_bwd_saved_ref`."""
    m1, m2 = gather_children(leaves, buf, idx)
    return _fused_rank_bwd_saved_ref(m1, m2, gm, gr, gl, P_l, P_r, pi,
                                     weights)


def _bwd_outputs(K, GA, S, P_shape, dev, dw=True):
    """(dm1, dm2, dP_l, dP_r, dpi_part (K, GA), dw_part (K, S) or None):
    dP shaped as the transitions; one partial row a particle, which the
    caller sums."""
    f = dict(dtype=torch.float32, device=dev)
    return (torch.empty((K, GA, S), **f), torch.empty((K, GA, S), **f),
            torch.empty(P_shape, **f), torch.empty(P_shape, **f),
            torch.empty((K, GA), **f),
            torch.empty((K, S), **f) if dw else None)


def _shrink_spl(rows, S, spl, max_warps):
    """Halve a lane's sites (spl) while the grid, every chunk of 32 spl
    sites its own warp (at most max_warps a row), would hold fewer than
    GRID_WARPS / 2 warps (8 an SM)."""
    while spl > 1 and (rows * min(_ceil(S, 32 * spl), max_warps)
                       < GRID_WARPS // 2):
        spl //= 2
    return spl


def rank_bwd_plan(K, G, A, S, spl=None, max_warps=None):
    """Launch of the rank backward (csrc/rank_kernels.cu's
    `fused_rank_bwd_blocked_kernel`): (sites a lane, warps a block, chunks
    a particle, blocks, shared-memory bytes).  One block per particle; a
    chunk is 32 lanes x spl sites, and a warp takes every warps-th chunk,
    up to BWD_MAX_WARPS warps a particle, so DS1's K = 2048 x S = 256
    runs 16,384 warps and K = 128 x S = 1949 1,024.  Blocked (G > 1, K3
    blocked and K10's backward): spl = BWD_SITES_PER_LANE, and a warp
    stages a chunk's children and cotangent (3 G A 32 spl floats) in
    shared memory, beside the transitions, pi and each warp's running
    2 A^2 + A sums of every block; warps shrink until it fits.  Dense
    (G = 1: K2, K3, K11a at A <= 8): nothing staged; spl = DENSE_BWD_SPL
    (`_shrink_spl`), and on a full grid (GRID_WARPS) each warp takes two
    chunks or more, at most DENSE_BWD_WARPS warps (primate K = 2048: 2
    warps at S = 256, 4 at 898, the quickest forms on the H100,
    tools/torch_k7_forms.py); on a short grid every chunk its own warp
    (K11a's K = 32 at S = 256: spl 1, 8 warps, 256 in all)."""
    mw = max_warps or BWD_MAX_WARPS
    if spl is None:
        spl = BWD_SITES_PER_LANE if G > 1 else _shrink_spl(
            K, S, DENSE_BWD_SPL, mw)
    chunks = _ceil(S, 32 * spl)
    warps = min(chunks, mw)
    if G == 1 and max_warps is None and K * warps >= GRID_WARPS:
        warps = min(DENSE_BWD_WARPS, _ceil(chunks, 2))
    stage = 3 * G * A * 32 * spl if G > 1 else 0

    def smem(w):
        return 4 * (2 * G * A * A + G * A + w * G * (2 * A * A + A)
                    + w * stage)

    while warps > 1 and smem(warps) > SMEM_LIMIT:
        warps -= 1
    return spl, warps, chunks, K, smem(warps)


def fwd_blocks(G, A):
    """The rank forward's form (csrc/rank_kernels.cu's fwd_blocks): the
    rate blocks its register form holds, 1 (dense) or, blocked,
    FWD_REG_BLOCKS for any G <= FWD_REG_BLOCKS at A <= FWD_REG_STATES (at
    most 16 planes in registers, the padded blocks skipped); 0, the staged
    form, otherwise."""
    if G == 1:
        return 1
    if A > FWD_REG_STATES or G > FWD_REG_BLOCKS:
        return 0
    return FWD_REG_BLOCKS


def rank_fwd_smem(G, A, warps, spl, ng=None):
    """Shared-memory bytes of the rank forward (csrc/rank_kernels.cu's
    fwd_smem) in form ng (default `fwd_blocks(G, A)`): the warps' two
    sums; blocked, also the transitions and pi; staged (ng = 0), also
    each warp's stage of a chunk's children (2 G A 32 spl floats)."""
    if ng is None:
        ng = fwd_blocks(G, A)
    n = 2 * warps
    if ng != 1:
        n += 2 * G * A * A + G * A
    if ng == 0:
        n += warps * 2 * G * A * 32 * spl
    return 4 * n


def rank_fwd_plan(K, G, A, S, spl=None, warps=None):
    """Launch of the rank forward (csrc/rank_kernels.cu's
    `fused_rank_fwd_kernel`, K1 at G = 1 and K10's forward at G > 1):
    (sites a lane, warps a block, chunks a particle, blocks, shared-memory
    bytes).  One block per particle; a chunk is 32 lanes x spl sites, and
    a warp takes every warps-th chunk.  spl = FWD_SPL dense (G = 1),
    halved while the grid would be short of warps (`_shrink_spl`), and 1
    blocked.  Every chunk its own warp, up to FWD_MAX_WARPS, but in the
    register form (`fwd_blocks` > 0) on a full grid (GRID_WARPS) a warp
    takes about FWD_WARP_CHUNKS chunks while the grid keeps 8 warps an SM
    (the staged form waits on each chunk's copies, so it keeps a warp a
    chunk); the staged form sheds warps until a block fits (G = 32 blocks
    of 8 states: 3).  The quickest forms on the H100 at the main paths'
    shapes (tools/torch_k1_k10_forms.py)."""
    if spl is None:
        spl = _shrink_spl(K, S, FWD_SPL, FWD_MAX_WARPS) if G == 1 else 1
    chunks = _ceil(S, 32 * spl)
    if warps is None:
        warps = min(chunks, FWD_MAX_WARPS)
        if fwd_blocks(G, A) and K * warps >= GRID_WARPS:
            warps = min(warps, max(_ceil(chunks, FWD_WARP_CHUNKS),
                                   _ceil(GRID_WARPS // 2, K)))
        while warps > 1 and rank_fwd_smem(G, A, warps, spl) > SMEM_LIMIT:
            warps -= 1
    return spl, warps, chunks, K, rank_fwd_smem(G, A, warps, spl)


def wide_bwd_smem(G, A, nst=WIDE_BWD_SITE_TILES):
    """Shared-memory bytes of K9bs / K9b: csrc/wide_kernels.cu's
    BwdLayout (P blocks padded to AP = 4 ceil(A / 4), reused as the dP /
    dpi staging row; pi; four (G AP, 4 nst) tiles at pitch 4 nst + 4; the
    warps' per-site partials, the per-site scalars, the dpi partials)."""
    sc = 4 * nst
    AP = 4 * _ceil(A, 4)
    GA, GAP = G * A, G * AP
    preg = max(2 * G * AP * AP, 4 * _ceil(2 * G * A * A + GA, 4))
    warps = _wide_max_threads(nst) // 32
    return 4 * (preg + 4 * _ceil(GA, 4) + 4 * GAP * (sc + 4)
                + 4 * warps * sc + 5 * sc + nst * GAP)


def _wide_max_threads(nst):
    """K9bs / K9b's threads a block at most (`bwd_max_threads`)."""
    return 32 * nst if nst > 8 else WIDE_BWD_THREADS


def _wide_one_bwd(G, A):
    """(nst, threads, dpt) of the one-group backward's launch."""
    npt = _ceil(A, 4)
    nst = WIDE_BWD_SITE_TILES
    if G * npt * nst > WIDE_BWD_THREADS:
        nst = 4
    threads = _ceil(G * npt * nst, 32) * 32
    return nst, threads, _pow2(_ceil(2 * G * npt * npt, threads))


def _group_size(G, most):
    """Blocks a group: the groups that `most` blocks each need, filled
    evenly (and fewer than G: the one-group bodies take G)."""
    most = max(1, min(most, G - 1))
    return _ceil(G, _ceil(G, most))


def wide_bwd_group_smem(gb, A, nst=WIDE_GROUP_NST):
    """Shared-memory bytes of the backward's group form: csrc/wide_kernels.cu's
    BwdGroupLayout (a group's P blocks, reused as its dP / dpi staging
    row; its pi; four (gb AP, 4 nst) tiles at pitch 4 nst + 4; the dpi
    partials)."""
    AP = 4 * _ceil(A, 4)
    preg = max(2 * gb * AP * AP, 4 * _ceil(2 * gb * A * A + gb * A, 4))
    return 4 * (preg + 4 * _ceil(gb * A, 4) + 4 * gb * AP * (4 * nst + 4)
                + nst * gb * AP)


def wide_bwd_group(K, G, A, S):
    """Blocks a group of K9bs / K9b (and K11a): G, today's one-group
    launch, wherever it fits -- a block's threads cover every plane tile
    (at most WIDE_BWD_THREADS), the shared memory holds all of P
    (`wide_bwd_smem`) and dpt is one the body is built for (up to 8 at 32
    sites a chunk, 4 at 16: 8 there would hold 128 dP accumulators a
    thread beside the tiles).  Protein + Gamma8 (8 x 20: 160 threads, dpt
    4) fits; GY94 + Gamma4 (4 x 61: dpt 8 at 16 sites), 16 x 20 (320
    threads) and 32 x 20 (325 KB) do not.  There the group form takes the
    most whole blocks whose tiles of 4 planes x WIDE_GROUP_NST site tiles
    fit WIDE_BWD_THREADS and whose layout fits (`wide_bwd_group_smem`),
    spread evenly (GY94 + Gamma4: 2 groups of 2 blocks)."""
    check_wide(G, A)
    nst, threads, dpt = _wide_one_bwd(G, A)
    if (threads <= _wide_max_threads(nst) and dpt <= (8 if nst == 8 else 4)
            and wide_bwd_smem(G, A, nst) <= SMEM_LIMIT):
        return G
    npt = _ceil(A, 4)
    most = WIDE_BWD_THREADS // (npt * WIDE_GROUP_NST)
    while most > 1 and wide_bwd_group_smem(most, A) > SMEM_LIMIT:
        most -= 1
    return _group_size(G, most)


def wide_bwd_plan(K, G, A, S, nst=None, max_cluster=MAX_CLUSTER, gb=None):
    """Launch of K9bs / K9b (and K11a above 8 states): (sites a chunk,
    cluster, threads, dP tiles a thread, blocks, shared-memory bytes) at
    gb blocks a group (default `wide_bwd_group`; gb = G is the one-group
    body, and the plan is the one it had before the group forms).
    Grid (cluster, K): the cluster's blocks split particle k's chunks of
    4 nst sites (block r takes chunks r, r + cluster, ...) and sum their
    dP through distributed shared memory.  A thread owns a (4 planes x 4
    sites) tile of u, v, du, dv and dm, so a block has G ceil(A / 4) nst
    threads rounded up to a warp, and dpt (1, 2, 4 or 8) of the 2 G
    ceil(A / 4)^2 (4 x 4) dP tiles.  nst = WIDE_BWD_SITE_TILES (32-site
    chunks), or 4 where more than 32 plane tiles would not fit
    WIDE_BWD_THREADS (a blocked model with a padded A, such as 14 x 9).
    The cluster is the largest (up to 8) that keeps the grid to one wave
    of the card: a block pays a fixed prologue (P into shared memory) and
    the cluster's reduction, so 8 blocks a particle ran 1.5x slower than
    2 at GY94's K = 128 (tools/torch_k9_bwd_forms.py, PERF.md).  The
    group form (gb < G) has a block a group's gb ceil(A / 4) nst tiles
    (nst = WIDE_GROUP_NST), and runs each group's 2 gb ceil(A / 4)^2 dP
    tiles in rounds of dpt = WIDE_GROUP_DPT a thread."""
    check_wide(G, A)
    if gb is None:
        gb = wide_bwd_group(K, G, A, S)
    npt = _ceil(A, 4)
    if gb < G:
        nst = nst or WIDE_GROUP_NST
        threads = _ceil(gb * npt * nst, 32) * 32
        dpt = WIDE_GROUP_DPT
        smem = wide_bwd_group_smem(gb, A, nst)
    else:
        if nst is None:
            nst = WIDE_BWD_SITE_TILES
            if G * npt * nst > WIDE_BWD_THREADS:
                nst = 4
        threads = _ceil(G * npt * nst, 32) * 32
        dpt = _pow2(_ceil(2 * G * npt * npt, threads))
        smem = wide_bwd_smem(G, A, nst)
    sc = 4 * nst
    chunks = _ceil(S, sc)
    # one wave: the blocks an SM holds by shared memory and by registers
    # at the launch bound's cap of 255 a thread
    per_sm = max(1, min(SMEM_LIMIT // smem, 65536 // (255 * threads)))
    cluster = min(chunks, max_cluster, max(1, SMS * per_sm // K))
    return sc, cluster, threads, dpt, cluster * K, smem


def wide_fwd_smem(G, A, sc, threads):
    """Shared-memory bytes of K9f: csrc/wide_kernels.cu's FwdLayout (P
    blocks padded to AP = 4 ceil(A / 4), pi, two (G AP, sc) tiles at pitch
    sc + 4, the warps' per-site max and pi-sum partials, the per-site
    scales and 16 floats of site-sum slots)."""
    AP = 4 * _ceil(A, 4)
    return 4 * (2 * G * AP * AP + 4 * _ceil(G * A, 4)
                + 2 * G * AP * (sc + 4) + 2 * (threads // 32) * sc + sc + 16)


def _wide_one_fwd(G, A, ts=4):
    """(sc, threads) of K9f's one-group launch: sc = 64 sites a chunk,
    halved (down to 2 ts) while the tiles would not fit WIDE_FWD_THREADS;
    threads rounded up to a multiple of 32 and of sc."""
    npt = _ceil(A, 4)
    sc = 64
    while G * npt * (sc // ts) > WIDE_FWD_THREADS and sc > 2 * ts:
        sc //= 2
    unit = max(32, sc)
    return sc, _ceil(G * npt * (sc // ts), unit) * unit


def wide_fwd_group_smem(gb, A, sc, threads):
    """Shared-memory bytes of K9f's group form: csrc/wide_kernels.cu's
    FwdGroupLayout (a group's P blocks and pi, two (gb AP, sc) tiles at
    pitch sc + 4, the warps' per-site partials, 16 site-sum slots)."""
    AP = 4 * _ceil(A, 4)
    return 4 * (2 * gb * AP * AP + 4 * _ceil(gb * A, 4)
                + 2 * gb * AP * (sc + 4) + 2 * (threads // 32) * sc + 16)


def wide_fwd_group(K, G, A, S):
    """Blocks a group of K9f: G, the one-group launch, wherever its
    plan has threads for every plane tile (at most WIDE_FWD_THREADS at 8
    sites a chunk) and its layout holds all of P (`wide_fwd_smem`):
    protein + Gamma8 (16 sites a chunk, 52.6 KB), GY94 + Gamma4 (16, 174
    KB) and 16 x 20 (8) fit; 32 x 20 (160 plane tiles) and 8 x 61 (314
    KB) do not.  There the group form takes the most whole blocks whose
    tiles of 4 planes x WIDE_GROUP_NST site tiles fit WIDE_FWD_THREADS and
    whose layout fits (`wide_fwd_group_smem`), spread evenly."""
    check_wide(G, A)
    sc, threads = _wide_one_fwd(G, A)
    if (threads <= WIDE_FWD_THREADS
            and wide_fwd_smem(G, A, sc, threads) <= SMEM_LIMIT):
        return G
    npt = _ceil(A, 4)
    sc = 4 * WIDE_GROUP_NST
    most = WIDE_FWD_THREADS // (npt * WIDE_GROUP_NST)
    while most > 1 and wide_fwd_group_smem(
            most, A, sc, _ceil(most * npt * WIDE_GROUP_NST, sc) * sc) \
            > SMEM_LIMIT:
        most -= 1
    return _group_size(G, most)


def wide_fwd_plan(K, G, A, S, sc=None, max_cluster=MAX_CLUSTER, ts=4,
                  gb=None):
    """Launch of K9f: (sites a chunk, cluster, threads, blocks,
    shared-memory bytes) at gb blocks a group (default `wide_fwd_group`;
    gb = G is the one-group body, whose plan is the one it had before the
    group forms).  Grid (cluster, K): the cluster's blocks split
    particle k's chunks of sc sites (block r takes chunks r, r + cluster,
    ...), each with P staged once, and sum rootll and logscale through
    distributed shared memory.  A thread owns a (4 planes x ts sites)
    tile of u and v (the launcher's ts = 4; tools/torch_k9_fwd_forms.py
    also times 8), so a block has G ceil(A / 4) sc / ts threads, rounded
    up to a multiple of 32 and of sc, at most WIDE_FWD_THREADS: sc = 64,
    halved (down to 2 ts) while the tiles would not fit.  The cluster is
    the largest power of two (up to 8, at most the chunks) that keeps the
    grid to one wave: the blocks an SM holds by shared memory and by the
    launch bound's 128 registers a thread.  On the H100 the largest
    blocks ran quickest, a second wave or a cluster of 6 blocks slower
    (tools/torch_k9_fwd_forms.py, PERF.md).  The group form (gb < G,
    ts = 4) has a block a group's gb ceil(A / 4) tiles x WIDE_GROUP_NST
    site tiles (32 sites a chunk)."""
    check_wide(G, A)
    if gb is None:
        gb = wide_fwd_group(K, G, A, S)
    npt = _ceil(A, 4)
    if gb < G:
        sc = sc or 4 * WIDE_GROUP_NST
        unit = max(32, sc)
        threads = _ceil(gb * npt * (sc // 4), unit) * unit
        smem = wide_fwd_group_smem(gb, A, sc, threads)
    else:
        if sc is None:
            sc = _wide_one_fwd(G, A, ts)[0]
        unit = max(32, sc)
        threads = _ceil(G * npt * (sc // ts), unit) * unit
        smem = wide_fwd_smem(G, A, sc, threads)
    if threads > WIDE_FWD_THREADS:
        raise ValueError(f"K9f: {gb * npt} plane tiles x {sc // ts} site "
                         f"tiles exceed {WIDE_FWD_THREADS} threads")
    chunks = _ceil(S, sc)
    per_sm = max(1, min(SMEM_LIMIT // smem, 65536 // (128 * threads)))
    fit = min(chunks, max_cluster, max(1, SMS * per_sm // K))
    cluster = 1 << (fit.bit_length() - 1)
    return sc, cluster, threads, cluster * K, smem


def _check_bwd_args(gm, gr, gl, P_l, P_r, pi, weights, K, GA, S):
    """Validates the backward's common inputs; returns (G, A, wide)."""
    f32 = torch.float32
    G, A = _blocks(P_l, GA)
    wide = wide_rank(P_l, GA)
    _ext.require(gm, "gm", f32, shape=(K, GA, S))
    _ext.require(gr, "gr", f32, shape=(K,))
    _ext.require(gl, "gl", f32, shape=(K,))
    _ext.require(P_l, "P_l", f32, shape=(K,) + tuple(P_l.shape[1:]))
    _ext.require(P_r, "P_r", f32, shape=P_l.shape)
    _ext.require(pi, "pi", f32, shape=(GA,))
    _ext.require(weights, "weights", f32, shape=(S,))
    return G, A, wide


def fused_rank_bwd_saved(m1, m2, gm, gr, gl, P_l, P_r, pi, weights,
                         want_dw=True):
    """Reverse of one rank's merge from the children saved by the
    forward (K2; K10's backward for blocked P).  gm (K, GA, S)
    merged-message cotangent; gr, gl (K,) rootll / logscale cotangents.
    Returns (dm1, dm2, dP_l, dP_r, dpi_part (n, GA), dw_part (n, S));
    the caller sums the partials over rows.  On the card, without
    want_dw, dw_part is None (the rank body then skips writing it; the
    wide body writes it all the same)."""
    if not m1.is_cuda:
        return _fused_rank_bwd_saved_ref(m1, m2, gm, gr, gl, P_l, P_r,
                                         pi, weights)
    return _launch_bwd_saved(m1, m2, gm, gr, gl, P_l, P_r, pi, weights,
                             want_dw=want_dw)


def _pointers(outs):
    """Device pointers of the outputs (None: a null pointer)."""
    return [None if t is None else t.data_ptr() for t in outs]


def _wide_bwd_launch(K, G, A, S, dev):
    """(plan arguments, scratch tensors, the group form?) of a K9bs / K9b
    launch: the one-group body's (sc, cluster, threads, dpt), or the
    group form's (sc, cluster, threads, gb) with its (K, 4, G ceil(A / 4),
    S_pad) tile partials and (K, 5, S_pad) per-site scalars."""
    gb = wide_bwd_group(K, G, A, S)
    sc, cluster, threads, dpt, _, _ = wide_bwd_plan(
        K, G, A, S, max_cluster=MAX_CLUSTER, gb=gb)
    if gb == G:
        return (sc, cluster, threads, dpt), (), False
    Sp = _ceil(S, sc) * sc
    f = dict(dtype=torch.float32, device=dev)
    scratch = (torch.empty((K, 4, G * _ceil(A, 4), Sp), **f),
               torch.empty((K, 5, Sp), **f))
    return (sc, cluster, threads, gb), scratch, True


def _launch_bwd_saved(m1, m2, gm, gr, gl, P_l, P_r, pi, weights,
                      counter=None, want_dw=True):
    """K2 / K10's backward / K9bs on the card, counted under `counter`
    (default: the route's own name).  K2 is the dense (G = 1) form of
    K10's backward: P (K, A, A) is the same memory as (K, 1, A, A), and
    dP comes back in P's own shape."""
    K, GA, S = m1.shape
    G, A, wide = _check_bwd_args(gm, gr, gl, P_l, P_r, pi, weights, K, GA,
                                 S)
    _ext.require(m1, "m1", torch.float32, shape=(K, GA, S))
    _ext.require(m2, "m2", torch.float32, shape=(K, GA, S))
    dev = m1.device
    blocked = P_l.ndim == 4
    # the wide body writes dw unconditionally
    outs = _bwd_outputs(K, GA, S, P_l.shape, dev, want_dw or wide)
    ins = [t.data_ptr() for t in (m1, m2, gm, gr, gl, P_l, P_r, pi,
                                  weights)]
    out_p = _pointers(outs)
    if wide:
        plan, scratch, group = _wide_bwd_launch(K, G, A, S, dev)
        entry = "launch_wide_rank_bwd_saved" + ("_group" if group else "")
        fn = _ext.bind("wide_kernels", entry, 15 + len(scratch), 8)
        name = "fused_rank_bwd_saved_wide" + ("_blocked" if blocked else "")
        _ext.LAUNCHES[counter or name] += 1
        code = fn(*ins, *out_p, *(t.data_ptr() for t in scratch), K, G, A,
                  S, *plan, _ext.stream_ptr(dev))
    else:
        spl, warps, _, _, _ = rank_bwd_plan(K, G, A, S)
        fn = _ext.bind("rank_kernels", "launch_fused_rank_bwd_saved_blocked",
                       15, 6)
        name = "fused_rank_bwd_saved" + ("_blocked" if blocked else "")
        _ext.LAUNCHES[counter or name] += 1
        code = fn(*ins, *out_p, K, G, A, S, spl, warps, _ext.stream_ptr(dev))
    _ext.check(code, counter or name)
    return outs[:5] + ((outs[5] if want_dw else None),)


def fused_rank_bwd(leaves, buf, idx, gm, gr, gl, P_l, P_r, pi, weights,
                   want_dw=True):
    """K3: reverse of one rank's merge with both children re-gathered
    from `leaves` (N, GA, S) and the final write-once `buf` (K, R, GA, S)
    by the rank's idx (4, K) (the same contract as fused_rank_update).
    Same outputs as fused_rank_bwd_saved (and its want_dw)."""
    if not buf.is_cuda:
        return _fused_rank_bwd_ref(leaves, buf, idx, gm, gr, gl, P_l, P_r,
                                   pi, weights)
    K, R, GA, S = buf.shape
    N = leaves.shape[0]
    G, A, wide = _check_bwd_args(gm, gr, gl, P_l, P_r, pi, weights, K, GA,
                                 S)
    _ext.require(leaves, "leaves", torch.float32, shape=(N, GA, S))
    _ext.require(buf, "buf", torch.float32)
    _ext.require(idx, "idx", torch.int32, shape=(4, K))
    dev = buf.device
    blocked = P_l.ndim == 4
    outs = _bwd_outputs(K, GA, S, P_l.shape, dev, want_dw or wide)
    ins = [t.data_ptr() for t in (leaves, buf, idx, gm, gr, gl, P_l, P_r,
                                  pi, weights)]
    out_p = _pointers(outs)
    if wide:
        plan, scratch, group = _wide_bwd_launch(K, G, A, S, dev)
        entry = "launch_wide_rank_bwd" + ("_group" if group else "")
        fn = _ext.bind("wide_kernels", entry, 16 + len(scratch), 10)
        name = "fused_rank_bwd_wide" + ("_blocked" if blocked else "")
        _ext.LAUNCHES[name] += 1
        code = fn(*ins, *out_p, *(t.data_ptr() for t in scratch), K, R, N,
                  G, A, S, *plan, _ext.stream_ptr(dev))
    else:
        spl, warps, _, _, _ = rank_bwd_plan(K, G, A, S)
        fn = _ext.bind("rank_kernels", "launch_fused_rank_bwd_blocked", 16, 8)
        name = "fused_rank_bwd" + ("_blocked" if blocked else "")
        _ext.LAUNCHES[name] += 1
        code = fn(*ins, *out_p, K, R, N, G, A, S, spl, warps,
                  _ext.stream_ptr(dev))
    _ext.check(code, name)
    return outs[:5] + ((outs[5] if want_dw else None),)


def merge_ll_plan(S, A=4):
    """K8's threads a block (a block a particle): a thread a site, S
    rounded up to warps, at most MERGE_MAX_THREADS (half above 4 states:
    the kernel's launch bound allows 128 registers a thread there).
    Thread t owns the sites t + j threads (j = 0, 1, ...), one a pass.  At
    K = 32 on the H100 this beat a cluster of 2-8 blocks a particle summed
    through distributed shared memory by 1.1-1.5x at S = 256 and 898, and
    2 sites a thread a pass by 1.1x (tools/torch_k11c_k8_forms.py)."""
    top = MERGE_MAX_THREADS if A <= 4 else MERGE_MAX_THREADS // 2
    return min(top, _ceil(S, 32) * 32)


def merge_loglik(m1, m2, P_l, P_r, pi, weights):
    """K8: merge + rescale + root log-lik on explicit (K, A, S) children,
    no autograd.  Returns (merged_scaled (K, A, S), rootll (K,),
    logscale (K,)); rootll is the log-lik of the unscaled merge.  On the
    card its launch is `merge_ll_plan`'s."""
    if not m1.is_cuda:
        return _ref_impl(m1, m2, P_l, P_r, pi, weights)
    K, A, S = m1.shape
    check_states(A, MAX_A, "K8 (fused_merge_loglik)")
    f32 = torch.float32
    _ext.require(m1, "m1", f32, shape=(K, A, S))
    _ext.require(m2, "m2", f32, shape=(K, A, S))
    _ext.require(P_l, "P_l", f32, shape=(K, A, A))
    _ext.require(P_r, "P_r", f32, shape=(K, A, A))
    _ext.require(pi, "pi", f32, shape=(A,))
    _ext.require(weights, "weights", f32, shape=(S,))
    dev = m1.device
    merged = torch.empty((K, A, S), dtype=f32, device=dev)
    rootll = torch.empty((K,), dtype=f32, device=dev)
    logscale = torch.empty((K,), dtype=f32, device=dev)
    threads = merge_ll_plan(S, A)
    fn = _ext.bind("twist_kernels", "launch_merge_loglik", 9, 4)
    _ext.LAUNCHES["fused_merge_loglik"] += 1
    _ext.check(fn(m1.data_ptr(), m2.data_ptr(), P_l.data_ptr(),
                  P_r.data_ptr(), pi.data_ptr(), weights.data_ptr(),
                  merged.data_ptr(), rootll.data_ptr(), logscale.data_ptr(),
                  K, A, S, threads, _ext.stream_ptr(dev)),
               "fused_merge_loglik")
    return merged, rootll, logscale


def _merge_bwd_ref(m1, m2, P_l, P_r, pi, weights, gm, gr, gl):
    """Plain version of K11a: K2's plain math with its dpi / dw partial
    rows summed."""
    out = _fused_rank_bwd_saved_ref(m1, m2, gm, gr, gl, P_l, P_r, pi,
                                    weights)
    return out[:4] + (out[4].sum(0), out[5].sum(0))


def merge_bwd(m1, m2, P_l, P_r, pi, weights, gm, gr, gl, want_dw=True):
    """K11a: exact cotangents of `_ref_impl` (merge + rescale + root
    log-lik) on explicit dense children (the JAX package's
    `_merge_bwd_pallas`, same signature).  m1, m2 (K, A, S); P_l, P_r
    (K, A, A), or a rate mixture's blocks (K, G, A_b, A_b) (the twist's
    chosen merges over blocks of more than 8 states: protein + Gamma4
    and + Gamma8); gm (K, A, S), gr, gl (K,).  Returns (dm1, dm2, dP_l,
    dP_r in P's shape, dpi (A,), dw (S,), or None on the card without
    want_dw).  On the card it runs K2's body (the rank backward's dense
    form, A <= 8) or K9bs's (dense 8 < A <= 128, blocked G <= 32 blocks
    of 8 < A_b <= 128 states, in block groups where `wide_bwd_group`
    says), which compute exactly these cotangents, counted as
    `merge_bwd`."""
    if not m1.is_cuda:
        return _merge_bwd_ref(m1, m2, P_l, P_r, pi, weights, gm, gr, gl)
    out = _launch_bwd_saved(m1, m2, gm, gr, gl, P_l, P_r, pi, weights,
                            counter="merge_bwd", want_dw=want_dw)
    return out[:4] + (out[4].sum(0),
                      out[5].sum(0) if want_dw else None)


class _FusedMergeLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m1, m2, P_l, P_r, pi, weights):
        ctx.save_for_backward(m1, m2, P_l, P_r, pi, weights)
        return merge_loglik(m1, m2, P_l, P_r, pi, weights)

    @staticmethod
    def backward(ctx, gm, gr, gl):
        return merge_bwd(*ctx.saved_tensors, gm.contiguous(),
                         gr.contiguous(), gl.contiguous(),
                         want_dw=ctx.needs_input_grad[5])


def fused_merge_loglik(m1, m2, P_l, P_r, pi, weights):
    """Differentiable K8 (forward: the kernel on the card, `_ref_impl` on
    the CPU; backward: K11a, `merge_bwd`)."""
    return _FusedMergeLoglik.apply(m1, m2, P_l, P_r, pi, weights)


def _pow2(x):
    """The least power of two >= x."""
    return 1 << max(0, int(x) - 1).bit_length()


def _ceil(a, b):
    return -(-a // b)


def twist_blocks(model):
    """(G, A_b) when the twist's pair log-likelihoods take a rate
    mixture's per-category transitions (K11b, K7 wide and K11c in their
    blocked forms): the model has `blocks`, 2 <= G <= MAX_G blocks of A_b
    <= MAX_TWIST_A states.  None keeps the dense route (models without
    blocks).  One rule on every device and under either backward."""
    blocks = getattr(model, "blocks", None)
    if blocks is None:
        return None
    G, Ab = blocks
    if not 2 <= G <= MAX_G or Ab > MAX_TWIST_A:
        return None
    return G, Ab


def twist_route(model, planes):
    """The route the twist takes on the card for `model` with messages of
    `planes` planes: (G, A_b) blocked (`twist_blocks`), or None dense.
    Raises where the card has no kernel: a dense model above MAX_TWIST_A
    states.  Needs no tensor (smc.sweep checks it before touching one)."""
    blocks = twist_blocks(model)
    if blocks is None:
        check_states(planes, MAX_TWIST_A,
                     "the dense twist kernels K7, K11b, K11c")
    return blocks


def _check_twist_shape(G, Ab):
    """Raises outside the twist kernels' contract: dense (G = 1) A <= 64,
    blocked G <= 32 blocks of A_b <= 64 states."""
    check_states(Ab, MAX_TWIST_A, "the twist kernels K7 wide, K11b, K11c")
    if not 1 <= G <= MAX_G:
        raise NotImplementedError(
            f"the twist kernels take at most {MAX_G} rate-category blocks, "
            f"got {G}")


def twist_fwd_group(G, Ab):
    """K11b's block group: (AB, NG, groups).  AB is A_b padded to a power
    of two (at least 4), NG the blocks a group holds padded to a power of
    two: all G while AB NG <= TWIST_FWD_TILE planes fit a thread's
    registers (the one-group forms), else groups of TWIST_FWD_GROUP
    padded planes at two sites a thread (protein+G4: 4 groups of one
    block of 32 padded states), or of one block of 64 (GY94+G4).  On the
    H100 the 32-plane groups ran 1.6-1.8x quicker than 64-plane ones at
    one site a thread (protein+G4 rank 0, 8 x 16, 8 x 20, 17 x 4;
    PERF.md §6)."""
    _check_twist_shape(G, Ab)
    AB = _pow2(max(Ab, 4))
    if G == 1:
        NG = 1
    elif _pow2(G) * AB <= TWIST_FWD_TILE:
        NG = _pow2(G)
    else:
        NG = max(1, TWIST_FWD_GROUP // AB)
    return AB, NG, _ceil(G, NG)


def twist_fwd_smem(G, Ab, M, threads, spt):
    """Shared-memory bytes of K11b (csrc/twist_wide_kernels.cu's
    fwd_smem): a group's P double-buffered on both sides, pi, the warps'
    partials and, over several groups, each thread's M x spt site sums."""
    AB, NG, groups = twist_fwd_group(G, Ab)
    multi = groups > 1
    n = (4 * AB * AB * NG + (4 * _ceil(G * Ab, 4) if multi else AB * NG)
         + 2 * (FWD_MAX_THREADS // 32))
    if multi:
        n += M * spt * threads
    return 4 * n


def twist_fwd_plan(G, Ab, S, M=1):
    """K11b's launch: (sites a thread, threads a block, site tiles).  A
    thread holds 2 x (a group's padded planes) x SPT message values in
    registers: SPT = 2 up to 32 padded planes, 1 up to 64 (at 16 planes
    SPT = 2 ran 6-7% quicker than 4 and 16-46% quicker than 1 on the H100:
    tools/torch_twist_forms.py --spt); a block covers up to 256 threads'
    sites (S = 256 at SPT = 2: one block of 128 threads per row), fewer
    where several groups' M site sums a thread would not fit the shared
    memory."""
    AB, NG, _ = twist_fwd_group(G, Ab)
    spt = 2 if AB * NG <= 32 else 1
    threads = min(FWD_MAX_THREADS, max(32, _ceil(_ceil(S, spt), 32) * 32))
    while (threads > 32
           and twist_fwd_smem(G, Ab, M, threads, spt) > SMEM_LIMIT):
        threads -= 32
    if twist_fwd_smem(G, Ab, M, threads, spt) > SMEM_LIMIT:
        raise NotImplementedError(
            f"K11b: M={M} site sums of G={G} x A={Ab} do not fit a block")
    return spt, threads, _ceil(S, threads * spt)


def twist_bwd_smem(G, Ab, sc, t_field=False, gb=None, M=1):
    """Shared-memory bytes of K7 wide, or K11c (t_field), at a chunk of sc
    sites and gb blocks a group (csrc/twist_wide_kernels.cu's bwd_smem):
    the group's m1, m2, pi v, pi u (pitch sc + 4), site partials, gsite
    (one row; M rows over several groups), the double-buffered P in both
    layouts (and K11c's staged T) and pi."""
    gb = G if gb is None else gb
    NPG = _ceil(Ab, 4)
    GAg = gb * Ab
    rows = M if gb < G else 1
    return 4 * ((4 * GAg + gb * NPG + rows) * (sc + 4)
                + (9 if t_field else 8) * GAg * 4 * NPG
                + _ceil(G * Ab, 4) * 4)


def _bwd_sc(G, Ab, S, t_field, gb, M):
    """K7 wide's chunk at gb blocks a group: the most sites, at most 256
    and a multiple of 32, whose tiles fit 512 threads and whose layout
    fits the shared memory; 0 where none does."""
    NGT = gb * _ceil(Ab, 4)
    sc = min(BWD_MAX_SC, (4 * BWD_MAX_THREADS // NGT) // 32 * 32,
             _ceil(S, 32) * 32)
    while sc > 32 and twist_bwd_smem(G, Ab, sc, t_field, gb, M) > SMEM_LIMIT:
        sc -= 32
    if sc < 32 or twist_bwd_smem(G, Ab, sc, t_field, gb, M) > SMEM_LIMIT:
        return 0
    return sc


def twist_bwd_group(G, Ab, S, t_field=False, M=1, KC=None):
    """Blocks a group of K7 wide and K11c for KC rows (a block each; None:
    a full grid): all G (the one-pass body) while the row's every plane
    fits a chunk of at least BWD_ONE_PASS_SC sites, or of all S (DS1: 4 x
    4 at SC = 256; dense A <= 64), or while the grid has fewer than two
    blocks an SM, where a row's own threads set the time; else one block
    a group (two passes: gsite from a first pass over the groups,
    csrc/twist_wide_kernels.cu), at up to 256 sites a chunk (protein+G4,
    whose one group would take SC = 96; GY94+G4, whose one group does not
    fit).  On the H100 at 896 rows a block a group beat the one-pass
    layout at chunks under 128 sites (protein+G4 by 9-10%, 8 x 20 by 2x,
    5 x 20 by 24%) and lost to it at 128 (3 x 20, by 13%); at 15 rows it
    ran 1.5-1.7x slower (PERF.md §6)."""
    _check_twist_shape(G, Ab)
    sc = _bwd_sc(G, Ab, S, t_field, G, M)
    if sc and (sc >= min(BWD_ONE_PASS_SC, _ceil(S, 32) * 32)
               or KC is not None and KC < 2 * SMS):
        return G
    if _bwd_sc(G, Ab, S, t_field, 1, M):
        return 1
    raise NotImplementedError(
        f"K7 wide: no block group of G={G} x A={Ab} fits a block at M={M}")


def twist_bwd_plan(G, Ab, S, t_field=False, M=1, gb=None):
    """K7 wide's launch, or K11c's above 8 dense states and blocked
    (t_field): (SC sites a chunk, threads, shared-memory bytes) at gb
    blocks a group (default `twist_bwd_group`).  A thread owns a (4
    planes x 4 sites) tile, so a chunk needs NGT SC / 4 threads (NGT = gb
    ceil(A_b / 4) plane tiles, up to 512 threads); SC is at most 256, a
    multiple of 32, and shrinks until the chunk's m1, m2, pi v, pi u
    (pitch SC + 4), site partials, gsite and the double-buffered P in
    both layouts (and K11c's staged T) fit a block's 227 KB
    (`twist_bwd_smem`).  K11c at DS1's 16 dense states, S = 256: SC = 256
    the quickest, 128 3% slower, 32 2.3-3x
    (tools/torch_k11c_k8_forms.py)."""
    if gb is None:
        gb = twist_bwd_group(G, Ab, S, t_field, M)
    sc = _bwd_sc(G, Ab, S, t_field, gb, M)
    if not sc:
        raise NotImplementedError(
            f"K7 wide: {gb} blocks of {Ab} states do not fit a block")
    NGT = gb * _ceil(Ab, 4)
    return (sc, _ceil(NGT * sc // 4, 32) * 32,
            twist_bwd_smem(G, Ab, sc, t_field, gb, M))


def k7_smem(M, A, warps, t_field=False):
    """Shared-memory bytes of K7, or of K11c at A <= 8 (t_field)
    (csrc/twist_kernels.cu's k7_smem): M rows of P_l | P_r at a 16-byte
    pitch, g (M floats, padded to 4) and each warp's M x 2 A^2 dP slots
    (K11c: M x A^2 T slots)."""
    pitch = 4 * _ceil(2 * A * A, 4)
    nv = A * A if t_field else 2 * A * A
    return 4 * (M * pitch + 4 * _ceil(M, 4) + warps * M * nv)


def twist_narrow_plan(KC, M, A, S, spl=None, max_warps=None,
                      t_field=False):
    """K7's launch (dense A <= 8): (sites a lane, warps a row, chunks a
    row, blocks, shared-memory bytes).  A block a row; a chunk is 32
    lanes x spl sites and warp w takes chunks w, w + warps, ...  spl =
    K7_SPL (1 above 4 states, where a lane's 2 A^2 dP sums and P fill
    the registers; `_shrink_spl` on a short grid); warps = as few as give
    the grid GRID_WARPS, at most the row's chunks and K7_MAX_WARPS, fewer
    while the dP slots of all M would not fit.  Primate rank 0 (KC =
    2112, M = 10, S = 256): spl 2, one warp a row walking 4 chunks; 6
    taxa left (KC = 480): 4 warps; the last rank (KC = 32): spl 1, 8
    warps -- the quickest forms on the H100 (tools/torch_k7_forms.py; 2
    warps of 4 sites a lane, 162 registers, ran 22% slower at rank 0).
    t_field: K11c's launch at A <= 8, the same body in its T-field form,
    with M x A^2 slots a warp; the same forms were K11c's quickest at
    those three row counts (tools/torch_k11c_k8_forms.py)."""
    mw = max_warps or K7_MAX_WARPS
    if spl is None:
        spl = _shrink_spl(KC, S, K7_SPL if A <= 4 else 1, mw)
    chunks = _ceil(S, 32 * spl)
    warps = min(chunks, mw, _ceil(GRID_WARPS, KC))
    while warps > 1 and k7_smem(M, A, warps, t_field) > SMEM_LIMIT:
        warps -= 1
    if k7_smem(M, A, warps, t_field) > SMEM_LIMIT:
        raise NotImplementedError(
            f"K7 keeps M x 2 A^2 dP sums in shared memory: M={M} at A={A} "
            f"needs {k7_smem(M, A, 1, t_field)} bytes, over {SMEM_LIMIT}")
    return spl, warps, chunks, KC, k7_smem(M, A, warps, t_field)


def _as_blocks(P):
    """Transitions as (M, K, G, A_b, A_b): a dense (M, K, A, A) is G = 1."""
    return P[:, :, None] if P.ndim == 4 else P


def _pair_site_lik(m1, m2, P_l, P_r, pi):
    """(M, K, S) site likelihoods of M candidate merges per particle, as
    explicit multiply-adds in the JAX package's order.  P dense (M, K, A,
    A) or blocked (M, K, G, A_b, A_b): u_b runs over the a of b's block
    (state g * A_b + a), the site sum over all planes in order, so on a
    block-diagonal input the blocked form drops only exact zero terms and
    equals the dense one."""
    P_l, P_r = _as_blocks(P_l), _as_blocks(P_r)
    G, Ab = P_l.shape[2], P_l.shape[-1]
    site_lik = None
    for g in range(G):
        for b in range(Ab):
            u_b = v_b = None
            for a in range(Ab):
                tu = m1[None, :, g * Ab + a, :] * P_l[:, :, g, a, b, None]
                tv = m2[None, :, g * Ab + a, :] * P_r[:, :, g, a, b, None]
                u_b = tu if u_b is None else u_b + tu
                v_b = tv if v_b is None else v_b + tv
            term = (u_b * v_b) * pi[g * Ab + b]
            site_lik = term if site_lik is None else site_lik + term
    return site_lik


def _pair_ll_ref(m1, m2, P_l, P_r, pi, weights):
    """Data log-likelihoods (M, K) of M candidate merges per particle:
    m1, m2 (K, A, S) shared across M; P_l, P_r (M, K, A, A), or blocked
    (M, K, G, A_b, A_b) with A = G A_b.  The plain version of K11b."""
    site_lik = _pair_site_lik(m1, m2, P_l, P_r, pi)
    return torch.sum(torch.log(site_lik) * weights[None, None, :], dim=-1)


def _dw_ref(m1, m2, P_l, P_r, pi, g):
    """Site-weight cotangent sum_{m,k} g[m,k] log site_lik[m,k,s]."""
    site_lik = _pair_site_lik(m1, m2, P_l, P_r, pi)
    return torch.sum(g[:, :, None] * torch.log(site_lik), dim=(0, 1))


def _twist_args(m1, m2, P_l, P_r, pi, weights, g=None):
    """Validates a twist kernel's inputs on the card, a blocked P per
    block (G <= 32 blocks of A_b <= 64 states), a dense one at A <= 64;
    returns (M, K, G, A_b, S) (G = 1, A_b = A for dense transitions)."""
    M, K = P_l.shape[:2]
    G = P_l.shape[2] if P_l.ndim == 5 else 1
    Ab = P_l.shape[-1]
    A, S = G * Ab, m1.shape[-1]
    _check_twist_shape(G, Ab)
    f32 = torch.float32
    _ext.require(m1, "m1", f32, shape=(K, A, S))
    _ext.require(m2, "m2", f32, shape=(K, A, S))
    P_shape = (M, K) + (G,) * (P_l.ndim == 5) + (Ab, Ab)
    _ext.require(P_l, "P_l", f32, shape=P_shape)
    _ext.require(P_r, "P_r", f32, shape=P_shape)
    _ext.require(pi, "pi", f32, shape=(A,))
    _ext.require(weights, "weights", f32, shape=(S,))
    if g is not None:
        _ext.require(g, "g", f32, shape=(M, K))
    return M, K, G, Ab, S


def pair_ll_fwd(m1, m2, P_l, P_r, pi, weights):
    """K11b: the (M, K) data log-likelihoods `_pair_ll_ref` computes, one
    kernel launch (M looped inside) plus a fixed-order sum of its
    per-tile partials; no autograd.  Blocked transitions (P of rank 5)
    launch the blocked form, counted as `pair_loglik_fwd_blocked`, in
    block groups where a thread's registers do not hold them all
    (`twist_fwd_group`)."""
    if not m1.is_cuda:
        return _pair_ll_ref(m1, m2, P_l, P_r, pi, weights)
    M, K, G, Ab, S = _twist_args(m1, m2, P_l, P_r, pi, weights)
    spt, threads, tiles = twist_fwd_plan(G, Ab, S, M)
    part = torch.empty((M, K, tiles), dtype=torch.float32, device=m1.device)
    fn = _ext.bind("twist_wide_kernels", "launch_pair_ll_fwd", 7, 8)
    name = "pair_loglik_fwd_blocked" if P_l.ndim == 5 else "pair_loglik_fwd"
    _ext.LAUNCHES[name] += 1
    _ext.check(fn(m1.data_ptr(), m2.data_ptr(), P_l.data_ptr(),
                  P_r.data_ptr(), pi.data_ptr(), weights.data_ptr(),
                  part.data_ptr(), K, M, G, Ab, S, spt, threads, tiles,
                  _ext.stream_ptr(m1.device)), name)
    return torch.sum(part, dim=-1)


def _pair_ll_bwd_plain(m1, m2, P_l, P_r, pi, weights, g):
    """Plain version of K7 and K7 wide (dense and blocked): the autograd
    VJP of `_pair_ll_ref`.  Returns (dm1, dm2, dP_l, dP_r, dpi, dw), dP
    in P's own shape."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (m1, m2, P_l, P_r, pi, weights)]
        return torch.autograd.grad(_pair_ll_ref(*ins), ins, g)


def _dp_from_t(T, P_l, P_r, pi):
    """dP_l[a, b] = pi_b sum_a' T[a, a'] P_r[a', b] and dP_r[a', b] =
    pi_b sum_a T[a, a'] P_l[a, b] (per (m, k) A x A products, full
    float32 on the card, as the JAX package forms them outside its
    kernel; K11c forms them inside its kernel)."""
    return (exact_matmul(T, P_r) * pi,
            exact_matmul(T.transpose(-1, -2), P_l) * pi)


def _pair_ll_bwd_t_ref(m1, m2, P_l, P_r, pi, weights, g):
    """Plain version of K11c, term for term `_kernel_ll_bwd2`'s math:
    gsite = g w / site; T[a, a'] = sum_s gsite m1[a] m2[a']; dm1[a] =
    sum_m gsite vbar_a, vbar_a = sum_b P_l[a, b] pi_b v_b (dm2 mirrored);
    dP from T.  Blocked transitions (P of rank 5) take the same math per
    block (`_pair_ll_bwd_t_blocked`).  Returns (dm1, dm2, dP_l, dP_r, dpi,
    dw)."""
    if P_l.ndim == 5:
        return _pair_ll_bwd_t_blocked(m1, m2, P_l, P_r, pi, weights, g)
    u = _apply_t(m1[None], P_l)                       # (M, K, A, S)
    v = _apply_t(m2[None], P_r)
    pu = u * pi[:, None]
    pv = v * pi[:, None]
    site = torch.sum(u * pv, dim=-2)                  # (M, K, S)
    gsite = (g[:, :, None] * weights) / site
    T = exact_matmul(gsite[:, :, None, :] * m1[None],
                     m2[None].transpose(-1, -2))      # (M, K, A, A)
    dm1 = torch.sum(gsite[:, :, None, :] * exact_matmul(P_l, pv), dim=0)
    dm2 = torch.sum(gsite[:, :, None, :] * exact_matmul(P_r, pu), dim=0)
    dPl, dPr = _dp_from_t(T, P_l, P_r, pi)
    dpi = torch.sum(dPl * P_l, dim=(0, 1, 2)) / pi
    return dm1, dm2, dPl, dPr, dpi, _dw_ref(m1, m2, P_l, P_r, pi, g)


def _pair_ll_bwd_t_blocked(m1, m2, P_l, P_r, pi, weights, g):
    """`_pair_ll_bwd_t_ref` for blocked P (M, K, G, A_b, A_b): u, v, T
    and dP within each block (T only on the diagonal blocks, where dP
    lives), the site sum over all G A_b planes in plane order."""
    M, K, G, Ab = P_l.shape[:4]
    A, S = m1.shape[1:]
    mb1 = m1.reshape(K, G, Ab, S)[None]
    mb2 = m2.reshape(K, G, Ab, S)[None]
    pib = pi.reshape(G, Ab)
    u = _apply_t(mb1, P_l)                            # (M, K, G, Ab, S)
    v = _apply_t(mb2, P_r)
    pu = u * pib[:, :, None]
    pv = v * pib[:, :, None]
    site = torch.sum((u * pv).reshape(M, K, A, S), dim=-2)
    gsite = ((g[:, :, None] * weights) / site)[:, :, None, None, :]
    T = exact_matmul(gsite * mb1, mb2.transpose(-1, -2))  # diagonal blocks
    dm1 = torch.sum(gsite * exact_matmul(P_l, pv), dim=0)
    dm2 = torch.sum(gsite * exact_matmul(P_r, pu), dim=0)
    dPl, dPr = _dp_from_t(T, P_l, P_r, pib[:, None, :])
    dpi = torch.sum(dPl * P_l, dim=(0, 1, 3)).reshape(A) / pi
    return (dm1.reshape(K, A, S), dm2.reshape(K, A, S), dPl, dPr, dpi,
            _dw_ref(m1, m2, P_l, P_r, pi, g))


def pair_ll_bwd(m1, m2, P_l, P_r, pi, weights, g, want_dw=True):
    """Cotangents of `_pair_ll_ref` for the output cotangent g (M, K):
    dense K7 (A <= 8), K7 wide (8 < A <= 64, and every blocked P, counted
    as `pair_ll_bwd_wide_blocked`), or K11c, the T-field form, when
    TWIST_BWD_V2 is set (PHYLO_TWIST_BWD_V2=1, the JAX package's knob): on
    the card K7's body (dense A <= 8) or K7 wide's (dense A > 8, and
    blocked P, counted as `pair_ll_bwd_t_blocked`) in their T-field form,
    which return dP_l, dP_r as K7 does, on K7's plans.  A blocked P runs
    in block groups where its planes do not fit a block's shared memory
    at once (`twist_bwd_group`).  Returns (dm1, dm2 (K, A, S), dP_l, dP_r
    in P's shape, dpi (A,), dw (S,) or None without want_dw)."""
    blocked = P_l.ndim == 5
    t_field = TWIST_BWD_V2
    if not m1.is_cuda:
        plain = _pair_ll_bwd_t_ref if t_field else _pair_ll_bwd_plain
        return plain(m1, m2, P_l, P_r, pi, weights, g)
    M, K, G, Ab, S = _twist_args(m1, m2, P_l, P_r, pi, weights, g)
    A = G * Ab
    f32 = torch.float32
    dev = m1.device
    dm1 = torch.empty((K, A, S), dtype=f32, device=dev)
    dm2 = torch.empty((K, A, S), dtype=f32, device=dev)
    dPl = torch.empty(P_l.shape, dtype=f32, device=dev)
    dPr = torch.empty(P_r.shape, dtype=f32, device=dev)
    ins = [t.data_ptr() for t in (m1, m2, P_l, P_r, pi, weights, g, dm1,
                                  dm2, dPl, dPr)]
    stream = _ext.stream_ptr(dev)
    if blocked or A > MAX_A:
        if t_field:
            name = "pair_ll_bwd_t_blocked" if blocked else "pair_ll_bwd_t"
            entry = "launch_pair_ll_bwd_t"
        else:
            name = ("pair_ll_bwd_wide_blocked" if blocked
                    else "pair_ll_bwd_wide")
            entry = "launch_pair_ll_bwd_wide"
        gb = twist_bwd_group(G, Ab, S, t_field, M, K)
        fn = _ext.bind("twist_wide_kernels", entry, 11, 9)
        _ext.LAUNCHES[name] += 1
        code = fn(*ins, K, M, G, Ab, S,
                  *twist_bwd_plan(G, Ab, S, t_field, M, gb), gb, stream)
    elif t_field:
        name = "pair_ll_bwd_t"
        fn = _ext.bind("twist_kernels", "launch_pair_ll_bwd_t", 11, 6)
        plan = twist_narrow_plan(K, M, A, S, t_field=True)[:2]
        _ext.LAUNCHES[name] += 1
        code = fn(*ins, K, M, A, S, *plan, stream)
    else:
        name = "pair_ll_bwd"
        spl, warps, _, _, _ = twist_narrow_plan(K, M, A, S)
        fn = _ext.bind("twist_kernels", "launch_pair_ll_bwd", 11, 6)
        _ext.LAUNCHES[name] += 1
        code = fn(*ins, K, M, A, S, spl, warps, stream)
    _ext.check(code, name)
    # dpi_b = sum_{m,k,a} dP_l[m,k,a,b] P_l[m,k,a,b] / pi_b over b's block:
    # P does not depend on the site, so it factors out of dP_l's site sum
    dpi = torch.sum(_as_blocks(dPl * P_l), dim=(0, 1, 3)).reshape(A) / pi
    dw = _dw_ref(m1, m2, P_l, P_r, pi, g) if want_dw else None
    return dm1, dm2, dPl, dPr, dpi, dw


class _PairLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fwd, m1, m2, P_l, P_r, pi, weights):
        ctx.save_for_backward(m1, m2, P_l, P_r, pi, weights)
        return fwd(m1, m2, P_l, P_r, pi, weights)

    @staticmethod
    def backward(ctx, g):
        grads = pair_ll_bwd(*ctx.saved_tensors, g.contiguous(),
                            want_dw=ctx.needs_input_grad[6])
        return (None,) + tuple(grads)


def pair_loglik(m1, m2, P_l, P_r, pi, weights):
    """Data log-likelihoods of M candidate merges per particle, (M, K),
    differentiable: the forward is the plain multiply-add expression
    (an XLA fusion in the JAX package, not a Pallas kernel), the
    backward `pair_ll_bwd` (K7, K7 wide or K11c on the card, the plain
    VJP on the CPU).  P dense or blocked; the gradient comes back in P's
    own shape."""
    return _PairLoglik.apply(_pair_ll_ref, m1, m2, P_l, P_r, pi, weights)


def fused_pair_loglik(m1, m2, P_l, P_r, pi, weights):
    """`pair_loglik` with the forward as K11b, `pair_ll_fwd` (the JAX
    package's `fused_pair_loglik`); the same backward."""
    return _PairLoglik.apply(pair_ll_fwd, m1, m2, P_l, P_r, pi, weights)


def check_states(A, limit, kernel):
    """Raises where the card has no kernel for A states."""
    if not 1 <= A <= limit:
        raise NotImplementedError(
            f"{kernel} take(s) A <= {limit} states on the card, got {A} "
            "(ROADMAP.md Queue 3: paths the card refuses)")


def _check_a(A, G=1):
    """The card's limits of K10's blocks: A <= 8 states (`wide_planes`
    sends wider blocks to K9 blocked), G <= 32 blocks."""
    check_states(A, MAX_A, "the blocked rank kernels K10")
    if not 1 <= G <= MAX_G:
        raise NotImplementedError(
            f"the CUDA rank kernels take at most {MAX_G} rate-category "
            f"blocks, got {G}")
