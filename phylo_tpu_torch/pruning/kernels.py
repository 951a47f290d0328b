"""Kernels K1, K2, K3 and K10: the fused rank update, its backward from
saved children and its backward that re-gathers the children (port of
phylo_tpu/pruning/kernels.py::fused_rank_update, ::fused_rank_bwd_saved
and ::fused_rank_bwd), dense and blocked (K10, rate mixtures: G > 1);
K8, the same merge on explicit children (::fused_merge_loglik), and K7,
the VNCSMC pair-loglik backward (::pair_loglik's `_pair_ll_bwd_pallas`),
further down.

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
dense messages of 8 < A <= 128 states (K9, the wide bodies: JAX's
`wide_rank_kernel` rule, G A^2 > 64, for G = 1; codon GY94 has A = 61);
CPU tensors run the plain versions `_fused_rank_ref` /
`_fused_rank_bwd_saved_ref` / `_fused_rank_bwd_ref` below, at any A.  A
blocked model takes A <= 8 states per block and G <= 32 blocks on the
card (K9's blocked wide form is not ported).  K1, K2, K3 and K9 have no
autograd rule: only the manual whole-sweep VJP (smc.sweep_vjp) and the
no-grad sweep call them.  K7 and K8 live in csrc/twist_kernels.cu, take
A <= 8 and carry torch.autograd.Functions (`fused_merge_loglik`,
`pair_loglik`).
"""

from __future__ import annotations

import torch

from phylo_tpu_torch import _ext
from phylo_tpu_torch.models.expm import exact_matmul

MAX_A = 8                       # states per block of K1-K3, K7, K8, K10
MAX_G = 32                      # rate-category blocks on the card
MAX_WIDE_A = 128                # dense states of the wide kernels K9
WIDE_TILE = 32                  # K9f: sites per CUDA block (partial rows)
BWD_PARTICLES_PER_BLOCK = 8     # K2/K3: particles per CUDA block (dpi/dw
                                # partials come back one row per block)
# bytes of the (R, K, 2, G*A, S) child residuals the manual-VJP forward
# may save for K2; above it the reverse pass re-gathers through K3
SAVE_CHILDREN_CAP = 2 ** 28


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


def wide_rank(P_l, GA):
    """True when a rank on the card takes the wide kernels K9: dense
    transitions with A^2 > 64 (JAX's `wide_rank_kernel` rule at G = 1).
    Raises where the card has no kernel (blocked A > 8, dense A > 128)."""
    G, A = _blocks(P_l, GA)
    if P_l.ndim == 4:
        _check_a(A, G, blocked=True)
        return False
    if A * A <= 64:
        return False
    if A > MAX_WIDE_A:
        raise NotImplementedError(
            f"the wide CUDA rank kernels take A <= {MAX_WIDE_A} states, "
            f"got {A}")
    return True


def fused_rank_update(leaves, buf, idx, outc, P_l, P_r, pi, weights,
                      save_children=False):
    """One full rank update, in place: child gather + transitions +
    merge + rescale + root log-lik + write of column `outc` of `buf`.

    leaves (N, GA, S) shared leaf messages; buf (K, R, GA, S) write-once
    buffer (node N+q lives in column q); idx (4, K) int32; outc int (the
    rank, never among the children read); P_l, P_r (K, A, A), or
    (K, G, A, A) blocked (K10); pi (GA,); weights (S,).  Returns (rootll
    (K,), logscale (K,)) and, with save_children, the gathered children
    (K, GA, S) twice."""
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
    _ext.require(buf, "buf", f32)
    _ext.require(idx, "idx", torch.int32, shape=(4, K))
    pshape = (K, G, A, A) if blocked else (K, A, A)
    _ext.require(P_l, "P_l", f32, shape=pshape)
    _ext.require(P_r, "P_r", f32, shape=pshape)
    _ext.require(pi, "pi", f32, shape=(GA,))
    _ext.require(weights, "weights", f32, shape=(S,))
    if not 0 <= outc < R:
        raise ValueError(f"output column {outc} outside [0, {R})")
    dev = buf.device
    # K9f writes one partial row per 32-site tile, summed below (fixed
    # order); K1 and K10 write rootll and logscale themselves
    T = -(-S // WIDE_TILE) if wide else 1
    sums = torch.empty((2, K, T), dtype=f32, device=dev)
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
        fn = _ext.bind("wide_kernels", "launch_wide_rank", 11, 6)
        name = "fused_rank_update_wide"
        _ext.LAUNCHES[name] += 1
        code = fn(*ptrs, K, R, N, A, S, outc, _ext.stream_ptr(dev))
    elif blocked:
        fn = _ext.bind("rank_kernels", "launch_fused_rank_blocked", 11, 7)
        name = "fused_rank_update_blocked"
        _ext.LAUNCHES[name] += 1
        code = fn(*ptrs, K, R, N, G, A, S, outc, _ext.stream_ptr(dev))
    else:
        fn = _ext.bind("rank_kernels", "launch_fused_rank", 11, 6)
        name = "fused_rank_update"
        _ext.LAUNCHES[name] += 1
        code = fn(*ptrs, K, R, N, A, S, outc, _ext.stream_ptr(dev))
    _ext.check(code, name)
    rootll, logscale = torch.sum(sums, dim=2) if wide else sums[:, :, 0]
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


def _bwd_outputs(K, GA, S, P_shape, dev):
    nb = -(-K // BWD_PARTICLES_PER_BLOCK)
    f = dict(dtype=torch.float32, device=dev)
    return (torch.empty((K, GA, S), **f), torch.empty((K, GA, S), **f),
            torch.empty(P_shape, **f), torch.empty(P_shape, **f),
            torch.empty((nb, GA), **f), torch.empty((nb, S), **f))


def _wide_bwd_outputs(K, A, S, dev):
    """K9bs / K9b: one CUDA block per particle, so dpi / dw come back as
    (K, A) / (K, S) partial rows."""
    f = dict(dtype=torch.float32, device=dev)
    return (torch.empty((K, A, S), **f), torch.empty((K, A, S), **f),
            torch.empty((K, A, A), **f), torch.empty((K, A, A), **f),
            torch.empty((K, A), **f), torch.empty((K, S), **f))


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


def fused_rank_bwd_saved(m1, m2, gm, gr, gl, P_l, P_r, pi, weights):
    """Reverse of one rank's merge from the children saved by the
    forward (K2; K10's backward for blocked P).  gm (K, GA, S)
    merged-message cotangent; gr, gl (K,) rootll / logscale cotangents.
    Returns (dm1, dm2, dP_l, dP_r, dpi_part (n, GA), dw_part (n, S));
    the caller sums the partials over rows."""
    if not m1.is_cuda:
        return _fused_rank_bwd_saved_ref(m1, m2, gm, gr, gl, P_l, P_r,
                                         pi, weights)
    K, GA, S = m1.shape
    G, A, wide = _check_bwd_args(gm, gr, gl, P_l, P_r, pi, weights, K, GA,
                                 S)
    _ext.require(m1, "m1", torch.float32, shape=(K, GA, S))
    _ext.require(m2, "m2", torch.float32, shape=(K, GA, S))
    dev = m1.device
    tkb = BWD_PARTICLES_PER_BLOCK
    outs = (_wide_bwd_outputs(K, A, S, dev) if wide
            else _bwd_outputs(K, GA, S, P_l.shape, dev))
    ins = [t.data_ptr() for t in (m1, m2, gm, gr, gl, P_l, P_r, pi,
                                  weights)]
    out_p = [t.data_ptr() for t in outs]
    if wide:
        fn = _ext.bind("wide_kernels", "launch_wide_rank_bwd_saved", 15, 3)
        name = "fused_rank_bwd_saved_wide"
        _ext.LAUNCHES[name] += 1
        code = fn(*ins, *out_p, K, A, S, _ext.stream_ptr(dev))
    elif P_l.ndim == 4:
        scratch = torch.empty((outs[4].shape[0], 5, S), dtype=torch.float32,
                              device=dev)
        fn = _ext.bind("rank_kernels", "launch_fused_rank_bwd_saved_blocked",
                       16, 5)
        name = "fused_rank_bwd_saved_blocked"
        _ext.LAUNCHES[name] += 1
        code = fn(*ins, *out_p, scratch.data_ptr(), K, G, A, S, tkb,
                  _ext.stream_ptr(dev))
    else:
        fn = _ext.bind("rank_kernels", "launch_fused_rank_bwd_saved", 15, 4)
        name = "fused_rank_bwd_saved"
        _ext.LAUNCHES[name] += 1
        code = fn(*ins, *out_p, K, A, S, tkb, _ext.stream_ptr(dev))
    _ext.check(code, name)
    return outs


def fused_rank_bwd(leaves, buf, idx, gm, gr, gl, P_l, P_r, pi, weights):
    """K3: reverse of one rank's merge with both children re-gathered
    from `leaves` (N, GA, S) and the final write-once `buf` (K, R, GA, S)
    by the rank's idx (4, K) (the same contract as fused_rank_update).
    Same outputs as fused_rank_bwd_saved."""
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
    tkb = BWD_PARTICLES_PER_BLOCK
    outs = (_wide_bwd_outputs(K, A, S, dev) if wide
            else _bwd_outputs(K, GA, S, P_l.shape, dev))
    ins = [t.data_ptr() for t in (leaves, buf, idx, gm, gr, gl, P_l, P_r,
                                  pi, weights)]
    out_p = [t.data_ptr() for t in outs]
    if wide:
        fn = _ext.bind("wide_kernels", "launch_wide_rank_bwd", 16, 5)
        name = "fused_rank_bwd_wide"
        _ext.LAUNCHES[name] += 1
        code = fn(*ins, *out_p, K, R, N, A, S, _ext.stream_ptr(dev))
    elif P_l.ndim == 4:
        scratch = torch.empty((outs[4].shape[0], 5, S), dtype=torch.float32,
                              device=dev)
        fn = _ext.bind("rank_kernels", "launch_fused_rank_bwd_blocked", 17, 7)
        name = "fused_rank_bwd_blocked"
        _ext.LAUNCHES[name] += 1
        code = fn(*ins, *out_p, scratch.data_ptr(), K, R, N, G, A, S, tkb,
                  _ext.stream_ptr(dev))
    else:
        fn = _ext.bind("rank_kernels", "launch_fused_rank_bwd", 16, 6)
        name = "fused_rank_bwd"
        _ext.LAUNCHES[name] += 1
        code = fn(*ins, *out_p, K, R, N, A, S, tkb, _ext.stream_ptr(dev))
    _ext.check(code, name)
    return outs


def merge_loglik(m1, m2, P_l, P_r, pi, weights):
    """K8: merge + rescale + root log-lik on explicit (K, A, S) children,
    no autograd.  Returns (merged_scaled (K, A, S), rootll (K,),
    logscale (K,)); rootll is the log-lik of the unscaled merge."""
    if not m1.is_cuda:
        return _ref_impl(m1, m2, P_l, P_r, pi, weights)
    K, A, S = m1.shape
    _check_a(A)
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
    fn = _ext.bind("twist_kernels", "launch_merge_loglik", 9, 3)
    _ext.LAUNCHES["fused_merge_loglik"] += 1
    _ext.check(fn(m1.data_ptr(), m2.data_ptr(), P_l.data_ptr(),
                  P_r.data_ptr(), pi.data_ptr(), weights.data_ptr(),
                  merged.data_ptr(), rootll.data_ptr(), logscale.data_ptr(),
                  K, A, S, _ext.stream_ptr(dev)),
               "fused_merge_loglik")
    return merged, rootll, logscale


class _FusedMergeLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m1, m2, P_l, P_r, pi, weights):
        ctx.save_for_backward(m1, m2, P_l, P_r, pi, weights)
        return merge_loglik(m1, m2, P_l, P_r, pi, weights)

    @staticmethod
    def backward(ctx, gm, gr, gl):
        saved = ctx.saved_tensors
        if saved[0].is_cuda:
            # K2 computes exactly these cotangents from explicit children
            m1, m2, P_l, P_r, pi, w = saved
            dm1, dm2, dPl, dPr, dpi, dw = fused_rank_bwd_saved(
                m1, m2, gm.contiguous(), gr.contiguous(), gl.contiguous(),
                P_l, P_r, pi, w)
            return dm1, dm2, dPl, dPr, dpi.sum(0), dw.sum(0)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in saved]
            outs = _ref_impl(*ins)
            return torch.autograd.grad(outs, ins, (gm, gr, gl))


def fused_merge_loglik(m1, m2, P_l, P_r, pi, weights):
    """Differentiable K8 (forward: the kernel on the card, `_ref_impl` on
    the CPU; backward: K2 on the card, the autograd VJP of `_ref_impl`
    on the CPU, as the JAX package's default `_bwd`)."""
    return _FusedMergeLoglik.apply(m1, m2, P_l, P_r, pi, weights)


def _pair_site_lik(m1, m2, P_l, P_r, pi):
    """(M, K, S) site likelihoods of M candidate merges per particle, as
    explicit multiply-adds in the JAX package's order."""
    A = P_l.shape[-1]
    site_lik = None
    for b in range(A):
        u_b = v_b = None
        for a in range(A):
            tu = m1[None, :, a, :] * P_l[:, :, a, b, None]
            tv = m2[None, :, a, :] * P_r[:, :, a, b, None]
            u_b = tu if u_b is None else u_b + tu
            v_b = tv if v_b is None else v_b + tv
        term = (u_b * v_b) * pi[b]
        site_lik = term if site_lik is None else site_lik + term
    return site_lik


def _pair_ll_ref(m1, m2, P_l, P_r, pi, weights):
    """Data log-likelihoods (M, K) of M candidate merges per particle:
    m1, m2 (K, A, S) shared across M; P_l, P_r (M, K, A, A)."""
    site_lik = _pair_site_lik(m1, m2, P_l, P_r, pi)
    return torch.sum(torch.log(site_lik) * weights[None, None, :], dim=-1)


def _dw_ref(m1, m2, P_l, P_r, pi, g):
    """Site-weight cotangent sum_{m,k} g[m,k] log site_lik[m,k,s]."""
    site_lik = _pair_site_lik(m1, m2, P_l, P_r, pi)
    return torch.sum(g[:, :, None] * torch.log(site_lik), dim=(0, 1))


def _pair_ll_bwd_plain(m1, m2, P_l, P_r, pi, weights, g):
    """Plain version of K7: the autograd VJP of `_pair_ll_ref`.  Returns
    (dm1, dm2, dP_l, dP_r, dpi, dw)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (m1, m2, P_l, P_r, pi, weights)]
        return torch.autograd.grad(_pair_ll_ref(*ins), ins, g)


def pair_ll_bwd(m1, m2, P_l, P_r, pi, weights, g, want_dw=True):
    """K7: cotangents of `_pair_ll_ref` for the output cotangent g (M, K).
    Returns (dm1, dm2 (K, A, S), dP_l, dP_r (M, K, A, A), dpi (A,), dw (S,)
    or None without want_dw)."""
    if not m1.is_cuda:
        return _pair_ll_bwd_plain(m1, m2, P_l, P_r, pi, weights, g)
    M, K, A, _ = P_l.shape
    S = m1.shape[-1]
    _check_a(A)
    f32 = torch.float32
    _ext.require(m1, "m1", f32, shape=(K, A, S))
    _ext.require(m2, "m2", f32, shape=(K, A, S))
    _ext.require(P_l, "P_l", f32, shape=(M, K, A, A))
    _ext.require(P_r, "P_r", f32, shape=(M, K, A, A))
    _ext.require(pi, "pi", f32, shape=(A,))
    _ext.require(weights, "weights", f32, shape=(S,))
    _ext.require(g, "g", f32, shape=(M, K))
    dev = m1.device
    dm1 = torch.empty((K, A, S), dtype=f32, device=dev)
    dm2 = torch.empty((K, A, S), dtype=f32, device=dev)
    dPl = torch.empty((M, K, A, A), dtype=f32, device=dev)
    dPr = torch.empty((M, K, A, A), dtype=f32, device=dev)
    fn = _ext.bind("twist_kernels", "launch_pair_ll_bwd", 11, 4)
    _ext.LAUNCHES["pair_ll_bwd"] += 1
    _ext.check(fn(m1.data_ptr(), m2.data_ptr(), P_l.data_ptr(),
                  P_r.data_ptr(), pi.data_ptr(), weights.data_ptr(),
                  g.data_ptr(), dm1.data_ptr(), dm2.data_ptr(),
                  dPl.data_ptr(), dPr.data_ptr(), K, M, A, S,
                  _ext.stream_ptr(dev)),
               "pair_ll_bwd")
    # dpi_b = sum_{m,k,a} dP_l[m,k,a,b] P_l[m,k,a,b] / pi_b: P does not
    # depend on the site, so it factors out of dP_l's site sum
    dpi = torch.sum(dPl * P_l, dim=(0, 1, 2)) / pi
    dw = _dw_ref(m1, m2, P_l, P_r, pi, g) if want_dw else None
    return dm1, dm2, dPl, dPr, dpi, dw


class _PairLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m1, m2, P_l, P_r, pi, weights):
        ctx.save_for_backward(m1, m2, P_l, P_r, pi, weights)
        return _pair_ll_ref(m1, m2, P_l, P_r, pi, weights)

    @staticmethod
    def backward(ctx, g):
        return pair_ll_bwd(*ctx.saved_tensors, g.contiguous(),
                           want_dw=ctx.needs_input_grad[5])


def pair_loglik(m1, m2, P_l, P_r, pi, weights):
    """Data log-likelihoods of M candidate merges per particle, (M, K),
    differentiable: the forward is the plain multiply-add expression
    (an XLA fusion in the JAX package, not a Pallas kernel), the
    backward is K7 on the card and the plain VJP on the CPU."""
    return _PairLoglik.apply(m1, m2, P_l, P_r, pi, weights)


def _check_a(A, G=1, blocked=False):
    """The card's limits of the narrow kernels: A <= 8 states per block,
    G <= 32 blocks (`blocked`: a rate mixture's K10)."""
    if not 1 <= A <= MAX_A:
        what, item = (("blocked rank kernels", "K9 blocked, ROADMAP.md "
                       "Queue 2") if blocked else
                      ("merge and twist kernels K7/K8", "K7/K8 wide, "
                       "ROADMAP.md Queue 3"))
        raise NotImplementedError(
            f"the CUDA {what} take A <= {MAX_A} states per block, got {A} "
            f"({item})")
    if not 1 <= G <= MAX_G:
        raise NotImplementedError(
            f"the CUDA rank kernels take at most {MAX_G} rate-category "
            f"blocks, got {G}")
