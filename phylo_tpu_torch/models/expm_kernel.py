"""Kernel K4: the uniformized-expm chain and its Frechet-adjoint backward
(port of phylo_tpu/models/expm_kernel.py).

Forward: P = e^{-mu b_eff} (I + D), D from the delta-form chain of
models.expm (order-12 Horner on the delta, S <- (x/j)(R + R S), then
12 squarings D <- 2D + D D), with (mu, R) = uniformize(Q).  Backward:
the cotangents of the TRUE matrix exponential via the Frechet-adjoint
identity L*(M, W) = L(M^T, W),

    b_bar = <P_bar, Q P>                       (zero past the clamp)
    Q_bar = sum_i b_eff_i e^{-mu b_eff_i} L_i,

with L_i the top-right block of the same delta chain run on the implicit
block matrix [[x R^T, P_bar_i / 2^s], [0, x R^T]] carried as a (T, F)
pair.  In the clamp region (b > 80/mu) the Q_bar term through
d(b_eff)/dQ is dropped, as the TPU kernel does.

CUDA tensors launch csrc/expm_kernels.cu: the forward and the backward
are one launch each, from Q itself (the kernels uniformize it), and the
backward returns Q_bar reduced over the batch (per-block partials summed
in block order, the same bits on every call) and b_bar.  `expm_plan`
gives both launches their shape.  CPU tensors run `_expm_fwd_plain` /
`_expm_bwd_plain`, the same arithmetic in torch.
"""

from __future__ import annotations

import torch

from phylo_tpu_torch import _ext
from phylo_tpu_torch.models.expm import CLAMP, _matmul, uniformize

MAX_A = 8
MAX_ORDER = 32          # the kernels' table of reciprocals 1/j
SMS = 132               # streaming multiprocessors of an H100 SXM
PLAN_THREADS = (64, 128, 256)
# the backward's block size from LARGE_B elements up (on an H100,
# tools/torch_expm_forms.py: 14-17% quicker than 128 threads and 6-9%
# than 512, since every block pays a partial and its barriers); the
# forward keeps the balance rule at every size (64 threads within 2% of
# 128, 3-11% quicker than 256 and 512)
BWD_LARGE_THREADS = 256
LARGE_B = 2 * SMS * BWD_LARGE_THREADS

_TICKETS = {}


def _ceil(a, b):
    return -(-a // b)


def expm_plan(B, A, backward=False):
    """(threads a block, blocks) of the K4 forward (or backward) launch
    for B elements: the size in PLAN_THREADS whose busiest SM gets the
    fewest elements (ceil(blocks / SMS) * threads), the smaller size on a
    tie, so that a batch of at least SMS * 64 elements covers every SM;
    the backward takes BWD_LARGE_THREADS from LARGE_B elements up."""
    if not 1 <= A <= MAX_A:
        raise ValueError(f"expm_plan takes 1 <= A <= {MAX_A}, got {A}")
    if backward and B >= LARGE_B:
        threads = BWD_LARGE_THREADS
    else:
        threads = min(PLAN_THREADS,
                      key=lambda t: (_ceil(_ceil(B, t), SMS) * t, t))
    return threads, _ceil(B, threads)


def _expm_fwd_plain(Q, b, order=12, squarings=12):
    """Plain version of the forward kernel: the delta chain of
    models.expm with the kernel's association, c = x (1/j),
    S <- c (R + R S), D <- 2 D + D D, P = e^{-mu b_eff} (I + D).  b: any
    batch shape -> (..., A, A)."""
    mu, R = uniformize(Q)
    b_eff = torch.minimum(b, CLAMP / mu)
    x = ((mu * b_eff) * 2.0 ** -squarings)[..., None, None]
    S = (x * (1.0 / order)) * R
    for j in range(order - 1, 0, -1):
        S = (x * (1.0 / j)) * (R + _matmul(R, S))
    for _ in range(squarings):
        S = 2.0 * S + _matmul(S, S)
    eye = torch.eye(Q.shape[-1], dtype=S.dtype, device=S.device)
    return torch.exp(-mu * b_eff)[..., None, None] * (S + eye)


def _block_sum(field, threads):
    """sum over the batch of field (B, A, A) as the kernel takes it: the
    sum of each block of `threads` elements, then of the blocks in
    order."""
    B = field.shape[0]
    nb = _ceil(B, threads)
    padded = torch.cat([field, field.new_zeros(
        (nb * threads - B,) + field.shape[1:])])
    parts = padded.reshape((nb, threads) + field.shape[1:]).sum(1)
    return parts.sum(0)


def _expm_bwd_plain(Q, b, P, gbar, order=12, squarings=12):
    """Plain version of the backward kernel: (Q_bar (A, A), b_bar (B,))
    from Q, b (B,), the forward's P and P_bar (B, A, A), with the
    kernel's association: c = x (1/j) scales each product,
    SF <- c R^T SF + (1/j)(E + E ST), ST <- c (R^T + R^T ST)."""
    A = Q.shape[-1]
    mu, R = uniformize(Q)
    RT = R.T
    b_eff = torch.minimum(b, CLAMP / mu)
    inv2s = 2.0 ** -squarings
    x = ((mu * b_eff) * inv2s)[:, None, None]
    E = gbar * inv2s
    ST = (x * (1.0 / order)) * RT
    SF = E * (1.0 / order)
    for j in range(order - 1, 0, -1):
        c = x * (1.0 / j)
        SF = c * _matmul(RT, SF) + (1.0 / j) * (E + _matmul(E, ST))
        ST = c * (RT + _matmul(RT, ST))
    DT, DF = ST, SF
    for _ in range(squarings):
        DF = 2.0 * DF + _matmul(DT, DF) + _matmul(DF, DT)
        DT = 2.0 * DT + _matmul(DT, DT)
    w = b_eff * torch.exp(-mu * b_eff)
    qbar = _block_sum(w[:, None, None] * DF,
                      expm_plan(b.shape[0], A, backward=True)[0])
    bbar = torch.sum(gbar * _matmul(Q, P), dim=(-2, -1))
    bbar = torch.where(b <= CLAMP / mu, bbar, torch.zeros_like(bbar))
    return qbar, bbar


def expm_fwd(Q, b, order=12, squarings=12):
    """K4 forward wrapper: Q (A, A), b (B,) -> P (B, A, A)."""
    if not b.is_cuda:
        return _expm_fwd_plain(Q, b, order, squarings)
    A = Q.shape[-1]
    _check_cuda(Q, b, A, order)
    B = b.shape[0]
    out = torch.empty((B, A, A), dtype=b.dtype, device=b.device)
    if B:
        threads, blocks = expm_plan(B, A)
        fn = _ext.bind("expm_kernels", "launch_expm_fwd", 3, 6)
        _ext.LAUNCHES["expm_fwd"] += 1
        _ext.check(fn(Q.data_ptr(), b.data_ptr(), out.data_ptr(), B, A,
                      order, squarings, threads, blocks,
                      _ext.stream_ptr(b.device)), "expm_fwd")
    return out


def _ticket(device):
    """The backward's block counter on the current stream: an int32 the
    kernel's last block resets to 0, so launches on one stream share
    it.  A CUDA graph's capture takes the one its stream's warm-up made:
    one made during the capture would live in the graph's memory pool
    and outlive the graph."""
    key = (device, _ext.stream_ptr(device))
    if key not in _TICKETS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "expm_bwd captured on a stream it never ran on: warm the "
                "call up on the capturing stream first")
        _TICKETS[key] = torch.zeros((1,), dtype=torch.int32, device=device)
    return _TICKETS[key]


def expm_bwd(Q, b, P, gbar, order=12, squarings=12):
    """K4 backward wrapper: (Q_bar (A, A), b_bar (B,)) from Q, b (B,), the
    forward's P and the cotangent P_bar (B, A, A)."""
    if not b.is_cuda:
        return _expm_bwd_plain(Q, b, P, gbar, order, squarings)
    A = Q.shape[-1]
    _check_cuda(Q, b, A, order)
    B = b.shape[0]
    for t, what in ((P, "expm P"), (gbar, "expm gbar")):
        _ext.require(t, what, torch.float32, shape=(B, A, A))
    f = dict(dtype=torch.float32, device=b.device)
    qbar = torch.empty((A, A), **f)
    bbar = torch.empty((B,), **f)
    if not B:
        return qbar.zero_(), bbar
    threads, blocks = expm_plan(B, A, backward=True)
    part = torch.empty((blocks, A * A), **f)
    fn = _ext.bind("expm_kernels", "launch_expm_bwd", 8, 6)
    ticket = _ticket(b.device)
    _ext.LAUNCHES["expm_bwd"] += 1
    _ext.check(fn(Q.data_ptr(), b.data_ptr(), P.data_ptr(), gbar.data_ptr(),
                  part.data_ptr(), ticket.data_ptr(), qbar.data_ptr(),
                  bbar.data_ptr(), B, A, order, squarings, threads, blocks,
                  _ext.stream_ptr(b.device)), "expm_bwd")
    return qbar, bbar


def _check_cuda(Q, b, A, order):
    if A > MAX_A or A < 1:
        raise NotImplementedError(
            f"the CUDA expm kernel takes A <= {MAX_A} states, got {A} "
            "(models.expm.expm_ctmc sends wider generators to "
            "expm_poisson)")
    if not 1 <= order <= MAX_ORDER:
        raise NotImplementedError(
            f"the CUDA expm kernel takes 1 <= order <= {MAX_ORDER}, got "
            f"{order}")
    _ext.require(Q, "expm Q", torch.float32, shape=(A, A))
    _ext.require(b, "expm b", torch.float32, ndim=1)


class _ExpmCTMC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Q, b, order, squarings):
        flat = b.reshape(-1).contiguous()
        P = expm_fwd(Q, flat, order, squarings)
        ctx.save_for_backward(Q, flat, P)
        ctx.order, ctx.squarings = order, squarings
        return P.reshape(b.shape + Q.shape)

    @staticmethod
    def backward(ctx, gbar):
        Q, flat, P = ctx.saved_tensors
        A = Q.shape[-1]
        g = gbar.reshape(-1, A, A).contiguous()
        qbar, bbar = expm_bwd(Q, flat, P, g, ctx.order, ctx.squarings)
        return qbar, bbar.reshape(gbar.shape[:-2]), None, None


def expm_ctmc_kernel(Q, b, order=12, squarings=12):
    """expm(Q b) through K4 with its Frechet-adjoint gradient: Q (A, A)
    shared, b any batch shape -> (..., A, A).  CUDA tensors launch the
    kernels (float32, A <= 8); CPU tensors run the plain versions."""
    if Q.ndim != 2:
        raise NotImplementedError("expm_ctmc_kernel takes a shared (A, A) Q")
    return _ExpmCTMC.apply(Q, b, order, squarings)
