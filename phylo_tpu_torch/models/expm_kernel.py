"""Kernel K4: the uniformized-expm chain and its Frechet-adjoint backward
(port of phylo_tpu/models/expm_kernel.py).

Forward: P = e^{-mu b_eff} (I + D), D from the delta-form chain of
models.expm (order-12 Horner on the delta, then 12 squarings
D <- 2D + D D).  Backward: the cotangents of the TRUE matrix exponential
via the Frechet-adjoint identity L*(M, W) = L(M^T, W),

    b_bar = <P_bar, Q P>                       (zero past the clamp)
    Q_bar = sum_i b_eff_i e^{-mu b_eff_i} L_i,

with L_i the top-right block of the same delta chain run on the implicit
block matrix [[x R^T, P_bar_i / 2^s], [0, x R^T]] carried as a (T, F)
pair.  The kernel writes the per-element field w_i L_i; a torch.sum over
the batch reduces it, and b_bar stays outside the kernel, as in the JAX
package.  In the clamp region (b > 80/mu) the Q_bar term through
d(b_eff)/dQ is dropped, as the TPU kernel does.

CUDA tensors launch csrc/expm_kernels.cu (one thread per batch element,
the whole chain in registers); CPU tensors run `_expm_fwd_plain` /
`_expm_bwd_plain`, the same arithmetic in torch.
"""

from __future__ import annotations

import torch

from phylo_tpu_torch import _ext
from phylo_tpu_torch.models.expm import (
    CLAMP, _matmul, delta_chain, uniformize,
)

MAX_A = 8


# plain version of the forward kernel: the delta chain of models.expm
_expm_fwd_plain = delta_chain


def _expm_bwd_plain(R, mu, b, gbar, order=12, squarings=12):
    """Plain version of the backward kernel: the per-element weighted
    Frechet field w_i L((x_i R)^T, gbar_i), (B, A, A)."""
    A = R.shape[-1]
    eye = torch.eye(A, dtype=R.dtype, device=R.device)
    b_eff = torch.minimum(b, CLAMP / mu)
    x = (mu * b_eff) / (2.0 ** squarings)
    xT = x[:, None, None] * R.T
    E = gbar * (1.0 / (2.0 ** squarings))
    ST = xT / order
    SF = E / order
    for j in range(order - 1, 0, -1):
        xTj = xT / j
        Ej = E / j
        IT = eye + ST
        SF = _matmul(xTj, SF) + _matmul(Ej, IT)
        ST = _matmul(xTj, IT)
    DT, DF = ST, SF
    for _ in range(squarings):
        TT = _matmul(DT, DT)
        TF = _matmul(DT, DF)
        FT = _matmul(DF, DT)
        DF = 2.0 * DF + TF + FT
        DT = 2.0 * DT + TT
    w = b_eff * torch.exp(-mu * b_eff)
    return w[:, None, None] * DF


def _scalars(R, mu):
    """The kernel's small parameter array [R (A*A), mu] on R's device."""
    return torch.cat([R.reshape(-1), mu.reshape(1)]).contiguous()


def expm_fwd(R, mu, b, order=12, squarings=12):
    """K4 forward wrapper: b (B,) -> P (B, A, A)."""
    if not b.is_cuda:
        return _expm_fwd_plain(R, mu, b, order, squarings)
    A = R.shape[-1]
    _check_cuda(R, b, A)
    B = b.shape[0]
    out = torch.empty((B, A, A), dtype=b.dtype, device=b.device)
    if B:
        fn = _ext.bind("expm_kernels", "launch_expm_fwd", 3, 4)
        _ext.LAUNCHES["expm_fwd"] += 1
        _ext.check(fn(_scalars(R, mu).data_ptr(), b.data_ptr(),
                      out.data_ptr(), B, A, order, squarings,
                      _ext.stream_ptr(b.device)), "expm_fwd")
    return out


def expm_bwd(R, mu, b, gbar, order=12, squarings=12):
    """K4 backward wrapper: the weighted Frechet field (B, A, A)."""
    if not b.is_cuda:
        return _expm_bwd_plain(R, mu, b, gbar, order, squarings)
    A = R.shape[-1]
    _check_cuda(R, b, A)
    B = b.shape[0]
    gbar = _ext.require(gbar.contiguous(), "expm gbar", torch.float32,
                        shape=(B, A, A))
    out = torch.empty((B, A, A), dtype=b.dtype, device=b.device)
    if B:
        fn = _ext.bind("expm_kernels", "launch_expm_bwd", 4, 4)
        _ext.LAUNCHES["expm_bwd"] += 1
        _ext.check(fn(_scalars(R, mu).data_ptr(), b.data_ptr(),
                      gbar.data_ptr(), out.data_ptr(), B, A, order,
                      squarings, _ext.stream_ptr(b.device)), "expm_bwd")
    return out


def _check_cuda(R, b, A):
    if A > MAX_A or A < 1:
        raise NotImplementedError(
            f"the CUDA expm kernel takes A <= {MAX_A} states, got {A} "
            "(models.expm.expm_ctmc sends wider generators to "
            "expm_poisson)")
    _ext.require(R, "expm R", torch.float32)
    _ext.require(b, "expm b", torch.float32, ndim=1)


class _ExpmCTMC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Q, b, order, squarings):
        mu, R = uniformize(Q)
        flat = b.reshape(-1).contiguous()
        P = expm_fwd(R, mu, flat, order, squarings)
        ctx.save_for_backward(Q, b, P)
        ctx.order, ctx.squarings = order, squarings
        return P.reshape(b.shape + Q.shape)

    @staticmethod
    def backward(ctx, gbar):
        Q, b, P = ctx.saved_tensors
        A = Q.shape[-1]
        mu, R = uniformize(Q)
        flat = b.reshape(-1)
        g = gbar.reshape(-1, A, A).contiguous()
        # b_bar = <P_bar, Q P>, zero past the clamp (d b_eff / d b = 0)
        QP = torch.sum(Q[:, :, None] * P[:, None, :, :], dim=-2)
        bbar = torch.sum(g * QP, dim=(-2, -1))
        bbar = torch.where(flat <= CLAMP / mu, bbar, torch.zeros_like(bbar))
        qbar = torch.sum(
            expm_bwd(R, mu, flat.contiguous(), g, ctx.order, ctx.squarings),
            dim=0)
        return qbar, bbar.reshape(b.shape), None, None


def expm_ctmc_kernel(Q, b, order=12, squarings=12):
    """expm(Q b) through K4 with its Frechet-adjoint gradient: Q (A, A)
    shared, b any batch shape -> (..., A, A).  CUDA tensors launch the
    kernels (float32, A <= 8); CPU tensors run the plain versions."""
    if Q.ndim != 2:
        raise NotImplementedError("expm_ctmc_kernel takes a shared (A, A) Q")
    return _ExpmCTMC.apply(Q, b, order, squarings)
