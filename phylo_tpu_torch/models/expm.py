"""Batched matrix exponentials of CTMC rate matrices (port of
phylo_tpu/models/expm.py, the JC69 closed form and the uniformized
delta-form chain).

Uniformization: Q = mu (R - I) with mu >= max_i |Q_ii| and R >= 0, so
expm(Q b) = exp(-mu b) expm(mu b R); with static scaling-and-squaring
(x = mu b / 2^s) the whole computation is a fixed chain of A x A
products.  The chain tracks D = expm(x R) - I and squares it as
D <- 2 D + D D (delta form), which keeps increments of order mu b / 2^s
(often 1e-7) from being absorbed by the unit diagonal in float32.

On a CUDA tensor `expm_ctmc` runs the hand-written kernel
(models.expm_kernel, forward chain + Frechet-adjoint backward); on the
CPU it runs the chain below, differentiated by autograd -- the same
split the JAX package makes between its Pallas kernel and its jnp chain.
"""

from __future__ import annotations

import torch

CLAMP = 80.0     # mu * b is clamped here: P is the stationary projector


def jc69_transition(b, A=4):
    """Closed-form JC69 transitions P(b) = e^{-b} I + (1 - e^{-b}) J / A
    for the reference generator Q = J/A - I (vcsmc.py:126-129).
    b: (...,) -> (..., A, A)."""
    eb = torch.exp(-b)[..., None, None]
    eye = torch.eye(A, dtype=b.dtype, device=b.device)
    ones = torch.full((A, A), 1.0 / A, dtype=b.dtype, device=b.device)
    return eb * eye + (1.0 - eb) * ones


def _matmul(a, b):
    """Batched A x A product as explicit multiply-add over the middle
    index (exact in the working precision; no TF32 path)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def uniformize(Q):
    """(mu, R): mu = max(-diag Q) (floored at 1e-30), R = Q / mu + I."""
    A = Q.shape[-1]
    mu = torch.clamp(torch.max(-torch.diagonal(Q, dim1=-2, dim2=-1)),
                     min=1e-30)
    R = Q / mu + torch.eye(A, dtype=Q.dtype, device=Q.device)
    return mu, R


def delta_chain(R, mu, b, order=12, squarings=12):
    """The delta-form chain for a uniformized generator (R, mu):
    b_eff = min(b, 80 / mu), x = mu b_eff / 2^s, order-`order` Horner
    on the delta, `squarings` squarings D <- 2D + D D, and
    P = e^{-mu b_eff} (I + D).  b: any batch shape -> (..., A, A).
    Differentiable by autograd; also the plain version of kernel K4's
    forward (models.expm_kernel)."""
    A = R.shape[-1]
    eye = torch.eye(A, dtype=R.dtype, device=R.device)
    b_eff = torch.minimum(b, CLAMP / mu)
    x = (mu * b_eff) / (2.0 ** squarings)
    xR = x[..., None, None] * R
    S = xR / order
    for j in range(order - 1, 0, -1):
        S = _matmul(xR / j, eye + S)
    D = S
    for _ in range(squarings):
        D = 2.0 * D + _matmul(D, D)
    return torch.exp(-mu * b_eff)[..., None, None] * (eye + D)


def expm_chain(Q, b, order=12, squarings=12):
    """expm(Q b) by the plain delta-form chain (autograd-differentiable
    in Q and b).  Q: (A, A); b: any batch shape."""
    mu, R = uniformize(Q)
    return delta_chain(R, mu, b, order, squarings)


def expm_ctmc(Q, b, *, order=12, squarings=12):
    """expm(Q * b) for a shared rate matrix Q (A, A) and branch lengths
    b of any batch shape, by the uniformized delta-form chain.

    CUDA tensors go through the hand-written kernel
    (models.expm_kernel.expm_ctmc_kernel; float32, A <= 8, any batch);
    CPU tensors through `expm_chain`."""
    dtype = torch.promote_types(Q.dtype, b.dtype)
    Q = Q.to(dtype).contiguous()      # GTR/HKY pass Q^T, a strided view
    b = b.to(dtype)
    if b.is_cuda:
        from phylo_tpu_torch.models.expm_kernel import expm_ctmc_kernel

        return expm_ctmc_kernel(Q, b, order, squarings)
    return expm_chain(Q, b, order=order, squarings=squarings)
