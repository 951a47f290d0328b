"""Batched matrix exponentials of CTMC rate matrices (port of
phylo_tpu/models/expm.py: the JC69 closed form, the uniformized
delta-form chain, the Poisson power table `expm_poisson` and the
spectral `expm_reversible`).

Uniformization: Q = mu (R - I) with mu >= max_i |Q_ii| and R >= 0, so
expm(Q b) = exp(-mu b) expm(mu b R); with static scaling-and-squaring
(x = mu b / 2^s) the whole computation is a fixed chain of A x A
products.  The chain tracks D = expm(x R) - I and squares it as
D <- 2 D + D D (delta form), which keeps increments of order mu b / 2^s
(often 1e-7) from being absorbed by the unit diagonal in float32.

On a CUDA tensor `expm_ctmc` runs the hand-written kernel
(models.expm_kernel, forward chain + Frechet-adjoint backward) for
A <= 8 states and `expm_poisson` above; on the CPU it runs the chain
below, differentiated by autograd -- the same split the JAX package
makes between its Pallas kernel, its Poisson table and its jnp chain.

The wide-alphabet products (A > 8: the chain's matmuls, the Poisson
table, the spectral reconstruction) are batched `torch.matmul` calls,
as the JAX package leaves them to XLA; on the card they run in full
float32 (`exact_matmul` refuses TF32).
"""

from __future__ import annotations

import math

import numpy as np
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


def exact_matmul(a, b):
    """torch.matmul that refuses TF32 on the card: the A x A
    contractions feed log-likelihood sums over thousands of sites and
    must be exact float32 (ROADMAP numerics rules)."""
    if a.is_cuda and a.dtype == torch.float32 and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "float32 products must be exact: keep torch.backends.cuda."
            "matmul.allow_tf32 False and the float32 matmul precision "
            "'highest'")
    return torch.matmul(a, b)


def _matmul(a, b):
    """Batched A x A product: explicit multiply-add over the middle index
    for A <= 8 (exact in the working precision), `exact_matmul` for wide
    alphabets, whose broadcast form would hold an (..., A, A, A)
    intermediate (the JAX package switches at the same width)."""
    if a.shape[-1] > 8:
        return exact_matmul(a, b)
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
    Differentiable by autograd.  Kernel K4's plain forward
    (models.expm_kernel._expm_fwd_plain) is the same chain with the
    kernel's association."""
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
    b of any batch shape.

    CUDA tensors with A <= 8 go through the hand-written kernel
    (models.expm_kernel.expm_ctmc_kernel; float32, any batch), wider
    ones through `expm_poisson` (the JAX package's rule on its
    accelerator, expm.py:141-150: a static choice on A); CPU tensors
    through the delta-form chain `expm_chain`."""
    dtype = torch.promote_types(Q.dtype, b.dtype)
    Q = Q.to(dtype).contiguous()      # GTR/HKY pass Q^T, a strided view
    b = b.to(dtype)
    if b.is_cuda:
        if Q.shape[-1] > 8:
            return expm_poisson(Q, b)
        from phylo_tpu_torch.models.expm_kernel import expm_ctmc_kernel

        return expm_ctmc_kernel(Q, b, order, squarings)
    return expm_chain(Q, b, order=order, squarings=squarings)


def _stirling_residuals(n_max):
    """c_n = lgamma(n+1) - (n ln n - n + 0.5 ln(2 pi n)), n = 1..n_max,
    as float64 host constants (~1/(12n), tiny)."""
    n = np.arange(1, n_max + 1, dtype=np.float64)
    lg = np.array([math.lgamma(v + 1.0) for v in n])
    return lg - (n * np.log(n) - n + 0.5 * np.log(2.0 * np.pi * n))


def expm_poisson(Q, b, *, n_max=160, clamp=80.0):
    """expm(Q * b) for a SHARED rate matrix Q (A, A) and batched b by the
    Poisson-weighted power table

        expm(Q b) = sum_n  pois(n; mu b) R^n,   R = Q/mu + I:

    the n_max+1 powers of R once (batch-free), then every batched
    transition is one (B, n_max+1) @ (n_max+1, A^2) product.  The
    weights are taken in log space with the Stirling-residual
    rearrangement

        log w_n = n (log1p(d_n) - d_n) - 0.5 log(2 pi n) - c_n,
        d_n = (t - n)/n,

    stable in float32 up to the clamp mu b <= 80 (b beyond it gets no
    gradient); log1p only where |d| < 0.5, through a double `where` so
    both branches' gradients stay finite; mu b < 1e-6 takes the first
    order branch I + b Q.  All terms are nonnegative, so P is.  n_max=160
    puts the Poisson tail at t = 80 below 1e-13."""
    dtype = torch.promote_types(Q.dtype, b.dtype)
    Q = Q.to(dtype)
    b = b.to(dtype)
    A = Q.shape[-1]
    f = dict(dtype=dtype, device=Q.device)
    mu = torch.clamp(torch.max(-torch.diagonal(Q)), min=1e-30)
    eye = torch.eye(A, **f)
    R = Q / mu + eye
    pows = [eye]
    for _ in range(n_max):
        pows.append(_matmul(pows[-1], R))
    table = torch.stack(pows).reshape(n_max + 1, A * A)

    t = mu * torch.minimum(b, clamp / mu)              # (...,)
    t_safe = torch.maximum(t, torch.full_like(t, 1e-6))[..., None]
    n = torch.arange(1, n_max + 1, **f)
    c_n = torch.tensor(_stirling_residuals(n_max), **f)
    d = (t_safe - n) / n
    small = torch.abs(d) < 0.5
    d_safe = torch.where(small, d, torch.zeros_like(d))
    log_ratio = torch.where(small, torch.log1p(d_safe),
                            torch.log(t_safe / n))
    log_w = n * (log_ratio - d) - 0.5 * torch.log(2.0 * math.pi * n) - c_n
    log_w = torch.cat([-t_safe, log_w], dim=-1)       # the n = 0 column
    w = torch.exp(log_w)                               # (..., n_max+1)
    P = exact_matmul(w, table).reshape(b.shape + (A, A))
    lin = eye + b[..., None, None] * Q
    return torch.where((t < 1e-6)[..., None, None], lin, P)


def expm_reversible(Q, pi, b, *, clip=True, chain_fallback=True,
                    gap_tol=1e-5):
    """expm(Q^T b) -- the MERGE orientation, as GTR.transition -- for a
    REVERSIBLE generator Q (pi_i Q_ij = pi_j Q_ji) by the spectral method:
    S = diag(d) Q diag(1/d), d = sqrt(pi), is symmetric, so with
    (w, U) = eigh(S)

        expm(Q b)^T = diag(d) U diag(e^{w b}) U^T diag(1/d):

    one A x A eigendecomposition per call, then one batched matmul.

    Gradients flow through eigh's backward, whose eigenvector terms
    divide by eigenvalue gaps.  chain_fallback=True routes a collapsed
    spectrum (min gap < gap_tol * max|w|) through `expm_ctmc(Q.T, b)`
    instead.  The JAX package decides with a lax.cond on a second
    eigvalsh; here the gap, a predicate that is never differentiated,
    comes from the same eigh's eigenvalues, detached, and the branch is
    taken on the host: ONE host synchronisation per call.

    clip=True zeroes the tiny negative entries the reconstruction can
    produce (exact expm is nonnegative), by torch.maximum(PT, 0), whose
    gradient splits exact zeros in half as jnp.maximum's does.  Returns
    b.shape + (A, A) in the inputs' promoted dtype.

    The decomposition and the reconstruction run in float64 whatever the
    working dtype (the JAX package computes them in it).  The
    reconstruction sums O(1) terms d_i U_ik e^{w_k b} U_jk / d_j into
    entries as small as 3e-11 (codons two or three changes apart); from
    a float32 eigh they come out up to 1.2e-5 off, 42% of GY94's entries
    by more than 1% (an H100; chip_smoke.py phase 3 prints it)."""
    dtype = torch.promote_types(Q.dtype, b.dtype)
    work = torch.promote_types(dtype, torch.float64)
    if work != dtype:
        return expm_reversible(Q.to(work), pi.to(work), b.to(work),
                               clip=clip, chain_fallback=chain_fallback,
                               gap_tol=gap_tol).to(dtype)
    Q = Q.to(dtype)
    b = b.to(dtype)
    pi = pi.to(dtype)
    d = torch.sqrt(torch.clamp(pi, min=1e-30))
    S = Q * (d[:, None] / d[None, :])
    S = (S + S.T) / 2          # exact symmetry for eigh
    w, U = torch.linalg.eigh(S)
    if chain_fallback:
        wd = w.detach()
        scale = torch.clamp(torch.max(torch.abs(wd)), min=1e-30)
        gap = torch.min(torch.diff(wd)) / scale
        if float(gap) < gap_tol:
            return expm_ctmc(Q.T, b)
    E = torch.exp(w * b[..., None])                    # (..., A)
    left = (U * d[:, None]) * E[..., None, :]          # (..., A, A)
    right = (U / d[:, None]).T
    PT = exact_matmul(left, right)
    if clip:
        PT = torch.maximum(PT, torch.zeros_like(PT))
    return PT
