"""The symmetric eigendecomposition of the spectral transitions
(models.expm.expm_reversible) as a kernel a CUDA graph can hold.

The JAX package calls jnp.linalg.eigh (phylo_tpu/models/expm.py:308),
which XLA runs on the device with no host round trip; it is not a Pallas
kernel.  torch.linalg.eigh on a CUDA tensor checks its solver's status on
the host (a synchronisation), so a step that calls it cannot be captured.
On a CUDA tensor `eigh` launches csrc/eigh_kernels.cu instead: the
parallel-ordered cyclic Jacobi method in float64, one thread block a
matrix, run to convergence inside the kernel, at most MAX_SWEEPS sweeps:
a matrix that has not converged by then comes back NaN (w and U), so it
shows on the device, in the transitions and the ELBO, with no host
read.  On a CPU tensor it runs torch.linalg.eigh, the plain version and
the oracle.

The gradient is a torch.autograd.Function whose backward is eigh's
standard formula in torch ops (they capture):

    S_bar = U (diag(w_bar) + F o (X - X^T) / 2) U^T,   X = U^T U_bar,
    F_ij = 1 / (w_j - w_i) for w_i != w_j, else 0,

torch.linalg.eigh's own (symmetric, as S is) for a spectrum without
ties.  Where two
eigenvalues are equal, torch's divides by zero (an infinite F_ij); here
F_ij is 0, so a cotangent that is exactly zero (the branch
`expm_reversible` does not take) gives an exactly zero S_bar, never
0 * inf = NaN.
"""

from __future__ import annotations

import torch

from phylo_tpu_torch import _ext

MAX_A = 64
# Jacobi sweeps before a matrix counts as not converged (GY94's 61
# states take 9-10 on an H100; PERF.md)
MAX_SWEEPS = 40


def eigh_fwd(S, max_sweeps=MAX_SWEEPS):
    """(w, U, sweeps): S (..., A, A) symmetric float64 on the card ->
    eigenvalues ascending (..., A), eigenvectors as columns (..., A, A)
    and the Jacobi sweeps each matrix took (...,) int32, from one launch
    of the kernel; a matrix still rotating after `max_sweeps` sweeps
    gives NaN in its w and U.  A CPU tensor runs torch.linalg.eigh
    (sweeps None)."""
    if not S.is_cuda:
        w, U = torch.linalg.eigh(S)
        return w, U, None
    A = S.shape[-1]
    if S.ndim < 2 or S.shape[-2] != A or not 1 <= A <= MAX_A:
        raise NotImplementedError(
            f"the CUDA eigh kernel takes (..., A, A) with 1 <= A <= "
            f"{MAX_A}, got {tuple(S.shape)}")
    batch = S.shape[:-2]
    flat = _ext.require(S.reshape(-1, A, A).contiguous(), "eigh S",
                        torch.float64, ndim=3)
    B = flat.shape[0]
    f = dict(dtype=torch.float64, device=S.device)
    w = torch.empty((B, A), **f)
    U = torch.empty((B, A, A), **f)
    sweeps = torch.empty((B,), dtype=torch.int32, device=S.device)
    if B:
        fn = _ext.bind("eigh_kernels", "launch_eigh_jacobi", 4, 3)
        _ext.LAUNCHES["eigh_jacobi"] += 1
        _ext.check(fn(flat.data_ptr(), w.data_ptr(), U.data_ptr(),
                      sweeps.data_ptr(), B, A, max_sweeps,
                      _ext.stream_ptr(S.device)), "eigh_jacobi")
    return (w.reshape(*batch, A), U.reshape(*batch, A, A),
            sweeps.reshape(batch))


def eigh_bwd(w, U, gw, gU):
    """S_bar of eigh's standard formula (symmetric), with F_ij = 0 where
    w_i == w_j; gw or gU None counts as zero."""
    inner = torch.zeros_like(U)
    if gU is not None:
        E = w[..., None, :] - w[..., :, None]             # w_j - w_i
        tie = E == 0
        F = torch.where(tie, torch.zeros_like(E),
                        1.0 / torch.where(tie, torch.ones_like(E), E))
        X = U.transpose(-2, -1) @ gU
        inner = F * ((X - X.transpose(-2, -1)) / 2)
    if gw is not None:
        inner = inner + torch.diag_embed(gw)
    return U @ inner @ U.transpose(-2, -1)


class _Eigh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, S):
        w, U, _ = eigh_fwd(S)
        ctx.save_for_backward(w, U)
        return w, U

    @staticmethod
    def backward(ctx, gw, gU):
        w, U = ctx.saved_tensors
        return eigh_bwd(w, U, gw, gU)


def eigh(S):
    """(w, U) of the symmetric S (..., A, A), differentiable: the Jacobi
    kernel on a CUDA tensor (float64, A <= 64), torch.linalg.eigh on a
    CPU tensor; the backward is `eigh_bwd` either way."""
    return _Eigh.apply(S)
