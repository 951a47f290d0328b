"""Closed-form combinatorial primitives (port of phylo_tpu/utils/math.py).

Reference counterparts: log double factorials (reference vcsmc.py:30-57)
and n-choose-2 (vcsmc.py:23-27), as closed forms instead of loops.
"""

from __future__ import annotations

import math

import torch


def log_double_factorial_odd(n):
    """log(n!!) for odd, positive ``n`` (elementwise, float64).

    For odd n = 2k - 1: log((2k-1)!!) = lgamma(2k+1) - k log 2 -
    lgamma(k+1).  Accepts a Python int or a tensor.
    """
    if not torch.is_tensor(n):
        k = (float(n) + 1.0) / 2.0
        return math.lgamma(2.0 * k + 1.0) - k * math.log(2.0) \
            - math.lgamma(k + 1.0)
    k = (n.to(torch.float64) + 1.0) / 2.0
    return (torch.lgamma(2.0 * k + 1.0) - k * math.log(2.0)
            - torch.lgamma(k + 1.0))


def topology_log_prior(leaf_counts):
    """Per-root topology log prior -log((2*max(c,2) - 3)!!) (float64);
    singleton roots are clamped to c=2 so their prior is 0 (reference
    vcsmc.py:199/227/243)."""
    c = torch.clamp(leaf_counts, min=2)
    return -log_double_factorial_odd(2 * c - 3)


def n_choose_2(n):
    """C(n, 2) as a float (reference `ncr(n, 2)`, vcsmc.py:23-27)."""
    n = float(n)
    return n * (n - 1.0) / 2.0


GAMMAINC_TERMS = 4096    # length of the incomplete-gamma series
GAMMAINC_TAIL = 1e-16    # a last term above this share: not converged


def _gammainc_terms(a, x):
    """log x and the series terms t_n = exp((a+n) log x - x -
    lgamma(a+n+1)), n < GAMMAINC_TERMS, of P(a, x) = sum_n t_n, formed in
    log space so nothing overflows.  The terms peak near n = x - a and
    spread over ~sqrt(x), so 4096 of them converge (to ~1e-11 relative or
    better) for x near a up to ~1e5: the discrete-Gamma boundaries up to
    alpha ~ 1e5."""
    n = torch.arange(GAMMAINC_TERMS, dtype=a.dtype, device=a.device)
    an = a[..., None] + n
    lx = torch.log(x)[..., None]
    return lx, an, torch.exp(an * lx - x[..., None] - torch.lgamma(an + 1.0))


class _GammaInc(torch.autograd.Function):
    """P(a, x) with gradients in both arguments, all from one series: the
    value is the sum of `_gammainc_terms`, d/da the series differentiated
    term by term, t_n (log x - digamma(a+n+1)), and d/dx the Gamma(a, 1)
    density (torch.special.gammainc has no derivative in a).  Where the
    series has not converged (its last term above GAMMAINC_TAIL of the
    sum: x far above a, or beyond ~1e5) the value is NaN, never a
    truncated sum."""

    @staticmethod
    def forward(ctx, a, x):
        ctx.save_for_backward(a, x)
        t = _gammainc_terms(a, x)[2]
        p = torch.sum(t, dim=-1)
        # all terms underflow where P ~ 0 (x far below a) and where the
        # terms peak past the series (x far above a)
        ok = (t[..., -1] <= GAMMAINC_TAIL * p) & ((p > 0) | (x < a))
        return torch.where(ok, p, torch.full_like(p, float("nan")))

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        ga = gx = None
        if ctx.needs_input_grad[0]:
            lx, an, t = _gammainc_terms(a, x)
            ga = g * torch.sum(t * (lx - torch.digamma(an + 1.0)), dim=-1)
        if ctx.needs_input_grad[1]:
            gx = g * torch.exp((a - 1.0) * torch.log(x) - x - torch.lgamma(a))
        return ga, gx


def gammainc(a, x):
    """Regularized lower incomplete gamma P(a, x), differentiable in a
    and x (the counterpart of jax.scipy.special.gammainc).  a and x are
    broadcast to one shape; a and x are positive, x within the series'
    reach (`_GammaInc`; NaN outside it)."""
    a, x = torch.broadcast_tensors(a, x)
    return _GammaInc.apply(a, x)
