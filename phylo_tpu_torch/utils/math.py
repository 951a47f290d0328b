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
