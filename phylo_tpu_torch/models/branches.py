"""Exponential branch-length variational family (port of
phylo_tpu/models/branches.py).

Per-rank proposal rates rate = exp(variable), variable initialized to
`branch_prior` (reference vcsmc.py:119-120; runner default log 10).
Sampling is reparameterized (b = standard_exp / rate) so pathwise
gradients reach the rates (vcsmc.py:353-356).
"""

from __future__ import annotations

import math

import torch


def init_branch_params(n_taxa, branch_prior=math.log(10.0),
                       dtype=torch.float32, device="cpu"):
    """Per-rank log-rates for left and right branches ((N-1,) each)."""
    n_ranks = n_taxa - 1
    return {
        "log_rates_l": torch.full((n_ranks,), branch_prior, dtype=dtype,
                                  device=device),
        "log_rates_r": torch.full((n_ranks,), branch_prior, dtype=dtype,
                                  device=device),
    }


def branch_rates(params):
    return torch.exp(params["log_rates_l"]), torch.exp(params["log_rates_r"])


def sample_branches(generator, rate, shape):
    """Reparameterized Exponential(rate) samples of `shape`, drawn from
    the explicit `generator` (on rate's device)."""
    eps = torch.empty(shape, dtype=rate.dtype, device=rate.device)
    eps.exponential_(generator=generator)
    return eps / rate


def exponential_logpdf(b, rate):
    """log Exponential(b; rate) = log(rate) - rate * b (elementwise)."""
    return torch.log(rate) - rate * b
