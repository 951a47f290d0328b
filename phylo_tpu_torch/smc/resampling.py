"""Particle resampling strategies (port of phylo_tpu/smc/resampling.py).

Multinomial is the reference's scheme (tf.random.categorical over the
log-weights, vcsmc.py:279-289); it draws through kernel K5
(smc.resample_kernel.categorical: an inverse CDF in exact integer
arithmetic over counter-based Philox bits), at any K.  Systematic and
stratified invert the weight CDF.
"""

from __future__ import annotations

import torch

from phylo_tpu_torch.smc.resample_kernel import categorical, draw_seed

STRATEGIES = ("multinomial", "systematic", "stratified", "none")


def resample_indices(generator, log_weights, strategy="multinomial"):
    """Ancestor indices (K,) int64 for per-particle log weights; the
    randomness comes from `generator` (on log_weights' device)."""
    K = log_weights.shape[0]
    dev = log_weights.device
    if strategy == "none":
        return torch.arange(K, device=dev)
    if strategy == "multinomial":
        log_norm = log_weights - torch.logsumexp(log_weights, dim=0)
        seed = draw_seed(generator, dev)
        return categorical(log_norm.to(torch.float32), seed).long()
    log_norm = log_weights - torch.max(log_weights)
    cdf = torch.cumsum(torch.exp(log_norm), dim=0)
    cdf = cdf / cdf[-1]
    ar = torch.arange(K, dtype=cdf.dtype, device=dev)
    if strategy == "systematic":
        u0 = torch.rand((), generator=generator, dtype=cdf.dtype, device=dev)
        u = (u0 + ar) / K
    elif strategy == "stratified":
        u0 = torch.rand((K,), generator=generator, dtype=cdf.dtype,
                        device=dev)
        u = (u0 + ar) / K
    else:
        raise ValueError(f"unknown resampling strategy {strategy!r}")
    idx = torch.searchsorted(cdf, u, right=True)
    # a stratum's uniform can round up to exactly 1.0: clamp to the top
    # particle rather than return an out-of-range index
    return torch.clamp(idx, max=K - 1)
