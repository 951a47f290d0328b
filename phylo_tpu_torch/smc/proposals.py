"""Topology proposals over the compacted root positions (port of
phylo_tpu/smc/proposals.py).

At rank r the n = N - r active roots sit in positions 0..n-1; the
uniform proposal draws an unordered pair without replacement by the
Gumbel-top-2 trick (reference vcsmc.py:291-316), masked to the active
prefix.
"""

from __future__ import annotations

import torch


def uniform_pair(generator, K, N, n_active, dtype=torch.float32,
                 device="cpu"):
    """(p1, p2) position pairs, each (K,) int64, uniform without
    replacement among positions < n_active, independently per particle;
    p1 is the arg-max Gumbel (the reference's `particle1`)."""
    u = torch.rand((K, N), generator=generator, dtype=dtype, device=device)
    z = -torch.log(-torch.log(u))
    pos = torch.arange(N, device=device)
    z = torch.where(pos[None, :] < n_active, z,
                    torch.full_like(z, float("-inf")))
    idx = torch.topk(z, 2, dim=1).indices
    return idx[:, 0], idx[:, 1]
