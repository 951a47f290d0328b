"""Forest-level prior/correction terms (port of
phylo_tpu/pruning/posterior.py) on per-position leaf counts with an
active-root mask (reference vcsmc.py:243,247-252)."""

from __future__ import annotations

import torch

from phylo_tpu_torch.utils.math import topology_log_prior


def forest_log_prior(leaf_counts, active_mask):
    """Sum of per-root topology log-priors over active roots (float64)."""
    per_root = topology_log_prior(leaf_counts)
    return torch.sum(torch.where(active_mask, per_root,
                                 torch.zeros_like(per_root)), dim=-1)


def overcounting_correction(leaf_counts, active_mask):
    """v_minus = sum over active roots of (c - 1{c == 1}) (Wang et al.'s
    jump-chain overcounting correction, reference vcsmc.py:247-252)."""
    term = leaf_counts - (leaf_counts == 1).to(leaf_counts.dtype)
    return torch.sum(torch.where(active_mask, term,
                                 torch.zeros_like(term)), dim=-1)
