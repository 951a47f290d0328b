"""Felsenstein nonparametric bootstrap over sites, driven by the SMC
sweep (port of phylo_tpu/smc/bootstrap.py).

Classic phylogenetic uncertainty quantification the reference does not
have (its runner only trains on the full alignment; reference
runner.py:151-176): resample the S alignment columns with replacement,
re-infer on each pseudo-replicate, and report how often each clade
recurs.  A site resample costs nothing at the sweep level: multinomial
column counts ARE per-site weights, so every replicate runs the same
sweep (the rank kernel K1, K5's resampling draws and K4 on the card)
with a different `site_weights` vector.

Support estimator: within each replicate the final particle cloud is a
weighted posterior sample, so a clade's replicate support is its
normalized particle mass, and the bootstrap support is the mean over
replicates:

    support(c) = (1/B) sum_r sum_k w_rk * [c in tree_rk]

``map_tree=True`` counts only each replicate's highest-weight particle
(the classic one-tree-per-replicate bootstrap).

The column counts come from ``numpy.random.default_rng(seed)`` and the
sweeps from one ``torch.Generator`` on the leaves' device seeded with
`seed`; the draws differ from the JAX package's (which derives both from
a PRNG key), the estimator does not.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class BootstrapResult:
    supports: dict          # {frozenset(taxa): support in [0, 1]}
    consensus: str          # majority-rule consensus Newick (supports
                            # as internal-node labels)
    elbos: np.ndarray       # (B,) per-replicate ELBO estimates
    counts: np.ndarray      # (B, S) resampled column counts


def replicate_supports(taxa, ancestors, merged_nodes, log_w, *,
                       map_tree=False):
    """{clade: mass} of one replicate's final particle cloud: each
    particle's normalized weight (or 1 for the highest-weight particle
    alone under `map_tree`) added to every clade of its decoded tree."""
    from phylo_tpu_torch.viz.trees import _clade_sets, decode_genealogy

    genealogy = decode_genealogy(ancestors, merged_nodes)
    log_w = np.asarray(log_w, np.float64)
    if map_tree:
        w = np.zeros_like(log_w)
        w[int(log_w.argmax())] = 1.0
    else:
        w = np.exp(log_w - log_w.max())
        w = w / w.sum()
    support = {}
    for k, rec in enumerate(genealogy):
        if w[k] == 0.0:
            continue
        for clade, _ in set(_clade_sets(taxa, rec)):
            support[clade] = support.get(clade, 0.0) + w[k]
    return support


def bootstrap_supports(seed, leaves, model, params, config, *,
                       n_replicates=20, taxa=None, threshold=0.5,
                       map_tree=False, base_weights=None):
    """Bootstrap clade supports for SMC phylogenetic inference.

    seed: int seeding the column resampling and the sweeps' generator.
    leaves/model/params/config: as `sample_phylogenies` (the sweeps run
        on the leaves' device, without gradients).
    n_replicates: number of bootstrap pseudo-replicates B.
    taxa: leaf names (defaults to S0..S{N-1}).
    threshold: majority-rule consensus threshold in [0.5, 1).
    map_tree: count only the highest-weight particle per replicate
        instead of the weighted particle cloud.
    base_weights: optional (S,) nonnegative weights biasing the column
        resampling (default uniform); counts are drawn from
        Multinomial(S, base_weights / sum).

    Returns a BootstrapResult.
    """
    from phylo_tpu_torch.smc.sweep import sample_phylogenies
    from phylo_tpu_torch.viz.trees import consensus_from_supports

    N, S = leaves.shape[0], leaves.shape[1]
    if taxa is None:
        taxa = [f"S{i}" for i in range(N)]
    if len(taxa) != N:
        raise ValueError(f"{len(taxa)} taxa for {N} leaves")

    p = (np.full((S,), 1.0 / S) if base_weights is None
         else np.asarray(base_weights, np.float64))
    p = p / p.sum()
    # host-side multinomial (data prep, off the hot path)
    counts = np.random.default_rng(seed).multinomial(S, p,
                                                     size=n_replicates)
    gen = torch.Generator(device=leaves.device)
    gen.manual_seed(seed)

    support = {}
    elbos = np.zeros((n_replicates,))
    for r in range(n_replicates):
        sw = torch.as_tensor(counts[r], device=leaves.device).to(leaves.dtype)
        with torch.no_grad():
            res = sample_phylogenies(gen, leaves, model, params, config,
                                     site_weights=sw)
        elbos[r] = float(res.elbo)
        rep = replicate_supports(
            taxa, res.ancestors.cpu().numpy(), res.merged_nodes.cpu().numpy(),
            res.log_weights[-1].cpu().numpy(), map_tree=map_tree)
        for clade, s in rep.items():
            support[clade] = support.get(clade, 0.0) + s

    support = {c: s / n_replicates for c, s in support.items()}
    newick, _ = consensus_from_supports(taxa, support, threshold=threshold)
    return BootstrapResult(supports=support, consensus=newick,
                           elbos=elbos, counts=counts)
