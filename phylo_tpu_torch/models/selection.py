"""Substitution-model selection by information criteria (the
ModelFinder / jModelTest role: IQ-TREE -m MFP, Kalyaanamoorthy et al.
2017); port of phylo_tpu/models/selection.py.

The reference trains one hand-picked parameterization per run
(vcsmc.py:119-148); choosing among model families is left to the user.
This module scores a candidate list of model specs (the `get_model`
spec-string grammar: ``jc69``, ``hky+g4``, ``gtr+g4+i``, ``lg.dat+f``,
…) on a fixed topology — supplied, or built here by neighbor-joining on
JC-corrected distances — with a joint ML fit of model parameters and
branch lengths per candidate (pruning.fixed_tree.optimize_tree), and
ranks them by AIC / AICc / BIC:

    fits = select_model(ds.genome, taxa=ds.taxa)
    best = fits[0]            # ModelFit(spec='gtr+g4', ...)

Parameter counts follow the standard conventions (see
`n_free_parameters`); the branch-length count is the 2(N-1) lengths the
rooted fit actually optimizes (classical unrooted counts use 2N-3; the
difference is a constant across candidates, so rankings are
unaffected).  The sample size for AICc/BIC is the number of alignment
sites (the common, if imperfect, convention).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "DNA_CANDIDATES",
    "ModelFit",
    "n_free_parameters",
    "select_model",
]

# the jModelTest-style DNA ladder: three base families x rate
# heterogeneity.  ReferenceQ is deliberately absent (not a standard
# generative family; its likelihood is not comparable across tools) --
# pass candidates=[...] to include it or protein .dat specs.
DNA_CANDIDATES = (
    "jc69", "hky", "gtr",
    "jc69+g4", "hky+g4", "gtr+g4",
    "jc69+i", "hky+i", "gtr+i",
    "jc69+g4+i", "hky+g4+i", "gtr+g4+i",
)


def n_free_parameters(model):
    """Canonical free-parameter count of a substitution model object.

    JC69 0; HKY 1+(A-1); GTR (A(A-1)/2 - 1)+(A-1) (one exchangeability
    is absorbed by the unit-rate normalization; 8 for DNA); ReferenceQ
    A(A-2) off-diagonal (A rows row-normalized) + (A-1) stationary;
    EmpiricalProtein 0 (+F: A-1); FixedQ 0.  Mixtures add their own:
    +gN adds 1 (alpha), +i adds 1 (p_inv), +rN adds 2N-2 (N-1 weights,
    N rates minus the unit-mean constraint).
    """
    from phylo_tpu_torch.models.empirical import EmpiricalProtein
    from phylo_tpu_torch.models.substitution import (
        GTR,
        HKY,
        JC69,
        FixedQ,
        FreeRates,
        GammaSites,
        ReferenceQ,
    )

    if isinstance(model, GammaSites):
        extra = (1 if model.G > 1 else 0) + (1 if model.invariant else 0)
        return n_free_parameters(model.base) + extra
    if isinstance(model, FreeRates):
        return n_free_parameters(model.base) + 2 * model.G - 2
    if isinstance(model, JC69) or isinstance(model, FixedQ):
        return 0
    if isinstance(model, HKY):
        return 1 + (model.A - 1)
    if isinstance(model, GTR):
        return (model.A * (model.A - 1) // 2 - 1) + (model.A - 1)
    if isinstance(model, ReferenceQ):
        return model.A * (model.A - 2) + (model.A - 1)
    if isinstance(model, EmpiricalProtein):
        return (model.A - 1) if model.plus_f else 0
    raise TypeError(
        f"no parameter-count rule for {type(model).__name__}; pass a "
        "standard model or count its parameters yourself"
    )


@dataclass
class ModelFit:
    spec: str
    log_likelihood: float
    k_model: int          # substitution-model free parameters
    k_branches: int       # fitted branch lengths (2(N-1), rooted)
    n_sites: float        # AICc/BIC sample size
    aic: float
    aicc: float
    bic: float
    params: dict = field(repr=False, default=None)
    branches: np.ndarray = field(repr=False, default=None)

    @property
    def k(self):
        return self.k_model + self.k_branches


def _criteria(ll, k, n):
    aic = 2.0 * k - 2.0 * ll
    denom = n - k - 1.0
    aicc = aic + (2.0 * k * (k + 1.0) / denom if denom > 0 else np.inf)
    bic = k * np.log(n) - 2.0 * ll
    return aic, aicc, bic


def select_model(genome, *, taxa=None, record=None, candidates=None,
                 criterion="bic", steps=300, learning_rate=0.05,
                 site_weights=None, dtype=None, device=None, verbose=False):
    """Fit every candidate model spec on one fixed topology and rank by
    an information criterion.

    genome: (N, S, A) one-hot / ambiguity-coded alignment
        (dataset.genome).
    record: fixed topology (merge record); None builds a neighbor-
        joining tree from JC-corrected distances (search.nj), the
        standard ModelFinder setup -- one shared tree, per-model
        branch-length refits.
    candidates: iterable of `get_model` spec strings; defaults to the
        12-model DNA ladder (DNA_CANDIDATES) for A=4 (protein
        alignments must pass their own .dat-based list).
    criterion: 'aic' | 'aicc' | 'bic' -- the sort key (all three are
        reported on every fit).
    device: where the fits run (default the card, `device.resolve_device`);
    dtype: 'float32' | 'float64', or None for the device's default
        (`device.resolve_dtype`: float64 on the CPU, float32 on the card,
        which refuses float64).

    Returns [ModelFit] sorted best-first by the chosen criterion.  Each
    fit carries the optimized params/branches, so the winner can go
    straight into tree search:

        fits = select_model(ds.genome, taxa=ds.taxa)
        model = get_model(fits[0].spec, A=ds.A)
        nni_search(leaves, model, {"model": fits[0].params["model"]},
                   record, ...)
    """
    import torch

    from phylo_tpu_torch.device import resolve_device, resolve_dtype
    from phylo_tpu_torch.models.substitution import get_model
    from phylo_tpu_torch.pruning.fixed_tree import optimize_tree
    from phylo_tpu_torch.search.nj import (
        jc_distance_matrix,
        neighbor_joining,
    )

    if criterion not in ("aic", "aicc", "bic"):
        raise ValueError(f"criterion must be aic|aicc|bic, got {criterion!r}")
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype, dev)
    genome = np.asarray(genome)
    N, S, A = genome.shape
    if candidates is None:
        if A != 4:
            raise ValueError(
                f"no default candidate list for A={A}; pass candidates= "
                "(e.g. PAML .dat specs for protein alignments)"
            )
        candidates = DNA_CANDIDATES
    if record is None:
        record = neighbor_joining(
            jc_distance_matrix(genome, site_weights=site_weights)
        )
    n_sites = float(S if site_weights is None
                    else np.sum(np.asarray(site_weights)))
    k_branches = 2 * (N - 1)

    fits = []
    for spec in candidates:
        model = get_model(spec, A=A)
        g = genome
        if hasattr(model, "expand_leaves"):
            g = model.expand_leaves(g)
        leaves = torch.as_tensor(np.asarray(g), device=dev).to(dtype)
        params0 = {"model": model.init_params(dtype, dev)}
        params, branches, ll = optimize_tree(
            leaves, model, params0, record, steps=steps,
            learning_rate=learning_rate, site_weights=site_weights,
        )
        km = n_free_parameters(model)
        aic, aicc, bic = _criteria(float(ll), km + k_branches, n_sites)
        fit = ModelFit(
            spec=spec, log_likelihood=float(ll), k_model=km,
            k_branches=k_branches, n_sites=n_sites,
            aic=aic, aicc=aicc, bic=bic,
            params=params, branches=branches.cpu().numpy(),
        )
        fits.append(fit)
        if verbose:
            print(f"  {spec:<12s} lnL {fit.log_likelihood:14.4f}  "
                  f"k {fit.k:3d}  AIC {fit.aic:12.2f}  "
                  f"AICc {fit.aicc:12.2f}  BIC {fit.bic:12.2f}",
                  flush=True)
    fits.sort(key=lambda f: getattr(f, criterion))
    return fits
