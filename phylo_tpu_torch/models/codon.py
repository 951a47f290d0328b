"""Codon substitution models: GY94, Goldman-Yang 1994 (port of
phylo_tpu/models/codon.py).

State space: the 61 sense codons (dataio/codons.py).  The generator
couples codons differing at exactly ONE nucleotide position:

    q_ij = 0                                (>= 2 differences)
    q_ij = pi_j                             (transversion, synonymous)
    q_ij = kappa * pi_j                     (transition,   synonymous)
    q_ij = omega * pi_j                     (transversion, nonsynonymous)
    q_ij = kappa * omega * pi_j             (transition,   nonsynonymous)

with kappa the transition/transversion ratio and omega = dN/dS the
selection parameter, both learnable in log space; pi is fixed (F61
counts of the alignment, or uniform) or learnable (+F).  The chain is
reversible by construction and Q is normalised to unit expected
substitution rate, so branch lengths are in expected substitutions per
codon.  Transitions come from the spectral `expm_reversible` by
default (one 61 x 61 eigh, then one batched matmul), or from
`expm_ctmc(Q^T, b)` with spectral=False.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from phylo_tpu_torch.dataio.codons import CODON_AA, SENSE_CODONS
from phylo_tpu_torch.models.expm import expm_ctmc, expm_reversible
from phylo_tpu_torch.models.substitution import _Model

_TRANSITIONS = {frozenset("AG"), frozenset("CT")}


@functools.lru_cache(maxsize=1)
def _structure_masks():
    """Static (61, 61) masks: one-nucleotide neighbours, transition vs
    transversion at the differing position, synonymous vs not.

    Module-level cached, not instance attributes: `_Model.__eq__` /
    `__hash__` compare instance __dict__s, which arrays would break."""
    A = len(SENSE_CODONS)
    neighbor = np.zeros((A, A))
    is_transition = np.zeros((A, A))
    is_synonymous = np.zeros((A, A))
    for i, ci in enumerate(SENSE_CODONS):
        for j, cj in enumerate(SENSE_CODONS):
            if i == j:
                continue
            diffs = [p for p in range(3) if ci[p] != cj[p]]
            if len(diffs) != 1:
                continue
            (p,) = diffs
            neighbor[i, j] = 1.0
            if frozenset((ci[p], cj[p])) in _TRANSITIONS:
                is_transition[i, j] = 1.0
            if CODON_AA[i] == CODON_AA[j]:
                is_synonymous[i, j] = 1.0
    return neighbor, is_transition, is_synonymous


class GY94(_Model):
    """Goldman-Yang codon model with learnable kappa and omega.

    frequencies: fixed (61,) stationary codon frequencies (e.g.
    `dataio.codons.empirical_codon_frequencies` of the alignment);
    None = uniform.  plus_f=True makes pi learnable instead, as
    softmax(params['y_station']) initialised at log(frequencies).
    """

    A = 61

    def __init__(self, frequencies=None, *, plus_f=False,
                 kappa=2.0, omega=0.2, normalize=True, spectral=True):
        if frequencies is None:
            frequencies = np.full((self.A,), 1.0 / self.A)
        freqs = np.asarray(frequencies, np.float64)
        if freqs.shape != (self.A,):
            raise ValueError(
                f"need {self.A} codon frequencies, got {freqs.shape}")
        if np.any(freqs <= 0):
            raise ValueError("codon frequencies must be positive "
                             "(use a pseudocount)")
        self._freqs = tuple(freqs / freqs.sum())
        self.plus_f = bool(plus_f)
        self._init_kappa = float(kappa)
        self._init_omega = float(omega)
        self.normalize = bool(normalize)
        self.spectral = bool(spectral)

    def init_params(self, dtype=torch.float32, device="cpu"):
        f = dict(dtype=dtype, device=device)
        p = {"log_kappa": torch.tensor(np.log(self._init_kappa), **f),
             "log_omega": torch.tensor(np.log(self._init_omega), **f)}
        if self.plus_f:
            p["y_station"] = torch.tensor(np.log(np.asarray(self._freqs)),
                                          **f)
        return p

    def stationary(self, params, dtype=torch.float64, device="cpu"):
        if self.plus_f:
            e = torch.exp(params["y_station"])
            return e / torch.sum(e)
        return torch.tensor(self._freqs, dtype=dtype, device=device)

    def Q(self, params, **_):
        lk = params["log_kappa"]
        dtype = torch.promote_types(lk.dtype, torch.float32)
        f = dict(dtype=dtype, device=lk.device)
        pi = self.stationary(params, **f).to(dtype)
        kappa = torch.exp(lk).to(dtype)
        omega = torch.exp(params["log_omega"]).to(dtype)
        nb, ts, syn = (torch.tensor(m, **f) for m in _structure_masks())
        one = torch.ones((), **f)
        # kappa on transitions, omega on nonsynonymous changes
        rate = nb * torch.where(ts > 0, kappa, one) \
            * torch.where(syn > 0, one, omega)
        q = rate * pi[None, :]
        q = q - torch.diag(torch.sum(q, dim=1))
        if self.normalize:
            mean_rate = -torch.sum(pi * torch.diagonal(q))
            q = q / torch.clamp(mean_rate, min=1e-30)
        return q

    def transition(self, params, b):
        """Transitions in MERGE orientation (as GTR: expm(Q^T b)), by the
        spectral form unless spectral=False."""
        Q = self.Q(params)
        if self.spectral:
            return expm_reversible(Q, self.stationary(
                params, dtype=Q.dtype, device=Q.device), b)
        return expm_ctmc(Q.T, b)
