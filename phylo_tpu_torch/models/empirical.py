"""Empirical amino-acid substitution models, LG / WAG / JTT class (port of
phylo_tpu/models/empirical.py).

An empirical protein model is a fixed symmetric exchangeability matrix
plus stationary frequencies, published as a PAML ``.dat`` file (the
strict lower triangle of the 20x20 exchangeabilities, then the 20
frequencies, in PAML's amino-acid order ``ARNDCQEGHILKMFPSTWYV``).  The
package ships the parser and the model class, and no published matrix:
the user passes their own ``lg.dat``.

    model = EmpiricalProtein.from_paml("lg.dat")               # fixed pi
    model = EmpiricalProtein.from_paml("lg.dat", plus_f=True)  # +F

It composes with GammaSites / FreeRates like any other base model
(``lg.dat+g4``, ``lg.dat+f+g4+i``); over A = 20 states a rate mixture
runs on the card through K9 blocked (pruning.kernels).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from phylo_tpu_torch.dataio.alphabets import PROTEIN_ALPHABET
from phylo_tpu_torch.device import device_constant
from phylo_tpu_torch.models.expm import expm_ctmc, expm_reversible
from phylo_tpu_torch.models.substitution import _Model

# PAML's canonical amino-acid ordering for .dat matrices
PAML_ORDER = "ARNDCQEGHILKMFPSTWYV"

_N_AA = 20
_N_EXCH = _N_AA * (_N_AA - 1) // 2       # 190 lower-triangle entries


def load_paml_dat(source):
    """Parse a PAML ``.dat`` empirical rate file.

    ``source`` is a path or the file's text: the strict lower triangle of
    the symmetric exchangeability matrix (19 rows, row i holding i
    entries), then 20 stationary frequencies, whitespace separated, in
    PAML's ``ARNDCQEGHILKMFPSTWYV`` order.  The first 210 numbers are
    read; notes after them are ignored.

    Returns ``(exch, freqs)`` as float64 arrays reordered to the
    alphabetical ``PROTEIN_ALPHABET`` of the one-hot encoding: ``exch``
    symmetric (20, 20) with a zero diagonal, ``freqs`` summing to 1.
    """
    text = source
    if "\n" not in str(source) and len(str(source)) < 4096:
        if not os.path.exists(source):
            raise FileNotFoundError(
                f"PAML .dat file not found: {source!r} (pass a path or "
                "the file's text)")
        with open(source) as f:
            text = f.read()

    values = []
    for tok in str(text).split():
        try:
            values.append(float(tok))
        except ValueError:
            # the notes after the numbers end the numeric block
            if len(values) >= _N_EXCH + _N_AA:
                break
            raise ValueError(
                f"non-numeric token {tok!r} after {len(values)} values; "
                f"need {_N_EXCH} exchangeabilities + {_N_AA} frequencies")
    if len(values) < _N_EXCH + _N_AA:
        raise ValueError(
            f"PAML .dat holds {len(values)} numbers; need at least "
            f"{_N_EXCH} exchangeabilities + {_N_AA} frequencies")

    exch_paml = np.zeros((_N_AA, _N_AA))
    k = 0
    for i in range(1, _N_AA):
        for j in range(i):
            exch_paml[i, j] = exch_paml[j, i] = values[k]
            k += 1
    freqs_paml = np.asarray(values[k:k + _N_AA])

    perm = np.asarray([PAML_ORDER.index(a) for a in PROTEIN_ALPHABET])
    exch = exch_paml[np.ix_(perm, perm)]
    freqs = freqs_paml[perm]
    total = freqs.sum()
    if not (0.9 < total < 1.1):
        raise ValueError(
            f"frequencies sum to {total:.4f}; not a PAML frequency row")
    return exch, freqs / total


class EmpiricalProtein(_Model):
    """Fixed-exchangeability reversible model: Q_ij = s_ij pi_j (i != j),
    diagonal = -row sum, normalized to unit expected substitution rate
    when `normalize`.  plus_f=True makes pi learnable, as
    softmax(params['y_station']) initialized at the supplied frequencies
    (+F); otherwise the model has no parameters.

    Transitions are in MERGE orientation, expm(Q^T b): by the spectral
    `expm_reversible` (float64 inside) unless spectral=False, which takes
    the uniformized chain `expm_ctmc(Q^T, b)` (with plus_f the spectral
    gradient divides by eigenvalue gaps; spectral=False avoids that).
    """

    def __init__(self, exch, freqs, *, name="custom", plus_f=False,
                 normalize=True, spectral=True):
        exch = np.asarray(exch, dtype=float)
        freqs = np.asarray(freqs, dtype=float)
        A = exch.shape[0]
        if exch.shape != (A, A) or freqs.shape != (A,):
            raise ValueError(
                f"exch {exch.shape} / freqs {freqs.shape} mismatch")
        if not np.allclose(exch, exch.T):
            raise ValueError("exchangeability matrix must be symmetric")
        # tuples: `_Model.__eq__` / `__hash__` compare instance __dict__s
        self._exch = tuple(map(tuple, exch))
        self._freqs = tuple(freqs / freqs.sum())
        self.A = A
        self.name = str(name)
        self.plus_f = bool(plus_f)
        self.normalize = bool(normalize)
        self.spectral = bool(spectral)

    @classmethod
    def from_paml(cls, source, *, name=None, plus_f=False, normalize=True):
        exch, freqs = load_paml_dat(source)
        if name is None:
            name = (os.path.splitext(os.path.basename(str(source)))[0]
                    if "\n" not in str(source) else "custom")
        return cls(exch, freqs, name=name, plus_f=plus_f,
                   normalize=normalize)

    def init_params(self, dtype=torch.float32, device="cpu"):
        if not self.plus_f:
            return {}
        logp = torch.log(torch.tensor(self._freqs, dtype=dtype,
                                      device=device))
        return {"y_station": logp - torch.mean(logp)}

    def stationary(self, params, dtype=torch.float64, device="cpu"):
        if not self.plus_f:
            return device_constant(self._freqs, dtype, torch.device(device))
        e = torch.exp(params["y_station"])
        return e / torch.sum(e)

    def Q(self, params, dtype=torch.float64, device="cpu"):
        pi = self.stationary(params, dtype=dtype, device=device)
        s = device_constant(self._exch, pi.dtype, pi.device)
        q = s * pi[None, :]
        q = q - torch.diag(torch.sum(q, dim=1))
        if self.normalize:
            rate = -torch.sum(pi * torch.diagonal(q))
            q = q / torch.clamp(rate, min=1e-30)
        return q

    def transition(self, params, b):
        f = dict(dtype=torch.promote_types(b.dtype, torch.float64),
                 device=b.device)
        Q = self.Q(params, **f)
        if self.spectral:
            return expm_reversible(Q, self.stationary(params, **f), b)
        return expm_ctmc(Q.T, b)
