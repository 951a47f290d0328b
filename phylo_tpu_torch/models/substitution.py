"""Substitution models of the slice (port of
phylo_tpu/models/substitution.py: JC69, ReferenceQ, FixedQ).

Models are stateless objects over parameter dicts of tensors.  Transition
matrices are returned in MERGE orientation, as in the JAX package: the
pruning contraction is merged(b) = sum_a msg(a) M[a, b], and ReferenceQ /
FixedQ keep the reference's raw expm(Q b) under that contraction
(reference vcsmc.py:180-188).
"""

from __future__ import annotations

import torch

from phylo_tpu_torch.models.expm import expm_ctmc, jc69_transition


class _Model:
    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__,
                     tuple(sorted(self.__dict__.items()))))


class JC69(_Model):
    """Jukes-Cantor: off-diagonal 1/A, diagonal -(A-1)/A, uniform
    stationary distribution; closed-form transitions, no parameters."""

    def __init__(self, A=4):
        self.A = A

    def init_params(self, dtype=torch.float32, device="cpu"):
        return {}

    def Q(self, params, dtype=torch.float64, device="cpu"):
        A = self.A
        return (torch.full((A, A), 1.0 / A, dtype=dtype, device=device)
                - torch.eye(A, dtype=dtype, device=device))

    def stationary(self, params, dtype=torch.float64, device="cpu"):
        return torch.full((self.A,), 1.0 / self.A, dtype=dtype,
                          device=device)

    def transition(self, params, b):
        return jc69_transition(b, self.A)


class ReferenceQ(_Model):
    """The reference's learned rate matrix + stationary distribution
    (vcsmc.py:122-124,133-148): off-diagonal exp(y_q) row-normalized to
    sum 1, diagonal -1; stationary = softmax(y_station)."""

    def __init__(self, A=4):
        self.A = A

    def init_params(self, dtype=torch.float32, device="cpu"):
        A = self.A
        off = 1.0 - torch.eye(A, dtype=dtype, device=device)
        return {
            "y_q": torch.full((A, A), 1.0 / A, dtype=dtype,
                              device=device) * off,
            "y_station": torch.full((A,), 1.0 / A, dtype=dtype,
                                    device=device),
        }

    def Q(self, params, **_):
        y = params["y_q"]
        A = self.A
        off = torch.exp(y) * (1.0 - torch.eye(A, dtype=y.dtype,
                                              device=y.device))
        off = off / torch.sum(off, dim=1, keepdim=True)
        return off - torch.diag(torch.sum(off, dim=1))

    def stationary(self, params, **_):
        return torch.softmax(params["y_station"], dim=0)

    def transition(self, params, b):
        # raw expm(Qb): the reference's `data @ P` defines this model
        return expm_ctmc(self.Q(params), b)


class FixedQ(_Model):
    """A fixed, user-supplied rate matrix with uniform (or supplied)
    stationary probabilities (reference csmc.py:141-150)."""

    def __init__(self, Q, stationary=None):
        import numpy as np

        self._Q = tuple(map(tuple, np.asarray(Q, dtype=float)))
        A = len(self._Q)
        if stationary is None:
            stationary = [1.0 / A] * A
        self._pi = tuple(float(x) for x in stationary)
        self.A = A

    def init_params(self, dtype=torch.float32, device="cpu"):
        return {}

    def Q(self, params, dtype=torch.float64, device="cpu"):
        return torch.tensor(self._Q, dtype=dtype, device=device)

    def stationary(self, params, dtype=torch.float64, device="cpu"):
        return torch.tensor(self._pi, dtype=dtype, device=device)

    def transition(self, params, b):
        return expm_ctmc(self.Q(params, dtype=b.dtype, device=b.device), b)


_NOT_PORTED = ("gtr", "hky", "hky85", "gy94", "codon")


def get_model(name, A=4):
    """Resolve a model spec of the slice: jc69 / reference.  Specs of
    the model zoo (gtr, hky, gy94, PAML .dat files, +g/+i/+r/+f
    modifiers) raise NotImplementedError: ROADMAP.md Queue 1 item 11."""
    spec = str(name)
    lowered = spec.lower()
    if "+" in spec or lowered.endswith(".dat") or lowered in _NOT_PORTED:
        raise NotImplementedError(
            f"substitution model {name!r} is not ported yet "
            "(ROADMAP.md Queue 1 item 11: model zoo)")
    if lowered in ("jc", "jc69", "jcmodel"):
        return JC69(A)
    if lowered in ("reference", "referenceq", "learned", "learned_q"):
        return ReferenceQ(A)
    raise KeyError(f"unknown substitution model {name!r}")
