"""Substitution models (port of phylo_tpu/models/substitution.py: JC69,
ReferenceQ, FixedQ, GTR, HKY, the across-site rate mixtures GammaSites
(+G, +I) and FreeRates (+R), and the spec parser, which also resolves
the codon model GY94 of models/codon.py and the empirical protein models
of models/empirical.py from PAML .dat files).

Models are stateless objects over parameter dicts of tensors (nested for
the mixtures: {"base": {...}, "log_alpha": ...}).  Transition matrices
are returned in MERGE orientation, as in the JAX package: the pruning
contraction is merged(b) = sum_a msg(a) M[a, b].  ReferenceQ / FixedQ
keep the reference's raw expm(Q b) under that contraction (reference
vcsmc.py:180-188); GTR / HKY return expm(Q^T b), the textbook
time-reversible likelihood.
"""

from __future__ import annotations

import torch

from phylo_tpu_torch.device import device_constant
from phylo_tpu_torch.models.expm import expm_ctmc, jc69_transition
from phylo_tpu_torch.utils.math import gammainc


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
        return device_constant(self._Q, dtype, torch.device(device))

    def stationary(self, params, dtype=torch.float64, device="cpu"):
        return device_constant(self._pi, dtype, torch.device(device))

    def transition(self, params, b):
        return expm_ctmc(self.Q(params, dtype=b.dtype, device=b.device), b)


class GTR(_Model):
    """Textbook GTR: Q_ij = s_ij pi_j (i != j), diagonal = -row sum, with
    exchangeabilities s in log space (params['log_exch'], the upper
    triangle in row order) and stationary = softmax(params['y_station']);
    normalized to unit expected substitution rate when `normalize`."""

    def __init__(self, A=4, normalize=True):
        self.A = A
        self.normalize = normalize

    def n_exch(self):
        return self.A * (self.A - 1) // 2

    def init_params(self, dtype=torch.float32, device="cpu"):
        return {
            "log_exch": torch.zeros((self.n_exch(),), dtype=dtype,
                                    device=device),
            "y_station": torch.zeros((self.A,), dtype=dtype, device=device),
        }

    def _exch_matrix(self, log_exch):
        A = self.A
        iu = torch.triu_indices(A, A, offset=1, device=log_exch.device)
        s = torch.zeros((A, A), dtype=log_exch.dtype,
                        device=log_exch.device).index_put(
            (iu[0], iu[1]), torch.exp(log_exch))
        return s + s.T

    def Q(self, params, **_):
        pi = self.stationary(params)
        q = self._exch_matrix(params["log_exch"]) * pi[None, :]
        q = q - torch.diag(torch.sum(q, dim=1))
        return _normalize(q, pi) if self.normalize else q

    def stationary(self, params, **_):
        return torch.softmax(params["y_station"], dim=0)

    def transition(self, params, b):
        # merge orientation: expm(Q^T b) = expm(Q b)^T
        return expm_ctmc(self.Q(params).T, b)


class HKY(_Model):
    """HKY85 (A=4, ACGT order): Q_ij = kappa pi_j for the transitions
    A<->G and C<->T, pi_j for transversions, diagonal = -row sum, kappa =
    exp(params['log_kappa']); normalized when `normalize`."""

    _TRANSITION_MASK = (
        (0, 0, 1, 0),   # A<->G
        (0, 0, 0, 1),   # C<->T
        (1, 0, 0, 0),
        (0, 1, 0, 0),
    )

    def __init__(self, A=4, normalize=True):
        if A != 4:
            raise ValueError("HKY85 is defined for the A=4 DNA alphabet")
        self.A = 4
        self.normalize = normalize

    def init_params(self, dtype=torch.float32, device="cpu"):
        return {
            "log_kappa": torch.zeros((), dtype=dtype, device=device),
            "y_station": torch.zeros((self.A,), dtype=dtype, device=device),
        }

    def Q(self, params, **_):
        pi = self.stationary(params)
        kappa = torch.exp(params["log_kappa"])
        mask = device_constant(self._TRANSITION_MASK, torch.bool, pi.device)
        off = torch.where(mask, kappa, torch.ones_like(kappa)) * pi[None, :]
        off = off * (1.0 - torch.eye(4, dtype=off.dtype, device=off.device))
        q = off - torch.diag(torch.sum(off, dim=1))
        return _normalize(q, pi) if self.normalize else q

    def stationary(self, params, **_):
        return torch.softmax(params["y_station"], dim=0)

    def transition(self, params, b):
        return expm_ctmc(self.Q(params).T, b)


def _normalize(q, pi):
    """q scaled to unit expected substitution rate -sum_i pi_i q_ii."""
    rate = -torch.sum(pi * torch.diagonal(q))
    return q / torch.clamp(rate, min=1e-30)


def discrete_gamma_rates(alpha, G, newton_iters=25):
    """Mean-of-bin discrete Gamma(alpha, alpha) category rates (Yang
    1994), differentiable in alpha, computed in float64.

    The G-1 quantile boundaries solve P(alpha, y) = g/G by Newton
    iterations from a Wilson-Hilferty start; they unroll into plain torch
    ops, so d rates / d alpha flows (through `utils.math.gammainc`, which
    differentiates in its first argument).  Bin means use E[X; X in bin]
    = P(alpha+1, .) differences for X ~ Gamma(alpha, rate=alpha), so
    mean_g r_g == 1."""
    alpha = torch.as_tensor(alpha).to(torch.float64)
    f = dict(dtype=torch.float64, device=alpha.device)
    if G == 1:
        return torch.ones((1,), **f)
    p = torch.arange(1, G, **f) / G
    z = torch.special.ndtri(p)
    c = 1.0 - 1.0 / (9.0 * alpha) + z * torch.sqrt(1.0 / (9.0 * alpha))
    y = alpha * torch.clamp(c, min=1e-3) ** 3
    for _ in range(newton_iters):
        fy = gammainc(alpha, y) - p
        log_pdf = (alpha - 1.0) * torch.log(y) - y - torch.lgamma(alpha)
        y = torch.clamp(y - fy * torch.exp(-log_pdf), min=1e-12)
    q1 = torch.cat([torch.zeros((1,), **f), gammainc(alpha + 1.0, y),
                    torch.ones((1,), **f)])
    return G * torch.diff(q1)


class _SiteMixture(_Model):
    """Across-site rate mixtures as product-space models: the rate
    category rides the state space, A' = C*A, Q' = blockdiag(r_c Q_base),
    pi' = w (x) pi_base, so pruning over A' computes the exact mixture
    likelihood sum_c w_c L^(c).  Subclasses provide `init_params`,
    `rates(params)` (C,) and `weights(params, dtype, device)` (C,)."""

    base: _Model
    n_cat: int

    def Q(self, params, dtype=torch.float64, device="cpu"):
        r = self.rates(params)
        qb = self.base.Q(params["base"], dtype=r.dtype,
                         device=r.device).to(r.dtype)
        return torch.kron(torch.diag(r), qb)

    def stationary(self, params, dtype=torch.float64, device="cpu"):
        pib = self.base.stationary(params["base"], dtype=dtype, device=device)
        w = self.weights(params, pib.dtype, pib.device).to(pib.dtype)
        return torch.kron(w, pib)

    @property
    def blocks(self):
        """(C, A_base): the sweep's blocked merge takes per-category
        transitions from `transition_blocks` when a model has this."""
        return (self.n_cat, self.base.A)

    def _category_rates(self, params):
        """`rates(params)`, reused while no gradient is taken and the
        mixture's own parameters are the same tensors, unchanged: the
        twist asks for transitions at every rank and pair chunk, and a
        discrete Gamma's 25 Newton steps are some hundreds of small
        kernel launches each time.  "Unchanged" is read from the tensors'
        versions, which a CUDA graph's replay does not bump: the fused
        epoch calls `clear_memos` around each capture and after each
        replay."""
        own = [t for k, t in sorted(params.items()) if k != "base"]
        key = [(t, t._version) for t in own]
        if torch.is_grad_enabled() and any(t.requires_grad for t in own):
            return self.rates(params)
        memo = getattr(self, "_rates_memo", None)
        if memo is not None and len(memo[0]) == len(key) and all(
                t is u and v == w for (t, v), (u, w) in zip(key, memo[0])):
            return memo[1]
        r = self.rates(params)
        self._rates_memo = (key, r)
        return r

    def transition_blocks(self, params, b):
        """Per-category transitions (..., C, A, A): the expm of a block-
        diagonal generator is the block-diagonal of the blocks' expms, so
        one batched base transition over b (x) r replaces a dense (CA)^3
        series (JC69 keeps its closed form)."""
        r = self._category_rates(params)
        return self.base.transition(params["base"],
                                    b[..., None] * r.to(b.dtype))

    def transition(self, params, b):
        """Dense (..., CA, CA) block-diagonal transitions, assembled by an
        exact broadcast multiply."""
        Pg = self.transition_blocks(params, b)
        C, A = self.n_cat, self.base.A
        eye = torch.eye(C, dtype=Pg.dtype, device=Pg.device)
        dense = Pg[..., :, :, None, :] * eye[:, None, :, None]
        return dense.reshape(*b.shape, C * A, C * A)

    def expand_leaves(self, genome):
        """(N, S, A) codes -> (N, S, C*A): the observation does not depend
        on the category, so each block repeats the base code."""
        import numpy as np

        return np.tile(np.asarray(genome), (1, 1, self.n_cat))


class GammaSites(_SiteMixture):
    """Discrete-Gamma rates across sites (Yang 1994), optionally with a
    proportion of invariant sites (+I): `invariant` prepends a rate-0
    category of weight p_inv = sigmoid(params['logit_pinv']) and rescales
    the Gamma rates by 1/(1-p_inv), so the mean rate stays 1.  alpha =
    exp(params['log_alpha']) is learnable."""

    def __init__(self, base, G=4, invariant=False):
        self.base = get_model(base) if isinstance(base, str) else base
        self.G = int(G)
        self.invariant = bool(invariant)
        self.n_cat = self.G + (1 if self.invariant else 0)
        self.A = self.base.A * self.n_cat

    def init_params(self, dtype=torch.float32, device="cpu"):
        p = {"base": self.base.init_params(dtype, device),
             "log_alpha": torch.zeros((), dtype=dtype, device=device)}
        if self.invariant:
            # sigmoid(-2) ~ 0.12: a small invariant fraction to start
            p["logit_pinv"] = torch.tensor(-2.0, dtype=dtype, device=device)
        return p

    def rates(self, params):
        r = discrete_gamma_rates(torch.exp(params["log_alpha"]), self.G)
        if not self.invariant:
            return r
        p = torch.sigmoid(params["logit_pinv"]).to(r.dtype)
        return torch.cat([torch.zeros((1,), dtype=r.dtype, device=r.device),
                          r / (1.0 - p)])

    def weights(self, params, dtype=torch.float64, device="cpu"):
        if not self.invariant:
            return torch.full((self.G,), 1.0 / self.G, dtype=dtype,
                              device=device)
        p = torch.sigmoid(params["logit_pinv"])
        return torch.cat([p[None], torch.full((self.G,), 1.0, dtype=p.dtype,
                                              device=p.device)
                          * (1.0 - p) / self.G])


class FreeRates(_SiteMixture):
    """FreeRates (+R; Yang 1995): G categories with learnable weights
    softmax(params['w_logits']) and rates exp(params['log_rates'])
    normalized so sum_c w_c r_c == 1."""

    def __init__(self, base, G=4):
        self.base = get_model(base) if isinstance(base, str) else base
        self.G = int(G)
        self.n_cat = self.G
        self.A = self.base.A * self.G

    def init_params(self, dtype=torch.float32, device="cpu"):
        # spread rates so the categories are not permutation-symmetric
        g = torch.arange(self.G, dtype=dtype, device=device)
        return {"base": self.base.init_params(dtype, device),
                "w_logits": torch.zeros((self.G,), dtype=dtype,
                                        device=device),
                "log_rates": (g - (self.G - 1) / 2.0)
                * (2.0 / max(self.G, 2))}

    def weights(self, params, dtype=None, device=None):
        x = params["w_logits"]
        e = torch.exp(x - torch.max(x))
        return e / torch.sum(e)

    def rates(self, params):
        raw = torch.exp(params["log_rates"])
        return raw / torch.sum(self.weights(params) * raw)


def clear_memos(model):
    """Forget the category rates `_SiteMixture._category_rates` keeps, on
    `model` and the models it wraps."""
    while model is not None:
        model.__dict__.pop("_rates_memo", None)
        model = getattr(model, "base", None)


def _get_base_model(name, A):
    lowered = name.lower()
    if lowered.endswith(".dat"):
        # a PAML empirical amino-acid file; the path keeps its case
        from phylo_tpu_torch.models.empirical import EmpiricalProtein

        return EmpiricalProtein.from_paml(name)
    if lowered in ("gy94", "codon"):
        # uniform-frequency GY94; the trainer swaps in the alignment's
        # empirical F61 frequencies
        from phylo_tpu_torch.models.codon import GY94

        return GY94()
    if lowered in ("jc", "jc69", "jcmodel"):
        return JC69(A)
    if lowered in ("reference", "referenceq", "learned", "learned_q"):
        return ReferenceQ(A)
    if lowered == "gtr":
        return GTR(A)
    if lowered in ("hky", "hky85"):
        return HKY(A)
    raise KeyError(f"unknown substitution model {name!r}")


def get_model(name, A=4):
    """Resolve a substitution-model spec: a base name (jc69, reference,
    gtr, hky, gy94/codon, or a PAML ``.dat`` path: an empirical protein
    model) optionally followed by '+'-separated modifiers -- ``+gN``
    discrete Gamma with N categories (``+g`` = ``+g4``), ``+i``
    invariant sites, ``+rN`` FreeRates, ``+f`` learnable stationary
    frequencies (.dat and gy94 bases) -- as in PhyML/RAxML/IQ-TREE model
    strings (``gtr+g4+i``, ``jc69+r3``, ``gy94+f``, ``lg.dat+f+g4``)."""
    parts = str(name).split("+")
    base = _get_base_model(parts[0], A)
    gamma = None
    invariant = False
    freerates = None
    for mod in parts[1:]:
        m = mod.strip().lower()
        if not m:
            continue
        if m == "i":
            invariant = True
        elif m == "f":
            from phylo_tpu_torch.models.codon import GY94
            from phylo_tpu_torch.models.empirical import EmpiricalProtein

            if isinstance(base, GY94):
                base = GY94(base._freqs, plus_f=True,
                            normalize=base.normalize,
                            spectral=base.spectral)
            elif isinstance(base, EmpiricalProtein):
                base = EmpiricalProtein(
                    base._exch, base._freqs, name=base.name, plus_f=True,
                    normalize=base.normalize, spectral=base.spectral)
            else:
                raise ValueError(
                    f"'+f' requires a PAML .dat or gy94 base model "
                    f"(spec {name!r})")
        elif m[0] == "g" and (len(m) == 1 or m[1:].isdigit()):
            gamma = int(m[1:]) if len(m) > 1 else 4
        elif m[0] == "r" and (len(m) == 1 or m[1:].isdigit()):
            freerates = int(m[1:]) if len(m) > 1 else 4
        else:
            raise ValueError(
                f"unknown model modifier {mod!r} in spec {name!r}")
    if freerates is not None:
        if gamma is not None or invariant:
            raise ValueError(
                f"'+r' cannot combine with '+g'/'+i' (spec {name!r})")
        return FreeRates(base, G=freerates)
    if gamma is not None or invariant:
        return GammaSites(base, G=gamma or 1, invariant=invariant)
    return base
