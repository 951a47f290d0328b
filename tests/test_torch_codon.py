"""The codon half of the port's model zoo against the JAX package, float64
on the CPU: the sense-codon tables and GY94's structure masks (equal),
`codon_dataset` on betacorona1 (byte-equal, name included),
`encode_codon_strings` on ambiguity codes, F61 frequencies, GY94's Q,
stationary vector and transitions (1e-12; spectral and chain, with +f),
`expm_reversible` (including a collapsed spectrum, which takes the chain
fallback) and `expm_poisson` (including its clamp and its first-order
branch), and the gradients of a scalar of GY94's transitions with
respect to log_kappa, log_omega and y_station against jax.grad (1e-8)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.dataio import load_dataset as j_load
from phylo_tpu.dataio import codons as jc
from phylo_tpu.models import codon as jcodon
from phylo_tpu.models import expm as jexpm
from phylo_tpu_torch.dataio import codons as tc
from phylo_tpu_torch.dataio import load_dataset
from phylo_tpu_torch.models import codon as tcodon
from phylo_tpu_torch.models import expm as texpm
from phylo_tpu_torch.models.substitution import get_model

torch.set_num_threads(1)


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _codon_data():
    return (jc.codon_dataset(j_load("betacorona1")),
            tc.codon_dataset(load_dataset("betacorona1")))


def _freqs():
    return tc.empirical_codon_frequencies(_codon_data()[1].genome)


def test_codon_tables_and_masks_match_jax():
    assert tc.SENSE_CODONS == jc.SENSE_CODONS and len(tc.SENSE_CODONS) == 61
    assert tc.CODON_AA == jc.CODON_AA
    for a, b in zip(tcodon._structure_masks(), jcodon._structure_masks()):
        np.testing.assert_array_equal(a, b)


def test_codon_dataset_is_byte_equal_on_betacorona1():
    jd, td = _codon_data()
    assert td.name == jd.name == "betacorona1_codon_drop2nt"
    assert td.taxa == jd.taxa
    assert td.genome.dtype == jd.genome.dtype
    assert td.genome.shape == (17, 1086, 61)
    assert td.genome.tobytes() == jd.genome.tobytes()


def test_encode_codon_strings_matches_jax():
    seqs = {"a": "TTYTAR---ATGNNN", "b": "TTTTAAGGGATRCCC",
            "c": "RRRYYYSWKTTTAAA"}
    jt, jg = jc.encode_codon_strings(seqs)
    tt, tg = tc.encode_codon_strings(seqs)
    assert tt == jt
    np.testing.assert_array_equal(tg, jg)
    with pytest.raises(ValueError, match="multiple of 3"):
        tc.encode_codon_strings({"a": "TTTT"})


def test_empirical_codon_frequencies_match_jax():
    jd, td = _codon_data()
    for pc in (1.0, 0.5):
        _close(tc.empirical_codon_frequencies(td.genome, pseudocount=pc),
               jc.empirical_codon_frequencies(jd.genome, pseudocount=pc))


def _gy94_params(plus_f, seed=3):
    """GY94's parameters moved off their initial values, as numpy."""
    rng = np.random.default_rng(seed)
    tree = {"log_kappa": np.log(2.0) + 0.3 * rng.normal(),
            "log_omega": np.log(0.2) + 0.3 * rng.normal()}
    if plus_f:
        tree["y_station"] = np.log(_freqs()) + 0.2 * rng.normal(size=61)
    return {k: np.asarray(v, np.float64) for k, v in tree.items()}


@pytest.mark.parametrize("spectral,plus_f", [(True, False), (True, True),
                                             (False, False)])
def test_gy94_matches_jax(spectral, plus_f):
    f = _freqs()
    jm = jcodon.GY94(f, plus_f=plus_f, spectral=spectral)
    tm = tcodon.GY94(f, plus_f=plus_f, spectral=spectral)
    tree = _gy94_params(plus_f)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    tp = {k: torch.tensor(v) for k, v in tree.items()}
    b = np.random.default_rng(4).exponential(0.2, (2, 3))
    _close(tm.Q(tp), jm.Q(jp))
    _close(tm.stationary(tp), jm.stationary(jp))
    _close(tm.transition(tp, torch.tensor(b)),
           jm.transition(jp, jnp.asarray(b)))
    init_j = jm.init_params(jnp.float64)
    init_t = tm.init_params(torch.float64)
    assert sorted(init_t) == sorted(init_j)
    for k in init_j:
        _close(init_t[k], init_j[k])


def test_spec_parser_resolves_gy94_and_plus_f():
    m = get_model("gy94", A=61)
    assert isinstance(m, tcodon.GY94) and not m.plus_f and m.spectral
    mf = get_model("codon+f", A=61)
    assert isinstance(mf, tcodon.GY94) and mf.plus_f
    g = get_model("gy94+g4", A=61)
    assert isinstance(g.base, tcodon.GY94) and g.blocks == (4, 61)
    with pytest.raises(ValueError, match=r"'\+f' requires"):
        get_model("gtr+f")
    with pytest.raises(FileNotFoundError, match="PAML .dat file not found"):
        get_model("lg.dat+f")


def _reversible_case(collapsed):
    """A reversible generator and its stationary vector: GY94's (distinct
    eigenvalues), or JC69 on 9 states, whose spectrum is degenerate, so
    expm_reversible takes the chain fallback."""
    if collapsed:
        A = 9
        Q = np.full((A, A), 1.0 / A) - np.eye(A)
        return Q, np.full(A, 1.0 / A)
    tree = _gy94_params(True)
    m = jcodon.GY94(_freqs(), plus_f=True)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    return np.asarray(m.Q(jp)), np.asarray(m.stationary(jp))


@pytest.mark.parametrize("collapsed", [False, True])
def test_expm_reversible_matches_jax(collapsed):
    Q, pi = _reversible_case(collapsed)
    b = np.random.default_rng(5).exponential(0.3, 6)
    got = texpm.expm_reversible(torch.tensor(Q), torch.tensor(pi),
                                torch.tensor(b))
    # the branch is chosen on the device: the chain's value to the bit
    # where the spectrum collapses, the spectral-only value elsewhere
    if collapsed:
        want = texpm.expm_ctmc(torch.tensor(Q).T, torch.tensor(b))
    else:
        want = texpm.expm_reversible(torch.tensor(Q), torch.tensor(pi),
                                     torch.tensor(b), chain_fallback=False)
    assert torch.equal(got, want)
    _close(got, jexpm.expm_reversible(jnp.asarray(Q), jnp.asarray(pi),
                                      jnp.asarray(b)))
    if not collapsed:
        _close(texpm.expm_reversible(torch.tensor(Q), torch.tensor(pi),
                                     torch.tensor(b), clip=False,
                                     chain_fallback=False),
               jexpm.expm_reversible(jnp.asarray(Q), jnp.asarray(pi),
                                     jnp.asarray(b), clip=False,
                                     chain_fallback=False))


def test_expm_reversible_float32_keeps_small_entries():
    """From float32 inputs the spectral transitions are float64's, cast:
    every entry of GY94's P, down to ~1e-11, within float32 rounding of
    the float64 result (a float32 reconstruction was off by ~6e-7
    absolute, more than 1% on 40% of the entries)."""
    Q, pi = _reversible_case(False)
    b = np.array([0.01, 0.1, 0.5])
    got = texpm.expm_reversible(torch.tensor(Q, dtype=torch.float32),
                                torch.tensor(pi, dtype=torch.float32),
                                torch.tensor(b, dtype=torch.float32))
    assert got.dtype == torch.float32
    want = texpm.expm_reversible(
        torch.tensor(Q, dtype=torch.float32).double(),
        torch.tensor(pi, dtype=torch.float32).double(),
        torch.tensor(b, dtype=torch.float32).double())
    assert float(want.min()) < 1e-9
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)


def test_expm_poisson_matches_jax():
    """A generic b, the clamp (mu b > 80) and the first-order branch
    (mu b < 1e-6), on GY94's Q^T; values and the gradient of a scalar of
    P with respect to Q and b."""
    Q, _ = _reversible_case(False)
    Qt = np.ascontiguousarray(Q.T)
    mu = np.max(-np.diag(Q))
    b = np.array([0.05, 0.7, 3.0, 200.0 / mu, 1e-8 / mu, 0.0])
    c = np.random.default_rng(6).normal(size=(6, 61, 61))

    @jax.jit
    def j_value_and_grad(Qt, b):
        P, vjp = jax.vjp(jexpm.expm_poisson, Qt, b)
        return P, vjp(jnp.asarray(c))

    want, jg = j_value_and_grad(jnp.asarray(Qt), jnp.asarray(b))
    got = texpm.expm_poisson(torch.tensor(Qt), torch.tensor(b))
    _close(got, want)
    _close(got, texpm.expm_chain(torch.tensor(Qt), torch.tensor(b)),
           rtol=1e-10)
    tq = torch.tensor(Qt, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    torch.sum(texpm.expm_poisson(tq, tb) * torch.tensor(c)).backward()
    _close(tq.grad, jg[0], rtol=1e-10)
    _close(tb.grad, jg[1], rtol=1e-10)
    assert float(tb.grad[3]) == 0.0          # past the clamp: no d/db


@pytest.mark.parametrize("plus_f", [False, True])
def test_gy94_transition_gradients_match_jax(plus_f):
    f = _freqs()
    tree = _gy94_params(plus_f, seed=8)
    rng = np.random.default_rng(9)
    b = rng.exponential(0.2, 4)
    c = rng.normal(size=(4, 61, 61))
    jm = jcodon.GY94(f, plus_f=plus_f)
    tm = tcodon.GY94(f, plus_f=plus_f)

    @jax.jit
    def j_grad(p):
        return jax.grad(lambda q: jnp.sum(jm.transition(q, b) * c))(p)

    want = j_grad({k: jnp.asarray(v) for k, v in tree.items()})
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in tree.items()}
    torch.sum(tm.transition(tp, torch.tensor(b)) * torch.tensor(c)).backward()
    for k in tree:
        _close(tp[k].grad, want[k], rtol=1e-8)
        assert np.all(np.asarray(tp[k].grad) != 0.0), k
