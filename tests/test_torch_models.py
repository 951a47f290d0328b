"""The DNA half of the model zoo against the JAX package, float64 on the
CPU: the differentiable incomplete gamma and the discrete-Gamma rates
(values to 1e-12, d rates / d alpha to 1e-9 against jax), GTR, HKY,
GammaSites (+I) and FreeRates (Q, stationary, per-category and dense
transitions to 1e-12), the model-spec parser, and the runner training a
rate mixture for one epoch on the CPU, from a spec and from flags."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.models import substitution as J
from phylo_tpu_torch.cli import runner
from phylo_tpu_torch.models import substitution as T
from phylo_tpu_torch.params import params_from_numpy
from phylo_tpu_torch.train.trainer import param_tensors
from phylo_tpu_torch.utils.math import gammainc

torch.set_num_threads(1)


# (a, x, rtol): small and moderate shapes, then large ones near the
# discrete-Gamma boundaries (a ~ x up to 1e5), where lgamma's rounding of
# large arguments limits both sides to ~1e-10
GAMMAINC_CASES = {
    "small": ([0.05, 0.2, 1.0, 1.2, 5.0, 6.0, 30.0],
              [1e-5, 0.01, 1.3, 0.3, 4.0, 9.0, 25.0], 1e-12),
    "large": ([256.0, 300.0, 5000.0, 2e4, 1e5, 1e5],
              [236.0, 325.0, 5080.0, 19850.0, 1e5, 100300.0], 1e-9),
}


@pytest.mark.parametrize("case", sorted(GAMMAINC_CASES))
def test_gammainc_and_its_gradients_match_jax(case):
    a, x, rtol = (np.asarray(v) for v in GAMMAINC_CASES[case])
    want = np.asarray(jax.scipy.special.gammainc(a, x))
    da, dx = jax.vmap(jax.grad(jax.scipy.special.gammainc, argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(x))
    ta = torch.tensor(a, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    got = gammainc(ta, tx)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(da), rtol=rtol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), rtol=rtol)


def test_gammainc_is_nan_where_its_series_does_not_reach():
    """x far above a (the terms peak past the series) gives NaN, never a
    truncated sum; x far below a gives P's true underflow, 0."""
    got = gammainc(torch.tensor([1.0, 0.2, 500.0], dtype=torch.float64),
                   torch.tensor([5000.0, 1e6, 1e-3], dtype=torch.float64))
    assert torch.isnan(got[:2]).all() and got[2] == 0.0


@functools.lru_cache(maxsize=None)
def _jax_rates(G):
    f = functools.partial(J.discrete_gamma_rates, G=G)
    return jax.jit(f), jax.jit(jax.jacfwd(f))


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("alpha", [0.2, 1.0, 5.0, 300.0])
def test_discrete_gamma_rates_match_jax(alpha, G):
    rates, jac = _jax_rates(G)
    want = np.asarray(rates(jnp.float64(alpha)))
    dwant = np.asarray(jac(jnp.float64(alpha)))
    a = torch.tensor(alpha, dtype=torch.float64, requires_grad=True)
    got = T.discrete_gamma_rates(a, G)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-12)
    assert abs(float(got.detach().mean()) - 1.0) < 1e-12
    dgot = np.stack([torch.autograd.grad(got[g], a, retain_graph=True)[0]
                     .numpy() for g in range(G)])
    np.testing.assert_allclose(dgot, dwant, rtol=1e-9,
                               atol=1e-9 * np.abs(dwant).max())


def _model_case(spec, seed):
    """(jax model, port model, numpy params moved off their initial
    values)."""
    jm = J.get_model(spec, A=4)
    tm = T.get_model(spec, A=4)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda x: np.asarray(x) + rng.normal(
        0.0, 0.3, np.shape(x)), jm.init_params(jnp.float64))
    return jm, tm, tree


@pytest.mark.parametrize("spec", ["gtr", "hky", "gtr+g4", "hky+g4+i",
                                  "gtr+i", "jc69+r3", "gtr+r2"])
def test_models_match_jax(spec):
    jm, tm, tree = _model_case(spec, seed=len(spec))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy({"model": tree}, requires_grad=False)["model"]
    b = np.random.default_rng(1).exponential(0.1, (3, 5))
    pairs = [(tm.Q(tp), jm.Q(jp)),
             (tm.stationary(tp), jm.stationary(jp)),
             (tm.transition(tp, torch.tensor(b)),
              jm.transition(jp, jnp.asarray(b)))]
    if hasattr(jm, "transition_blocks"):
        assert tm.blocks == jm.blocks
        pairs.append((tm.transition_blocks(tp, torch.tensor(b)),
                      jm.transition_blocks(jp, jnp.asarray(b))))
        assert tm.A == jm.A
        g = np.eye(4)[np.random.default_rng(2).integers(0, 4, (3, 7))]
        np.testing.assert_array_equal(tm.expand_leaves(g),
                                      jm.expand_leaves(g))
    for got, want in pairs:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("spec,kind", [
    ("gtr+g4", (T.GammaSites, T.GTR, 4, False)),
    ("hky+g+i", (T.GammaSites, T.HKY, 4, True)),
    ("jc69+i", (T.GammaSites, T.JC69, 1, True)),
    ("reference+r3", (T.FreeRates, T.ReferenceQ, 3, False)),
])
def test_spec_parser(spec, kind):
    m = T.get_model(spec)
    cls, base, G, inv = kind
    assert type(m) is cls and type(m.base) is base and m.G == G
    assert getattr(m, "invariant", False) == inv


@pytest.mark.parametrize("spec,err", [
    ("lg.dat", NotImplementedError), ("lg.dat+f", NotImplementedError),
    ("gtr+f", ValueError), ("jc69+g4+f", ValueError),
    ("gtr+g4+r3", ValueError), ("gtr+x", ValueError), ("k80", KeyError),
])
def test_spec_parser_refuses(spec, err):
    with pytest.raises(err):
        T.get_model(spec)


@pytest.mark.parametrize("argv,cls,G", [
    (["--model=gtr+g4"], T.GammaSites, 4),
    (["--model=gtr", "--gamma_categories=4"], T.GammaSites, 4),
    (["--model=gtr", "--invariant_sites=true"], T.GammaSites, 1),
    (["--model=jc69", "--free_rates=true", "--gamma_categories=3"],
     T.FreeRates, 3),
])
def test_runner_trains_a_rate_mixture_on_cpu(argv, cls, G):
    """One epoch through runner.run on the CPU; every parameter, the
    mixture's included, gets a finite non-zero gradient (alpha has none
    to get with a single Gamma category)."""
    res = runner.run(["--dataset=load_strings", "--n_particles=4",
                      "--num_epoch=1", "--batch_size=5", "--no_artifacts",
                      "--device=cpu"] + argv)
    assert np.isfinite(res.elbo)
    model = res.params["model"]
    assert ("log_alpha" in model) == (cls is T.GammaSites)
    assert ("log_rates" in model) == (cls is T.FreeRates)
    for t in param_tensors(res.params):
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert bool((t.grad != 0).any()) or (
            G == 1 and t is model["log_alpha"])
    assert res.history["Qmatrices"][-1].shape == (
        4 * (G + ("--invariant_sites=true" in argv)),) * 2


def test_mixture_spec_and_flags_are_exclusive():
    with pytest.raises(ValueError, match="already includes"):
        runner.run(["--dataset=load_strings", "--n_particles=4",
                    "--num_epoch=1", "--no_artifacts", "--device=cpu",
                    "--model=gtr+g4", "--gamma_categories=4"])
