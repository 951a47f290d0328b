"""Gradients of the port's manual whole-sweep VJP (K1 forward, K2
reverse, K4 prologue; plain versions on the CPU) against jax.grad of
phylo_tpu's sweep under the same injected decisions (float64, 1e-8
relative), and against the port's own autograd through the plain sweep
with the same random draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.smc.sweep import SweepConfig as JConfig
from phylo_tpu.smc.sweep import sample_phylogenies as j_sample
from phylo_tpu_torch.models.substitution import ReferenceQ
from phylo_tpu_torch.params import params_from_numpy, params_to_numpy
from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies

from test_torch_sweep import random_genome, setup_case, torch_decisions

torch.set_num_threads(1)


def _assert_trees_close(got, want, rtol=1e-8):
    for g in want:
        for k in want[g]:
            a, b = np.asarray(got[g][k]), np.asarray(want[g][k])
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-12 *
                                       max(1.0, np.abs(b).max()),
                                       err_msg=f"{g}/{k}")
            assert np.any(a != 0.0), f"{g}/{k} gradient is zero"


@pytest.mark.parametrize("model_name,kw", [
    ("reference", {}),
    ("jc69", {}),
    ("reference", dict(carried_weights=True, q_raw_subtraction=False)),
])
def test_manual_vjp_grads_match_jax_grad(model_name, kw):
    genome = random_genome(21, N=6, S=32)
    K = 8
    jmodel, tmodel, tree, dec = setup_case(genome, model_name, K, seed=22)

    def loss(p):
        return j_sample(jax.random.PRNGKey(0), jnp.asarray(genome), jmodel,
                        p, JConfig(K=K, **kw),
                        decisions=jax.tree.map(jnp.asarray, dec)).elbo

    want = jax.grad(loss)(jax.tree.map(jnp.asarray, tree))
    params = params_from_numpy(tree)
    res = sample_phylogenies(None, torch.tensor(genome), tmodel, params,
                             SweepConfig(K=K, manual_vjp=True, **kw),
                             decisions=torch_decisions(dec))
    res.elbo.backward()
    grads = {g: {k: t.grad for k, t in sub.items()}
             for g, sub in params.items()}
    _assert_trees_close(params_to_numpy(grads), jax.tree.map(np.asarray,
                                                              want))


@pytest.mark.parametrize("kw", [{}, dict(resampling="systematic"),
                                dict(ess_threshold=0.7,
                                     carried_weights=True)])
def test_manual_vjp_matches_plain_autograd(kw):
    """No decisions: branch lengths are eps / rate, so the rates also get
    the pathwise gradient through the transitions; both routes draw the
    same randomness from equal generators."""
    genome = torch.tensor(random_genome(31))
    model = ReferenceQ(4)
    rng = np.random.default_rng(32)
    tree = {"model": {"y_q": rng.normal(0, 0.3, (4, 4)),
                      "y_station": rng.normal(0, 0.3, 4)},
            "branches": {"log_rates_l": 2.3 + rng.normal(0, 0.3, 5),
                         "log_rates_r": 2.3 + rng.normal(0, 0.3, 5)}}
    out = []
    for manual in (True, False):
        params = params_from_numpy(tree)
        gen = torch.Generator().manual_seed(33)
        res = sample_phylogenies(gen, genome, model, params,
                                 SweepConfig(K=8, manual_vjp=manual, **kw))
        (res.elbo + res.log_likelihood_R.sum()).backward()
        out.append((float(res.elbo.detach()), params_to_numpy(
            {g: {k: t.grad for k, t in sub.items()}
             for g, sub in params.items()})))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-12)
    _assert_trees_close(out[0][1], out[1][1])


def test_manual_vjp_rejects_data_gradients():
    """Leaves that require grad get their cotangent from the manual VJP
    (once refused): equal to plain autograd's with the same draws, and
    the parameter gradient with it (tests/test_torch_data_grads.py holds
    them to jax.grad)."""
    model = ReferenceQ(4)
    out = []
    for manual in (True, False):
        genome = torch.tensor(random_genome(41)).requires_grad_(True)
        params = {"model": model.init_params(torch.float64),
                  "branches": {"log_rates_l": torch.full(
                      (5,), 2.3, dtype=torch.float64, requires_grad=True),
                      "log_rates_r": torch.full((5,), 2.3,
                                                dtype=torch.float64)}}
        res = sample_phylogenies(torch.Generator().manual_seed(0), genome,
                                 model, params,
                                 SweepConfig(K=4, manual_vjp=manual))
        res.elbo.backward()
        out.append((genome.grad.numpy(),
                    params["branches"]["log_rates_l"].grad.numpy()))
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
        assert np.any(a != 0.0)
