"""Leaf and site-weight cotangents of the port's manual whole-sweep VJP
against jax.grad of phylo_tpu's sweep under the same injected decisions
(float64, 1e-8 relative): VCSMC on the saved-children route (K2) and the
re-gather route (K3, SAVE_CHILDREN_CAP forced to 0), VNCSMC (the pair
log-liks' leaf children and site-weight terms), and
SweepConfig(data_grads=False) under twist giving exact zeros."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.smc.sweep import SweepConfig as JConfig
from phylo_tpu.smc.sweep import sample_phylogenies as j_sample
from phylo_tpu.smc.twist import TwistConfig as JTwist
from phylo_tpu_torch.models.substitution import ReferenceQ
from phylo_tpu_torch.params import params_from_numpy
from phylo_tpu_torch.pruning import kernels as tk
from phylo_tpu_torch.smc import twist as tw
from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies

from test_torch_sweep import random_genome, setup_case, torch_decisions
from test_twist import make_twist_decisions

torch.set_num_threads(1)

N, S = 5, 12


def _weights(seed):
    return np.random.default_rng(seed).uniform(0.5, 1.5, S)


def _close(got, want, rtol=1e-8):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-11 * np.abs(want).max())
    assert np.abs(want).max() > 0


def _jax_data_grads(genome, w, jmodel, tree, dec, cfg):
    def elbo(leaves, sw):
        return j_sample(jax.random.PRNGKey(0), leaves, jmodel,
                        jax.tree.map(jnp.asarray, tree), cfg,
                        decisions=jax.tree.map(jnp.asarray, dec),
                        site_weights=sw).elbo

    return jax.tree.map(np.asarray, jax.grad(elbo, argnums=(0, 1))(
        jnp.asarray(genome), jnp.asarray(w)))


def _port_data_grads(genome, w, tree, dec, cfg):
    leaves = torch.tensor(genome, requires_grad=True)
    sw = torch.tensor(w, requires_grad=True)
    res = sample_phylogenies(None, leaves, ReferenceQ(4),
                             params_from_numpy(tree), cfg, decisions=dec,
                             site_weights=sw)
    res.elbo.backward()
    return leaves.grad.numpy(), sw.grad.numpy()


@pytest.fixture(scope="module")
def vcsmc():
    genome = random_genome(81, N=N, S=S)
    w = _weights(82)
    K = 6
    jmodel, _, tree, dec = setup_case(genome, "reference", K, seed=83)
    want = _jax_data_grads(genome, w, jmodel, tree, dec, JConfig(K=K))
    return dict(genome=genome, w=w, K=K, tree=tree, dec=dec, want=want)


@pytest.mark.parametrize("route", ["saved", "regather"])
def test_vcsmc_data_grads_match_jax_grad(vcsmc, route, monkeypatch):
    if route == "regather":
        monkeypatch.setattr(tk, "SAVE_CHILDREN_CAP", 0)
    got = _port_data_grads(vcsmc["genome"], vcsmc["w"], vcsmc["tree"],
                           torch_decisions(vcsmc["dec"]),
                           SweepConfig(K=vcsmc["K"], manual_vjp=True))
    for g, want in zip(got, vcsmc["want"]):
        _close(g, want)


@pytest.fixture(scope="module")
def vncsmc():
    genome = random_genome(91, N=N, S=S)
    w = _weights(92)
    K, M = 3, 2
    jmodel, _, tree, _ = setup_case(genome, "reference", K, seed=93)
    rng = np.random.default_rng(94)
    dec = jax.tree.map(np.asarray, make_twist_decisions(
        rng, N, K, M, np.exp(tree["branches"]["log_rates_l"]),
        np.exp(tree["branches"]["log_rates_r"])))
    want = _jax_data_grads(genome, w, jmodel, tree, dec,
                           JConfig(K=K, twist=JTwist(M=M)))
    return dict(genome=genome, w=w, K=K, M=M, tree=tree, dec=dec,
                want=want)


@pytest.mark.parametrize("pair_chunk", [None, 4])
def test_vncsmc_data_grads_match_jax_grad(vncsmc, pair_chunk):
    cfg = SweepConfig(K=vncsmc["K"], manual_vjp=True,
                      twist=tw.TwistConfig(M=vncsmc["M"],
                                           pair_chunk=pair_chunk))
    got = _port_data_grads(vncsmc["genome"], vncsmc["w"], vncsmc["tree"],
                           torch_decisions(vncsmc["dec"]), cfg)
    for g, want in zip(got, vncsmc["want"]):
        _close(g, want)


def test_twist_data_grads_off_gives_zeros(vncsmc):
    """data_grads=False under twist: exact zeros for the data, the
    parameter gradients unchanged."""
    out = []
    for flag in (True, False):
        cfg = SweepConfig(K=vncsmc["K"], manual_vjp=True, data_grads=flag,
                          twist=tw.TwistConfig(M=vncsmc["M"]))
        leaves = torch.tensor(vncsmc["genome"], requires_grad=True)
        sw = torch.tensor(vncsmc["w"], requires_grad=True)
        params = params_from_numpy(vncsmc["tree"])
        res = sample_phylogenies(None, leaves, ReferenceQ(4), params, cfg,
                                 decisions=torch_decisions(vncsmc["dec"]),
                                 site_weights=sw)
        res.elbo.backward()
        out.append((leaves.grad, sw.grad,
                    [t.grad for t in params["model"].values()]))
    assert torch.count_nonzero(out[1][0]) == 0
    assert torch.count_nonzero(out[1][1]) == 0
    assert torch.count_nonzero(out[0][0]) > 0
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)
