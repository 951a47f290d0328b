"""The port's sweep against phylo_tpu's sample_phylogenies in float64
under the same injected decisions (golden parity, 1e-9): per-rank log
weights and log-likelihoods, the ELBO and the de-biased log-likelihood,
for JC69 and ReferenceQ and the reference-quirk / estimator flags.  Both
of the port's routes are held: the no-grad kernel-path sweep (plain K1
on the CPU) and plain autograd through the sweep."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.models.branches import init_branch_params as j_branches
from phylo_tpu.models.substitution import JC69 as JJC69
from phylo_tpu.models.substitution import ReferenceQ as JRefQ
from phylo_tpu.smc.sweep import SweepConfig as JConfig
from phylo_tpu.smc.sweep import sample_phylogenies as j_sample
from phylo_tpu_torch.models.substitution import JC69, ReferenceQ
from phylo_tpu_torch.params import params_from_numpy
from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies

torch.set_num_threads(1)

STRINGS = ["ACTTTGAGAG", "ACTTTGACAG", "ACTTTGACTG", "ACTTTGACTC"]


def make_decisions(rng, N, K, rates_l, rates_r):
    """Pre-drawn sweep randomness, as numpy arrays (the JAX package's
    golden-parity helper)."""
    R = N - 1
    ancestors = np.zeros((R, K), dtype=np.int32)
    pairs = np.zeros((R, K, 2), dtype=np.int32)
    branches_l = np.zeros((R, K))
    branches_r = np.zeros((R, K))
    for r in range(R):
        ancestors[r] = rng.integers(0, K, size=K)
        for k in range(K):
            pairs[r, k] = rng.choice(N - r, size=2, replace=False)
        branches_l[r] = rng.exponential(1.0 / rates_l[r], size=K)
        branches_r[r] = rng.exponential(1.0 / rates_r[r], size=K)
    return dict(ancestors=ancestors, pairs=pairs, branches_l=branches_l,
                branches_r=branches_r)


def setup_case(genome, model_name, K, seed):
    """(jax model, torch model, numpy params, numpy decisions)."""
    N, _, A = genome.shape
    rng = np.random.default_rng(seed)
    jmodel = JRefQ(A=A) if model_name == "reference" else JJC69(A=A)
    tmodel = ReferenceQ(A) if model_name == "reference" else JC69(A)
    tree = jax.tree.map(np.asarray, {
        "model": jmodel.init_params(jnp.float64),
        "branches": j_branches(N, dtype=jnp.float64)})
    for key in ("log_rates_l", "log_rates_r"):
        tree["branches"][key] = tree["branches"][key] + rng.normal(
            0, 0.3, N - 1)
    if model_name == "reference":
        tree["model"]["y_q"] = tree["model"]["y_q"] + rng.normal(
            0, 0.2, (A, A))
        tree["model"]["y_station"] = tree["model"]["y_station"] + \
            rng.normal(0, 0.2, A)
    dec = make_decisions(rng, N, K, np.exp(tree["branches"]["log_rates_l"]),
                         np.exp(tree["branches"]["log_rates_r"]))
    return jmodel, tmodel, tree, dec


def random_genome(seed, N=6, S=40, A=4):
    rng = np.random.default_rng(seed)
    g = np.eye(A)[rng.integers(0, A, (N, S))]
    g[0, :3] = 1.0                                # a few missing sites
    return g


def jax_sweep(genome, jmodel, tree, dec, K, **kw):
    return j_sample(jax.random.PRNGKey(0), jnp.asarray(genome), jmodel,
                    jax.tree.map(jnp.asarray, tree), JConfig(K=K, **kw),
                    decisions=jax.tree.map(jnp.asarray, dec))


def torch_decisions(dec):
    return {k: torch.as_tensor(v) for k, v in dec.items()}


FIELDS = ("log_weights", "log_likelihood", "elbo", "log_likelihood_R")


def assert_parity(got, want, rtol=1e-9):
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(got, f).detach().numpy(), np.asarray(getattr(want, f)),
            rtol=rtol, atol=1e-12, err_msg=f)
    np.testing.assert_array_equal(got.v_minus.numpy(),
                                  np.asarray(want.v_minus))
    np.testing.assert_array_equal(got.merged_nodes.numpy(),
                                  np.asarray(want.merged_nodes))


@pytest.mark.parametrize("model_name", ["jc69", "reference"])
@pytest.mark.parametrize("genome_name", ["strings", "random"])
def test_sweep_matches_jax(model_name, genome_name):
    from phylo_tpu_torch.dataio import dataset_from_strings

    genome = (dataset_from_strings(STRINGS).genome
              if genome_name == "strings" else random_genome(1))
    K = 6
    jmodel, tmodel, tree, dec = setup_case(genome, model_name, K, seed=2)
    want = jax_sweep(genome, jmodel, tree, dec, K)
    got = sample_phylogenies(
        None, torch.tensor(genome), tmodel,
        params_from_numpy(tree, requires_grad=False), SweepConfig(K=K),
        decisions=torch_decisions(dec))
    assert_parity(got, want)


@pytest.mark.parametrize("kw", [
    dict(q_raw_subtraction=False),
    dict(resample_branch_history=True),
    dict(right_multiplier_bug=False),
    dict(carried_weights=True),
    dict(ess_threshold=0.6, carried_weights=True),
    dict(rescale=False),
])
def test_sweep_flags_match_jax(kw):
    genome = random_genome(4, N=5, S=24)
    K = 5
    jmodel, tmodel, tree, dec = setup_case(genome, "reference", K, seed=5)
    want = jax_sweep(genome, jmodel, tree, dec, K, **kw)
    got = sample_phylogenies(
        None, torch.tensor(genome), tmodel,
        params_from_numpy(tree, requires_grad=False),
        SweepConfig(K=K, **kw), decisions=torch_decisions(dec))
    assert_parity(got, want)


def test_plain_autograd_route_matches_jax():
    """The differentiable plain sweep (manual_vjp=False) computes the
    same values as the no-grad kernel-path sweep and JAX."""
    genome = random_genome(6)
    K = 7
    jmodel, tmodel, tree, dec = setup_case(genome, "reference", K, seed=7)
    want = jax_sweep(genome, jmodel, tree, dec, K)
    got = sample_phylogenies(
        None, torch.tensor(genome), tmodel, params_from_numpy(tree),
        SweepConfig(K=K, manual_vjp=False), decisions=torch_decisions(dec))
    assert got.elbo.requires_grad
    assert_parity(got, want)


def test_sweep_site_weights_match_jax():
    genome = random_genome(8, S=30)
    K = 4
    w = np.random.default_rng(9).uniform(0.0, 2.0, 30)
    jmodel, tmodel, tree, dec = setup_case(genome, "jc69", K, seed=9)
    want = j_sample(jax.random.PRNGKey(0), jnp.asarray(genome), jmodel,
                    jax.tree.map(jnp.asarray, tree), JConfig(K=K),
                    decisions=jax.tree.map(jnp.asarray, dec),
                    site_weights=jnp.asarray(w))
    got = sample_phylogenies(
        None, torch.tensor(genome), tmodel,
        params_from_numpy(tree, requires_grad=False), SweepConfig(K=K),
        decisions=torch_decisions(dec), site_weights=torch.tensor(w))
    assert_parity(got, want)


def test_random_sweep_is_seeded_and_valid():
    """Without decisions the sweep draws from the given generator: the
    same seed gives the same sweep, ancestors are in range and the
    ELBO is finite."""
    genome = torch.tensor(random_genome(10))
    model = ReferenceQ(4)
    params = {"model": model.init_params(torch.float64),
              "branches": {"log_rates_l": torch.full((5,), 2.3,
                                                     dtype=torch.float64),
                           "log_rates_r": torch.full((5,), 2.3,
                                                     dtype=torch.float64)}}
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(11)
        outs.append(sample_phylogenies(gen, genome, model, params,
                                       SweepConfig(K=8)))
    assert torch.equal(outs[0].log_weights, outs[1].log_weights)
    assert torch.isfinite(outs[0].elbo)
    assert int(outs[0].ancestors.min()) >= 0
    assert int(outs[0].ancestors.max()) < 8
