"""VNCSMC (twisted) sweep of the port against the JAX package and the
NumPy oracle, in float64 under injected decisions (test_twist.py's
`make_twist_decisions`): per-rank log weights, log-likelihoods and the
ELBO (JAX 1e-9, oracle 1e-8), and the gradients of the manual twist VJP
and of plain autograd against jax.grad (1e-8).  Also the sampled path
(manual VJP against plain autograd on the same draws; its mean ELBO
against the JAX sampled path's within 3 standard errors), and the
runner's --nested flag on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.dataio import dataset_from_strings
from phylo_tpu.oracle.reference_vncsmc import OracleVNCSMC as JOracleVNCSMC
from phylo_tpu.smc.sweep import SweepConfig as JConfig
from phylo_tpu.smc.sweep import sample_phylogenies as j_sample
from phylo_tpu.smc.twist import TwistConfig as JTwist
from phylo_tpu.smc.twist import _prefix_order as j_prefix_order
from phylo_tpu_torch.cli import runner
from phylo_tpu_torch.models.substitution import ReferenceQ
from phylo_tpu_torch.oracle.reference_vncsmc import OracleVNCSMC
from phylo_tpu_torch.params import params_from_numpy, params_to_numpy
from phylo_tpu_torch.smc import twist as tw
from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies
from phylo_tpu_torch.train.trainer import param_tensors

from test_torch_sweep import random_genome, setup_case
from test_twist import STRINGS, make_twist_decisions

torch.set_num_threads(1)

FIELDS = ("log_weights", "log_likelihood", "elbo", "log_likelihood_R",
          "q_proposal")


def _grads(params):
    return params_to_numpy({g: {k: t.grad for k, t in sub.items()}
                            for g, sub in params.items()})


def _assert_trees_close(got, want, rtol=1e-8):
    for g in want:
        for k in want[g]:
            a, b = np.asarray(got[g][k]), np.asarray(want[g][k])
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-12 *
                                       max(1.0, np.abs(b).max()),
                                       err_msg=f"{g}/{k}")
            assert np.any(a != 0.0), f"{g}/{k} gradient is zero"


CASES = {
    # the 5-taxon strings of test_twist.py, K=4, M=3
    "strings": dict(genome=lambda: dataset_from_strings(STRINGS).genome,
                    K=4, M=3, seed=0),
    # 6 taxa, random sites with missing data, K=5, M=2
    "random": dict(genome=lambda: random_genome(61, N=6, S=16), K=5, M=2,
                   seed=62),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """numpy inputs, the JAX sweep's outputs and jax.grad of its ELBO."""
    c = CASES[request.param]
    genome, K, M = c["genome"](), c["K"], c["M"]
    N = genome.shape[0]
    jmodel, _, tree, _ = setup_case(genome, "reference", K, seed=c["seed"])
    rng = np.random.default_rng(c["seed"] + 1)
    dec = jax.tree.map(np.asarray, make_twist_decisions(
        rng, N, K, M, np.exp(tree["branches"]["log_rates_l"]),
        np.exp(tree["branches"]["log_rates_r"])))
    cfg = JConfig(K=K, twist=JTwist(M=M))

    def run(p):
        return j_sample(jax.random.PRNGKey(0), jnp.asarray(genome), jmodel,
                        p, cfg, decisions=jax.tree.map(jnp.asarray, dec))

    jtree = jax.tree.map(jnp.asarray, tree)
    want = run(jtree)
    want_g = jax.tree.map(np.asarray,
                          jax.grad(lambda p: run(p).elbo)(jtree))
    return dict(genome=genome, K=K, M=M, tree=tree, dec=dec, want=want,
                want_g=want_g, jmodel=jmodel)


def _port(case, manual_vjp=True, pair_chunk=None, requires_grad=True):
    params = params_from_numpy(case["tree"], requires_grad=requires_grad)
    res = sample_phylogenies(
        None, torch.tensor(case["genome"]), ReferenceQ(4), params,
        SweepConfig(K=case["K"], manual_vjp=manual_vjp,
                    twist=tw.TwistConfig(M=case["M"],
                                         pair_chunk=pair_chunk)),
        decisions={k: torch.tensor(v) for k, v in case["dec"].items()})
    return res, params


def test_prefix_tables_match_jax():
    for N in (2, 5, 12):
        order, inverse = tw._prefix_order(N)
        j_order, j_inverse = j_prefix_order(N)
        np.testing.assert_array_equal(order, j_order)
        np.testing.assert_array_equal(inverse, j_inverse)


@pytest.mark.parametrize("pair_chunk", [None, 3])
def test_twist_sweep_matches_jax(case, pair_chunk):
    got, _ = _port(case, pair_chunk=pair_chunk, requires_grad=False)
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(case["want"], f)),
            rtol=1e-9, atol=1e-12, err_msg=f)
    for f in ("merged_nodes", "v_minus", "ancestors"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(case["want"], f)))


def test_twist_sweep_matches_oracle(case):
    jmodel, tree = case["jmodel"], case["tree"]
    jparams = jax.tree.map(jnp.asarray, tree["model"])
    oracle = OracleVNCSMC(
        case["genome"], np.asarray(jmodel.Q(jparams)),
        np.asarray(jmodel.stationary(jparams)),
        np.exp(tree["branches"]["log_rates_l"]),
        np.exp(tree["branches"]["log_rates_r"]), case["K"], M=case["M"])
    want = oracle.run(case["dec"])
    got, _ = _port(case, requires_grad=False)
    for f in ("log_weights", "log_likelihood", "elbo"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)), want[f],
                                   rtol=1e-8, err_msg=f)


def test_oracle_copy_matches_jax_package_copy(case):
    """The port's NumPy oracles (phylo_tpu_torch.oracle) are copies of the
    JAX package's: the same outputs, bit for bit, on a fixed-decision
    run (VNCSMC, and its VCSMC base class through it)."""
    jmodel, tree = case["jmodel"], case["tree"]
    jparams = jax.tree.map(jnp.asarray, tree["model"])
    args = (case["genome"], np.asarray(jmodel.Q(jparams)),
            np.asarray(jmodel.stationary(jparams)),
            np.exp(tree["branches"]["log_rates_l"]),
            np.exp(tree["branches"]["log_rates_r"]), case["K"])
    got = OracleVNCSMC(*args, M=case["M"]).run(case["dec"])
    want = JOracleVNCSMC(*args, M=case["M"]).run(case["dec"])
    assert set(got) == set(want)
    for f in want:
        np.testing.assert_array_equal(np.asarray(got[f]),
                                      np.asarray(want[f]), err_msg=f)


@pytest.mark.parametrize("manual_vjp", [True, False])
def test_twist_grads_match_jax_grad(case, manual_vjp):
    res, params = _port(case, manual_vjp=manual_vjp)
    res.elbo.backward()
    _assert_trees_close(_grads(params), case["want_g"])


@pytest.mark.parametrize("pair_chunk", [None, 4])
def test_manual_twist_vjp_matches_plain_autograd(pair_chunk):
    """No decisions: pools are eps / rate, so the rates also get the
    pathwise gradient through every candidate's transitions; both routes
    draw the same pools, ancestors and choices from equal generators."""
    genome = torch.tensor(random_genome(71, N=6, S=20))
    rng = np.random.default_rng(72)
    tree = {"model": {"y_q": rng.normal(0, 0.3, (4, 4)),
                      "y_station": rng.normal(0, 0.3, 4)},
            "branches": {"log_rates_l": 2.3 + rng.normal(0, 0.3, 5),
                         "log_rates_r": 2.3 + rng.normal(0, 0.3, 5)}}
    out = []
    for manual in (True, False):
        params = params_from_numpy(tree)
        gen = torch.Generator().manual_seed(73)
        res = sample_phylogenies(
            gen, genome, ReferenceQ(4), params,
            SweepConfig(K=6, manual_vjp=manual,
                        twist=tw.TwistConfig(M=3, pair_chunk=pair_chunk)))
        (res.elbo + res.log_likelihood_R.sum()
         + res.q_proposal.sum()).backward()
        out.append((res, _grads(params)))
    (a, ga), (b, gb) = out
    np.testing.assert_array_equal(a.merged_nodes.numpy(),
                                  b.merged_nodes.numpy())
    assert float(a.elbo.detach()) == pytest.approx(float(b.elbo.detach()),
                                                 rel=1e-12)
    _assert_trees_close(ga, gb)


def test_twist_sampled_path_is_seeded_and_valid():
    genome = torch.tensor(random_genome(81, N=6, S=12))
    model = ReferenceQ(4)
    params = params_from_numpy({
        "model": {"y_q": np.full((4, 4), 0.25) * (1 - np.eye(4)),
                  "y_station": np.full(4, 0.25)},
        "branches": {"log_rates_l": np.full(5, 2.3),
                     "log_rates_r": np.full(5, 2.3)}}, requires_grad=False)
    cfg = SweepConfig(K=8, twist=tw.TwistConfig(M=2))
    runs = [sample_phylogenies(torch.Generator().manual_seed(82), genome,
                               model, params, cfg) for _ in range(2)]
    assert torch.equal(runs[0].log_weights, runs[1].log_weights)
    res = runs[0]
    assert torch.isfinite(res.elbo)
    assert bool((res.q_proposal <= 0).all())   # log probabilities
    merged = res.merged_nodes.numpy()
    N = genome.shape[0]
    assert (merged >= 0).all() and (merged < 2 * N - 1).all()
    assert (merged[:, :, 0] != merged[:, :, 1]).all()


def test_twist_sampled_elbo_matches_jax_in_distribution():
    """The sampled paths draw from different streams (Gumbel-max from a
    torch.Generator against jax.random.categorical), so hold the law:
    mean ELBO over 48 seeds each within 3 combined standard errors."""
    from phylo_tpu.models.substitution import ReferenceQ as JRefQ

    ds = dataset_from_strings(STRINGS)
    N, K, M, n = ds.N, 8, 2, 48
    jmodel = JRefQ(A=4)
    tree = {"model": jax.tree.map(np.array,
                                  jmodel.init_params(jnp.float64)),
            "branches": {"log_rates_l": np.full(N - 1, np.log(10.0)),
                         "log_rates_r": np.full(N - 1, np.log(10.0))}}
    cfg = JConfig(K=K, twist=JTwist(M=M))
    leaves = jnp.asarray(ds.genome)
    jparams = jax.tree.map(jnp.asarray, tree)
    run = jax.jit(lambda key: j_sample(key, leaves, jmodel, jparams,
                                       cfg).elbo)
    e_jax = np.array([float(run(k)) for k in
                      jax.random.split(jax.random.PRNGKey(0), n)])
    params = params_from_numpy(tree, requires_grad=False)
    tcfg = SweepConfig(K=K, twist=tw.TwistConfig(M=M))
    genome = torch.tensor(ds.genome)
    e_port = np.array([float(sample_phylogenies(
        torch.Generator().manual_seed(s), genome, ReferenceQ(4), params,
        tcfg).elbo) for s in range(n)])
    se = np.sqrt(e_jax.var(ddof=1) / n + e_port.var(ddof=1) / n)
    assert abs(e_jax.mean() - e_port.mean()) <= 3.0 * se


def test_lex_choice_maps_to_prefix():
    N, M = 6, 3
    lex = tw.upper_tri_pairs(N)
    pref = lex[tw._prefix_order(N)[0]]
    choice = torch.arange(len(lex) * M)
    got = tw.lex_to_prefix_choice(choice, N, M).numpy()
    np.testing.assert_array_equal(pref[got // M], lex[choice.numpy() // M])
    np.testing.assert_array_equal(got % M, choice.numpy() % M)


def test_runner_nested_cpu(tmp_path):
    res = runner.run(["--dataset=load_strings", "--n_particles=4",
                      "--num_epoch=2", "--batch_size=5", "--device=cpu",
                      "--nested=True", "--M=3", f"--results_dir={tmp_path}"])
    assert np.isfinite(res.elbo)
    assert len(res.history["elbo"]) == 2
    for t in param_tensors(res.params):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert bool((t.grad != 0).any())
    assert "/True/4/" in res.save_dir
