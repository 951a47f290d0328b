"""Training of the port: one SGD step against JAX's gradient applied by
hand (float64, injected decisions), the runner end to end on the CPU,
and every flag outside the slice rejected with its ROADMAP item."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylo_tpu.smc.sweep import SweepConfig as JConfig
from phylo_tpu.smc.sweep import sample_phylogenies as j_sample
from phylo_tpu_torch.cli import runner
from phylo_tpu_torch.dataio import load_dataset
from phylo_tpu_torch.params import params_from_numpy, params_to_numpy
from phylo_tpu_torch.smc.sweep import SweepConfig
from phylo_tpu_torch.train.trainer import (
    TrainConfig, _optimizer, param_tensors, sgd_step, step_generator, train,
)

from test_torch_sweep import random_genome, setup_case, torch_decisions

torch.set_num_threads(1)


def test_one_sgd_step_matches_jax_grad_applied_by_hand():
    genome = random_genome(51, N=5, S=20)
    K, lr = 6, 0.05
    jmodel, tmodel, tree, dec = setup_case(genome, "reference", K, seed=52)
    g = jax.grad(lambda p: -j_sample(
        jax.random.PRNGKey(0), jnp.asarray(genome), jmodel, p,
        JConfig(K=K), decisions=jax.tree.map(jnp.asarray, dec)).elbo)(
        jax.tree.map(jnp.asarray, tree))
    want = jax.tree.map(lambda p, d: np.asarray(p) - lr * np.asarray(d),
                        tree, g)

    params = params_from_numpy(tree)
    opt = _optimizer(TrainConfig(learning_rate=lr), param_tensors(params))
    loss = sgd_step(tmodel, params, opt, SweepConfig(K=K), None,
                    torch.tensor(genome), decisions=torch_decisions(dec))
    assert torch.isfinite(loss)
    got = params_to_numpy(params)
    for grp in want:
        for k in want[grp]:
            np.testing.assert_allclose(got[grp][k], want[grp][k],
                                       rtol=1e-10, atol=1e-12)


def test_step_generators_are_pure_functions():
    a = torch.rand(4, generator=step_generator(3, 1, 2, "cpu"))
    b = torch.rand(4, generator=step_generator(3, 1, 2, "cpu"))
    c = torch.rand(4, generator=step_generator(3, 1, 3, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_runner_cpu_smoke(tmp_path):
    res = runner.run(["--dataset=load_strings", "--n_particles=8",
                      "--num_epoch=2", "--batch_size=5", "--device=cpu",
                      f"--results_dir={tmp_path}"])
    assert np.isfinite(res.elbo)
    assert len(res.history["elbo"]) == 2
    for t in param_tensors(res.params):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    files = set(os.listdir(res.save_dir))
    assert {"results.p", "metrics.json", "run_parameters.txt"} <= files
    with open(os.path.join(res.save_dir, "metrics.json")) as f:
        assert len(json.load(f)["elbo"]) == 2


def test_console_script_exits_zero():
    """The phylo-tpu-torch script runs sys.exit(main()): a successful run
    must give exit status 0."""
    with pytest.raises(SystemExit) as exc:
        sys.exit(runner.main(["--dataset=load_strings", "--n_particles=4",
                              "--num_epoch=1", "--batch_size=5",
                              "--no_artifacts", "--device=cpu"]))
    assert exc.value.code in (None, 0)


def test_train_is_reproducible_on_cpu():
    ds = load_dataset("load_strings")
    cfg = TrainConfig(n_particles=6, batch_size=4, num_epoch=2,
                      save_artifacts=False, log_every=0, device="cpu",
                      dtype="float64", optimizer="adam", learning_rate=0.01)
    a, b = train(ds, cfg), train(ds, cfg)
    assert a.history["elbo"] == b.history["elbo"]


@pytest.mark.parametrize("flag,err,match", [
    ("--model=gtr+f", ValueError, "requires a PAML .dat or gy94"),
    ("--paml_dat=lg.dat", FileNotFoundError, "PAML .dat file not found"),
    ("--model=lg.dat", FileNotFoundError, "PAML .dat file not found"),
    ("--mesh=4", ValueError, "needs 4 devices"),
    ("--num_processes=2", ValueError, "coordinator"),
    ("--dtype=bfloat16", NotImplementedError, "ROADMAP.md"),
    ("--model=lg.dat+f", FileNotFoundError, "PAML .dat file not found"),
])
def test_flags_outside_the_slice_raise(flag, err, match):
    """--dtype=bfloat16 raises NotImplementedError naming the ROADMAP; a
    mesh larger than the process group and a process count without a
    coordinator raise ValueError; the PAML flags and specs of the
    protein slice raise JAX's errors on a missing .dat file and on '+f'
    over a base without frequencies to learn."""
    with pytest.raises(err, match=match):
        runner.main(["--dataset=load_strings", "--n_particles=4",
                     "--num_epoch=1", "--no_artifacts", "--device=cpu",
                     flag])
