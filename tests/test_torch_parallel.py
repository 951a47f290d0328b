"""The port on a device mesh (phylo_tpu_torch.parallel) over gloo on the
CPU, in float64.

In process: `pad_sites` against the JAX package's, `make_mesh`'s shapes
and errors, `initialize_distributed` without configuration.

Multi-process: this file is its own worker.  One spawn per mesh layout
-- ('s',) 2, ('k',) 2 and ('k', 's') (2, 2) -- runs every case inside
it: VCSMC under injected decisions (values, and the gradients of the
manual VJP and of plain autograd), a seeded sweep with no decisions, and
on the layouts with an 's' axis VNCSMC's value and gradients; the
('s',) 2 spawn first trains through `runner.main` with --mesh=2 and the
multi-process flags (rank 0 alone writes) and then trains on an odd
number of sites.  The JAX references run in this (the parent) process,
the port's one-process references too; the workers import torch only.
Bars: the JAX single-device sweep 1e-9 (gradients 1e-8), the port's
one process 1e-10 (training's ELBO history 1e-9).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, S, K, M = 5, 13, 4, 2
LAYOUTS = {"s2": ((2,), ("s",)), "k2": ((2,), ("k",)),
           "ks22": ((2, 2), ("k", "s"))}
TRAIN = dict(n_particles=4, batch_size=7, num_epoch=2, optimizer="adam",
             learning_rate=0.01, dtype="float64", device="cpu",
             save_artifacts=False, collect_trees=False, log_every=0)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _inputs(seed=3):
    """numpy genome (N, S, 4), params tree and decisions (VCSMC, VNCSMC),
    without JAX: the port's parameter layout is the JAX package's."""
    rng = np.random.default_rng(seed)
    genome = np.eye(4)[rng.integers(0, 4, (N, S))]
    genome[0, 2] = 1.0                              # a missing site
    tree = {"model": {"y_q": rng.normal(0, 0.3, (4, 4)),
                      "y_station": rng.normal(0, 0.3, 4)},
            "branches": {"log_rates_l": 2.3 + rng.normal(0, 0.3, N - 1),
                         "log_rates_r": 2.3 + rng.normal(0, 0.3, N - 1)}}
    rl = np.exp(tree["branches"]["log_rates_l"])
    rr = np.exp(tree["branches"]["log_rates_r"])
    R = N - 1
    dec = dict(ancestors=rng.integers(0, K, (R, K)).astype(np.int32),
               pairs=np.stack([np.stack([rng.choice(N - r, 2, replace=False)
                                         for _ in range(K)])
                               for r in range(R)]).astype(np.int32),
               branches_l=rng.exponential(1.0, (R, K)) / rl[:, None],
               branches_r=rng.exponential(1.0, (R, K)) / rr[:, None])
    lex = np.asarray([(i, j) for i in range(N) for j in range(i + 1, N)])
    P = len(lex)
    tdec = dict(
        ancestors=dec["ancestors"],
        twist_pool_l=rng.exponential(1.0, (R, P, M, K)) / rl[:, None, None,
                                                             None],
        twist_pool_r=rng.exponential(1.0, (R, P, M, K)) / rr[:, None, None,
                                                             None],
        twist_choice=np.stack([
            rng.choice(np.flatnonzero(lex[:, 1] < N - r), K) * M
            + rng.integers(0, M, K) for r in range(R)]).astype(np.int32),
        pairs=np.zeros((R, K, 2), np.int32), branches_l=np.zeros((R, K)),
        branches_r=np.zeros((R, K)))
    return genome, tree, dec, tdec


def _flat_grads(params):
    from phylo_tpu_torch.params import flatten

    return np.concatenate([t.grad.numpy().ravel()
                           for t in flatten(params)[1]])


def _port_cases(leaves, weights, shardings, with_twist):
    """{name: array} of every sweep case on this process's block."""
    from phylo_tpu_torch.models.substitution import ReferenceQ
    from phylo_tpu_torch.params import params_from_numpy
    from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies
    from phylo_tpu_torch.smc.twist import TwistConfig

    _, tree, dec, tdec = _inputs()
    model = ReferenceQ(4)
    out = {}
    cases = [("vcsmc", dec, SweepConfig(K=K))]
    if with_twist:
        cases.append(("vncsmc", tdec,
                      SweepConfig(K=K, twist=TwistConfig(M=M))))
    for name, d, cfg in cases:
        dt = {k: torch.as_tensor(v) for k, v in d.items()}
        with torch.no_grad():
            res = sample_phylogenies(None, leaves, model,
                                     params_from_numpy(tree), cfg,
                                     decisions=dt, site_weights=weights,
                                     shardings=shardings)
        out[f"{name}_lw"] = res.log_weights.numpy()
        out[f"{name}_elbo"] = res.elbo.numpy()
        for manual in (True, False):
            params = params_from_numpy(tree)
            cfg_g = SweepConfig(K=K, manual_vjp=manual, twist=cfg.twist)
            sample_phylogenies(None, leaves, model, params, cfg_g,
                               decisions=dt, site_weights=weights,
                               shardings=shardings).elbo.backward()
            out[f"{name}_grad_{'manual' if manual else 'autograd'}"] = \
                _flat_grads(params)
    with torch.no_grad():
        res = sample_phylogenies(torch.Generator().manual_seed(11), leaves,
                                 model, params_from_numpy(tree),
                                 SweepConfig(K=K), site_weights=weights,
                                 shardings=shardings)
    out["seeded_lw"] = res.log_weights.numpy()
    out["seeded_anc"] = res.ancestors.numpy()
    return out


def _train_dataset():
    from phylo_tpu_torch.dataio.datasets import PhyloDataset

    genome = _inputs(seed=5)[0]
    return PhyloDataset(name="mesh", taxa=[f"T{i}" for i in range(N)],
                        genome=genome)


def worker(layout, port, rank, world, out_path, results_dir):
    from phylo_tpu_torch.parallel import (
        initialize_distributed, make_mesh, pad_sites, shard_leaves,
        sweep_sharding,
    )

    address = f"localhost:{port}"
    out = {}
    if layout == "s2":
        # the runner joins the process group itself
        from phylo_tpu_torch.cli import runner

        runner.main(["--dataset=load_strings", "--n_particles=4",
                     "--num_epoch=1", "--batch_size=5", "--device=cpu",
                     "--mesh=2", f"--coordinator={address}",
                     f"--num_processes={world}", f"--process_id={rank}",
                     f"--results_dir={results_dir}"])
    else:
        initialize_distributed(address, world, rank, device="cpu")
    shape, names = LAYOUTS[layout]
    sh = sweep_sharding(make_mesh(shape, names, device="cpu"))
    genome = _inputs()[0]
    padded, w = pad_sites(genome, sh.site_multiple())
    leaves = torch.tensor(shard_leaves(padded, sh))
    weights = torch.tensor(w[sh.sites(len(w))])
    out.update(_port_cases(leaves, weights, sh, "s" in names))
    if layout == "s2":
        from phylo_tpu_torch.train import TrainConfig, train

        res = train(_train_dataset(), TrainConfig(mesh_shape=(2,), **TRAIN))
        out["train_elbo"] = np.asarray(res.history["elbo"])
    np.savez(out_path, **out)


def _spawn(layout, tmp):
    world = int(np.prod(LAYOUTS[layout][0]))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    procs = []
    for rank in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), layout, str(port),
             str(rank), str(world), str(tmp / f"{layout}_{rank}.npz"),
             str(tmp / "runner")], env=env, cwd=str(tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every layout's workers, started at once."""
    tmp = tmp_path_factory.mktemp("mesh")
    return tmp, {lay: _spawn(lay, tmp) for lay in LAYOUTS}


@pytest.fixture(scope="module")
def mesh_runs(spawned, jax_ref, port_ref):
    """The workers' outputs by layout and rank (the references are made
    in this process while the workers run)."""
    tmp, procs = spawned
    out = {}
    for lay, ps in procs.items():
        for rank, p in enumerate(ps):
            log, _ = p.communicate(timeout=300)
            assert p.returncode == 0, f"{lay} rank {rank}:\n{log}"
        out[lay] = [dict(np.load(tmp / f"{lay}_{r}.npz"))
                    for r in range(len(ps))]
    out["runner_dir"] = tmp / "runner"
    return out


@pytest.fixture(scope="module")
def port_ref():
    """The port's one-process outputs (no mesh)."""
    genome = _inputs()[0]
    return _port_cases(torch.tensor(genome), None, None, True)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's single-device sweep: values and jax.grad."""
    import jax
    import jax.numpy as jnp

    from phylo_tpu.models.substitution import ReferenceQ as JRefQ
    from phylo_tpu.smc.sweep import SweepConfig as JConfig
    from phylo_tpu.smc.sweep import sample_phylogenies as j_sample
    from phylo_tpu.smc.twist import TwistConfig as JTwist

    genome, tree, dec, tdec = _inputs()
    out = {}
    for name, d, cfg in (("vcsmc", dec, JConfig(K=K)),
                         ("vncsmc", tdec, JConfig(K=K,
                                                  twist=JTwist(M=M)))):
        def run(p, d=d, cfg=cfg):
            return j_sample(jax.random.PRNGKey(0), jnp.asarray(genome),
                            JRefQ(A=4), p, cfg,
                            decisions=jax.tree.map(jnp.asarray, d))

        jt = jax.tree.map(jnp.asarray, tree)
        res = run(jt)
        out[f"{name}_lw"] = np.asarray(res.log_weights)
        out[f"{name}_elbo"] = np.asarray(res.elbo)
        g = jax.grad(lambda p: run(p).elbo)(jt)
        # the port's flatten order: sorted keys, depth first
        out[f"{name}_grad"] = np.concatenate([
            np.asarray(g[top][k]).ravel() for top in ("branches", "model")
            for k in sorted(g[top])])
    return out


def _close(a, b, rtol):
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_vcsmc_matches_jax_and_one_process(mesh_runs, jax_ref,
                                                port_ref, layout):
    for got in mesh_runs[layout]:
        for f in ("vcsmc_lw", "vcsmc_elbo"):
            _close(got[f], jax_ref[f], 1e-9)
            _close(got[f], port_ref[f], 1e-10)
        for route in ("manual", "autograd"):
            g = got[f"vcsmc_grad_{route}"]
            _close(g, jax_ref["vcsmc_grad"], 1e-8)
            _close(g, port_ref[f"vcsmc_grad_{route}"], 1e-10)
        # every rank holds the whole result, and the same gradients
        for f in got:
            np.testing.assert_array_equal(got[f], mesh_runs[layout][0][f])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_seeded_sweep_repeats_one_process(mesh_runs, port_ref, layout):
    for got in mesh_runs[layout]:
        np.testing.assert_array_equal(got["seeded_anc"],
                                      port_ref["seeded_anc"])
        _close(got["seeded_lw"], port_ref["seeded_lw"], 1e-10)


@pytest.mark.parametrize("layout", ["s2", "ks22"])
def test_mesh_vncsmc_matches_jax_and_one_process(mesh_runs, jax_ref,
                                                 port_ref, layout):
    for got in mesh_runs[layout]:
        for f in ("vncsmc_lw", "vncsmc_elbo"):
            _close(got[f], jax_ref[f], 1e-9)
            _close(got[f], port_ref[f], 1e-10)
        for route in ("manual", "autograd"):
            g = got[f"vncsmc_grad_{route}"]
            _close(g, jax_ref["vncsmc_grad"], 1e-8)
            _close(g, port_ref[f"vncsmc_grad_{route}"], 1e-10)


def test_train_with_mesh_uneven_sites(mesh_runs):
    """13 sites over an 's' mesh of 2 (batches of 7 padded to 8): the
    ELBO history of the unsharded run to 1e-9; rank 0 alone writes."""
    from phylo_tpu_torch.train import TrainConfig, train

    want = train(_train_dataset(), TrainConfig(mesh_shape=None, **TRAIN))
    r0, r1 = mesh_runs["s2"]
    for got in (r0, r1):
        _close(got["train_elbo"], np.asarray(want.history["elbo"]), 1e-9)
    np.testing.assert_array_equal(r0["train_elbo"], r1["train_elbo"])


def test_runner_mesh_two_processes_rank0_writes(mesh_runs):
    runs = [os.path.join(d, f) for d, _, fs in os.walk(
        mesh_runs["runner_dir"]) for f in fs if f == "run_parameters.txt"]
    assert len(runs) == 1, runs
    assert os.path.exists(os.path.join(os.path.dirname(runs[0]),
                                       "results.p"))


def test_pad_sites_matches_jax():
    from phylo_tpu.parallel import pad_sites as j_pad
    from phylo_tpu_torch.parallel import pad_sites

    genome = _inputs()[0]
    for mult in (1, 2, 4, 5):
        for w in (None, np.linspace(0.5, 1.5, S)):
            got, want = pad_sites(genome, mult, w), j_pad(genome, mult, w)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, np.asarray(b))
                assert np.asarray(a).dtype == np.asarray(b).dtype


def test_make_mesh_shapes_and_errors():
    """A world of one: a 1-element shape is a pure site mesh, and a shape
    needing more processes than the world raises JAX's message."""
    import torch.distributed as dist

    from phylo_tpu_torch.parallel import make_mesh, sweep_sharding

    with pytest.raises(ValueError, match=r"needs 4 devices, have 1"):
        make_mesh((4,), device="cpu")
    with pytest.raises(ValueError, match=r"needs 2 devices, have 1"):
        make_mesh((1, 2), device="cpu")
    assert not dist.is_initialized()
    try:
        mesh = make_mesh((1,), device="cpu")
        assert mesh.axis_names == ("s",) and mesh.shape == {"s": 1}
        assert make_mesh(device="cpu").shape == {"s": 1}
        km = make_mesh((1, 1), device="cpu")
        assert km.axis_names == ("k", "s")
        sh = sweep_sharding(mesh)
        assert sh.site_multiple() == 1 and sh.sites(13) == slice(0, 13)
        assert sh.particles(6) == slice(0, 6) and not sh.has_k
    finally:
        dist.destroy_process_group()


def test_initialize_distributed_noop_and_errors(monkeypatch):
    from phylo_tpu_torch.parallel import (
        initialize_distributed, is_multiprocess, process_summary,
    )

    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert not is_multiprocess()
    assert process_summary().startswith("process 0/1")
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(num_processes=2, process_id=0)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed()


def test_k_not_a_multiple_is_refused():
    from phylo_tpu_torch.parallel.mesh import Mesh
    from phylo_tpu_torch.parallel.sharding import SweepSharding

    sh = SweepSharding(Mesh(("k", "s"), {"k": 2, "s": 1}, {"k": 0, "s": 0},
                            {}))
    with pytest.raises(ValueError, match="multiple"):
        sh.particles(5)
    assert sh.particles(6) == slice(0, 3)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
           int(sys.argv[4]), sys.argv[5], sys.argv[6])
