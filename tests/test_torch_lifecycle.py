"""A training run's life cycle in the port, on the CPU: checkpoints and
resume (bit for bit, also after a SIGKILL), the elastic supervisor, the
tree tools and cli.trees against the JAX package's, the best particle's
Newick, seed replicas, the sweep runner, profiling and plots.

Run as a script, this file is the SIGKILL test's worker process:
    python tests/test_torch_lifecycle.py CKPT_DIR OUT_PICKLE EPOCHS [FAULT]
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from phylo_tpu_torch.cli import runner, sweep_runner
from phylo_tpu_torch.cli import trees as trees_cli
from phylo_tpu_torch.dataio import dataset_from_strings, load_dataset
from phylo_tpu_torch.train import TrainConfig, train, train_elastic
from phylo_tpu_torch.train.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint,
)
from phylo_tpu_torch.train.replicas import train_replicas
from phylo_tpu_torch.train.trainer import (
    _optimizer, _sweep_config, best_newick, init_params, param_tensors,
    sgd_step, step_generator,
)
from phylo_tpu_torch.utils import profiling
from phylo_tpu_torch.viz import trees

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIMATES = ["Tarsius_syrichta", "Lemur_catta", "Homo_sapiens", "Pan",
            "Gorilla", "Pongo", "Hylobates", "Macaca_fuscata", "M_mulatta",
            "M_fascicularis", "M_sylvanus", "Saimiri_sciureus"]


def taxa_of(N):
    return PRIMATES if N == 12 else [f"t{i}" for i in range(N)]


def seeded_records(N, K, seed):
    """Valid sweep records: (ancestors (R, K), merged_nodes (R, K, 2),
    left and right branches, log weights), from resampling and merging
    each particle's forest of roots (node N + r is rank r's merge)."""
    rng = np.random.default_rng(seed)
    R = N - 1
    ancestors = np.zeros((R, K), dtype=np.int32)
    merged = np.zeros((R, K, 2), dtype=np.int32)
    roots = [list(range(N)) for _ in range(K)]
    for r in range(R):
        idx = np.arange(K) if r == 0 else rng.integers(0, K, K)
        ancestors[r] = idx
        roots = [list(roots[i]) for i in idx]
        for k in range(K):
            a, b = rng.choice(len(roots[k]), 2, replace=False)
            n1, n2 = roots[k][a], roots[k][b]
            merged[r, k] = (n1, n2)
            roots[k].remove(n1)
            roots[k].remove(n2)
            roots[k].append(N + r)
    lb = rng.exponential(0.1, (R, K))
    rb = rng.exponential(0.1, (R, K))
    lw = rng.normal(0.0, 2.0, (R, K))
    return ancestors, merged, lb, rb, lw


def random_strings(seed, N=5, S=20):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGT"), S)) for _ in range(N)]


def cfg(**kw):
    base = dict(n_particles=6, batch_size=5, num_epoch=3, learning_rate=0.05,
                optimizer="adam", dtype="float64", seed=3,
                save_artifacts=False, log_every=0, device="cpu")
    base.update(kw)
    return TrainConfig(**base)


def assert_same_bits(a, b):
    ta, tb = param_tensors(a), param_tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.detach().cpu().numpy().tobytes() == \
            y.detach().cpu().numpy().tobytes()


def state_bits(sd):
    """An optimizer state_dict with every tensor replaced by its bytes."""
    if isinstance(sd, torch.Tensor):
        return (sd.dtype, tuple(sd.shape), sd.cpu().numpy().tobytes())
    if isinstance(sd, dict):
        return {k: state_bits(v) for k, v in sd.items()}
    if isinstance(sd, (list, tuple)):
        return [state_bits(v) for v in sd]
    return sd


# ------------------------------------------------- tree tools against JAX
def _tree_outputs(mod, N, K=16):
    taxa = taxa_of(N)
    anc, merged, lb, rb, lw = seeded_records(N, K, seed=N)
    gen = mod.decode_genealogy(anc, merged, lb, rb)
    bare = mod.decode_genealogy(anc, merged)
    sup = mod.majority_consensus(taxa, gen, lw[-1])[1]
    return {
        "decode": [{k: v.tolist() for k, v in rec.items()} for rec in gen],
        "newick": [mod.to_newick(taxa, rec) for rec in gen]
        + [mod.to_newick(taxa, rec) for rec in bare],
        "nexus": [mod.to_nexus(taxa, gen[:5]),
                  mod.to_nexus(taxa, gen[:3], probs=[0.5, 0.25, 0.125],
                               names=["a", "b", "c"])],
        "jump_chains": mod.jump_chain_evolution(taxa, anc, merged),
        "name_chains": mod.merge_name_chains(taxa, gen),
        "probabilities": mod.tree_probabilities(taxa, gen, lw[-1]),
        "consensus": [mod.majority_consensus(taxa, gen, lw[-1]),
                      mod.majority_consensus(taxa, gen),
                      mod.majority_consensus(taxa, gen, lw[-1], 0.7),
                      mod.consensus_from_supports(taxa, sup, 0.6)],
        "robinson_foulds": [
            mod.robinson_foulds(taxa, gen[i], gen[j], normalized=nz,
                                rooted=ro)
            for i in range(4) for j in range(4)
            for nz in (False, True) for ro in (False, True)],
    }


@pytest.mark.parametrize("what", ["decode", "newick", "nexus", "jump_chains",
                                  "name_chains", "probabilities",
                                  "consensus", "robinson_foulds"])
@pytest.mark.parametrize("N", [5, 12])
def test_tree_tools_equal_jax(N, what):
    from phylo_tpu.viz import trees as jtrees

    assert _tree_outputs(trees, N)[what] == _tree_outputs(jtrees, N)[what]


def test_viz_exports_match_jax():
    import phylo_tpu.viz as jviz
    import phylo_tpu_torch.viz as tviz

    # submodules appear in dir() once imported anywhere in the process
    names = {n for n in dir(jviz) if not n.startswith("_")} - {
        "trees", "plots"}
    assert names == {"decode_genealogy", "merge_name_chains", "to_newick",
                     "tree_probabilities"}
    for n in names:
        assert getattr(tviz, n) is getattr(trees, n)


@pytest.mark.parametrize("N", [5, 12])
def test_build_digraph_edges_equal_jax(N):
    pytest.importorskip("networkx")
    from phylo_tpu.viz import plots as jplots
    from phylo_tpu_torch.viz import plots

    taxa = taxa_of(N)
    gen = trees.decode_genealogy(*seeded_records(N, 4, seed=1)[:2])
    for rec in gen:
        assert sorted(plots.build_digraph(taxa, rec).edges) == \
            sorted(jplots.build_digraph(taxa, rec).edges)


# ------------------------------------------ the best particle's Newick
@pytest.mark.parametrize("N", [5, 12])
def test_best_newick_is_jax_decode_all_then_pick(N):
    from phylo_tpu.viz import trees as jtrees

    anc, merged, lb, rb, lw = seeded_records(N, 32, seed=N + 1)
    gen = jtrees.decode_genealogy(anc, merged, lb, rb)
    want = jtrees.to_newick(taxa_of(N), gen[int(np.argmax(lw[-1]))])
    assert best_newick(taxa_of(N), anc, merged, lb, rb, lw) == want


def test_trainer_newick_best_follows_jax_rule_on_its_history():
    from phylo_tpu.viz import trees as jtrees

    ds = dataset_from_strings(random_strings(5))
    h = train(ds, cfg(n_particles=8, num_epoch=2)).history
    assert len(h["newick_best"]) == 2
    assert h["jump_chain_evolution"] == []          # no save_dir
    for e in range(2):
        gen = jtrees.decode_genealogy(h["ancestors"][e], h["merged_nodes"][e],
                                      h["left_branches"][e],
                                      h["right_branches"][e])
        best = int(np.argmax(h["log_weights"][e][-1]))
        assert h["newick_best"][e] == jtrees.to_newick(ds.taxa, gen[best])


def test_best_particle_topology_matches_jax_sweep():
    """Under the same injected decisions (float64), the JAX sweep and the
    port's pick the same best particle, with the same topology and branch
    lengths within 1e-9."""
    from phylo_tpu.viz import trees as jtrees
    from phylo_tpu_torch.params import params_from_numpy
    from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies
    from test_torch_sweep import (
        jax_sweep, random_genome, setup_case, torch_decisions,
    )

    genome = random_genome(61, N=5, S=12)
    K = 6
    jmodel, tmodel, tree, dec = setup_case(genome, "reference", K, seed=62)
    want = jax_sweep(genome, jmodel, tree, dec, K)
    got = sample_phylogenies(None, torch.tensor(genome), tmodel,
                             params_from_numpy(tree, requires_grad=False),
                             SweepConfig(K=K), decisions=torch_decisions(dec))
    w = {f: np.asarray(getattr(want, f)) for f in (
        "ancestors", "merged_nodes", "left_branches", "right_branches",
        "log_weights")}
    g = {f: getattr(got, f).detach().numpy() for f in w}
    kw, kg = (int(np.argmax(x["log_weights"][-1])) for x in (w, g))
    assert kw == kg
    rw = jtrees.decode_genealogy(w["ancestors"], w["merged_nodes"],
                                 w["left_branches"], w["right_branches"])[kw]
    rg = trees.decode_genealogy(g["ancestors"], g["merged_nodes"],
                                g["left_branches"], g["right_branches"])[kg]
    taxa = taxa_of(5)
    assert trees._topology_key(taxa, rg) == jtrees._topology_key(taxa, rw)
    np.testing.assert_array_equal(rg["merges"], rw["merges"])
    np.testing.assert_allclose(rg["branches"], rw["branches"], rtol=1e-9,
                               atol=1e-12)


# --------------------------------------------------------- checkpoints
@pytest.mark.parametrize("model", [None, "gtr+g4"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_checkpoint_round_trip_is_bit_exact(tmp_path, optimizer, model):
    ds = dataset_from_strings(random_strings(7))
    config = cfg(optimizer=optimizer, substitution_model=model)
    mdl, params = init_params(ds, config)
    opt = _optimizer(config, param_tensors(params))
    leaves = torch.tensor(mdl.expand_leaves(ds.genome)
                          if hasattr(mdl, "expand_leaves") else ds.genome)
    for step in range(2):
        sgd_step(mdl, params, opt, _sweep_config(config),
                 step_generator(0, 0, 1 + step, "cpu"), leaves)
    history = {"elbo": [-1.5, -1.25], "newick_best": ["(a,b);", "(b,a);"]}
    path = save_checkpoint(tmp_path, params, opt, 2, history=history)
    assert os.path.basename(path) == "epoch_2"

    _, fresh = init_params(ds, config)
    fresh_opt = _optimizer(config, param_tensors(fresh))
    epoch, hist = restore_checkpoint(tmp_path, fresh, fresh_opt)
    assert epoch == 2 and hist == history
    assert_same_bits(fresh, params)
    assert state_bits(fresh_opt.state_dict()) == state_bits(opt.state_dict())
    if optimizer == "adam":
        assert fresh_opt.state_dict()["state"]
        for st in fresh_opt.state.values():
            assert st["step"].device.type == "cpu"
    # the optimizer updates the restored leaves themselves
    assert all(p is t for p, t in zip(fresh_opt.param_groups[0]["params"],
                                      param_tensors(fresh)))


def test_latest_checkpoint_ignores_temporary_files(tmp_path):
    ds = dataset_from_strings(random_strings(8))
    config = cfg(optimizer="sgd")
    _, params = init_params(ds, config)
    opt = _optimizer(config, param_tensors(params))
    assert latest_checkpoint(tmp_path) is None
    assert latest_checkpoint(tmp_path / "missing") is None
    for e in (1, 2, 10):
        save_checkpoint(tmp_path, params, opt, e)
    # an interrupted save of epoch 11 leaves only its temporary file
    (tmp_path / "epoch_11.tmp-123").write_bytes(b"torn")
    assert latest_checkpoint(tmp_path) == str(tmp_path / "epoch_10")
    assert sorted(os.listdir(tmp_path)) == [
        "epoch_1", "epoch_10", "epoch_11.tmp-123", "epoch_2"]
    epoch, hist = restore_checkpoint(tmp_path, params, opt)
    assert epoch == 10 and hist is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "missing", params, opt)


def test_restore_refuses_another_model(tmp_path):
    ds = dataset_from_strings(random_strings(9))
    _, params = init_params(ds, cfg(optimizer="sgd"))
    opt = _optimizer(cfg(optimizer="sgd"), param_tensors(params))
    save_checkpoint(tmp_path, params, opt, 1)
    _, other = init_params(ds, cfg(optimizer="sgd", substitution_model="gtr"))
    with pytest.raises(ValueError, match="another model"):
        restore_checkpoint(tmp_path, other,
                           _optimizer(cfg(), param_tensors(other)))


# -------------------------------------------------------------- resume
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_resume_replays_the_uninterrupted_run(tmp_path, dtype, optimizer):
    ds = dataset_from_strings(random_strings(10))
    kw = dict(dtype=dtype, optimizer=optimizer, checkpoint_every=1)
    full = train(ds, cfg(checkpoint_dir=str(tmp_path / "a"), **kw))
    part = train(ds, cfg(num_epoch=2, checkpoint_dir=str(tmp_path / "b"),
                         **kw))
    assert part.history["elbo"] == full.history["elbo"][:2]
    resumed = train(ds, cfg(resume_from=str(tmp_path / "b"),
                            checkpoint_dir=str(tmp_path / "c"), **kw))
    assert resumed.history["elbo"] == full.history["elbo"]
    assert resumed.history["newick_best"] == full.history["newick_best"]
    assert_same_bits(resumed.params, full.params)
    assert os.listdir(tmp_path / "c") == ["epoch_3"]


def test_resume_auto_needs_a_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        train(dataset_from_strings(random_strings(11)),
              cfg(resume_from="auto"))


def test_fault_injection_fires_only_on_a_trained_epoch(tmp_path):
    ds = dataset_from_strings(random_strings(12))
    kw = dict(checkpoint_every=1, checkpoint_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="injected fault at epoch 2"):
        train(ds, cfg(fault_injection="raise:2", **kw))
    assert latest_checkpoint(tmp_path) == str(tmp_path / "epoch_2")
    res = train(ds, cfg(fault_injection="raise:2", resume_from="auto", **kw))
    assert len(res.history["elbo"]) == 3
    with pytest.raises(ValueError, match="unknown fault kind"):
        train(ds, cfg(fault_injection="hang:1"))


def _worker_config(ckpt_dir, num_epoch, fault):
    return cfg(n_particles=6, num_epoch=num_epoch, seed=7,
               checkpoint_every=1, checkpoint_dir=ckpt_dir,
               resume_from="auto", fault_injection=fault)


def test_sigkill_resume_reproduces_uninterrupted_run(tmp_path):
    epochs = 5
    ds = load_dataset("load_strings")
    ref = train(ds, _worker_config(str(tmp_path / "ckpt_ref"), epochs, None))

    # crashed run: SIGKILL at the start of epoch 3 (after the epoch_3
    # checkpoint of epoch index 2 landed)
    crash_ckpt, crash_out = tmp_path / "ckpt_crash", tmp_path / "crash.p"
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(crash_ckpt),
         str(crash_out), str(epochs), "sigkill:3"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == -9, (proc.returncode, proc.stderr)
    assert not crash_out.exists()
    assert (crash_ckpt / "epoch_3").exists()
    assert latest_checkpoint(crash_ckpt) == str(crash_ckpt / "epoch_3")

    # the same command again: resume_from="auto" picks up epoch_3
    res = train(ds, _worker_config(str(crash_ckpt), epochs, "sigkill:3"))
    assert res.history["elbo"] == ref.history["elbo"]
    assert_same_bits(res.params, ref.params)


# ------------------------------------------------------ train_elastic
def test_train_elastic_retries_transient_failures(tmp_path):
    ds = load_dataset("load_strings")
    kw = dict(n_particles=4, checkpoint_every=1)
    failures = []
    result = train_elastic(
        ds, cfg(fault_injection="raise:2", checkpoint_dir=str(tmp_path / "ck"),
                **kw),
        max_restarts=2, on_failure=lambda a, e: failures.append(str(e)))
    assert len(failures) == 1 and "injected fault" in failures[0]
    assert len(result.history["elbo"]) == 3
    clean = train(ds, cfg(checkpoint_dir=str(tmp_path / "ck_clean"), **kw))
    assert result.history["elbo"] == clean.history["elbo"]


def test_train_elastic_requires_stable_checkpoints():
    with pytest.raises(ValueError, match="checkpoint"):
        train_elastic(load_dataset("load_strings"), cfg(num_epoch=1))


def test_train_elastic_honors_explicit_resume_from(tmp_path):
    """An explicit resume_from (warm start) is not replaced with 'auto'
    on the first attempt."""
    config = cfg(n_particles=4, num_epoch=1, checkpoint_every=1,
                 checkpoint_dir=str(tmp_path / "ck"),
                 resume_from=str(tmp_path / "does_not_exist"))
    with pytest.raises(FileNotFoundError):
        train_elastic(load_dataset("load_strings"), config, max_restarts=0)


# ------------------------------------------------------------ replicas
def test_replicas_train_independently():
    ds = load_dataset("load_strings")
    out = train_replicas(ds, cfg(n_particles=6, batch_size=10), n_replicas=3)
    elbos = out["history"]["elbo"]
    assert elbos.shape == (3, 3) and np.isfinite(elbos).all()
    assert len(set(elbos[-1].tolist())) == 3
    assert out["params"]["branches"]["log_rates_l"].shape == (3, ds.N - 1)
    assert len(out["history"]["epoch_seconds"]) == 3


def test_replica_site_batches_follow_jax_schedule(monkeypatch):
    """Each site is its own column code (base-4 digits over the taxa), so
    the batches the steps see name their sites; they must be JAX's: one
    default_rng(seed), each epoch one permutation per replica in replica
    order, cut into S // batch_size steps (replicas.py:67-80)."""
    from phylo_tpu_torch.train import replicas

    S, N, R, bs, epochs = 13, 4, 2, 5, 2
    strings = ["".join("ACGT"[(s // 4 ** n) % 4] for s in range(S))
               for n in range(N)]
    ds = dataset_from_strings(strings)
    seen = []
    real = replicas.sgd_step

    def spy(model, params, opt, sweep_cfg, gen, batch, **kw):
        codes = batch.argmax(-1).numpy()                  # (N, bs)
        seen.append((4 ** np.arange(N)) @ codes)
        return real(model, params, opt, sweep_cfg, gen, batch, **kw)

    monkeypatch.setattr(replicas, "sgd_step", spy)
    replicas.train_replicas(ds, cfg(n_particles=4, batch_size=bs,
                                    num_epoch=epochs, seed=5), R)
    rng = np.random.default_rng(5)
    want = []
    for _ in range(epochs):
        perms = [rng.permutation(S) for _ in range(R)]
        for step in range(S // bs):
            want += [p[step * bs:(step + 1) * bs] for p in perms]
    assert len(seen) == len(want)
    for got, exp in zip(seen, want):
        np.testing.assert_array_equal(got, exp)


def test_replicas_refuse_a_rate_mixture():
    with pytest.raises(ValueError, match="rate mixture"):
        train_replicas(load_dataset("load_strings"),
                       cfg(gamma_categories=4), n_replicas=2)


# -------------------------------------------------------- sweep runner
def test_sweep_runner_rows_and_seeds(tmp_path, monkeypatch):
    from phylo_tpu_torch.train import results

    # the rows come from the runs; their plots and pickles are not needed
    monkeypatch.setattr(results, "save_results", lambda *a: None)
    sweep_runner.main(["--dataset=load_strings", "--K_list=4,6",
                       "--repeats=2", "--num_epoch=1", "--batch_size=5",
                       "--device=cpu", f"--results_dir={tmp_path}"])
    with open(tmp_path / "sweep_summary.json") as f:
        rows = json.load(f)
    assert [(r["K"], r["seed"]) for r in rows] == [
        (4, 0), (6, 1), (4, 1000), (6, 1001)]
    assert all(np.isfinite(r["final_elbo"]) for r in rows)
    assert all(os.path.isdir(r["save_dir"]) for r in rows)
    again = train(load_dataset("load_strings"), TrainConfig(
        n_particles=6, batch_size=5, num_epoch=1, seed=1001, log_every=0,
        save_artifacts=False, device="cpu"))
    assert again.elbo == rows[3]["final_elbo"]


# ------------------------------------------------- runner and cli.trees
def test_runner_checkpoint_every_writes_checkpoints(tmp_path):
    res = runner.run(["--dataset=load_strings", "--n_particles=4",
                      "--num_epoch=2", "--batch_size=5", "--device=cpu",
                      "--checkpoint_every=1", f"--results_dir={tmp_path}"])
    assert sorted(os.listdir(os.path.join(res.save_dir, "ckpt"))) == [
        "epoch_1", "epoch_2"]
    with open(os.path.join(res.save_dir, "results.p"), "rb") as f:
        r = pickle.load(f)
    assert len(r["newick_best"]) == 2
    assert len(r["jump_chain_evolution"]) == 2
    assert len(r["jump_chain_evolution"][0]) == 4          # K chains


def test_runner_resume_from_continues_the_run(tmp_path):
    base = ["--dataset=load_strings", "--n_particles=4", "--batch_size=5",
            "--device=cpu", "--optimizer=adam", "--learning_rate=0.05",
            f"--results_dir={tmp_path}"]
    full = runner.run(base + ["--num_epoch=3", "--no_artifacts"])
    first = runner.run(base + ["--num_epoch=2", "--checkpoint_every=2"])
    ckpt = os.path.join(first.save_dir, "ckpt")
    resumed = runner.run(base + ["--num_epoch=3", "--no_artifacts",
                                 f"--resume_from={ckpt}"])
    assert resumed.history["elbo"] == full.history["elbo"]
    assert_same_bits(resumed.params, full.params)


def test_cli_trees_equals_jax_on_a_port_run(tmp_path):
    from phylo_tpu.cli import trees as jtrees_cli

    res = runner.run(["--dataset=load_strings", "--n_particles=8",
                      "--num_epoch=1", "--batch_size=5", "--device=cpu",
                      f"--results_dir={tmp_path}"])
    got = trees_cli.summarize(res.save_dir, top=3,
                              out=str(tmp_path / "port.nex"))
    want = jtrees_cli.summarize(os.path.join(res.save_dir, "results.p"),
                                top=3, out=str(tmp_path / "jax.nex"))
    assert got.pop("nexus") == str(tmp_path / "port.nex")
    want.pop("nexus")
    assert json.dumps(got) == json.dumps(want)
    assert (tmp_path / "port.nex").read_text() == \
        (tmp_path / "jax.nex").read_text()
    printed = trees_cli.main([res.save_dir, "--top=2"])
    assert os.path.exists(os.path.join(res.save_dir, "trees.nex"))
    assert printed["topologies"] == got["topologies"][:2]


# ----------------------------------------------------------- profiling
def test_block_timer_and_timed_on_the_cpu():
    x = torch.ones(8)
    with profiling.BlockTimer("add", sync=x) as t:
        y = x + 1
    assert t.seconds >= 0 and t.name == "add"
    with profiling.BlockTimer(sync="cpu") as t2:
        pass
    assert t2.seconds >= 0
    secs, out = profiling.timed(torch.add, x, y, warmup=2, iters=3)
    assert secs >= 0 and torch.equal(out, x + y)
    profiling.synchronize({"a": [x, (y,)], "b": None, "c": "text"})


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(tmp_path, device="cpu") as prof:
        torch.mm(torch.ones(4, 4), torch.ones(4, 4))
    assert prof is not None
    with open(tmp_path / "trace.json") as f:
        assert "aten::mm" in f.read()


def test_device_trace_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.device_trace(tmp_path):
            pass


def _worker(argv):
    ckpt_dir, out, num_epoch = argv[0], argv[1], int(argv[2])
    fault = argv[3] if len(argv) > 3 else None
    result = train(load_dataset("load_strings"),
                   _worker_config(ckpt_dir, num_epoch, fault))
    with open(out, "wb") as f:
        pickle.dump(result.history["elbo"], f)


if __name__ == "__main__":
    _worker(sys.argv[1:])
