"""Boundaries of the port: phylo_tpu_torch and chip_smoke.py import
neither jax nor phylo_tpu, and the entry points run on the GPU unless
the caller names the CPU (they raise when no GPU is visible)."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "phylo_tpu_torch")

torch.set_num_threads(1)


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_phylo_tpu_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "phylo_tpu", "optax"), (
            f"{os.path.relpath(path, REPO)} imports {mod}")


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import phylo_tpu_torch.cli.runner, phylo_tpu_torch.train\n"
        "import phylo_tpu_torch.smc.sweep_vjp, phylo_tpu_torch.params\n"
        "import phylo_tpu_torch.smc.twist, phylo_tpu_torch.pruning.kernels\n"
        "import phylo_tpu_torch.smc.csmc, phylo_tpu_torch.smc.bootstrap\n"
        "import phylo_tpu_torch.pruning.fixed_tree\n"
        "import phylo_tpu_torch.pruning.ancestral, phylo_tpu_torch.search\n"
        "import phylo_tpu_torch.models.selection\n"
        "import phylo_tpu_torch.cli.score_tree, phylo_tpu_torch.cli.csmc\n"
        "import phylo_tpu_torch.cli.model_select\n"
        "import phylo_tpu_torch.cli.bootstrap\n"
        "import phylo_tpu_torch.parallel, phylo_tpu_torch.oracle\n"
        "import phylo_tpu_torch.oracle.reference_vncsmc\n"
        "import phylo_tpu_torch.parallel.collectives\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'phylo_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    from phylo_tpu_torch.cli import runner
    from phylo_tpu_torch.dataio import load_dataset
    from phylo_tpu_torch.train import TrainConfig, train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(load_dataset("load_strings"),
              TrainConfig(n_particles=4, num_epoch=1, save_artifacts=False))
    with pytest.raises(RuntimeError, match="--device=cpu"):
        runner.main(["--dataset=load_strings", "--n_particles=4",
                     "--num_epoch=1", "--no_artifacts"])
    from phylo_tpu_torch.cli import sweep_runner
    from phylo_tpu_torch.train import train_elastic
    from phylo_tpu_torch.train.replicas import train_replicas

    ds = load_dataset("load_strings")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_runner.main(["--dataset=load_strings", "--K_list=4",
                           "--num_epoch=1", "--results_dir=unused"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_elastic(ds, TrainConfig(n_particles=4, num_epoch=1,
                                      checkpoint_every=1,
                                      checkpoint_dir="unused"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_replicas(ds, TrainConfig(n_particles=4, num_epoch=1), 2)


TREE_CLIS = {
    "score_tree": ["--dataset=load_strings", "--newick=((S0,S1),(S2,S3));"],
    "model_select": ["--dataset=load_strings", "--candidates=jc69",
                     "--steps=1"],
    "bootstrap": ["--dataset=load_strings", "--n_particles=4",
                  "--n_replicates=1"],
    "csmc": ["--dataset=load_strings", "--n_particles=4"],
}


@pytest.mark.parametrize("name", sorted(TREE_CLIS))
def test_tree_tool_clis_default_to_cuda(name):
    """The tree tools' CLIs run on the card unless --device=cpu is given,
    and raise before any work when no GPU is visible."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    import importlib

    cli = importlib.import_module(f"phylo_tpu_torch.cli.{name}")
    assert cli.parse_args(TREE_CLIS[name]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device=cpu"):
        cli.main(TREE_CLIS[name])


def test_tree_tools_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    from phylo_tpu_torch.dataio import load_dataset
    from phylo_tpu_torch.models.selection import select_model
    from phylo_tpu_torch.smc.csmc import CSMC

    ds = load_dataset("load_strings")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CSMC({"taxa": ds.taxa, "genome": ds.genome})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        select_model(ds.genome, candidates=["jc69"], steps=1)


def test_mesh_entry_points_default_to_cuda():
    """initialize_distributed and a mesh's world of one run on the card
    (NCCL) unless the caller names the CPU, and raise before any process
    group when no GPU is visible."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    import torch.distributed as dist

    from phylo_tpu_torch.parallel import initialize_distributed, make_mesh

    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_distributed("localhost:1", num_processes=1, process_id=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((1,))
    assert not dist.is_initialized()


def test_float64_on_cuda_is_rejected():
    from phylo_tpu_torch.device import resolve_dtype

    with pytest.raises(NotImplementedError, match="float64 on cuda"):
        resolve_dtype("float64", "cuda")


def test_kernel_input_checks_refuse_cpu_tensors():
    """Wrappers validate what they hand to a kernel: a CPU tensor never
    reaches the CUDA launch path, and the checker refuses it."""
    from phylo_tpu_torch import _ext

    with pytest.raises(ValueError, match="CUDA tensor"):
        _ext.require(torch.zeros(3), "x", torch.float32)
