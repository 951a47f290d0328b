"""Experiment driver CLI (port of phylo_tpu/cli/runner.py).

The same flag surface as the JAX runner (reference runner.py:12-58),
plus ``--device`` (default ``cuda``; ``cpu`` on request).
``--dtype=bfloat16`` raises NotImplementedError naming its ROADMAP.md
entry.

Usage (on a GPU):
    python -m phylo_tpu_torch.cli.runner --dataset=primate_data \
        --n_particles=2048 --num_epoch=100 --batch_size=256
    python -m phylo_tpu_torch.cli.runner --dataset=primate_data \
        --nested=True --M=10 --n_particles=32 --batch_size=256
    python -m phylo_tpu_torch.cli.runner --dataset=hohna_data_1 \
        --model=gtr+g4 --n_particles=2048 --batch_size=256
    python -m phylo_tpu_torch.cli.runner --dataset=betacorona1 \
        --codons=True --n_particles=128 --batch_size=256
    python -m phylo_tpu_torch.cli.runner --dataset=<protein FASTA> \
        --gamma_categories=4 --n_particles=256 --batch_size=256
    python -m phylo_tpu_torch.cli.runner --dataset=<protein FASTA> \
        --paml_dat=lg.dat --plus_f=True --gamma_categories=4
    python -m phylo_tpu_torch.cli.runner --dataset=<protein FASTA> \
        --gamma_categories=8 --n_particles=256 --batch_size=256
    python -m phylo_tpu_torch.cli.runner --dataset=betacorona1 \
        --codons=True --model=gy94+g4 --n_particles=128 --batch_size=256

Rate mixtures run on the card up to 32 blocks of up to 128 states
(protein+Gamma8, GY94+Gamma4 included); more blocks or wider ones raise
before any tensor is touched (`smc.sweep.card_refusals`).

Checkpoints go to <run dir>/ckpt every --checkpoint_every epochs;
--resume_from=<checkpoint or its directory> continues a run from one.

On a mesh, one process per device: ``--mesh=2`` shards sites over two
devices (``--mesh=2,1`` particles, ``--mesh=2,2`` both, as ('k', 's')),
each process started with ``--coordinator=host:port
--num_processes=<n> --process_id=<i>`` (or JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID); ``--mesh=1`` runs in one process.
Rank 0 writes the results:
    python -m phylo_tpu_torch.cli.runner --dataset=hohna_data_1 \
        --model=gtr+g4 --n_particles=2048 --mesh=2 \
        --coordinator=localhost:29500 --num_processes=2 --process_id=0
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _boolish(x):
    return str(x).lower() == "true"


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Variational Combinatorial Sequential Monte Carlo "
        "(PyTorch/CUDA port)")
    p.add_argument("--dataset", default="primate_data")
    p.add_argument("--n_particles", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--num_epoch", type=int, default=100)
    p.add_argument("--optimizer", default="GradientDescentOptimizer",
                   help="GradientDescentOptimizer|Adam|sgd|adam")
    p.add_argument("--branch_prior", type=float, default=float(np.log(10)))
    p.add_argument("--M", type=int, default=10)
    p.add_argument("--nested", type=_boolish, default=False)
    p.add_argument("--jcmodel", type=_boolish, default=False)
    p.add_argument("--model", default=None,
                   help="substitution model spec: jc69|reference|gtr|hky|"
                   "gy94|<paml.dat>, optionally +gN, +i or +rN (e.g. "
                   "gtr+g4+i), +f for gy94 and .dat bases (lg.dat+f+g4)")
    p.add_argument("--codons", type=_boolish, default=False,
                   help="convert the DNA alignment to the 61 sense codons "
                   "(model defaults to gy94)")
    p.add_argument("--gamma_categories", type=int, default=0)
    p.add_argument("--paml_dat", default=None,
                   help="empirical amino-acid model from a PAML .dat file "
                   "(LG/WAG/JTT...); overrides --model")
    p.add_argument("--plus_f", type=_boolish, default=False,
                   help="+F: learn the stationary frequencies (initialized "
                   "at the --paml_dat file's values)")
    p.add_argument("--invariant_sites", type=_boolish, default=False)
    p.add_argument("--free_rates", type=_boolish, default=False)
    p.add_argument("--memory_optimization", default="on",
                   help="accepted for reference compatibility")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resampling", default="multinomial",
                   choices=["multinomial", "systematic", "stratified",
                            "none"])
    p.add_argument("--ess_threshold", type=float, default=None)
    p.add_argument("--carried_weights", type=_boolish, default=False)
    p.add_argument("--results_dir", default="./results")
    p.add_argument("--no_artifacts", action="store_true")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--resume_from", default=None)
    p.add_argument("--mesh", default=None,
                   help="comma-separated mesh shape, e.g. '4' shards sites "
                   "over 4 devices (one process each)")
    p.add_argument("--coordinator", default=None,
                   help="multi-process: the rendezvous host:port (or set "
                   "JAX_COORDINATOR_ADDRESS)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="multi-process: total process count")
    p.add_argument("--process_id", type=int, default=None,
                   help="multi-process: this process's index")
    p.add_argument("--reference_compat", type=_boolish, default=True)
    p.add_argument("--fixed_partition", type=_boolish, default=False)
    p.add_argument("--log_params", type=_boolish, default=False)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default cuda; cpu on request)")
    return p.parse_args(argv)


def _check_flags(args):
    if args.dtype == "bfloat16":
        raise NotImplementedError(
            "--dtype=bfloat16 is not ported to phylo_tpu_torch (ROADMAP.md "
            "Queue 3: configurations the card refuses)")


def run(argv=None):
    """Parse `argv`, train, and return the TrainResult."""
    args = parse_args(argv)
    _check_flags(args)

    if args.coordinator or args.num_processes or os.environ.get(
            "JAX_COORDINATOR_ADDRESS"):
        from phylo_tpu_torch.parallel import (
            initialize_distributed,
            process_summary,
        )

        initialize_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            device=args.device,
        )
        print(process_summary())

    from phylo_tpu_torch.dataio import load_dataset
    from phylo_tpu_torch.train import TrainConfig, train

    ds = load_dataset(args.dataset)
    if args.codons:
        from phylo_tpu_torch.dataio.codons import codon_dataset

        ds = codon_dataset(ds)
        if args.model is None:
            args.model = "gy94"
    print(f"Dataset: {ds.name}  N={ds.N} taxa, S={ds.S} sites, "
          f"A={ds.A} states")
    config = TrainConfig(
        n_particles=args.n_particles,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        num_epoch=args.num_epoch,
        M=args.M,
        nested=args.nested,
        optimizer=args.optimizer,
        branch_prior=args.branch_prior,
        jcmodel=args.jcmodel,
        substitution_model=args.model,
        paml_dat=args.paml_dat,
        plus_f=args.plus_f,
        gamma_categories=args.gamma_categories,
        invariant_sites=args.invariant_sites,
        free_rates=args.free_rates,
        resampling=args.resampling,
        ess_threshold=args.ess_threshold,
        carried_weights=args.carried_weights,
        dtype=args.dtype,
        seed=args.seed,
        q_raw_subtraction=args.reference_compat,
        right_multiplier_bug=args.reference_compat,
        resample_branch_history=not args.reference_compat,
        fixed_partition=args.fixed_partition,
        log_params=args.log_params,
        results_dir=args.results_dir,
        save_artifacts=not args.no_artifacts,
        checkpoint_every=args.checkpoint_every,
        resume_from=args.resume_from,
        mesh_shape=(tuple(int(x) for x in args.mesh.split(","))
                    if args.mesh else None),
        device=args.device,
    )
    res = train(ds, config)
    g = res.graphs
    print(f"Done. Final ELBO {res.elbo:.3f}"
          + (f"; artifacts in {res.save_dir}" if res.save_dir else "")
          + (f"; fused epoch: {sum(g['replays'])} CUDA graph replays, "
             f"{g['capture_seconds']:.2f} s capturing" if g["captured"]
             else f"; fused epoch {g['reason']}"))
    return res


def main(argv=None):
    """Console entry point: train and return None (exit status 0)."""
    run(argv)


if __name__ == "__main__":
    main()
