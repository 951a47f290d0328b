"""Experiment driver CLI (port of phylo_tpu/cli/runner.py).

The same flag surface as the JAX runner (reference runner.py:12-58),
plus ``--device`` (default ``cuda``; ``cpu`` on request).  Flags of
later slices raise NotImplementedError naming their ROADMAP.md item.

Usage (on a GPU):
    python -m phylo_tpu_torch.cli.runner --dataset=primate_data \
        --n_particles=2048 --num_epoch=100 --batch_size=256
    python -m phylo_tpu_torch.cli.runner --dataset=primate_data \
        --nested=True --M=10 --n_particles=32 --batch_size=256
    python -m phylo_tpu_torch.cli.runner --dataset=hohna_data_1 \
        --model=gtr+g4 --n_particles=2048 --batch_size=256
    python -m phylo_tpu_torch.cli.runner --dataset=betacorona1 \
        --codons=True --n_particles=128 --batch_size=256
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
                   "gy94, optionally +gN, +i or +rN (e.g. gtr+g4+i), "
                   "+f for gy94")
    p.add_argument("--codons", type=_boolish, default=False,
                   help="convert the DNA alignment to the 61 sense codons "
                   "(model defaults to gy94)")
    p.add_argument("--gamma_categories", type=int, default=0)
    p.add_argument("--paml_dat", default=None)
    p.add_argument("--plus_f", type=_boolish, default=False)
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
    p.add_argument("--mesh", default=None)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--reference_compat", type=_boolish, default=True)
    p.add_argument("--fixed_partition", type=_boolish, default=False)
    p.add_argument("--log_params", type=_boolish, default=False)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default cuda; cpu on request)")
    return p.parse_args(argv)


def _check_flags(args):
    def no(flag, item):
        raise NotImplementedError(
            f"{flag} is not ported to phylo_tpu_torch yet "
            f"(ROADMAP.md {item})")

    if args.paml_dat or args.plus_f:
        no("--paml_dat/--plus_f", "Queue 1 item 11b, protein half")
    if args.mesh:
        no("--mesh", "Queue 1 item 16")
    if args.coordinator or args.num_processes or args.process_id \
            is not None or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        no("multi-host training", "Queue 1 item 16")
    if args.checkpoint_every:
        no("--checkpoint_every", "Queue 1 item 9 (checkpoint)")
    if args.resume_from:
        no("--resume_from", "Queue 1 item 9 (checkpoint)")
    if args.dtype == "bfloat16":
        no("--dtype=bfloat16", "Queue 1")


def run(argv=None):
    """Parse `argv`, train, and return the TrainResult."""
    args = parse_args(argv)
    _check_flags(args)

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
        device=args.device,
    )
    res = train(ds, config)
    print(f"Done. Final ELBO {res.elbo:.3f}"
          + (f"; artifacts in {res.save_dir}" if res.save_dir else ""))
    return res


def main(argv=None):
    """Console entry point: train and return None (exit status 0)."""
    run(argv)


if __name__ == "__main__":
    main()
