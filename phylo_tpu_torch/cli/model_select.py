"""Substitution-model selection from the command line (port of
phylo_tpu/cli/model_select.py; the ModelFinder / jModelTest role -- no
reference equivalent; the reference hardcodes one parameterization per
run, vcsmc.py:119-148).

Usage (on a GPU; --device=cpu on the CPU):
    python -m phylo_tpu_torch.cli.model_select --dataset=primate_data
        [--candidates=jc69,hky+g4,gtr+g4+i] [--criterion=bic]
        [--newick=tree.nwk] [--steps=300] [--out=best_tree.nwk]

Fits every candidate spec (model parameters + branch lengths, Adam ML)
on one fixed topology — a supplied Newick tree, or a neighbor-joining
tree built from JC-corrected distances — and prints an IQ-TREE-style
ranking table.  --out writes the winning model's refitted tree.
--dtype defaults to float64 on the CPU (the JAX CLI's default) and
float32 on the card, whose kernels are float32 only.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Model selection by AIC/AICc/BIC on a fixed topology"
    )
    p.add_argument("--dataset", required=True,
                   help="dataset name or alignment file path")
    p.add_argument("--candidates", default=None,
                   help="comma-separated model specs (default: the "
                        "12-model DNA ladder jc69..gtr+g4+i)")
    p.add_argument("--criterion", default="bic",
                   choices=["aic", "aicc", "bic"])
    p.add_argument("--newick", default=None,
                   help="fixed topology (file path or literal string); "
                        "default builds a neighbor-joining tree from "
                        "JC-corrected distances")
    p.add_argument("--steps", type=int, default=300,
                   help="Adam steps per candidate fit")
    p.add_argument("--learning_rate", type=float, default=0.05)
    p.add_argument("--dtype", default=None,
                   choices=["float32", "float64"],
                   help="default float64 on the CPU, float32 on cuda")
    p.add_argument("--out", default=None,
                   help="write the best model's refitted tree as Newick")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default cuda; cpu on request)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np

    from phylo_tpu_torch.dataio import load_dataset
    from phylo_tpu_torch.device import resolve_device
    from phylo_tpu_torch.models.selection import select_model
    from phylo_tpu_torch.pruning.fixed_tree import parse_newick
    from phylo_tpu_torch.search.nj import (
        jc_distance_matrix,
        neighbor_joining,
    )
    from phylo_tpu_torch.viz.trees import to_newick

    dev = resolve_device(args.device)
    ds = load_dataset(args.dataset)
    taxa = list(ds.taxa)
    print(f"dataset: {ds.name}  N={ds.N} S={ds.S} A={ds.A}")

    if args.newick:
        text = args.newick
        if os.path.exists(text):
            with open(text) as f:
                text = f.read()
        taxa, record = parse_newick(text, taxa=taxa, clamp_negative=True)
        print("topology: user-supplied Newick")
    else:
        record = neighbor_joining(jc_distance_matrix(np.asarray(ds.genome)))
        print("topology: neighbor-joining on JC-corrected distances")

    candidates = (args.candidates.split(",")
                  if args.candidates else None)
    fits = select_model(
        ds.genome, record=record, candidates=candidates,
        criterion=args.criterion, steps=args.steps,
        learning_rate=args.learning_rate, dtype=args.dtype, device=dev,
        verbose=True,
    )

    crit = args.criterion
    best = fits[0]
    print(f"\nranking by {crit.upper()} "
          f"(n={best.n_sites:.0f} sites, {best.k_branches} branch "
          "lengths counted per model):")
    print(f"{'model':<12s} {'lnL':>14s} {'k':>4s} {'AIC':>12s} "
          f"{'AICc':>12s} {'BIC':>12s} {'d' + crit.upper():>10s}")
    ref = getattr(best, crit)
    for f in fits:
        print(f"{f.spec:<12s} {f.log_likelihood:14.4f} {f.k:4d} "
              f"{f.aic:12.2f} {f.aicc:12.2f} {f.bic:12.2f} "
              f"{getattr(f, crit) - ref:10.2f}")
    print(f"\nbest model: {best.spec}  "
          f"(lnL {best.log_likelihood:.4f}, {crit.upper()} {ref:.2f})")

    if args.out:
        rec = dict(record, branches=np.asarray(best.branches))
        with open(args.out, "w") as f:
            f.write(to_newick(taxa, rec) + "\n")
        print(f"best-model tree written to {args.out}")
    return best.spec


if __name__ == "__main__":
    main()
