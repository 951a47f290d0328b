"""Bootstrap clade supports from the command line (port of
phylo_tpu/cli/bootstrap.py).

Felsenstein nonparametric bootstrap (smc/bootstrap.py) on any dataset
the runner accepts; no reference equivalent (the reference trains once
on the full alignment, runner.py:151-176).

Usage (on a GPU; --device=cpu on the CPU):
    python -m phylo_tpu_torch.cli.bootstrap --dataset=primate_data \
        --n_particles=64 --n_replicates=50 [--model=jc69]
        [--map_tree] [--threshold=0.5] [--out=consensus.nwk]

Prints per-clade supports and the majority-rule consensus Newick
(support fractions as internal-node labels).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Bootstrap clade supports")
    p.add_argument("--dataset", required=True)
    p.add_argument("--n_particles", type=int, default=64)
    p.add_argument("--n_replicates", type=int, default=50)
    p.add_argument("--model", default="jc69",
                   help="substitution model spec (jc69|reference|gtr|"
                   "hky|<paml.dat>, +gN/+i/+rN/+f modifiers)")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--map_tree", action="store_true",
                   help="count one (highest-weight) tree per replicate")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--out", default=None,
                   help="write the consensus Newick here")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default cuda; cpu on request)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from phylo_tpu_torch.dataio import load_dataset
    from phylo_tpu_torch.device import resolve_device, resolve_dtype
    from phylo_tpu_torch.models.branches import init_branch_params
    from phylo_tpu_torch.models.substitution import get_model
    from phylo_tpu_torch.smc.bootstrap import bootstrap_supports
    from phylo_tpu_torch.smc.sweep import SweepConfig

    dev = resolve_device(args.device)
    dtype = resolve_dtype(args.dtype, dev)
    ds = load_dataset(args.dataset)
    model = get_model(args.model, A=ds.A)
    genome = ds.genome
    if hasattr(model, "expand_leaves"):
        genome = model.expand_leaves(genome)
    if model.A != genome.shape[-1]:
        raise ValueError(
            f"model {args.model!r} has A={model.A} states but the "
            f"dataset has A={ds.A}"
        )
    params = {
        "model": model.init_params(dtype, dev),
        "branches": init_branch_params(ds.N, dtype=dtype, device=dev),
    }
    res = bootstrap_supports(
        args.seed, torch.as_tensor(np.asarray(genome), device=dev).to(dtype),
        model, params, SweepConfig(K=args.n_particles),
        n_replicates=args.n_replicates, taxa=list(ds.taxa),
        threshold=args.threshold, map_tree=args.map_tree,
    )
    print(f"dataset: {ds.name}  N={ds.N} S={ds.S}  "
          f"B={args.n_replicates} K={args.n_particles}")
    print(f"mean replicate ELBO: {res.elbos.mean():.3f} "
          f"(sd {res.elbos.std():.3f})")
    for clade, s in sorted(res.supports.items(),
                           key=lambda cs: -cs[1]):
        if len(clade) > 1:
            print(f"  {s:6.3f}  {{{', '.join(sorted(clade))}}}")
    print(f"consensus: {res.consensus}")
    if args.out:
        with open(args.out, "w") as f:
            f.write(res.consensus + "\n")
        print(f"consensus written to {args.out}")
    return res


if __name__ == "__main__":
    main()
