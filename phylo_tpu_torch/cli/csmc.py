"""Non-variational CSMC from the command line (port of
phylo_tpu/cli/csmc.py) -- the reference's ``python csmc.py``
entry point (reference csmc.py:457-562: standalone __main__ that samples
phylogenies under fixed parameters, prints the normalization-constant
estimate and topology posterior, and draws the max-probability tree when
``showing``).

Usage (on a GPU; --device=cpu on the CPU):
    python -m phylo_tpu_torch.cli.csmc --dataset=primates_small \
        --n_particles=8 --resampling=false --showing=true

The oracle runs in float64 wherever it runs: it launches no kernel.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Combinatorial Sequential Monte Carlo (fixed "
        "parameters, the reference's oracle)"
    )
    p.add_argument("--dataset", default="load_strings")
    p.add_argument("--n_particles", type=int, default=8)
    p.add_argument("--resampling", type=_boolish, default=False)
    p.add_argument("--showing", type=_boolish, default=False,
                   help="draw the max-probability tree "
                   "(reference csmc.py:450-452)")
    p.add_argument("--save_path", default="max_prob_tree.png")
    p.add_argument("--branch_length", type=float, default=2.0,
                   help="fixed branch length (reference csmc.py:254-255)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default cuda; cpu on request)")
    return p.parse_args(argv)


def _boolish(x):
    return str(x).lower() == "true"


def main(argv=None):
    args = parse_args(argv)

    from phylo_tpu_torch.dataio import load_dataset
    from phylo_tpu_torch.device import resolve_device
    from phylo_tpu_torch.smc.csmc import CSMC

    dev = resolve_device(args.device)

    ds = load_dataset(args.dataset)
    print(f"Dataset: {ds.name}  N={ds.N} taxa, S={ds.S} sites, "
          f"A={ds.A} states")
    csmc = CSMC(
        {"taxa": ds.taxa, "genome": ds.genome},
        branch_length=args.branch_length, seed=args.seed, device=dev,
    )
    out = csmc.sample_phylogenies(
        args.n_particles, resampling=args.resampling,
        showing=args.showing, save_path=args.save_path,
    )
    print("normalization constant estimate:", out["norm"])
    print("topology posterior (top 5):")
    for prob, k in out["tree_probabilities"][:5]:
        print(f"  {prob:.4f}  (particle {k})")
    if args.showing:
        print(f"max-probability tree drawn to {out['max_prob_tree_png']}")
    return out


if __name__ == "__main__":
    main()
