"""Posterior tree summaries from a training run's results.p (port of
phylo_tpu/cli/trees.py).

Groups the final epoch's particles by topology, reports posterior
probabilities (reference csmc.py:335-349 aggregation, applied to the
VCSMC output), and writes the distinct topologies as Newick and a NEXUS
TREES block -- tree-file export the reference does not have (its only
tree artifact is the pickled string jump chain, vcsmc.py:622-642).

Usage:
    python -m phylo_tpu_torch.cli.trees <run_dir_or_results.p> \
        [--top 5] [--out trees.nex]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Posterior tree summaries")
    p.add_argument("results", help="run directory or results.p path")
    p.add_argument("--top", type=int, default=5,
                   help="number of distinct topologies to report")
    p.add_argument("--out", default=None,
                   help="NEXUS output path (default <run_dir>/trees.nex)")
    return p.parse_args(argv)


def summarize(results_path, top=5, out=None):
    path = results_path
    if os.path.isdir(path):
        path = os.path.join(path, "results.p")
    with open(path, "rb") as f:
        r = pickle.load(f)
    if r.get("ancestors") is None:
        raise ValueError(
            "results.p has no merge records (written by runs of this "
            "framework version with collect_trees enabled)"
        )

    from phylo_tpu_torch.viz.trees import (
        decode_genealogy,
        majority_consensus,
        to_newick,
        to_nexus,
        tree_probabilities,
    )

    taxa = r["taxa"]
    lb = r["left_branches"][-1]
    rb = r["right_branches"][-1]
    genealogy = decode_genealogy(r["ancestors"], r["merged_nodes"], lb, rb)
    final_lw = r["log_weights"][-1][-1]       # last epoch, last rank (K,)
    probs = tree_probabilities(taxa, genealogy, final_lw)[:top]

    records = [genealogy[k] for _, k in probs]
    pvals = [p for p, _ in probs]
    nexus = to_nexus(taxa, records, probs=pvals)
    out = out or os.path.join(os.path.dirname(path), "trees.nex")
    with open(out, "w") as f:
        f.write(nexus)

    consensus_nwk, _ = majority_consensus(taxa, genealogy, final_lw)
    summary = {
        "topologies": [
            {
                "probability": float(p),
                "particle": int(k),
                "newick": to_newick(taxa, genealogy[k]),
            }
            for p, k in probs
        ],
        # weighted majority-rule consensus with clade supports as
        # internal labels
        "consensus": consensus_nwk,
        "nexus": out,
        "n_particles": int(r["nParticles"]),
    }
    return summary


def main(argv=None):
    args = parse_args(argv)
    summary = summarize(args.results, top=args.top, out=args.out)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
