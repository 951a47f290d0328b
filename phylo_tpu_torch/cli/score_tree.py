"""Score a fixed (Newick) tree against an alignment (port of
phylo_tpu/cli/score_tree.py).

Fixed-tree evaluation the reference does not have: compute
log P(Y | tree, theta) by Felsenstein pruning over a user-supplied
rooted binary topology, under a named substitution model or the
trained model of a finished run (its results.p best-epoch Q and
stationary probabilities), optionally ML-fitting the branch lengths on
the fixed topology first.

Usage (on a GPU; --device=cpu on the CPU):
    python -m phylo_tpu_torch.cli.score_tree --dataset=primate_data \
        --newick=tree.nwk [--run=<run_dir_or_results.p>]
        [--model=jc69] [--optimize_branches] [--steps=200] [--out=...]
    python -m phylo_tpu_torch.cli.score_tree --dataset=DS1 \
        --model=gtr+g4 --newick=nj.nwk --spr --nni_branch_steps=5

--newick takes a file path or a literal Newick string.  Without
branch lengths in the tree, --optimize_branches is implied (scoring
needs lengths).  --out writes the (possibly refitted) tree back as
Newick with the final lengths.

--dtype defaults to the device's: float64 on the CPU (the JAX CLI's
default), float32 on the card, whose kernels are float32 only.
"""

from __future__ import annotations

import argparse
import os
import pickle


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Fixed-tree log-likelihood (Felsenstein pruning)"
    )
    p.add_argument("--dataset", required=True,
                   help="dataset name or alignment file path")
    p.add_argument("--newick", required=True,
                   help="Newick file path or literal string")
    p.add_argument("--run", default=None,
                   help="run directory or results.p: score under the "
                        "trained best-epoch Q/stationary (FixedQ)")
    p.add_argument("--model", default=None,
                   help="substitution model when --run is not given "
                        "(jc69|reference|gtr|hky|gy94|<paml.dat>, with "
                        "+gN/+i/+rN/+f modifiers; fresh init params; "
                        "default jc69, or gy94 under --codons)")
    p.add_argument("--codons", action="store_true",
                   help="re-encode the DNA alignment as 61 sense "
                        "codons and default the model to GY94 with "
                        "empirical F61 frequencies")
    p.add_argument("--optimize_branches", action="store_true",
                   help="ML-fit branch lengths on the fixed topology")
    p.add_argument("--steps", type=int, default=200,
                   help="optimizer steps for --optimize_branches")
    p.add_argument("--learning_rate", type=float, default=0.05)
    p.add_argument("--dtype", default=None,
                   choices=["float32", "float64"],
                   help="default float64 on the CPU, float32 on cuda")
    p.add_argument("--clamp_negative", action="store_true",
                   help="clamp negative branch lengths (common in NJ "
                        "trees) to 0 instead of rejecting them")
    p.add_argument("--out", default=None,
                   help="write the scored tree (final branch lengths) "
                        "as Newick to this path")
    search_group = p.add_mutually_exclusive_group()
    search_group.add_argument(
        "--nni", action="store_true",
        help="improve the topology by NNI hill-climbing "
             "(search/nni.py) before scoring; all 2(N-2) "
             "neighbors score in one batched sweep per step")
    search_group.add_argument(
        "--spr", action="store_true",
        help="improve the topology by SPR hill-climbing "
             "(search/spr.py): the full prune-regraft "
             "neighborhood scores in one batched sweep per "
             "step (a superset of the NNI moves)")
    p.add_argument("--search_chunk", type=int, default=2048,
                   help="cap on candidates scored per sweep during "
                        "--nni/--spr (larger neighborhoods are split "
                        "into equal-shape chunks; 0 = no cap)")
    p.add_argument("--nni_iters", type=int, default=50,
                   help="max hill-climbing iterations (--nni/--spr)")
    p.add_argument("--nni_branch_steps", type=int, default=20,
                   help="joint branch-length refit steps per search "
                        "iteration (0 keeps candidate lengths fixed; "
                        "applies to --nni and --spr)")
    p.add_argument("--ancestral", default=None,
                   help="reconstruct marginal ancestral states on the "
                        "scored tree; writes argmax sequences as FASTA "
                        "when the path ends in .fasta/.fa, else a .npz "
                        "with the full (V, S, A) posterior (plus "
                        "base-state/rate-category marginals for gamma "
                        "runs)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default cuda; cpu on request)")
    return p.parse_args(argv)


def _load_run_model(run):
    """FixedQ from a run's results.p best-epoch parameters."""
    from phylo_tpu_torch.models.substitution import FixedQ

    path = run
    if os.path.isdir(path):
        path = os.path.join(path, "results.p")
    with open(path, "rb") as f:
        results = pickle.load(f)
    best = int(results.get("best_epoch", -1))
    Q = results["Qmatrices"][best]
    pi = results["stationary_probs"][best]
    return FixedQ(Q, stationary=pi)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from phylo_tpu_torch.dataio import load_dataset
    from phylo_tpu_torch.device import resolve_device, resolve_dtype
    from phylo_tpu_torch.models.substitution import get_model
    from phylo_tpu_torch.pruning.fixed_tree import (
        optimize_branch_lengths,
        parse_newick,
        tree_log_likelihood,
    )
    from phylo_tpu_torch.viz.trees import to_newick

    dev = resolve_device(args.device)
    dtype = resolve_dtype(args.dtype, dev)

    ds = load_dataset(args.dataset)
    if args.codons:
        from phylo_tpu_torch.dataio.codons import codon_dataset

        ds = codon_dataset(ds)
    if args.model is None:
        # None = the flag was not given: default jc69, or GY94 under
        # --codons (an explicit --model always wins, incl. jc69-on-
        # codons)
        args.model = "gy94" if args.codons else "jc69"
    text = args.newick
    if os.path.exists(text):
        with open(text) as f:
            text = f.read()
    taxa, record = parse_newick(text, taxa=list(ds.taxa),
                                clamp_negative=args.clamp_negative)

    genome = np.asarray(ds.genome)
    if args.run:
        model = _load_run_model(args.run)
        if model.A != ds.A:
            # gamma runs save the product-space Q' (G*A x G*A); the
            # observation is category-independent, so tiling the leaf
            # codes across the G blocks scores the exact Gamma-mixture
            # likelihood (models.substitution.GammaSites.expand_leaves)
            G, rem = divmod(model.A, ds.A)
            if rem != 0:
                raise ValueError(
                    f"run model has A={model.A} states but the dataset "
                    f"has A={ds.A}; they are incompatible"
                )
            genome = np.tile(genome, (1, 1, G))
    else:
        model = get_model(args.model, A=ds.A)
        from phylo_tpu_torch.train.trainer import _resolve_codon_frequencies

        model = _resolve_codon_frequencies(model, ds)
        if hasattr(model, "expand_leaves"):
            # product-space mixtures (+g/+i/+r specs): tile leaf codes
            # across the rate-category blocks
            genome = model.expand_leaves(genome)
        if model.A != genome.shape[-1]:
            raise ValueError(
                f"model {args.model!r} has A={model.A} states but the "
                f"dataset has A={ds.A}"
            )
    # only params['model'] participates in fixed-tree scoring (branch
    # lengths come from the record / the ML fit)
    params = {"model": model.init_params(dtype, dev)}
    leaves = torch.as_tensor(np.asarray(genome), device=dev).to(dtype)

    if args.nni or args.spr:
        from phylo_tpu_torch.search import nni_search, spr_search

        search = spr_search if args.spr else nni_search
        res = search(
            leaves, model, params, record, max_iters=args.nni_iters,
            branch_opt_steps=args.nni_branch_steps, verbose=True,
            max_particles=args.search_chunk or None,
        )
        record = res.record
        print(f"{'SPR' if args.spr else 'NNI'} search: "
              f"{res.iterations} iterations, "
              f"log-likelihood {res.log_likelihood:.6f}")

    branches = record.get("branches")
    optimize = args.optimize_branches or branches is None
    if optimize:
        branches, ll = optimize_branch_lengths(
            leaves, model, params, record, steps=args.steps,
            learning_rate=args.learning_rate,
        )
        record = dict(record, branches=branches.cpu().numpy())
        print(f"optimized branch lengths ({args.steps} steps)")
    else:
        with torch.no_grad():
            ll = tree_log_likelihood(leaves, model, params, record)

    src = args.run or args.model
    print(f"dataset: {ds.name}  N={ds.N} S={ds.S} A={ds.A}")
    print(f"model: {src}")
    print(f"log P(Y | tree, theta) = {float(ll):.6f}")

    if args.ancestral:
        from phylo_tpu_torch.pruning.ancestral import (
            ancestral_marginals,
            collapse_categories,
            decode_states,
        )

        with torch.no_grad():
            post, _ = ancestral_marginals(leaves, model, params, record)
        post = post.cpu().numpy()
        N = ds.N
        names = list(taxa) + [f"node{N + q}" for q in range(N - 1)]
        names[-1] = "root"
        G = model.A // ds.A
        base_post = post
        cat_post = None
        if G > 1:      # gamma run: collapse the product space
            bp, cp = collapse_categories(torch.as_tensor(post), G)
            base_post, cat_post = bp.numpy(), cp.numpy()
        conf = float(base_post[N:].max(axis=-1).mean())
        print(f"ancestral reconstruction: mean internal-node argmax "
              f"probability {conf:.4f}")
        if args.ancestral.endswith((".fasta", ".fa")):
            alphabet = ("ACGT" if ds.A == 4 else None)
            if alphabet is None:
                from phylo_tpu_torch.dataio.alphabets import (
                    PROTEIN_ALPHABET,
                )

                alphabet = (PROTEIN_ALPHABET
                            if ds.A == len(PROTEIN_ALPHABET)
                            else "".join(chr(65 + i) for i in range(ds.A)))
            seqs = decode_states(base_post, alphabet)
            with open(args.ancestral, "w") as f:
                for name, seq in zip(names, seqs):
                    f.write(f">{name}\n{seq}\n")
        else:
            arrays = dict(post=post, merges=np.asarray(record["merges"]),
                          branches=np.asarray(record["branches"]),
                          names=np.asarray(names))
            if cat_post is not None:
                arrays["base_post"] = base_post
                arrays["rate_category_post"] = cat_post
            np.savez(args.ancestral, **arrays)
        print(f"ancestral states written to {args.ancestral}")
    if args.out:
        with open(args.out, "w") as f:
            f.write(to_newick(taxa, record) + "\n")
        print(f"tree written to {args.out}")
    return float(ll)


if __name__ == "__main__":
    main()
