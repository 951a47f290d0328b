"""Experiment sweep runner -- the role of the reference's autorun.sh
(reference autorun.sh:1-12: bash loop over K values with repeats); port
of phylo_tpu/cli/sweep_runner.py, with ``--device`` (default ``cuda``).

Runs a grid of (K, seed) training configurations sequentially and writes
``<results_dir>/sweep_summary.json``.  Usage:

    python -m phylo_tpu_torch.cli.sweep_runner --dataset=primate_data \
        --K_list=32,64 --repeats=3 --num_epoch=100 --nested=true
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="primate_data")
    p.add_argument("--K_list", default="32,32,32,64,64,64",
                   help="comma-separated particle counts (repeats by "
                   "listing, like autorun.sh)")
    p.add_argument("--repeats", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--num_epoch", type=int, default=100)
    p.add_argument("--M", type=int, default=10)
    p.add_argument("--nested", type=lambda x: str(x).lower() == "true",
                   default=False)
    p.add_argument("--jcmodel", type=lambda x: str(x).lower() == "true",
                   default=False)
    p.add_argument("--results_dir", default="./results")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default cuda; cpu on request)")
    args = p.parse_args(argv)

    from phylo_tpu_torch.dataio import load_dataset
    from phylo_tpu_torch.train import TrainConfig, train

    ds = load_dataset(args.dataset)
    ks = [int(k) for k in args.K_list.split(",")]

    summary = []
    for rep in range(args.repeats):
        for i, K in enumerate(ks):
            seed = rep * 1000 + i
            cfg = TrainConfig(
                n_particles=K,
                batch_size=args.batch_size,
                learning_rate=args.learning_rate,
                num_epoch=args.num_epoch,
                M=args.M,
                nested=args.nested,
                jcmodel=args.jcmodel,
                seed=seed,
                dtype=args.dtype,
                results_dir=args.results_dir,
                collect_trees=False,
                log_every=0,
                device=args.device,
            )
            t0 = time.time()
            res = train(ds, cfg)
            summary.append(dict(
                K=K,
                seed=seed,
                final_elbo=res.elbo,
                best_elbo=float(max(res.history["elbo"])),
                wall_s=time.time() - t0,
                save_dir=res.save_dir,
            ))
            print(f"K={K} seed={seed}: best ELBO "
                  f"{summary[-1]['best_elbo']:.3f} "
                  f"({summary[-1]['wall_s']:.1f}s)")

    out = os.path.join(args.results_dir, "sweep_summary.json")
    os.makedirs(args.results_dir, exist_ok=True)
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
