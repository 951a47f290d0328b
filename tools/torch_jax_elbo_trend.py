"""Train one configuration with the JAX runner and with the port's runner
on the CPU and compare how their ELBOs move over the epochs.

Both runners are started as subprocesses with the same flags (the port's
with --device=cpu), once per seed; the ELBO after every epoch is read
from their logs ("epoch i/n  ELBO x").  Prints one JSON line per run and
a summary per runner: the mean over seeds of the least-squares slope of
the ELBO per epoch, its standard error across seeds, the mean ELBO of
the first and the last quarter of the epochs, and the standard deviation
of one epoch's ELBO about each run's line (the estimate's noise).

    python tools/torch_jax_elbo_trend.py --dataset=results/chip_smoke/protein_16x500.fa \
        --epochs=20 --seeds=0,1,2,3 -- --gamma_categories=4 --n_particles=32

Flags after `--` go to both runners.  chip_smoke.py writes that FASTA
(seed 0) in its phase 1; `python -c "import chip_smoke;
chip_smoke.protein_files()"` writes it on any machine.
"""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH = re.compile(r"^epoch\s+(\d+)/\d+\s+ELBO\s+(-?[0-9.]+)", re.M)
INIT = re.compile(r"Initial evaluation of ELBO:\s+(-?[0-9.]+)")
RUNNERS = {"jax": ["phylo_tpu.cli.runner"],
           "torch": ["phylo_tpu_torch.cli.runner", "--device=cpu"]}


def run(which, dataset, epochs, seed, extra):
    module, *own = RUNNERS[which]
    cmd = [sys.executable, "-m", module, f"--dataset={dataset}",
           f"--num_epoch={epochs}", f"--seed={seed}", "--no_artifacts",
           *own, *extra]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, check=True).stdout
    return (float(INIT.search(out).group(1)),
            [float(m.group(2)) for m in EPOCH.finditer(out)])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--seeds", default="0,1,2,3")
    args = ap.parse_args(argv[:argv.index("--")] if "--" in argv else argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    q = max(1, args.epochs // 4)
    for which in RUNNERS:
        slopes, first, last, resid = [], [], [], []
        for seed in seeds:
            init, elbo = run(which, args.dataset, args.epochs, seed, extra)
            e = np.arange(1, len(elbo) + 1)
            slope, icpt = np.polyfit(e, elbo, 1)
            slopes.append(slope)
            first.append(np.mean(elbo[:q]))
            last.append(np.mean(elbo[-q:]))
            resid.append(np.std(np.asarray(elbo) - (slope * e + icpt),
                                ddof=2))
            print(json.dumps({"runner": which, "seed": seed, "init": init,
                              "elbo": elbo, "slope": slope}), flush=True)
        print(json.dumps({
            "runner": which, "flags": extra, "epochs": args.epochs,
            "seeds": seeds, "slope_mean": float(np.mean(slopes)),
            "slope_se": float(np.std(slopes, ddof=1) / np.sqrt(len(seeds)))
            if len(seeds) > 1 else None,
            "first_quarter_mean": float(np.mean(first)),
            "last_quarter_mean": float(np.mean(last)),
            "epoch_noise_sd": float(np.mean(resid))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
