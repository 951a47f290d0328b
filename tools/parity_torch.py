"""Distributional ELBO parity of the port on the card against its CPU
float64 path.

The sweep's ELBO is a random variable: a sweep's draws (resampling, pair
proposals, branch lengths) come from a generator, and the card's and the
CPU's generators give different streams.  So the check is on the
distribution: n sweeps under n seeds at the SAME initial parameters on
each path -- the card in float32 through the CUDA kernels, the CPU in
float64 through the plain versions -- and the two means must agree
within 3 combined standard errors (the JAX package's tools/parity_tpu.py
check, for the port).

Cells: primate VCSMC at K=2048 (ReferenceQ, all 898 sites: K1's path)
and protein + Gamma8 at K=256 on chip_smoke.py's simulated 16 x 500
protein alignment (written from seed 0; K9f blocked's path over 160
planes).  No-grad sweeps, the runner's initial parameters.

    python tools/parity_torch.py [n_sweeps] [out.json]

Needs a CUDA card.  Prints one JSON object per cell and writes them all,
with the card's name and power limit, to out.json (default
results/parity_torch.json).
"""

import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

N_SWEEPS = int(sys.argv[1]) if len(sys.argv) > 1 else 12
OUT = (sys.argv[2] if len(sys.argv) > 2
       else os.path.join(REPO, "results", "parity_torch.json"))
CELLS = (
    ("primate VCSMC K=2048", "primate_data", cs.K, {}),
    ("protein+G8 K=256", cs.PROT_FASTA, cs.K_PROT,
     {"gamma_categories": cs.G_GAMMA8}),
)


def sweeps(dataset, K, extra, device, dtype, seeds):
    """ELBOs of no-grad sweeps at the runner's initial parameters, one a
    seed, after a warm-up sweep; returns (elbos, seconds a sweep, the
    kernels' launches)."""
    from phylo_tpu_torch import _ext
    from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies
    from phylo_tpu_torch.train.trainer import TrainConfig, init_params

    ds = cs.load(dataset)
    model, params = init_params(ds, TrainConfig(
        n_particles=K, device=device, dtype=dtype, **extra))
    genome = ds.genome
    if hasattr(model, "expand_leaves"):
        genome = model.expand_leaves(genome)
    leaves = torch.tensor(genome, dtype=params["branches"][
        "log_rates_l"].dtype, device=device)
    gen = torch.Generator(device=device)
    out = []
    with torch.no_grad():
        # a warm-up sweep (the card builds its kernels at first use)
        sample_phylogenies(gen, leaves, model, params, SweepConfig(K=K))
    _ext.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        for seed in seeds:
            gen.manual_seed(seed)
            out.append(float(sample_phylogenies(
                gen, leaves, model, params, SweepConfig(K=K)).elbo))
    if device == "cuda":
        torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / len(seeds)
    return out, secs, dict(_ext.LAUNCHES)


def stats(x):
    x = np.asarray(x)
    return {"mean": float(x.mean()), "sd": float(x.std(ddof=1)),
            "elbos": x.tolist()}


def main():
    if not torch.cuda.is_available():
        print("parity_torch: no CUDA device visible", file=sys.stderr)
        return 1
    cs.protein_files()
    seeds = [1000 + i for i in range(N_SWEEPS)]
    rows = []
    for label, dataset, K, extra in CELLS:
        card, card_s, launches = sweeps(dataset, K, extra, "cuda",
                                        "float32", seeds)
        cpu, cpu_s, _ = sweeps(dataset, K, extra, "cpu", "float64", seeds)
        c, h = np.asarray(card), np.asarray(cpu)
        se = float(np.sqrt(c.var(ddof=1) / len(c) + h.var(ddof=1) / len(h)))
        gap = float(abs(c.mean() - h.mean()))
        row = {"cell": label, "n_sweeps": N_SWEEPS,
               "card_f32": {**stats(card), "seconds_a_sweep": card_s,
                            "launches": launches},
               "cpu_f64": {**stats(cpu), "seconds_a_sweep": cpu_s},
               "gap_nats": gap, "combined_se": se, "gap_in_se": gap / se,
               "pass_3se": gap <= 3 * se}
        print(json.dumps(row), flush=True)
        rows.append(row)
    card = cs.card_line()
    os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"card": card, "cells": rows}, f, indent=1)
    print(card)
    return 0 if all(r["pass_3se"] for r in rows) else 2


if __name__ == "__main__":
    sys.exit(main())
