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
and VNCSMC at K=32, M=10 (K11b, K8); DS1 GTR+G4 at K=2048 (K10's
forward); GY94 on betacorona1's 1086 codons at K=128 (K9f); and on
chip_smoke.py's simulated 16 x 500 protein alignment (written from seed
0) protein + Gamma4 at K=256 (K9f blocked), protein + Gamma8 at K=256
(K9f blocked over 160 planes) and VNCSMC protein + Gamma4 at K=32, M=10
(K11b blocked, K8's plain twin at 80 planes).  No-grad sweeps, the
runner's initial parameters and sweep configuration.

    python tools/parity_torch.py [n_sweeps] [out.json] [cell,...]

The third argument picks cells by label (all by default).

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
TWIST = {"nested": True, "M": cs.M_TWIST}
# (label, dataset, K, TrainConfig fields, codons)
CELLS = (
    ("primate VCSMC K=2048", "primate_data", cs.K, {}, False),
    ("primate VNCSMC K=32 M=10", "primate_data", cs.K_TWIST, TWIST, False),
    ("DS1 GTR+G4 K=2048", "hohna_data_1", cs.K,
     {"substitution_model": "gtr+g4"}, False),
    ("GY94 betacorona1 K=128", "betacorona1", cs.K_CODON,
     {"substitution_model": "gy94"}, True),
    ("protein+G4 K=256", cs.PROT_FASTA, cs.K_PROT,
     {"gamma_categories": cs.G_GAMMA}, False),
    ("protein+G8 K=256", cs.PROT_FASTA, cs.K_PROT,
     {"gamma_categories": cs.G_GAMMA8}, False),
    ("VNCSMC protein+G4 K=32 M=10", cs.PROT_FASTA, cs.K_TWIST,
     dict(TWIST, gamma_categories=cs.G_GAMMA), False),
)
PICK = sys.argv[3].split(",") if len(sys.argv) > 3 else None


def sweeps(dataset, K, extra, codons, device, dtype, seeds):
    """ELBOs of no-grad sweeps at the runner's initial parameters, one a
    seed, after a warm-up sweep; returns (elbos, seconds a sweep, the
    kernels' launches)."""
    from phylo_tpu_torch import _ext
    from phylo_tpu_torch.smc.sweep import sample_phylogenies
    from phylo_tpu_torch.train.trainer import (
        TrainConfig, _sweep_config, init_params,
    )

    ds = cs.load(dataset, codons)
    config = TrainConfig(n_particles=K, device=device, dtype=dtype,
                         **extra)
    model, params = init_params(ds, config)
    sweep_cfg = _sweep_config(config)
    genome = ds.genome
    if hasattr(model, "expand_leaves"):
        genome = model.expand_leaves(genome)
    leaves = torch.tensor(genome, dtype=params["branches"][
        "log_rates_l"].dtype, device=device)
    gen = torch.Generator(device=device)
    out = []
    with torch.no_grad():
        # a warm-up sweep (the card builds its kernels at first use)
        sample_phylogenies(gen, leaves, model, params, sweep_cfg)
    _ext.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        for seed in seeds:
            gen.manual_seed(seed)
            out.append(float(sample_phylogenies(
                gen, leaves, model, params, sweep_cfg).elbo))
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
    card = cs.card_line()
    rows = []
    for label, dataset, K, extra, codons in CELLS:
        if PICK and label not in PICK:
            continue
        gpu, gpu_s, launches = sweeps(dataset, K, extra, codons, "cuda",
                                      "float32", seeds)
        cpu, cpu_s, _ = sweeps(dataset, K, extra, codons, "cpu", "float64",
                               seeds)
        c, h = np.asarray(gpu), np.asarray(cpu)
        se = float(np.sqrt(c.var(ddof=1) / len(c) + h.var(ddof=1) / len(h)))
        gap = float(abs(c.mean() - h.mean()))
        row = {"cell": label, "n_sweeps": N_SWEEPS,
               "card_f32": {**stats(gpu), "seconds_a_sweep": gpu_s,
                            "launches": launches},
               "cpu_f64": {**stats(cpu), "seconds_a_sweep": cpu_s},
               "gap_nats": gap, "combined_se": se, "gap_in_se": gap / se,
               "pass_3se": gap <= 3 * se}
        print(json.dumps(row), flush=True)
        rows.append(row)
        # written after every cell, so a cut run keeps the cells done
        os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
        with open(OUT, "w") as f:
            json.dump({"card": card, "cells": rows}, f, indent=1)
    print(card)
    return 0 if all(r["pass_3se"] for r in rows) else 2


if __name__ == "__main__":
    sys.exit(main())
