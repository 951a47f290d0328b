"""Smoke test of the PyTorch/CUDA port (phylo_tpu_torch) on one GPU.

    python3 chip_smoke.py [--ptxas] [--phase8] [--phase9]

Phases, each printing a line of its own; any failure raises and the
script exits non-zero without printing a result:

1. build every kernel from csrc/ (one nvcc per source, in parallel) and
   read the card (nvidia-smi name and power limit);
2. each kernel against its plain PyTorch version on the card at the main
   paths' shapes (VCSMC: K=2048 particles, S=256 and 898 sites, 45,056
   transition matrices; VNCSMC: K=32 chosen merges, M=10 subsamples of
   32 x 66 candidate pairs; GTR+G4 on DS1: K=2048, G=4 rate blocks of
   A=4, S=256 and 1949, and G=5 (+I), the rank forward also untimed at
   G=2 and 3 blocks of 4 and at 8 states (G=1 and 4 blocks); K4 on
   primate's 45,056 matrices,
   DS1 GTR+G4's 425,984 a step and the twist's DS1 rank-0 898,560 and
   last-rank 7,680, each with every fourth branch past the clamp too,
   and untimed at B = 1, 7, 255, 257, 4,099, at (order, squarings) =
   (8, 6) and on GTR+G4+I, with two backward calls bit-identical and one
   device kernel a wrapper call (a captured CUDA graph); GY94 codons: K9 at
   K=128, A=61, S=256 and 1086, and A=100, A=20 at a small shape, the
   all-planes-tied case included; protein+G4: K9 blocked at K=256, G=4
   blocks of A=20, S=256 and 500, K9bs blocked at K=64, and G=5 (+I)
   and all planes tied, and the block-group forms forced there (1 and 2
   blocks a group) against the one-group body (the column, dm, dP, dpi
   and dw to the bit); over 128 planes, protein+G8 (8 x 20) at K=256,
   S=256 and 500 and K=32, and GY94+G4 (4 x 61: the backward in block
   groups) at K=128, S=256 and 1086, all planes tied too; VNCSMC's pair log-likelihoods at rank 0: K11b at
   primate (A=4, KC=2,112) and at DS1 GTR+G4 (KC=11,232) blocked (G=4 blocks of
   4, as the twist takes a rate mixture) and dense (the same
   transitions as 16 block-diagonal states), each in an A/B against the
   plain forward, K7 wide blocked and dense and K11c at DS1 KC=896 and
   timed at KC=11,232, K11b and K7 wide dense at GY94's rank 0 (61
   states, KC = 32 x 136, S=256) beside their plain versions (every K7
   wide and K11c call's dP held entry by entry, its dpi entry by entry
   against the sum of its terms' magnitudes), K11c
   (K7's bodies in their T-field form) also at
   primate rank 0 (A=4, KC=2,112, where phase 4 launches it), untimed
   at the later ranks' KC=480 and 32 (4 and 8 warps a row) and small,
   each K11c shape called twice through its launcher (the same bits)
   and once captured (one device kernel), the blocked forms against the
   dense ones (1e-6)
   with their A/B, dense A=20 and 61 and blocked 5 x 4, 2 x 20, 3 x 7
   and 4 x 4 over two site chunks small; over 64 planes, protein+G4's
   G=4 blocks of 20 at rank 0 (KC=3,840: K11b blocked in block groups,
   K7 wide blocked and K11c blocked at KC=896 and timed at 3,840), the
   plan's block groups against one group and 2 a group (dm to the bit),
   and 3 x 20, 8 x 20, 4 x 61 and 17 x 4 over two site tiles small;
   K11a at A=4, 16 and 61 (its wide body), and at 4 and 8 blocks of 20),
   with the tolerances printed, and
   timed beside the plain version, the least time the card could take
   (bound) and, where one exists, a single PyTorch library call; the
   Jacobi eigh kernel of the spectral transitions (float64) against
   torch.linalg.eigh at .dat's 20 states, GY94's 61, a random 64 and
   the collapsed 9-state JC69 (eigenvalues, reconstruction and
   orthogonality 1e-12, the backward 1e-9 relative L2), timed beside
   it, and on a matrix holding a NaN or an infinity (NaN out, no launch
   error), and under a lowered sweep cap at .dat's and GY94's matrices
   (their own sweeps: the uncapped bits; one fewer: NaN); K5 at
   K=2048 and at VNCSMC's K=32, with some particles at weight 0 (-inf,
   never drawn), by chi-square beside torch.multinomial; and the
   saved-children route (K10 saving + K10's backward) against the
   re-gather route (K10 + K3) at the DS1 step shape, the trade
   SAVE_CHILDREN_CAP decides (also at primate's K=2048, S=256: K1 saving
   + K2 against K1 + K3, both backwards now one body); the rank forward
   K1 and K10 (one body, `fused_rank_fwd_kernel`) with the L2 -> SM
   bytes of its one pass beside the DRAM byte bound; the rank
   backwards K2 and K3 (the dense form of K3 blocked's body, the
   all-planes-tied case too), K3 blocked (timed at DS1 S=256 and 1949),
   K10's saved backward, K9f, K9bs and K9b (dense and blocked), K11a
   (A=4 and 16, with and without dw), K7 (primate rank 0, ragged S=300,
   the last rank's KC=32, and A=3 and 8 small; the launcher alone) and
   K1, K10's forward, K5 and K8 each also called twice (the same bits)
   and once captured
   as a CUDA graph (one device kernel a wrapper call, of the named body),
   their times printed beside the former design's, K8's beside the launch
   floor (an empty kernel on the same sleep-held stream);
3. fixed-decision ELBO: the sweep in float32 on the card through the
   kernels against float64 on the CPU through the plain path, with the
   same numpy-made decisions (1e-3 relative, BASELINE.md's bar), and
   the manual-VJP gradients likewise, for VCSMC (K=2048; S=256 under
   SAVE_CHILDREN_CAP: K2, all 898 sites over it: K3), VNCSMC (K=32,
   M=10), GTR+G4 (primate K=512 S=256, under the cap: K10's
   saved-children backward; DS1 K=128 S=1949, over it: K3 blocked) and
   GY94 on betacorona1's codons (K=128; S=256 under the cap: K9bs; all
   1086 codons over it: K9b), after a probe of GY94's transitions from a
   float32 eigh (why expm_reversible works in float64), and protein+G4
   on the simulated 16 x 500 protein alignment (K=64, S=256: K9bs
   blocked; K=256, all 500 sites: K9b blocked) and .dat+F+G4 on it
   (K=64, S=256: K9bs blocked, spectral transitions through the eigh
   kernel), and VNCSMC K=32, M=10
   (primate with the defaults: K11b, K7, K11a; with the plain forward;
   with the T-field backward K11c; GTR+G4 on DS1's first 10 taxa at
   S=256: K11b and K7 wide blocked, K11a at 16 dense states, and again
   with the T-field backward: K11b and K11c blocked), and VNCSMC
   protein+G4 and .dat+F+G4 on the simulated alignment's first 6 taxa
   and 128 sites under both backwards (K11b, K7 wide and K11c blocked,
   K11a at 80 planes), each against one CPU run; protein+G8 (K=256,
   S=256: K9b blocked), GY94+G4 (K=128, S=256: K9b blocked in block
   groups) and VNCSMC protein+G8 (6 taxa, 128 sites: K11a on 8 blocks
   of 20), and VNCSMC GY94 on betacorona1's first 5 taxa and 64 codons
   (K11b and K7 wide dense at 61 states, K11a's wide body, the eigh
   kernel) in one pair chunk a rank and again with pair_chunk=4 on the
   card (rank 0 in 3 uneven chunks), against the same CPU run and the
   two card runs against each other (1e-5; the chunks' extra launches
   exact);
4. the main paths: two epochs each of VCSMC training on primate (N=12,
   S=898) at K=2048, of VNCSMC (twisted) training at K=32, M=10, of
   GTR+G4 VCSMC training on DS1 (N=27, S=1949) at K=2048, of GY94
   codon VCSMC training on betacorona1 (N=17, 1086 codons, A=61) at
   K=128, of protein+G4 training (ReferenceQ(A=20) under GammaSites G=4)
   at K=256 and of an empirical .dat+F+G4 protein model at K=64 on a
   16 x 500 protein alignment that the script simulates from seed 0, of
   VNCSMC GTR+G4 on DS1 at K=32, M=10 (K11b and K7 wide blocked, K11a;
   the ELBOs and seconds per epoch beside PR 6's), and of
   primate VNCSMC again with the T-field backward K11c (66 launches), of
   VNCSMC protein+G4 at K=32, M=10 on the simulated alignment (K11b and
   K7 wide blocked over block groups, K11a at 80 planes; exact launch
   counts) and again with the T-field backward (K11c blocked), of
   protein+G8 at K=256 and VNCSMC protein+G8 at K=32, M=10 on the same
   alignment and GY94+G4 on betacorona1's codons at K=128 (exact launch
   counts each), of VNCSMC over the spectral models at K=32, M=10 (GY94
   on betacorona1's codons: K11b and K7 wide dense at 61 states, K11a's
   wide body; GY94+G4: K11b and K7 wide blocked, 4 blocks of 61;
   .dat+F+G4 on the protein alignment), their pair chunks from
   TwistConfig.chunk_budget_mb (each rank's chunks printed, exact launch
   counts from the same rule), and of GY94+G8 VCSMC at K=128 (488
   planes: K9f blocked's group body, 2 blocks a group), each with its
   peak torch.cuda.max_memory_allocated printed, site
   batch 256, through phylo_tpu_torch.cli.runner, with every kernel's
   launch counter set to 0 before each path and read after, under the
   default fused epoch (the captured paths' SGD steps and eval sweeps as
   CUDA graph replays: steps and steps + 1 of them in epochs 1 and 2;
   the launch counts through the graphs' bookkeeping);
5. where the time of the second epoch of each path goes (under the
   default fused epoch), under torch.profiler: device time, busy share,
   host dispatches and graph launches
   (K4f's, K4b's, K9f's and K5's device time and launches on every path,
   the rank forward's (K1, K10), and the rank backwards' (K2, K3, K3
   blocked / K10's backward and K11a at 4 states: one body; the wide
   body of K9bs, K9b and K11a), K7's,
   K11c's and K8's;
   for VNCSMC GTR+G4 on DS1 (one SGD step, a graph replay: its loop
   epoch's half a million launches took the profiler's summary minutes),
   K11b's, K7 wide's
   and K4's device time beside an epoch's earlier, and for VNCSMC
   protein+G4 and protein+G8 K11b's and K7 wide's; the block-group
   bodies' device time on every path);
6. a training run's life cycle at the main path's width (primate VCSMC,
   K=2048, b256), in a temporary directory: two epochs through the
   runner with artifacts and a checkpoint an epoch (the main path's
   kernels launched; the checkpoints, two best-particle Newick strings
   naming the 12 taxa with 22 finite positive branch lengths, two epochs
   of 2048 jump chains; the seconds an epoch and, rerun on each epoch's
   arrays, the host seconds of the best Newick, JAX's decode-all rule,
   the jump chains and the checkpoint), epoch_2 restored on the card and
   on the CPU (params and optimizer state the run's to the bit) and its
   no-grad eval with epoch 2's generator (the run's ELBO to the bit), a
   resume to 3 epochs (the first two ELBOs the run's to the bit; the
   third beside an uninterrupted run's), cli.trees on it, train_elastic
   through an injected fault, two seed replicas, the sweep runner at
   K=32 and 64, and a torch.profiler trace of one eval sweep naming K1's
   and K5's kernels;
7. the tree tools through their CLIs at full width, each with the launch
   counters set to 0 just before and read just after, its wall seconds
   printed: (a) model_select over the 12-model DNA ladder on primate's
   neighbour-joining tree (100 Adam steps a model; K4f and K4b), after
   that tree's GTR score at the initial parameters on the card (f32)
   against the CPU (f64) within 1e-5 relative; (b) score_tree under GTR
   on (a)'s winning tree with --optimize_branches and --ancestral (K4f,
   K4b; 23 FASTA sequences); (c) score_tree --spr --nni_branch_steps=5
   --nni_iters=2 on DS1 GTR+G4 from its NJ tree, the neighbourhood in
   K=2048 chunks over all 1949 sites (K10 forward, K3 blocked backward,
   K4), after one chunk's scores on the card against 64 of them rescored
   on the CPU in float64 (1e-5 relative); the search must not end below
   its starting tree; (d) bootstrap, 10 replicates at K=2048 (K1, K5):
   supports in [0, 1], a consensus naming each taxon once; (e) the CSMC
   oracle at K=64 with resampling, float64 on the card: the CPU run's
   merged_nodes and ancestors at the same seed, its norm to 1e-10 and
   its log weights to 1e-10 relative; then a torch.profiler trace of a
   refit step, a fit step and a bootstrap sweep must name the rank
   forward and backward, K4's two kernels and K5's.
8. the mesh on the one card (phylo_tpu_torch.parallel): (a) primate
   VCSMC K=2048 b256, 2 epochs through the runner with --mesh=1 (NCCL,
   a world of one) bit-identical to the run without a mesh, the
   all-reduces called all the same; then two ranks in child processes
   of this script sharing the card over gloo (NCCL refuses a duplicate
   GPU): (b) an ('s',) mesh of 2 on DS1 GTR+G4 over all 1949 sites
   (K10's forward and K3 blocked per shard): K=128 under phase 3's
   decisions against its CPU float64 run, and K=2048 against the
   one-rank card run (1e-3 ELBO, 1e-2 gradients), a seeded training
   epoch at K=2048 b256 (finite ELBOs, parameters bit-identical across
   ranks) and rank 0's trace of an SGD step naming the rank forward and
   backward; (c) a ('k',) mesh of 2 on primate VCSMC K=2048 (the child
   exchange, K8, K11a and K4 per shard) against phase 3's CPU float64
   run, and a seeded sweep (K5 on the gathered weights); (d) primate
   VNCSMC K=32, M=10 on an ('s',) mesh of 2 (K11b, K7, K11a, K8 per
   shard) against phase 3's CPU run; (e) the data cotangents of item 8b
   (dleaves, dw) are phase 3's lines of primate K=2048 S=256 (K2) and
   DS1 GTR+G4 K=128 (K3 blocked); (e) primate VNCSMC K=32 on the ('k',)
   mesh of 2, twice: the ELBO and gradients the same bits both times
   (the roots' cotangents summed in a fixed order), and against phase
   3's CPU float64 run.  Each rank prints its launches, its
   collective calls and bytes a sweep and its wall seconds; a rank that
   fails fails the script.  `--phase8` runs phase 1, those phase-3
   checks and phase 8 alone, without a result line.
9. the fused epoch (TrainConfig.fused_epoch): primate VCSMC K=2048,
   primate VNCSMC K=32 M=10, DS1 GTR+G4 K=2048, VNCSMC protein+G4
   K=32 M=10 and the spectral paths GY94 K=128, GY94+G4 K=128,
   .dat+F+G4 K=64 and VNCSMC GY94 and .dat+F+G4 K=32 M=10, each 2 epochs
   twice with fused_epoch=False (the
   loop) and twice with True: the same launch counts, graph replays of
   the steps and steps + 1 in epochs 1 and 2, the ELBOs and final
   parameters the loop's to the bit on primate VCSMC, on the spectral
   paths (whose loops must repeat themselves) and wherever the loop
   repeats itself (else within the loops' spread and 1e-6 relative);
   printed both ways: seconds an epoch, capture seconds, peak memory,
   and the second epoch's profile (host dispatches, graph launches,
   busy share); DS1 VNCSMC twice under the default, its ELBOs and
   parameters to the bit; sample_phylogenies_with_buffer's two sweeps
   into one leaf buffer against the plain sweep, to the bit (K1 on
   primate K=2048, K9f blocked on protein+G4, K9f on GY94).
   `--phase9` runs phase 1 and phase 9 alone, without a result line.

The kernels line's launches are phase 4's, phase 7's and phase 8's
(every rank's).  The last lines are the kernel table as JSON, the card's
name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import pickle
import re
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and FP32 (non-tensor)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP64 on the tensor cores (NVIDIA's H100 SXM data sheet)
FP64_TC_OPS_PER_S = 67e12
K, N, S_BATCH, S_FULL, A = 2048, 12, 256, 898, 4
K_TWIST, M_TWIST = 32, 10          # VNCSMC: reference autorun.sh
R = N - 1
N_DS1, S_DS1, G_GAMMA = 27, 1949, 4   # DS1 (hohna_data_1), GTR+G4
# betacorona1 as 61 sense codons under GY94 (BENCH_DETAILS.json
# codon_gy94_step: 17 x 1086, K=128)
K_CODON, N_CODON, S_CODON, A_CODON = 128, 17, 1086, 61
# protein + Gamma4 (bench.py protein_gamma_step: "simulated protein
# 16x500 A=20 GammaSites G=4 K=256"); K9bs blocked runs below the
# SAVE_CHILDREN_CAP at K=64
K_PROT, K_PROT_SAVED, N_PROT, S_PROT, A_PROT = 256, 64, 16, 500, 20
# rate mixtures over more than 128 planes (K9 blocked in block groups
# where one does not fit): protein + Gamma8 (IQ-TREE's +G8, MrBayes'
# ngammacat=8) on the same alignment, GY94 + Gamma4 on betacorona1
G_GAMMA8, G_GY94, G_GY94G8 = 8, 4, 8
PROT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results", "chip_smoke")
PROT_FASTA = os.path.join(PROT_DIR, "protein_16x500.fa")
PROT_DAT = os.path.join(PROT_DIR, "protein_seed0.dat")
SLEEP_CYCLES = 100_000_000         # ~50 ms at the H100's ~2 GHz clock
# the rank backward's one body (K2, K3, K11a at A <= 8: its dense form)
RANK_BWD_KERNEL = "fused_rank_bwd_blocked_kernel"
# the rank forward's one body (K1: its dense form; K10's forward)
RANK_FWD_KERNEL = "fused_rank_fwd_kernel"
# Phase-2 times of the redesigned kernels on their former design (ms,
# PERF.md's kernel table: this script on an NVIDIA H100 80GB HBM3 at
# 700 W), keyed by (kernel, particles, states a block, sites)
FORMER_MS = {("K2", K, 4, 256): 0.0489, ("K3", K, 4, 256): 0.0373,
          ("K10 bwd-saved", K, 4, 256): 0.2002,
          ("K3 blocked", K, 4, 256): 0.1746,
          ("K9bs", 128, 61, 256): 0.3026, ("K9bs", 128, 61, 1086): 1.2451,
          ("K9b", 128, 61, 256): 0.2618, ("K9b", 128, 61, 1086): 1.1591,
          ("K9bs blocked", 64, 20, 256): 0.1667,
          ("K9bs blocked", 256, 20, 256): 0.3930,
          ("K9bs blocked", 256, 20, 500): 0.7759,
          ("K9b blocked", 256, 20, 256): 0.3579,
          ("K9b blocked", 256, 20, 500): 0.7156,
          ("K11a", 32, 4, 256): 0.0388, ("K11a", 32, 16, 256): 0.0653,
          # K9f (one block a 32-site tile) and K5 (the Gumbel field)
          ("K9f save", 128, 61, 256): 0.0678, ("K9f", 128, 61, 256): 0.0659,
          ("K9f save", 128, 61, 1086): 0.2503,
          ("K9f", 128, 61, 1086): 0.2409,
          ("K9f blocked", 256, 20, 256): 0.0775,
          ("K9f blocked", 256, 20, 500): 0.1456,
          ("K5", 2048, 1, 1): 0.0170,
          # K7 (a 128-thread block a row, a block-wide dP sum per m)
          ("K7", 2112, 4, 256): 0.1497,
          # K11c (the former tile body: 256 threads a row, 32-site
          # tiles, T in global memory, dP from T by two matmuls in the
          # wrapper; at primate's shape first timed by the one-call A/B
          # of tools/torch_k11c_k8_forms.py --parent, through its wrapper)
          ("K11c", 896, 16, 256): 1.0867, ("K11c", 11232, 16, 256): 12.176,
          ("K11c", 2112, 4, 256): 0.4650,
          # K8 (128 threads a particle walking its sites)
          ("K8", 32, 4, 256): 0.0037, ("K8", 32, 4, 898): 0.0067,
          # K1 and K10's forward (a thread a site striding by 128; K10
          # reading a blocked site's children twice)
          ("K1 save", K, 4, 256): 0.0120, ("K1", K, 4, 898): 0.0219,
          ("K10 save", K, 4, 256): 0.0443, ("K10", K, 4, 256): 0.0266,
          ("K10 G=5 save", K, 4, 256): 0.0532, ("K10", K, 4, 1949): 0.2631}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    """Device milliseconds per call of fn, by CUDA events around `iters`
    calls.  A sleep kernel holds the stream while the host enqueues the
    calls, so a small kernel's time is its own and not the rate at which
    Python launches it (without it, K8 at K=32 read 0.049 ms, the
    wrapper's host cost)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_rel(a, b):
    a = a.double().cpu()
    b = b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def entry_rel(a, b, scale=None):
    """Entry by entry: the largest |a - b| / (scale + 1e-30), scale |b|
    where not given, and the median |b|, on the device (a float32
    tensor's entries span many decades, where a ratio of maxima holds
    only the largest)."""
    scale = b.float().abs() if scale is None else scale
    d = (a.float() - b.float()).abs() / (scale + 1e-30)
    return float(d.max()), float(b.float().abs().median())


def max_abs(a, b):
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def require(ok, what):
    if not ok:
        raise AssertionError(what)


def protein_files():
    """The protein paths' inputs, written from seed 0 under results/: a
    PAML .dat whose 190 exchangeabilities (lognormal) and 20 frequencies
    come from the seed, and a FASTA of N_PROT x S_PROT residues that the
    port's simulate_on_tree evolves under that EmpiricalProtein along a
    seeded random rooted tree (branch lengths Exponential, mean 0.1)."""
    from phylo_tpu_torch.dataio import PROTEIN_ALPHABET, simulate_on_tree
    from phylo_tpu_torch.models.empirical import EmpiricalProtein

    os.makedirs(PROT_DIR, exist_ok=True)
    rng = np.random.default_rng(0)
    rows = [" ".join(f"{x:.6f}" for x in rng.lognormal(0.0, 1.0, i))
            for i in range(1, 20)]
    f = rng.random(20) + 0.5
    with open(PROT_DAT, "w") as fh:
        fh.write("\n".join(rows + ["", " ".join(f"{x:.8f}" for x in
                                                f / f.sum()), ""]))
    active, merges = list(range(N_PROT)), []
    for q in range(N_PROT - 1):
        i, j = rng.choice(len(active), 2, replace=False)
        merges.append((active[i], active[j]))
        active = [x for x in active if x not in merges[-1]] + [N_PROT + q]
    record = {"merges": np.asarray(merges),
              "branches": rng.exponential(0.1, (N_PROT - 1, 2))}
    ds = simulate_on_tree(record, EmpiricalProtein.from_paml(PROT_DAT),
                          {"model": {}}, S_PROT, seed=0)
    with open(PROT_FASTA, "w") as fh:
        for n, g in enumerate(ds.genome):
            fh.write(f">t{n}\n"
                     + "".join(PROTEIN_ALPHABET[a] for a in g.argmax(-1))
                     + "\n")


# ---------------------------------------------------------------- phase 2
def load(dataset, codons=False):
    """The dataset, converted to the 61 sense codons when `codons`."""
    from phylo_tpu_torch.dataio import codon_dataset, load_dataset

    ds = load_dataset(dataset)
    return codon_dataset(ds) if codons else ds


def last_rank_idx(gen, dev, S, dataset="primate", spec=None, Kd=K,
                  codons=False):
    """The child index (4, Kd) that K1 (K10 for a rate mixture, K9 for
    codons) gets at the last rank of a real sweep (Kd particles, initial
    parameters, the first S sites of `dataset` under model `spec`): rows
    follow the sweep's resampling genealogy, so the timed launch reads
    the slabs the main path reads."""
    from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies
    from phylo_tpu_torch.train.trainer import TrainConfig, init_params

    ds = load(dataset, codons)
    Nd = ds.N
    Rd = Nd - 1
    model, params = init_params(ds, TrainConfig(
        n_particles=Kd, device=dev, substitution_model=spec))
    genome = ds.genome[:, :S]
    if hasattr(model, "expand_leaves"):
        genome = model.expand_leaves(genome)
    leaves = torch.tensor(genome, dtype=torch.float32, device=dev)
    with torch.no_grad():
        res = sample_phylogenies(gen, leaves, model, params,
                                 SweepConfig(K=Kd))
    # replay the sweep's row_of_node bookkeeping (smc/sweep.py)
    row_of_node = torch.zeros((Kd, Rd), dtype=torch.int64, device=dev)
    for r in range(Rd):
        row_of_node = row_of_node[res.ancestors[r]]
        if r < Rd - 1:
            row_of_node[:, r] = torch.arange(Kd, device=dev)
    nodes = res.merged_nodes[Rd - 1].T                      # (2, K)
    rows = torch.gather(row_of_node, 1,
                        (nodes.T - Nd).clamp(0, Rd - 1)).T  # (2, K)
    return torch.stack([rows[0], nodes[0], rows[1], nodes[1]]).to(
        torch.int32).contiguous()


def rank_inputs(gen, S, dev, G=1, idx=None, A=A):
    """One rank's inputs at the main paths' shapes: primate (N=12) with
    dense (K, A, A) transitions for G=1, DS1 (N=27) with (K, G, A, A)
    blocks otherwise; G=5 makes block 0 the identity, the +I rate-0
    category, whose merged planes tie.  A: states a block (the main
    paths' 4 by default)."""
    f = dict(dtype=torch.float32, device=dev)
    Nd = N if G == 1 else N_DS1
    Rd = Nd - 1
    GA = G * A
    buf = torch.rand((K, Rd, GA, S), generator=gen, **f) * 0.95 + 0.05
    leaves = torch.rand((Nd, GA, S), generator=gen, **f) * 0.95 + 0.05
    outc = Rd - 1
    if idx is None:
        idx = (last_rank_idx(gen, dev, S) if G == 1 else
               last_rank_idx(gen, dev, S, "hohna_data_1", "gtr+g4"))
    pshape = (K, A, A) if G == 1 else (K, G, A, A)
    P_l = torch.rand(pshape, generator=gen, **f) * 0.95 + 0.05
    P_r = torch.rand(pshape, generator=gen, **f) * 0.95 + 0.05
    if G == 5:
        P_l[:, 0] = torch.eye(A, **f)
        P_r[:, 0] = torch.eye(A, **f)
    pi = torch.rand((GA,), generator=gen, **f) + 0.1
    pi = (pi / pi.sum()).contiguous()
    w = torch.ones((S,), **f)
    return buf, leaves, idx, outc, P_l, P_r, pi, w


def k1_slabs_read(idx, Nd=N):
    """Distinct child slabs that idx makes K1 read: each distinct leaf
    once (the leaves are shared by all particles) and each distinct
    (row, column) of the buffer once."""
    i = idx.long().cpu()
    nodes = torch.cat([i[1], i[3]])
    rows = torch.cat([i[0], i[2]])
    leaf = nodes < Nd
    n_leaf = int(torch.unique(nodes[leaf]).numel())
    n_int = int(torch.unique(rows[~leaf] * (2 * Nd) + nodes[~leaf]).numel())
    return n_leaf, n_int


def check_k1(kern, gen, dev, S, save, G=1, idx=None, A_=A, timed=True):
    """K1 (G=1, primate) or K10's forward (G > 1, DS1 blocks), A_ states
    a block.  Untimed: the checks alone, for the forms no main-path shape
    launches (the register form's padded blocks at G = 2, 3; 8 states)."""
    buf, leaves, idx, outc, P_l, P_r, pi, w = rank_inputs(gen, S, dev, G, idx,
                                                          A_)
    fn = kern.fused_rank_update
    b_k, b_p = buf.clone(), buf.clone()
    b_k[:, outc] = float("nan")         # a site the kernel misses shows
    got = fn(leaves, b_k, idx, outc, P_l, P_r, pi, w, save_children=save)
    want = kern._fused_rank_ref(leaves, b_p, idx, outc, P_l, P_r, pi, w,
                                save_children=save)
    torch.cuda.synchronize()
    errs = {"buf": max_abs(b_k, b_p), "rootll": max_rel(got[0], want[0]),
            "logscale": max_rel(got[1], want[1])}
    if save:
        errs["children"] = max(max_abs(got[2], want[2]),
                               max_abs(got[3], want[3]))
    tol = {"buf": 1e-5, "rootll": 1e-5, "logscale": 1e-5, "children": 0.0}
    label = ("K1 fused_rank_update" if G == 1 else
             f"K10 fused_rank_update_blocked G={G}") + (
        f" A={A_}" if A_ != A else "")
    log(f"  {label} S={S} save={save}: "
        + ", ".join(f"{k} err {v:.3e} (tol {tol[k]:g})"
                    for k, v in errs.items()))
    for k, v in errs.items():
        require(v <= tol[k], f"{label} {k} error {v} > {tol[k]}")

    def call():
        return fn(leaves, b_k, idx, outc, P_l, P_r, pi, w,
                  save_children=save)
    repeat_checks(f"{label} S={S} save={save} (plan (spl, warps, chunks, "
                  f"blocks, smem) {kern.rank_fwd_plan(K, G, A_, S)}, "
                  f"register blocks {kern.fwd_blocks(G, A_)})", call,
                  state=b_k, kernel=RANK_FWD_KERNEL)
    if not timed:
        return None
    ms = time_ms(call)
    plain = time_ms(lambda: kern._fused_rank_ref(
        leaves, b_p, idx, outc, P_l, P_r, pi, w, save_children=save),
        iters=3 if G > 1 else 20)
    GA = G * A
    slab = GA * S * 4
    n_leaf, n_int = k1_slabs_read(idx, leaves.shape[0])
    # child slabs read once each, column outc written (+ saved children)
    nbytes = (n_leaf + n_int) * slab + K * slab \
        + (2 * K * slab if save else 0) \
        + 2 * K * G * A * A * 4 + S * 4 + GA * 4 + 4 * K * 4 + 2 * K * 4
    nops = K * S * (4 * G * A * A + 4 * GA + 2)
    b_ms, b_by = bound(nbytes, nops)
    name = label.split()[0]
    key = name + (" G=5" if G == G_GAMMA + 1 else "") + (
        " save" if save else "")
    log(f"  {name} S={S}: last-rank idx of a real sweep reads "
        f"{n_leaf} leaf + {n_int} internal slabs for {2 * K} children; "
        f"kernel {ms:.4f} ms ({former(key, K, A, S)}), plain {plain:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB from and "
        f"to DRAM; {b_ms / ms:.0%} of it reached); L2 -> SM "
        f"{2 * K * slab / 1e6:.1f} MB a launch (each child value read "
        f"once); plan (spl, warps, chunks, blocks, smem) "
        f"{kern.rank_fwd_plan(K, G, A, S)}")
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None), \
        (leaves, buf, idx, P_l, P_r, pi, w)


def bwd_cotangents(gen, dev, K_, GA, S):
    f = dict(dtype=torch.float32, device=dev)
    return (torch.randn((K_, GA, S), generator=gen, **f),
            torch.randn((K_,), generator=gen, **f),
            torch.randn((K_,), generator=gen, **f))


def compare_bwd(label, got, want, tol=1e-4):
    got, want = list(got), list(want)
    got[4], got[5] = got[4].sum(0), got[5].sum(0)
    want[4], want[5] = want[4].sum(0), want[5].sum(0)
    torch.cuda.synchronize()
    names = ["dm1", "dm2", "dP_l", "dP_r", "dpi", "dw"]
    errs = {n: max_rel(a, b) for n, a, b in zip(names, got, want)}
    log(f"  {label}: " + ", ".join(
        f"{n} rel err {v:.3e}" for n, v in errs.items()) + f" (tol {tol:g})")
    for n, v in errs.items():
        require(v <= tol, f"{label} {n} relative error {v} > {tol}")
    return max(max_abs(a, b) for a, b in zip(got, want))


def former(kernel, Kd, A_, S):
    """The former design's time of a kernel at this shape, for the log
    line."""
    t = FORMER_MS.get((kernel, Kd, A_, S))
    return (f"former design: {t:.4f} ms" if t is not None else
            "former design: not timed here")


def repeat_checks(label, fn, sums=0, state=None, kernel=None):
    """Two calls of a kernel's wrapper give the same bits (no float
    atomics), and one call enqueues one device kernel (`device_kernels`),
    plus `sums` torch.sum kernels where the wrapper reduces partial rows
    itself (K11a: dpi and dw).  `state`: a tensor the call writes in place
    (K9f's buffer column), compared too.  `kernel`: a name the one device
    kernel must hold."""
    a = fn()
    before = None if state is None else state.clone()
    b = fn()
    torch.cuda.synchronize()
    same = all(bool(torch.equal(x, y)) for x, y in zip(a, b)) and (
        state is None or bool(torch.equal(before, state)))
    require(same, f"{label}: two calls differ")
    names, _ = device_kernels(fn)
    n = sum(c for _, c in names)
    shown = [(re.findall(r"[A-Za-z_]+_kernel", k) or [k[:60]])[-1]
             for k, _ in names]
    log(f"  {label}: two calls bit-identical: {same}; device kernels a "
        f"call: {n} ({', '.join(shown)})")
    require(n == 1 + sums, f"{label}: {n} device kernels a call, not "
            f"{1 + sums}")
    if kernel is not None:
        ours = sum(c for k, c in names if kernel in k)
        require(ours == 1, f"{label}: {ours} launches of {kernel}, not 1")


def bwd_bytes(K_, G, S, child_slabs):
    """Bytes a rank backward must move: the children (slabs of G*A*S
    floats), the cotangent in and the two child cotangents out, the
    transitions in and their cotangents out, dpi and dw out once."""
    GA = G * A
    slab = GA * S * 4
    return child_slabs * slab + 3 * K_ * slab + 4 * K_ * G * A * A * 4 \
        + 2 * K_ * 4 + S * 4 + GA * 4 + (GA + S) * 4


def check_k2(kern, gen, dev, inputs, G=1):
    """K2 (G=1) or K10's saved-children backward (G > 1)."""
    leaves, buf, idx, P_l, P_r, pi, w = inputs
    S = w.shape[0]
    GA = G * A
    m1, m2 = kern.gather_children(leaves, buf, idx)
    m1, m2 = m1.contiguous(), m2.contiguous()
    args = (m1, m2, *bwd_cotangents(gen, dev, K, GA, S), P_l, P_r, pi, w)
    label = "K2 fused_rank_bwd_saved" if G == 1 else \
        f"K10 fused_rank_bwd_saved_blocked G={G}"
    err = compare_bwd(label, kern.fused_rank_bwd_saved(*args),
                      kern._fused_rank_bwd_saved_ref(*args))
    repeat_checks(label, lambda: kern.fused_rank_bwd_saved(*args),
                  kernel=RANK_BWD_KERNEL)
    ms = time_ms(lambda: kern.fused_rank_bwd_saved(*args))
    ms_no_dw = time_ms(lambda: kern.fused_rank_bwd_saved(*args,
                                                         want_dw=False))
    plain = time_ms(lambda: kern._fused_rank_bwd_saved_ref(*args),
                    iters=3 if G > 1 else 20)
    nops = K * S * (8 * G * A * A + 20 * GA + 4)
    b_ms, b_by = bound(bwd_bytes(K, G, S, 2 * K), nops)
    name = "K2" if G == 1 else "K10 bwd-saved"
    log(f"  {name} G={G} S={S}: kernel {ms:.4f} ms ({former(name, K, A, S)}), "
        f"without dw {ms_no_dw:.4f} ms, plain {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); plan (spl, warps, chunks, blocks, smem) "
        f"{kern.rank_bwd_plan(K, G, A, S)}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_k3(kern, gen, dev, inputs, G=1, ties=False):
    """K3: the backward re-gathering both children by the rank's index,
    dense (G=1, primate) or blocked (G > 1, DS1).  ties: every P column
    the same and pi uniform (JAX's test_fused_rank_bwd_handles_max_ties
    case), so all G*A planes tie at the max."""
    leaves, buf, idx, P_l, P_r, pi, w = inputs
    S = w.shape[0]
    GA = G * A
    if ties:
        # identical blocks (as expanded leaves are) and one P column
        # shared by every block and state
        leaves = leaves[:, :A].repeat(1, G, 1)
        buf = buf[:, :, :A].repeat(1, 1, G, 1)
        col = torch.rand((K,) + (1,) * (P_l.ndim - 3) + (A, 1),
                         generator=gen, device=dev) * 0.95 + 0.05
        P_l = P_r = col.expand(P_l.shape).contiguous()
        pi = torch.full((GA,), 1.0 / GA, dtype=torch.float32, device=dev)
    args = (leaves, buf, idx, *bwd_cotangents(gen, dev, K, GA, S), P_l, P_r,
            pi, w)
    label = ("K3 fused_rank_bwd" if G == 1 else
             f"K3 fused_rank_bwd_blocked G={G}") + (" ties" if ties else "")
    err = compare_bwd(label, kern.fused_rank_bwd(*args),
                      kern._fused_rank_bwd_ref(*args))
    repeat_checks(label, lambda: kern.fused_rank_bwd(*args),
                  kernel=RANK_BWD_KERNEL)
    if ties:
        return None
    ms = time_ms(lambda: kern.fused_rank_bwd(*args))
    plain = time_ms(lambda: kern._fused_rank_bwd_ref(*args),
                    iters=3 if G > 1 else 20)
    n_leaf, n_int = k1_slabs_read(idx, leaves.shape[0])
    nops = K * S * (8 * G * A * A + 20 * GA + 4)
    b_ms, b_by = bound(bwd_bytes(K, G, S, n_leaf + n_int), nops)
    name = "K3" if G == 1 else "K3 blocked"
    log(f"  {name} G={G} S={S}: kernel {ms:.4f} ms ({former(name, K, A, S)}), "
        f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{b_ms / ms:.0%} of it reached)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def cap_trade(kern, gen, dev, inputs, label, fwd, bwd_saved, bwd):
    """The trade SAVE_CHILDREN_CAP decides, at a main path's step shape
    (site batch 256, the last rank's real index): the saved route costs
    the forward writing the children plus the saved-children backward
    reading them, the re-gather route the forward without the write plus
    the re-gathering backward.  Measured in turns, saved, re-gather,
    re-gather, saved."""
    leaves, buf, idx, P_l, P_r, pi, w = inputs
    Kd, S = idx.shape[1], w.shape[0]
    outc = buf.shape[1] - 1
    GA = leaves.shape[1]
    gm, gr, gl = bwd_cotangents(gen, dev, Kd, GA, S)
    m1, m2 = kern.gather_children(leaves, buf, idx)
    m1, m2 = m1.contiguous(), m2.contiguous()
    b = buf.clone()

    def saved():
        kern.fused_rank_update(leaves, b, idx, outc, P_l, P_r, pi, w,
                               save_children=True)
        kern.fused_rank_bwd_saved(m1, m2, gm, gr, gl, P_l, P_r, pi, w)

    def regather():
        kern.fused_rank_update(leaves, b, idx, outc, P_l, P_r, pi, w)
        kern.fused_rank_bwd(leaves, b, idx, gm, gr, gl, P_l, P_r, pi, w)

    t = {"saved": [], "regather": []}
    for name in ("saved", "regather", "regather", "saved"):
        t[name].append(time_ms(saved if name == "saved" else regather))
    out = {k: sum(v) / len(v) for k, v in t.items()}
    rule = ("saves the children" if kern.save_children_ok(
        buf.shape[1], Kd, GA, S, 4) else "sends it to re-gather")
    log(f"  SAVE_CHILDREN_CAP trade, {label} K={Kd} S={S} one rank: saved "
        f"route ({fwd} saving + {bwd_saved}) {out['saved']:.4f} ms, "
        f"re-gather route ({fwd} + {bwd}) {out['regather']:.4f} ms "
        f"(runs: {json.dumps(t)}); at this step shape the cap {rule}")
    return out


def wide_inputs(gen, dev, S, idx, Kd=K_CODON, Nd=N_CODON, A_=A_CODON,
                ties=False, G=1):
    """One rank's inputs on a wide path: Kd particles, Nd leaves, G blocks
    of A_ states, dense (Kd, A_, A_) transitions (G=1: the codon path) or
    blocked (Kd, G, A_, A_) ones (protein+G4), the child index `idx`.
    G=5 makes block 0 the identity (the +I rate-0 category).  ties: the
    blocks of every message identical (as expanded leaves are), one P
    column shared by every block and state and pi uniform (JAX's
    test_fused_rank_bwd_wide_handles_max_ties case), so all G*A_ planes
    tie at every site's max."""
    f = dict(dtype=torch.float32, device=dev)
    GA = G * A_
    pshape = (Kd, A_, A_) if G == 1 else (Kd, G, A_, A_)
    buf = torch.rand((Kd, Nd - 1, GA, S), generator=gen, **f) * 0.95 + 0.05
    leaves = torch.rand((Nd, GA, S), generator=gen, **f) * 0.95 + 0.05
    P_l = torch.rand(pshape, generator=gen, **f) * 0.95 + 0.05
    P_r = torch.rand(pshape, generator=gen, **f) * 0.95 + 0.05
    pi = torch.rand((GA,), generator=gen, **f) + 0.1
    if G == 5:
        P_l[:, 0] = torch.eye(A_, **f)
        P_r[:, 0] = torch.eye(A_, **f)
    if ties:
        leaves = leaves[:, :A_].repeat(1, G, 1)
        buf = buf[:, :, :A_].repeat(1, 1, G, 1)
        col = torch.rand((Kd,) + (1,) * (len(pshape) - 3) + (A_, 1),
                         generator=gen, **f) * 0.95 + 0.05
        P_l = P_r = col.expand(pshape).contiguous()
        pi = torch.ones((GA,), **f)
    pi = (pi / pi.sum()).contiguous()
    w = torch.ones((S,), **f)
    return leaves, buf, idx, P_l, P_r, pi, w


def k9_bounds(idx, A_, S, Nd, kind, G=1):
    """(bound ms, by) of one K9 launch on these inputs (G blocks of A_
    states).  kind: "fwd", "fwd_save" (K9f), "bwd_saved" (K9bs), "bwd"
    (K9b).  Bytes: the child slabs read once each (the distinct ones idx
    names, or the 2 Kd saved copies for K9bs), the cotangent in and
    outputs out, transitions and their cotangents, dpi and dw once (the
    forward: rootll and logscale).
    FP32 operations per particle and site: 4 G A^2 + 4 G A + 2 forward (u
    and v: 2 G A^2 FMAs), 12 G A^2 + 20 G A + 4 backward (u, v, dm1, dm2,
    dP_l, dP_r)."""
    Kd = idx.shape[1]
    GA = G * A_
    slab = GA * S * 4
    n_leaf, n_int = k1_slabs_read(idx, Nd)
    child = (2 * Kd if kind == "bwd_saved" else n_leaf + n_int) * slab
    small = 2 * Kd * G * A_ * A_ * 4 + S * 4 + GA * 4
    if kind.startswith("fwd"):
        nbytes = child + Kd * slab + small + 2 * Kd * 4 \
            + (2 * Kd * slab if kind == "fwd_save" else 0)
        return bound(nbytes, Kd * S * (4 * G * A_ * A_ + 4 * GA + 2))
    nbytes = child + 3 * Kd * slab + 2 * small + 2 * Kd * 4 + (GA + S) * 4
    return bound(nbytes, Kd * S * (12 * G * A_ * A_ + 20 * GA + 4))


def check_k9(kern, gen, dev, idx, S, Nd=N_CODON, A_=A_CODON, timed=True,
             G=1, line_save=True):
    """K9f (saving the children and not), K9bs and K9b against their plain
    versions at a wide path's shapes (Kd = idx.shape[1] particles, Nd
    leaves, G blocks of A_ states: dense for G=1, K9 blocked above;
    untimed for a side check at other shapes), the all-planes-tied case
    included; timed beside the plain versions and, as a
    yardstick for a later design, the two contractions u = P_l^T m1,
    v = P_r^T m2 alone as torch.bmm.  Returns the kernels line's entries
    {name: dict} when timed (K9f's from the variant with save_children
    == line_save, the one the main path runs)."""
    Kd = idx.shape[1]
    GA = G * A_
    sfx = "_blocked" if G > 1 else ""
    out = {}
    leaves, buf, idx, P_l, P_r, pi, w = wide_inputs(gen, dev, S, idx, Kd,
                                                    Nd, A_, G=G)
    outc = buf.shape[1] - 1
    tag = f"K={Kd} G={G} A={A_} S={S}" if G > 1 else f"K={Kd} A={A_} S={S}"
    fname = "K9f" + (" blocked" if G > 1 else "")
    # FORMER_MS's blocked entries are protein+G4's; over 128 planes the
    # card had no kernel before the block-group forms
    fA = A_ if G * A_ <= 128 else G * A_
    for save in (True, False):
        b_k, b_p = buf.clone(), buf.clone()
        got = kern.fused_rank_update(leaves, b_k, idx, outc, P_l, P_r, pi, w,
                                     save_children=save)
        want = kern._fused_rank_ref(leaves, b_p, idx, outc, P_l, P_r, pi, w,
                                    save_children=save)
        torch.cuda.synchronize()
        # w / scale lies in [0, 1]: its absolute error is a relative one
        errs = {"buf": max_abs(b_k, b_p), "rootll": max_rel(got[0], want[0]),
                "logscale": max_rel(got[1], want[1])}
        if save:
            errs["children"] = max(max_abs(got[2], want[2]),
                                   max_abs(got[3], want[3]))
        tol = {"buf": 1e-5, "rootll": 1e-5, "logscale": 1e-5, "children": 0.0}
        log(f"  {fname} fused_rank_update_wide{sfx} {tag} save={save}: "
            + ", ".join(f"{k} err {v:.3e} (tol {tol[k]:g})"
                        for k, v in errs.items()))
        for k, v in errs.items():
            require(v <= tol[k], f"{fname} {k} error {v} > {tol[k]}")

        def call(save=save, b_k=b_k):
            return kern.fused_rank_update(leaves, b_k, idx, outc, P_l, P_r,
                                          pi, w, save_children=save)
        repeat_checks(f"{fname} {tag} save={save}", call,
                      state=b_k[:, outc])
        if not timed:
            continue
        ms = time_ms(call)
        plain = time_ms(lambda: kern._fused_rank_ref(
            leaves, b_p, idx, outc, P_l, P_r, pi, w, save_children=save),
            iters=3)
        b_ms, b_by = k9_bounds(idx, A_, S, Nd,
                               "fwd_save" if save else "fwd", G)
        log(f"  {fname} {tag} save={save}: kernel {ms:.4f} ms "
            f"({former(fname + (' save' if save else ''), Kd, fA, S)}), "
            f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{b_ms / ms:.0%} of it reached); library: null (no single "
            "PyTorch call gathers, merges, rescales and reduces)")
        if save == line_save:
            out["fused_rank_update_wide" + sfx] = dict(
                max_abs_err=max(errs.values()), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
    m1, m2 = kern.gather_children(leaves, buf, idx)
    m1, m2 = m1.contiguous(), m2.contiguous()
    if G > 1:
        # all planes tied: every site's column is 1 on every plane
        t_in = wide_inputs(gen, dev, S, idx, Kd, Nd, A_, ties=True, G=G)
        b_k, b_p = t_in[1].clone(), t_in[1].clone()
        got = kern.fused_rank_update(t_in[0], b_k, idx, outc, *t_in[3:])
        want = kern._fused_rank_ref(t_in[0], b_p, idx, outc, *t_in[3:])
        torch.cuda.synchronize()
        err = max(max_abs(b_k, b_p), max_rel(got[0], want[0]))
        log(f"  {fname} {tag} all planes tied: buf / rootll err {err:.3e} "
            "(tol 1e-5)")
        require(err <= 1e-5, f"{fname} tied error {err}")
        del t_in, b_k, b_p
    if timed:
        Plt = P_l.reshape(Kd * G, A_, A_).transpose(1, 2).contiguous()
        Prt = P_r.reshape(Kd * G, A_, A_).transpose(1, 2).contiguous()
        mb1 = m1.reshape(Kd * G, A_, S)
        mb2 = m2.reshape(Kd * G, A_, S)
        mm = time_ms(lambda: (torch.bmm(Plt, mb1), torch.bmm(Prt, mb2)))
        log(f"  K9 yardstick {tag}: the two contractions alone as torch.bmm "
            f"(full float32) {mm:.4f} ms")
    for tied in (False, True):
        if tied:
            leaves, buf, idx, P_l, P_r, pi, w = wide_inputs(
                gen, dev, S, idx, Kd, Nd, A_, ties=True, G=G)
            m1, m2 = kern.gather_children(leaves, buf, idx)
            m1, m2 = m1.contiguous(), m2.contiguous()
        cts = (*bwd_cotangents(gen, dev, Kd, GA, S), P_l, P_r, pi, w)
        for name, kind, fn, ref, args in (
                ("fused_rank_bwd_saved_wide" + sfx, "bwd_saved",
                 kern.fused_rank_bwd_saved, kern._fused_rank_bwd_saved_ref,
                 (m1, m2, *cts)),
                ("fused_rank_bwd_wide" + sfx, "bwd", kern.fused_rank_bwd,
                 kern._fused_rank_bwd_ref, (leaves, buf, idx, *cts))):
            label = ("K9bs" if kind == "bwd_saved" else "K9b") + (
                " blocked" if G > 1 else "")
            err = compare_bwd(f"{label} {name} {tag}"
                              + (" ties" if tied else ""),
                              fn(*args), ref(*args))
            repeat_checks(f"{label} {tag}" + (" ties" if tied else ""),
                          lambda: fn(*args))
            if not timed or tied:
                continue
            ms = time_ms(lambda: fn(*args))
            plain = time_ms(lambda: ref(*args), iters=3)
            b_ms, b_by = k9_bounds(idx, A_, S, Nd, kind, G)
            log(f"  {label} {tag}: kernel {ms:.4f} ms "
                f"({former(label, Kd, fA, S)}), plain {plain:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}, {b_ms / ms:.0%} of it reached); "
                "library: null (no single PyTorch call computes this "
                "backward)")
            out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return out


@contextlib.contextmanager
def forced_group(kern, plan, gb, cluster):
    """Within the block, the wide wrappers launch in block groups of gb
    blocks at a cluster cap of `cluster`: kern.<plan> (`wide_fwd_group`
    or `wide_bwd_group`) and kern.MAX_CLUSTER patched, then restored."""
    saved = getattr(kern, plan), kern.MAX_CLUSTER
    setattr(kern, plan, lambda *shape: gb)
    kern.MAX_CLUSTER = cluster
    try:
        yield
    finally:
        setattr(kern, plan, saved[0])
        kern.MAX_CLUSTER = saved[1]


def check_forced_groups(kern, gen, dev, idx, S, Nd=N_PROT, G=G_GAMMA,
                        A_=A_PROT, ties=False, emit=None):
    """The block-group forms forced where one group fits (gb = 1 and 2 of
    protein+G4's 4 x 20, at the one-group body's cluster) against the
    one-group body: K9f's column and saved children, and K9bs's and K9b's
    dm1, dm2, dP_l, dP_r, dpi and dw partial rows, to the bit (the group
    backward rebuilds the one-group body's per-site sum order), rootll
    and logscale within 1e-6 relative (their pi-sums add the groups in
    turn).  `emit`: where the rows go (default: the log)."""
    Kd = idx.shape[1]
    leaves, buf, idx, P_l, P_r, pi, w = wide_inputs(gen, dev, S, idx, Kd,
                                                    Nd, A_, ties=ties, G=G)
    m1, m2 = kern.gather_children(leaves, buf, idx)
    m1, m2 = m1.contiguous(), m2.contiguous()
    cts = (*bwd_cotangents(gen, dev, Kd, G * A_, S), P_l, P_r, pi, w)
    fc = kern.wide_fwd_plan(Kd, G, A_, S)[1]
    bc = kern.wide_bwd_plan(Kd, G, A_, S)[1]
    outc = buf.shape[1] - 1

    def fwd():
        b = buf.clone()
        out = kern.fused_rank_update(leaves, b, idx, outc, P_l, P_r, pi, w,
                                     save_children=True)
        return b[:, outc], out

    for gb in (1, 2):
        col1, out1 = fwd()
        with forced_group(kern, "wide_fwd_group", gb, fc):
            colg, outg = fwd()
        sums = max(max_rel(outg[0], out1[0]), max_rel(outg[1], out1[1]))
        row = {"check": "forced group", "K": Kd, "G": G, "A": A_, "S": S,
               "gb": gb, "ties": ties,
               "column_and_children_bits": bool(
                   torch.equal(col1, colg) and torch.equal(out1[2], outg[2])
                   and torch.equal(out1[3], outg[3])),
               "site_sums_rel_err": sums}
        for label, fn, head in (("K9bs", kern.fused_rank_bwd_saved, (m1, m2)),
                                ("K9b", kern.fused_rank_bwd,
                                 (leaves, buf, idx))):
            one = fn(*head, *cts)
            with forced_group(kern, "wide_bwd_group", gb, bc):
                grp = fn(*head, *cts)
            row[label] = {n: bool(torch.equal(a, b)) for n, a, b in zip(
                ("dm1", "dm2", "dP_l", "dP_r", "dpi", "dw"), one, grp)}
        torch.cuda.synchronize()
        (emit or (lambda r: log(f"  K9 blocked group form forced: "
                                f"{json.dumps(r)}")))(row)
        require(row["column_and_children_bits"] and sums <= 1e-6
                and all(all(row[k].values()) for k in ("K9bs", "K9b")),
                f"the forced group form differs from one group: {row}")


def small_idx(gen, dev, Kd, Nd, R_):
    """A random child index (4, Kd) over Nd leaves and R_ - 1 filled
    buffer columns (the last one is written)."""
    rows = torch.randint(0, Kd, (2, Kd), generator=gen, device=dev)
    nodes = torch.randint(0, Nd + R_ - 1, (2, Kd), generator=gen, device=dev)
    return torch.stack([rows[0], nodes[0], rows[1], nodes[1]]).to(
        torch.int32).contiguous()


def expm_inputs(gen, dev, spec=None, pairs=None):
    """K4's generator and branch lengths on a main path.  Primate VCSMC
    (spec None): the reference model's Q, moved off its initial value,
    and R*2*K = 45,056 branch lengths b ~ Exponential(rate 10).  DS1 under
    a rate mixture `spec`: the merge orientation Q^T of its base model
    (exchangeabilities and frequencies moved off their initial values)
    and the per-step batch the sweep gives K4, the (R, 2K) branch lengths
    eps / rate at the initial branch rates times the G category rates:
    26*4096*4 = 425,984 matrices for gtr+g4, 5 categories for gtr+g4+i
    (its rate-0 category makes b = 0).  With `pairs`, the twist's batch
    for that many candidate pairs (smc/twist.py::chunk_loglik: (2C, M, K)
    branch lengths times the G rates): 2 * 351 * 10 * 32 * 4 = 898,560
    at DS1's rank 0, 7,680 at its last rank (3 pairs)."""
    from phylo_tpu_torch.dataio import load_dataset
    from phylo_tpu_torch.models.branches import branch_rates
    from phylo_tpu_torch.models.substitution import ReferenceQ
    from phylo_tpu_torch.train.trainer import TrainConfig, init_params

    f = dict(dtype=torch.float32, device=dev)
    if spec is None:
        model = ReferenceQ(A)
        p = model.init_params(torch.float32, dev)
        p["y_q"] = p["y_q"] + 0.3 * torch.randn((A, A), generator=gen, **f)
        b = torch.empty((R * 2 * K,), **f).exponential_(generator=gen) / 10.0
        return model.Q(p).contiguous(), b
    ds = load_dataset("hohna_data_1")
    model, params = init_params(ds, TrainConfig(
        n_particles=K, device=dev, substitution_model=spec))
    with torch.no_grad():
        base = {k: v + 0.3 * torch.randn(v.shape, generator=gen, **f)
                for k, v in params["model"]["base"].items()}
        Qt = model.base.Q(base).T.contiguous()
        rates_l, rates_r = branch_rates(params["branches"])
        if pairs is None:
            eps = torch.empty((2, ds.N - 1, K), **f).exponential_(
                generator=gen)
            b = torch.cat([eps[0] / rates_l[:, None],
                           eps[1] / rates_r[:, None]], dim=1)
        else:
            b = torch.empty((2 * pairs * M_TWIST * K_TWIST,), **f
                            ).exponential_(generator=gen) / rates_l.mean()
        b = (b[..., None] * model.rates(params["model"]).to(torch.float32))
    return Qt, b.reshape(-1).contiguous()


def device_kernels(fn):
    """([(name, launches)] of the device work one call of fn enqueues, the
    number of calls of fn made): the nodes of a CUDA graph captured from
    one call (after a warm-up call on the capturing stream), read through
    the driver API, kernel nodes by their function's name.
    torch.profiler's traces lost kernel records late in this script's
    runs (a call counted as 0, 1/3 or 2/3 of a launch, again on retries);
    a captured graph does not."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    vp, ref = ctypes.c_void_p, ctypes.byref
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):       # per-stream state (K4's ticket)
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=stream, capture_error_mode="relaxed"):
        fn()
    graph = vp(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    require(cu.cuGraphGetNodes(graph, None, ref(n)) == 0, "cuGraphGetNodes")
    nodes = (vp * n.value)()
    require(cu.cuGraphGetNodes(graph, nodes, ref(n)) == 0, "cuGraphGetNodes")
    found = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(vp(node), ref(kind))
        key = f"graph node of type {kind.value}"
        if kind.value == 0:               # CU_GRAPH_NODE_TYPE_KERNEL
            params = (vp * 32)()          # CUDA_KERNEL_NODE_PARAMS: func first
            name = ctypes.c_char_p()
            key = "kernel"
            if (cu.cuGraphKernelNodeGetParams(vp(node), params) == 0
                    and cu.cuFuncGetName(ref(name), vp(params[0])) == 0):
                key = name.value.decode()
        found[key] = found.get(key, 0) + 1
    del g
    return sorted(found.items()), 2


def k4_bounds(B, order=12, squarings=12):
    """(fwd, bwd) bounds of K4 on B matrices: ((ms, by), (ms, by)).
    Forward: b read, P written, Q read; order - 1 + squarings products of
    2 A^3 operations plus A^2 for the scale or the 2 D.  Backward: b, P
    and P_bar read, b_bar written, Q read and Q_bar written; three products
    a step, (Q P) and its dot with P_bar for b_bar, and w DF summed over
    the batch."""
    steps = order - 1 + squarings
    mm, aa = 2 * A ** 3, A * A
    fwd = bound(B * 4 + B * aa * 4 + aa * 4, B * (steps * (mm + aa) + 10))
    bwd = bound(B * 4 + 2 * B * aa * 4 + B * 4 + 2 * aa * 4,
                B * (steps * (3 * mm + 3 * aa) + mm + 2 * aa + 2 * aa))
    return fwd, bwd


def check_k4(ek, gen, dev, label, Q, b, timed=True, order=12, squarings=12):
    """K4 forward and backward against their plain versions on (Q, b) and
    again with every fourth branch past 80 / mu (the clamp region: b_bar
    must be exactly 0 there): P to 1e-6 max abs, Q_bar (the batch sum,
    reduced in the kernel) and b_bar to 1e-4 relative.  Each backward is
    called twice and must give the same bits (no float atomics).  When
    `timed`, both are timed beside the plain versions and
    torch.linalg.matrix_exp (forward and its backward), and the kernels
    line's (fwd, bwd) entries returned."""
    f = dict(dtype=torch.float32, device=dev)
    B = b.shape[0]
    gbar = torch.randn((B, A, A), generator=gen, **f)
    mixed = b.clone()
    mixed[::4] = 500.0
    errs = {}
    for region, bb in (("mu*b < 80", b), ("every 4th mu*b > 80", mixed)):
        P_k = ek.expm_fwd(Q, bb, order, squarings)
        P_p = ek._expm_fwd_plain(Q, bb, order, squarings)
        q_k, b_k = ek.expm_bwd(Q, bb, P_k, gbar, order, squarings)
        q_k2, b_k2 = ek.expm_bwd(Q, bb, P_k, gbar, order, squarings)
        q_p, b_p = ek._expm_bwd_plain(Q, bb, P_k, gbar, order, squarings)
        torch.cuda.synchronize()
        same = bool(torch.equal(q_k, q_k2) and torch.equal(b_k, b_k2))
        e = dict(fwd=max_abs(P_k, P_p), qbar=max_rel(q_k, q_p),
                 bbar=max_rel(b_k, b_p),
                 bwd_abs=max(max_abs(q_k, q_p), max_abs(b_k, b_p)))
        log(f"  K4 {label} B={B} ({order}, {squarings}) {region}: fwd max "
            f"abs err {e['fwd']:.3e} (tol 1e-6), Q_bar rel err "
            f"{e['qbar']:.3e}, b_bar rel err {e['bbar']:.3e} (tol 1e-4); "
            f"two backward calls bit-identical: {same}")
        require(e["fwd"] <= 1e-6, f"K4 {label} fwd error {e['fwd']}")
        require(e["qbar"] <= 1e-4 and e["bbar"] <= 1e-4,
                f"K4 {label} bwd error {e['qbar']} {e['bbar']}")
        require(same, f"K4 {label}: two backward calls differ")
        if bb is mixed:
            require(float(b_k[::4].abs().max()) == 0.0,
                    f"K4 {label}: b_bar non-zero past the clamp")
        errs[region] = e
        del P_k, P_p, q_k, b_k, q_k2, b_k2, q_p, b_p
    if not timed:
        return None
    P = ek.expm_fwd(Q, b)
    ms_f = time_ms(lambda: ek.expm_fwd(Q, b))
    plain_f = time_ms(lambda: ek._expm_fwd_plain(Q, b), iters=5)
    Qb = (Q[None] * b[:, None, None]).contiguous()
    lib_f = time_ms(lambda: torch.linalg.matrix_exp(Qb), iters=5)
    ms_b = time_ms(lambda: ek.expm_bwd(Q, b, P, gbar))
    plain_b = time_ms(lambda: ek._expm_bwd_plain(Q, b, P, gbar), iters=5)
    (bf, byf), (bb_, byb) = k4_bounds(B)
    # library: the backward of torch.linalg.matrix_exp on the same batch
    # (the Frechet adjoint per matrix; Q_bar and b_bar follow by sums)
    Qb_req = Qb.clone().requires_grad_(True)
    E = torch.linalg.matrix_exp(Qb_req)
    lib_b = time_ms(lambda: torch.autograd.grad(E, Qb_req, gbar,
                                                retain_graph=True), iters=5)
    log(f"  K4 fwd {label} B={B}: kernel {ms_f:.4f} ms, plain {plain_f:.4f} "
        f"ms, torch.linalg.matrix_exp {lib_f:.4f} ms, bound {bf:.4f} ms "
        f"({byf})")
    log(f"  K4 bwd {label} B={B}: kernel {ms_b:.4f} ms, plain {plain_b:.4f} "
        f"ms, torch.linalg.matrix_exp backward {lib_b:.4f} ms, bound "
        f"{bb_:.4f} ms ({byb})")
    fwd = dict(max_abs_err=max(e["fwd"] for e in errs.values()), ms=ms_f,
               plain_ms=plain_f, bound_ms=bf, bound_by=byf, library_ms=lib_f)
    bwd = dict(max_abs_err=max(e["bwd_abs"] for e in errs.values()),
               ms=ms_b,
               plain_ms=plain_b, bound_ms=bb_, bound_by=byb,
               library_ms=lib_b)
    return fwd, bwd


def eigh_cases():
    """The symmetrized generators the eigh kernel takes on the main paths
    and at its widest: .dat's 20 states (the seeded .dat's F
    frequencies), GY94's 61 (betacorona1's F61, initial kappa and omega),
    a random reversible 64-state generator, and JC69 on 9 states, whose
    spectrum collapses (eight equal eigenvalues)."""
    from phylo_tpu_torch.models.empirical import EmpiricalProtein
    from phylo_tpu_torch.models.substitution import get_model
    from phylo_tpu_torch.train.trainer import _resolve_codon_frequencies

    f64 = dict(dtype=torch.float64, device="cpu")

    def sym(Q, pi):
        d = torch.sqrt(pi)
        S = Q * (d[:, None] / d[None, :])
        return (S + S.T) / 2

    dat = EmpiricalProtein.from_paml(PROT_DAT, plus_f=True)
    p = dat.init_params(**f64)
    ds = load("betacorona1", codons=True)
    gy = _resolve_codon_frequencies(get_model("gy94", A=ds.A), ds)
    q = gy.init_params(**f64)
    rng = np.random.default_rng(64)
    pi = rng.dirichlet(np.ones(64))
    E = rng.gamma(1.0, size=(64, 64))
    Q64 = (E + E.T) / 2 * pi[None]
    np.fill_diagonal(Q64, 0.0)
    Q64 -= np.diag(Q64.sum(1))
    return {"dat 20": sym(dat.Q(p, **f64), dat.stationary(p, **f64)),
            "GY94 61": sym(gy.Q(q), gy.stationary(q, **f64)),
            "random 64": sym(torch.tensor(Q64), torch.tensor(pi)),
            "JC69 9": torch.full((9, 9), 1.0 / 9, **f64)
            - torch.eye(9, **f64)}


def eigh_bound(A):
    """(ms, by): the least time the card could take for one A x A
    symmetric eigendecomposition with its eigenvectors, whatever the
    method: the larger of S read and (w, U) written once at the HBM rate
    and 9 A^3 FP64 operations (the symmetric QR algorithm's count with
    the eigenvectors: Golub & Van Loan, Matrix Computations, 4th ed.,
    section 8.3.5) at the card's FP64 tensor-core peak, 67 TFLOP/s
    (NVIDIA's H100 SXM data sheet)."""
    t_ops = 9 * A ** 3 / FP64_TC_OPS_PER_S * 1e3
    t_bytes = (2 * A * A + A) * 8 / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_eigh_non_finite(dev):
    """A NaN or an infinity in S (what a non-finite parameter would
    bring): the kernel launches without error and returns NaN in every
    output, with a well-formed matrix beside it in the same batch
    decomposed as alone; the card stays usable."""
    from phylo_tpu_torch.models import eigh_kernel

    S = eigh_cases()["GY94 61"].to(dev)
    alone = eigh_kernel.eigh_fwd(S)
    for bad in (float("nan"), float("inf")):
        X = S.clone()
        X[3, 17] = X[17, 3] = bad
        w, U, sweeps = eigh_kernel.eigh_fwd(torch.stack([X, S]))
        torch.cuda.synchronize()
        require(bool(torch.isnan(w[0]).all()) and bool(
            torch.isnan(U[0]).all()) and int(sweeps[0]) == 0,
            f"eigh with {bad} in S: outputs not all NaN")
        require(torch.equal(w[1], alone[0]) and torch.equal(U[1], alone[1]),
                f"eigh with {bad} beside it: the finite matrix's result "
                "changed")
    log("  eigh with NaN or inf in S: every output NaN, no launch error; "
        "the finite matrix of the same batch the bits it has alone")


def check_eigh_cap(S, n_sweeps, label):
    """The sweep cap (models.eigh_kernel.eigh_fwd's max_sweeps, 40 by
    default): at the sweeps S takes, the uncapped bits; one fewer, NaN in
    every w and U entry of the batch (two copies of S) and the cap as its
    sweeps, with no launch error.  No host read is added to the call."""
    from phylo_tpu_torch.models import eigh_kernel

    w, U, _ = eigh_kernel.eigh_fwd(S)
    pair = torch.stack([S, S])
    w1, U1, s1 = eigh_kernel.eigh_fwd(pair, max_sweeps=n_sweeps)
    wc, Uc, sc = eigh_kernel.eigh_fwd(pair, max_sweeps=n_sweeps - 1)
    torch.cuda.synchronize()
    require(torch.equal(w1[0], w) and torch.equal(U1[1], U)
            and bool((s1 == n_sweeps).all()),
            f"eigh {label} capped at its {n_sweeps} sweeps differs from "
            "the uncapped call")
    require(bool(torch.isnan(wc).all()) and bool(torch.isnan(Uc).all())
            and bool((sc == n_sweeps - 1).all()),
            f"eigh {label} capped at {n_sweeps - 1} sweeps: not all NaN")
    log(f"  eigh {label} sweep cap: at {n_sweeps} sweeps the uncapped bits; "
        f"at {n_sweeps - 1} every w and U entry NaN ({n_sweeps - 1} "
        f"sweeps reported), no launch error (default cap "
        f"{eigh_kernel.MAX_SWEEPS})")


def check_eigh(dev):
    """The Jacobi eigh kernel (models.eigh_kernel, float64) against
    torch.linalg.eigh on the card at `eigh_cases`: eigenvalues within
    1e-12 of the largest, U diag(w) U^T within 1e-12 of S, U orthogonal
    within 1e-12, the backward of a gauge-invariant loss within 1e-9
    relative L2 of torch.linalg.eigh's autograd, two calls the same bits
    and one device kernel a call (a captured graph); timed (CUDA events)
    beside torch.linalg.eigh, the plain version and the library call at
    once, and `eigh_bound`; then `check_eigh_non_finite`.  The kernels
    line carries GY94's 61 states.  At .dat's 20 and GY94's 61 states,
    `check_eigh_cap`."""
    from phylo_tpu_torch.models import eigh_kernel

    row = None
    for label, S_cpu in eigh_cases().items():
        S = S_cpu.to(dev)
        A = S.shape[0]
        w, U, sweeps = eigh_kernel.eigh_fwd(S)
        wr, _ = torch.linalg.eigh(S)
        eye = torch.eye(A, dtype=S.dtype, device=dev)
        w_err = float((w - wr).abs().max() / wr.abs().max())
        recon = float(((U * w) @ U.T - S).abs().max())
        orth = float((U.T @ U - eye).abs().max())
        rng = np.random.default_rng(A)
        G = torch.tensor(rng.normal(size=(A, A)), device=dev)
        X0 = torch.tensor(rng.normal(0.0, 1e-3, (A, A)), device=dev)

        def loss(fn, X):
            ww, UU = fn(S + (X + X.T) / 2)
            return torch.sum(G * ((UU * torch.exp(0.3 * ww)) @ UU.T)) \
                + torch.sum(ww * torch.arange(A, device=dev))

        Xk = X0.clone().requires_grad_(True)
        Xr = X0.clone().requires_grad_(True)
        gk, = torch.autograd.grad(loss(eigh_kernel.eigh, Xk), Xk)
        gr, = torch.autograd.grad(loss(torch.linalg.eigh, Xr), Xr)
        bwd = float(torch.norm(gk - gr) / torch.norm(gr))
        require(w_err <= 1e-12 and recon <= 1e-12 and orth <= 1e-12
                and bwd <= 1e-9,
                f"eigh {label}: eigenvalues {w_err:.3e}, reconstruction "
                f"{recon:.3e}, orthogonality {orth:.3e}, backward {bwd:.3e}")
        repeat_checks(f"eigh {label}", lambda: eigh_kernel.eigh_fwd(S)[:2],
                      kernel="jacobi_eigh_kernel")
        n_sweeps = int(sweeps)
        if label in ("dat 20", "GY94 61"):
            check_eigh_cap(S, n_sweeps, label)
        ms = time_ms(lambda: eigh_kernel.eigh_fwd(S))
        lib = time_ms(lambda: torch.linalg.eigh(S))
        b_ms, b_by = eigh_bound(A)
        log(f"  eigh {label}: {n_sweeps} sweeps; eigenvalues {w_err:.3e} "
            f"of the largest, reconstruction {recon:.3e}, orthogonality "
            f"{orth:.3e}, backward {bwd:.3e} rel L2 (tol 1e-12, 1e-12, "
            f"1e-12, 1e-9); kernel {ms:.4f} ms, torch.linalg.eigh (the "
            f"plain version and the library call) {lib:.4f} ms, bound "
            f"{b_ms:.6f} ms (by {b_by}: the larger of S, w and U at "
            f"3.35 TB/s and 9 A^3 FP64 operations at 67 TFLOP/s)")
        if label == "GY94 61":
            row = dict(max_abs_err=recon, ms=ms, plain_ms=lib,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    check_eigh_non_finite(dev)
    return row


def check_k4_all(ek, gen, dev):
    """K4 at every shape phase 2 holds it to: timed at primate VCSMC's
    45,056 matrices, DS1 GTR+G4's 425,984 (the kernels line) and the
    twist's DS1 rank-0 898,560 and last-rank 7,680; untimed at B = 1, 7,
    255, 257 and 4,099 (ragged edges; at B = 1 Q_bar is that element's
    own field), at a non-default (order, squarings) = (8, 6) (the generic
    instance) and on DS1 GTR+G4+I (b = 0 in its rate-0 category).  Then
    one forward and one backward call captured as a CUDA graph: exactly one
    device kernel each, and its launch counter up by one.  Returns the
    kernels line's (fwd, bwd)."""
    from phylo_tpu_torch import _ext

    Qd, bd = expm_inputs(gen, dev, "gtr+g4")
    line = None
    for label, (Q, b) in (
            ("primate", expm_inputs(gen, dev)),
            ("DS1 gtr+g4", (Qd, bd)),
            ("DS1 twist rank 0", expm_inputs(gen, dev, "gtr+g4",
                                              pairs=N_DS1 * (N_DS1 - 1) // 2)),
            ("DS1 twist last rank", expm_inputs(gen, dev, "gtr+g4",
                                                 pairs=3))):
        entries = check_k4(ek, gen, dev, label, Q, b)
        if label == "DS1 gtr+g4":
            line = entries
        torch.cuda.empty_cache()
    for B in (1, 7, 255, 257, 4099):
        check_k4(ek, gen, dev, "DS1 gtr+g4", Qd, bd[:B].contiguous(),
                 timed=False)
    check_k4(ek, gen, dev, "DS1 gtr+g4", Qd, bd[:4099].contiguous(),
             timed=False, order=8, squarings=6)
    check_k4(ek, gen, dev, "DS1 gtr+g4+i",
             *expm_inputs(gen, dev, "gtr+g4+i"), timed=False)
    P = ek.expm_fwd(Qd, bd)
    gbar = torch.randn(P.shape, generator=gen, device=dev)
    for name, fn in (("expm_fwd", lambda: ek.expm_fwd(Qd, bd)),
                     ("expm_bwd", lambda: ek.expm_bwd(Qd, bd, P, gbar))):
        before = _ext.LAUNCHES[name]
        seen, made = device_kernels(fn)
        counted = (_ext.LAUNCHES[name] - before) / made
        log(f"  K4 one {name} call captured as a CUDA graph: "
            f"{json.dumps(seen)}; launch counter +{counted} a call")
        require(len(seen) == 1 and seen[0][1] == 1 and counted == 1
                and f"{name}_kernel" in seen[0][0],
                f"K4: one {name} call launched {seen}, counted {counted}")
    torch.cuda.empty_cache()
    return line


def sm_clock_hz():
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def k5_bound(K, field=False):
    """(ms, by) of K draws: the logits read and the indices written once,
    against the pipes the work issues to at the card's maximum SM clock:
    MUFU (16 a clock an SM) for each exp or log, IMAD (64 a clock an SM)
    for Philox4x32-10's 40 multiplies a call.  The inverse CDF: one exp a
    particle, half a Philox call a draw.  field=True: the former (K, K)
    Gumbel field, two logs and a quarter of a Philox call an entry."""
    clk = sm_clock_hz() * 132
    n = K * K if field else K
    mufu = 2 * n if field else n
    imad = 40 * n / (4 if field else 2)
    t_ops = max(mufu / (16 * clk), imad / (64 * clk)) * 1e3
    t_bytes = (8 * K + 16) / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k5(rk, gen, dev, Kd=K):
    """K5 on Kd skewed weights (Gumbel logits spanning ~3 orders of
    magnitude), every 13th particle from the 4th at weight 0 (-inf): the
    kernel against its plain version on the same seed, -inf never drawn,
    two calls bit-identical, one device kernel a call, the law by
    chi-square over 512 x Kd draws beside torch.multinomial's; timed
    beside the plain version, torch.multinomial and the former design."""
    rng = np.random.default_rng(7)
    logits = torch.tensor(rng.gumbel(size=Kd) * 2.0, dtype=torch.float32,
                          device=dev)
    dead = slice(3, None, 13)
    logits[dead] = -math.inf
    log_norm = (logits - torch.logsumexp(logits, 0)).contiguous()
    p = torch.softmax(logits.double(), 0).cpu().numpy()
    seed = rk.draw_seed(gen, dev)
    got = rk.categorical(log_norm, seed)
    want = rk._categorical_plain(log_norm, seed)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    log(f"  K5 categorical K={Kd}: {mism} of {Kd} draws differ from the "
        "plain version on the same seed (tol 2)")
    require(mism <= 2, f"K5 disagrees with its plain version on {mism}")
    repeat_checks(f"K5 categorical K={Kd}", lambda: (rk.categorical(
        log_norm, seed),))
    rounds = 512
    counts = {"kernel": torch.zeros(Kd, dtype=torch.int64, device=dev),
              "torch.multinomial": torch.zeros(Kd, dtype=torch.int64,
                                               device=dev)}
    probs = torch.softmax(logits, 0)
    for _ in range(rounds):
        s = rk.draw_seed(gen, dev)
        counts["kernel"] += torch.bincount(
            rk.categorical(log_norm, s).long(), minlength=Kd)
        counts["torch.multinomial"] += torch.bincount(torch.multinomial(
            probs, Kd, replacement=True, generator=gen), minlength=Kd)
    drawn = int(counts["kernel"][dead].sum())
    require(drawn == 0, f"K5 drew a -inf particle {drawn} times")
    n = rounds * Kd
    zs = {}
    for name, c in counts.items():
        chi2, dof = pooled_chi2(c.cpu().numpy(), p, n)
        zs[name] = (chi2 - dof) / math.sqrt(2 * dof)
        log(f"  K5 {name} K={Kd}: chi2 {chi2:.1f} on {dof} dof over "
            f"{rounds}x{Kd} draws (z = {zs[name]:+.2f}); -inf particles "
            f"drawn {int(c[dead].sum())} times")
    require(abs(zs["kernel"]) < 4.0, f"K5 chi-square z {zs['kernel']}")
    ms = time_ms(lambda: rk.categorical(log_norm, seed))
    plain = time_ms(lambda: rk._categorical_plain(log_norm, seed), iters=5)
    lib = time_ms(lambda: torch.multinomial(probs, Kd, replacement=True,
                                            generator=gen))
    b_ms, b_by = k5_bound(Kd)
    f_ms, f_by = k5_bound(Kd, field=True)
    log(f"  K5 K={Kd}: kernel {ms:.4f} ms ({former('K5', Kd, 1, 1)}), "
        f"plain {plain:.4f} ms, torch.multinomial {lib:.4f} ms, bound "
        f"{b_ms:.6f} ms ({b_by}; latency-bound: one block's dependent "
        f"max, scan and search); the former Gumbel field's bound "
        f"{f_ms:.4f} ms ({f_by})")
    return dict(max_abs_err=float((got - want).abs().max()), ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib)


def check_k8(kern, gen, dev, S, A=A, timed=True):
    """K8 on the VNCSMC path's chosen merges: K=32 particles, explicit
    children, S=256 (SGD steps) or 898 (eval sweeps); untimed at other
    alphabets and sizes (above 4 states at most 512 threads, so a thread
    takes two sites at S=898, over two passes)."""
    f = dict(dtype=torch.float32, device=dev)
    Kt = K_TWIST
    m1 = torch.rand((Kt, A, S), generator=gen, **f) * 0.95 + 0.05
    m2 = torch.rand((Kt, A, S), generator=gen, **f) * 0.95 + 0.05
    P_l = torch.rand((Kt, A, A), generator=gen, **f) * 0.95 + 0.05
    P_r = torch.rand((Kt, A, A), generator=gen, **f) * 0.95 + 0.05
    pi = torch.rand((A,), generator=gen, **f) + 0.1
    pi = (pi / pi.sum()).contiguous()
    w = torch.ones((S,), **f)
    args = (m1, m2, P_l, P_r, pi, w)
    got = kern.merge_loglik(*args)
    want = kern._ref_impl(*args)
    torch.cuda.synchronize()
    errs = {"merged": max_abs(got[0], want[0]),
            "rootll": max_rel(got[1], want[1]),
            "logscale": max_rel(got[2], want[2])}
    tol = 1e-5   # f32 site sums of S logs, summed in another order
    log(f"  K8 fused_merge_loglik K={Kt} A={A} S={S}: " + ", ".join(
        f"{k} err {v:.3e}" for k, v in errs.items()) + f" (tol {tol:g})")
    for k, v in errs.items():
        require(v <= tol, f"K8 {k} error {v} > {tol}")
    repeat_checks(f"K8 K={Kt} A={A} S={S} (plan: "
                  f"{kern.merge_ll_plan(S, A)} threads a particle)",
                  lambda: kern.merge_loglik(*args),
                  kernel="merge_loglik_kernel")
    if not timed:
        return None
    ms = time_ms(lambda: kern.merge_loglik(*args))
    plain = time_ms(lambda: kern._ref_impl(*args))
    floor = time_ms(lambda: torch.cuda._sleep(0))
    slab = Kt * A * S * 4
    nbytes = 3 * slab + 2 * Kt * A * A * 4 + A * 4 + S * 4 + 2 * Kt * 4
    nops = Kt * S * (4 * A * A + 4 * A + 2)
    b_ms, b_by = bound(nbytes, nops)
    log(f"  K8 S={S}: kernel {ms:.4f} ms ({former('K8', Kt, A, S)}), "
        f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}); the launch "
        f"floor (an empty kernel, the same sleep-held stream) {floor:.4f} "
        "ms; library: null (no single PyTorch call merges, rescales and "
        "reduces the root log-likelihood)")
    return dict(max_abs_err=max(max_abs(a, b) for a, b in zip(got, want)),
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def check_k7(kern, gen, dev, KC=K_TWIST * (N * (N - 1) // 2), M_=M_TWIST,
             S=S_BATCH, A_=A, timed=True):
    """K7 at the VNCSMC training shapes: M=10 subsamples, KC = 32
    particles x 66 candidate pairs (rank 0 of primate), S=256 sites;
    also ragged and small shapes, untimed.  Two launches give the same
    bits and one is one device kernel (the launcher alone: the wrapper
    adds its dpi ops)."""
    f = dict(dtype=torch.float32, device=dev)
    m1 = torch.rand((KC, A_, S), generator=gen, **f) * 0.95 + 0.05
    m2 = torch.rand((KC, A_, S), generator=gen, **f) * 0.95 + 0.05
    P_l = torch.rand((M_, KC, A_, A_), generator=gen, **f) * 0.95 + 0.05
    P_r = torch.rand((M_, KC, A_, A_), generator=gen, **f) * 0.95 + 0.05
    pi = torch.rand((A_,), generator=gen, **f) + 0.1
    pi = (pi / pi.sum()).contiguous()
    w = torch.ones((S,), **f)
    g = torch.randn((M_, KC), generator=gen, **f)
    args = (m1, m2, P_l, P_r, pi, w, g)
    got = kern.pair_ll_bwd(*args, want_dw=False)[:5]
    want = kern._pair_ll_bwd_plain(*args)[:5]
    torch.cuda.synchronize()
    names = ["dm1", "dm2", "dP_l", "dP_r", "dpi"]
    errs = {n: max_rel(a, b) for n, a, b in zip(names, got, want)}
    # f32 sums over M subsamples (dm) and S sites (dP, dpi), in another
    # order than the plain version's autograd
    tol = 1e-4
    plan = kern.twist_narrow_plan(KC, M_, A_, S)
    log(f"  K7 pair_ll_bwd M={M_} KC={KC} A={A_} S={S} (plan: spl, warps, "
        f"chunks, blocks, smem {plan}): " + ", ".join(
            f"{n} rel err {v:.3e}" for n, v in errs.items())
        + f" (tol {tol:g})")
    for n, v in errs.items():
        require(v <= tol, f"K7 {n} relative error {v} > {tol}")
    fn = kern._ext.bind("twist_kernels", "launch_pair_ll_bwd", 11, 6)

    def launch():
        o = [torch.empty_like(t) for t in (m1, m2, P_l, P_r)]
        code = fn(*[t.data_ptr() for t in (*args, *o)], KC, M_, A_, S,
                  plan[0], plan[1], torch.cuda.current_stream().cuda_stream)
        require(code == 0, f"K7 launch error {code}")
        return o
    repeat_checks(f"K7 M={M_} KC={KC} A={A_} S={S} (launcher)", launch,
                  kernel="pair_ll_bwd_narrow_kernel")
    if not timed:
        return None
    ms = time_ms(lambda: kern.pair_ll_bwd(*args, want_dw=False))
    alone = time_ms(launch)
    plain = time_ms(lambda: kern._pair_ll_bwd_plain(*args), iters=5)
    slab = KC * A_ * S * 4
    pbytes = M_ * KC * A_ * A_ * 4
    nbytes = 4 * slab + 4 * pbytes + M_ * KC * 4 + S * 4 + 2 * A_ * 4
    # per (m, k, s): u, v (4 A^2), site (3 A), gsite (2), du/dv (4 A),
    # dm and dP accumulation (8 A^2); an FMA counts 2
    nops = M_ * KC * S * (12 * A_ * A_ + 7 * A_ + 2)
    b_ms, b_by = bound(nbytes, nops)
    log(f"  K7 M={M_} KC={KC} S={S}: kernel {ms:.4f} ms (the launch alone "
        f"{alone:.4f}; {former('K7', KC, A_, S)}), plain {plain:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.0%} of it reached); "
        "library: null (no single PyTorch call computes this "
        "vector-Jacobian product)")
    return dict(max_abs_err=max(max_abs(a, b) for a, b in zip(got, want)),
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def twist_inputs(gen, dev, dataset, spec, C, S, A_=None, Kt=K_TWIST,
                 G_=None, blocked=False, codons=False):
    """The twist's pair-loglik inputs at rank 0 of `dataset` under model
    `spec` (ReferenceQ for None): the first C prefix-ordered candidate
    pairs (leaves, shared by the Kt particles) over the first S sites,
    and the transitions of pool branch lengths b = eps / 10 (the initial
    rates) at the model's initial parameters, M_TWIST subsamples; KC =
    Kt * C rows in the sweep's K-major order.  `blocked`: a rate
    mixture's per-category transitions (M, KC, G, A_b, A_b), as the
    twist takes them.  With A_, random inputs of A_ states instead (a
    small shape), or of G_ blocks of A_ states with G_.  `codons`: the
    dataset as 61 sense codons (GY94 with its F61 frequencies)."""
    from phylo_tpu_torch.smc import twist as tw
    from phylo_tpu_torch.train.trainer import TrainConfig, init_params

    f = dict(dtype=torch.float32, device=dev)
    KC = Kt * C
    if A_ is not None:
        GA, tail = (A_, (A_, A_)) if G_ is None else (G_ * A_, (G_, A_, A_))
        m_l, m_r = (torch.rand((KC, GA, S), generator=gen, **f) * 0.95 + 0.05
                    for _ in range(2))
        P_l, P_r = (torch.rand((M_TWIST, KC) + tail, generator=gen, **f)
                    * 0.95 + 0.05 for _ in range(2))
        pi = torch.rand((GA,), generator=gen, **f) + 0.1
        return m_l, m_r, P_l, P_r, (pi / pi.sum()).contiguous(), \
            torch.ones((S,), **f)
    ds = load(dataset, codons)
    model, params = init_params(ds, TrainConfig(
        n_particles=Kt, device=dev, substitution_model=spec))
    genome = ds.genome[:, :S]
    if hasattr(model, "expand_leaves"):
        genome = model.expand_leaves(genome)
    leaves = torch.tensor(genome, **f).transpose(1, 2).contiguous()
    pairs = tw._tables(ds.N, dev)[0][:C]
    As = leaves.shape[1]
    m_l, m_r = (leaves[pairs[:, j]][None].expand(Kt, C, As, S)
                .reshape(KC, As, S).contiguous() for j in range(2))
    eps = torch.empty((2 * C, M_TWIST, Kt), **f).exponential_(generator=gen)
    with torch.no_grad():
        fn = model.transition_blocks if blocked else model.transition
        P = fn(params["model"], eps / 10.0).float()
        pi = model.stationary(params["model"], **f).float()
    P_l, P_r = (x.permute((1, 2, 0) + tuple(range(3, P.ndim)))
                .reshape((M_TWIST, KC) + P.shape[3:]).contiguous()
                for x in (P[:C], P[C:]))
    return m_l, m_r, P_l, P_r, pi.contiguous(), torch.ones((S,), **f)


def dense_inputs(kern, ins):
    """Blocked twist inputs with P as its dense block-diagonal form."""
    return ins[:2] + tuple(kern.blockdiag_dense(P).contiguous()
                           for P in ins[2:4]) + ins[4:]


def first_rows(ins, n):
    """The first n rows (KC) of twist inputs."""
    return tuple((x[:, :n] if x.ndim >= 4 else x[:n] if x.ndim == 3 else x)
                 .contiguous() for x in ins)


def twist_bound(ins, kind):
    """Bound of one twist call on inputs `ins`: the forward K11b, the
    backward K7 / K7 wide, or the T-field backward K11c with its dP
    products; P dense (G = 1) or blocked, G blocks of A_b states, A = G
    A_b planes.  Operations per (m, row, site): u, v (4 A^2 / G, an FMA
    counts 2), the site sum and its log (3 A + 2); the backwards add
    gsite (2), du, dv (4 A) and dm, dP (8 A^2 / G), or pi u, pi v, vbar,
    ubar and T (6 A^2 / G + 4 A) and per (m, row) the two A_b x A_b
    products of each block (4 G A_b^3).  Bytes: each input read once (P:
    G A_b^2 floats a matrix), each output written once."""
    m1, _, P_l, _, _, w = ins
    M_, KC = P_l.shape[:2]
    G = P_l.shape[2] if P_l.ndim == 5 else 1
    A_ = m1.shape[1]
    AA = A_ * A_ // G
    S = w.shape[0]
    slab = KC * A_ * S * 4
    pbytes = M_ * KC * AA * 4
    if kind == "fwd":
        nbytes = 2 * slab + 2 * pbytes + M_ * KC * 4 + S * 4 + A_ * 4
        nops = M_ * KC * S * (4 * AA + 3 * A_ + 2)
    else:
        nbytes = 4 * slab + 4 * pbytes + M_ * KC * 4 + S * 4 + 2 * A_ * 4
        per = (12 * AA + 7 * A_ + 2 if kind == "bwd"
               else 10 * AA + 7 * A_ + 2)
        nops = M_ * KC * S * per + (4 * M_ * KC * G * (A_ // G) ** 3
                                    if kind == "bwd_t" else 0)
    return bound(nbytes, nops)


def ab_ms(fa, fb, iters_a=20, iters_b=20):
    """Times of fa and fb in turns a, b, b, a (one card, one call)."""
    a1 = time_ms(fa, iters=iters_a)
    b1 = time_ms(fb, iters=iters_b)
    b2 = time_ms(fb, iters=iters_b)
    a2 = time_ms(fa, iters=iters_a)
    return (a1, a2), (b1, b2)


def check_k11b(kern, ins, label, timed=True, repeat=False):
    """K11b (the pair-loglik forward) against its plain version; with
    `repeat`, also called twice (the same bits) and once captured (one
    device kernel and the wrapper's sum of the tiles' partials); timed,
    the A/B against the plain forward in turns plain, kernel, kernel,
    plain."""
    got = kern.pair_ll_fwd(*ins)
    want = kern._pair_ll_ref(*ins)
    torch.cuda.synchronize()
    err = max_rel(got, want)
    M_, KC = ins[2].shape[:2]
    tol = 1e-4   # f32 sums over S sites of logs, in another order
    log(f"  K11b {label} M={M_} KC={KC} P {tuple(ins[2].shape[2:])} "
        f"S={ins[0].shape[-1]}: rel err {err:.3e} (tol {tol:g})")
    require(err <= tol, f"K11b {label} relative error {err} > {tol}")
    if repeat:
        repeat_checks(f"K11b {label}", lambda: [kern.pair_ll_fwd(*ins)],
                      sums=1, kernel="pair_ll_fwd_kernel")
    if not timed:
        return None
    with torch.no_grad():
        (p1, p2), (k1_, k2_) = ab_ms(lambda: kern._pair_ll_ref(*ins),
                                     lambda: kern.pair_ll_fwd(*ins),
                                     iters_a=5)
    b_ms, b_by = twist_bound(ins, "fwd")
    log(f"  K11b {label} A/B (plain, kernel, kernel, plain): {p1:.4f}, "
        f"{k1_:.4f}, {k2_:.4f}, {p2:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
        "library: null (no single PyTorch call computes it)")
    return dict(max_abs_err=max_abs(got, want), ms=(k1_ + k2_) / 2,
                plain_ms=(p1 + p2) / 2, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def bwd_launch(kern, ins, g, t_field, gb=None):
    """One launch of K7 wide (t_field False: dense A > 8 or blocked) or
    K11c (K7's body in its T-field form at dense A <= 8, K7 wide's above
    and blocked) through its C entry point at the wrapper's plan (gb:
    blocks a group, default the plan's), without the wrapper's dpi ops;
    returns (the launch, the kernel's name, the plan)."""
    M_, KC = ins[2].shape[:2]
    G = ins[2].shape[2] if ins[2].ndim == 5 else 1
    Ab, S = ins[2].shape[-1], ins[0].shape[-1]
    if G > 1 or Ab > kern.MAX_A:
        gb = gb or kern.twist_bwd_group(G, Ab, S, t_field, M_, KC)
        entry = "launch_pair_ll_bwd_t" if t_field else \
            "launch_pair_ll_bwd_wide"
        fn = kern._ext.bind("twist_wide_kernels", entry, 11, 9)
        plan = kern.twist_bwd_plan(G, Ab, S, t_field, M_, gb) + (gb,)
        ints = (KC, M_, G, Ab, S) + plan
        name = {(False, True): "pair_ll_bwd_wide_kernel",
                (True, True): "pair_ll_bwd_t_wide_kernel",
                (False, False): "pair_ll_bwd_wide_groups_kernel",
                (True, False): "pair_ll_bwd_t_groups_kernel"}[
                    (t_field, gb == G)]
    else:
        require(t_field, "K7 at A <= 8 is check_k7's")
        fn = kern._ext.bind("twist_kernels", "launch_pair_ll_bwd_t", 11, 6)
        plan = kern.twist_narrow_plan(KC, M_, Ab, S, t_field=True)[:2]
        ints = (KC, M_, Ab, S) + plan
        name = "pair_ll_bwd_t_narrow_kernel"

    def launch():
        o = [torch.empty_like(t) for t in ins[:4]]
        code = fn(*[t.data_ptr() for t in (*ins, g, *o)], *ints,
                  torch.cuda.current_stream().cuda_stream)
        require(code == 0, f"{name} launch error {code}")
        return o
    return launch, name, plan


def check_twist_bwd(kern, gen, ins, label, t_field, timed=True,
                    full=None, plain_iters=3):
    """K7 wide, dense or blocked (t_field False), or K11c (the T-field
    backward, dP formed from T in the kernel) against its plain version;
    also called twice through its launcher (the same bits) and once
    captured (one device kernel); timed at these inputs (the plain
    version over `plain_iters` calls, or where that is 1 the call that
    gave the reference, after the kernel's: at GY94's rank 0 its unrolled
    autograd VJP takes ~16 s a call), and the kernel alone at the `full`
    rank-0 inputs."""
    M_, KC = ins[2].shape[:2]
    f = dict(dtype=torch.float32, device=ins[0].device)
    g = torch.randn((M_, KC), generator=gen, **f)
    kind = "bwd_t" if t_field else "bwd"
    plain = kern._pair_ll_bwd_t_ref if t_field else kern._pair_ll_bwd_plain
    old = kern.TWIST_BWD_V2
    kern.TWIST_BWD_V2 = t_field
    try:
        got = kern.pair_ll_bwd(*ins, g, want_dw=False)[:5]
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        want = plain(*ins, g)[:5]
        ev[1].record()
        torch.cuda.synchronize()
        names = ["dm1", "dm2", "dP_l", "dP_r", "dpi"]
        errs = {n: max_rel(a, b) for n, a, b in zip(names, got, want)}
        tol = 1e-4   # f32 sums over M (dm) and S (dP, dpi) in another order
        log(f"  {label} M={M_} KC={KC} P {tuple(ins[2].shape[2:])} "
            f"S={ins[0].shape[-1]}: "
            + ", ".join(f"{n} rel err {v:.3e}" for n, v in errs.items())
            + f" (tol {tol:g})")
        for n, v in errs.items():
            require(v <= tol, f"{label} {n} relative error {v} > {tol}")
        # dP and dpi entry by entry.  A dP entry is the cotangent g[m, kc]
        # times a sum over the sites of terms of one sign: each is held
        # at the relative bar, however small beside the largest.  dpi[b]
        # = sum over (m, kc, a) of dP_l[.., a, b] P_l[.., a, b] / pi_b,
        # terms of either sign (g's), so each entry is held against that
        # sum of magnitudes
        P_l, pi = ins[2], ins[4]
        dpi_scale = ((want[2].abs() * P_l).sum(dim=(0, 1, -2)).reshape(-1)
                     / pi)
        for n, a, b, sc in zip(names[2:], got[2:], want[2:],
                               (None, None, dpi_scale)):
            e, med = entry_rel(a, b, sc)
            of = "|entry|" if sc is None else "sum of |terms|"
            log(f"  {label} {n} entry-wise rel err {e:.3e} of its {of} "
                f"(tol {tol:g}; median |entry| {med:.3e}, largest "
                f"{float(b.abs().max()):.3e})")
            require(e <= tol, f"{label} {n} entry-wise relative error {e} "
                    f"> {tol}")
        launch, kname, plan = bwd_launch(kern, ins, g, t_field)
        repeat_checks(f"{label} M={M_} KC={KC} (launcher, plan {plan})",
                      launch, kernel=kname)
        if not timed:
            return None
        ms = time_ms(lambda: kern.pair_ll_bwd(*ins, g, want_dw=False))
        plain_ms = (time_ms(lambda: plain(*ins, g), iters=plain_iters)
                    if plain_iters > 1 else ev[0].elapsed_time(ev[1]))
        b_ms, b_by = twist_bound(ins, kind)
        A_, S = ins[0].shape[1:]
        alone = ""
        if t_field:
            alone = (f" (the launch alone {time_ms(launch):.4f}; "
                     f"{former('K11c', KC, A_, S)})")
        log(f"  {label} KC={KC}: kernel {ms:.4f} ms{alone}, "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{b_ms / ms:.0%} of it reached); library: null (no single "
            "PyTorch call computes this vector-Jacobian product)")
        if full is not None:
            gf = torch.randn(full[2].shape[:2], generator=gen, **f)
            ms_f = time_ms(lambda: kern.pair_ll_bwd(*full, gf,
                                                    want_dw=False))
            bf, bfy = twist_bound(full, kind)
            KCf = full[2].shape[1]
            was = f" ({former('K11c', KCf, A_, S)})" if t_field else ""
            log(f"  {label} at rank 0's KC={KCf}: kernel {ms_f:.4f} ms"
                f"{was}, bound {bf:.4f} ms ({bfy})")
    finally:
        kern.TWIST_BWD_V2 = old
    return dict(max_abs_err=max(max_abs(a, b) for a, b in zip(got, want)),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def check_forms(kern, gen, ins, label, timed=True):
    """The blocked forms of K11b and K7 wide against their dense forms on
    the same inputs, P as its block-diagonal dense form (within 1e-6: the
    same chains, the dense form's off-block terms exact zeros; dP over
    the diagonal blocks, summed over the sites in another split); timed,
    their A/B in one call, in turns dense, blocked, blocked, dense."""
    dense = dense_inputs(kern, ins)
    M_, KC, G = ins[2].shape[:3]
    Ab = ins[2].shape[-1]
    g = torch.randn((M_, KC), generator=gen, dtype=torch.float32,
                    device=ins[0].device)
    fwd_b, fwd_d = kern.pair_ll_fwd(*ins), kern.pair_ll_fwd(*dense)
    bwd_b = kern.pair_ll_bwd(*ins, g, want_dw=False)[:5]
    bwd_d = list(kern.pair_ll_bwd(*dense, g, want_dw=False)[:5])
    for i in (2, 3):
        bwd_d[i] = torch.stack([bwd_d[i][:, :, j * Ab:(j + 1) * Ab,
                                         j * Ab:(j + 1) * Ab]
                                for j in range(G)], dim=2)
    torch.cuda.synchronize()
    errs = {"ll": max_rel(fwd_b, fwd_d)}
    errs.update({n: max_rel(a, b) for n, a, b in zip(
        ("dm1", "dm2", "dP_l", "dP_r", "dpi"), bwd_b, bwd_d)})
    # 1e-6 for the kernels' outputs; dpi is the wrapper's float32 torch.sum
    # of dP P over M KC A_b terms of both signs (g is random), reduced in
    # another order in each form: 1e-5
    tols = {n: 1e-5 if n == "dpi" else 1e-6 for n in errs}
    log(f"  {label} blocked vs dense forms, KC={KC} G={G} A_b={Ab}: "
        + ", ".join(f"{n} rel err {v:.3e} (tol {tols[n]:g})"
                    for n, v in errs.items()))
    for n, v in errs.items():
        require(v <= tols[n], f"{label} blocked vs dense {n}: {v} > "
                f"{tols[n]}")
    if not timed:
        return
    with torch.no_grad():
        (d1, d2), (b1, b2) = ab_ms(lambda: kern.pair_ll_fwd(*dense),
                                   lambda: kern.pair_ll_fwd(*ins))
    log(f"  {label} K11b A/B (dense, blocked, blocked, dense): {d1:.4f}, "
        f"{b1:.4f}, {b2:.4f}, {d2:.4f} ms")
    (d1, d2), (b1, b2) = ab_ms(
        lambda: kern.pair_ll_bwd(*dense, g, want_dw=False),
        lambda: kern.pair_ll_bwd(*ins, g, want_dw=False))
    log(f"  {label} K7 wide A/B (dense, blocked, blocked, dense): "
        f"{d1:.4f}, {b1:.4f}, {b2:.4f}, {d2:.4f} ms")


def group_forms(kern, gen, ins, label):
    """K7 wide blocked's and K11c blocked's block groups at `ins`: the
    plan's launch against all G blocks in one group (one pass) and 2 and
    1 blocks a group (two passes: gsite from a first pass over the
    groups, u and v again in the second), each through the entry point:
    dm to the bit (gsite is the one-group chain), dP within 1e-6 (its site
    sums split among other thread counts); timed in turns first..last,
    last..first."""
    M_, KC, G = ins[2].shape[:3]
    g = torch.randn((M_, KC), generator=gen, dtype=torch.float32,
                    device=ins[0].device)
    for t_field in (False, True):
        what = "K11c" if t_field else "K7 wide"
        forms = {gb: bwd_launch(kern, ins, g, t_field, gb)
                 for gb in dict.fromkeys((kern.twist_bwd_group(
                     G, ins[2].shape[-1], ins[0].shape[-1], t_field, M_,
                     KC), G, 2, 1))}
        first, *rest = forms
        base = forms[first][0]()
        for gb in rest:
            got = forms[gb][0]()
            torch.cuda.synchronize()
            same = all(bool(torch.equal(a, b)) for a, b in
                       zip(got[:2], base[:2]))
            err = max(max_rel(a, b) for a, b in zip(got[2:], base[2:]))
            log(f"  {what} {label} {gb} blocks a group (plan {forms[gb][2]}"
                f") against {first} ({forms[first][2]}): dm the same bits: "
                f"{same}; dP rel err {err:.3e} (tol 1e-6)")
            require(same and err <= 1e-6, f"{what} {label}: {gb} blocks a "
                    f"group differ from {first}")
        order = list(forms) + list(forms)[::-1]
        times = [(gb, time_ms(forms[gb][0])) for gb in order]
        log(f"  {what} {label} blocks a group: ms in turns: " + ", ".join(
            f"{gb}: {ms:.4f}" for gb, ms in times))


def check_twist_kernels(kernels, gen, dev):
    """Phase 2's pair-loglik kernels (K11b, K7 wide, K11c), dense and
    blocked; returns the kernels line's entries (K11b dense, K11b
    blocked, K7 wide dense, K7 wide blocked, K11c at primate's launched
    shape, K11c blocked at protein+G4's, and K11b and K7 wide dense at
    GY94's rank 0)."""
    # VNCSMC's pair log-likelihoods at rank 0 (all candidate pairs):
    # K11b dense on primate (A=4, KC = 32 x 66); on DS1 GTR+G4 (KC = 32 x
    # 351) blocked, as the twist takes a rate mixture (G=4 blocks of 4),
    # and dense on the same block-diagonal transitions (PR 6's 16 dense
    # states), each in an A/B against the plain forward; K7 wide blocked
    # and dense and K11c on the first KC = 896 rows (32 x 28, the row
    # count of rank 19), where the plain autograd VJP fits, and the
    # kernels alone at rank 0's KC; the blocked forms against the dense
    # ones; A = 20 (+I) and 61 (codons) dense, and blocked G=5 x 4 (+I),
    # 2 x 20, 3 x 7 and 4 x 4 over two site chunks, small
    twist_p = twist_inputs(gen, dev, "primate", None, N * (N - 1) // 2,
                           S_BATCH)
    check_k11b(kernels, twist_p, "primate")
    # K11c where phase 4 launches it: primate rank 0 (A=4, KC = 32 x 66),
    # K7's narrow body in its T-field form
    k11c = check_twist_bwd(kernels, gen, twist_p, "K11c pair_ll_bwd_t "
                           "primate", True)
    # and at later ranks' row counts, where the plan puts 4 warps (KC=480)
    # and 8 warps of a site a lane (KC=32) on a row: the T slots summed
    # over warps before dP is formed
    for KC_ in (480, 32):
        check_twist_bwd(kernels, gen, first_rows(twist_p, KC_),
                        f"K11c primate KC={KC_}", True, timed=False)
    del twist_p
    twist_b = twist_inputs(gen, dev, "hohna_data_1", "gtr+g4",
                           N_DS1 * (N_DS1 - 1) // 2, S_BATCH, blocked=True)
    twist_d = dense_inputs(kernels, twist_b)
    k11b_blk = check_k11b(kernels, twist_b, "DS1 gtr+g4 blocked")
    k11b = check_k11b(kernels, twist_d, "DS1 gtr+g4 dense")
    rows_b = first_rows(twist_b, K_TWIST * 28)
    rows_d = dense_inputs(kernels, rows_b)
    k7wb = check_twist_bwd(kernels, gen, rows_b, "K7 wide blocked", False,
                           full=twist_b)
    k7w = check_twist_bwd(kernels, gen, rows_d, "K7 wide dense", False,
                          full=twist_d)
    check_twist_bwd(kernels, gen, rows_d, "K11c pair_ll_bwd_t DS1 dense",
                    True, full=twist_d)
    check_forms(kernels, gen, rows_b, "DS1 gtr+g4 KC=896")
    check_forms(kernels, gen, twist_b, "DS1 gtr+g4 rank 0")
    del twist_b, twist_d, rows_b, rows_d
    # protein+G4 (G=4 blocks of 20 states, 80 planes) at rank 0 of the
    # simulated 16 x 500 alignment (KC = 32 x 120): K11b blocked in four
    # block groups of one block of 32 padded states, K7 wide and K11c
    # blocked a block a group (two passes, SC = 256); the plain backwards
    # on the first 896 rows, the kernels alone at rank 0; the plan's
    # groups against all 4 blocks in one (SC = 96) and 2 a group
    prot = twist_inputs(gen, dev, PROT_FASTA, "reference+g4",
                        N_PROT * (N_PROT - 1) // 2, S_BATCH, blocked=True)
    k11b_prot = check_k11b(kernels, prot, "protein+G4 blocked", repeat=True)
    rows_p = first_rows(prot, K_TWIST * 28)
    k7wb_prot = check_twist_bwd(kernels, gen, rows_p,
                                "K7 wide blocked protein+G4", False,
                                full=prot)
    k11c_blk = check_twist_bwd(kernels, gen, rows_p,
                               "K11c blocked protein+G4", True, full=prot)
    group_forms(kernels, gen, rows_p, "protein+G4 KC=896")
    # the last ranks' rows (3 and 2 taxa left: 96 and 32), where the grid
    # holds under two blocks an SM and the plan keeps one group
    group_forms(kernels, gen, first_rows(rows_p, 96), "protein+G4 KC=96")
    log("  protein+G4 rank 0 line entries (K11b blocked, K7 wide blocked): "
        + json.dumps([k11b_prot, k7wb_prot]))
    del prot, rows_p
    torch.cuda.empty_cache()
    # GY94 at rank 0 of betacorona1 (61 dense states, KC = 32 x 136, S =
    # 256: VNCSMC GY94's first rank, which its pair chunks split in two):
    # K11b dense and K7 wide dense, each timed beside its plain version
    # (the unrolled expression and its autograd VJP)
    gy = twist_inputs(gen, dev, "betacorona1", "gy94",
                      N_CODON * (N_CODON - 1) // 2, S_BATCH, codons=True)
    k11b_61 = check_k11b(kernels, gy, "GY94 dense 61", repeat=True)
    k7w_61 = check_twist_bwd(kernels, gen, gy, "K7 wide dense GY94", False,
                             plain_iters=1)
    del gy
    torch.cuda.empty_cache()
    for A_, S in ((20, 70), (61, 70), (20, 300)):
        small = twist_inputs(gen, dev, None, None, 5, S, A_=A_, Kt=3)
        check_k11b(kernels, small, "small dense", timed=False)
        check_twist_bwd(kernels, gen, small, "K7 wide small dense", False,
                        timed=False)
        check_twist_bwd(kernels, gen, small, "K11c small", True,
                        timed=False)
    for G_, A_, S in ((5, 4, 70), (2, 20, 70), (3, 7, 70), (4, 4, 300)):
        small = twist_inputs(gen, dev, None, None, 5, S, A_=A_, Kt=3, G_=G_)
        check_k11b(kernels, small, "small blocked", timed=False)
        check_twist_bwd(kernels, gen, small, "K7 wide small blocked", False,
                        timed=False)
        check_forms(kernels, gen, small, "small", timed=False)
    # over 64 planes (the forms of this slice's block groups): K11b in
    # groups of 64 padded planes, K7 wide and K11c in one group (3 x 20, 8
    # x 20, 17 x 4) or in groups of one block (4 x 61, GY94+G4's width);
    # over two site tiles of K11b and two or more chunks of K7 wide
    for G_, A_ in ((3, 20), (8, 20), (4, 61), (17, 4)):
        small = twist_inputs(gen, dev, None, None, 5, 300, A_=A_, Kt=3,
                             G_=G_)
        label = f"small {G_} x {A_}"
        check_k11b(kernels, small, label, timed=False, repeat=True)
        check_twist_bwd(kernels, gen, small, f"K7 wide {label}", False,
                        timed=False)
        check_twist_bwd(kernels, gen, small, f"K11c {label}", True,
                        timed=False)
    group_forms(kernels, gen, twist_inputs(gen, dev, None, None, 5, 300,
                                           A_=20, Kt=3, G_=4), "small")
    return k11b, k11b_blk, k7w, k7wb, k11c, k11c_blk, k11b_61, k7w_61


def check_k11a(kern, gen, dev, A_, S=S_BATCH, Kt=K_TWIST, G_=1):
    """K11a (the merge backward on explicit children) at the VNCSMC
    path's chosen merges: K=32 particles, S=256 sites, A_ dense states
    (K2's body for A <= 8, K9bs dense above), or G_ > 1 blocks of A_
    (K9bs blocked's body: protein+G4's 4 x 20)."""
    f = dict(dtype=torch.float32, device=dev)
    GA = G_ * A_
    m1, m2 = (torch.rand((Kt, GA, S), generator=gen, **f) * 0.95 + 0.05
              for _ in range(2))
    tail = (A_, A_) if G_ == 1 else (G_, A_, A_)
    P_l, P_r = (torch.rand((Kt,) + tail, generator=gen, **f) * 0.95 + 0.05
                for _ in range(2))
    pi = torch.rand((GA,), generator=gen, **f) + 0.1
    pi = (pi / pi.sum()).contiguous()
    w = torch.ones((S,), **f)
    args = (m1, m2, P_l, P_r, pi, w) + bwd_cotangents(gen, dev, Kt, GA, S)
    got = kern.merge_bwd(*args)
    want = kern._merge_bwd_ref(*args)
    torch.cuda.synchronize()
    names = ["dm1", "dm2", "dP_l", "dP_r", "dpi", "dw"]
    errs = {n: max_rel(a, b) for n, a, b in zip(names, got, want)}
    tol = 1e-4
    shape = f"A={A_}" if G_ == 1 else f"G={G_} x A={A_}"
    log(f"  K11a merge_bwd K={Kt} {shape} S={S}: " + ", ".join(
        f"{n} rel err {v:.3e}" for n, v in errs.items()) + f" (tol {tol:g})")
    for n, v in errs.items():
        require(v <= tol, f"K11a {n} relative error {v} > {tol}")
    repeat_checks(f"K11a merge_bwd {shape}", lambda: kern.merge_bwd(*args),
                  sums=2, kernel=RANK_BWD_KERNEL if A_ <= kern.MAX_A else
                  "wide_rank_bwd_kernel")
    repeat_checks(f"K11a merge_bwd {shape} without dw",
                  lambda: kern.merge_bwd(*args, want_dw=False)[:5], sums=1)
    ms = time_ms(lambda: kern.merge_bwd(*args))
    ms_no_dw = time_ms(lambda: kern.merge_bwd(*args, want_dw=False))
    plain = time_ms(lambda: kern._merge_bwd_ref(*args))
    slab = Kt * GA * S * 4
    nbytes = (5 * slab + 4 * Kt * G_ * A_ * A_ * 4 + 2 * Kt * 4
              + 2 * (S + GA) * 4)
    # u, v (4 G A^2), dm and dP (8 G A^2), the per-site scalars and the
    # max (about 10 G A); an FMA counts 2
    nops = Kt * S * (12 * G_ * A_ * A_ + 10 * GA)
    b_ms, b_by = bound(nbytes, nops)
    log(f"  K11a {shape}: kernel {ms:.4f} ms ({former('K11a', Kt, GA, S)}), "
        f"without dw {ms_no_dw:.4f} ms, plain {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); library: null (no single PyTorch call "
        "computes this vector-Jacobian product)")
    return dict(max_abs_err=max(max_abs(a, b) for a, b in zip(got, want)),
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def pooled_chi2(counts, p, n, min_expected=5.0):
    """Pearson chi-square of category counts against probabilities p,
    with the categories expected fewer than `min_expected` times pooled
    into one bin (the statistic is far from its asymptote otherwise).
    Returns (chi2, degrees of freedom)."""
    e = n * p
    keep = e >= min_expected
    obs = np.append(counts[keep], counts[~keep].sum())
    exp = np.append(e[keep], e[~keep].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    return float(((obs - exp) ** 2 / exp).sum()), len(exp) - 1


# ---------------------------------------------------------------- phase 3
def make_decisions(rng, N_, K_, rates_l, rates_r):
    R_ = N_ - 1
    ancestors = rng.integers(0, K_, size=(R_, K_))
    pairs = np.zeros((R_, K_, 2), dtype=np.int64)
    for r in range(R_):
        pairs[r] = np.argsort(rng.random((K_, N_ - r)), axis=1)[:, :2]
    bl = np.stack([rng.exponential(1.0 / rates_l[r], size=K_)
                   for r in range(R_)])
    br = np.stack([rng.exponential(1.0 / rates_r[r], size=K_)
                   for r in range(R_)])
    return dict(ancestors=ancestors, pairs=pairs, branches_l=bl,
                branches_r=br)


def make_twist_decisions(rng, N_, K_, M_, rates_l, rates_r):
    """Ancestors, lexicographic branch pools (R, P, M, K) and
    lexicographic flat choices pair * M + m on pairs active at each
    rank, as the JAX package's test_twist.py makes them."""
    R_ = N_ - 1
    pairs = np.asarray([(i, j) for i in range(N_)
                        for j in range(i + 1, N_)])
    P = len(pairs)
    dec = dict(
        ancestors=rng.integers(0, K_, size=(R_, K_)),
        twist_pool_l=rng.exponential(1.0, size=(R_, P, M_, K_))
        / rates_l[:, None, None, None],
        twist_pool_r=rng.exponential(1.0, size=(R_, P, M_, K_))
        / rates_r[:, None, None, None])
    choice = np.zeros((R_, K_), dtype=np.int64)
    for r in range(R_):
        valid = np.flatnonzero(pairs[:, 1] < N_ - r)
        choice[r] = rng.choice(valid, size=K_) * M_ + rng.integers(
            0, M_, size=K_)
    dec["twist_choice"] = choice
    return dec


def mixture_tree(model, rng, Nd):
    """Initial parameters of `model` (nested for a rate mixture) moved by
    seeded noise, as numpy, with branch log-rates near log(10)."""
    from phylo_tpu_torch.params import params_to_numpy

    tree = {"model": params_to_numpy(model.init_params(torch.float64)),
            "branches": {
                "log_rates_l": math.log(10) + 0.3 * rng.normal(size=Nd - 1),
                "log_rates_r": math.log(10) + 0.3 * rng.normal(size=Nd - 1)}}

    def move(sub):
        if isinstance(sub, dict):
            return {k: move(v) for k, v in sub.items()}
        return sub + 0.2 * rng.normal(size=np.shape(sub))
    tree["model"] = move(tree["model"])
    return tree


# the CPU float64 results of fixed_decision_check, by its arguments but
# the card's backward: one CPU run serves both of the card's backwards
_CPU_RUNS = {}


def fixed_inputs(twist=False, spec=None, dataset="primate", Kd=K, S=None,
                 codons=False, Nd=None, use_pallas_ll=True,
                 data_grads=False, pair_chunk=None):
    """fixed_decision_check's inputs, from seed 11: (model, genome (N, S,
    planes), numpy params tree, numpy decisions, SweepConfig, label, the
    site weights or None: uniform in [0.5, 1.5] with `data_grads`)."""
    from phylo_tpu_torch.models.substitution import ReferenceQ, get_model
    from phylo_tpu_torch.smc.sweep import SweepConfig
    from phylo_tpu_torch.smc.twist import TwistConfig
    from phylo_tpu_torch.train.trainer import _resolve_codon_frequencies

    ds = load(dataset, codons)
    rng = np.random.default_rng(11)
    genome = ds.genome[:Nd, :S]
    if spec is None:
        model = ReferenceQ(A)
        tree = {"model": {"y_q": (np.full((A, A), 0.25) * (1 - np.eye(A))
                                  + 0.2 * rng.normal(size=(A, A))),
                          "y_station": 0.25 + 0.2 * rng.normal(size=A)},
                "branches": {"log_rates_l": math.log(10) + 0.3 * rng.normal(
                    size=R), "log_rates_r": math.log(10) + 0.3 * rng.normal(
                    size=R)}}
    else:
        model = _resolve_codon_frequencies(get_model(spec, A=ds.A), ds)
        tree = mixture_tree(model, rng, genome.shape[0])
        if hasattr(model, "expand_leaves"):
            genome = model.expand_leaves(genome)
    rates = (np.exp(tree["branches"]["log_rates_l"]),
             np.exp(tree["branches"]["log_rates_r"]))
    Nd = genome.shape[0]
    if twist:
        Kd = K_TWIST
        dec = make_twist_decisions(rng, Nd, Kd, M_TWIST, *rates)
        cfg = SweepConfig(K=Kd, twist=TwistConfig(
            M=M_TWIST, pair_chunk=pair_chunk, use_pallas_ll=use_pallas_ll))
        label = (f"{os.path.basename(dataset)} {spec or 'reference'} "
                 f"VNCSMC N={Nd} K={Kd} M={M_TWIST} S={genome.shape[1]}"
                 f"{'' if use_pallas_ll else ', plain forward'}"
                 + ("" if pair_chunk is None else
                    f", pair_chunk={pair_chunk} on the card"))
    else:
        dec = make_decisions(rng, Nd, Kd, *rates)
        cfg = SweepConfig(K=Kd)
        label = (f"primate VCSMC K={Kd} S={genome.shape[1]}" if spec is None
                 else f"{os.path.basename(dataset)} {spec} K={Kd} "
                 f"S={genome.shape[1]}")
    weights = (rng.uniform(0.5, 1.5, genome.shape[1]) if data_grads
               else None)
    return model, genome, tree, dec, cfg, label, weights


def rel_l2(a, b):
    return float((a - b).norm() / b.norm())


def fixed_decision_check(dev, twist=False, spec=None, dataset="primate",
                         Kd=K, S=None, route=(), codons=False, Nd=None,
                         use_pallas_ll=True, bwd_v2=False, cpu_bwd_v2=None,
                         data_grads=False, pair_chunk=None, note=""):
    """The sweep with numpy-made decisions, float32 on the card against
    float64 on the CPU: VCSMC at K=2048, VNCSMC at K=32, M=10, or model
    `spec` (a rate mixture, or GY94 on `dataset` as codons, with the
    alignment's F61 frequencies) on the first S sites (and the first Nd
    taxa) of `dataset` at Kd particles; under twist with the pair
    log-likelihoods' forward on K11b (`use_pallas_ll`) or plain, and the
    T-field backward K11c (`bwd_v2`; on the CPU `cpu_bwd_v2`, default
    the same: the two plain backwards are one function, which
    tests/test_torch_twist_mixture_wide.py holds to 1e-12, and at 80
    planes the T-field one is ~10x quicker on the CPU than autograd of
    the unrolled forward).  `route` names the kernels the card must have
    launched in the gradient.  With `data_grads` the sweep takes site
    weights, and the leaves' and weights' cotangents (item 8b) are held
    to the same 1e-2 bar.  `pair_chunk` sets the twist's pair chunks on
    the card; the CPU runs one chunk a rank (tests/test_torch_twist_
    spectral.py holds chunks = one chunk to 1e-12 there).  `note` ends
    the printed label (a cut of the taxa or sites, and why).  Returns the
    two runs' (ELBO, log_likelihood_R, gradients, named gradients, data
    cotangents) by name, and the card run's launches under "launches"."""
    from phylo_tpu_torch import _ext
    from phylo_tpu_torch.params import params_from_numpy
    from phylo_tpu_torch.pruning import kernels
    from phylo_tpu_torch.smc.sweep import sample_phylogenies
    from phylo_tpu_torch.train.trainer import param_tensors

    cpu_bwd_v2 = bwd_v2 if cpu_bwd_v2 is None else cpu_bwd_v2
    t_start = time.time()
    model, genome, tree, dec, cfg, label, weights = fixed_inputs(
        twist, spec, dataset, Kd, S, codons, Nd, use_pallas_ll, data_grads,
        pair_chunk)
    if twist:
        label += (f"{', T-field backward' if bwd_v2 else ''}"
                  f"{', CPU T-field' if cpu_bwd_v2 and not bwd_v2 else ''}")
    label += note
    out = {}
    key = (twist, spec, dataset, Kd, S, codons, Nd, use_pallas_ll,
           cpu_bwd_v2, data_grads)
    if key in _CPU_RUNS:
        out["cpu f64"] = _CPU_RUNS[key]
    for name, device, dtype in (("cuda f32", dev, torch.float32),
                                ("cpu f64", "cpu", torch.float64)):
        if name in out:
            continue
        kernels.TWIST_BWD_V2 = bwd_v2 if device != "cpu" else cpu_bwd_v2
        params = params_from_numpy(tree, dtype=dtype, device=device)
        leaves = torch.tensor(genome, dtype=dtype, device=device,
                              requires_grad=data_grads)
        sw = (None if weights is None else torch.tensor(
            weights, dtype=dtype, device=device, requires_grad=True))
        d = {k: torch.as_tensor(v, device=device) for k, v in dec.items()}
        _ext.reset_launches()
        run_cfg = cfg if device != "cpu" or not twist else replace(
            cfg, twist=replace(cfg.twist, pair_chunk=None))
        res = sample_phylogenies(None, leaves, model, params, run_cfg,
                                 decisions=d, site_weights=sw)
        res.elbo.backward()
        if device != "cpu":
            out["launches"] = dict(_ext.LAUNCHES)
            for kname in (route,) if isinstance(route, str) else route:
                require(_ext.LAUNCHES[kname] > 0, f"{kname} did not run in "
                        f"the {label} gradient")
            if twist and not use_pallas_ll:
                require(_ext.LAUNCHES["pair_loglik_fwd"] == 0,
                        "K11b ran with use_pallas_ll=False")
        grads = [t.grad.detach().cpu().double() for t in param_tensors(params)]
        named = {k: params["model"][k].grad.detach().cpu().double()
                 for k in ("log_alpha", "log_kappa", "log_omega")
                 if k in params["model"]}
        if spec is not None and "log_exch" in params["model"].get("base", {}):
            named["log_exch"] = params["model"]["base"]["log_exch"].grad \
                .detach().cpu().double()
        data = ([t.grad.detach().cpu().double() for t in (leaves, sw)]
                if data_grads else [])
        out[name] = (float(res.elbo.detach()),
                     res.log_likelihood_R.detach().cpu().double(), grads,
                     named, data)
        del res, params, leaves
    _CPU_RUNS[key] = out["cpu f64"]
    kernels.TWIST_BWD_V2 = False
    (e32, llr32, g32, n32, d32), (e64, llr64, g64, n64, d64) = (
        out["cuda f32"], out["cpu f64"])
    rel = abs(e32 - e64) / abs(e64)
    rel_llr = float(((llr32 - llr64).abs() / llr64.abs()).max())
    g32, g64 = torch.cat([g.reshape(-1) for g in g32]), torch.cat(
        [g.reshape(-1) for g in g64])
    rel_g = float((g32 - g64).norm() / g64.norm())
    rel_named = {k: float((n32[k] - n64[k]).norm() / n64[k].norm())
                 for k in n64}
    values = "".join(f"; {k} grad cuda {float(n32[k].reshape(-1)[0]):.6f} "
                     f"cpu {float(n64[k].reshape(-1)[0]):.6f}"
                     for k in n64 if n64[k].numel() == 1)
    rel_named.update({k: rel_l2(a, b) for k, a, b in zip(
        ("dleaves (item 8b)", "dw (item 8b)"), d32, d64)})
    extra = "".join(f"; {k} rel err {v:.3e} (tol 1e-2)"
                    for k, v in rel_named.items())
    via = (f" (reverse pass through "
           f"{route if isinstance(route, str) else ', '.join(route)})"
           if route else "")
    log(f"phase 3 fixed-decision ELBO {label}{via}: cuda f32 {e32:.6f} vs "
        f"cpu f64 {e64:.6f}, rel err {rel:.3e} (tol 1e-3); "
        f"log_likelihood_R max rel err {rel_llr:.3e}; manual-VJP gradient "
        f"rel L2 err {rel_g:.3e} (tol 1e-2){extra}{values}; "
        f"{time.time() - t_start:.1f} s")
    require(rel <= 1e-3, f"fixed-decision ELBO rel error {rel}")
    require(rel_llr <= 1e-3, f"log_likelihood_R rel error {rel_llr}")
    require(rel_g <= 1e-2, f"gradient rel error {rel_g}")
    for k, v in rel_named.items():
        require(v <= 1e-2, f"{k} gradient rel error {v}")
    return out


def chunk_agreement(one, chunked, C, Nd, label):
    """A card run with pair_chunk=C against the one-chunk card run of the
    same sweep (`fixed_decision_check`'s outputs): the ELBO and
    log_likelihood_R to 1e-5 relative and the gradients to 1e-5 relative
    L2 (float32 sums in another order), and exactly the extra launches
    the chunks make: eigh and K11b a chunk of the forward and of the
    re-evaluation, K7 wide a chunk of the reverse pass."""
    (e1, llr1, g1, _, _), (e2, llr2, g2, _, _) = (one["cuda f32"],
                                                  chunked["cuda f32"])
    extra = sum(-(-(n * (n - 1) // 2) // C) - 1 for n in range(Nd, 1, -1))
    want = {"eigh_jacobi": 2 * extra, "pair_loglik_fwd": 2 * extra,
            "pair_ll_bwd_wide": extra}
    got = {k: chunked["launches"].get(k, 0) - one["launches"].get(k, 0)
           for k in want}
    g1, g2 = (torch.cat([g.reshape(-1) for g in gs]) for gs in (g1, g2))
    errs = {"ELBO": abs(e2 - e1) / abs(e1),
            "log_likelihood_R": float(((llr2 - llr1).abs()
                                       / llr1.abs()).max()),
            "gradient rel L2": rel_l2(g2, g1)}
    log(f"phase 3 {label} pair_chunk={C} against one chunk, both on the "
        "card: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol 1e-5); extra launches {got} (want {want})")
    for k, v in errs.items():
        require(v <= 1e-5, f"{label} pair_chunk={C}: {k} {v} > 1e-5")
    require(got == want, f"{label} pair_chunk={C}: extra launches {got}, "
            f"want {want}")


def spectral_float32_probe(dev):
    """Why models.expm.expm_reversible works in float64: GY94's
    transitions (betacorona1's F61 frequencies, initial kappa and omega)
    rebuilt from a float32 eigh and a float32 product on the card,
    against the port's (float64 on the card), at b = 0.01, 0.1, 0.5."""
    from phylo_tpu_torch.models.expm import expm_reversible
    from phylo_tpu_torch.models.substitution import get_model
    from phylo_tpu_torch.train.trainer import _resolve_codon_frequencies

    ds = load("betacorona1", codons=True)
    model = _resolve_codon_frequencies(get_model("gy94", A=ds.A), ds)
    f64 = dict(dtype=torch.float64, device=dev)
    p = model.init_params(**f64)
    Q, pi = model.Q(p), model.stationary(p, **f64)
    b = torch.tensor([0.01, 0.1, 0.5], **f64)
    want = expm_reversible(Q, pi, b)
    Q, pi, b = Q.float(), pi.float(), b.float()
    d = torch.sqrt(pi)
    S = Q * (d[:, None] / d[None, :])
    w, U = torch.linalg.eigh((S + S.T) / 2)
    left = (U * d[:, None]) * torch.exp(w * b[:, None])[:, None, :]
    got = torch.clamp(torch.matmul(left, (U / d[:, None]).T), min=0.0)
    err = (got.double() - want).abs()
    log(f"phase 3 GY94 transitions from a float32 eigh: max abs err "
        f"{float(err.max()):.3e} on entries down to {float(want.min()):.3e};"
        f" {float((err > 1e-2 * want).double().mean()):.1%} of the entries "
        f"more than 1% off (expm_reversible works in float64)")


# ---------------------------------------------------------------- phase 4
# ELBO bands: primate from the port's card runs (-6512 at init, about
# -6457 / -6292 after 2 epochs); DS1 GTR+G4 from a CPU run of the port
# (K=32, b256, seed 0: -9102.1 at init, -8406.5 after 2 epochs); DS1
# VNCSMC GTR+G4 from a CPU run of the port (K=4, M=2, b256, seed 0:
# -8038.8 at init, -7723.7 / -7735.2 after epochs 1 / 2)
VNCSMC_DS1_BAND = (-10500.0, -6500.0)
VNCSMC_PROT_BAND = (-16000.0, -9000.0)
# VNCSMC protein+G4: the reverse passes (a step's 15 ranks) and the
# forwards (the initial eval, each epoch's step and eval sweep, and the
# reverse pass's re-evaluation)
PROT_STEPS = (N_PROT - 1) * 2 * (S_PROT // S_BATCH)
PROT_TWIST_EXACT = {
    "pair_loglik_fwd_blocked": (N_PROT - 1) * (
        1 + 2 * (S_PROT // S_BATCH + 1)) + PROT_STEPS,
    "merge_bwd": PROT_STEPS, "pair_loglik_fwd": 0, "pair_ll_bwd_wide": 0,
    "pair_ll_bwd_t": 0}


def twist_chunks(spec, A_, Nd, S, K_=K_TWIST, M_=M_TWIST):
    """The pair chunks each rank of a VNCSMC sweep of `spec` (A_ states a
    category) on Nd taxa and S sites takes, at the runner's K_TWIST and
    M=10 in float32: `smc.twist.resolve_chunk`'s rule at the default
    chunk budget, a pure function of shapes."""
    from phylo_tpu_torch.models.substitution import get_model
    from phylo_tpu_torch.smc import twist as tw

    model = get_model(spec, A=A_)
    twist = tw.TwistConfig(M=M_)
    out = []
    for n in range(Nd, 1, -1):
        P = n * (n - 1) // 2
        C = tw.resolve_chunk(twist, model, P, K_, model.A, S, 4)
        out.append(-(-P // C))
    return out


def twist_exact(spec, A_, Nd, S_full, blocked, spectral):
    """Exact launches of a VNCSMC path through the runner (the initial
    eval and 2 epochs of S_full // S_BATCH SGD steps and an eval sweep),
    from `twist_chunks`: K11b a pair chunk of every forward sweep and of
    each step's re-evaluation, K7 wide a chunk of each step's reverse
    pass, K11a a rank of each reverse pass; with `spectral`, eigh a
    transition call: a chunk, and a rank's chosen merges, of every
    forward sweep, and a chunk of each re-evaluation plus the prologue's
    one call of each reverse pass.  Returns (counts, the chunks of each
    rank at S_BATCH and S_full)."""
    steps = 2 * (S_full // S_BATCH)
    R_ = Nd - 1
    c_b = twist_chunks(spec, A_, Nd, S_BATCH)
    c_e = twist_chunks(spec, A_, Nd, S_full)
    fwd = "pair_loglik_fwd" + ("_blocked" if blocked else "")
    bwd = "pair_ll_bwd_wide" + ("_blocked" if blocked else "")
    other = "" if blocked else "_blocked"
    exact = {fwd: 3 * sum(c_e) + 2 * steps * sum(c_b),
             bwd: steps * sum(c_b), "merge_bwd": steps * R_,
             "pair_loglik_fwd" + other: 0, "pair_ll_bwd_wide" + other: 0,
             "pair_ll_bwd": 0, "pair_ll_bwd_t": 0,
             "pair_ll_bwd_t_blocked": 0, "fused_merge_loglik": 0}
    if spectral:
        exact["eigh_jacobi"] = (3 * (sum(c_e) + R_)
                                + steps * (2 * sum(c_b) + R_ + 1))
    return exact, (c_b, c_e)


def eigh_calls(S):
    """Launches of the eigh kernel on a spectral path (initial eval + 2
    epochs): one a transition call, two an SGD step (the sweep and the
    manual VJP's recompute) and one an eval sweep."""
    return 1 + 2 * (2 * (S // S_BATCH) + 1)


PATHS = {
    "vcsmc": dict(
        dataset="primate_data", band=(-8000.0, -5500.0),
        train=dict(n_particles=K),
        argv=[f"--n_particles={K}"],
        kernels=("fused_rank_update", "fused_rank_bwd_saved", "expm_fwd",
                 "expm_bwd", "categorical"),
        # 11 ranks of the initial eval and, each epoch, 3 SGD steps and
        # the eval sweep
        exact={"fused_rank_update": R * (1 + 2 * (S_FULL // S_BATCH + 1)),
               "fused_rank_update_blocked": 0}),
    "vncsmc": dict(
        dataset="primate_data", band=(-8000.0, -5500.0),
        train=dict(nested=True, M=M_TWIST, n_particles=K_TWIST),
        argv=["--nested=True", f"--M={M_TWIST}",
              f"--n_particles={K_TWIST}"],
        kernels=("fused_merge_loglik", "pair_loglik_fwd", "pair_ll_bwd",
                 "merge_bwd", "expm_fwd", "expm_bwd", "categorical")),
    "gtr_g4_ds1": dict(
        dataset="hohna_data_1", band=(-10500.0, -7000.0),
        train=dict(n_particles=K, substitution_model="gtr+g4"),
        argv=["--model=gtr+g4", f"--n_particles={K}"],
        kernels=("fused_rank_update_blocked", "fused_rank_bwd_blocked",
                 "expm_fwd", "expm_bwd", "categorical"),
        exact={"fused_rank_update_blocked": (N_DS1 - 1) * (
            1 + 2 * (S_DS1 // S_BATCH + 1)), "fused_rank_update": 0},
        fwd_profile="the former K10 forward design: 11.52 ms over 208 "
                    "launches"),
    # VNCSMC with GTR+G4 on DS1 (the twist scores its candidates through
    # G=4 blocks of 4 states): 7 SGD steps of 256 sites + the 1949-site
    # eval sweep, 26 ranks each, one pair chunk per rank; K11b blocked in
    # every sweep and in the reverse pass's re-evaluation, K7 wide blocked
    # and K11a in each step's reverse pass; no dense twist kernel.  PR 6
    # (dense 16-state twist, NVIDIA H100 80GB HBM3, 700 W): ELBO -7420.570
    # and -7387.625 after epochs 1 and 2, 6.20-8.66 s per epoch; K7 wide
    # 816 ms and K11b 454 ms of a profiled epoch's device time
    "vncsmc_gtr_g4_ds1": dict(
        dataset="hohna_data_1", band=VNCSMC_DS1_BAND,
        train=dict(nested=True, M=M_TWIST, n_particles=K_TWIST,
                   substitution_model="gtr+g4"),
        argv=["--model=gtr+g4", "--nested=True", f"--M={M_TWIST}",
              f"--n_particles={K_TWIST}"],
        kernels=("pair_loglik_fwd_blocked", "pair_ll_bwd_wide_blocked",
                 "merge_bwd", "expm_fwd", "expm_bwd", "categorical"),
        exact={"pair_ll_bwd_wide_blocked": (N_DS1 - 1) * 2 * (
            S_DS1 // S_BATCH),
               "merge_bwd": (N_DS1 - 1) * 2 * (S_DS1 // S_BATCH),
               "pair_loglik_fwd_blocked": (N_DS1 - 1) * (
                   1 + 2 * (S_DS1 // S_BATCH + 1) + 2 * (S_DS1 // S_BATCH)),
               "pair_loglik_fwd": 0, "pair_ll_bwd_wide": 0},
        earlier="PR 6: ELBO -7420.570, -7387.625 after epochs 1, 2; "
                "6.20-8.66 s per epoch",
        # one SGD step (26 ranks) is profiled: the epoch's 562k launches
        # took the profiler's summary 136 s
        profile_step=True,
        twist_profile="an epoch (7 steps + the eval) before: K11b 74.9 ms "
                      "over 390 launches, K7 wide 151.3 ms over 182",
        k4_profile="an epoch before: K4f 11.8 ms, K4b 15.5 ms"),
    # primate VNCSMC again with the T-field backward K11c
    # (PHYLO_TWIST_BWD_V2=1) in place of K7: 3 SGD steps an epoch, 11
    # ranks each; profiled, so that K11c's device time on its path is on
    # record
    "vncsmc_t_field": dict(
        dataset="primate_data", band=(-8000.0, -5500.0),
        bwd_v2=True, train=dict(nested=True, M=M_TWIST, n_particles=K_TWIST),
        argv=["--nested=True", f"--M={M_TWIST}",
              f"--n_particles={K_TWIST}"],
        kernels=("pair_loglik_fwd", "pair_ll_bwd_t", "merge_bwd"),
        exact={"pair_ll_bwd_t": R * 2 * (S_FULL // S_BATCH),
               "pair_ll_bwd": 0}),
    # GY94 on betacorona1's codons: 4 SGD steps of 256 codons (saved
    # children: K9bs) + the 1086-codon eval sweep, 16 ranks each; the
    # transitions are spectral (no expm kernel); exact launch counts of
    # K9f and K9bs (initial eval + 2 epochs)
    "gy94_codon": dict(
        dataset="betacorona1", codons=True, band=(-70000.0, -30000.0),
        train=dict(n_particles=K_CODON, substitution_model="gy94"),
        argv=["--codons=True", f"--n_particles={K_CODON}"],
        kernels=("fused_rank_update_wide", "fused_rank_bwd_saved_wide",
                 "categorical", "eigh_jacobi"),
        exact={"fused_rank_update_wide": (N_CODON - 1) * (1 + 2 * (
            S_CODON // S_BATCH + 1)),
               "fused_rank_bwd_saved_wide": (N_CODON - 1) * 2 * (
            S_CODON // S_BATCH),
               "eigh_jacobi": eigh_calls(S_CODON)}),
    # protein + Gamma4 (80 planes) on the simulated 16 x 500 alignment: an
    # epoch is 1 SGD step of 256 sites (K=256: the children would take
    # 629 MB, over SAVE_CHILDREN_CAP, so K9b blocked) + the 500-site eval
    # sweep, 15 ranks each; transitions by expm_poisson (A = 20 > 8: no
    # expm kernel).  The .dat+F+G4 path at K=64 saves its children (157
    # MB): K9bs blocked, spectral transitions.  Bands from a CPU run of
    # the port (K=32, b256, seed 0): -12823.1 at init, -12950.3 after 2
    # epochs (protein_g4); -12342.8, -12411.7 (.dat+F+G4)
    "protein_g4": dict(
        dataset=PROT_FASTA, band=(-16000.0, -9000.0),
        train=dict(n_particles=K_PROT, gamma_categories=4),
        argv=["--gamma_categories=4", f"--n_particles={K_PROT}"],
        kernels=("fused_rank_update_wide_blocked",
                 "fused_rank_bwd_wide_blocked", "categorical"),
        exact={"fused_rank_update_wide_blocked": (N_PROT - 1) * (1 + 2 * (
            S_PROT // S_BATCH + 1)),
               "fused_rank_bwd_wide_blocked": (N_PROT - 1) * 2 * (
            S_PROT // S_BATCH)}),
    # VNCSMC protein+Gamma4 (the reference's autorun.sh algorithm under
    # the most used protein model) on the simulated 16 x 500 alignment: an
    # epoch is 1 SGD step of 256 sites + the 500-site eval sweep, 15 ranks
    # each, one pair chunk per rank (rank 0: 32 x 120 candidate pairs x M
    # = 10); the twist scores its candidates through G=4 blocks of 20
    # states: K11b blocked (two block groups) in every sweep and in the
    # reverse pass's re-evaluation, K7 wide blocked and K11a (K9bs
    # blocked's body, 80 planes) in each step's reverse pass; transitions
    # by expm_poisson (no expm kernel at 20 states); no dense twist kernel
    "vncsmc_protein_g4": dict(
        dataset=PROT_FASTA, band=VNCSMC_PROT_BAND,
        train=dict(nested=True, M=M_TWIST, n_particles=K_TWIST,
                   gamma_categories=4),
        argv=["--gamma_categories=4", "--nested=True", f"--M={M_TWIST}",
              f"--n_particles={K_TWIST}"],
        kernels=("pair_loglik_fwd_blocked", "pair_ll_bwd_wide_blocked",
                 "merge_bwd", "categorical"),
        exact=PROT_TWIST_EXACT | {"pair_ll_bwd_wide_blocked": PROT_STEPS,
                                  "pair_ll_bwd_t_blocked": 0},
        twist_profile="no earlier design: the card refused this path "
                      "before the block-group forms"),
    # the same with the T-field backward K11c blocked
    # (PHYLO_TWIST_BWD_V2=1) in place of K7 wide blocked; not profiled
    "vncsmc_protein_g4_t_field": dict(
        dataset=PROT_FASTA, band=VNCSMC_PROT_BAND, bwd_v2=True,
        profile=False,
        train=dict(nested=True, M=M_TWIST, n_particles=K_TWIST,
                   gamma_categories=4),
        argv=["--gamma_categories=4", "--nested=True", f"--M={M_TWIST}",
              f"--n_particles={K_TWIST}"],
        kernels=("pair_loglik_fwd_blocked", "pair_ll_bwd_t_blocked",
                 "merge_bwd"),
        exact=PROT_TWIST_EXACT | {"pair_ll_bwd_t_blocked": PROT_STEPS,
                                  "pair_ll_bwd_wide_blocked": 0}),
    # protein + Gamma8 (160 planes: K9f blocked and K9b blocked in one
    # group of 16-site chunks) on the same alignment at K=256: an epoch is
    # 1 SGD step + the eval sweep, 15 ranks each; the children would take
    # 1.26 GB, over SAVE_CHILDREN_CAP, so K9b blocked.  Band from a CPU
    # run of the port (K=32, b256, seed 0): -12823.0 at init, -12931.8 /
    # -12937.7 after epochs 1 / 2
    "protein_g8": dict(
        dataset=PROT_FASTA, band=(-16000.0, -9000.0),
        train=dict(n_particles=K_PROT, gamma_categories=G_GAMMA8),
        argv=[f"--gamma_categories={G_GAMMA8}", f"--n_particles={K_PROT}"],
        kernels=("fused_rank_update_wide_blocked",
                 "fused_rank_bwd_wide_blocked", "categorical"),
        exact={"fused_rank_update_wide_blocked": (N_PROT - 1) * (1 + 2 * (
            S_PROT // S_BATCH + 1)),
               "fused_rank_bwd_wide_blocked": (N_PROT - 1) * 2 * (
            S_PROT // S_BATCH), "fused_rank_bwd_saved_wide_blocked": 0}),
    # VNCSMC protein + Gamma8: the twist over 8 blocks of 20 (K11b blocked
    # in block groups, K7 wide blocked a block a group) and K11a on the
    # chosen merges' 8 blocks of 20 (K9bs blocked's one-group body).  A CPU
    # run of the port (K=4, M=2, b256, seed 0, PHYLO_TWIST_BWD_V2=1):
    # -12458.3 at init, -12216.6 / -12319.4 after epochs 1 / 2
    "vncsmc_protein_g8": dict(
        dataset=PROT_FASTA, band=VNCSMC_PROT_BAND,
        train=dict(nested=True, M=M_TWIST, n_particles=K_TWIST,
                   gamma_categories=G_GAMMA8),
        argv=[f"--gamma_categories={G_GAMMA8}", "--nested=True",
              f"--M={M_TWIST}", f"--n_particles={K_TWIST}"],
        kernels=("pair_loglik_fwd_blocked", "pair_ll_bwd_wide_blocked",
                 "merge_bwd", "categorical"),
        exact=PROT_TWIST_EXACT | {"pair_ll_bwd_wide_blocked": PROT_STEPS,
                                  "pair_ll_bwd_t_blocked": 0},
        twist_profile="no earlier design: the card refused this path "
                      "before the wide rank kernels' block groups"),
    # GY94 + Gamma4 on betacorona1's codons (4 blocks of 61, 244 planes):
    # 4 SGD steps of 256 codons + the 1086-codon eval sweep, 16 ranks
    # each; K9f blocked in one group (174 KB a block), K9b blocked in 2
    # groups of 2 blocks (the children would take 512 MB, over the cap);
    # not profiled.  A CPU run of the port (K=16, b256, seed 0): -55101.1
    # at init, -50097.0 / -50789.8 after epochs 1 / 2
    "gy94_g4": dict(
        dataset="betacorona1", codons=True, band=(-70000.0, -30000.0),
        profile=False,
        train=dict(n_particles=K_CODON, substitution_model="gy94+g4"),
        argv=["--codons=True", "--model=gy94+g4", f"--n_particles={K_CODON}"],
        kernels=("fused_rank_update_wide_blocked",
                 "fused_rank_bwd_wide_blocked", "categorical",
                 "eigh_jacobi"),
        exact={"fused_rank_update_wide_blocked": (N_CODON - 1) * (1 + 2 * (
            S_CODON // S_BATCH + 1)),
               "fused_rank_bwd_wide_blocked": (N_CODON - 1) * 2 * (
            S_CODON // S_BATCH), "fused_rank_bwd_saved_wide_blocked": 0,
               "eigh_jacobi": eigh_calls(S_CODON)}),
    "protein_dat_f_g4": dict(
        dataset=PROT_FASTA, band=(-16000.0, -9000.0), profile=False,
        train=dict(n_particles=K_PROT_SAVED, gamma_categories=4,
                   paml_dat=PROT_DAT, plus_f=True),
        argv=[f"--paml_dat={PROT_DAT}", "--plus_f=True",
              "--gamma_categories=4", f"--n_particles={K_PROT_SAVED}"],
        kernels=("fused_rank_update_wide_blocked",
                 "fused_rank_bwd_saved_wide_blocked", "categorical",
                 "eigh_jacobi"),
        exact={"fused_rank_update_wide_blocked": (N_PROT - 1) * (1 + 2 * (
            S_PROT // S_BATCH + 1)),
               "fused_rank_bwd_saved_wide_blocked": (N_PROT - 1) * 2 * (
            S_PROT // S_BATCH),
               "eigh_jacobi": eigh_calls(S_PROT)}),
    # VNCSMC GY94 on betacorona1's codons (dense 61 states: K11b and K7
    # wide dense, K11a's wide body at 61 on the chosen merges; spectral
    # transitions through the eigh kernel, a call a pair chunk): 4 SGD
    # steps of 256 codons + the 1086-codon eval sweep, 16 ranks each.
    # The pair chunks come from TwistConfig.chunk_budget_mb: rank 0's 136
    # candidate pairs x M = 10 x 32 particles (87,040 float64 transitions
    # of 61 x 61 a call in one chunk, ~2.6 GB a tensor) take 2 chunks.
    # Exact launches from the chunk rule (`twist`: twist_exact's
    # arguments).  Band from a CPU run of the port (K=4, M=2, b256, seed 0,
    # PHYLO_TWIST_BWD_V2=1): -52590.6 at init, -45577.0 / -43766.8 after
    # epochs 1 / 2
    "vncsmc_gy94": dict(
        dataset="betacorona1", codons=True, band=(-70000.0, -30000.0),
        train=dict(nested=True, M=M_TWIST, n_particles=K_TWIST,
                   substitution_model="gy94"),
        argv=["--codons=True", "--nested=True", f"--M={M_TWIST}",
              f"--n_particles={K_TWIST}"],
        kernels=("pair_loglik_fwd", "pair_ll_bwd_wide", "merge_bwd",
                 "categorical", "eigh_jacobi"),
        twist=("gy94", A_CODON, N_CODON, S_CODON, False, True),
        twist_profile="no earlier run: the first twist over a spectral "
                      "model on the card"),
    # VNCSMC GY94+Gamma4 (4 blocks of 61, 244 planes): K11b and K7 wide
    # blocked a block a group, K11a on 4 blocks of 61 (K9bs blocked's
    # body); 4 times GY94's transitions a pair (rank 0 in 5 chunks at 256
    # codons, 6 at 1086); not profiled.  Band from a CPU run of the port
    # (K=4, M=2, b256, seed 0, PHYLO_TWIST_BWD_V2=1): -48401.4 at init,
    # -44881.3 / -43851.1 after epochs 1 / 2
    "vncsmc_gy94_g4": dict(
        dataset="betacorona1", codons=True, band=(-70000.0, -30000.0),
        profile=False,
        train=dict(nested=True, M=M_TWIST, n_particles=K_TWIST,
                   substitution_model="gy94+g4"),
        argv=["--codons=True", "--model=gy94+g4", "--nested=True",
              f"--M={M_TWIST}", f"--n_particles={K_TWIST}"],
        kernels=("pair_loglik_fwd_blocked", "pair_ll_bwd_wide_blocked",
                 "merge_bwd", "categorical", "eigh_jacobi"),
        twist=("gy94+g4", A_CODON, N_CODON, S_CODON, True, True)),
    # VNCSMC .dat+F+Gamma4 on the simulated 16 x 500 alignment (4 blocks
    # of 20, spectral transitions): 1 SGD step + the 500-site eval sweep,
    # 15 ranks each, one pair chunk a rank; not profiled.  Band from a CPU
    # run of the port (K=4, M=2, b256, seed 0, PHYLO_TWIST_BWD_V2=1):
    # -11755.7 at init, -11891.7 / -11809.5 after epochs 1 / 2
    "vncsmc_protein_dat_f_g4": dict(
        dataset=PROT_FASTA, band=VNCSMC_PROT_BAND, profile=False,
        train=dict(nested=True, M=M_TWIST, n_particles=K_TWIST,
                   gamma_categories=4, paml_dat=PROT_DAT, plus_f=True),
        argv=[f"--paml_dat={PROT_DAT}", "--plus_f=True",
              "--gamma_categories=4", "--nested=True", f"--M={M_TWIST}",
              f"--n_particles={K_TWIST}"],
        kernels=("pair_loglik_fwd_blocked", "pair_ll_bwd_wide_blocked",
                 "merge_bwd", "categorical", "eigh_jacobi"),
        twist=(f"{PROT_DAT}+f+g4", A_PROT, N_PROT, S_PROT, True, True)),
    # GY94+Gamma8 VCSMC on betacorona1's codons (8 blocks of 61, 488
    # planes): K9f blocked past one block group, its group body in 4
    # groups of 2 blocks (wide_fwd_group(128, 8, 61, S) = 2 at S = 256 and
    # 1086): that body's first path.  The backward is K9b blocked in
    # groups of 2 blocks: the children would take ~1 GB, over
    # SAVE_CHILDREN_CAP.  4 SGD steps + the eval sweep, 16 ranks each;
    # profiled (the group bodies' device time).  Band from a CPU run of the
    # port (K=16, b256, seed 0): -54002.4 at init, -50143.3 / -50093.7
    # after epochs 1 / 2
    "gy94_g8": dict(
        groups=(G_GY94G8, A_CODON),
        dataset="betacorona1", codons=True, band=(-70000.0, -30000.0),
        train=dict(n_particles=K_CODON, substitution_model="gy94+g8"),
        argv=["--codons=True", "--model=gy94+g8", f"--n_particles={K_CODON}"],
        kernels=("fused_rank_update_wide_blocked",
                 "fused_rank_bwd_wide_blocked", "categorical",
                 "eigh_jacobi"),
        exact={"fused_rank_update_wide_blocked": (N_CODON - 1) * (1 + 2 * (
            S_CODON // S_BATCH + 1)),
               "fused_rank_bwd_wide_blocked": (N_CODON - 1) * 2 * (
            S_CODON // S_BATCH), "fused_rank_bwd_saved_wide_blocked": 0,
               "eigh_jacobi": eigh_calls(S_CODON)}),
}


def main_path(ext, name):
    """Two training epochs of one path through the runner, with the
    launch counters set to 0 just before and read just after."""
    from phylo_tpu_torch.cli import runner
    from phylo_tpu_torch.pruning import kernels
    from phylo_tpu_torch.train.trainer import param_tensors

    path = PATHS[name]
    argv = [f"--dataset={path['dataset']}", f"--batch_size={S_BATCH}"] \
        + path["argv"] + ["--num_epoch=2", "--no_artifacts", "--device=cuda"]
    exact = path.get("exact", {})
    if "twist" in path:
        exact, (c_b, c_e) = twist_exact(*path["twist"])
        log(f"phase 4 {name} pair chunks a rank (smc.twist.resolve_chunk, "
            f"default budget): {c_b} at {S_BATCH} sites, {c_e} at "
            f"{path['twist'][3]}")
    if "groups" in path:
        G_, A_ = path["groups"]
        gbs = [kernels.wide_fwd_group(path["train"]["n_particles"], G_, A_, S)
               for S in (S_BATCH, load(path["dataset"], True).S)]
        require(all(gb < G_ for gb in gbs), f"phase 4 {name}: K9f blocked "
                f"takes {gbs} of {G_} blocks a group: not its group body")
        log(f"phase 4 {name}: K9f blocked's group body, {gbs} blocks a "
            f"group of {G_} at {S_BATCH} and the eval's sites "
            "(kernels.wide_fwd_group)")
    kernels.TWIST_BWD_V2 = path.get("bwd_v2", False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ext.reset_launches()
    res = runner.run(argv)
    torch.cuda.synchronize()
    launches = dict(ext.LAUNCHES)
    kernels.TWIST_BWD_V2 = False
    log(f"phase 4 {name} main path launches: {json.dumps(launches)}")
    peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.max_memory_reserved()
    log(f"phase 4 {name} peak memory: torch.cuda.max_memory_allocated "
        f"{peak} B ({peak / 2 ** 30:.2f} GiB); max_memory_reserved {held} B "
        f"({held / 2 ** 30:.2f} GiB)")
    for kname in path["kernels"]:
        require(launches.get(kname, 0) > 0, f"{kname} never launched")
    for kname, n in exact.items():
        require(launches.get(kname, 0) == n,
                f"{kname} launched {launches.get(kname, 0)} times, not {n}")
    log(f"phase 4 {name} ELBO after each epoch: "
        f"{json.dumps(res.history['elbo'])}")
    elbo = res.elbo
    lo, hi = path["band"]
    require(math.isfinite(elbo) and lo < elbo < hi,
            f"ELBO {elbo} outside the {name} band ({lo}, {hi})")
    for t in param_tensors(res.params):
        g = t.grad
        require(g is not None and bool(torch.isfinite(g).all())
                and bool((g != 0).any()), "a gradient is missing, "
                "non-finite or zero")
    log(f"phase 4 {name}: every gradient finite and non-zero ("
        + ", ".join(f"{grp}.{k}" for grp in ("model", "branches")
                    for k in sorted(res.params[grp])) + ")")
    secs = res.history["epoch_seconds"]
    earlier = f" ({path['earlier']})" if "earlier" in path else ""
    log(f"phase 4 {name} ELBO {elbo:.3f}; seconds per epoch after warm-up "
        f"{secs[-1]:.4f} (epoch 1 incl. warm-up {secs[0]:.4f}){earlier}")
    g = res.graphs
    if g["captured"]:
        steps = load(path["dataset"], path.get("codons", False)).S // S_BATCH
        require(g["replays"] == [steps, steps + 1],
                f"phase 4 {name}: graph replays {g['replays']} an epoch, "
                f"not [{steps}, {steps + 1}]")
    log(f"phase 4 {name} fused epoch: {g['reason']}; graph replays an "
        f"epoch {g['replays']}, capture {g['capture_seconds']:.3f} s")
    return launches


# ---------------------------------------------------------------- phase 5
def profile_epoch(name):
    """A main path under torch.profiler (device activity, with the
    runtime calls that hand the card work), after phase 4 warmed
    everything up: the second epoch of train(num_epoch=2) under the
    default fused_epoch, from its first step to train()'s end (the eval
    sweep and the history included).  Prints its host wall time, the
    summed device time and count of device events, the device's busy
    share, the host dispatches and the graph launches among them, and
    the kernels with the most device time.  The trace is read from its
    raw records (`trace_stats`).  A path with `profile_step` profiles
    one SGD step on the first 256 sites instead: the step graph's second
    replay where the plan captures the path, else an eager step."""
    from torch.profiler import ProfilerActivity, profile

    from phylo_tpu_torch import _ext
    from phylo_tpu_torch.pruning import kernels
    from phylo_tpu_torch.train import TrainConfig
    from phylo_tpu_torch.train.trainer import (
        _FusedEpoch, _optimizer, _sweep_config, capture_plan, init_params,
        param_tensors, sgd_step, step_generator, step_seed,
    )

    path = PATHS[name]
    if path.get("profile_step"):
        ds = load(path["dataset"], path.get("codons", False))
        cfg = TrainConfig(batch_size=S_BATCH, save_artifacts=False,
                          device="cuda", **path["train"])
        model, params = init_params(ds, cfg)
        genome = (model.expand_leaves(ds.genome)
                  if hasattr(model, "expand_leaves") else ds.genome)
        leaves = torch.tensor(genome, dtype=torch.float32, device="cuda")
        opt = _optimizer(cfg, param_tensors(params))
        sweep_cfg = _sweep_config(cfg)
        kernels.TWIST_BWD_V2 = path.get("bwd_v2", False)
        captured = capture_plan(cfg)[0]
        if captured:
            fe = _FusedEpoch(model, params, opt, sweep_cfg, leaves, S_BATCH,
                             torch.device("cuda"))
            idx = torch.arange(S_BATCH, device="cuda")
            for i in (1, 2):            # eager + captured; replayed
                fe.step(step_seed(cfg.seed, 0, i), idx)
            run = lambda: fe.step(step_seed(cfg.seed, 0, 3), idx)  # noqa
            what = "one SGD step, a graph replay"
        else:
            batch = leaves[:, :S_BATCH].contiguous()
            run = lambda: sgd_step(  # noqa: E731
                model, params, opt, sweep_cfg,
                step_generator(cfg.seed, 0, 1, "cuda"), batch)
            what = "one SGD step"
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        t = trace_stats(prof)
        kernels.TWIST_BWD_V2 = False
        if captured:
            fe.release()
    else:
        r = fused_run(_ext, name, True, profiled=True)
        captured = r["res"].graphs["captured"]
        wall_ms = r["profile"]["wall_ms"]
        t1 = time.perf_counter()
        t = r["profile"]["trace"]
        what = "the second epoch of train(num_epoch=2)"
    named = {k: [0.0, 0] for k in ("K11b", "K7 wide", "K7", "K11c", "K8",
                                   "K4f", "K4b", "rank fwd (K1, K10)",
                                   "rank bwd (K2, K3, K10 bwd, K11a A<=8)",
                                   "K9b / K9bs / K11a", "K9f",
                                   "K9b / K9bs groups", "K9f groups",
                                   "K5", "eigh")}
    if t is None:
        log(f"phase 5 {name} profile: wall {wall_ms:.1f} ms; the profiler "
            "recorded no device time (device numbers not measured)")
        return
    for key, ms, n in t["top"]:
        for kname, fn in (("K11b", "pair_ll_fwd_kernel"),
                          ("K7 wide", "pair_ll_bwd_wide_"),
                          ("K7", "pair_ll_bwd_narrow_kernel"),
                          ("K11c", "pair_ll_bwd_t_"),
                          ("K8", "merge_loglik_kernel"),
                          ("K4f", "expm_fwd_kernel"),
                          ("K4b", "expm_bwd_kernel"),
                          ("rank fwd (K1, K10)", RANK_FWD_KERNEL),
                          ("rank bwd (K2, K3, K10 bwd, K11a A<=8)",
                           RANK_BWD_KERNEL),
                          ("K9b / K9bs / K11a", "wide_rank_bwd_kernel"),
                          ("K9f", "wide_rank_fwd_kernel"),
                          ("K9b / K9bs groups",
                           "wide_rank_bwd_group_kernel"),
                          ("K9f groups", "wide_rank_fwd_group_kernel"),
                          ("K5", "categorical_kernel"),
                          ("eigh", "jacobi_eigh_kernel")):
            if fn in key:
                named[kname][0] += ms
                named[kname][1] += n
    log(f"phase 5 {name} profile of {what}: " + json.dumps({
        "wall_ms": wall_ms, "device_kernel_ms": t["device_ms"],
        "device_busy_share": t["device_ms"] / wall_ms,
        "kernel_launches": t["kernels"],
        "host_dispatches": t["dispatches"],
        "graph_launches": t["graph_launches"], "captured": captured,
        "summary_s": time.perf_counter() - t1,
        "top_kernels": [{"name": k[:70], "device_ms": ms, "launches": n}
                        for k, ms, n in t["top"][:10]]}))
    log(f"phase 5 {name} K4 kernels: " + ", ".join(
        f"{k} {named[k][0]:.2f} ms over {named[k][1]} launches"
        for k in ("K4f", "K4b"))
        + f" ({path.get('k4_profile', 'earlier: not recorded')})")
    log(f"phase 5 {name} rank forward (K1, K10): "
        f"{named['rank fwd (K1, K10)'][0]:.3f} ms over "
        f"{named['rank fwd (K1, K10)'][1]} launches"
        + (f" ({path['fwd_profile']})" if "fwd_profile" in path else ""))
    log(f"phase 5 {name} rank backwards, K7, K11c and K8: " + ", ".join(
        f"{k} {named[k][0]:.3f} ms over {named[k][1]} launches"
        for k in ("rank bwd (K2, K3, K10 bwd, K11a A<=8)",
                  "K9b / K9bs / K11a", "K7", "K11c", "K8")))
    log(f"phase 5 {name} K9f, K5 and eigh: " + ", ".join(
        f"{k} {named[k][0]:.2f} ms over {named[k][1]} launches"
        for k in ("K9f", "K9f groups", "K9b / K9bs groups", "K5", "eigh")))
    if "twist_profile" in path:
        twist = {k: named[k] for k in ("K11b", "K7 wide")}
        log(f"phase 5 {name} twist kernels: " + ", ".join(
            f"{k} {ms:.1f} ms over {n} launches"
            for k, (ms, n) in twist.items())
            + f"; together {sum(v[0] for v in twist.values()):.1f} ms "
            f"({path['twist_profile']})")


# ---------------------------------------------------------------- phase 6
# the kernels a no-grad eval sweep of the main path must show in a trace
TRACE_KERNELS = (RANK_FWD_KERNEL, "categorical_kernel")


def same_bits(a, b):
    """Two values (tensors, or a state_dict's nesting of them) equal to
    the bit, wherever each lives."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape
                and a.detach().cpu().numpy().tobytes()
                == b.detach().cpu().numpy().tobytes())
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_bits(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same_bits(x, y) for x, y in zip(a, b)))
    return a == b


def newick_leaves(nwk):
    """(taxon names, branch lengths) of a Newick string with lengths."""
    names = re.findall(r"(?<=[(,])([^(),:;]+)", nwk)
    lengths = [float(x) for x in re.findall(r":([^,();]+)", nwk)]
    return names, lengths


def host_costs(ds, hist, params, tmp):
    """Host seconds, per epoch of the run, of what the trainer does on
    the host besides the steps: the best particle's Newick (its lineage
    alone), JAX's rule (decode all K lineages, then pick), the K jump
    chains, and the checkpoint (torch.save of the history up to that
    epoch, fsync'd), each rerun on that epoch's own arrays; the strings
    must be the run's.  Each timing starts after gc.collect(): a
    collection of the older generations over this script's heap (phase
    5's profiler events) took 10.7 s inside one timing."""
    import gc

    from phylo_tpu_torch.train.checkpoint import save_checkpoint
    from phylo_tpu_torch.train.trainer import (
        TrainConfig, _optimizer, best_newick, param_tensors,
    )
    from phylo_tpu_torch.viz.trees import (
        decode_genealogy, jump_chain_evolution, to_newick,
    )

    opt = _optimizer(TrainConfig(), param_tensors(params))
    out = []
    for e in range(len(hist["elbo"])):
        arrs = [hist[k][e] for k in ("ancestors", "merged_nodes",
                                     "left_branches", "right_branches")]
        lw = hist["log_weights"][e]
        upto = {k: v[:e + 1] for k, v in hist.items()}

        def timed(fn):
            gc.collect()
            t0 = time.perf_counter()
            value = fn()
            return value, time.perf_counter() - t0

        nwk, t_best = timed(lambda: best_newick(ds.taxa, *arrs, lw))
        nwk_all, t_all = timed(lambda: to_newick(ds.taxa, decode_genealogy(
            *arrs)[int(np.argmax(lw[-1]))]))
        chains, t_chains = timed(
            lambda: jump_chain_evolution(ds.taxa, *arrs[:2]))
        path, t_ckpt = timed(lambda: save_checkpoint(
            os.path.join(tmp, "host_costs"), params, opt, e + 1,
            history=upto))
        require(nwk == nwk_all == hist["newick_best"][e],
                f"epoch {e}: the best Newick differs from JAX's rule")
        require(chains == hist["jump_chain_evolution"][e],
                f"epoch {e}: the jump chains differ from the run's")
        out.append({"best_newick_s": t_best, "decode_all_s": t_all,
                    "jump_chains_s": t_chains, "checkpoint_s": t_ckpt,
                    "checkpoint_bytes": os.path.getsize(path)})
    return out


def lifecycle(ext, dev, Kd=K):
    """A training run's life cycle at the main path's width (primate
    VCSMC, K=2048, b256): a run with artifacts and a checkpoint an epoch,
    its epoch_2 restored on the card and on the CPU (the same bits) and
    evaluated again, a resume to 3 epochs, cli.trees on it, train_elastic
    through an injected fault, two seed replicas, the sweep runner, and a
    trace of one eval sweep."""
    import tempfile

    from phylo_tpu_torch.cli import runner, sweep_runner
    from phylo_tpu_torch.cli import trees as trees_cli
    from phylo_tpu_torch.train import TrainConfig, train_elastic
    from phylo_tpu_torch.train.checkpoint import restore_checkpoint
    from phylo_tpu_torch.train.replicas import train_replicas
    from phylo_tpu_torch.train.trainer import (
        _optimizer, _sweep_config, evaluate, init_params, param_tensors,
        step_generator,
    )
    from phylo_tpu_torch.utils.profiling import BlockTimer, device_trace

    dataset = "primate_data"
    ds = load(dataset)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_life_") as tmp:
        base = [f"--dataset={dataset}", f"--n_particles={Kd}",
                f"--batch_size={S_BATCH}", f"--device={dev.type}",
                f"--results_dir={os.path.join(tmp, 'runs')}"]
        # 1. two epochs with artifacts and a checkpoint after each
        ext.reset_launches()
        with BlockTimer("run", sync=dev) as run_t:
            res = runner.run(base + ["--num_epoch=2", "--checkpoint_every=1"])
        launches = dict(ext.LAUNCHES)
        for kname in PATHS["vcsmc"]["kernels"]:
            require(launches.get(kname, 0) > 0,
                    f"phase 6: {kname} never launched")
        ckpt = os.path.join(res.save_dir, "ckpt")
        for e in (1, 2):
            require(os.path.isfile(os.path.join(ckpt, f"epoch_{e}")),
                    f"phase 6: no checkpoint epoch_{e}")
        with open(os.path.join(res.save_dir, "results.p"), "rb") as f:
            rp = pickle.load(f)
        require(len(rp["newick_best"]) == 2, "phase 6: not 2 newick_best")
        for nwk in rp["newick_best"]:
            names, lengths = newick_leaves(nwk)
            require(sorted(names) == sorted(ds.taxa),
                    f"phase 6: {nwk} does not name each taxon once")
            require(len(lengths) == 2 * (ds.N - 1) and all(
                math.isfinite(b) and b > 0 for b in lengths),
                f"phase 6: {nwk} lacks {2 * (ds.N - 1)} finite positive "
                "branch lengths")
        jce = rp["jump_chain_evolution"]
        require(len(jce) == 2 and all(len(c) == Kd for c in jce),
                "phase 6: jump_chain_evolution is not 2 epochs of K chains")
        hist = res.history
        log(f"phase 6 run with artifacts and checkpoints: ELBO "
            f"{json.dumps(hist['elbo'])}; seconds per epoch (steps + eval) "
            f"{json.dumps(hist['epoch_seconds'])}; runner.run wall "
            f"{run_t.seconds:.3f} s; launches {json.dumps(launches)}")
        costs = host_costs(ds, hist, res.params, tmp)
        log("phase 6 host seconds per epoch at K="
            f"{Kd} (best Newick, JAX's decode-all rule, jump chains, "
            f"checkpoint): {json.dumps(costs)}")

        # 2. epoch_2 restored on the card and on the CPU
        saved = torch.load(os.path.join(ckpt, "epoch_2"), map_location="cpu",
                           weights_only=False)
        cfg = TrainConfig(n_particles=Kd, batch_size=S_BATCH,
                          device=dev.type)
        restored = {}
        for where in (dev.type, "cpu"):
            model, params = init_params(ds, cfg, device=where)
            opt = _optimizer(cfg, param_tensors(params))
            epoch, h = restore_checkpoint(ckpt, params, opt)
            require(epoch == 2 and h["elbo"] == hist["elbo"],
                    f"phase 6: restored epoch {epoch} / history on {where}")
            require(same_bits(param_tensors(params),
                              param_tensors(res.params)),
                    f"phase 6: the params restored on {where} are not the "
                    "run's final params to the bit")
            require(same_bits(opt.state_dict(), saved["optimizer"]),
                    f"phase 6: the optimizer state restored on {where} is "
                    "not the saved one to the bit")
            restored[where] = (model, params)
        model, params = restored[dev.type]
        leaves = torch.tensor(ds.genome, dtype=torch.float32, device=dev)
        again = float(evaluate(model, params, _sweep_config(cfg),
                               step_generator(cfg.seed, 1, 0, dev),
                               leaves).elbo)
        require(again == hist["elbo"][1],
                f"phase 6: the restored params' eval gives {again!r}, the "
                f"run's epoch 2 {hist['elbo'][1]!r}")
        log(f"phase 6 epoch_2 restored on {dev.type} and on the CPU: params "
            "and optimizer state the run's to the bit; its eval with the "
            f"(seed, 1, 0) generator repeats epoch 2's ELBO {again!r} to "
            "the bit")

        # 3. resume to 3 epochs, beside an uninterrupted third epoch
        res3 = runner.run(base + ["--num_epoch=3", "--checkpoint_every=1",
                                  f"--resume_from={ckpt}"])
        e3 = res3.history["elbo"]
        require(len(e3) == 3 and e3[:2] == hist["elbo"],
                f"phase 6: resumed ELBOs {e3} do not start with {hist['elbo']}")
        straight = runner.run(base + ["--num_epoch=3", "--no_artifacts"])
        log(f"phase 6 resumed to 3 epochs: third ELBO {e3[2]!r}; an "
            f"uninterrupted run's {straight.history['elbo'][2]!r} (gap "
            f"{e3[2] - straight.history['elbo'][2]:.6g}; its first two "
            f"{json.dumps(straight.history['elbo'][:2])})")

        # 4. the posterior over topologies of the resumed run
        summary = trees_cli.summarize(res3.save_dir, top=5)
        probs = [t["probability"] for t in summary["topologies"]]
        require(probs and all(0.0 < p <= 1.0 for p in probs)
                and sum(probs) <= 1.0 + 1e-6,
                f"phase 6: topology probabilities {probs}")
        require(sorted(newick_leaves(summary["consensus"])[0])
                == sorted(ds.taxa),
                f"phase 6: consensus {summary['consensus']} does not name "
                "each taxon once")
        require(os.path.isfile(summary["nexus"]), "phase 6: no trees.nex")
        log(f"phase 6 cli.trees: top probabilities {json.dumps(probs)}; "
            f"consensus {summary['consensus']}")

        # 5. train_elastic through an injected fault at epoch index 1
        failures = []
        el = train_elastic(ds, TrainConfig(
            n_particles=Kd, batch_size=S_BATCH, num_epoch=2,
            checkpoint_every=1, checkpoint_dir=os.path.join(tmp, "elastic"),
            fault_injection="raise:1", save_artifacts=False, log_every=0,
            device=dev.type), max_restarts=2,
            on_failure=lambda a, e: failures.append(str(e)))
        require(len(el.history["elbo"]) == 2 and len(failures) == 1
                and "injected fault" in failures[0],
                f"phase 6: train_elastic gave {el.history['elbo']} after "
                f"failures {failures}")
        log(f"phase 6 train_elastic: one failure ({failures[0]}), ELBO "
            f"{json.dumps(el.history['elbo'])}")

        # 6. two seed replicas, one epoch
        rep = train_replicas(ds, TrainConfig(
            n_particles=Kd, batch_size=S_BATCH, num_epoch=1,
            save_artifacts=False, log_every=0, device=dev.type), 2)
        re_elbo = rep["history"]["elbo"]
        require(re_elbo.shape == (1, 2) and bool(np.isfinite(re_elbo).all())
                and re_elbo[0, 0] != re_elbo[0, 1],
                f"phase 6: replica ELBOs {re_elbo}")
        log(f"phase 6 train_replicas: ELBO {json.dumps(re_elbo.tolist())}")

        # 7. the sweep runner
        sweep_dir = os.path.join(tmp, "sweep")
        sweep_runner.main([f"--dataset={dataset}", "--K_list=32,64",
                           "--num_epoch=1", f"--device={dev.type}",
                           f"--results_dir={sweep_dir}"])
        with open(os.path.join(sweep_dir, "sweep_summary.json")) as f:
            rows = json.load(f)
        require(len(rows) == 2 and all(
            math.isfinite(r["final_elbo"]) for r in rows),
            f"phase 6: sweep summary {rows}")
        log("phase 6 sweep_runner: " + json.dumps(
            [{k: r[k] for k in ("K", "seed", "final_elbo", "wall_s")}
             for r in rows]))

        # 8. a trace of one eval sweep names K1's and K5's kernels
        trace_dir = os.path.join(tmp, "trace")
        with device_trace(trace_dir, device=dev.type):
            evaluate(model, params, _sweep_config(cfg),
                     step_generator(cfg.seed, 1, 0, dev), leaves)
        with open(os.path.join(trace_dir, "trace.json")) as f:
            text = f.read()
        for kname in TRACE_KERNELS:
            require(kname in text, f"phase 6: the trace names no {kname}")
        log(f"phase 6 device_trace of one eval sweep: {len(text)} bytes, "
            f"names {', '.join(TRACE_KERNELS)}")


# ---------------------------------------------------------------- phase 7
# the tree tools: what each part must launch (counters set to 0 before
# each CLI run and read after), and what a trace of a short rerun of
# their device work must name
TREE_KERNELS = {
    "a": ("expm_fwd", "expm_bwd"),
    "b": ("expm_fwd", "expm_bwd"),
    "c": ("fused_rank_update_blocked", "fused_rank_bwd_blocked",
          "expm_fwd", "expm_bwd"),
    "d": ("fused_rank_update", "categorical"),
}
TREE_TRACE_KERNELS = (RANK_FWD_KERNEL, RANK_BWD_KERNEL, "expm_fwd_kernel",
                      "expm_bwd_kernel", "categorical_kernel")
# (c)'s SPR chunk rescored on the CPU in float64: this many of its
# candidates, evenly spaced (each particle of an injected sweep is scored
# alone, so a subset has the same scores)
CPU_CANDIDATES = 64


def run_cli(ext, dev, label, main_fn, argv):
    """One CLI's main(argv) with the launch counters set to 0 just before
    and read just after; its standard output kept.  Returns (its return
    value, its output, launches, wall seconds)."""
    import io

    torch.cuda.synchronize()
    ext.reset_launches()
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        ret = main_fn(argv + [f"--device={dev.type}"])
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(ext.LAUNCHES)
    for kname in TREE_KERNELS.get(label, ()):
        require(launches.get(kname, 0) > 0,
                f"phase 7 ({label}): {kname} never launched")
    log(f"phase 7 ({label}) {secs:.2f} s wall, launches "
        f"{json.dumps(launches)}")
    return ret, out.getvalue(), launches, secs


def rel_gap(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def tree_tools(ext, dev, Kd=K):
    """The tree tools through their CLIs at full width: (a) model
    selection over the 12-model DNA ladder on primate's NJ tree, (b)
    scoring with branch refits and ancestral states under the winner's
    tree, (c) the SPR search with branch refits on DS1 GTR+G4 (N=27,
    S=1949; its 2,600-candidate neighbourhood in K=2048 chunks: K10
    forward, K3 blocked backward), (d) bootstrap at K=2048 and (e) the
    CSMC oracle; the card held to the CPU at the checks listed in each
    step.  Returns {kernel: launches} over (a)-(e)."""
    import tempfile

    from phylo_tpu_torch.cli import bootstrap as boot_cli
    from phylo_tpu_torch.cli import csmc as csmc_cli
    from phylo_tpu_torch.cli import model_select as select_cli
    from phylo_tpu_torch.cli import score_tree as score_cli
    from phylo_tpu_torch.models.substitution import get_model
    from phylo_tpu_torch.pruning.fixed_tree import (
        parse_newick, tree_log_likelihood,
    )
    from phylo_tpu_torch.search import (
        jc_distance_matrix, neighbor_joining, records_to_decisions,
        spr_neighbors, tree_log_likelihoods_batch,
    )
    from phylo_tpu_torch.smc.csmc import CSMC
    from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies
    from phylo_tpu_torch.utils.profiling import device_trace
    from phylo_tpu_torch.viz.trees import to_newick

    cpu = torch.device("cpu")
    total = {}
    secs = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    def as_leaves(genome, d, dtype):
        return torch.as_tensor(np.asarray(genome), device=d).to(dtype)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tree_") as tmp:
        # (a) model selection on primate's NJ tree; first its GTR score at
        # the initial parameters, card float32 against CPU float64
        ds = load("primate")
        nj = neighbor_joining(jc_distance_matrix(ds.genome))
        gtr = get_model("gtr")
        ll = {}
        for d, dtype in ((dev, torch.float32), (cpu, torch.float64)):
            with torch.no_grad():
                ll[d.type] = tree_log_likelihood(
                    as_leaves(ds.genome, d, dtype), gtr,
                    {"model": gtr.init_params(dtype, d)}, nj).item()
        gap = rel_gap(ll[dev.type], ll["cpu"])
        require(gap < 1e-5, f"phase 7 (a): the NJ tree's GTR score "
                f"{ll[dev.type]!r} on the card against {ll['cpu']!r}")
        log(f"phase 7 (a) primate NJ tree under GTR at the initial "
            f"parameters: cuda f32 {ll[dev.type]:.6f} vs cpu f64 "
            f"{ll['cpu']:.6f} (rel {gap:.2e}, bound 1e-5)")
        best_nwk = os.path.join(tmp, "best.nwk")
        best, out, launches, secs["a"] = run_cli(
            ext, dev, "a", select_cli.main,
            ["--dataset=primate", "--steps=100", f"--out={best_nwk}"])
        add(launches)
        ranking = [line.split()[0] for line in out.splitlines()
                   if line.split() and line.split()[0] in (
                       "jc69", "hky", "gtr", "jc69+g4", "hky+g4",
                       "gtr+g4", "jc69+i", "hky+i", "gtr+i", "jc69+g4+i",
                       "hky+g4+i", "gtr+g4+i")]
        require(len(ranking) == 24 and ranking[12] == best,
                f"phase 7 (a): the ranking table {ranking}")
        log(f"phase 7 (a) model_select over the 12-model ladder, 100 Adam "
            f"steps each: best {best}; BIC order {ranking[12:]}")

        # (b) the winner's tree under GTR: branch refits and ancestral
        # states
        fasta = os.path.join(tmp, "anc.fasta")
        ll_b, out, launches, secs["b"] = run_cli(
            ext, dev, "b", score_cli.main,
            ["--dataset=primate", "--model=gtr", f"--newick={best_nwk}",
             "--optimize_branches", f"--ancestral={fasta}"])
        add(launches)
        with open(fasta) as f:
            recs = f.read().split(">")[1:]
        require(math.isfinite(ll_b) and len(recs) == 2 * ds.N - 1
                and all(len(r.split()[1]) == ds.S
                        and set(r.split()[1]) <= set("ACGT") for r in recs),
                f"phase 7 (b): log-likelihood {ll_b}, {len(recs)} "
                "ancestral sequences")
        log(f"phase 7 (b) score_tree --optimize_branches --ancestral: "
            f"log-likelihood {ll_b:.4f}; {len(recs)} sequences of "
            f"{ds.S} states")

        # (c) the SPR search on DS1 GTR+G4 from the NJ tree; first one
        # K=2048 chunk's scores, card float32 against CPU float64
        ds1 = load("DS1")
        nj1 = neighbor_joining(jc_distance_matrix(ds1.genome))
        nj_nwk = os.path.join(tmp, "ds1_nj.nwk")
        with open(nj_nwk, "w") as f:
            f.write(to_newick(list(ds1.taxa), nj1) + "\n")
        _, nj1 = parse_newick(open(nj_nwk).read(), taxa=list(ds1.taxa))
        g4 = get_model("gtr+g4")
        genome1 = g4.expand_leaves(ds1.genome)
        nbrs = spr_neighbors(nj1, ds1.N)
        chunk = [nj1] + nbrs[:Kd - 1]
        leaves1 = as_leaves(genome1, dev, torch.float32)
        with torch.no_grad():
            card = tree_log_likelihoods_batch(
                leaves1, g4, {"model": g4.init_params(torch.float32, dev)},
                chunk).cpu().numpy()
        pick = np.linspace(0, Kd - 1, CPU_CANDIDATES).astype(int)
        with torch.no_grad():
            host = tree_log_likelihoods_batch(
                as_leaves(genome1, cpu, torch.float64), g4,
                {"model": g4.init_params(torch.float64, cpu)},
                [chunk[i] for i in pick]).numpy()
        gaps = np.abs(card[pick] - host) / np.abs(host)
        require(np.isfinite(card).all() and gaps.max() < 1e-5,
                f"phase 7 (c): chunk scores off the CPU's by up to "
                f"{gaps.max():.2e}")
        log(f"phase 7 (c) DS1 GTR+G4 SPR neighbourhood of the NJ tree: "
            f"{len(nbrs)} candidates; one chunk of {Kd} scored on the card, "
            f"{CPU_CANDIDATES} of them against cpu f64: max rel "
            f"{gaps.max():.2e} (bound 1e-5); NJ tree {card[0]:.4f}")
        with torch.no_grad():
            start = tree_log_likelihood(
                leaves1, g4, {"model": g4.init_params(torch.float32, dev)},
                nj1).item()
        scored, out, launches, secs["c"] = run_cli(
            ext, dev, "c", score_cli.main,
            ["--dataset=DS1", "--model=gtr+g4", f"--newick={nj_nwk}",
             "--spr", "--nni_branch_steps=5", "--nni_iters=2",
             f"--search_chunk={Kd}"])
        add(launches)
        iters = [line for line in out.splitlines()
                 if line.startswith("SPR iter")]
        first = float(re.search(r"current ll (\S+),", iters[0]).group(1))
        final = float(re.search(r"SPR search: .* log-likelihood (\S+)",
                                out).group(1))
        require(math.isfinite(scored) and final >= first,
                f"phase 7 (c): the search ends at {final}, below its "
                f"starting tree's {first}")
        log(f"phase 7 (c) score_tree --spr --nni_branch_steps=5 "
            f"--nni_iters=2: {'; '.join(iters)}; the search's "
            f"log-likelihood {final:.4f} from {first:.4f} (the NJ tree "
            f"refitted; {start:.4f} at its NJ lengths); the final tree "
            f"scored by fixed-tree pruning {scored:.4f}")

        # (d) bootstrap supports at K=2048
        res, out, launches, secs["d"] = run_cli(
            ext, dev, "d", boot_cli.main,
            ["--dataset=primate", "--model=jc69", f"--n_particles={Kd}",
             "--n_replicates=10"])
        add(launches)
        names, _ = newick_leaves(res.consensus)
        require(all(0.0 <= v <= 1.0 + 1e-9 for v in res.supports.values())
                and sorted(names) == sorted(ds.taxa),
                f"phase 7 (d): supports {sorted(res.supports.values())}, "
                f"consensus {res.consensus}")
        log(f"phase 7 (d) bootstrap, 10 replicates at K={Kd}: mean ELBO "
            f"{res.elbos.mean():.3f}; consensus {res.consensus}")

        # (e) the CSMC oracle, on the card and on the CPU at one seed
        out_e, _, launches, secs["e"] = run_cli(
            ext, dev, "e", csmc_cli.main,
            ["--dataset=primate", "--n_particles=64", "--resampling=true"])
        add(launches)
        host = CSMC({"taxa": ds.taxa, "genome": ds.genome},
                    device="cpu").sample_phylogenies(64, resampling=True)
        same = (np.array_equal(out_e["merged_nodes"], host["merged_nodes"])
                and np.array_equal(out_e["ancestors"], host["ancestors"]))
        norm_ok = (out_e["norm"] == host["norm"]
                   or rel_gap(out_e["norm"], host["norm"]) < 1e-10)
        lw_gap = float(np.max(np.abs(out_e["log_weights"]
                                     - host["log_weights"])))
        lw_ok = lw_gap <= 1e-10 * float(np.max(np.abs(host["log_weights"])))
        require(same and norm_ok and lw_ok, f"phase 7 (e): CSMC on the "
                f"card: same draws {same}, norm {out_e['norm']!r} against "
                f"{host['norm']!r}, log weights {lw_gap:.2e} apart")
        log(f"phase 7 (e) csmc K=64 with resampling: merged_nodes and "
            f"ancestors the CPU run's; norm {out_e['norm']!r} (cpu "
            f"{host['norm']!r}); log weights max abs gap {lw_gap:.2e}")

        # a trace of a short rerun of the tools' device work: one refit
        # step of a 256-candidate chunk on DS1, one GTR fit step on
        # primate, one bootstrap replicate's sweep
        trace_dir = os.path.join(tmp, "trace")
        with device_trace(trace_dir, device=dev.type):
            refit = chunk[:256]
            dec = records_to_decisions(refit, ds1.N, dtype=torch.float32,
                                       device=dev)
            for k in ("branches_l", "branches_r"):
                dec[k].requires_grad_(True)
            params = {"model": g4.init_params(torch.float32, dev),
                      "branches": {
                          "log_rates_l": torch.zeros(ds1.N - 1, device=dev),
                          "log_rates_r": torch.zeros(ds1.N - 1, device=dev)}}
            sample_phylogenies(
                None, leaves1, g4, params, SweepConfig(K=len(refit)),
                decisions=dec).log_likelihood_R.sum().backward()
            gp = {"model": {k: t.requires_grad_(True) for k, t in
                            gtr.init_params(torch.float32, dev).items()}}
            tree_log_likelihood(as_leaves(ds.genome, dev, torch.float32),
                                gtr, gp, nj).backward()
            jc = get_model("jc69")
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            with torch.no_grad():
                sample_phylogenies(
                    gen, as_leaves(ds.genome, dev, torch.float32), jc,
                    {"model": {}, "branches": {
                        "log_rates_l": torch.zeros(ds.N - 1, device=dev),
                        "log_rates_r": torch.zeros(ds.N - 1, device=dev)}},
                    SweepConfig(K=Kd))
        with open(os.path.join(trace_dir, "trace.json")) as f:
            text = f.read()
        for kname in TREE_TRACE_KERNELS:
            require(kname in text, f"phase 7: the trace names no {kname}")
        log(f"phase 7 device_trace of a refit step, a fit step and a "
            f"bootstrap sweep: {len(text)} bytes, names "
            f"{', '.join(TREE_TRACE_KERNELS)}")
    log("phase 7 wall seconds: " + json.dumps(
        {k: round(v, 2) for k, v in secs.items()}))
    return total


# ---------------------------------------------------------------- phase 8
# the mesh on the one card: NCCL at world size 1 in this process, and two
# ranks sharing the card over gloo (NCCL refuses a duplicate GPU) in
# child processes of this script (`--mesh-child`)
MESH_TRACE_KERNELS = (RANK_FWD_KERNEL, RANK_BWD_KERNEL)
DS1_G4 = dict(spec="gtr+g4", dataset="hohna_data_1")
# (b): DS1 GTR+G4 over all 1949 sites, K=128 (phase 3's shape: its CPU
# float64 run; the CPU's at K=2048 would hold a 13 GB buffer) and the
# main path's K=2048; (d) primate VNCSMC; (c) primate VCSMC at all 898
# sites; K=2048 on a 'k' mesh
MESH_PARTS = {
    "s": [("b K=128", dict(DS1_G4, Kd=128, data_grads=True)),
          ("b K=2048", dict(DS1_G4, Kd=K)),
          ("d", dict(twist=True))],
    # (e): primate VNCSMC K=32 on the 'k' mesh, twice: the roots'
    # cotangents summed in a fixed order (smc.twist.add_cols)
    "k": [("c", dict()), ("e", dict(twist=True)),
          ("e again", dict(twist=True))],
}
MESH_TRAIN = dict(n_particles=K, batch_size=S_BATCH, num_epoch=1,
                  substitution_model="gtr+g4", save_artifacts=False,
                  collect_trees=False, log_every=0)


def _reset_counts():
    from phylo_tpu_torch import _ext
    from phylo_tpu_torch.parallel import collectives

    torch.cuda.synchronize()
    _ext.reset_launches()
    collectives.reset_counts()


def _counts():
    from phylo_tpu_torch import _ext
    from phylo_tpu_torch.parallel import collectives

    torch.cuda.synchronize()
    return dict(launches=dict(_ext.LAUNCHES),
                calls=dict(collectives.CALLS),
                bytes=dict(collectives.BYTES))


def mesh_sweep(dev, sh, kw, seed=None):
    """One float32 sweep of fixed_inputs(**kw) on this rank's block of
    the mesh `sh` (None: one rank) with the manual VJP's gradient, or,
    given `seed`, no decisions and no gradient.  Returns the ELBO, the
    flat gradient, the counts and the wall seconds."""
    from phylo_tpu_torch.parallel import pad_sites, shard_leaves
    from phylo_tpu_torch.params import params_from_numpy
    from phylo_tpu_torch.smc.sweep import sample_phylogenies
    from phylo_tpu_torch.train.trainer import param_tensors

    f32 = torch.float32
    model, genome, tree, dec, cfg, label, w = fixed_inputs(**kw)
    if sh is not None:
        padded, w_pad = pad_sites(genome, sh.site_multiple(), w)
        if w is not None or padded.shape[1] != genome.shape[1]:
            w = w_pad[sh.sites(len(w_pad))]
        genome = shard_leaves(padded, sh)
    grad = seed is None
    params = params_from_numpy(tree, dtype=f32, device=dev,
                               requires_grad=grad)
    leaves = torch.tensor(genome, dtype=f32, device=dev)
    sw = None if w is None else torch.tensor(w, dtype=f32, device=dev)
    gen, d = None, None
    if grad:
        d = {k: torch.as_tensor(v, device=dev) for k, v in dec.items()}
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    _reset_counts()
    t = time.time()
    with torch.set_grad_enabled(grad):
        res = sample_phylogenies(gen, leaves, model, params, cfg,
                                 decisions=d, site_weights=sw, shardings=sh)
        if grad:
            res.elbo.backward()
    secs = time.time() - t
    out = dict(label=label, elbo=float(res.elbo.detach()), seconds=secs,
               **_counts())
    if grad:
        out["grad"] = torch.cat([t_.grad.detach().reshape(-1).double().cpu()
                                 for t_ in param_tensors(params)])
    return out


def mesh_child(argv):
    """A rank of a two-rank mesh on the one card over gloo: runs the
    parts of MESH_PARTS[axis] and pickles what it measured."""
    axis, rank, world, port, out_path = (argv[0], int(argv[1]),
                                         int(argv[2]), int(argv[3]), argv[4])
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from phylo_tpu_torch.parallel import (
        initialize_distributed, make_mesh, sweep_sharding,
    )

    from phylo_tpu_torch.device import resolve_device

    initialize_distributed(f"localhost:{port}", world, rank, backend="gloo")
    dev = resolve_device("cuda")
    names = ("s",) if axis == "s" else ("k",)
    sh = sweep_sharding(make_mesh((world,), names))
    out = {}
    for name, kw in MESH_PARTS[axis]:
        out[name] = mesh_sweep(dev, sh, kw)
    if axis == "k":
        # K5 on the gathered log weights: a seeded sweep, no decisions
        out["c seeded"] = mesh_sweep(dev, sh, dict(S=S_BATCH), seed=3)
    else:
        out["b train"] = mesh_train(dev, sh, rank)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def mesh_train(dev, sh, rank):
    """(b)'s seeded training epoch on DS1 GTR+G4 K=2048 b256 over the
    mesh, then a traced SGD step; returns the ELBOs, the parameters' bits
    and, on rank 0, the kernels the trace names."""
    from phylo_tpu_torch.train import TrainConfig, train
    from phylo_tpu_torch.train.trainer import (
        _optimizer, _sweep_config, init_params, param_tensors, sgd_step,
        step_generator,
    )
    from phylo_tpu_torch.utils.profiling import device_trace

    ds = load("hohna_data_1")
    _reset_counts()
    t = time.time()
    res = train(ds, TrainConfig(mesh_shape=(sh.s,), device="cuda",
                                **MESH_TRAIN))
    out = dict(elbo=list(res.history["elbo"]), seconds=time.time() - t,
               params=torch.cat([t_.detach().reshape(-1).cpu() for t_ in
                                 param_tensors(res.params)]), **_counts())
    config = TrainConfig(device="cuda", **MESH_TRAIN)
    model, params = init_params(ds, config, device=dev)
    leaves = torch.tensor(model.expand_leaves(ds.genome), dtype=torch.float32,
                          device=dev)[:, :S_BATCH]
    opt = _optimizer(config, param_tensors(params))
    step = lambda: sgd_step(model, params, opt, _sweep_config(config),  # noqa
                            step_generator(0, 0, 1, dev), leaves,
                            shardings=sh)
    step()
    trace_dir = os.path.join(PROT_DIR, f"mesh_trace_{rank}")
    with device_trace(trace_dir, device="cuda"):
        step()
    with open(os.path.join(trace_dir, "trace.json")) as f:
        text = f.read()
    out["trace"] = [k for k in MESH_TRACE_KERNELS if k in text]
    return out


def _spawn_mesh(axis, world, tmp):
    """Starts the ranks of a two-rank mesh; their output goes to a log
    file each (a pipe left unread could stall a rank)."""
    here = os.path.abspath(__file__)
    port = free_port()
    procs = []
    for rank in range(world):
        base = os.path.join(tmp, f"{axis}_{rank}")
        with open(base + ".log", "w") as logf:
            procs.append((subprocess.Popen(
                [sys.executable, here, "--mesh-child", axis, str(rank),
                 str(world), str(port), base + ".p"],
                stdout=logf, stderr=subprocess.STDOUT), base))
    return procs


def free_port():
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _collect(axis, procs):
    """Every rank's results; a rank that failed fails the script (the
    other ranks are stopped)."""
    out = []
    for rank, (p, base) in enumerate(procs):
        try:
            p.wait(timeout=600)
        finally:
            if p.returncode != 0:
                for q, _ in procs:
                    q.kill()
                    q.wait()
        if p.returncode != 0:
            with open(base + ".log") as f:
                log(f.read()[-6000:])
            require(False, f"phase 8 ('{axis}',) mesh rank {rank} exited "
                    f"{p.returncode}")
        with open(base + ".p", "rb") as f:
            out.append(pickle.load(f))
    return out


def _mesh_line(part, rank, r, card, over="a sweep"):
    calls = ", ".join(f"{k} {v} calls / {r['bytes'].get(k, 0)} B"
                      for k, v in sorted(r["calls"].items()))
    log(f"phase 8 {part} rank {rank}: {r['seconds']:.3f} s wall ({card}); "
        f"launches {json.dumps(r['launches'])}; collectives {over}: "
        f"{calls or 'none'}")


def _hold(part, got, want_elbo, want_grad, against):
    rel = abs(got["elbo"] - want_elbo) / abs(want_elbo)
    rel_g = rel_l2(got["grad"], want_grad)
    log(f"phase 8 {part} {got['label']}: ELBO {got['elbo']:.6f} vs "
        f"{against} {want_elbo:.6f}, rel err {rel:.3e} (tol 1e-3); "
        f"manual-VJP gradient rel L2 err {rel_g:.3e} (tol 1e-2)")
    require(rel <= 1e-3, f"phase 8 {part} ELBO rel error {rel}")
    require(rel_g <= 1e-2, f"phase 8 {part} gradient rel error {rel_g}")
    return rel, rel_g


def mesh_world_of_one(ext):
    """(a): primate VCSMC K=2048 b256 for 2 epochs through the runner with
    --mesh=1 (a world of one, NCCL) and without: the same ELBOs and
    parameters, bit for bit; the all-reduces are called all the same."""
    import torch.distributed as dist

    from phylo_tpu_torch.cli import runner
    from phylo_tpu_torch.train.trainer import param_tensors

    argv = ["--dataset=primate_data", f"--batch_size={S_BATCH}",
            f"--n_particles={K}", "--num_epoch=2", "--no_artifacts",
            "--device=cuda"]
    runs = {}
    for mesh in ("", "--mesh=1"):
        _reset_counts()
        t = time.time()
        res = runner.run(argv + ([mesh] if mesh else []))
        runs[mesh] = (res, time.time() - t, _counts())
    (a, _, ca), (b, secs, cb) = runs[""], runs["--mesh=1"]
    require(dist.get_backend() == "nccl", "the world of one is not NCCL")
    dist.destroy_process_group()
    require(a.history["elbo"] == b.history["elbo"],
            f"--mesh=1 ELBOs {b.history['elbo']} != {a.history['elbo']}")
    for x, y in zip(param_tensors(a.params), param_tensors(b.params)):
        require(torch.equal(x, y), "--mesh=1 parameters differ")
    require(cb["calls"].get("all_reduce", 0) > 0, "--mesh=1 called no "
            "all_reduce")
    require(ca["launches"] == cb["launches"], "--mesh=1 launched "
            f"{cb['launches']}, not {ca['launches']}")
    log(f"phase 8 (a) --mesh=1 (NCCL, world of one): ELBOs "
        f"{json.dumps(b.history['elbo'])}, bit-identical to the run "
        f"without a mesh, parameters too; {secs:.2f} s for 2 epochs; "
        f"collectives over the run: {json.dumps(cb['calls'])} calls, "
        f"{json.dumps(cb['bytes'])} B; launches {json.dumps(cb['launches'])}")
    return cb["launches"]


def mesh_phase(ext, dev, card):
    """Phase 8; returns its launches (every rank's) by kernel."""
    import tempfile

    t0 = time.time()
    launches = dict(mesh_world_of_one(ext))
    tmp = tempfile.mkdtemp(prefix="mesh_", dir=PROT_DIR)
    procs = {axis: _spawn_mesh(axis, 2, tmp) for axis in ("s", "k")}
    try:
        # meanwhile: the one-rank card run of (b) at K=2048, and phase
        # 3's CPU float64 runs (cached) for the rest
        one = mesh_sweep(dev, None, dict(DS1_G4, Kd=K))
        ranks = {axis: _collect(axis, ps) for axis, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p, _ in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    twist_cpu = _CPU_RUNS[(True, None, "primate", K, None, False, None,
                           True, False, False)]
    cpu = {"b K=128": _CPU_RUNS[(False, "gtr+g4", "hohna_data_1", 128, None,
                                 False, None, True, False, True)],
           "d": twist_cpu, "e": twist_cpu, "e again": twist_cpu,
           "c": _CPU_RUNS[(False, None, "primate", K, None, False, None,
                           True, False, False)]}
    need = {"b K=128": ("fused_rank_update_blocked",
                        "fused_rank_bwd_blocked"),
            "b K=2048": ("fused_rank_update_blocked",
                         "fused_rank_bwd_blocked"),
            "d": ("pair_loglik_fwd", "pair_ll_bwd", "merge_bwd",
                  "fused_merge_loglik"),
            "e": ("pair_loglik_fwd", "pair_ll_bwd", "merge_bwd",
                  "fused_merge_loglik"),
            "e again": ("pair_loglik_fwd", "pair_ll_bwd", "merge_bwd",
                        "fused_merge_loglik"),
            "c": ("fused_merge_loglik", "merge_bwd", "expm_fwd",
                  "expm_bwd"),
            "c seeded": ("fused_merge_loglik", "expm_fwd", "categorical"),
            "b train": ("fused_rank_update_blocked",
                        "fused_rank_bwd_blocked", "expm_fwd", "expm_bwd",
                        "categorical")}
    for axis, rs in ranks.items():
        for part in rs[0]:
            for rank, r in enumerate(rs):
                got = r[part]
                _mesh_line(f"({part}) ('{axis}',) 2", rank, got, card,
                           "over the run" if part == "b train"
                           else "a sweep")
                for kname in need[part]:
                    require(got["launches"].get(kname, 0) > 0,
                            f"phase 8 ({part}) rank {rank} launched no "
                            f"{kname}")
                for kname, n in got["launches"].items():
                    launches[kname] = launches.get(kname, 0) + n
                if part in cpu:
                    c = cpu[part]
                    _hold(f"({part}) rank {rank}", got, c[0],
                          torch.cat([g.reshape(-1) for g in c[2]]),
                          "cpu f64 one process")
                if part == "b K=2048":
                    _hold(f"({part}) rank {rank}", got, one["elbo"],
                          one["grad"], "the one-rank card run")
            require(rs[0][part]["elbo"] == rs[1][part]["elbo"],
                    f"phase 8 ({part}): the ranks' ELBOs differ")
            if "grad" in rs[0][part]:
                require(torch.equal(rs[0][part]["grad"], rs[1][part]["grad"])
                        and rs[0][part]["elbo"] == rs[1][part]["elbo"],
                        f"phase 8 ({part}): the ranks' results differ")
    for rank, r in enumerate(ranks["k"]):
        same = (r["e"]["elbo"] == r["e again"]["elbo"]
                and torch.equal(r["e"]["grad"], r["e again"]["grad"]))
        require(same, f"phase 8 (e) rank {rank}: the 'k' mesh's twist sweep "
                "gave other bits the second time")
    log(f"phase 8 (e) ('k',) 2 {ranks['k'][0]['e']['label']}, twice: ELBO "
        f"{ranks['k'][0]['e']['elbo']!r} and every gradient the same bits "
        "in both runs on both ranks (the roots' cotangents summed in a "
        "fixed order)")
    log(f"phase 8 (b) one-rank card run {one['label']}: ELBO "
        f"{one['elbo']:.6f}, {one['seconds']:.3f} s ({card}); launches "
        f"{json.dumps(one['launches'])}")
    tr = [r["b train"] for r in ranks["s"]]
    for rank, r in enumerate(tr):
        require(all(math.isfinite(e) and -10500 < e < -7000
                    for e in r["elbo"]),
                f"phase 8 (b) rank {rank} training ELBO {r['elbo']}")
    require(torch.equal(tr[0]["params"], tr[1]["params"]),
            "phase 8 (b): the parameters differ across ranks")
    require(tr[0]["elbo"] == tr[1]["elbo"], "phase 8 (b): the ranks' ELBOs "
            "differ")
    require(tr[0]["trace"] == list(MESH_TRACE_KERNELS),
            f"phase 8 (b): rank 0's trace names {tr[0]['trace']}, not "
            f"{MESH_TRACE_KERNELS}")
    log(f"phase 8 (b) training epoch on the ('s',) 2 mesh: ELBO "
        f"{tr[0]['elbo']} on both ranks, parameters bit-identical across "
        f"ranks; rank 0's trace of an SGD step names "
        f"{', '.join(tr[0]['trace'])}")
    log(f"phase 8 done in {time.time() - t0:.1f} s ({card}); ranks that "
        "share the card give counts, not scaling")
    return launches


# ---------------------------------------------------------------- phase 9
# the fused epoch, fused_epoch=False against True; the spectral paths
# (captured since their eigengap is decided on the device) held to the bit
# and the new VNCSMC spectral paths but GY94+G4 (its 4 runs would take
# ~260 s): VNCSMC GY94 and .dat+F+G4
PHASE9_SPECTRAL = ("gy94_codon", "gy94_g4", "protein_dat_f_g4",
                   "vncsmc_gy94", "vncsmc_protein_dat_f_g4")
PHASE9 = ("vcsmc", "vncsmc", "gtr_g4_ds1",
          "vncsmc_protein_g4") + PHASE9_SPECTRAL
# runtime calls that hand the card work, as the trace names them
DISPATCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                     "cuGraphLaunch", "cudaMemcpy", "cuMemcpy",
                     "cudaMemset", "cuMemset")


@contextlib.contextmanager
def second_epoch_profile(out):
    """Profiles (device activity only) the second epoch of the train()
    run inside the block: from its second site_batches call (the epoch's
    start) to the end of train().  Fills out["wall_ms"] (host clock,
    ending in torch.cuda.synchronize()) and out["trace"]
    (`trace_stats`)."""
    from torch.profiler import ProfilerActivity, profile

    from phylo_tpu_torch.train import trainer

    prof = profile(activities=[ProfilerActivity.CUDA])
    orig = trainer.site_batches
    calls = []

    def hooked(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            torch.cuda.synchronize()
            prof.start()
            out["t0"] = time.perf_counter()
        return orig(*a, **kw)

    trainer.site_batches = hooked
    try:
        yield
    finally:
        trainer.site_batches = orig
        torch.cuda.synchronize()
        if "t0" in out:
            out["wall_ms"] = (time.perf_counter() - out["t0"]) * 1e3
            prof.stop()
    out["trace"] = trace_stats(prof)


def trace_stats(prof):
    """The device events and runtime calls of a finished profile, read
    from its raw records (the profiler's own summary took minutes at half
    a million launches): {"device_ms", "kernels" (device events),
    "dispatches" (runtime calls that hand the card work: kernel and graph
    launches, copies, memsets), "graph_launches", "top" [(name, ms, n)]},
    or None when the trace holds no device event."""
    per = {}
    dispatches = graphs = 0
    results = getattr(prof.profiler, "kineto_results", None)
    for e in (results.events() if results is not None else ()):
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            row = per.setdefault(name, [0.0, 0])
            row[0] += e.duration_ns() / 1e6
            row[1] += 1
        elif name.startswith(DISPATCH_PREFIXES):
            dispatches += 1
            graphs += "GraphLaunch" in name
    if not per:
        return None
    top = sorted(((k, ms, n) for k, (ms, n) in per.items()),
                 key=lambda r: -r[1])
    return {"device_ms": sum(r[1] for r in top),
            "kernels": sum(r[2] for r in top),
            "dispatches": dispatches or None, "graph_launches": graphs,
            "top": top}


def fused_run(ext, name, fused, profiled=False, num_epoch=2):
    """train() on a main path's configuration with fused_epoch as given:
    {"res", "launches" (the run's, counters zeroed before), "peak"
    (torch.cuda.max_memory_allocated over the run), "epoch_s" (the
    second epoch's seconds), "profile" (the second epoch's, when
    profiled)}."""
    from phylo_tpu_torch.pruning import kernels
    from phylo_tpu_torch.train import TrainConfig, train

    path = PATHS[name]
    ds = load(path["dataset"], path.get("codons", False))
    cfg = TrainConfig(batch_size=S_BATCH, num_epoch=num_epoch,
                      save_artifacts=False, device="cuda",
                      fused_epoch=fused, **path["train"])
    kernels.TWIST_BWD_V2 = path.get("bwd_v2", False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ext.reset_launches()
    prof = {}
    with (second_epoch_profile(prof) if profiled
          else contextlib.nullcontext()):
        res = train(ds, cfg)
    torch.cuda.synchronize()
    kernels.TWIST_BWD_V2 = False
    return {"res": res, "launches": dict(ext.LAUNCHES),
            "peak": torch.cuda.max_memory_allocated(),
            "epoch_s": res.history["epoch_seconds"][-1], "profile": prof,
            "steps": ds.S // S_BATCH}


def _elbo_spread(runs):
    """The largest ELBO difference, any epoch, between two runs."""
    return max(abs(x - y) for a in runs for b in runs
               for x, y in zip(a["res"].history["elbo"],
                               b["res"].history["elbo"]))


def leaf_buffer_check(ext):
    """smc.sweep.sample_phylogenies_with_buffer on the card: at the
    runner's initial parameters, two seeded sweeps into one
    make_leaf_buffer against sample_phylogenies from the same seed (the
    same bits; the leaf columns untouched).  The rank forward writes
    into the buffer's internal columns at its particle stride: K1 on
    primate K=2048 (all 898 sites), K9f blocked on protein+G4 K=256 and
    K9f on GY94 K=128."""
    from phylo_tpu_torch.smc.sweep import (
        make_leaf_buffer, sample_phylogenies, sample_phylogenies_with_buffer,
    )
    from phylo_tpu_torch.train import TrainConfig
    from phylo_tpu_torch.train.trainer import _sweep_config, init_params

    for name, kname in (("vcsmc", "fused_rank_update"),
                        ("protein_g4", "fused_rank_update_wide_blocked"),
                        ("gy94_codon", "fused_rank_update_wide")):
        path = PATHS[name]
        ds = load(path["dataset"], path.get("codons", False))
        cfg = TrainConfig(device="cuda", **path["train"])
        model, params = init_params(ds, cfg)
        genome = (model.expand_leaves(ds.genome)
                  if hasattr(model, "expand_leaves") else ds.genome)
        leaves = torch.tensor(genome, dtype=torch.float32, device="cuda")
        sweep_cfg = _sweep_config(cfg)
        gen = lambda: torch.Generator(device="cuda").manual_seed(5)  # noqa
        plain = sample_phylogenies(gen(), leaves, model, params, sweep_cfg)
        buf = make_leaf_buffer(leaves, sweep_cfg, model=model)
        cols = buf[:, :ds.N].clone()
        ext.reset_launches()
        for _ in range(2):
            res, buf = sample_phylogenies_with_buffer(
                gen(), leaves, model, params, sweep_cfg, buf)
            require(torch.equal(res.elbo, plain.elbo) and torch.equal(
                res.log_weights, plain.log_weights),
                f"phase 9 {name}: the buffered sweep's ELBO "
                f"{float(res.elbo)} is not the plain sweep's "
                f"{float(plain.elbo)}")
        require(torch.equal(buf[:, :ds.N], cols),
                f"phase 9 {name}: the buffered sweep wrote a leaf column")
        require(ext.LAUNCHES.get(kname, 0) == 2 * (ds.N - 1),
                f"phase 9 {name}: {kname} launched "
                f"{ext.LAUNCHES.get(kname, 0)} times, not {2 * (ds.N - 1)}")
        log(f"phase 9 {name} leaf buffer {tuple(buf.shape)}: two buffered "
            f"sweeps, ELBO {float(plain.elbo):.3f} and log weights the plain "
            f"sweep's to the bit, leaf columns untouched, {kname} "
            f"{ext.LAUNCHES[kname]} launches")
        del buf, cols, plain, res
        torch.cuda.empty_cache()


def fused_epoch_phase(ext):
    """Phase 9: each path two epochs twice with fused_epoch=False (the
    loop) and twice with True (CUDA graphs; the second epoch profiled in
    one run of each): the same launches, graph replays an epoch of the
    steps + 1 after the warm-up step and the initial eval, and fused =
    loop to the bit wherever the loop repeats itself (else within the
    loops' spread and 1e-6 relative), and always on primate VCSMC and the
    spectral paths (GY94, GY94+G4, .dat+F+G4: eigh kernel, eigengap on
    the device); then DS1 VNCSMC twice under the default, to the bit.
    Returns {path: printed numbers}."""
    from phylo_tpu_torch.train.trainer import param_tensors

    out = {}
    for name in PHASE9:
        loops = [fused_run(ext, name, False, profiled=True),
                 fused_run(ext, name, False)]
        fused = [fused_run(ext, name, True),
                 fused_run(ext, name, True, profiled=True)]
        steps = loops[0]["steps"]
        for r in loops + fused:
            require(r["launches"] == loops[0]["launches"],
                    f"phase 9 {name}: launches {r['launches']} differ from "
                    f"the loop's {loops[0]['launches']}")
        for r in fused:
            g = r["res"].graphs
            require(g["captured"] and g["replays"] == [steps, steps + 1],
                    f"phase 9 {name}: graphs {g} (steps {steps})")
        for r in loops:
            require(not r["res"].graphs["captured"],
                    f"phase 9 {name}: the loop was captured")
        spread = _elbo_spread(loops)
        repeats = spread == 0.0 and same_bits(
            param_tensors(loops[0]["res"].params),
            param_tensors(loops[1]["res"].params))
        ref = loops[0]["res"]
        gap = _elbo_spread([loops[0]] + fused)
        rel = max(abs(x - y) / abs(y) for r in fused
                  for x, y in zip(r["res"].history["elbo"],
                                  ref.history["elbo"]))
        bits = all(r["res"].history["elbo"] == ref.history["elbo"]
                   and same_bits(param_tensors(r["res"].params),
                                 param_tensors(ref.params)) for r in fused)
        if repeats or name == "vcsmc" or name in PHASE9_SPECTRAL:
            require(repeats or name not in PHASE9_SPECTRAL,
                    f"phase 9 {name}: the loop does not repeat itself")
            require(bits, f"phase 9 {name}: the fused ELBOs "
                    f"{[r['res'].history['elbo'] for r in fused]} or "
                    "parameters are not the loop's "
                    f"{ref.history['elbo']} to the bit")
        else:
            lo = min(min(r["res"].history["elbo"]) for r in loops)
            hi = max(max(r["res"].history["elbo"]) for r in loops)
            require(rel <= 1e-6 and all(
                lo - spread <= x <= hi + spread for r in fused
                for x in r["res"].history["elbo"]),
                f"phase 9 {name}: fused ELBOs outside the loops' spread "
                f"{spread} or 1e-6 relative ({rel:.3g})")
        prof = {}
        for mode, r in (("loop", loops[0]), ("fused", fused[1])):
            t = r["profile"].get("trace")
            wall = r["profile"].get("wall_ms")
            prof[mode] = None if t is None else {
                "wall_ms": wall, "device_ms": t["device_ms"],
                "busy": t["device_ms"] / wall, "device_events": t["kernels"],
                "host_dispatches": t["dispatches"],
                "graph_launches": t["graph_launches"]}
        row = {
            "elbo": ref.history["elbo"],
            "loop_repeats_to_the_bit": repeats, "loop_spread": spread,
            "fused_gap": gap, "fused_rel_gap": rel,
            "fused_equals_loop_to_the_bit": bits,
            "s_per_epoch": {"loop": loops[1]["epoch_s"],
                            "fused": fused[0]["epoch_s"]},
            "capture_s": [r["res"].graphs["capture_seconds"]
                          for r in fused],
            "replays": fused[0]["res"].graphs["replays"],
            "max_memory_allocated": {"loop": loops[1]["peak"],
                                     "fused": fused[0]["peak"]},
            "second_epoch_profile": prof}
        log(f"phase 9 {name}: " + json.dumps(row))
        out[name] = row
        del loops, fused
        torch.cuda.empty_cache()
    # DS1 VNCSMC twice under the default: the twist's root log-likelihood
    # cotangents summed in a fixed order (smc.twist.gather_cols), so the
    # runs agree to the bit
    a, b = (fused_run(ext, "vncsmc_gtr_g4_ds1", True)["res"]
            for _ in range(2))
    same = a.history["elbo"] == b.history["elbo"] and same_bits(
        param_tensors(a.params), param_tensors(b.params))
    log("phase 9 vncsmc_gtr_g4_ds1 twice under the default: ELBOs "
        f"{json.dumps([a.history['elbo'], b.history['elbo']])}; the same "
        f"bits (parameters too): {same}; s/epoch "
        f"{[a.history['epoch_seconds'][-1], b.history['epoch_seconds'][-1]]}")
    require(same, "phase 9 vncsmc_gtr_g4_ds1: two runs differ")
    del a, b
    leaf_buffer_check(ext)
    return out


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from phylo_tpu_torch import _ext
    from phylo_tpu_torch.device import resolve_device
    from phylo_tpu_torch.models import expm_kernel
    from phylo_tpu_torch.pruning import kernels
    from phylo_tpu_torch.smc import resample_kernel

    dev = resolve_device("cuda")
    t0 = time.time()
    times = _ext.build_all(verbose="--ptxas" in argv)
    card = card_line()
    log(f"phase 1 built {sorted(times)} in {time.time() - t0:.1f} s "
        f"(per source {json.dumps({k: round(v, 1) for k, v in times.items()})}"
        "); "
        f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    protein_files()
    log(f"phase 1 wrote the protein path's inputs from seed 0: {PROT_FASTA} "
        f"({N_PROT} x {S_PROT}), {PROT_DAT}")
    if "--phase9" in argv:
        # phase 9 alone; no result line
        fused_epoch_phase(_ext)
        return 0
    if "--phase8" in argv:
        # phase 8 alone, after the phase-3 checks whose CPU runs it reads;
        # no result line
        fixed_decision_check(dev, route="fused_rank_bwd")
        fixed_decision_check(dev, twist=True, route=(
            "pair_loglik_fwd", "pair_ll_bwd", "merge_bwd"))
        fixed_decision_check(dev, spec="gtr+g4", dataset="hohna_data_1",
                             Kd=128, route="fused_rank_bwd_blocked",
                             data_grads=True)
        mesh_phase(_ext, dev, card)
        return 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    log("phase 2 kernels against their plain versions on the card:")
    k1, k1_inputs = check_k1(kernels, gen, dev, S_BATCH, save=True)
    check_k1(kernels, gen, dev, S_FULL, save=False)
    # the dense form at 8 states, which no main path launches
    check_k1(kernels, gen, dev, S_BATCH, save=True, idx=k1_inputs[2], A_=8,
             timed=False)
    k2 = check_k2(kernels, gen, dev, k1_inputs)
    k3 = check_k3(kernels, gen, dev, k1_inputs)
    check_k3(kernels, gen, dev, k1_inputs, ties=True)
    # the former bodies and their launchers are gone from the library
    for gone in ("launch_fused_rank_bwd_saved", "launch_fused_rank_bwd",
                 "launch_fused_rank", "launch_fused_rank_blocked"):
        require(not hasattr(_ext.lib("rank_kernels"), gone),
                f"rank_kernels still exports {gone}")
    cap_trade(kernels, gen, dev, k1_inputs, "primate", "K1", "K2", "K3")
    del k1_inputs
    # DS1 GTR+G4 (K10, K3 blocked): one real child index per site count
    idx_b = last_rank_idx(gen, dev, S_BATCH, "hohna_data_1", "gtr+g4")
    k10f, blk_inputs = check_k1(kernels, gen, dev, S_BATCH, save=True,
                                G=G_GAMMA, idx=idx_b)
    check_k1(kernels, gen, dev, S_BATCH, save=False, G=G_GAMMA, idx=idx_b)
    check_k1(kernels, gen, dev, S_BATCH, save=True, G=G_GAMMA + 1, idx=idx_b)
    # the forms no main-path shape launches: the register form's padded
    # blocks (G = 2, 3) and the staged form at 8 states a block
    for G_, A_ in ((2, A), (3, A), (G_GAMMA, 8)):
        check_k1(kernels, gen, dev, S_BATCH, save=True, G=G_, idx=idx_b,
                 A_=A_, timed=False)
    k10b = check_k2(kernels, gen, dev, blk_inputs, G=G_GAMMA)
    k3b = check_k3(kernels, gen, dev, blk_inputs, G=G_GAMMA)
    check_k3(kernels, gen, dev, blk_inputs, G=G_GAMMA, ties=True)
    cap_trade(kernels, gen, dev, blk_inputs, "DS1 GTR+G4", "K10",
              "K2 blocked", "K3 blocked")
    del blk_inputs
    # K3 blocked at all 1949 sites of DS1 (the eval sweep's shape), on the
    # inputs of K10's forward at that shape
    _, ds1_inputs = check_k1(kernels, gen, dev, S_DS1, save=False,
                             G=G_GAMMA)
    check_k3(kernels, gen, dev, ds1_inputs, G=G_GAMMA)
    del ds1_inputs
    torch.cuda.empty_cache()
    # K4 on primate VCSMC's batch, DS1 GTR+G4's (the kernels line) and the
    # twist's; ragged and single-element batches; the generic instance
    k4f, k4b = check_k4_all(expm_kernel, gen, dev)
    k_eigh = check_eigh(dev)
    k5 = check_k5(resample_kernel, gen, dev)
    check_k5(resample_kernel, gen, dev, K_TWIST)      # VNCSMC's K
    k7 = check_k7(kernels, gen, dev)
    # ragged sites; the last rank's KC = 32; odd and widest A, small
    check_k7(kernels, gen, dev, S=300)
    check_k7(kernels, gen, dev, KC=K_TWIST, timed=False)
    check_k7(kernels, gen, dev, KC=5, M_=3, S=70, A_=3, timed=False)
    check_k7(kernels, gen, dev, KC=4, M_=2, S=40, A_=8, timed=False)
    k8 = check_k8(kernels, gen, dev, S_BATCH)
    check_k8(kernels, gen, dev, S_FULL)
    check_k8(kernels, gen, dev, S_FULL, A=7, timed=False)
    check_k8(kernels, gen, dev, 2 * S_FULL + 3, A=8, timed=False)
    (k11b, k11b_blk, k7w, k7wb, k11c, k11c_blk, k11b_61,
     k7w_61) = check_twist_kernels(kernels, gen, dev)
    check_k11a(kernels, gen, dev, A)
    k11a = check_k11a(kernels, gen, dev, 4 * G_GAMMA)
    # VNCSMC GY94's chosen merges: K11a's wide body at 61 dense states
    k11a_61 = check_k11a(kernels, gen, dev, A_CODON)
    # protein+G4's chosen merges: K9bs blocked's body, 80 planes
    check_k11a(kernels, gen, dev, A_PROT, G_=G_GAMMA)
    torch.cuda.empty_cache()
    # K9 on GY94 codons (K=128, A=61): one real child index per site
    # count; the kernels line carries S=256 (the SGD steps) for K9f and
    # K9bs and S=1086 (the re-gather route's shape) for K9b
    idx_c = last_rank_idx(gen, dev, S_BATCH, "betacorona1", "gy94",
                          K_CODON, codons=True)
    k9 = check_k9(kernels, gen, dev, idx_c, S_BATCH)
    cap_trade(kernels, gen, dev, wide_inputs(gen, dev, S_BATCH, idx_c),
              "GY94 codons", "K9f", "K9bs", "K9b")
    k9_full = check_k9(kernels, gen, dev, last_rank_idx(
        gen, dev, S_CODON, "betacorona1", "gy94", K_CODON, codons=True),
        S_CODON)
    k9["fused_rank_bwd_wide"] = k9_full["fused_rank_bwd_wide"]
    del k9_full
    # the 512-thread backward (64 < A <= 128) at a small shape, untimed
    check_k9(kernels, gen, dev, small_idx(gen, dev, 8, 6, 5), 70, Nd=6,
             A_=100, timed=False)
    torch.cuda.empty_cache()
    # K9 blocked on protein+G4 (G=4 x A=20): the real child index of the
    # last rank of a protein sweep per shape; the kernels line carries the
    # main paths' shapes: K9f and K9b at K=256, S=256 (the SGD step; no
    # saved children over the cap), K9bs at K=64, S=256
    k9_blk = {}
    for Kd, S in ((K_PROT, S_BATCH), (K_PROT, S_PROT),
                  (K_PROT_SAVED, S_BATCH)):
        idx_p = last_rank_idx(gen, dev, S, PROT_FASTA, "reference+g4", Kd)
        got = check_k9(kernels, gen, dev, idx_p, S, Nd=N_PROT, A_=A_PROT,
                       G=G_GAMMA, line_save=False)
        if S == S_BATCH:
            keep = (("fused_rank_bwd_saved_wide_blocked",) if Kd ==
                    K_PROT_SAVED else ("fused_rank_update_wide_blocked",
                                       "fused_rank_bwd_wide_blocked"))
            k9_blk.update({k: got[k] for k in keep})
        if Kd == K_PROT and S == S_BATCH:
            # +I: block 0 the identity (its planes are the children's own)
            check_k9(kernels, gen, dev, idx_p, S, Nd=N_PROT, A_=A_PROT,
                     G=G_GAMMA + 1, timed=False)
        if Kd == K_PROT and S == S_BATCH:
            # the group forms forced at 4 x 20 against the one-group body
            for ties in (False, True):
                check_forced_groups(kernels, gen, dev, idx_p, S, ties=ties)
    torch.cuda.empty_cache()
    # over 128 planes: protein+G8 (8 x 20, one group at 16-site chunks)
    # at K=256, S=256 (the kernels line: the SGD step, K9b over the cap)
    # and 500, K9bs at K=32; GY94+G4 (4 x 61: K9f one group, the backward
    # in 2 groups of 2 blocks) at K=128, S=256 (the kernels line) and
    # 1086; K11a at K=32 on 8 blocks of 20 (VNCSMC protein+G8's chosen
    # merges)
    k9_wide = {}
    for spec, G, A_, Nd, ds_, codons, Kd, S in (
            ("reference+g8", G_GAMMA8, A_PROT, N_PROT, PROT_FASTA, False,
             K_PROT, S_BATCH),
            ("reference+g8", G_GAMMA8, A_PROT, N_PROT, PROT_FASTA, False,
             K_PROT, S_PROT),
            ("reference+g8", G_GAMMA8, A_PROT, N_PROT, PROT_FASTA, False,
             K_TWIST, S_BATCH),
            ("gy94+g4", G_GY94, A_CODON, N_CODON, "betacorona1", True,
             K_CODON, S_BATCH),
            ("gy94+g4", G_GY94, A_CODON, N_CODON, "betacorona1", True,
             K_CODON, S_CODON)):
        idx_w = last_rank_idx(gen, dev, S, ds_, spec, Kd, codons=codons)
        got = check_k9(kernels, gen, dev, idx_w, S, Nd=Nd, A_=A_, G=G,
                       line_save=False)
        if S == S_BATCH and Kd != K_TWIST:
            k9_wide.update({(k, f"{G}x{A_}"): got[k] for k in (
                "fused_rank_update_wide_blocked",
                "fused_rank_bwd_wide_blocked")})
        del idx_w
        torch.cuda.empty_cache()
    k11a_g8 = check_k11a(kernels, gen, dev, A_PROT, G_=G_GAMMA8)
    log(f"phase 2 over 128 planes done at {time.time() - t0:.1f} s")

    log(f"phase 2 done at {time.time() - t0:.1f} s")
    # primate VCSMC: at the main path's site batch, under the cap (K2), and
    # at all 898 sites, over it (K3)
    # with site weights and the data cotangents (item 8b) on K2's route
    fixed_decision_check(dev, S=S_BATCH, route="fused_rank_bwd_saved",
                         data_grads=True)
    fixed_decision_check(dev, route="fused_rank_bwd")
    # VNCSMC: primate with the defaults (K11b, K7, K11a), with the plain
    # forward and with the T-field backward (K11c); GTR+G4 on DS1's
    # first 10 taxa (K11b and K7 wide blocked, G=4 blocks of 4, K11a at
    # 16 dense states for the chosen merges; the CPU's plain float64
    # enumeration over all 27 taxa would take many minutes)
    fixed_decision_check(dev, twist=True, route=(
        "pair_loglik_fwd", "pair_ll_bwd", "merge_bwd"))
    fixed_decision_check(dev, twist=True, S=S_BATCH, use_pallas_ll=False,
                         route=("pair_ll_bwd", "merge_bwd"))
    fixed_decision_check(dev, twist=True, S=S_BATCH, bwd_v2=True,
                         route=("pair_loglik_fwd", "pair_ll_bwd_t"))
    fixed_decision_check(dev, twist=True, spec="gtr+g4",
                         dataset="hohna_data_1", S=S_BATCH, Nd=10,
                         route=("pair_loglik_fwd_blocked",
                                "pair_ll_bwd_wide_blocked", "merge_bwd"))
    # the same with the T-field backward: the blocked route too, K11b
    # blocked and K7 wide's body in its blocked T-field form
    fixed_decision_check(dev, twist=True, spec="gtr+g4",
                         dataset="hohna_data_1", S=S_BATCH, Nd=10,
                         bwd_v2=True, route=("pair_loglik_fwd_blocked",
                                             "pair_ll_bwd_t_blocked",
                                             "merge_bwd"))
    # VNCSMC protein+G4 and .dat+F+G4 (4 blocks of 20 states) on the
    # simulated alignment's first 6 taxa and 128 sites, under both
    # backwards, against one CPU run each (its T-field plain backward)
    for spec in ("reference+g4", f"{PROT_DAT}+f+g4"):
        for v2 in (False, True):
            fixed_decision_check(
                dev, twist=True, spec=spec, dataset=PROT_FASTA, S=128, Nd=6,
                bwd_v2=v2, cpu_bwd_v2=True, route=(
                    "pair_loglik_fwd_blocked", "pair_ll_bwd_t_blocked" if v2
                    else "pair_ll_bwd_wide_blocked", "merge_bwd"))
    # GTR+G4: under the cap (K10's saved-children backward), over it (K3)
    fixed_decision_check(dev, spec="gtr+g4", Kd=512, S=S_BATCH,
                         route="fused_rank_bwd_saved_blocked")
    # (and the data cotangents on the re-gather route, K3 blocked)
    fixed_decision_check(dev, spec="gtr+g4", dataset="hohna_data_1", Kd=128,
                         route="fused_rank_bwd_blocked", data_grads=True)
    # GY94 codons at K=128: under the cap (K9bs), over it (K9b)
    spectral_float32_probe(dev)
    fixed_decision_check(dev, spec="gy94", dataset="betacorona1", codons=True,
                         Kd=K_CODON, S=S_BATCH,
                         route="fused_rank_bwd_saved_wide")
    fixed_decision_check(dev, spec="gy94", dataset="betacorona1", codons=True,
                         Kd=K_CODON, route="fused_rank_bwd_wide")
    # protein+G4: under the cap (K9bs blocked), over it (K9b blocked)
    fixed_decision_check(dev, spec="reference+g4", dataset=PROT_FASTA,
                         Kd=K_PROT_SAVED, S=S_BATCH,
                         route="fused_rank_bwd_saved_wide_blocked")
    fixed_decision_check(dev, spec="reference+g4", dataset=PROT_FASTA,
                         Kd=K_PROT, route="fused_rank_bwd_wide_blocked")
    # .dat+F+G4 (spectral transitions through the eigh kernel) at its
    # main path's K=64, under the cap (K9bs blocked)
    fixed_decision_check(dev, spec=f"{PROT_DAT}+f+g4", dataset=PROT_FASTA,
                         Kd=K_PROT_SAVED, S=S_BATCH,
                         route="fused_rank_bwd_saved_wide_blocked")
    # over 128 planes: protein+G8 at K=64, S=256 (315 MB over the cap:
    # K9b blocked, one group), GY94+G4 at the main path's K=128, S=256
    # (over the cap: K9b blocked in 2 groups), VNCSMC protein+G8 on the
    # first 5 taxa and 128 sites (K11b, K7 wide blocked, K11a on 8 blocks
    # of 20)
    fixed_decision_check(dev, spec="reference+g8", dataset=PROT_FASTA,
                         Kd=K_PROT_SAVED, S=S_BATCH,
                         route="fused_rank_bwd_wide_blocked")
    fixed_decision_check(dev, spec="gy94+g4", dataset="betacorona1",
                         codons=True, Kd=K_CODON, S=S_BATCH,
                         route="fused_rank_bwd_wide_blocked")
    fixed_decision_check(
        dev, twist=True, spec="reference+g8", dataset=PROT_FASTA, S=128,
        Nd=5, cpu_bwd_v2=True, route=("pair_loglik_fwd_blocked",
                                      "pair_ll_bwd_wide_blocked",
                                      "merge_bwd"))
    # VNCSMC GY94 (dense 61 states: K11b and K7 wide dense, K11a's wide
    # body, spectral transitions through the eigh kernel) on betacorona1's
    # first 5 taxa and 64 codons: the CPU's float64 twist at 61 states
    # (the unrolled plain forward, the T-field plain backward) took ~70 s
    # there on 4 threads of a shared host.  GY94+G4's would take ~4x as
    # long and is not run; .dat+F+G4's is the protein check above
    gy94_fixed = dict(
        twist=True, spec="gy94", dataset="betacorona1", codons=True, S=64,
        Nd=5, cpu_bwd_v2=True, route=("pair_loglik_fwd", "pair_ll_bwd_wide",
                                      "merge_bwd", "eigh_jacobi"),
        note=f" (cut from {N_CODON} taxa and {S_CODON} codons for the CPU "
             "float64 reference's time)")
    one = fixed_decision_check(dev, **gy94_fixed)
    # the same with several pair chunks a rank on the card (4 pairs a
    # chunk: rank 0's 10 pairs in 3 uneven chunks, rank 1's 6 in 2): an
    # eigh call, a K11b launch and a K7 wide launch a chunk, the manual
    # VJP re-evaluating the same chunks; held to the same CPU run and to
    # the one-chunk card run
    chunked = fixed_decision_check(dev, pair_chunk=4, **gy94_fixed)
    chunk_agreement(one, chunked, 4, 5, "VNCSMC GY94 N=5 S=64")
    torch.cuda.empty_cache()
    log(f"phase 3 done at {time.time() - t0:.1f} s")
    by_path = {name: main_path(_ext, name) for name in PATHS}
    launches = {k: sum(c.get(k, 0) for c in by_path.values())
                for k in set().union(*by_path.values())}
    log(f"phase 4 done at {time.time() - t0:.1f} s")
    for name in PATHS:
        if PATHS[name].get("profile", True):
            profile_epoch(name)
    log(f"phase 5 done at {time.time() - t0:.1f} s")
    lifecycle(_ext, dev)
    log(f"phase 6 done at {time.time() - t0:.1f} s")
    for k, n in tree_tools(_ext, dev).items():
        launches[k] = launches.get(k, 0) + n
    log(f"phase 7 done at {time.time() - t0:.1f} s")
    for k, n in mesh_phase(_ext, dev, card).items():
        launches[k] = launches.get(k, 0) + n
    log(f"phase 8 done at {time.time() - t0:.1f} s")
    fused_epoch_phase(_ext)
    log(f"phase 9 done at {time.time() - t0:.1f} s")

    rows = [
        ("fused_rank_update", "phylo_tpu_torch/csrc/rank_kernels.cu",
         "phylo_tpu/pruning/kernels.py:1646", k1),
        ("fused_rank_bwd_saved", "phylo_tpu_torch/csrc/rank_kernels.cu",
         "phylo_tpu/pruning/kernels.py:2071", k2),
        ("fused_rank_bwd", "phylo_tpu_torch/csrc/rank_kernels.cu",
         "phylo_tpu/pruning/kernels.py:1949", k3),
        ("fused_rank_update_blocked", "phylo_tpu_torch/csrc/rank_kernels.cu",
         "phylo_tpu/pruning/kernels.py:1646", k10f),
        ("fused_rank_bwd_saved_blocked",
         "phylo_tpu_torch/csrc/rank_kernels.cu",
         "phylo_tpu/pruning/kernels.py:2071", k10b),
        ("fused_rank_bwd_blocked", "phylo_tpu_torch/csrc/rank_kernels.cu",
         "phylo_tpu/pruning/kernels.py:1949", k3b),
        ("expm_fwd", "phylo_tpu_torch/csrc/expm_kernels.cu",
         "phylo_tpu/models/expm_kernel.py:140", k4f),
        ("expm_bwd", "phylo_tpu_torch/csrc/expm_kernels.cu",
         "phylo_tpu/models/expm_kernel.py:169", k4b),
        ("categorical", "phylo_tpu_torch/csrc/resample_kernels.cu",
         "phylo_tpu/smc/resample_kernel.py:93", k5),
        # no pallas_call: JAX's jnp.linalg.eigh in expm_reversible
        ("eigh_jacobi", "phylo_tpu_torch/csrc/eigh_kernels.cu",
         "phylo_tpu/models/expm.py:308", k_eigh),
        ("pair_ll_bwd", "phylo_tpu_torch/csrc/twist_kernels.cu",
         "phylo_tpu/pruning/kernels.py:1059", k7),
        ("fused_merge_loglik", "phylo_tpu_torch/csrc/twist_kernels.cu",
         "phylo_tpu/pruning/kernels.py:159", k8),
        ("pair_ll_bwd_wide", "phylo_tpu_torch/csrc/twist_wide_kernels.cu",
         "phylo_tpu/pruning/kernels.py:1059", k7w),
        ("pair_ll_bwd_wide_blocked",
         "phylo_tpu_torch/csrc/twist_wide_kernels.cu",
         "phylo_tpu/pruning/kernels.py:1059", k7wb),
        ("pair_loglik_fwd", "phylo_tpu_torch/csrc/twist_wide_kernels.cu",
         "phylo_tpu/pruning/kernels.py:588", k11b),
        ("pair_loglik_fwd_blocked",
         "phylo_tpu_torch/csrc/twist_wide_kernels.cu",
         "phylo_tpu/pruning/kernels.py:588", k11b_blk),
        ("pair_ll_bwd_t", "phylo_tpu_torch/csrc/twist_kernels.cu",
         "phylo_tpu/pruning/kernels.py:1037", k11c),
        ("pair_ll_bwd_t_blocked",
         "phylo_tpu_torch/csrc/twist_wide_kernels.cu",
         "phylo_tpu/pruning/kernels.py:1037", k11c_blk),
        ("merge_bwd", "phylo_tpu_torch/csrc/wide_kernels.cu",
         "phylo_tpu/pruning/kernels.py:395", k11a),
        ("fused_rank_update_wide", "phylo_tpu_torch/csrc/wide_kernels.cu",
         "phylo_tpu/pruning/kernels.py:1646", k9["fused_rank_update_wide"]),
        ("fused_rank_bwd_saved_wide", "phylo_tpu_torch/csrc/wide_kernels.cu",
         "phylo_tpu/pruning/kernels.py:2071",
         k9["fused_rank_bwd_saved_wide"]),
        ("fused_rank_bwd_wide", "phylo_tpu_torch/csrc/wide_kernels.cu",
         "phylo_tpu/pruning/kernels.py:1949", k9["fused_rank_bwd_wide"]),
    ] + [(name, "phylo_tpu_torch/csrc/wide_kernels.cu",
          f"phylo_tpu/pruning/kernels.py:{site}", k9_blk[name])
         for name, site in (("fused_rank_update_wide_blocked", 1646),
                            ("fused_rank_bwd_saved_wide_blocked", 2071),
                            ("fused_rank_bwd_wide_blocked", 1949))]
    # over 128 planes, a row a (wrapper, shape), launches from the path
    # that runs that shape
    wide_rows = [(f"{name} {shape}", path, site, k9_wide[(name, shape)])
                 for shape, path in (("8x20", "protein_g8"),
                                     ("4x61", "gy94_g4"))
                 for name, site in (("fused_rank_update_wide_blocked", 1646),
                                    ("fused_rank_bwd_wide_blocked", 1949))]
    wide_rows.append(("merge_bwd 8x20", "vncsmc_protein_g8", 395, k11a_g8))
    # GY94's 61 dense states under the twist (phase 2 at rank 0), launches
    # from VNCSMC GY94's path
    wide_rows += [("pair_loglik_fwd 61", "vncsmc_gy94", 588, k11b_61),
                  ("pair_ll_bwd_wide 61", "vncsmc_gy94", 1059, k7w_61),
                  ("merge_bwd 61", "vncsmc_gy94", 395, k11a_61)]
    table = [dict(name=name, route="cuda", source=src, replaces=rep,
                  launches=int(launches.get(name, 0)), **m)
             for name, src, rep, m in rows] + [
        dict(name=name, route="cuda",
             source=("phylo_tpu_torch/csrc/twist_wide_kernels.cu"
                     if name.startswith("pair_") else
                     "phylo_tpu_torch/csrc/wide_kernels.cu"),
             replaces=f"phylo_tpu/pruning/kernels.py:{site}",
             launches=int(by_path[path].get(name.split()[0], 0)), **m)
        for name, path, site, m in wide_rows]
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
