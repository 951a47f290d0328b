"""Smoke test of the PyTorch/CUDA port (phylo_tpu_torch) on one GPU.

    python3 chip_smoke.py [--ptxas]

Phases, each printing a line of its own; any failure raises and the
script exits non-zero without printing a result:

1. build every kernel from csrc/ (one nvcc per source, in parallel) and
   read the card (nvidia-smi name and power limit);
2. each kernel against its plain PyTorch version on the card at the main
   paths' shapes (VCSMC: K=2048 particles, S=256 and 898 sites, 45,056
   transition matrices; VNCSMC: K=32 chosen merges, M=10 subsamples of
   32 x 66 candidate pairs; GTR+G4 on DS1: K=2048, G=4 rate blocks of
   A=4, S=256 and 1949, and G=5 (+I); K4 on primate's 45,056 matrices,
   DS1 GTR+G4's 425,984 a step and the twist's DS1 rank-0 898,560 and
   last-rank 7,680, each with every fourth branch past the clamp too,
   and untimed at B = 1, 7, 255, 257, 4,099, at (order, squarings) =
   (8, 6) and on GTR+G4+I, with two backward calls bit-identical and one
   device kernel a wrapper call (torch.profiler); GY94 codons: K9 at
   K=128, A=61, S=256 and 1086, and A=100, A=20 at a small shape, the
   all-planes-tied case included; protein+G4: K9 blocked at K=256, G=4
   blocks of A=20, S=256 and 500, K9bs blocked at K=64, and G=5 (+I)
   and all planes tied; VNCSMC's pair log-likelihoods at rank 0: K11b at
   primate (A=4, KC=2,112) and at DS1 GTR+G4 (KC=11,232) blocked (G=4 blocks of
   4, as the twist takes a rate mixture) and dense (the same
   transitions as 16 block-diagonal states), each in an A/B against the
   plain forward, K7 wide blocked and dense and K11c at DS1 KC=896 and
   timed at KC=11,232, the blocked forms against the dense ones (1e-6)
   with their A/B, dense A=20 and 61 and blocked 5 x 4, 2 x 20, 3 x 7
   and 4 x 4 over two site chunks small; K11a at A=4 and 16), with the
   tolerances printed, and
   timed beside the plain version, the least time the card could take
   (bound) and, where one exists, a single PyTorch library call; and the
   saved-children route (K10 saving + K10's backward) against the
   re-gather route (K10 + K3) at the DS1 step shape, the trade
   SAVE_CHILDREN_CAP decides;
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
   blocked; K=256, all 500 sites: K9b blocked), and VNCSMC K=32, M=10
   (primate with the defaults: K11b, K7, K11a; with the plain forward;
   with the T-field backward K11c; GTR+G4 on DS1's first 10 taxa at
   S=256: K11b and K7 wide blocked, K11a at 16 dense states);
4. the main paths: two epochs each of VCSMC training on primate (N=12,
   S=898) at K=2048, of VNCSMC (twisted) training at K=32, M=10, of
   GTR+G4 VCSMC training on DS1 (N=27, S=1949) at K=2048, of GY94
   codon VCSMC training on betacorona1 (N=17, 1086 codons, A=61) at
   K=128, of protein+G4 training (ReferenceQ(A=20) under GammaSites G=4)
   at K=256 and of an empirical .dat+F+G4 protein model at K=64 on a
   16 x 500 protein alignment that the script simulates from seed 0, of
   VNCSMC GTR+G4 on DS1 at K=32, M=10 (K11b and K7 wide blocked, K11a;
   the ELBOs and seconds per epoch beside PR 6's), and of
   primate VNCSMC again with the T-field backward K11c,
   site batch 256, through phylo_tpu_torch.cli.runner, with every
   kernel's launch counter set to 0 before each path and read after;
5. where the time of one epoch of each path goes, under torch.profiler
   (K4f's and K4b's device time and launches on every path; for VNCSMC
   GTR+G4 on DS1, K11b's, K7 wide's and K4's device time beside their
   earlier designs').

The last lines are the kernel table as JSON, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and FP32 (non-tensor)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
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
PROT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results", "chip_smoke")
PROT_FASTA = os.path.join(PROT_DIR, "protein_16x500.fa")
PROT_DAT = os.path.join(PROT_DIR, "protein_seed0.dat")
SLEEP_CYCLES = 100_000_000         # ~50 ms at the H100's ~2 GHz clock


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


def rank_inputs(gen, S, dev, G=1, idx=None):
    """One rank's inputs at the main paths' shapes: primate (N=12) with
    dense (K, A, A) transitions for G=1, DS1 (N=27) with (K, G, A, A)
    blocks otherwise; G=5 makes block 0 the identity, the +I rate-0
    category, whose merged planes tie."""
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


def check_k1(kern, gen, dev, S, save, G=1, idx=None):
    """K1 (G=1, primate) or K10's forward (G > 1, DS1 blocks)."""
    buf, leaves, idx, outc, P_l, P_r, pi, w = rank_inputs(gen, S, dev, G, idx)
    fn = kern.fused_rank_update
    b_k, b_p = buf.clone(), buf.clone()
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
    label = "K1 fused_rank_update" if G == 1 else \
        f"K10 fused_rank_update_blocked G={G}"
    log(f"  {label} S={S} save={save}: "
        + ", ".join(f"{k} err {v:.3e} (tol {tol[k]:g})"
                    for k, v in errs.items()))
    for k, v in errs.items():
        require(v <= tol[k], f"{label} {k} error {v} > {tol[k]}")
    ms = time_ms(lambda: fn(leaves, b_k, idx, outc, P_l, P_r, pi, w,
                            save_children=save))
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
    log(f"  {label.split()[0]} S={S}: last-rank idx of a real sweep reads "
        f"{n_leaf} leaf + {n_int} internal slabs for {2 * K} children; "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
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


def bwd_bytes(K_, G, S, child_slabs, nb):
    """Bytes a rank backward must move: the children (slabs of G*A*S
    floats), the cotangent in and the two child cotangents out, the
    transitions in and their cotangents out, the partial rows."""
    GA = G * A
    slab = GA * S * 4
    return child_slabs * slab + 3 * K_ * slab + 4 * K_ * G * A * A * 4 \
        + 2 * K_ * 4 + S * 4 + GA * 4 + nb * (GA + S) * 4


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
    ms = time_ms(lambda: kern.fused_rank_bwd_saved(*args))
    plain = time_ms(lambda: kern._fused_rank_bwd_saved_ref(*args),
                    iters=3 if G > 1 else 20)
    nb = -(-K // kern.BWD_PARTICLES_PER_BLOCK)
    nops = K * S * (8 * G * A * A + 20 * GA + 4)
    b_ms, b_by = bound(bwd_bytes(K, G, S, 2 * K, nb), nops)
    log(f"  {label.split()[0]} S={S}: kernel {ms:.4f} ms, plain {plain:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by})")
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
    if ties:
        return None
    ms = time_ms(lambda: kern.fused_rank_bwd(*args))
    plain = time_ms(lambda: kern._fused_rank_bwd_ref(*args),
                    iters=3 if G > 1 else 20)
    nb = -(-K // kern.BWD_PARTICLES_PER_BLOCK)
    n_leaf, n_int = k1_slabs_read(idx, leaves.shape[0])
    nops = K * S * (8 * G * A * A + 20 * GA + 4)
    b_ms, b_by = bound(bwd_bytes(K, G, S, n_leaf + n_int, nb), nops)
    log(f"  K3 G={G} S={S}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
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


def k9_bounds(kern, idx, A_, S, Nd, kind, G=1):
    """(bound ms, by) of one K9 launch on these inputs (G blocks of A_
    states).  kind: "fwd", "fwd_save" (K9f), "bwd_saved" (K9bs), "bwd"
    (K9b).  Bytes: the child slabs read once each (the distinct ones idx
    names, or the 2 Kd saved copies for K9bs), the cotangent in and
    outputs out, transitions and their cotangents, the partial rows.
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
        T = -(-S // kern.WIDE_TILE)
        nbytes = child + Kd * slab + small + 2 * Kd * T * 4 \
            + (2 * Kd * slab if kind == "fwd_save" else 0)
        return bound(nbytes, Kd * S * (4 * G * A_ * A_ + 4 * GA + 2))
    nbytes = child + 3 * Kd * slab + 2 * small + 2 * Kd * 4 \
        + Kd * (GA + S) * 4
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
        if not timed:
            continue
        ms = time_ms(lambda: kern.fused_rank_update(
            leaves, b_k, idx, outc, P_l, P_r, pi, w, save_children=save))
        plain = time_ms(lambda: kern._fused_rank_ref(
            leaves, b_p, idx, outc, P_l, P_r, pi, w, save_children=save),
            iters=3)
        b_ms, b_by = k9_bounds(kern, idx, A_, S, Nd,
                               "fwd_save" if save else "fwd", G)
        log(f"  {fname} {tag} save={save}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}); library: null "
            "(no single PyTorch call gathers, merges, rescales and reduces)")
        if save == line_save:
            out["fused_rank_update_wide" + sfx] = dict(
                max_abs_err=max(errs.values()), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
    m1, m2 = kern.gather_children(leaves, buf, idx)
    m1, m2 = m1.contiguous(), m2.contiguous()
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
            if not timed or tied:
                continue
            ms = time_ms(lambda: fn(*args))
            plain = time_ms(lambda: ref(*args), iters=3)
            b_ms, b_by = k9_bounds(kern, idx, A_, S, Nd, kind, G)
            log(f"  {label} {tag}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}); library: "
                "null (no single PyTorch call computes this backward)")
            out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return out


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
    """[(name, launches)] of the device kernels one call of fn makes, read
    from torch.profiler's device trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, int(e.count)) for e in prof.key_averages()
            if getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA]


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


def check_k4_all(ek, gen, dev):
    """K4 at every shape phase 2 holds it to: timed at primate VCSMC's
    45,056 matrices, DS1 GTR+G4's 425,984 (the kernels line) and the
    twist's DS1 rank-0 898,560 and last-rank 7,680; untimed at B = 1, 7,
    255, 257 and 4,099 (ragged edges; at B = 1 Q_bar is that element's
    own field), at a non-default (order, squarings) = (8, 6) (the generic
    instance) and on DS1 GTR+G4+I (b = 0 in its rate-0 category).  Then
    one forward and one backward call under torch.profiler: exactly one
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
        seen = device_kernels(fn)
        counted = _ext.LAUNCHES[name] - before
        log(f"  K4 one {name} call under torch.profiler: {json.dumps(seen)}"
            f"; launch counter +{counted}")
        require(len(seen) == 1 and seen[0][1] == 1 and counted == 1
                and f"{name}_kernel" in seen[0][0],
                f"K4: one {name} call launched {seen}, counted {counted}")
    torch.cuda.empty_cache()
    return line


def check_k5(rk, gen, dev):
    rng = np.random.default_rng(7)
    # skewed weights spanning ~3 orders of magnitude
    logits = torch.tensor(rng.gumbel(size=K) * 2.0, dtype=torch.float32,
                          device=dev)
    log_norm = (logits - torch.logsumexp(logits, 0)).contiguous()
    p = torch.softmax(logits.double(), 0).cpu().numpy()
    seed = rk.draw_seed(gen, dev)
    got = rk.categorical(log_norm, seed)
    want = rk._categorical_plain(log_norm, seed)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    log(f"  K5 categorical: {mism} of {K} draws differ from the plain "
        "version on the same seed (tol 2)")
    require(mism <= 2, f"K5 disagrees with its plain version on {mism}")
    rounds = 512
    counts = {"kernel": torch.zeros(K, dtype=torch.int64, device=dev),
              "torch.multinomial": torch.zeros(K, dtype=torch.int64,
                                               device=dev)}
    probs = torch.softmax(logits, 0)
    for _ in range(rounds):
        s = rk.draw_seed(gen, dev)
        counts["kernel"] += torch.bincount(
            rk.categorical(log_norm, s).long(), minlength=K)
        counts["torch.multinomial"] += torch.bincount(torch.multinomial(
            probs, K, replacement=True, generator=gen), minlength=K)
    n = rounds * K
    zs = {}
    for name, c in counts.items():
        chi2, dof = pooled_chi2(c.cpu().numpy(), p, n)
        zs[name] = (chi2 - dof) / math.sqrt(2 * dof)
        log(f"  K5 {name}: chi2 {chi2:.1f} on {dof} dof over {rounds}x{K}"
            f" draws (z = {zs[name]:+.2f})")
    require(abs(zs["kernel"]) < 4.0, f"K5 chi-square z {zs['kernel']}")
    ms = time_ms(lambda: rk.categorical(log_norm, seed))
    plain = time_ms(lambda: rk._categorical_plain(log_norm, seed), iters=5)
    lib = time_ms(lambda: torch.multinomial(probs, K, replacement=True,
                                            generator=gen))
    # per field entry: 2 logf + subtract + compare, plus a quarter of a
    # Philox4x32-10 call (10 rounds x 4 multiplies) counted as 10 ops
    b_ms, b_by = bound(2 * K * 4 + 16, K * K * 14)
    log(f"  K5: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"torch.multinomial {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=float((got - want).abs().max()), ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib)


def check_k8(kern, gen, dev, S):
    """K8 on the VNCSMC path's chosen merges: K=32 particles, explicit
    children, S=256 (SGD steps) or 898 (eval sweeps)."""
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
    log(f"  K8 fused_merge_loglik K={Kt} S={S}: " + ", ".join(
        f"{k} err {v:.3e}" for k, v in errs.items()) + f" (tol {tol:g})")
    for k, v in errs.items():
        require(v <= tol, f"K8 {k} error {v} > {tol}")
    ms = time_ms(lambda: kern.merge_loglik(*args))
    plain = time_ms(lambda: kern._ref_impl(*args))
    slab = Kt * A * S * 4
    nbytes = 3 * slab + 2 * Kt * A * A * 4 + A * 4 + S * 4 + 2 * Kt * 4
    nops = Kt * S * (4 * A * A + 4 * A + 2)
    b_ms, b_by = bound(nbytes, nops)
    log(f"  K8 S={S}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); library: null (no single PyTorch call "
        "merges, rescales and reduces the root log-likelihood)")
    return dict(max_abs_err=max(max_abs(a, b) for a, b in zip(got, want)),
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def check_k7(kern, gen, dev):
    """K7 at the VNCSMC training shapes: M=10 subsamples, KC = 32
    particles x 66 candidate pairs (rank 0 of primate), S=256 sites."""
    f = dict(dtype=torch.float32, device=dev)
    KC = K_TWIST * (N * (N - 1) // 2)
    m1 = torch.rand((KC, A, S_BATCH), generator=gen, **f) * 0.95 + 0.05
    m2 = torch.rand((KC, A, S_BATCH), generator=gen, **f) * 0.95 + 0.05
    P_l = torch.rand((M_TWIST, KC, A, A), generator=gen, **f) * 0.95 + 0.05
    P_r = torch.rand((M_TWIST, KC, A, A), generator=gen, **f) * 0.95 + 0.05
    pi = torch.rand((A,), generator=gen, **f) + 0.1
    pi = (pi / pi.sum()).contiguous()
    w = torch.ones((S_BATCH,), **f)
    g = torch.randn((M_TWIST, KC), generator=gen, **f)
    args = (m1, m2, P_l, P_r, pi, w, g)
    got = kern.pair_ll_bwd(*args, want_dw=False)[:5]
    want = kern._pair_ll_bwd_plain(*args)[:5]
    torch.cuda.synchronize()
    names = ["dm1", "dm2", "dP_l", "dP_r", "dpi"]
    errs = {n: max_rel(a, b) for n, a, b in zip(names, got, want)}
    # f32 sums over M subsamples (dm) and S sites (dP, dpi), in another
    # order than the plain version's autograd
    tol = 1e-4
    log("  K7 pair_ll_bwd: " + ", ".join(
        f"{n} rel err {v:.3e}" for n, v in errs.items()) + f" (tol {tol:g})")
    for n, v in errs.items():
        require(v <= tol, f"K7 {n} relative error {v} > {tol}")
    ms = time_ms(lambda: kern.pair_ll_bwd(*args, want_dw=False))
    plain = time_ms(lambda: kern._pair_ll_bwd_plain(*args), iters=5)
    slab = KC * A * S_BATCH * 4
    pbytes = M_TWIST * KC * A * A * 4
    nbytes = 4 * slab + 4 * pbytes + M_TWIST * KC * 4 + S_BATCH * 4 \
        + 2 * A * 4
    # per (m, k, s): u, v (4 A^2), site (3 A), gsite (2), du/dv (4 A),
    # dm and dP accumulation (8 A^2); an FMA counts 2
    nops = M_TWIST * KC * S_BATCH * (12 * A * A + 7 * A + 2)
    b_ms, b_by = bound(nbytes, nops)
    log(f"  K7 M={M_TWIST} KC={KC} S={S_BATCH}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}); library: null (no "
        "single PyTorch call computes this vector-Jacobian product)")
    return dict(max_abs_err=max(max_abs(a, b) for a, b in zip(got, want)),
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def twist_inputs(gen, dev, dataset, spec, C, S, A_=None, Kt=K_TWIST,
                 G_=None, blocked=False):
    """The twist's pair-loglik inputs at rank 0 of `dataset` under model
    `spec` (ReferenceQ for None): the first C prefix-ordered candidate
    pairs (leaves, shared by the Kt particles) over the first S sites,
    and the transitions of pool branch lengths b = eps / 10 (the initial
    rates) at the model's initial parameters, M_TWIST subsamples; KC =
    Kt * C rows in the sweep's K-major order.  `blocked`: a rate
    mixture's per-category transitions (M, KC, G, A_b, A_b), as the
    twist takes them.  With A_, random inputs of A_ states instead (a
    small shape), or of G_ blocks of A_ states with G_."""
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
    ds = load(dataset)
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
    ubar and T (6 A^2 + 4 A) and per (m, row) the two A x A products (4
    A^3).  Bytes: each input read once (P: G A_b^2 floats a matrix),
    each output written once."""
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
        nops = M_ * KC * S * per + (4 * M_ * KC * A_ ** 3
                                    if kind == "bwd_t" else 0)
    return bound(nbytes, nops)


def ab_ms(fa, fb, iters_a=20, iters_b=20):
    """Times of fa and fb in turns a, b, b, a (one card, one call)."""
    a1 = time_ms(fa, iters=iters_a)
    b1 = time_ms(fb, iters=iters_b)
    b2 = time_ms(fb, iters=iters_b)
    a2 = time_ms(fa, iters=iters_a)
    return (a1, a2), (b1, b2)


def check_k11b(kern, ins, label, timed=True):
    """K11b (the pair-loglik forward) against its plain version; timed,
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


def check_twist_bwd(kern, gen, ins, label, t_field, timed=True,
                    full=None):
    """K7 wide, dense or blocked (t_field False), or K11c (the T-field
    backward, with its dP products) against its plain version; timed at
    these inputs, and the kernel alone at the `full` rank-0 inputs."""
    M_, KC = ins[2].shape[:2]
    f = dict(dtype=torch.float32, device=ins[0].device)
    g = torch.randn((M_, KC), generator=gen, **f)
    kind = "bwd_t" if t_field else "bwd"
    plain = kern._pair_ll_bwd_t_ref if t_field else kern._pair_ll_bwd_plain
    old = kern.TWIST_BWD_V2
    kern.TWIST_BWD_V2 = t_field
    try:
        got = kern.pair_ll_bwd(*ins, g, want_dw=False)[:5]
        want = plain(*ins, g)[:5]
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
        if not timed:
            return None
        ms = time_ms(lambda: kern.pair_ll_bwd(*ins, g, want_dw=False))
        plain_ms = time_ms(lambda: plain(*ins, g), iters=3)
        b_ms, b_by = twist_bound(ins, kind)
        log(f"  {label} KC={KC}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}); library: null (no single "
            "PyTorch call computes this vector-Jacobian product)")
        if full is not None:
            gf = torch.randn(full[2].shape[:2], generator=gen, **f)
            ms_f = time_ms(lambda: kern.pair_ll_bwd(*full, gf,
                                                    want_dw=False))
            bf, bfy = twist_bound(full, kind)
            log(f"  {label} at rank 0's KC={full[2].shape[1]}: kernel "
                f"{ms_f:.4f} ms, bound {bf:.4f} ms ({bfy})")
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


def check_twist_kernels(kernels, gen, dev):
    """Phase 2's pair-loglik kernels (K11b, K7 wide, K11c), dense and
    blocked; returns the kernels line's entries (K11b dense, K11b
    blocked, K7 wide dense, K7 wide blocked, K11c)."""
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
    k11c = check_twist_bwd(kernels, gen, rows_d, "K11c pair_ll_bwd_t", True,
                           full=twist_d)
    check_forms(kernels, gen, rows_b, "DS1 gtr+g4 KC=896")
    check_forms(kernels, gen, twist_b, "DS1 gtr+g4 rank 0")
    del twist_b, twist_d, rows_b, rows_d
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
    return k11b, k11b_blk, k7w, k7wb, k11c


def check_k11a(kern, gen, dev, A_, S=S_BATCH, Kt=K_TWIST):
    """K11a (the merge backward on explicit children) at the VNCSMC
    path's chosen merges: K=32 particles, S=256 sites, A_ dense states
    (K2's body for A <= 8, K9bs dense above)."""
    f = dict(dtype=torch.float32, device=dev)
    m1, m2 = (torch.rand((Kt, A_, S), generator=gen, **f) * 0.95 + 0.05
              for _ in range(2))
    P_l, P_r = (torch.rand((Kt, A_, A_), generator=gen, **f) * 0.95 + 0.05
                for _ in range(2))
    pi = torch.rand((A_,), generator=gen, **f) + 0.1
    pi = (pi / pi.sum()).contiguous()
    w = torch.ones((S,), **f)
    args = (m1, m2, P_l, P_r, pi, w) + bwd_cotangents(gen, dev, Kt, A_, S)
    got = kern.merge_bwd(*args)
    want = kern._merge_bwd_ref(*args)
    torch.cuda.synchronize()
    names = ["dm1", "dm2", "dP_l", "dP_r", "dpi", "dw"]
    errs = {n: max_rel(a, b) for n, a, b in zip(names, got, want)}
    tol = 1e-4
    log(f"  K11a merge_bwd K={Kt} A={A_} S={S}: " + ", ".join(
        f"{n} rel err {v:.3e}" for n, v in errs.items()) + f" (tol {tol:g})")
    for n, v in errs.items():
        require(v <= tol, f"K11a {n} relative error {v} > {tol}")
    ms = time_ms(lambda: kern.merge_bwd(*args))
    plain = time_ms(lambda: kern._merge_bwd_ref(*args))
    slab = Kt * A_ * S * 4
    nbytes = 5 * slab + 4 * Kt * A_ * A_ * 4 + 2 * Kt * 4 + 2 * (S + A_) * 4
    # u, v (4 A^2), dm and dP (8 A^2), the per-site scalars and the max
    # (about 10 A); an FMA counts 2
    nops = Kt * S * (12 * A_ * A_ + 10 * A_)
    b_ms, b_by = bound(nbytes, nops)
    log(f"  K11a A={A_}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
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


def fixed_decision_check(dev, twist=False, spec=None, dataset="primate",
                         Kd=K, S=None, route=(), codons=False, Nd=None,
                         use_pallas_ll=True, bwd_v2=False):
    """The sweep with numpy-made decisions, float32 on the card against
    float64 on the CPU: VCSMC at K=2048, VNCSMC at K=32, M=10, or model
    `spec` (a rate mixture, or GY94 on `dataset` as codons, with the
    alignment's F61 frequencies) on the first S sites (and the first Nd
    taxa) of `dataset` at Kd particles; under twist with the pair
    log-likelihoods' forward on K11b (`use_pallas_ll`) or plain, and the
    T-field backward K11c (`bwd_v2`, both devices).  `route` names the
    kernels the card must have launched in the gradient."""
    from phylo_tpu_torch import _ext
    from phylo_tpu_torch.models.substitution import ReferenceQ, get_model
    from phylo_tpu_torch.params import params_from_numpy
    from phylo_tpu_torch.pruning import kernels
    from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies
    from phylo_tpu_torch.smc.twist import TwistConfig
    from phylo_tpu_torch.train.trainer import (
        _resolve_codon_frequencies, param_tensors,
    )

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
            M=M_TWIST, use_pallas_ll=use_pallas_ll))
        label = (f"{os.path.basename(dataset)} {spec or 'reference'} "
                 f"VNCSMC N={Nd} K={Kd} M={M_TWIST} S={genome.shape[1]}"
                 f"{'' if use_pallas_ll else ', plain forward'}"
                 f"{', T-field backward' if bwd_v2 else ''}")
    else:
        dec = make_decisions(rng, Nd, Kd, *rates)
        cfg = SweepConfig(K=Kd)
        label = (f"primate VCSMC K={Kd} S={genome.shape[1]}" if spec is None
                 else f"{os.path.basename(dataset)} {spec} K={Kd} "
                 f"S={genome.shape[1]}")
    out = {}
    kernels.TWIST_BWD_V2 = bwd_v2
    for name, device, dtype in (("cuda f32", dev, torch.float32),
                                ("cpu f64", "cpu", torch.float64)):
        params = params_from_numpy(tree, dtype=dtype, device=device)
        leaves = torch.tensor(genome, dtype=dtype, device=device)
        d = {k: torch.as_tensor(v, device=device) for k, v in dec.items()}
        _ext.reset_launches()
        res = sample_phylogenies(None, leaves, model, params, cfg,
                                 decisions=d)
        res.elbo.backward()
        if device != "cpu":
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
        out[name] = (float(res.elbo.detach()),
                     res.log_likelihood_R.detach().cpu().double(), grads,
                     named)
        del res, params, leaves
    kernels.TWIST_BWD_V2 = False
    (e32, llr32, g32, n32), (e64, llr64, g64, n64) = (out["cuda f32"],
                                                      out["cpu f64"])
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
    extra = "".join(f"; {k} rel err {v:.3e} (tol 1e-2)"
                    for k, v in rel_named.items())
    via = (f" (reverse pass through "
           f"{route if isinstance(route, str) else ', '.join(route)})"
           if route else "")
    log(f"phase 3 fixed-decision ELBO {label}{via}: cuda f32 {e32:.6f} vs "
        f"cpu f64 {e64:.6f}, rel err {rel:.3e} (tol 1e-3); "
        f"log_likelihood_R max rel err {rel_llr:.3e}; manual-VJP gradient "
        f"rel L2 err {rel_g:.3e} (tol 1e-2){extra}{values}")
    require(rel <= 1e-3, f"fixed-decision ELBO rel error {rel}")
    require(rel_llr <= 1e-3, f"log_likelihood_R rel error {rel_llr}")
    require(rel_g <= 1e-2, f"gradient rel error {rel_g}")
    for k, v in rel_named.items():
        require(v <= 1e-2, f"{k} gradient rel error {v}")


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
PATHS = {
    "vcsmc": dict(
        dataset="primate_data", band=(-8000.0, -5500.0),
        train=dict(n_particles=K),
        argv=[f"--n_particles={K}"],
        kernels=("fused_rank_update", "fused_rank_bwd_saved", "expm_fwd",
                 "expm_bwd", "categorical")),
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
                 "expm_fwd", "expm_bwd", "categorical")),
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
        twist_profile="PR 6: K11b 454 ms over 390 launches, K7 wide 816 ms "
                      "over 182; register-tiled blocked forms: 77.1 and "
                      "148.9 ms",
        k4_profile="with divisions in the chain and the batch sums in "
                   "torch: K4 backward 93 ms"),
    # primate VNCSMC again with the T-field backward K11c
    # (PHYLO_TWIST_BWD_V2=1) in place of K7: 3 SGD steps an epoch, 11
    # ranks each
    "vncsmc_t_field": dict(
        dataset="primate_data", band=(-8000.0, -5500.0), profile=False,
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
                 "categorical"),
        exact={"fused_rank_update_wide": (N_CODON - 1) * (1 + 2 * (
            S_CODON // S_BATCH + 1)),
               "fused_rank_bwd_saved_wide": (N_CODON - 1) * 2 * (
            S_CODON // S_BATCH)}),
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
    "protein_dat_f_g4": dict(
        dataset=PROT_FASTA, band=(-16000.0, -9000.0), profile=False,
        train=dict(n_particles=K_PROT_SAVED, gamma_categories=4,
                   paml_dat=PROT_DAT, plus_f=True),
        argv=[f"--paml_dat={PROT_DAT}", "--plus_f=True",
              "--gamma_categories=4", f"--n_particles={K_PROT_SAVED}"],
        kernels=("fused_rank_update_wide_blocked",
                 "fused_rank_bwd_saved_wide_blocked", "categorical"),
        exact={"fused_rank_update_wide_blocked": (N_PROT - 1) * (1 + 2 * (
            S_PROT // S_BATCH + 1)),
               "fused_rank_bwd_saved_wide_blocked": (N_PROT - 1) * 2 * (
            S_PROT // S_BATCH)}),
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
    kernels.TWIST_BWD_V2 = path.get("bwd_v2", False)
    torch.cuda.synchronize()
    ext.reset_launches()
    res = runner.run(argv)
    torch.cuda.synchronize()
    launches = dict(ext.LAUNCHES)
    kernels.TWIST_BWD_V2 = False
    log(f"phase 4 {name} main path launches: {json.dumps(launches)}")
    for kname in path["kernels"]:
        require(launches.get(kname, 0) > 0, f"{kname} never launched")
    for kname, n in path.get("exact", {}).items():
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
    return launches


# ---------------------------------------------------------------- phase 5
def profile_epoch(name):
    """train() for one epoch of a main path's configuration under
    torch.profiler, after phase 4 warmed everything up.  The profiled run
    holds train()'s set-up, its initial eval sweep and one epoch (the
    SGD steps + the eval sweep).  Prints its host wall time, the summed
    device time and count of all kernel launches, the device's busy
    share, and the kernels with the most device time.  Only the device
    is traced: the profiler's summary of host operator events took
    minutes at VNCSMC DS1's half a million launches an epoch."""
    from torch.profiler import ProfilerActivity, profile

    from phylo_tpu_torch.train import TrainConfig, train

    path = PATHS[name]
    ds = load(path["dataset"], path.get("codons", False))
    cfg = TrainConfig(batch_size=S_BATCH, num_epoch=1, save_artifacts=False,
                      log_every=0, device="cuda", **path["train"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(ds, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
    rows = []
    named = {k: [0.0, 0] for k in ("K11b", "K7 wide", "K4f", "K4b")}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            rows.append((e.key[:70], float(us) / 1e3, int(e.count)))
            for kname, fn in (("K11b", "pair_ll_fwd_kernel"),
                              ("K7 wide", "pair_ll_bwd_wide_kernel"),
                              ("K4f", "expm_fwd_kernel"),
                              ("K4b", "expm_bwd_kernel")):
                if fn in e.key:
                    named[kname][0] += float(us) / 1e3
                    named[kname][1] += int(e.count)
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if not rows:
        log(f"phase 5 {name} profile: wall {wall_ms:.1f} ms; the profiler "
            "recorded no device time (device numbers not measured)")
        return
    log(f"phase 5 {name} profile of train(num_epoch=1): " + json.dumps({
        "wall_ms": wall_ms, "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "kernel_launches": sum(r[2] for r in rows),
        "summary_s": time.perf_counter() - t1,
        "top_kernels": [{"name": k, "device_ms": ms, "launches": n}
                        for k, ms, n in rows[:10]]}))
    log(f"phase 5 {name} K4 kernels: " + ", ".join(
        f"{k} {named[k][0]:.2f} ms over {named[k][1]} launches"
        for k in ("K4f", "K4b"))
        + f" ({path.get('k4_profile', 'earlier: not recorded')})")
    if "twist_profile" in path:
        twist = {k: named[k] for k in ("K11b", "K7 wide")}
        log(f"phase 5 {name} twist kernels: " + ", ".join(
            f"{k} {ms:.1f} ms over {n} launches"
            for k, (ms, n) in twist.items())
            + f"; together {sum(v[0] for v in twist.values()):.1f} ms "
            f"({path['twist_profile']})")


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
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    log("phase 2 kernels against their plain versions on the card:")
    k1, k1_inputs = check_k1(kernels, gen, dev, S_BATCH, save=True)
    check_k1(kernels, gen, dev, S_FULL, save=False)
    k2 = check_k2(kernels, gen, dev, k1_inputs)
    k3 = check_k3(kernels, gen, dev, k1_inputs)
    del k1_inputs
    # DS1 GTR+G4 (K10, K3 blocked): one real child index per site count
    idx_b = last_rank_idx(gen, dev, S_BATCH, "hohna_data_1", "gtr+g4")
    k10f, blk_inputs = check_k1(kernels, gen, dev, S_BATCH, save=True,
                                G=G_GAMMA, idx=idx_b)
    check_k1(kernels, gen, dev, S_BATCH, save=False, G=G_GAMMA, idx=idx_b)
    check_k1(kernels, gen, dev, S_BATCH, save=True, G=G_GAMMA + 1, idx=idx_b)
    k10b = check_k2(kernels, gen, dev, blk_inputs, G=G_GAMMA)
    k3b = check_k3(kernels, gen, dev, blk_inputs, G=G_GAMMA)
    check_k3(kernels, gen, dev, blk_inputs, G=G_GAMMA, ties=True)
    cap_trade(kernels, gen, dev, blk_inputs, "DS1 GTR+G4", "K10",
              "K2 blocked", "K3 blocked")
    del blk_inputs
    check_k1(kernels, gen, dev, S_DS1, save=False, G=G_GAMMA)
    torch.cuda.empty_cache()
    # K4 on primate VCSMC's batch, DS1 GTR+G4's (the kernels line) and the
    # twist's; ragged and single-element batches; the generic instance
    k4f, k4b = check_k4_all(expm_kernel, gen, dev)
    k5 = check_k5(resample_kernel, gen, dev)
    k7 = check_k7(kernels, gen, dev)
    k8 = check_k8(kernels, gen, dev, S_BATCH)
    check_k8(kernels, gen, dev, S_FULL)
    k11b, k11b_blk, k7w, k7wb, k11c = check_twist_kernels(kernels, gen,
                                                          dev)
    check_k11a(kernels, gen, dev, A)
    k11a = check_k11a(kernels, gen, dev, 4 * G_GAMMA)
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
    torch.cuda.empty_cache()

    log(f"phase 2 done at {time.time() - t0:.1f} s")
    # primate VCSMC: at the main path's site batch, under the cap (K2), and
    # at all 898 sites, over it (K3)
    fixed_decision_check(dev, S=S_BATCH, route="fused_rank_bwd_saved")
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
    # GTR+G4: under the cap (K10's saved-children backward), over it (K3)
    fixed_decision_check(dev, spec="gtr+g4", Kd=512, S=S_BATCH,
                         route="fused_rank_bwd_saved_blocked")
    fixed_decision_check(dev, spec="gtr+g4", dataset="hohna_data_1", Kd=128,
                         route="fused_rank_bwd_blocked")
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
        ("pair_ll_bwd_t", "phylo_tpu_torch/csrc/twist_wide_kernels.cu",
         "phylo_tpu/pruning/kernels.py:1037", k11c),
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
    table = [dict(name=name, route="cuda", source=src, replaces=rep,
                  launches=int(launches.get(name, 0)), **m)
             for name, src, rep, m in rows]
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
