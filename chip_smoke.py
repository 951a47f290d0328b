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
   A=4, S=256 and 1949, and G=5 (+I); K4 on primate's 45,056 matrices
   and DS1 GTR+G4's 425,984 a step; GY94 codons: K9 at K=128, A=61,
   S=256 and 1086, and A=100, A=20 at a small shape, the all-planes-tied
   case included), with the tolerances printed, and
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
   float32 eigh (why expm_reversible works in float64);
4. the main paths: two epochs each of VCSMC training on primate (N=12,
   S=898) at K=2048, of VNCSMC (twisted) training at K=32, M=10, of
   GTR+G4 VCSMC training on DS1 (N=27, S=1949) at K=2048 and of GY94
   codon VCSMC training on betacorona1 (N=17, 1086 codons, A=61) at
   K=128, site batch 256, through phylo_tpu_torch.cli.runner, with every
   kernel's launch counter set to 0 before each path and read after;
5. where the time of one epoch of each path goes, under torch.profiler.

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
                ties=False):
    """One rank's inputs on the codon path: Kd particles, Nd leaves, A_
    states, dense (Kd, A_, A_) transitions, the child index `idx`.  ties:
    every P column the same and pi uniform (JAX's
    test_fused_rank_bwd_wide_handles_max_ties case), so all A_ planes
    tie at every site's max."""
    f = dict(dtype=torch.float32, device=dev)
    buf = torch.rand((Kd, Nd - 1, A_, S), generator=gen, **f) * 0.95 + 0.05
    leaves = torch.rand((Nd, A_, S), generator=gen, **f) * 0.95 + 0.05
    P_l = torch.rand((Kd, A_, A_), generator=gen, **f) * 0.95 + 0.05
    P_r = torch.rand((Kd, A_, A_), generator=gen, **f) * 0.95 + 0.05
    pi = torch.rand((A_,), generator=gen, **f) + 0.1
    if ties:
        col = torch.rand((Kd, A_, 1), generator=gen, **f) * 0.95 + 0.05
        P_l = P_r = col.expand(Kd, A_, A_).contiguous()
        pi = torch.ones((A_,), **f)
    pi = (pi / pi.sum()).contiguous()
    w = torch.ones((S,), **f)
    return leaves, buf, idx, P_l, P_r, pi, w


def k9_bounds(kern, idx, A_, S, Nd, kind):
    """(bound ms, by) of one K9 launch on these inputs.  kind: "fwd",
    "fwd_save" (K9f), "bwd_saved" (K9bs), "bwd" (K9b).  Bytes: the child
    slabs read once each (the distinct ones idx names, or the 2 Kd saved
    copies for K9bs), the cotangent in and outputs out, transitions and
    their cotangents, the partial rows.  FP32 operations per particle and
    site: 4 A^2 + 4 A + 2 forward (u and v: 2 A^2 FMAs), 12 A^2 + 20 A + 4
    backward (u, v, dm1, dm2, dP_l, dP_r)."""
    Kd = idx.shape[1]
    slab = A_ * S * 4
    n_leaf, n_int = k1_slabs_read(idx, Nd)
    child = (2 * Kd if kind == "bwd_saved" else n_leaf + n_int) * slab
    small = 2 * Kd * A_ * A_ * 4 + S * 4 + A_ * 4
    if kind.startswith("fwd"):
        T = -(-S // kern.WIDE_TILE)
        nbytes = child + Kd * slab + small + 2 * Kd * T * 4 \
            + (2 * Kd * slab if kind == "fwd_save" else 0)
        return bound(nbytes, Kd * S * (4 * A_ * A_ + 4 * A_ + 2))
    nbytes = child + 3 * Kd * slab + 2 * small + 2 * Kd * 4 \
        + Kd * (A_ + S) * 4
    return bound(nbytes, Kd * S * (12 * A_ * A_ + 20 * A_ + 4))


def check_k9(kern, gen, dev, idx, S, Nd=N_CODON, A_=A_CODON, timed=True):
    """K9f (saving the children and not), K9bs and K9b against their plain
    versions at the codon path's shapes (Kd = idx.shape[1] particles, Nd
    leaves, A_ states; untimed for a side check at other shapes), the
    all-planes-tied case included; timed beside the plain versions and,
    as a yardstick for a later design, the two torch.bmm contractions
    u = P_l^T m1, v = P_r^T m2 alone.  Returns the kernels line's
    entries {name: dict} when timed."""
    Kd = idx.shape[1]
    out = {}
    leaves, buf, idx, P_l, P_r, pi, w = wide_inputs(gen, dev, S, idx, Kd,
                                                    Nd, A_)
    outc = buf.shape[1] - 1
    tag = f"K={Kd} A={A_} S={S}"
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
        log(f"  K9f fused_rank_update_wide {tag} save={save}: " + ", ".join(
            f"{k} err {v:.3e} (tol {tol[k]:g})" for k, v in errs.items()))
        for k, v in errs.items():
            require(v <= tol[k], f"K9f {k} error {v} > {tol[k]}")
        if not timed:
            continue
        ms = time_ms(lambda: kern.fused_rank_update(
            leaves, b_k, idx, outc, P_l, P_r, pi, w, save_children=save))
        plain = time_ms(lambda: kern._fused_rank_ref(
            leaves, b_p, idx, outc, P_l, P_r, pi, w, save_children=save),
            iters=3)
        b_ms, b_by = k9_bounds(kern, idx, A_, S, Nd,
                               "fwd_save" if save else "fwd")
        log(f"  K9f {tag} save={save}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}); library: null "
            "(no single PyTorch call gathers, merges, rescales and reduces)")
        if save:
            out["fused_rank_update_wide"] = dict(
                max_abs_err=max(errs.values()), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
    m1, m2 = kern.gather_children(leaves, buf, idx)
    m1, m2 = m1.contiguous(), m2.contiguous()
    if timed:
        Plt = P_l.transpose(1, 2).contiguous()
        Prt = P_r.transpose(1, 2).contiguous()
        mm = time_ms(lambda: (torch.bmm(Plt, m1), torch.bmm(Prt, m2)))
        log(f"  K9 yardstick {tag}: the two contractions alone as torch.bmm "
            f"(full float32) {mm:.4f} ms")
    for ties in (False, True):
        if ties:
            leaves, buf, idx, P_l, P_r, pi, w = wide_inputs(
                gen, dev, S, idx, Kd, Nd, A_, ties=True)
            m1, m2 = kern.gather_children(leaves, buf, idx)
            m1, m2 = m1.contiguous(), m2.contiguous()
        cts = (*bwd_cotangents(gen, dev, Kd, A_, S), P_l, P_r, pi, w)
        for name, kind, fn, ref, args in (
                ("fused_rank_bwd_saved_wide", "bwd_saved",
                 kern.fused_rank_bwd_saved, kern._fused_rank_bwd_saved_ref,
                 (m1, m2, *cts)),
                ("fused_rank_bwd_wide", "bwd", kern.fused_rank_bwd,
                 kern._fused_rank_bwd_ref, (leaves, buf, idx, *cts))):
            label = ("K9bs " if kind == "bwd_saved" else "K9b ") + name
            err = compare_bwd(f"{label} {tag}" + (" ties" if ties else ""),
                              fn(*args), ref(*args))
            if not timed or ties:
                continue
            ms = time_ms(lambda: fn(*args))
            plain = time_ms(lambda: ref(*args), iters=3)
            b_ms, b_by = k9_bounds(kern, idx, A_, S, Nd, kind)
            log(f"  {label.split()[0]} {tag}: kernel {ms:.4f} ms, plain "
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


def expm_inputs(gen, dev, spec=None):
    """K4's generator and branch lengths on a main path.  Primate VCSMC
    (spec None): the reference model's Q, moved off its initial value,
    and R*2*K = 45,056 branch lengths b ~ Exponential(rate 10).  DS1 under
    a rate mixture `spec`: the merge orientation Q^T of its base model
    (exchangeabilities and frequencies moved off their initial values)
    and the per-step batch the sweep gives K4, the (R, 2K) branch lengths
    eps / rate at the initial branch rates times the G category rates:
    26*4096*4 = 425,984 matrices for gtr+g4, 5 categories for gtr+g4+i
    (its rate-0 category makes b = 0)."""
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
        eps = torch.empty((2, ds.N - 1, K), **f).exponential_(generator=gen)
        b = torch.cat([eps[0] / rates_l[:, None], eps[1] / rates_r[:, None]],
                      dim=1)
        b = (b[..., None] * model.rates(params["model"]).to(torch.float32))
    return Qt, b.reshape(-1).contiguous()


def check_k4(ek, gen, dev, label, Q, b, timed=True):
    """K4 forward and backward against their plain versions on (Q, b),
    and, with the branch lengths clamped past 80 / mu, on the clamp
    region; timed beside the plain versions and torch.linalg.matrix_exp
    (forward and its backward) when `timed`."""
    from phylo_tpu_torch.models.expm import uniformize

    f = dict(dtype=torch.float32, device=dev)
    B = b.shape[0]
    gbar = torch.randn((B, A, A), generator=gen, **f)
    out = {}
    clamped = torch.full_like(b, 500.0)
    mu, Rm = uniformize(Q)
    for region, bb in (("mu*b < 80", b), ("mu*b > 80 (clamp)", clamped)):
        P_k = ek.expm_fwd(Rm, mu, bb)
        P_p = ek._expm_fwd_plain(Rm, mu, bb)
        F_k = ek.expm_bwd(Rm, mu, bb, gbar)
        F_p = ek._expm_bwd_plain(Rm, mu, bb, gbar)
        torch.cuda.synchronize()
        e_f = max_abs(P_k, P_p)
        e_b = max_rel(F_k.sum(0), F_p.sum(0))
        e_bf = max_rel(F_k, F_p)
        log(f"  K4 {label} B={B} {region}: fwd max abs err {e_f:.3e} "
            f"(tol 1e-6), bwd Q_bar rel err {e_b:.3e}, field rel err "
            f"{e_bf:.3e} (tol 1e-4)")
        require(e_f <= 1e-6, f"K4 {label} fwd error {e_f}")
        require(e_b <= 1e-4 and e_bf <= 1e-4,
                f"K4 {label} bwd error {e_b} {e_bf}")
        out[region] = (e_f, max_abs(F_k, F_p))
        del P_k, P_p, F_k, F_p
    if not timed:
        return None
    ms_f = time_ms(lambda: ek.expm_fwd(Rm, mu, b))
    plain_f = time_ms(lambda: ek._expm_fwd_plain(Rm, mu, b))
    Qb = (Q[None] * b[:, None, None]).contiguous()
    lib_f = time_ms(lambda: torch.linalg.matrix_exp(Qb))
    ms_b = time_ms(lambda: ek.expm_bwd(Rm, mu, b, gbar))
    plain_b = time_ms(lambda: ek._expm_bwd_plain(Rm, mu, b, gbar))
    steps = 11 + 12                      # order-1 Horner + squarings
    mm = 2 * A ** 3
    bf, byf = bound(B * 4 + B * A * A * 4 + (A * A + 1) * 4,
                    B * (steps * (mm + A * A) + 10))
    bb_, byb = bound(B * 4 + 2 * B * A * A * 4 + (A * A + 1) * 4,
                     B * steps * (3 * mm + 3 * A * A))
    # library: the backward of torch.linalg.matrix_exp on the same batch
    # (the Frechet adjoint per matrix; Q_bar and b_bar follow by sums)
    Qb_req = Qb.clone().requires_grad_(True)
    E = torch.linalg.matrix_exp(Qb_req)
    lib_b = time_ms(lambda: torch.autograd.grad(E, Qb_req, gbar,
                                                retain_graph=True))
    log(f"  K4 fwd {label} B={B}: kernel {ms_f:.4f} ms, plain {plain_f:.4f} "
        f"ms, torch.linalg.matrix_exp {lib_f:.4f} ms, bound {bf:.4f} ms "
        f"({byf})")
    log(f"  K4 bwd {label} B={B}: kernel {ms_b:.4f} ms, plain {plain_b:.4f} "
        f"ms, torch.linalg.matrix_exp backward {lib_b:.4f} ms, bound "
        f"{bb_:.4f} ms ({byb})")
    fwd = dict(max_abs_err=max(v[0] for v in out.values()), ms=ms_f,
               plain_ms=plain_f, bound_ms=bf, bound_by=byf, library_ms=lib_f)
    bwd = dict(max_abs_err=max(v[1] for v in out.values()), ms=ms_b,
               plain_ms=plain_b, bound_ms=bb_, bound_by=byb,
               library_ms=lib_b)
    return fwd, bwd


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
                         Kd=K, S=None, route=None, codons=False):
    """The sweep with numpy-made decisions, float32 on the card against
    float64 on the CPU: VCSMC at K=2048, VNCSMC at K=32, M=10, or model
    `spec` (a rate mixture, or GY94 on `dataset` as codons, with the
    alignment's F61 frequencies) on the first S sites of `dataset` at Kd
    particles; `route` names the reverse-pass kernel the card must have
    launched."""
    from phylo_tpu_torch import _ext
    from phylo_tpu_torch.models.substitution import ReferenceQ, get_model
    from phylo_tpu_torch.params import params_from_numpy
    from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies
    from phylo_tpu_torch.smc.twist import TwistConfig
    from phylo_tpu_torch.train.trainer import (
        _resolve_codon_frequencies, param_tensors,
    )

    ds = load(dataset, codons)
    rng = np.random.default_rng(11)
    genome = ds.genome[:, :S] if S else ds.genome
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
        tree = mixture_tree(model, rng, ds.N)
        if hasattr(model, "expand_leaves"):
            genome = model.expand_leaves(genome)
    rates = (np.exp(tree["branches"]["log_rates_l"]),
             np.exp(tree["branches"]["log_rates_r"]))
    if twist:
        Kd = K_TWIST
        dec = make_twist_decisions(rng, ds.N, Kd, M_TWIST, *rates)
        cfg = SweepConfig(K=Kd, twist=TwistConfig(M=M_TWIST))
        label = f"primate VNCSMC K={Kd} M={M_TWIST}"
    else:
        dec = make_decisions(rng, ds.N, Kd, *rates)
        cfg = SweepConfig(K=Kd)
        label = (f"primate VCSMC K={Kd} S={genome.shape[1]}" if spec is None
                 else f"{dataset} {spec} K={Kd} S={genome.shape[1]}")
    out = {}
    for name, device, dtype in (("cuda f32", dev, torch.float32),
                                ("cpu f64", "cpu", torch.float64)):
        params = params_from_numpy(tree, dtype=dtype, device=device)
        leaves = torch.tensor(genome, dtype=dtype, device=device)
        d = {k: torch.as_tensor(v, device=device) for k, v in dec.items()}
        _ext.reset_launches()
        res = sample_phylogenies(None, leaves, model, params, cfg,
                                 decisions=d)
        res.elbo.backward()
        if device != "cpu" and route is not None:
            require(_ext.LAUNCHES[route] > 0, f"{route} did not run in the "
                    f"{label} gradient")
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
    via = f" (reverse pass through {route})" if route else ""
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
# (K=32, b256, seed 0: -9102.1 at init, -8406.5 after 2 epochs)
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
        kernels=("fused_merge_loglik", "pair_ll_bwd",
                 "fused_rank_bwd_saved", "expm_fwd", "expm_bwd",
                 "categorical")),
    "gtr_g4_ds1": dict(
        dataset="hohna_data_1", band=(-10500.0, -7000.0),
        train=dict(n_particles=K, substitution_model="gtr+g4"),
        argv=["--model=gtr+g4", f"--n_particles={K}"],
        kernels=("fused_rank_update_blocked", "fused_rank_bwd_blocked",
                 "expm_fwd", "expm_bwd", "categorical")),
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
}


def main_path(ext, name):
    """Two training epochs of one path through the runner, with the
    launch counters set to 0 just before and read just after."""
    from phylo_tpu_torch.cli import runner
    from phylo_tpu_torch.train.trainer import param_tensors

    path = PATHS[name]
    argv = [f"--dataset={path['dataset']}", f"--batch_size={S_BATCH}"] \
        + path["argv"] + ["--num_epoch=2", "--no_artifacts", "--device=cuda"]
    torch.cuda.synchronize()
    ext.reset_launches()
    res = runner.run(argv)
    torch.cuda.synchronize()
    launches = dict(ext.LAUNCHES)
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
    log(f"phase 4 {name} ELBO {elbo:.3f}; seconds per epoch after warm-up "
        f"{secs[-1]:.4f} (epoch 1 incl. warm-up {secs[0]:.4f})")
    return launches


# ---------------------------------------------------------------- phase 5
def profile_epoch(name):
    """train() for one epoch of a main path's configuration under
    torch.profiler, after phase 4 warmed everything up.  The profiled run
    holds train()'s set-up, its initial eval sweep and one epoch (the
    SGD steps + the eval sweep).  Prints its host wall time, the summed
    device time and count of all kernel launches, the device's busy
    share, and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from phylo_tpu_torch.train import TrainConfig, train

    path = PATHS[name]
    ds = load(path["dataset"], path.get("codons", False))
    cfg = TrainConfig(batch_size=S_BATCH, num_epoch=1, save_artifacts=False,
                      log_every=0, device="cuda", **path["train"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(ds, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            rows.append((e.key[:70], float(us) / 1e3, int(e.count)))
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
        "top_kernels": [{"name": k, "device_ms": ms, "launches": n}
                        for k, ms, n in rows[:10]]}))


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
    # K4 on primate VCSMC's batch, and on DS1 GTR+G4's (the kernels line
    # carries the latter: the largest batch a main path gives K4)
    check_k4(expm_kernel, gen, dev, "primate", *expm_inputs(gen, dev))
    k4f, k4b = check_k4(expm_kernel, gen, dev, "DS1 gtr+g4",
                        *expm_inputs(gen, dev, "gtr+g4"))
    check_k4(expm_kernel, gen, dev, "DS1 gtr+g4+i",
             *expm_inputs(gen, dev, "gtr+g4+i"), timed=False)
    torch.cuda.empty_cache()
    k5 = check_k5(resample_kernel, gen, dev)
    k7 = check_k7(kernels, gen, dev)
    k8 = check_k8(kernels, gen, dev, S_BATCH)
    check_k8(kernels, gen, dev, S_FULL)
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

    log(f"phase 2 done at {time.time() - t0:.1f} s")
    # primate VCSMC: at the main path's site batch, under the cap (K2), and
    # at all 898 sites, over it (K3)
    fixed_decision_check(dev, S=S_BATCH, route="fused_rank_bwd_saved")
    fixed_decision_check(dev, route="fused_rank_bwd")
    fixed_decision_check(dev, twist=True)
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
    torch.cuda.empty_cache()
    log(f"phase 3 done at {time.time() - t0:.1f} s")
    by_path = {name: main_path(_ext, name) for name in PATHS}
    launches = {k: sum(c.get(k, 0) for c in by_path.values())
                for k in set().union(*by_path.values())}
    log(f"phase 4 done at {time.time() - t0:.1f} s")
    for name in PATHS:
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
        ("fused_rank_update_wide", "phylo_tpu_torch/csrc/wide_kernels.cu",
         "phylo_tpu/pruning/kernels.py:1646", k9["fused_rank_update_wide"]),
        ("fused_rank_bwd_saved_wide", "phylo_tpu_torch/csrc/wide_kernels.cu",
         "phylo_tpu/pruning/kernels.py:2071",
         k9["fused_rank_bwd_saved_wide"]),
        ("fused_rank_bwd_wide", "phylo_tpu_torch/csrc/wide_kernels.cu",
         "phylo_tpu/pruning/kernels.py:1949", k9["fused_rank_bwd_wide"]),
    ]
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
