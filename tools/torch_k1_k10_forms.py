"""Time the forms of the rank forward (K1, and K10's forward) on one card,
and hold each against its plain version.

The body is csrc/rank_kernels.cu's `fused_rank_fwd_kernel<A, SPL, NG>`
at A = 4.  Its forms: the register form (NG blocks at compile time:
NG = 1 dense, K1; NG = 4 blocked, G <= 4) or, blocked, the staged form
(NG = 0: the children staged by cp.async in the warp's shared memory, G
at run time); SPL = 1, 2 or 4 sites a lane (the library instantiates 1
and 2 dense, 1 blocked; 4 is built here only); 1, 2, 4 or 8 warps a
particle (at most the particle's chunks); beside the launcher's pick
through the wrapper (`fused_rank_update`, whose plan is
`rank_fwd_plan`).  Each form also in the two choices the library fixed,
from patched copies of the source (VARIANTS): each plane divided by the
scale in place of one reciprocal a site, and the other store kind
(streaming dense, plain blocked).  Shapes (chip_smoke.py phase 2's, each with the child
index of the last rank of a real sweep): K1 at primate K = 2048, S = 256
saving the children (the SGD step) and S = 898 (the eval sweep); K10 at
DS1 GTR+G4 K = 2048, G = 4, S = 256 without saving (the step: the
children would be over SAVE_CHILDREN_CAP) and saving, G = 5 (+I, planes
tied) saving, and S = 1949 (the eval sweep).  Beside them, probes of
what bounds a launch: `probe_reads` reads each particle's two children
(the L2 -> SM traffic of one pass) and writes one float a thread,
`probe_writes` writes the column (the DRAM stores), `probe_rw` does
both (the column as the children's product, contiguous), and
`probe_rw_sites` both in the kernel's access pattern (a lane a site, its
loads over the planes first), `_pad` into a separate output whose rows
are padded to 32 sites (128-byte aligned); `_cs` with streaming
(evict-first) stores.

Every form is checked against the plain version (phase 2's tolerances:
the column 1e-5 abs, rootll and logscale 1e-5 rel, saved children exact)
and timed in turns first..last, last..first (CUDA events behind a sleep
kernel, chip_smoke.py's `time_ms`); the shim is built with -Xptxas -v
and every instance's registers and spills printed.

    python tools/torch_k1_k10_forms.py [--parent DIR]

--parent DIR (a checkout of the commit before this redesign, e.g. from
git archive) also builds that checkout's rank_kernels.cu and runs the
one-call A/B former, new, new, former at every shape: the former K1 /
K10 forward launch against `fused_rank_update`.

Needs a CUDA card and nvcc; prints one JSON line per shape, the ptxas
summary and the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
import torch_k7_forms as k7f  # noqa: E402
from phylo_tpu_torch import _ext  # noqa: E402
from phylo_tpu_torch.pruning import kernels  # noqa: E402

TOL = {"buf": 1e-5, "rootll": 1e-5, "logscale": 1e-5, "children": 0.0}
WARPS = (1, 2, 4, 8)
# the library's body and its patched copies: {name: (division a plane,
# the other store kind, the source's lines replaced and their counts)}
VARIANTS = {
    "lib": (False, False, ()),
    "div": (True, False, (("] * inv);", "] / scale);", 2),)),
    "flip": (False, True, (("Stream = NG != 1;", "Stream = NG == 1;", 1),)),
    "div_flip": (True, True, (("] * inv);", "] / scale);", 2),
                              ("Stream = NG != 1;", "Stream = NG == 1;",
                               1))),
}
PROBE_NAMES = ("probe_reads", "probe_writes", "probe_rw", "probe_rw_cs",
               "probe_rw_sites", "probe_rw_sites_cs", "probe_rw_sites_pad",
               "probe_rw_sites_pad_cs")
# (NG, SPL) instances of the shim: dense, the register form at G <= 4,
# the staged form (G > 1)
FORMS = ((1, 1), (1, 2), (1, 4), (4, 1), (4, 2), (0, 1), (0, 2))
FWD_PTRS = ("const float* leaves, float* buf, const int* idx, "
            "const float* Pl, const float* Pr, const float* pi, "
            "const float* w, float* rootll, float* logscale, float* c1, "
            "float* c2")
FWD_CALL = "leaves, buf, idx, Pl, Pr, pi, w, rootll, logscale, c1, c2"
PROBES = """
__global__ void probe_reads(const float* __restrict__ leaves,
                            const float* __restrict__ buf,
                            const int* __restrict__ idx, float* out, int K,
                            int R, int N, int GA, int S) {
  const int k = blockIdx.x;
  const size_t slab = (size_t)GA * S;
  const float* m1 = child_slab(leaves, buf, idx[k], idx[K + k], N, R, slab);
  const float* m2 =
      child_slab(leaves, buf, idx[2 * K + k], idx[3 * K + k], N, R, slab);
  float acc = 0.f;
  for (size_t i = threadIdx.x; i < slab; i += blockDim.x)
    acc += m1[i] + m2[i];
  out[(size_t)k * blockDim.x + threadIdx.x] = acc;
}

__global__ void probe_writes(float* buf, int R, int GA, int S, int outc) {
  const size_t slab = (size_t)GA * S;
  float* out = buf + ((size_t)blockIdx.x * R + outc) * slab;
  for (size_t i = threadIdx.x; i < slab; i += blockDim.x) out[i] = 1.f;
}

// both: the column as the children's product, element by element
// (contiguous) or a lane a site over NP planes, its loads first (the
// kernel's access pattern); CS: streaming (evict-first) stores
// (o, Sp: a separate output of rows padded to Sp sites, 128-byte aligned)
template <int NP, bool CS>
__global__ void probe_rw(const float* __restrict__ leaves,
                         const float* __restrict__ bin,
                         float* __restrict__ buf, const int* __restrict__ idx,
                         int K, int R, int N, int GA, int S, int outc,
                         float* __restrict__ o, int Sp) {
  const int k = blockIdx.x;
  const size_t slab = (size_t)GA * S;
  const float* m1 = child_slab(leaves, bin, idx[k], idx[K + k], N, R, slab);
  const float* m2 =
      child_slab(leaves, bin, idx[2 * K + k], idx[3 * K + k], N, R, slab);
  float* out = o ? o + (size_t)k * GA * Sp
                 : buf + ((size_t)k * R + outc) * slab;
  if (!o) Sp = S;
  if constexpr (NP == 0) {
    for (size_t i = threadIdx.x; i < slab; i += blockDim.x) {
      const float v = __ldg(m1 + i) * __ldg(m2 + i);
      if (CS) __stcs(out + i, v); else out[i] = v;
    }
  } else {
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      float a[NP], b[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        a[p] = __ldg(m1 + (size_t)p * S + s);
        b[p] = __ldg(m2 + (size_t)p * S + s);
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (CS) __stcs(out + (size_t)p * Sp + s, a[p] * b[p]);
        else out[(size_t)p * Sp + s] = a[p] * b[p];
      }
    }
  }
}

// kind 0: reads, 1: writes, 2 / 3: both contiguous (3 streaming stores),
// 4 / 5: both a lane a site (5 streaming stores), 6 / 7: 4 / 5 into rows
// padded to 32 sites (out: K GA Sp floats)
extern "C" int probe(const float* leaves, float* buf, const int* idx,
                     float* out, int K, int R, int N, int GA, int S,
                     int outc, int kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = kind >= 6 ? out : nullptr;
  const int Sp = (S + 31) / 32 * 32;
  if (kind >= 6) kind -= 2;
#define PHYLO_RW(NP, CS)                                                 \
  probe_rw<NP, CS><<<K, 256, 0, st>>>(leaves, buf, buf, idx, K, R, N, GA, \
                                      S, outc, o, Sp)
  if (kind == 0)
    probe_reads<<<K, 256, 0, st>>>(leaves, buf, idx, out, K, R, N, GA, S);
  else if (kind == 1)
    probe_writes<<<K, 256, 0, st>>>(buf, R, GA, S, outc);
  else if (kind == 2) PHYLO_RW(0, false);
  else if (kind == 3) PHYLO_RW(0, true);
#define PHYLO_RW_SITES(NP) \
  if (kind == 4) PHYLO_RW(NP, false); else PHYLO_RW(NP, true)
  else if (GA == 4) { PHYLO_RW_SITES(4); }
  else if (GA == 16) { PHYLO_RW_SITES(16); }
  else if (GA == 20) { PHYLO_RW_SITES(20); }
  return (int)cudaGetLastError();
}
"""


def shim_body(probes):
    """The shim's entries: form (NG, SPL) at A = 4 as fwd_<ng>_<spl>, and
    the probes."""
    out = [PROBES] if probes else []
    for ng, spl in FORMS:
        out.append(
            f'extern "C" int fwd_{ng}_{spl}({FWD_PTRS}, int K, int R, '
            "int N, int G, int S, int outc, int warps, void* stream) { "
            f"return launch_fwd_form<4, {spl}, {ng}>({FWD_CALL}, K, R, N, "
            "G, S, outc, warps, static_cast<cudaStream_t>(stream)); }\n")
    return "".join(out)


def patched_source(out_dir, name, subs):
    """A copy of csrc/rank_kernels.cu under out_dir/<name>/ with each
    (old, new, count) of subs replaced; returns its directory."""
    with open(os.path.join(_ext.CSRC, "rank_kernels.cu")) as fh:
        src = fh.read()
    for old, new, count in subs:
        if src.count(old) != count:
            raise RuntimeError(f"{name}: {old!r} occurs {src.count(old)} "
                               f"times in rank_kernels.cu, not {count}")
        src = src.replace(old, new)
    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "rank_kernels.cu"), "w") as fh:
        fh.write(src)
    return d


def shapes(gen, dev):
    """Yields (label, G, save, inputs) at phase 2's K1 / K10 shapes, one
    at a time (DS1's S = 1949 buffer alone is 6.6 GB); inputs as
    chip_smoke.rank_inputs returns them (buf, leaves, idx, outc, P_l, P_r,
    pi, w)."""
    G = cs.G_GAMMA
    yield "K1 S=256 save", 1, True, cs.rank_inputs(gen, cs.S_BATCH, dev)
    yield "K1 S=898", 1, False, cs.rank_inputs(gen, cs.S_FULL, dev)
    idx_b = cs.last_rank_idx(gen, dev, cs.S_BATCH, "hohna_data_1", "gtr+g4")
    for label, Gs, save in (("K10 G=4 S=256", G, False),
                            ("K10 G=4 S=256 save", G, True),
                            ("K10 G=5 S=256 save", G + 1, True)):
        yield label, Gs, save, cs.rank_inputs(gen, cs.S_BATCH, dev, Gs,
                                              idx_b)
    idx_f = cs.last_rank_idx(gen, dev, cs.S_DS1, "hohna_data_1", "gtr+g4")
    yield "K10 G=4 S=1949", G, False, cs.rank_inputs(gen, cs.S_DS1, dev, G,
                                                     idx_f)


def errors(got, want, col, col_want):
    """Phase 2's errors: the written column (col against col_want), the
    two sums and, saving, the children."""
    e = {"buf": cs.max_abs(col, col_want),
         "rootll": cs.max_rel(got[0], want[0]),
         "logscale": cs.max_rel(got[1], want[1])}
    if len(want) > 2:
        e["children"] = max(cs.max_abs(got[2], want[2]),
                            cs.max_abs(got[3], want[3]))
    return e


def check(label, e):
    for n, v in e.items():
        cs.require(v <= TOL[n], f"{label}: {n} error {v} > {TOL[n]}")


def launch_args(ins, G, save, dev):
    """(outputs, the pointer and int arguments of a launch but warps)."""
    buf, leaves, idx, outc, P_l, P_r, pi, w = ins
    K, R, GA, S = buf.shape
    sums = torch.empty((2, K), device=dev)
    kids = [torch.empty((K, GA, S), device=dev) for _ in range(2)] if save \
        else [None, None]
    ptrs = [leaves.data_ptr(), buf.data_ptr(), idx.data_ptr(),
            P_l.data_ptr(), P_r.data_ptr(), pi.data_ptr(), w.data_ptr(),
            sums[0].data_ptr(), sums[1].data_ptr(),
            *[None if t is None else t.data_ptr() for t in kids]]
    out = (sums[0], sums[1], *kids) if save else (sums[0], sums[1])
    return out, ptrs, (K, R, leaves.shape[0], G, S, outc)


def forms_of(libs, label, G, save, ins, dev):
    buf, leaves, idx, outc, P_l, P_r, pi, w = ins
    S = buf.shape[-1]
    b_p = buf.clone()
    want = kernels._fused_rank_ref(leaves, b_p, idx, outc, P_l, P_r, pi, w,
                                   save_children=save)
    plan = kernels.rank_fwd_plan(buf.shape[0], G, cs.A, S)
    forms = {}
    reg = kernels.fwd_blocks(G, cs.A)
    for ng, spl in FORMS:
        if ng != reg and (ng != 0 or G == 1):
            continue
        chunks = -(-S // (32 * spl))
        for var, (div, flip, _) in VARIANTS.items():
            fn = k7f.bind(libs[var], f"fwd_{ng}_{spl}", 11, 7)
            for warps in WARPS:
                if warps > chunks or kernels.rank_fwd_smem(
                        G, cs.A, warps, spl, ng) > kernels.SMEM_LIMIT:
                    continue

                def run(fn=fn, warps=warps):
                    out, ptrs, ints = launch_args(ins, G, save, dev)
                    _ext.check(fn(*ptrs, *ints, warps, _ext.stream_ptr(dev)),
                               "rank fwd form")
                    return out
                kind = ("reg" if ng else "staged") + (
                    "_div" if div else "_recip") + (
                    "_cs" if flip == (ng == 1) else "")
                forms[f"{kind}_spl{spl}_w{warps}"] = run
    forms["wrapper"] = lambda: kernels.fused_rank_update(
        leaves, buf, idx, outc, P_l, P_r, pi, w, save_children=save)
    errs = {}
    for n, f in forms.items():
        buf[:, outc] = float("nan")      # a site a form misses shows
        errs[n] = errors(f(), want, buf[:, outc], b_p[:, outc])
        check(f"{label} {n}", errs[n])
    probe = libs["lib"].probe
    probe.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    probe.restype = ctypes.c_int
    K, R, GA, _ = buf.shape
    # the reads probe's one float a thread; the padded rows' output
    scratch = torch.empty(max(K * 256, K * GA * (-(-S // 32) * 32)),
                          device=dev)
    for kind, name in enumerate(PROBE_NAMES):
        def run(kind=kind):
            _ext.check(probe(leaves.data_ptr(), buf.data_ptr(),
                             idx.data_ptr(), scratch.data_ptr(), K, R,
                             leaves.shape[0], GA, S, outc, kind,
                             _ext.stream_ptr(dev)), "probe")
        forms[name] = run
    n_leaf, n_int = cs.k1_slabs_read(idx, leaves.shape[0])
    names = list(forms)
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        ms[n].append(cs.time_ms(forms[n]))
    mean = {n: sum(v) / len(v) for n, v in ms.items()}
    kernels_only = [n for n in names if not n.startswith("probe")]
    best = min(kernels_only, key=lambda n: mean[n])
    slab = GA * S * 4
    print(json.dumps({
        "shape": label, "K": K, "G": G, "A": cs.A, "S": S, "save": save,
        "plan (spl, warps, chunks, blocks, smem)": plan,
        "child slabs read (leaf, internal)": [n_leaf, n_int],
        "l2_to_sm_bytes": 2 * K * slab, "dram_bytes_written":
            K * slab * (3 if save else 1),
        "max_err": {n: max(e.values()) for n, e in errs.items()},
        "ms": ms, "quickest": best,
        "gains_at_plan": _gains(mean, plan, G)}), flush=True)


def _gains(mean, plan, G):
    """At the plan's (spl, warps), the other option's ms over the launched
    form's (> 1: the launched choice is quicker): a division a plane in
    place of one reciprocal a site, and the other store kind (the library
    streams the column blocked, G > 1, and stores it plainly dense)."""
    spl, warps = plan[:2]
    kind = "reg" if kernels.fwd_blocks(G, cs.A) else "staged"
    cs_on, cs_off = ("_cs", "") if G > 1 else ("", "_cs")
    form = f"spl{spl}_w{warps}"
    new = mean.get(f"{kind}_recip{cs_on}_{form}")
    div = mean.get(f"{kind}_div{cs_on}_{form}")
    other = mean.get(f"{kind}_recip{cs_off}_{form}")
    return {"recip": div / new if new and div else None,
            "stores": other / new if new and other else None}


def parent_ab(lib, label, G, save, ins, dev):
    """The former K1 / K10 forward launch against fused_rank_update."""
    buf, leaves, idx, outc, P_l, P_r, pi, w = ins
    K, R, _, S = buf.shape
    Nd = leaves.shape[0]
    old = (k7f.bind(lib, "launch_fused_rank", 11, 6) if G == 1 else
           k7f.bind(lib, "launch_fused_rank_blocked", 11, 7))

    def former():
        out, ptrs, _ = launch_args(ins, G, save, dev)
        ints = (K, R, Nd, cs.A, S, outc) if G == 1 else \
            (K, R, Nd, G, cs.A, S, outc)
        _ext.check(old(*ptrs, *ints, _ext.stream_ptr(dev)), "former fwd")
        return out

    def new():
        return kernels.fused_rank_update(leaves, buf, idx, outc, P_l, P_r,
                                         pi, w, save_children=save)
    got_f = former()
    col_f = buf[:, outc].clone()
    buf[:, outc] = float("nan")
    got_n = new()
    e = errors(got_n, got_f, buf[:, outc], col_f)
    check(f"former vs new {label}", e)
    k7f.ab(label, {"K": K, "G": G, "S": S, "save": save,
                   "max_diff": max(e.values())}, former, new)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    out_dir = os.path.join(_ext.build_dir(), "k1_k10_forms")
    os.makedirs(out_dir, exist_ok=True)
    procs = {var: k7f.build("rank_kernels", shim_body(var == "lib"),
                            out_dir, patched_source(out_dir, var, subs), var)
             for var, (_, _, subs) in VARIANTS.items()}
    if args.parent:
        src = os.path.join(os.path.abspath(args.parent), "phylo_tpu_torch",
                           "csrc")
        procs["parent"] = k7f.build("rank_kernels", "", out_dir, src,
                                    "parent")
    _ext.build_all()
    libs, ptx = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
        ptx[name] = k7f.ptxas_summary(log, (
            "fused_rank_fwd_kernel", "fused_rank_kernel",
            "fused_rank_blocked_kernel", "probe_"))
    print(json.dumps({"ptxas": ptx}), flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for label, G, save, ins in shapes(gen, dev):
        forms_of(libs, label, G, save, ins, dev)
        if args.parent:
            parent_ab(libs["parent"], label, G, save, ins, dev)
        del ins
        torch.cuda.empty_cache()
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
