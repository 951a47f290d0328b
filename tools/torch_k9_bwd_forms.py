"""Time the forms of the port's two rank-backward bodies on one card.

* The wide body (K9bs, K9b, K11a above 8 states; csrc/wide_kernels.cu,
  `run_bwd<Gather, DPT, NST>`): chunks of 4 NST sites (NST = 4, 8, 16:
  16, 32, 64 sites), threads G ceil(A / 4) NST, DPT dP tiles a thread,
  and the cluster of 8, 4, 2 or 1 blocks a particle (1: one block
  walking all of a particle's chunks, the former grid).
* K3 blocked and K10's backward (csrc/rank_kernels.cu,
  `fused_rank_bwd_blocked_kernel<4, Gather, SPL, false>`, the blocked
  form): SPL = 1, 2, 4 sites a lane per chunk, warps a block up to 8
  (the plan) or 4.  The body's dense form (G = 1: K2, K3, K11a at A <=
  8) has its own tool, tools/torch_k7_forms.py.

A shim per source includes it and exports every form the shapes need;
nvcc builds both shims with -Xptxas -v, and the script prints each
kernel's registers and spills.  At each shape every form is held against
the plain version (phase 2's relative tolerance, 1e-4) and timed in the
order first..last, last..first (CUDA events behind a sleep kernel,
chip_smoke.py's `time_ms`), beside the launcher's own choice through the
wrapper.

Shapes: GY94 betacorona1 K=128, A=61 (K9bs at S=256, K9b at S=1086),
K11a at K=32, A=16, S=256, protein + Gamma4 (G=4, A=20) K9b blocked at
K=256 and K9bs blocked at K=64, S=256, on the child index of the last
rank of a real sweep; DS1 GTR+Gamma4 K=2048 (G=4 blocks of 4) at S=256
(K3 blocked and K10's backward) and S=1949 (K3 blocked).

    python tools/torch_k9_bwd_forms.py [--only wide|rank] [--clocks]

--clocks instead builds a copy of the wide body with clock64() stamps at
its phase boundaries (thread 0 of every block adds each phase's cycles
to a device counter) and prints the cycles a block spends per phase at
GY94's K9bs, K11a at 16 states and protein+G4's K9bs blocked, for
clusters of 8, 2 and 1 blocks a particle.  A phase's count runs from the
previous stamp, so with several chunks a block, "wait" also holds the
previous chunk's dP.

Needs a CUDA card and nvcc; prints one JSON line per shape, the ptxas
summary and the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from phylo_tpu_torch import _ext  # noqa: E402
from phylo_tpu_torch.pruning import kernels  # noqa: E402

PTRS = ("const float* m1, const float* m2, const float* leaves, "
        "const float* buf, const int* idx, const float* gm, "
        "const float* gr, const float* gl, const float* Pl, "
        "const float* Pr, const float* pi, const float* w, float* dm1, "
        "float* dm2, float* dPl, float* dPr, float* dpi_part, "
        "float* dw_part")
CALL = ("m1, m2, leaves, buf, idx, gm, gr, gl, Pl, Pr, pi, w, dm1, dm2, "
        "dPl, dPr, dpi_part, dw_part")
K3_SHIM = """
template <bool Gather, int SPL>
static int run_k3(%s, int K, int R, int N, int G, int S, int warps,
                  void* stream) {
  auto kernel = fused_rank_bwd_blocked_kernel<4, Gather, SPL, false>;
  const size_t smem = bwd_blocked_smem(G, 4, warps, SPL);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<K, 32 * warps, smem, st>>>(%s, K, R, N, G, S);
  return (int)cudaGetLastError();
}
""" % (PTRS, CALL)
K3_SPL = (1, 2, 4)
WIDE_NST = (4, 8, 16)


def build(name, body, exports, out_dir):
    """Start nvcc on a shim that includes csrc/<name>.cu and exports
    `exports` (C source lines); returns (the process, the library's
    path)."""
    src = os.path.join(_ext.CSRC, name + ".cu")
    shim = os.path.join(out_dir, name + "_forms.cu")
    with open(shim, "w") as fh:
        fh.write(f'#include "{src}"\n{body}\n' + "\n".join(exports) + "\n")
    so = os.path.join(out_dir, name + "_forms.so")
    return subprocess.Popen(
        [_ext._nvcc(), *_ext.NVCC_FLAGS, "-Xptxas", "-v", "-o", so, shim],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def ptxas_summary(log):
    """{mangled kernel: [registers, spill stores, spill loads (bytes)]} of
    the two rank-backward bodies, from nvcc -Xptxas -v."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = [None, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn][0] = int(m.group(1))
    return {k: v for k, v in out.items()
            if "fused_rank_bwd_blocked_kernel" in k
            or "wide_rank_bwd_kernel" in k}


def bind(lib, fn, n_int):
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def ptrs(gather, ins, outs):
    leaves, buf, idx, m1, m2, gm, gr, gl, P_l, P_r, pi, w = ins
    p = [t.data_ptr() for t in (m1, m2, leaves, buf, idx, gm, gr, gl, P_l,
                                P_r, pi, w, *outs)]
    if gather:
        p[0] = p[1] = None
    else:
        p[2] = p[3] = p[4] = None
    return p


def err(got, want):
    got, want = list(got), list(want)
    for i in (4, 5):
        got[i], want[i] = got[i].sum(0), want[i].sum(0)
    return max(cs.max_rel(a, b) for a, b in zip(got, want))


def time_forms(label, forms, ref, picked, meta):
    """forms: {name: fn() -> outputs}; ref: the plain outputs."""
    errs = {n: err(fn(), ref) for n, fn in forms.items()}
    for n, e in errs.items():
        cs.require(e <= 1e-4, f"{label} form {n}: relative error {e}")
    names = list(forms)
    ms = {n: [] for n in names + ["launcher"]}
    for n in names + names[::-1]:
        ms[n].append(cs.time_ms(forms[n], iters=20))
    ms["launcher"].append(cs.time_ms(picked, iters=20))
    print(json.dumps({"shape": label, **meta, "max_rel_err": errs,
                      "ms": ms}), flush=True)


def wide_shapes(gen, dev):
    """(label, gather, Kd, G, A_, S, Nd, ins)."""
    out = []
    cs.protein_files()
    for label, gather, Kd, S in (("GY94 K9bs", 0, cs.K_CODON, cs.S_BATCH),
                                 ("GY94 K9b", 1, cs.K_CODON, cs.S_CODON)):
        idx = cs.last_rank_idx(gen, dev, S, "betacorona1", "gy94", Kd,
                               codons=True)
        out.append((label, gather, Kd, 1, cs.A_CODON, S, cs.N_CODON, idx))
    for label, gather, Kd in (("protein K9b blocked", 1, cs.K_PROT),
                              ("protein K9bs blocked", 0, cs.K_PROT_SAVED)):
        idx = cs.last_rank_idx(gen, dev, cs.S_BATCH, cs.PROT_FASTA,
                               "reference+g4", Kd)
        out.append((label, gather, Kd, 4, cs.A_PROT, cs.S_BATCH, cs.N_PROT,
                    idx))
    out.append(("K11a A=16", 0, cs.K_TWIST, 1, 16, cs.S_BATCH, 4,
                cs.small_idx(gen, dev, cs.K_TWIST, 4, 3)))
    return out


def wide_inputs(gen, dev, shape):
    label, gather, Kd, G, A_, S, Nd, idx = shape
    leaves, buf, idx, P_l, P_r, pi, w = cs.wide_inputs(gen, dev, S, idx, Kd,
                                                       Nd, A_, G=G)
    m1, m2 = (t.contiguous() for t in kernels.gather_children(
        leaves, buf, idx))
    cts = cs.bwd_cotangents(gen, dev, Kd, G * A_, S)
    return (leaves, buf, idx, m1, m2, *cts, P_l, P_r, pi, w)


CLOCK_PHASES = (
    # (name, anchor in wide_kernels.cu, stamp before or after it)
    ("prologue", "    const int c0 = c * SC;\n", "after"),
    ("wait", "    const float* x1 = smem + L.x1;\n", "before"),
    ("uv", "    // (3) one thread a site: the warps' partials in warp order",
     "before"),
    ("combine", "    // (4) du over the cotangent tile, dv, and the dpi sums",
     "before"),
    ("dudv", "    // (5) dm1 = P_l du, dm2 = P_r dv (b ascending), to global",
     "before"),
    ("dm", "    // dP_l[g, a, b] += sum_s x1[a, s] du[b, s]; dP_r with x2, dv",
     "before"),
    ("dP", "  // the block's dP and dpi row in shared memory (P's region is",
     "before"),
    ("stage", "  cluster.sync();                       // every rank's row",
     "before"),
    ("cluster sync", "  // rank r sums its slice of float4 groups of every",
     "before"),
    ("dsmem sum", "  cluster.sync();                       // no rank leaves",
     "before"))


def clock_source():
    """wide_kernels.cu with a stamp at each of CLOCK_PHASES' anchors (the
    prologue's only in a block's first chunk) and a reader."""
    with open(os.path.join(_ext.CSRC, "wide_kernels.cu")) as fh:
        s = fh.read()
    s = s.replace("namespace {\n", "__device__ unsigned long long "
                  "g_clk[16];\nnamespace {\n", 1)
    head = "  const int lane = tid & 31, warp = tid >> 5;\n"
    assert head in s
    s = s.replace(head, head + (
        "  long long t_prev = clock64();\n"
        "#define STAMP(i) do { if (tid == 0) { const long long t_ = "
        "clock64(); atomicAdd(&g_clk[i], (unsigned long long)(t_ - "
        "t_prev)); t_prev = t_; } } while (0)\n"
        "  if (tid == 0) atomicAdd(&g_clk[15], 1ull);\n"), 1)
    for i, (_, anchor, where) in enumerate(CLOCK_PHASES):
        assert anchor in s, anchor
        stamp = f"STAMP({i});\n"
        if i == 0:
            stamp = f"if (c == r) STAMP({i});\n"
        s = s.replace(anchor, anchor + stamp if where == "after"
                      else stamp + anchor, 1)
    end = "  cluster.sync();                       // no rank leaves while read\n"
    s = s.replace(end, end + f"  STAMP({len(CLOCK_PHASES)});\n", 1)
    return s + """
extern "C" int read_clocks(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_clk, sizeof(unsigned long long) * 16);
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(g_clk, z, sizeof(unsigned long long) * 16);
  return (int)cudaGetLastError();
}
"""


def phase_clocks(dev, out_dir):
    src = os.path.join(out_dir, "wide_clocks.cu")
    with open(src, "w") as fh:
        fh.write(clock_source())
    so = os.path.join(out_dir, "wide_clocks.so")
    subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", so, src],
                   check=True)
    lib = ctypes.CDLL(so)
    launch = lib.launch_wide_rank_bwd_saved
    launch.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    read = lib.read_clocks
    read.argtypes = [ctypes.c_void_p]
    names = [n for n, _, _ in CLOCK_PHASES] + ["second cluster sync"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for label, Kd, G, A_, Nd in (("GY94 K9bs", cs.K_CODON, 1, cs.A_CODON,
                                  cs.N_CODON),
                                 ("K11a A=16", cs.K_TWIST, 1, 16, 4),
                                 ("protein K9bs blocked", cs.K_PROT_SAVED,
                                  4, cs.A_PROT, cs.N_PROT)):
        S = cs.S_BATCH
        idx = cs.small_idx(gen, dev, Kd, Nd, Nd - 1)
        leaves, buf, idx, P_l, P_r, pi, w = cs.wide_inputs(gen, dev, S, idx,
                                                           Kd, Nd, A_, G=G)
        m1, m2 = (t.contiguous() for t in kernels.gather_children(
            leaves, buf, idx))
        cts = cs.bwd_cotangents(gen, dev, Kd, G * A_, S)
        for cap in (8, 2, 1):
            sc, _, threads, dpt, _, _ = kernels.wide_bwd_plan(Kd, G, A_, S)
            cl = min(cap, -(-S // sc))         # not the plan's one wave
            outs = kernels._bwd_outputs(Kd, G * A_, S, P_l.shape, dev, Kd)
            p = [t.data_ptr() for t in (m1, m2, *cts, P_l, P_r, pi, w,
                                        *outs)]
            clk = (ctypes.c_ulonglong * 16)()
            _ext.check(launch(*p, Kd, G, A_, S, sc, cl, threads, dpt,
                              _ext.stream_ptr(dev)), "clocks")
            torch.cuda.synchronize()
            read(clk)                              # clear after a warm-up
            _ext.check(launch(*p, Kd, G, A_, S, sc, cl, threads, dpt,
                              _ext.stream_ptr(dev)), "clocks")
            torch.cuda.synchronize()
            read(clk)
            nb = clk[15]
            print(json.dumps({"shape": label, "K": Kd, "cluster": cl,
                              "chunks_a_block": -(-(-(-S // sc)) // cl),
                              "kcycles_a_block": {
                                  n: round(clk[i] / nb / 1e3, 2)
                                  for i, n in enumerate(names)}}),
                  flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("wide", "rank"), default=None)
    ap.add_argument("--clocks", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    _ext.build_all()
    if args.clocks:
        out_dir = os.path.join(_ext.build_dir(), "forms")
        os.makedirs(out_dir, exist_ok=True)
        phase_clocks(dev, out_dir)
        print(cs.card_line())
        return 0
    out_dir = os.path.join(_ext.build_dir(), "forms")
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # the forms each shape needs, then both shims built at once
    wshapes = wide_shapes(gen, dev) if args.only != "rank" else []
    wforms = {}
    for sh in wshapes:
        _, gather, Kd, G, A_, S, _, _ = sh
        for nst in WIDE_NST:
            _, _, threads, dpt, _, smem = kernels.wide_bwd_plan(
                Kd, G, A_, S, nst)
            if threads <= kernels._wide_max_threads(nst) and \
                    smem <= kernels.SMEM_LIMIT:
                wforms[gather, nst, dpt] = None
    wexp = [f'extern "C" int k9_{g}_{n}_{d}({PTRS}, int K, int R, int N, '
            f'int G, int A, int S, int cluster, int threads, void* stream) '
            f'{{ return run_bwd<{"true" if g else "false"}, {d}, {n}>('
            f'{CALL}, K, R, N, G, A, S, cluster, threads, '
            f'static_cast<cudaStream_t>(stream)); }}'
            for g, n, d in wforms]
    kexp = [f'extern "C" int k3_{g}_{spl}({PTRS}, int K, int R, int N, '
            f'int G, int S, int warps, void* stream) {{ return '
            f'run_k3<{"true" if g else "false"}, {spl}>({CALL}, K, R, N, G, '
            f'S, warps, stream); }}' for g in (0, 1) for spl in K3_SPL]
    procs = {}
    if wexp:
        procs["wide"] = build("wide_kernels", "", wexp, out_dir)
    if args.only != "wide":
        procs["rank"] = build("rank_kernels", K3_SHIM, kexp, out_dir)
    libs, ptx = {}, {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {key} shim:\n{log}")
        libs[key] = ctypes.CDLL(so)
        ptx.update(ptxas_summary(log))
    print(json.dumps({"ptxas": ptx}), flush=True)

    for sh in wshapes:
        label, gather, Kd, G, A_, S, Nd, _ = sh
        ins = wide_inputs(gen, dev, sh)
        leaves, buf, idx, m1, m2, gm, gr, gl, P_l, P_r, pi, w = ins
        R = buf.shape[1]
        lib_args = ((leaves, buf, idx) if gather else (m1, m2)) + (
            gm, gr, gl, P_l, P_r, pi, w)
        wrapper = kernels.fused_rank_bwd if gather else \
            kernels.fused_rank_bwd_saved
        ref = (kernels._fused_rank_bwd_ref if gather else
               kernels._fused_rank_bwd_saved_ref)(*lib_args)
        forms = {}
        for nst in WIDE_NST:
            _, _, threads, dpt, _, _ = kernels.wide_bwd_plan(Kd, G, A_, S,
                                                             nst)
            if (gather, nst, dpt) not in wforms:
                continue
            fn = bind(libs["wide"], f"k9_{gather}_{nst}_{dpt}", 8)
            for cl in sorted({min(c, -(-S // (4 * nst))) for c in (8, 4, 2,
                                                                   1)}):
                def run(fn=fn, cl=cl, threads=threads):
                    outs = kernels._bwd_outputs(Kd, G * A_, S, P_l.shape,
                                                dev, Kd)
                    _ext.check(fn(*ptrs(gather, ins, outs), Kd, R, Nd, G,
                                  A_, S, cl, threads,
                                  _ext.stream_ptr(dev)), "form")
                    return outs
                forms[f"sc{4 * nst}_c{cl}"] = run
        plan = kernels.wide_bwd_plan(Kd, G, A_, S)
        time_forms(label, forms, ref, lambda: wrapper(*lib_args),
                   {"K": Kd, "G": G, "A": A_, "S": S,
                    "plan (sc, cluster, threads, dpt, blocks, smem)": plan})

    if args.only != "wide":
        for label, gather, S in (("DS1 K10 bwd-saved", 0, cs.S_BATCH),
                                 ("DS1 K3 blocked", 1, cs.S_BATCH),
                                 ("DS1 K3 blocked", 1, cs.S_DS1)):
            idx = cs.last_rank_idx(gen, dev, S, "hohna_data_1", "gtr+g4")
            buf, leaves, idx, _, P_l, P_r, pi, w = cs.rank_inputs(
                gen, S, dev, cs.G_GAMMA, idx)
            m1, m2 = (t.contiguous() for t in kernels.gather_children(
                leaves, buf, idx))
            cts = cs.bwd_cotangents(gen, dev, cs.K, cs.G_GAMMA * cs.A, S)
            ins = (leaves, buf, idx, m1, m2, *cts, P_l, P_r, pi, w)
            lib_args = ((leaves, buf, idx) if gather else (m1, m2)) + (
                *cts, P_l, P_r, pi, w)
            wrapper = kernels.fused_rank_bwd if gather else \
                kernels.fused_rank_bwd_saved
            ref = (kernels._fused_rank_bwd_ref if gather else
                   kernels._fused_rank_bwd_saved_ref)(*lib_args)
            R, Nd = buf.shape[1], leaves.shape[0]
            forms = {}
            for spl in K3_SPL:
                fn = bind(libs["rank"], f"k3_{gather}_{spl}", 6)
                for cap in (8, 4):
                    _, warps, _, _, _ = kernels.rank_bwd_plan(
                        cs.K, cs.G_GAMMA, cs.A, S, spl, cap)

                    def run(fn=fn, warps=warps):
                        outs = kernels._bwd_outputs(
                            cs.K, cs.G_GAMMA * cs.A, S, P_l.shape, dev, cs.K)
                        _ext.check(fn(*ptrs(gather, ins, outs), cs.K, R, Nd,
                                      cs.G_GAMMA, S, warps,
                                      _ext.stream_ptr(dev)), "form")
                        return outs
                    forms[f"spl{spl}_w{warps}"] = run
            plan = kernels.rank_bwd_plan(cs.K, cs.G_GAMMA, cs.A, S)
            time_forms(label, forms, ref, lambda: wrapper(*lib_args),
                       {"K": cs.K, "G": cs.G_GAMMA, "A": cs.A, "S": S,
                        "plan (spl, warps, chunks, blocks, smem)": plan})
            del ins, buf, leaves, m1, m2, ref
            torch.cuda.empty_cache()
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
