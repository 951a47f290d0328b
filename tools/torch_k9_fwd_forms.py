"""Time the forms of the wide rank forward K9f and of K5 on one card.

* K9f (csrc/wide_kernels.cu, `run_fwd<TS, NST, MINB>`): tiles of TS = 4
  or 8 sites a thread (4 planes x TS), chunks of SC = TS NST sites (16
  to 128), the launch bound's MINB = 2 or 3 blocks of 256 threads an SM
  (at most 128 or 85 registers a thread), and a cluster of 1, 2, 4 or 8
  blocks a particle.  The launcher runs TS = 4, MINB = 2 and the chunk
  and cluster of `wide_fwd_plan`.
* K5 (csrc/resample_kernels.cu, `categorical_kernel`): one block of 128,
  256, 512 or 1024 threads at K = 2048 (the launcher: 1024), 32 at K = 32.

A shim per source includes it and exports every form; nvcc builds both
with -Xptxas -v, and the script prints each kernel's registers and
spills.  At each shape every K9f form is held against the plain version
(chip_smoke.py's tolerances: the written column 1e-5 absolute, rootll
and logscale 1e-5 relative, saved children exact) and every K5 form
against the launcher's draws (exact), and all are timed in the order
first..last, last..first (CUDA events behind a sleep kernel,
chip_smoke.py's `time_ms`), beside the launcher's own pick through the
wrapper.

K9f's shapes, on the child index of the last rank of a real sweep: GY94
betacorona1 K=128, A=61 at S=256 (saving the children, the SGD step) and
S=1086 (the eval sweep); protein + Gamma4 (G=4, A=20) K=256 at S=256 and
500, and the .dat path's K=64 at S=256 saving.

    python tools/torch_k9_fwd_forms.py [--clocks] [--parent DIR]

--clocks instead builds a copy of K9f with clock64() stamps at its phase
boundaries (thread 0 of every block adds each phase's cycles to a device
counter) and prints the cycles a block spends per phase at the plan's
forms and at clusters of 1 and 2, GY94 S=256 and 1086, protein K=256.
A phase runs from the previous stamp: "wait" holds the prologue (P, pi,
the first chunk) in a block's first chunk and the previous chunk's write
after it.

--parent DIR (a checkout of the commit before this redesign, e.g. from
git archive) instead builds that checkout's K9f and K5 and times them
against this tree's wrappers at the main shapes in turns former, new,
new, former: the former K9f with the torch.sum of its per-tile partial
rows (its wrapper's second launch), the former K5 (the (K, K) Gumbel
field) alone.

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
from phylo_tpu_torch.smc import resample_kernel as rk  # noqa: E402

# (TS, NST, MINB) of the K9f forms
FWD_FORMS = [(4, 4, 2), (4, 8, 2), (4, 16, 2), (4, 4, 3), (4, 8, 3),
             (4, 16, 3), (8, 4, 2), (8, 8, 2), (8, 16, 2)]
CLUSTERS = (1, 2, 4, 8)
K5_THREADS = (128, 256, 512, 1024)
FWD_ARGS = ("const float* leaves, float* buf, const int* idx, "
            "const float* Pl, const float* Pr, const float* pi, "
            "const float* w, float* rootll, float* logscale, float* c1, "
            "float* c2, int K, int R, int N, int G, int A, int S, int outc, "
            "int cluster, int threads, void* stream")
FWD_CALL = ("leaves, buf, idx, Pl, Pr, pi, w, rootll, logscale, c1, c2, K, "
            "R, N, G, A, S, outc, cluster, threads, "
            "static_cast<cudaStream_t>(stream)")
K5_EXPORT = """
extern "C" int k5_form(const float* logits, const long long* seed, int* out,
                       int K, int E, int threads, void* stream) {
  categorical_kernel<<<1, threads, (size_t)K * sizeof(long long),
                       static_cast<cudaStream_t>(stream)>>>(
      logits, seed, out, nullptr, K, E);
  return (int)cudaGetLastError();
}
"""


def build(out_dir):
    """Start nvcc -Xptxas -v on both shims; returns {name: (process,
    library path)}."""
    procs = {}
    fwd = "".join(
        f'extern "C" int fwd_{t}_{n}_{m}({FWD_ARGS}) {{ return '
        f"run_fwd<{t}, {n}, {m}>({FWD_CALL}); }}\n"
        for t, n, m in FWD_FORMS)
    for name, body in (("wide_kernels", fwd),
                       ("resample_kernels", K5_EXPORT)):
        shim = os.path.join(out_dir, name + "_fwd_forms.cu")
        with open(shim, "w") as fh:
            fh.write(f'#include "{os.path.join(_ext.CSRC, name + ".cu")}"'
                     f"\n{body}")
        so = os.path.join(out_dir, name + "_fwd_forms.so")
        procs[name] = (subprocess.Popen(
            [_ext._nvcc(), *_ext.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
             shim], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    return procs


def ptxas_summary(log):
    """{mangled kernel: [registers, spill stores, spill loads (bytes)]}."""
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
            if "wide_rank_fwd_kernel" in k or "categorical_kernel" in k}


def bind(lib, fn, n_ptr, n_int):
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def shapes(gen, dev):
    """(label, Kd, G, A_, S, Nd, save, idx)."""
    cs.protein_files()
    out = []
    for S, save in ((cs.S_BATCH, True), (cs.S_CODON, False)):
        idx = cs.last_rank_idx(gen, dev, S, "betacorona1", "gy94",
                               cs.K_CODON, codons=True)
        out.append(("GY94 K9f", cs.K_CODON, 1, cs.A_CODON, S, cs.N_CODON,
                    save, idx))
    for Kd, S, save in ((cs.K_PROT, cs.S_BATCH, False),
                        (cs.K_PROT, cs.S_PROT, False),
                        (cs.K_PROT_SAVED, cs.S_BATCH, True)):
        idx = cs.last_rank_idx(gen, dev, S, cs.PROT_FASTA, "reference+g4",
                               Kd)
        out.append(("protein K9f blocked", Kd, cs.G_GAMMA, cs.A_PROT, S,
                    cs.N_PROT, save, idx))
    return out


def time_forms(meta, forms, picked):
    """Time forms {name: fn} in turns and the launcher's pick; print."""
    names = list(forms)
    ms = {n: [] for n in names + ["launcher"]}
    for n in names + names[::-1]:
        ms[n].append(cs.time_ms(forms[n], iters=20))
    ms["launcher"].append(cs.time_ms(picked))
    print(json.dumps({**meta, "ms": ms}), flush=True)


def fwd_forms(lib, gen, dev):
    for label, Kd, G, A_, S, Nd, save, idx in shapes(gen, dev):
        leaves, buf, idx, P_l, P_r, pi, w = cs.wide_inputs(gen, dev, S, idx,
                                                           Kd, Nd, A_, G=G)
        R, GA, outc = buf.shape[1], G * A_, buf.shape[1] - 1
        b_ref = buf.clone()
        ref = kernels._fused_rank_ref(leaves, b_ref, idx, outc, P_l, P_r, pi,
                                      w, save_children=save)
        forms = {}
        for ts, nst, minb in FWD_FORMS:
            sc = ts * nst
            try:
                threads = kernels.wide_fwd_plan(Kd, G, A_, S, sc=sc,
                                                ts=ts)[2]
            except ValueError:
                continue
            fn = bind(lib, f"fwd_{ts}_{nst}_{minb}", 11, 9)
            for cl in sorted({min(c, -(-S // sc)) for c in CLUSTERS}):
                def run(fn=fn, cl=cl, threads=threads):
                    sums = torch.empty((2, Kd), dtype=torch.float32,
                                       device=dev)
                    kids = [torch.empty((Kd, GA, S), dtype=torch.float32,
                                        device=dev) for _ in range(2)]
                    ptrs = [t.data_ptr() for t in (
                        leaves, buf, idx, P_l, P_r, pi, w, sums[0],
                        sums[1])] + [k.data_ptr() if save else None
                                     for k in kids]
                    _ext.check(fn(*ptrs, Kd, R, Nd, G, A_, S, outc, cl,
                                  threads, _ext.stream_ptr(dev)), "form")
                    return (sums[0], sums[1]) + (tuple(kids) if save
                                                 else ())
                forms[f"ts{ts}_sc{sc}_b{minb}_c{cl}"] = run
        errs = {}
        for name, fn in forms.items():
            got = fn()
            torch.cuda.synchronize()
            e = {"buf": cs.max_abs(buf[:, outc], b_ref[:, outc]),
                 "rootll": cs.max_rel(got[0], ref[0]),
                 "logscale": cs.max_rel(got[1], ref[1])}
            if save:
                e["children"] = max(cs.max_abs(got[2], ref[2]),
                                    cs.max_abs(got[3], ref[3]))
            cs.require(max(e["buf"], e["rootll"], e["logscale"]) <= 1e-5
                       and e.get("children", 0.0) == 0.0,
                       f"{label} form {name}: {e}")
            errs[name] = max(e.values())
        time_forms({"shape": label, "K": Kd, "G": G, "A": A_, "S": S,
                    "save": save,
                    "plan (sc, cluster, threads, blocks, smem)":
                        kernels.wide_fwd_plan(Kd, G, A_, S),
                    "max_err": errs}, forms,
                   lambda: kernels.fused_rank_update(
                       leaves, buf, idx, outc, P_l, P_r, pi, w,
                       save_children=save))
        del leaves, buf, b_ref, ref, forms
        torch.cuda.empty_cache()


def k5_forms(lib, gen, dev):
    fn = bind(lib, "k5_form", 3, 3)
    for Kd in (cs.K, cs.K_TWIST):
        logits = torch.randn((Kd,), generator=gen, device=dev) * 2.0
        logits[3::13] = -float("inf")
        seed = rk.draw_seed(gen, dev)
        want = rk.categorical(logits, seed)
        forms = {}
        for threads in (K5_THREADS if Kd > 32 else (32,)):
            def run(threads=threads):
                out = torch.empty((Kd,), dtype=torch.int32, device=dev)
                _ext.check(fn(logits.data_ptr(), seed.data_ptr(),
                              out.data_ptr(), Kd, rk.cdf_bits(Kd), threads,
                              _ext.stream_ptr(dev)), "k5 form")
                return out
            cs.require(bool(torch.equal(run(), want)),
                       f"K5 form of {threads} threads draws otherwise")
            forms[f"threads{threads}"] = run
        time_forms({"shape": "K5", "K": Kd}, forms,
                   lambda: rk.categorical(logits, seed))


CLOCK_PHASES = (
    # (name, anchor in wide_kernels.cu's K9f, stamp before or after it)
    ("wait", "    __syncthreads();                    // (1) the chunk's "
             "tiles are in\n", "after"),
    ("uv", "    // over the warp's plane tiles of one site tile: lanes st + "
           "NST q\n", "before"),
    ("combine", "    __syncthreads();                    // (3) the chunk's "
                "scales are in\n", "after"),
    ("write", "  }\n\n  // the block's sums: lanes by shuffles", "before"),
    ("block sums", "  cluster.sync();                       // every rank's "
                   "sums are staged\n", "before"),
    ("cluster", "  cluster.sync();                       // no rank leaves "
                "while it is read\n", "after"))


def clock_source():
    """wide_kernels.cu with a stamp at each of CLOCK_PHASES' anchors in
    K9f and a reader."""
    with open(os.path.join(_ext.CSRC, "wide_kernels.cu")) as fh:
        s = fh.read()
    s = s.replace("namespace {\n", "__device__ unsigned long long "
                  "g_clk[16];\nnamespace {\n", 1)
    head = "  const int lane = tid & 31, wid = tid >> 5;\n"
    assert s.count(head) == 1
    s = s.replace(head, head + (
        "  long long t_prev = clock64();\n"
        "#define STAMP(i) do { if (tid == 0) { const long long t_ = "
        "clock64(); atomicAdd(&g_clk[i], (unsigned long long)(t_ - "
        "t_prev)); t_prev = t_; } } while (0)\n"
        "  if (tid == 0) atomicAdd(&g_clk[15], 1ull);\n"))
    for i, (_, anchor, where) in enumerate(CLOCK_PHASES):
        assert s.count(anchor) == 1, anchor
        stamp = f"STAMP({i});\n"
        if where == "before" and anchor.startswith("  }"):
            stamp = f"    STAMP({i});\n"
            s = s.replace(anchor, stamp + anchor)
            continue
        s = s.replace(anchor, anchor + stamp if where == "after"
                      else stamp + anchor)
    fwd = "".join(
        f'extern "C" int fwd_4_{n}_2({FWD_ARGS}) {{ return '
        f"run_fwd<4, {n}, 2>({FWD_CALL}); }}\n" for n in (2, 4, 8, 16))
    return s + fwd + """
extern "C" int read_clocks(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_clk, sizeof(unsigned long long) * 16);
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(g_clk, z, sizeof(unsigned long long) * 16);
  return (int)cudaGetLastError();
}
"""


def phase_clocks(dev, out_dir):
    src = os.path.join(out_dir, "wide_fwd_clocks.cu")
    with open(src, "w") as fh:
        fh.write(clock_source())
    so = os.path.join(out_dir, "wide_fwd_clocks.so")
    subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", so, src],
                   check=True)
    lib = ctypes.CDLL(so)
    read = lib.read_clocks
    read.argtypes = [ctypes.c_void_p]
    names = [n for n, _, _ in CLOCK_PHASES]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for label, Kd, G, A_, S, Nd, save, idx in shapes(gen, dev)[:4]:
        leaves, buf, idx, P_l, P_r, pi, w = cs.wide_inputs(gen, dev, S, idx,
                                                           Kd, Nd, A_, G=G)
        R, GA, outc = buf.shape[1], G * A_, buf.shape[1] - 1
        sc, plan_c, threads, _, _ = kernels.wide_fwd_plan(Kd, G, A_, S)
        fn = bind(lib, f"fwd_4_{sc // 4}_2", 11, 9)
        sums = torch.empty((2, Kd), dtype=torch.float32, device=dev)
        kids = [torch.empty((Kd, GA, S), dtype=torch.float32, device=dev)
                for _ in range(2)]
        ptrs = [t.data_ptr() for t in (leaves, buf, idx, P_l, P_r, pi, w,
                                       sums[0], sums[1])] + [
            k.data_ptr() if save else None for k in kids]
        for cl in sorted({plan_c, 1, 2}):
            clk = (ctypes.c_ulonglong * 16)()
            for _ in range(2):                 # a warm-up, then the reading
                read(clk)
                _ext.check(fn(*ptrs, Kd, R, Nd, G, A_, S, outc, cl, threads,
                              _ext.stream_ptr(dev)), "clocks")
                torch.cuda.synchronize()
            read(clk)
            nb = clk[15]
            print(json.dumps({"shape": label, "K": Kd, "S": S, "sc": sc,
                              "cluster": cl, "plan": cl == plan_c,
                              "chunks_a_block": -(-(-(-S // sc)) // cl),
                              "kcycles_a_block": {
                                  n: round(clk[i] / nb / 1e3, 2)
                                  for i, n in enumerate(names)}}),
                  flush=True)


def parent_ab(dev, out_dir, parent):
    """The parent checkout's K9f (+ its torch.sum) and K5 against this
    tree's wrappers, in turns former, new, new, former."""
    libs = {}
    procs = {}
    for name in ("wide_kernels", "resample_kernels"):
        so = os.path.join(out_dir, f"parent_{name}.so")
        procs[name] = (subprocess.Popen(
            [_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", so, os.path.join(
                parent, "phylo_tpu_torch", "csrc", name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    old_k9 = bind(libs["wide_kernels"], "launch_wide_rank", 11, 7)
    old_k5 = bind(libs["resample_kernels"], "launch_categorical", 3, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for label, Kd, G, A_, S, Nd, save, idx in shapes(gen, dev)[:4]:
        leaves, buf, idx, P_l, P_r, pi, w = cs.wide_inputs(gen, dev, S, idx,
                                                           Kd, Nd, A_, G=G)
        R, GA, outc = buf.shape[1], G * A_, buf.shape[1] - 1
        T = -(-S // 32)

        def former(save=save):
            part = torch.empty((2, Kd, T), dtype=torch.float32, device=dev)
            kids = [torch.empty((Kd, GA, S), dtype=torch.float32, device=dev)
                    for _ in range(2)] if save else [None, None]
            ptrs = [t.data_ptr() for t in (leaves, buf, idx, P_l, P_r, pi, w,
                                           part[0], part[1])] + [
                k.data_ptr() if save else None for k in kids]
            _ext.check(old_k9(*ptrs, Kd, R, Nd, G, A_, S, outc,
                              _ext.stream_ptr(dev)), "former K9f")
            return torch.sum(part, dim=2)

        def new(save=save):
            return kernels.fused_rank_update(leaves, buf, idx, outc, P_l,
                                             P_r, pi, w, save_children=save)
        a, b = former(), new()
        cs.require(cs.max_rel(a[0], b[0]) <= 1e-5, f"{label}: rootll")
        ab(f"{label} save={save}", {"K": Kd, "G": G, "A": A_, "S": S},
           former, new)
    for Kd in (cs.K, cs.K_TWIST):
        logits = torch.randn((Kd,), generator=gen, device=dev) * 2.0
        seed = rk.draw_seed(gen, dev)

        def former():
            out = torch.empty((Kd,), dtype=torch.int32, device=dev)
            _ext.check(old_k5(logits.data_ptr(), seed.data_ptr(),
                              out.data_ptr(), Kd, _ext.stream_ptr(dev)),
                       "former K5")
            return out
        ab("K5", {"K": Kd}, former, lambda: rk.categorical(logits, seed))


def ab(label, meta, former, new):
    ms = {"former": [], "new": []}
    for name in ("former", "new", "new", "former"):
        ms[name].append(cs.time_ms(former if name == "former" else new))
    print(json.dumps({"shape": label, **meta, "ms": ms}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--parent", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    _ext.build_all()
    out_dir = os.path.join(_ext.build_dir(), "forms")
    os.makedirs(out_dir, exist_ok=True)
    if args.clocks or args.parent:
        if args.clocks:
            phase_clocks(dev, out_dir)
        if args.parent:
            parent_ab(dev, out_dir, args.parent)
        print(cs.card_line())
        return 0
    libs, ptx = {}, {}
    for name, (proc, so) in build(out_dir).items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} shim:\n{log}")
        libs[name] = ctypes.CDLL(so)
        ptx.update(ptxas_summary(log))
    print(json.dumps({"ptxas": ptx}), flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k5_forms(libs["resample_kernels"], gen, dev)
    fwd_forms(libs["wide_kernels"], gen, dev)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
