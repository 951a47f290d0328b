"""Time the forms of K7 and of the rank backward's dense form on one card.

* K7, the DNA twist pair-loglik backward (csrc/twist_kernels.cu,
  `pair_ll_bwd_narrow_kernel<A, SPL, MINB>`): SPL = 1, 2 or 4 sites a
  lane and every warp count from 1 to the row's chunks (at most 8), and
  at the plan's warps the launch bound's MINB = 2 or 3 blocks of 256
  threads an SM (at most 128 or 85 registers a thread), beside the
  launcher's pick (`twist_narrow_plan`) and K7 wide
  (csrc/twist_wide_kernels.cu, `launch_pair_ll_bwd_wide`) at G = 1, A_b
  = 4 with its own plan, a candidate route for DNA.  Shapes: primate's
  twist at M = 10, rank 0 (KC = 2112) at S = 256 and the ragged S = 300,
  KC = 480 (6 taxa left) and the last rank (KC = 32).
* The rank backward (csrc/rank_kernels.cu,
  `fused_rank_bwd_blocked_kernel<4, Gather, SPL, Dense>`): the dense form
  at SPL = 1, 2, 4 and 8, 4 or 2 warps, and the blocked form at G = 1
  (staged chunks, the merge recomputed in pass 2), each writing dw;
  beside the wrapper with and without dw (want_dw).  Shapes: K2 and K3
  at primate K = 2048, S = 256 and 898 (the child index of the last rank
  of a real sweep), K11a at K = 32, S = 256.

A shim per source includes it and exports what the launchers do not;
nvcc builds both with -Xptxas -v, and the script prints each kernel's
registers and spills.  Every form is held against the plain version
(phase 2's 1e-4 relative) and timed in turns first..last, last..first
(CUDA events behind a sleep kernel, chip_smoke.py's `time_ms`), beside
the launcher's own pick through the wrapper.

    python tools/torch_k7_forms.py [--parent DIR]

--parent DIR (a checkout of the commit before this redesign, e.g. from
git archive) also builds that checkout's twist_kernels.cu and
rank_kernels.cu and times their K7 (a 128-thread block a row) and dense
rank backward (8 particles a block) against this tree's wrappers, in
turns former, new, new, former, at the shapes above (K11a with its
wrapper's two sums, as merge_bwd runs it, and the new one also without
dw).

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

TOL = 1e-4
K7_SPL = (1, 2, 4)
# (KC, S) of primate's twist at M = 10
K7_SHAPES = ((2112, 256), (2112, 300), (480, 256), (32, 256))
RANK_PTRS = ("const float* m1, const float* m2, const float* leaves, "
             "const float* buf, const int* idx, const float* gm, "
             "const float* gr, const float* gl, const float* Pl, "
             "const float* Pr, const float* pi, const float* w, float* dm1, "
             "float* dm2, float* dPl, float* dPr, float* dpi_part, "
             "float* dw_part")
RANK_CALL = ("m1, m2, leaves, buf, idx, gm, gr, gl, Pl, Pr, pi, w, dm1, "
             "dm2, dPl, dPr, dpi_part, dw_part")
RANK_SHIM = """
template <bool Gather, int SPL, bool Dense>
static int run_rank(%s, int K, int R, int N, int S, int warps,
                    void* stream) {
  auto kernel = fused_rank_bwd_blocked_kernel<4, Gather, SPL, Dense>;
  const size_t smem = blocked_smem(1, 4) + (size_t)warps * 36 * sizeof(float)
      + (Dense ? 0 : (size_t)warps * 3 * 4 * 32 * SPL * sizeof(float));
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<K, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      %s, K, R, N, 1, S);
  return (int)cudaGetLastError();
}
""" % (RANK_PTRS, RANK_CALL)
# (SPL, dense) of the rank forms: the dense form, and the blocked one at G=1
RANK_FORMS = ((1, True), (2, True), (4, True), (1, False))
K7_PTRS = ("const float* m1, const float* m2, const float* Pl, "
           "const float* Pr, const float* pi, const float* w, const float* g, "
           "float* dm1, float* dm2, float* dPl, float* dPr")
K7_SHIM = """
template <int SPL, int MINB>
static int run_k7(%s, int KC, int M, int S, int warps, void* stream) {
  pair_ll_bwd_narrow_kernel<4, SPL, MINB>
      <<<KC, 32 * warps, k7_smem(M, 4, warps),
         static_cast<cudaStream_t>(stream)>>>(
          m1, m2, Pl, Pr, pi, w, g, dm1, dm2, dPl, dPr, KC, M, S);
  return (int)cudaGetLastError();
}
""" % K7_PTRS
# (SPL, MINB) of the K7 forms with a tighter launch bound
K7_BOUNDS = ((1, 3), (2, 2), (2, 3), (4, 2))


def build(name, body, out_dir, src_dir=_ext.CSRC, tag="forms"):
    """Start nvcc -Xptxas -v on a shim that includes csrc/<name>.cu and
    adds `body`; returns (the process, the library's path)."""
    shim = os.path.join(out_dir, f"{name}_{tag}.cu")
    with open(shim, "w") as fh:
        fh.write(f'#include "{os.path.join(src_dir, name + ".cu")}"\n'
                 f"{body}\n")
    so = os.path.join(out_dir, f"{name}_{tag}.so")
    return subprocess.Popen(
        [_ext._nvcc(), *_ext.NVCC_FLAGS, "-Xptxas", "-v", "-o", so, shim],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def ptxas_summary(log, keys):
    """{mangled kernel: [registers, spill stores, spill loads (bytes)]} of
    the kernels whose names hold one of `keys`."""
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
    return {k: v for k, v in out.items() if any(s in k for s in keys)}


def bind(lib, fn, n_ptr, n_int):
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def max_err(got, want):
    """The largest relative error over the outputs both hold (dpi and dw
    as sums over their partial rows)."""
    e = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            continue
        if i >= 4 and a.ndim == 2:
            a, b = a.sum(0), b.sum(0)
        e = max(e, cs.max_rel(a.reshape(b.shape), b))
    return e


def time_forms(meta, forms):
    """Time forms {name: fn} in turns first..last, last..first; print."""
    names = list(forms)
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        ms[n].append(cs.time_ms(forms[n]))
    best = min(names, key=lambda n: sum(ms[n]))
    print(json.dumps({**meta, "ms": ms, "quickest": best}), flush=True)


def k7_inputs(gen, dev, KC, S, M=cs.M_TWIST, A=cs.A):
    f = dict(dtype=torch.float32, device=dev)
    m1, m2 = (torch.rand((KC, A, S), generator=gen, **f) * 0.95 + 0.05
              for _ in range(2))
    P_l, P_r = (torch.rand((M, KC, A, A), generator=gen, **f) * 0.95 + 0.05
                for _ in range(2))
    pi = torch.rand((A,), generator=gen, **f) + 0.1
    pi = (pi / pi.sum()).contiguous()
    w = torch.ones((S,), **f)
    g = torch.randn((M, KC), generator=gen, **f)
    return m1, m2, P_l, P_r, pi, w, g


def k7_forms(lib, gen, dev):
    fn = _ext.bind("twist_kernels", "launch_pair_ll_bwd", 11, 6)
    wide = _ext.bind("twist_wide_kernels", "launch_pair_ll_bwd_wide", 11, 9)
    M, A = cs.M_TWIST, cs.A
    for KC, S in K7_SHAPES:
        args = k7_inputs(gen, dev, KC, S)
        m1, m2, P_l, P_r, pi, w, g = args
        want = kernels._pair_ll_bwd_plain(*args)

        def outs():
            return [torch.empty_like(t) for t in (m1, m2, P_l, P_r)]

        forms = {}
        for spl in K7_SPL:
            chunks = -(-S // (32 * spl))
            for warps in range(1, min(chunks, kernels.K7_MAX_WARPS) + 1):
                def run(spl=spl, warps=warps):
                    o = outs()
                    _ext.check(fn(*[t.data_ptr() for t in (*args, *o)], KC,
                                  M, A, S, spl, warps, _ext.stream_ptr(dev)),
                               "K7 form")
                    return o
                forms[f"spl{spl}_w{warps}"] = run
        for spl, minb in K7_BOUNDS:
            warps = kernels.twist_narrow_plan(KC, M, A, S, spl=spl)[1]
            bound = bind(lib, f"k7_{spl}_{minb}", 11, 4)

            def run_bound(bound=bound, warps=warps):
                o = outs()
                _ext.check(bound(*[t.data_ptr() for t in (*args, *o)], KC,
                                 M, S, warps, _ext.stream_ptr(dev)),
                           "K7 bound form")
                return o
            forms[f"spl{spl}_w{warps}_b{minb}"] = run_bound

        def run_wide():
            o = outs()
            _ext.check(wide(*[t.data_ptr() for t in (*args, *o)], KC, M, 1,
                            A, S, *kernels.twist_bwd_plan(1, A, S), 1,
                            _ext.stream_ptr(dev)), "K7 wide")
            return o
        forms["k7_wide_G1"] = run_wide
        forms["launcher"] = lambda: kernels.pair_ll_bwd(*args, want_dw=False)
        errs = {}
        for name, f in forms.items():
            errs[name] = max_err(f()[:4], want[:4])
            cs.require(errs[name] <= TOL, f"K7 {name} KC={KC} S={S}: "
                       f"{errs[name]}")
        time_forms({"shape": "K7", "M": M, "KC": KC, "A": A, "S": S,
                    "plan (spl, warps, chunks, blocks, smem)":
                        kernels.twist_narrow_plan(KC, M, A, S),
                    "max_rel_err": max(errs.values())}, forms)


def rank_inputs(gen, dev, S, Kd=cs.K):
    """(leaves, buf, idx, m1, m2, cotangents, P_l, P_r, pi, w): at K =
    2048 primate's rank inputs (dense P) with the children gathered by the
    last rank's real index; at K11a's K = 32 explicit random children
    (leaves, buf and idx None), as chip_smoke.py's check_k11a makes."""
    if Kd == cs.K:
        buf, leaves, idx, _, P_l, P_r, pi, w = cs.rank_inputs(gen, S, dev)
        m1, m2 = (t.contiguous() for t in kernels.gather_children(
            leaves, buf, idx))
    else:
        f = dict(dtype=torch.float32, device=dev)
        leaves = buf = idx = None
        m1, m2, P_l, P_r = (
            torch.rand(shape, generator=gen, **f) * 0.95 + 0.05
            for shape in ((Kd, cs.A, S),) * 2 + ((Kd, cs.A, cs.A),) * 2)
        pi = torch.rand((cs.A,), generator=gen, **f) + 0.1
        pi = (pi / pi.sum()).contiguous()
        w = torch.ones((S,), **f)
    cts = cs.bwd_cotangents(gen, dev, Kd, cs.A, S)
    return leaves, buf, idx, m1, m2, cts, P_l, P_r, pi, w


def _ptr(t):
    return None if t is None else t.data_ptr()


def rank_forms(lib, gen, dev):
    shapes = [("K2", 0, cs.S_BATCH, cs.K), ("K3", 1, cs.S_BATCH, cs.K),
              ("K2", 0, cs.S_FULL, cs.K), ("K3", 1, cs.S_FULL, cs.K),
              ("K11a", 0, cs.S_BATCH, cs.K_TWIST)]
    for label, gather, S, Kd in shapes:
        leaves, buf, idx, m1, m2, cts, P_l, P_r, pi, w = rank_inputs(
            gen, dev, S, Kd)
        R, Nd = (buf.shape[1], leaves.shape[0]) if gather else (0, 0)
        head = (leaves, buf, idx) if gather else (m1, m2)
        plain = (kernels._fused_rank_bwd_ref if gather else
                 kernels._fused_rank_bwd_saved_ref)
        wrapper = (kernels.fused_rank_bwd if gather else
                   kernels.fused_rank_bwd_saved)
        want = plain(*head, *cts, P_l, P_r, pi, w)
        forms = {}
        for spl, dense in RANK_FORMS:
            chunks = -(-S // (32 * spl))
            fn = bind(lib, f"rank_{gather}_{spl}_{int(dense)}", 18, 5)
            for warps in sorted({min(c, chunks) for c in (8, 4, 2)},
                                reverse=True):
                def run(fn=fn, warps=warps):
                    o = kernels._bwd_outputs(Kd, cs.A, S, P_l.shape, dev)
                    p = [_ptr(t) for t in (m1, m2, leaves, buf, idx, *cts,
                                           P_l, P_r, pi, w, *o)]
                    if gather:
                        p[0] = p[1] = None
                    _ext.check(fn(*p, Kd, R, Nd, S, warps,
                                  _ext.stream_ptr(dev)), "rank form")
                    return o
                kind = "dense" if dense else "blocked_G1"
                forms[f"{kind}_spl{spl}_w{warps}"] = run
        forms["wrapper"] = lambda: wrapper(*head, *cts, P_l, P_r, pi, w)
        forms["wrapper_no_dw"] = lambda: wrapper(*head, *cts, P_l, P_r, pi,
                                                 w, want_dw=False)
        errs = {n: max_err(f(), want) for n, f in forms.items()}
        for n, e in errs.items():
            cs.require(e <= TOL, f"{label} {n} S={S}: {e}")
        time_forms({"shape": label, "K": Kd, "A": cs.A, "S": S,
                    "plan (spl, warps, chunks, blocks, smem)":
                        kernels.rank_bwd_plan(Kd, 1, cs.A, S),
                    "max_rel_err": max(errs.values())}, forms)
        del leaves, buf, m1, m2, want, forms
        torch.cuda.empty_cache()


def ab(label, meta, former, new, extra=None):
    """former, new (and extra {name: fn}), in turns former, new, new,
    former (extra after each new)."""
    fns = {"former": former, "new": new, **(extra or {})}
    ms = {n: [] for n in fns}
    order = ["former", "new", *(extra or {}), "new", *(extra or {}),
             "former"]
    for n in order:
        ms[n].append(cs.time_ms(fns[n]))
    print(json.dumps({"shape": label, **meta, "ms": ms}), flush=True)


def parent_ab(libs, gen, dev):
    """The parent checkout's K7 and dense rank backward against this
    tree's wrappers."""
    old_k7 = bind(libs["twist_kernels"], "launch_pair_ll_bwd", 11, 4)
    old_k2 = bind(libs["rank_kernels"], "launch_fused_rank_bwd_saved", 15, 4)
    old_k3 = bind(libs["rank_kernels"], "launch_fused_rank_bwd", 16, 6)
    tkb = 8                     # the former body's particles a block
    M, A = cs.M_TWIST, cs.A
    for KC, S in K7_SHAPES:
        args = k7_inputs(gen, dev, KC, S)

        def former(args=args, KC=KC, S=S):
            o = [torch.empty_like(t) for t in args[:4]]
            _ext.check(old_k7(*[t.data_ptr() for t in (*args, *o)], KC, M, A,
                              S, _ext.stream_ptr(dev)), "former K7")
            return o

        def new(args=args):
            return kernels.pair_ll_bwd(*args, want_dw=False)
        e = max_err(former(), new()[:4])
        cs.require(e <= TOL, f"K7 former vs new KC={KC} S={S}: {e}")
        ab("K7", {"KC": KC, "M": M, "S": S}, former, new)
    for label, gather, S, Kd in (("K2", 0, cs.S_BATCH, cs.K),
                                 ("K3", 1, cs.S_BATCH, cs.K),
                                 ("K2", 0, cs.S_FULL, cs.K),
                                 ("K3", 1, cs.S_FULL, cs.K),
                                 ("K11a", 0, cs.S_BATCH, cs.K_TWIST)):
        leaves, buf, idx, m1, m2, cts, P_l, P_r, pi, w = rank_inputs(
            gen, dev, S, Kd)
        R, Nd = (buf.shape[1], leaves.shape[0]) if gather else (0, 0)
        head = (leaves, buf, idx) if gather else (m1, m2)

        def former(head=head, Kd=Kd, S=S, gather=gather, R=R, Nd=Nd,
                   P_l=P_l, P_r=P_r, pi=pi, w=w, cts=cts):
            o = list(kernels._bwd_outputs(Kd, A, S, P_l.shape, dev))
            o[4] = torch.empty((-(-Kd // tkb), A), device=dev)
            o[5] = torch.empty((-(-Kd // tkb), S), device=dev)
            p = [t.data_ptr() for t in (*head, *cts, P_l, P_r, pi, w, *o)]
            if gather:
                code = old_k3(*p, Kd, R, Nd, A, S, tkb, _ext.stream_ptr(dev))
            else:
                code = old_k2(*p, Kd, A, S, tkb, _ext.stream_ptr(dev))
            _ext.check(code, f"former {label}")
            if label == "K11a":         # merge_bwd's two sums
                return o[:4] + [o[4].sum(0), o[5].sum(0)]
            return o

        if label == "K11a":
            def new(args=(m1, m2, P_l, P_r, pi, w, *cts)):
                return kernels.merge_bwd(*args)
            extra = {"new_no_dw": lambda args=(m1, m2, P_l, P_r, pi, w,
                                               *cts):
                     kernels.merge_bwd(*args, want_dw=False)}
        else:
            wrapper = (kernels.fused_rank_bwd if gather else
                       kernels.fused_rank_bwd_saved)

            def new(wrapper=wrapper, head=head, cts=cts, P_l=P_l, P_r=P_r,
                    pi=pi, w=w):
                return wrapper(*head, *cts, P_l, P_r, pi, w)
            extra = {"new_no_dw": lambda wrapper=wrapper, head=head, cts=cts,
                     P_l=P_l, P_r=P_r, pi=pi, w=w: wrapper(
                         *head, *cts, P_l, P_r, pi, w, want_dw=False)}
        e = max_err(former(), new())
        cs.require(e <= TOL, f"{label} former vs new S={S}: {e}")
        ab(label, {"K": Kd, "A": A, "S": S}, former, new, extra)
        del leaves, buf, m1, m2
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    out_dir = os.path.join(_ext.build_dir(), "k7_forms")
    os.makedirs(out_dir, exist_ok=True)
    rank_body = RANK_SHIM + "".join(
        f'extern "C" int rank_{g}_{spl}_{int(d)}({RANK_PTRS}, int K, int R, '
        f"int N, int S, int warps, void* stream) {{ return run_rank<"
        f"{'true' if g else 'false'}, {spl}, {'true' if d else 'false'}>("
        f"{RANK_CALL}, K, R, N, S, warps, stream); }}\n"
        for g in (0, 1) for spl, d in RANK_FORMS)
    k7_body = K7_SHIM + "".join(
        f'extern "C" int k7_{spl}_{minb}({K7_PTRS}, int KC, int M, int S, '
        f"int warps, void* stream) {{ return run_k7<{spl}, {minb}>(m1, m2, "
        f"Pl, Pr, pi, w, g, dm1, dm2, dPl, dPr, KC, M, S, warps, stream); "
        "}\n" for spl, minb in K7_BOUNDS)
    procs = {"rank_kernels": build("rank_kernels", rank_body, out_dir),
             "twist_kernels": build("twist_kernels", k7_body, out_dir)}
    if args.parent:
        src = os.path.join(os.path.abspath(args.parent), "phylo_tpu_torch",
                           "csrc")
        for name in ("rank_kernels", "twist_kernels"):
            procs[f"parent_{name}"] = build(name, "", out_dir, src, "parent")
    _ext.build_all()
    libs, ptx = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
        if not name.startswith("parent"):
            ptx.update(ptxas_summary(log, ("pair_ll_bwd_narrow_kernel",
                                           "fused_rank_bwd_blocked_kernel")))
    print(json.dumps({"ptxas": ptx}), flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k7_forms(libs["twist_kernels"], gen, dev)
    rank_forms(libs["rank_kernels"], gen, dev)
    if args.parent:
        parent_ab({n: libs[f"parent_{n}"] for n in ("rank_kernels",
                                                    "twist_kernels")},
                  gen, dev)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
