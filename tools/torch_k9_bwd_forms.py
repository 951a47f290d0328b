"""Time the thread shapes of the port's K9 backward on one card.

csrc/wide_kernels.cu instantiates its backward (`run_bwd<Gather, NT,
DPJ>`: NT threads, DPJ dP accumulators a side per thread) in a few
forms and `launch_bwd` picks one by the plane count.  This script builds
a shim that includes the source and exports each form named on the
command line, then, at each shape, checks that every form that fits it
(NT / 32 * 8 >= G*A planes, NT * DPJ >= G A^2) returns the same bits as
the form `launch_bwd` picks and times them in the order first..last,
last..first (CUDA events, chip_smoke.py's `time_ms`).

Shapes: protein + Gamma4 (G=4, A=20, 80 planes) at the main paths'
steps, K9b at K=256 and K9bs at K=64, S=256, on the child index of the
last rank of a real sweep over chip_smoke.py's seeded 16 x 500 FASTA;
and +R6 (G=6, 120 planes) at K=256 on a random index.

    python tools/torch_k9_bwd_forms.py [--forms 512x8,512x32]

Needs a CUDA card and nvcc; prints one JSON line per shape and the
card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from phylo_tpu_torch import _ext  # noqa: E402
from phylo_tpu_torch.pruning import kernels  # noqa: E402

ARGS = ("const float* m1, const float* m2, const float* leaves, "
        "const float* buf, const int* idx, const float* gm, "
        "const float* gr, const float* gl, const float* Pl, "
        "const float* Pr, const float* pi, const float* w, float* dm1, "
        "float* dm2, float* dPl, float* dPr, float* dpi_part, "
        "float* dw_part, int K, int R, int N, int G, int A, int S, "
        "void* stream")
CALL = ("m1, m2, leaves, buf, idx, gm, gr, gl, Pl, Pr, pi, w, dm1, dm2, "
        "dPl, dPr, dpi_part, dw_part, K, R, N, G, A, S, "
        "static_cast<cudaStream_t>(stream)")


def build(forms):
    """The shim library exporting form_<gather>_<NT>_<DPJ> per form."""
    src = os.path.join(_ext.CSRC, "wide_kernels.cu")
    out_dir = os.path.join(_ext.build_dir(), "forms")
    os.makedirs(out_dir, exist_ok=True)
    shim = os.path.join(out_dir, "forms.cu")
    lines = [f'#include "{src}"']
    for nt, dpj in forms:
        for gather in (0, 1):
            lines.append(
                f'extern "C" int form_{gather}_{nt}_{dpj}({ARGS}) {{ return '
                f"run_bwd<{'true' if gather else 'false'}, {nt}, {dpj}>"
                f"({CALL}); }}")
    with open(shim, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    so = os.path.join(out_dir, "forms_" + "_".join(
        f"{nt}x{dpj}" for nt, dpj in forms) + ".so")
    subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", so, shim],
                   check=True)
    lib = ctypes.CDLL(so)
    fns = {}
    for nt, dpj in forms:
        for gather in (0, 1):
            f = getattr(lib, f"form_{gather}_{nt}_{dpj}")
            f.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 \
                + [ctypes.c_void_p]
            f.restype = ctypes.c_int
            fns[gather, nt, dpj] = f
    return fns


def run_form(fn, gather, ins, K, G, A, S, dev):
    leaves, buf, idx, m1, m2, gm, gr, gl, P_l, P_r, pi, w = ins
    outs = kernels._wide_bwd_outputs(K, G * A, S, P_l.shape, dev)
    p = [t.data_ptr() if t is not None else None for t in (
        m1, m2, leaves, buf, idx, gm, gr, gl, P_l, P_r, pi, w, *outs)]
    if gather:
        p[0] = p[1] = None
    else:
        p[2] = p[3] = p[4] = None
    R, N = buf.shape[1], leaves.shape[0]
    _ext.check(fn(*p, K, R, N, G, A, S, _ext.stream_ptr(dev)), "form")
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--forms", default="512x8,512x32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    forms = [tuple(int(x) for x in f.split("x"))
             for f in args.forms.split(",")]
    dev = torch.device("cuda")
    fns = build(forms)
    cs.protein_files()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shapes = [("protein_g4 K9b", 1, 256, 4, cs.S_BATCH),
              ("protein_dat_f_g4 K9bs", 0, 64, 4, cs.S_BATCH),
              ("R6 K9b", 1, 256, 6, cs.S_BATCH)]
    for label, gather, Kd, G, S in shapes:
        if G == 4:
            idx = cs.last_rank_idx(gen, dev, S, cs.PROT_FASTA,
                                   "reference+g4", Kd)
        else:
            idx = cs.small_idx(gen, dev, Kd, cs.N_PROT, cs.N_PROT - 1)
        leaves, buf, idx, P_l, P_r, pi, w = cs.wide_inputs(
            gen, dev, S, idx, Kd, cs.N_PROT, cs.A_PROT, G=G)
        m1, m2 = (t.contiguous() for t in kernels.gather_children(
            leaves, buf, idx))
        cts = cs.bwd_cotangents(gen, dev, Kd, G * cs.A_PROT, S)
        ins = (leaves, buf, idx, m1, m2, *cts, P_l, P_r, pi, w)
        lib_args = ((leaves, buf, idx) if gather else (m1, m2)) + (
            *cts, P_l, P_r, pi, w)
        picked = (kernels.fused_rank_bwd if gather
                  else kernels.fused_rank_bwd_saved)(*lib_args)
        GA = G * cs.A_PROT
        fit = [(nt, dpj) for nt, dpj in forms
               if nt // 32 * 8 >= GA and nt * dpj >= GA * cs.A_PROT]
        same = {}
        for nt, dpj in fit:
            got = run_form(fns[gather, nt, dpj], gather, ins, Kd, G,
                           cs.A_PROT, S, dev)
            same[f"{nt}x{dpj}"] = all(bool(torch.equal(a, b))
                                      for a, b in zip(got, picked))
        order = fit + fit[::-1]
        ms = {f"{nt}x{dpj}": [] for nt, dpj in fit}
        for nt, dpj in order:
            fn = fns[gather, nt, dpj]
            ms[f"{nt}x{dpj}"].append(cs.time_ms(
                lambda: run_form(fn, gather, ins, Kd, G, cs.A_PROT, S, dev),
                iters=50))
        print(json.dumps({"shape": label, "K": Kd, "G": G, "A": cs.A_PROT,
                          "S": S, "same_bits_as_launch_bwd": same,
                          "ms": ms}), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
