"""Check and time the wide rank kernels' block-group forms on one card.

The wide rank kernels (csrc/wide_kernels.cu: K9f, K9bs, K9b, and K11a
above 8 states) take G <= 32 rate blocks of up to 128 states; where one
block of threads does not hold every plane of a chunk they run their
block-group bodies (`kernels.wide_fwd_group`, `wide_bwd_group`).  This
script

* builds csrc/wide_kernels.cu with -Xptxas -v and prints the registers
  and spills of every wide_rank_* instance;
* holds K9f (saving the children and not), K9bs and K9b, through their
  wrappers, against the plain versions (1e-5 on the column, 1e-4
  relative on the backward's outputs, as chip_smoke.py's K9 checks) at
  protein + Gamma8 (8 x 20: K=256, S=256 and 500; K9bs at K=32), GY94 +
  Gamma4 (4 x 61: K=128, S=256 and 1086) and, small, 16 x 20, 32 x 20,
  8 x 61 and 2 x 128, with all planes tied too, and K11a at K=32, 8 x
  20; two calls give the same bits;
* forces the group forms where one group fits (protein + Gamma4's 4 x 20
  at gb = 1 and 2, at the one-group body's cluster) and holds them
  against the one-group body: the column, dm, dP and dw to the bit,
  rootll and logscale within 1e-6 relative;
* with --time, times each launch beside its plain version;
* with --parent DIR (a `git archive` of the commit before, unpacked
  under a gitignored directory such as _chip_check/), builds that
  commit's wide_kernels.cu and times its launches against this tree's at
  the earlier paths' shapes (GY94 codons K=128, A=61; protein + Gamma4
  K=256 and K=64), former, new, new, former, their outputs compared bit
  for bit.

    python tools/torch_k9_groups.py [--time] [--parent DIR]

Needs a CUDA card and nvcc; prints one JSON line per check and the
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
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
from phylo_tpu_torch import _ext  # noqa: E402
from phylo_tpu_torch.pruning import kernels  # noqa: E402
from torch_k7_forms import ptxas_summary  # noqa: E402


def emit(**row):
    print(json.dumps(row), flush=True)


def inputs(gen, dev, Kd, G, A, S, ties=False, Nd=16):
    idx = cs.small_idx(gen, dev, Kd, Nd, Nd - 1)
    leaves, buf, idx, P_l, P_r, pi, w = cs.wide_inputs(
        gen, dev, S, idx, Kd, Nd, A, ties=ties, G=G)
    m1, m2 = kernels.gather_children(leaves, buf, idx)
    cts = cs.bwd_cotangents(gen, dev, Kd, G * A, S)
    return dict(leaves=leaves, buf=buf, idx=idx, P_l=P_l, P_r=P_r, pi=pi,
                w=w, m1=m1.contiguous(), m2=m2.contiguous(), cts=cts)


def fwd(d, save, ref=False, buf=None):
    """K9f (or its plain version) writing the last column of `buf`
    (default a copy of the inputs' buffer: the timed calls pass one, as
    the column's rewrite is idempotent)."""
    buf = d["buf"].clone() if buf is None else buf
    fn = kernels._fused_rank_ref if ref else kernels.fused_rank_update
    out = fn(d["leaves"], buf, d["idx"], buf.shape[1] - 1, d["P_l"],
             d["P_r"], d["pi"], d["w"], save_children=save)
    return buf[:, -1], out


def bwd(d, gather, ref=False):
    args = ((d["leaves"], d["buf"], d["idx"]) if gather
            else (d["m1"], d["m2"])) + tuple(d["cts"]) + (
        d["P_l"], d["P_r"], d["pi"], d["w"])
    if ref:
        return (kernels._fused_rank_bwd_ref if gather
                else kernels._fused_rank_bwd_saved_ref)(*args)
    fn = kernels.fused_rank_bwd if gather else kernels.fused_rank_bwd_saved
    return fn(*args)


def check_shape(gen, dev, Kd, G, A, S, timed, ties=False, saved=True,
                regather=True):
    """K9f, K9bs, K9b at (Kd, G, A, S) against the plain versions."""
    d = inputs(gen, dev, Kd, G, A, S, ties)
    tag = dict(K=Kd, G=G, A=A, S=S, ties=ties,
               fwd_gb=kernels.wide_fwd_group(Kd, G, A, S),
               bwd_gb=kernels.wide_bwd_group(Kd, G, A, S))
    for save in (True, False):
        col, out = fwd(d, save)
        rcol, rout = fwd(d, save, ref=True)
        col2, out2 = fwd(d, save)
        torch.cuda.synchronize()
        errs = {"buf": cs.max_abs(col, rcol),
                "rootll": cs.max_rel(out[0], rout[0]),
                "logscale": cs.max_rel(out[1], rout[1])}
        if save:
            errs["children"] = max(cs.max_abs(out[2], rout[2]),
                                   cs.max_abs(out[3], rout[3]))
        same = torch.equal(col, col2) and all(
            torch.equal(a, b) for a, b in zip(out, out2))
        cs.require(max(errs.values()) <= 1e-5 and same,
                   f"K9f {tag} save={save}: {errs}, same bits {same}")
        row = dict(kernel="K9f", save=save, errs=errs, same_bits=same)
        if timed:
            b = d["buf"].clone()
            row["ms"] = cs.time_ms(lambda: fwd(d, save, buf=b))
            row["plain_ms"] = cs.time_ms(
                lambda: fwd(d, save, ref=True, buf=b), iters=3)
        emit(**tag, **row)
    for gather in ((False,) if saved else ()) + ((True,) if regather
                                                 else ()):
        got, want, again = bwd(d, gather), bwd(d, gather, ref=True), \
            bwd(d, gather)
        torch.cuda.synchronize()
        names = ("dm1", "dm2", "dP_l", "dP_r", "dpi", "dw")
        # dpi and dw come back as partial rows, summed by the caller
        errs = {n: cs.max_rel(a.sum(0) if j > 3 else a,
                              b.sum(0) if j > 3 else b)
                for j, (n, a, b) in enumerate(zip(names, got, want))}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        label = "K9b" if gather else "K9bs"
        cs.require(max(errs.values()) <= 1e-4 and same,
                   f"{label} {tag}: {errs}, same bits {same}")
        row = dict(kernel=label, errs=errs, same_bits=same)
        if timed:
            row["ms"] = cs.time_ms(lambda: bwd(d, gather))
            row["plain_ms"] = cs.time_ms(lambda: bwd(d, gather, ref=True),
                                         iters=3)
        emit(**tag, **row)


def check_k11a(gen, dev, timed, Kt=cs.K_TWIST, G=8, A=20, S=cs.S_BATCH):
    d = inputs(gen, dev, Kt, G, A, S)
    args = (d["m1"], d["m2"], d["P_l"], d["P_r"], d["pi"], d["w"]) + \
        tuple(d["cts"])
    got, want, again = kernels.merge_bwd(*args), \
        kernels._merge_bwd_ref(*args), kernels.merge_bwd(*args)
    torch.cuda.synchronize()
    errs = {n: cs.max_rel(a, b) for n, a, b in zip(
        ("dm1", "dm2", "dP_l", "dP_r", "dpi", "dw"), got, want)}
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    cs.require(max(errs.values()) <= 1e-4 and same, f"K11a {errs} {same}")
    row = dict(kernel="K11a", K=Kt, G=G, A=A, S=S, errs=errs,
               same_bits=same)
    if timed:
        row["ms"] = cs.time_ms(lambda: kernels.merge_bwd(*args))
        row["plain_ms"] = cs.time_ms(lambda: kernels._merge_bwd_ref(*args))
    emit(**row)


def parent_ab(lib, gen, dev):
    """The former wide_kernels library against this tree's wrappers at
    the earlier paths' shapes: the same bits, and times in turns."""
    old_f = cs_bind(lib, "launch_wide_rank", 11, 10)
    old_bs = cs_bind(lib, "launch_wide_rank_bwd_saved", 15, 8)
    old_b = cs_bind(lib, "launch_wide_rank_bwd", 16, 10)
    for Kd, G, A, S, Nd in ((128, 1, 61, 256, 17), (128, 1, 61, 1086, 17),
                            (256, 4, 20, 256, 16), (256, 4, 20, 500, 16),
                            (64, 4, 20, 256, 16)):
        d = inputs(gen, dev, Kd, G, A, S, Nd=Nd)
        st = _ext.stream_ptr(dev)
        R = d["buf"].shape[1]

        # each side writes its own copy, so that the bits compare
        buf_f, buf_n = d["buf"].clone(), d["buf"].clone()

        def former_f(d=d, Kd=Kd, G=G, A=A, S=S, R=R, Nd=Nd, buf=buf_f):
            sums = torch.empty((2, Kd), device=dev)
            sc, cl, th, _, _ = kernels.wide_fwd_plan(Kd, G, A, S)
            p = [t.data_ptr() for t in (d["leaves"], buf, d["idx"], d["P_l"],
                                        d["P_r"], d["pi"], d["w"])]
            _ext.check(old_f(*p, sums[0].data_ptr(), sums[1].data_ptr(),
                             None, None, Kd, R, Nd, G, A, S, R - 1, sc, cl,
                             th, st), "former K9f")
            return buf[:, -1], sums[0], sums[1]

        def new_f(d=d, buf=buf_n):
            col, out = fwd(d, False, buf=buf)
            return col, out[0], out[1]

        def former_b(d=d, gather=False, Kd=Kd, G=G, A=A, S=S, R=R, Nd=Nd):
            sc, cl, th, dpt, _, _ = kernels.wide_bwd_plan(Kd, G, A, S)
            o = kernels._bwd_outputs(Kd, G * A, S, d["P_l"].shape, dev)
            ins = [t.data_ptr() for t in tuple(d["cts"]) + (
                d["P_l"], d["P_r"], d["pi"], d["w"])]
            op = [t.data_ptr() for t in o]
            if gather:
                head = [t.data_ptr() for t in (d["leaves"], d["buf"],
                                               d["idx"])]
                code = old_b(*head, *ins, *op, Kd, R, Nd, G, A, S, sc, cl,
                             th, dpt, st)
            else:
                head = [d["m1"].data_ptr(), d["m2"].data_ptr()]
                code = old_bs(*head, *ins, *op, Kd, G, A, S, sc, cl, th,
                              dpt, st)
            _ext.check(code, "former K9 backward")
            return o

        for label, former, new in (
                ("K9f", former_f, new_f),
                ("K9bs", former_b, lambda d=d: bwd(d, False)),
                ("K9b", lambda: former_b(gather=True),
                 lambda d=d: bwd(d, True))):
            bits = all(torch.equal(a, b) for a, b in zip(former(), new()))
            ms = {"former": [], "new": []}
            for n in ("former", "new", "new", "former"):
                ms[n].append(cs.time_ms(former if n == "former" else new))
            emit(check="parent A/B", kernel=label, K=Kd, G=G, A=A, S=S,
                 same_bits=bits, ms=ms)
            cs.require(bits, f"{label} {Kd} {G} {A} {S}: not the former bits")
        del d
        torch.cuda.empty_cache()


def cs_bind(lib, fn, n_ptr, n_int):
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def build_ptxas(src, so):
    """Start nvcc -Xptxas -v of `src` into `so`."""
    return subprocess.Popen(
        [_ext._nvcc(), *_ext.NVCC_FLAGS, "-Xptxas", "-v", "-o", so, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(proc, what):
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {what}:\n{log}")
    return log


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--parent", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    # this tree's library where _ext loads it, and the parent's beside it,
    # built together
    os.makedirs(_ext.build_dir(), exist_ok=True)
    procs = {"this": build_ptxas(os.path.join(_ext.CSRC, "wide_kernels.cu"),
                                 _ext._lib_path("wide_kernels"))}
    parent_so = os.path.join(_ext.build_dir(), "parent_wide_kernels.so")
    if args.parent:
        procs["parent"] = build_ptxas(
            os.path.join(os.path.abspath(args.parent), "phylo_tpu_torch",
                         "csrc", "wide_kernels.cu"), parent_so)
    logs = {k: finish(p, k) for k, p in procs.items()}
    emit(ptxas=ptxas_summary(logs["this"], ("wide_rank",)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    check_k11a(gen, dev, args.time)
    for Kd, S in ((256, 256), (64, 500)):
        for ties in (False, True):
            cs.check_forced_groups(kernels, gen, dev,
                                   cs.small_idx(gen, dev, Kd, 16, 15), S,
                                   Nd=16, ties=ties,
                                   emit=lambda row: emit(**row))
    for Kd, G, A, S, saved, regather in (
            (256, 8, 20, 256, False, True), (256, 8, 20, 500, False, True),
            (32, 8, 20, 256, True, False), (128, 4, 61, 256, True, True),
            (128, 4, 61, 1086, False, True)):
        check_shape(gen, dev, Kd, G, A, S, args.time, saved=saved,
                    regather=regather)
        torch.cuda.empty_cache()
    for Kd, G, A, S in ((16, 8, 20, 70), (8, 4, 61, 70)):
        check_shape(gen, dev, Kd, G, A, S, False, ties=True)
    for Kd, G, A, S in ((8, 16, 20, 70), (8, 32, 20, 70), (4, 8, 61, 70),
                        (4, 2, 128, 40), (4, 3, 9, 37)):
        check_shape(gen, dev, Kd, G, A, S, False)
    if args.parent:
        parent_ab(ctypes.CDLL(parent_so), gen, dev)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
