"""Time the forms of K11c (the T-field twist backward) and K8 (the narrow
merge) on one card, and hold each against its plain version.

* K11c, K7's bodies in their T-field form: at A <= 8
  (csrc/twist_kernels.cu, `pair_ll_bwd_t_narrow_kernel<A, SPL>`) SPL =
  1, 2 or 4 sites a lane and every warp count from 1 to the row's chunks
  (at most 8), beside K7 (`pair_ll_bwd_narrow_kernel`) at its own plan
  on the same inputs; above 8 states (csrc/twist_wide_kernels.cu,
  `pair_ll_bwd_t_wide_kernel`) chunks of SC = 32, 64, 128 and 256 sites,
  beside K7 wide dense.  Shapes: primate's twist at M = 10, rank 0 (KC
  = 2112, real transitions, as chip_smoke.py makes them), KC = 480 and
  32 (later ranks), S = 256; DS1 GTR+G4 as 16 dense states, KC = 896 and
  rank 0's 11,232.
* K8 (`merge_loglik_kernel<A>`, a block a particle, a site a thread a
  pass): the plan's threads (one pass) and half of them (two passes), at
  K = 32, S = 256 and 898, beside the launch floor (an empty kernel,
  `torch.cuda._sleep(0)`, on the same sleep-held stream).  (A cluster of
  2-8 blocks a particle, form (b), and two sites a thread a pass ran
  1.1-1.5x slower than one block a thread a site and were dropped:
  PERF.md.)

Every form is checked against the plain version (K11c: 1e-4 relative
against `_pair_ll_bwd_t_ref`; K8: 1e-5 against `_ref_impl`, as phase 2)
and timed in turns first..last, last..first (CUDA events behind a sleep
kernel, chip_smoke.py's `time_ms`); the kernels are built again with
-Xptxas -v and their registers and spills printed.

    python tools/torch_k11c_k8_forms.py [--parent DIR]

--parent DIR (a checkout of the commit before this redesign, e.g. from
git archive) also builds that checkout's twist_kernels.cu and
twist_wide_kernels.cu and runs the one-call A/B former, new, new,
former at every phase-2 shape: K11c through its former wrapper (the T
kernel, `_dp_from_t`'s two products and the dpi ops) against
`pair_ll_bwd` under TWIST_BWD_V2, and the two kernels alone; K8's former
launch against `merge_loglik`.

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

K11C_TOL, K8_TOL = 1e-4, 1e-5
SC_FORMS = (32, 64, 128, 256)
K8_SITES = (cs.S_BATCH, cs.S_FULL)


def twist_shapes(gen, dev):
    """[(label, inputs)] at phase 2's K11c shapes: primate rank 0 and
    two later ranks' row counts, DS1 dense KC = 896 and 11,232, and the
    small dense A = 20 and 61 inputs."""
    prim = cs.twist_inputs(gen, dev, "primate", None, cs.N * (cs.N - 1) // 2,
                           cs.S_BATCH)
    ds1 = cs.dense_inputs(kernels, cs.twist_inputs(
        gen, dev, "hohna_data_1", "gtr+g4", cs.N_DS1 * (cs.N_DS1 - 1) // 2,
        cs.S_BATCH, blocked=True))
    out = [("primate rank 0", prim),
           ("primate KC=480", cs.first_rows(prim, 480)),
           ("primate KC=32", cs.first_rows(prim, 32)),
           ("DS1 dense KC=896", cs.first_rows(ds1, cs.K_TWIST * 28)),
           ("DS1 dense rank 0", ds1)]
    for A_, S in ((20, 70), (61, 70), (20, 300)):
        out.append((f"small A={A_} S={S}", cs.twist_inputs(
            gen, dev, None, None, 5, S, A_=A_, Kt=3)))
    return out


def with_t_field(fn):
    """fn run with kernels.TWIST_BWD_V2 set."""
    def run():
        old = kernels.TWIST_BWD_V2
        kernels.TWIST_BWD_V2 = True
        try:
            return fn()
        finally:
            kernels.TWIST_BWD_V2 = old
    return run


def k11c_forms(gen, dev, shapes):
    narrow = _ext.bind("twist_kernels", "launch_pair_ll_bwd_t", 11, 6)
    wide = _ext.bind("twist_wide_kernels", "launch_pair_ll_bwd_t", 11, 9)
    k7 = _ext.bind("twist_kernels", "launch_pair_ll_bwd", 11, 6)
    k7w = _ext.bind("twist_wide_kernels", "launch_pair_ll_bwd_wide", 11, 9)
    for label, ins in shapes:
        if label.startswith("small"):
            continue
        M, KC = ins[2].shape[:2]
        A, S = ins[0].shape[1:]
        g = torch.randn((M, KC), generator=gen, device=dev)
        want = kernels._pair_ll_bwd_t_ref(*ins, g)
        ptrs = [t.data_ptr() for t in (*ins, g)]

        def call(fn, *plan):
            def run():
                o = [torch.empty_like(t) for t in ins[:4]]
                _ext.check(fn(*ptrs, *[t.data_ptr() for t in o], KC, M, *plan,
                              _ext.stream_ptr(dev)), "K11c form")
                return o
            return run

        forms = {}
        if A <= kernels.MAX_A:
            for spl in (1, 2, 4):
                chunks = -(-S // (32 * spl))
                for warps in range(1, min(chunks, kernels.K7_MAX_WARPS) + 1):
                    forms[f"t_spl{spl}_w{warps}"] = call(narrow, A, S, spl,
                                                         warps)
            spl, warps = kernels.twist_narrow_plan(KC, M, A, S)[:2]
            forms["k7"] = call(k7, A, S, spl, warps)
        else:
            for sc in SC_FORMS:
                NGT = -(-A // 4)
                threads = -(-NGT * sc // 4 // 32) * 32
                if threads > kernels.BWD_MAX_THREADS:
                    continue
                smem = 4 * ((4 * A + NGT + 1) * (sc + 4) + 9 * A * 4 * NGT
                            + -(-A // 4) * 4)
                if smem > kernels.SMEM_LIMIT:
                    continue
                forms[f"t_sc{sc}"] = call(wide, 1, A, S, sc, threads, smem,
                                          1)
            forms["k7_wide"] = call(k7w, 1, A, S,
                                    *kernels.twist_bwd_plan(1, A, S), 1)
        forms["wrapper"] = with_t_field(
            lambda: kernels.pair_ll_bwd(*ins, g, want_dw=False))
        errs = {}
        for name, f in forms.items():
            errs[name] = k7f.max_err(f()[:4], want[:4])
            cs.require(errs[name] <= K11C_TOL,
                       f"K11c {name} {label}: {errs[name]}")
        plan = (kernels.twist_narrow_plan(KC, M, A, S, t_field=True)
                if A <= kernels.MAX_A
                else kernels.twist_bwd_plan(1, A, S, t_field=True))
        bound, by = cs.twist_bound(ins, "bwd_t")
        k7f.time_forms({"shape": f"K11c {label}", "M": M, "KC": KC, "A": A,
                        "S": S, "plan": plan, "bound_ms": bound,
                        "bound_by": by, "max_rel_err": max(errs.values())},
                       forms)


def k8_inputs(gen, dev, S, Kt=cs.K_TWIST, A=cs.A):
    f = dict(dtype=torch.float32, device=dev)
    m1, m2 = (torch.rand((Kt, A, S), generator=gen, **f) * 0.95 + 0.05
              for _ in range(2))
    P_l, P_r = (torch.rand((Kt, A, A), generator=gen, **f) * 0.95 + 0.05
                for _ in range(2))
    pi = torch.rand((A,), generator=gen, **f) + 0.1
    return m1, m2, P_l, P_r, (pi / pi.sum()).contiguous(), torch.ones((S,),
                                                                      **f)


def k8_err(got, want):
    return max(cs.max_abs(got[0], want[0]), cs.max_rel(got[1], want[1]),
               cs.max_rel(got[2], want[2]))


def k8_forms(gen, dev):
    fn = _ext.bind("twist_kernels", "launch_merge_loglik", 9, 4)
    Kt, A = cs.K_TWIST, cs.A
    for S in K8_SITES:
        args = k8_inputs(gen, dev, S)
        want = kernels._ref_impl(*args)
        forms = {}
        plan = kernels.merge_ll_plan(S, A)
        for threads in (plan, max(32, -(-S // 64) * 32)):

            def run(threads=threads):
                o = (torch.empty((Kt, A, S), device=dev),
                     torch.empty((Kt,), device=dev),
                     torch.empty((Kt,), device=dev))
                _ext.check(fn(*[t.data_ptr() for t in (*args, *o)], Kt, A,
                              S, threads, _ext.stream_ptr(dev)), "K8 form")
                return o
            forms[f"t{threads}_passes{-(-S // threads)}"] = run
        forms["wrapper"] = lambda: kernels.merge_loglik(*args)
        forms["launch_floor"] = lambda: torch.cuda._sleep(0)
        errs = {n: k8_err(f(), want) for n, f in forms.items()
                if n != "launch_floor"}
        for n, e in errs.items():
            cs.require(e <= K8_TOL, f"K8 {n} S={S}: {e}")
        k7f.time_forms({"shape": "K8", "K": Kt, "A": A, "S": S,
                        "plan (threads)": plan,
                        "max_err": max(errs.values())}, forms)


def parent_ab(libs, gen, dev, shapes):
    """The parent checkout's K11c (through its former wrapper and alone)
    and K8 against this tree's."""
    old_t = k7f.bind(libs["twist_wide_kernels"], "launch_pair_ll_bwd_t", 10,
                     4)
    old_k8 = k7f.bind(libs["twist_kernels"], "launch_merge_loglik", 9, 3)
    for label, ins in shapes:
        M, KC = ins[2].shape[:2]
        A, S = ins[0].shape[1:]
        g = torch.randn((M, KC), generator=gen, device=dev)
        m1, m2, P_l, P_r, pi, w = ins

        def former_alone(ins=ins, g=g, KC=KC, M=M, A=A, S=S):
            o = [torch.empty_like(t) for t in ins[:3]]
            _ext.check(old_t(*[t.data_ptr() for t in (*ins, g, *o)], KC, M,
                             A, S, _ext.stream_ptr(dev)), "former K11c")
            return o

        def former(ins=ins, P_l=P_l, P_r=P_r, pi=pi, A=A):
            dm1, dm2, T = former_alone()
            dPl, dPr = kernels._dp_from_t(T, P_l, P_r, pi)
            dpi = torch.sum(dPl * P_l, dim=(0, 1, 2)) / pi
            return dm1, dm2, dPl, dPr, dpi

        new = with_t_field(lambda ins=ins, g=g: kernels.pair_ll_bwd(
            *ins, g, want_dw=False))
        launch, _, _ = cs.bwd_launch(kernels, ins, g, True)
        e = k7f.max_err(former()[:4], new()[:4])
        cs.require(e <= K11C_TOL, f"K11c former vs new {label}: {e}")
        k7f.ab(f"K11c {label}", {"M": M, "KC": KC, "A": A, "S": S,
                                 "max_rel_diff": e},
               former, new, {"former_alone": former_alone,
                             "new_alone": launch})
        torch.cuda.empty_cache()
    Kt, A = cs.K_TWIST, cs.A
    for S in K8_SITES:
        args = k8_inputs(gen, dev, S)

        def former(args=args, S=S):
            o = (torch.empty((Kt, A, S), device=dev),
                 torch.empty((Kt,), device=dev),
                 torch.empty((Kt,), device=dev))
            _ext.check(old_k8(*[t.data_ptr() for t in (*args, *o)], Kt, A,
                              S, _ext.stream_ptr(dev)), "former K8")
            return o

        def new(args=args):
            return kernels.merge_loglik(*args)
        e = k8_err(former(), new())
        cs.require(e <= K8_TOL, f"K8 former vs new S={S}: {e}")
        k7f.ab("K8", {"K": Kt, "A": A, "S": S, "max_diff": e}, former, new,
               {"launch_floor": lambda: torch.cuda._sleep(0)})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    out_dir = os.path.join(_ext.build_dir(), "k11c_k8_forms")
    os.makedirs(out_dir, exist_ok=True)
    procs = {name: k7f.build(name, "", out_dir)
             for name in ("twist_kernels", "twist_wide_kernels")}
    if args.parent:
        src = os.path.join(os.path.abspath(args.parent), "phylo_tpu_torch",
                           "csrc")
        for name in ("twist_kernels", "twist_wide_kernels"):
            procs[f"parent_{name}"] = k7f.build(name, "", out_dir, src,
                                                "parent")
    _ext.build_all()
    libs, ptx = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name.startswith("parent"):
            libs[name[len("parent_"):]] = ctypes.CDLL(so)
        else:
            ptx.update(k7f.ptxas_summary(log, (
                "pair_ll_bwd_t_", "merge_loglik_kernel",
                "pair_ll_bwd_narrow_kernel", "pair_ll_bwd_wide_kernel")))
    print(json.dumps({"ptxas": ptx}), flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shapes = twist_shapes(gen, dev)
    k11c_forms(gen, dev, shapes)
    k8_forms(gen, dev)
    if args.parent:
        parent_ab(libs, gen, dev, shapes)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
