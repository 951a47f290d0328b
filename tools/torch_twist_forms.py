"""The twist's pair-loglik kernels K11b, K7 wide and K11c on the card,
dense and blocked, against their plain versions and timed, without the
rest of chip_smoke.py: a quick check after an edit of
phylo_tpu_torch/csrc/twist_wide_kernels.cu.

    python tools/torch_twist_forms.py [--ptxas] [--spt 4,2,1]
                                      [--parent DIR]

Builds twist_wide_kernels.cu (with --ptxas, prints nvcc's registers,
shared memory and spills per kernel), runs chip_smoke.py's
`check_twist_kernels` (DS1 GTR+G4 rank 0 and primate at M=10, S=256, the
blocked forms against the dense ones and their A/B, protein+G4 rank 0
and its block groups, small odd shapes), and prints each kernel's line
entry and the card's name and power limit.  --parent DIR (a checkout of
the commit before, e.g. from git archive, unpacked under a gitignored
directory) also builds that checkout's twist_wide_kernels.cu and runs the
one-call A/B former, new, new, former at DS1 GTR+G4's launched shapes
(K11b blocked and dense at rank 0 through the wrappers; K7 wide blocked
at 896 rows and at rank 0, launch against launch, the new wrapper with
its dpi ops after each new): each former launch through the parent's
entry point at the plan it would take (one block group), held to this
tree's (1e-6).
With --spt, instead times K11b's sites-a-thread forms at DS1 GTR+G4 rank
0 (blocked G=4 x 4 and dense 16 states): a shim that includes the source
exports `run_fwd<AB, NG, SPT>` per form; each form is held to the one
the launcher picks (1e-6: the same chains, another split of the site
sum) and timed in the order first..last, last..first.  Needs a CUDA
device."""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def spt_forms(kernels, gen, dev, spts):
    """K11b's forms (AB, NG, SPT) at DS1 GTR+G4 rank 0, blocked and dense."""
    from phylo_tpu_torch import _ext

    out_dir = os.path.join(_ext.build_dir(), "forms")
    os.makedirs(out_dir, exist_ok=True)
    shim = os.path.join(out_dir, "twist_forms.cu")
    shapes = ((4, 4), (16, 1))
    lines = [f'#include "{os.path.join(_ext.CSRC, "twist_wide_kernels.cu")}"']
    for ab, ng in shapes:
        for spt in spts:
            lines.append(
                f'extern "C" int fwd_{ab}_{ng}_{spt}(const float* m1, '
                "const float* m2, const float* Pl, const float* Pr, "
                "const float* pi, const float* w, float* part, int KC, "
                "int M, int G, int Ab, int S, int threads, int tiles, "
                "void* stream) {\n  return run_fwd<"
                f"{ab}, {ng}, {spt}>(m1, m2, Pl, Pr, pi, w, part, KC, M, G, "
                "Ab, S, threads, tiles, false, "
                "static_cast<cudaStream_t>(stream));\n}")
    with open(shim, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    so = os.path.join(out_dir, "twist_forms.so")
    subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", so, shim],
                   check=True)
    lib = ctypes.CDLL(so)
    blocked = cs.twist_inputs(gen, dev, "hohna_data_1", "gtr+g4",
                              cs.N_DS1 * (cs.N_DS1 - 1) // 2, cs.S_BATCH,
                              blocked=True)
    for (ab, ng), ins in zip(shapes, (blocked,
                                      cs.dense_inputs(kernels, blocked))):
        M_, KC = ins[2].shape[:2]
        G = ins[2].shape[2] if ins[2].ndim == 5 else 1
        Ab, S = ins[2].shape[-1], ins[0].shape[-1]
        want = kernels.pair_ll_fwd(*ins)
        calls = {}
        for spt in spts:
            fn = getattr(lib, f"fwd_{ab}_{ng}_{spt}")
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            threads = min(kernels.FWD_MAX_THREADS,
                          max(32, kernels._ceil(kernels._ceil(S, spt), 32)
                              * 32))
            tiles = kernels._ceil(S, threads * spt)
            part = torch.empty((M_, KC, tiles), dtype=torch.float32,
                               device=dev)

            def call(fn=fn, part=part, threads=threads, tiles=tiles):
                code = fn(*(t.data_ptr() for t in ins), part.data_ptr(), KC,
                          M_, G, Ab, S, threads, tiles,
                          _ext.stream_ptr(dev))
                _ext.check(code, "K11b form")
                return part.sum(-1)

            err = cs.max_rel(call(), want)
            cs.require(err <= 1e-6, f"form SPT={spt}: rel err {err}")
            calls[spt] = call
        order = list(spts) + list(spts)[::-1]
        times = [(spt, cs.time_ms(calls[spt])) for spt in order]
        cs.log(f"K11b forms AB={ab} NG={ng} (G={G}, A_b={Ab}) KC={KC} "
               f"S={S}, SPT: ms in turns: " + ", ".join(
                   f"{spt}: {ms:.4f}" for spt, ms in times))
        # the launcher's form at fewer subsamples: the cost of a row (its
        # messages read once) against the cost of an (m, row)
        by_m = {}
        for m in (1, 2, 5, M_):
            sub = ins[:2] + tuple(P[:m].contiguous() for P in ins[2:4]) \
                + ins[4:]
            by_m[m] = cs.time_ms(lambda sub=sub: kernels.pair_ll_fwd(*sub))
        cs.log(f"K11b AB={ab} NG={ng} KC={KC} by M: " + ", ".join(
            f"M={m}: {ms:.4f} ms" for m, ms in by_m.items()))


def parent_ab(kernels, gen, dev, parent):
    """The parent checkout's K11b and K7 wide (one block group: the same
    chains) against this tree's wrappers at DS1 GTR+G4's launched shapes,
    in turns former, new, new, former."""
    from phylo_tpu_torch import _ext

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_k7_forms as k7f

    out_dir = os.path.join(_ext.build_dir(), "twist_parent")
    os.makedirs(out_dir, exist_ok=True)
    proc, so = k7f.build("twist_wide_kernels", "", out_dir, os.path.join(
        os.path.abspath(parent), "phylo_tpu_torch", "csrc"), "parent")
    log, _ = proc.communicate()
    cs.require(proc.returncode == 0, f"nvcc failed for the parent:\n{log}")
    lib = ctypes.CDLL(so)
    old_fwd = k7f.bind(lib, "launch_pair_ll_fwd", 7, 8)
    old_bwd = k7f.bind(lib, "launch_pair_ll_bwd_wide", 11, 8)
    full = cs.twist_inputs(gen, dev, "hohna_data_1", "gtr+g4",
                           cs.N_DS1 * (cs.N_DS1 - 1) // 2, cs.S_BATCH,
                           blocked=True)
    for label, ins in (("DS1 blocked rank 0", full),
                       ("DS1 dense rank 0", cs.dense_inputs(kernels, full))):
        M_, KC = ins[2].shape[:2]
        G = ins[2].shape[2] if ins[2].ndim == 5 else 1
        Ab, S = ins[2].shape[-1], ins[0].shape[-1]
        plan = kernels.twist_fwd_plan(G, Ab, S, M_)

        def former(ins=ins, plan=plan, KC=KC, M_=M_, G=G, Ab=Ab, S=S):
            part = torch.empty((M_, KC, plan[2]), device=dev)
            _ext.check(old_fwd(*(t.data_ptr() for t in ins),
                               part.data_ptr(), KC, M_, G, Ab, S, *plan,
                               _ext.stream_ptr(dev)), "former K11b")
            return part.sum(-1)

        def new(ins=ins):
            return kernels.pair_ll_fwd(*ins)
        err = cs.max_rel(former(), new())
        cs.require(err <= 1e-6, f"K11b former vs new {label}: {err}")
        k7f.ab(f"K11b {label}", {"M": M_, "KC": KC, "G": G, "A_b": Ab,
                                 "S": S, "max_rel_diff": err}, former, new)
    for label, ins in (("DS1 blocked KC=896", cs.first_rows(
            full, cs.K_TWIST * 28)), ("DS1 blocked rank 0", full)):
        M_, KC, G = ins[2].shape[:3]
        Ab, S = ins[2].shape[-1], ins[0].shape[-1]
        g = torch.randn((M_, KC), generator=gen, device=dev)

        def former(ins=ins, g=g, KC=KC, M_=M_, G=G, Ab=Ab, S=S):
            o = [torch.empty_like(t) for t in ins[:4]]
            _ext.check(old_bwd(*(t.data_ptr() for t in (*ins, g, *o)), KC,
                               M_, G, Ab, S, *kernels.twist_bwd_plan(G, Ab, S),
                               _ext.stream_ptr(dev)), "former K7 wide")
            return o

        new = cs.bwd_launch(kernels, ins, g, False)[0]
        err = max(cs.max_rel(a, b) for a, b in zip(former(), new()))
        cs.require(err <= 1e-6, f"K7 wide former vs new {label}: {err}")
        k7f.ab(f"K7 wide {label}", {"M": M_, "KC": KC, "G": G, "A_b": Ab,
                                    "S": S, "max_rel_diff": err}, former,
               new, {"new_wrapper": lambda ins=ins, g=g: kernels.pair_ll_bwd(
                   *ins, g, want_dw=False)})


def main(argv):
    if not torch.cuda.is_available():
        print("torch_twist_forms: no CUDA device visible", file=sys.stderr)
        return 1
    from phylo_tpu_torch import _ext
    from phylo_tpu_torch.pruning import kernels

    t0 = time.time()
    _ext.build_all(["twist_wide_kernels"], verbose="--ptxas" in argv)
    cs.log(f"built twist_wide_kernels in {time.time() - t0:.1f} s; card: "
           f"{cs.card_line()}; torch {torch.__version__}")
    cs.protein_files()                 # protein+G4's alignment, seed 0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if "--spt" in argv:
        spt_forms(kernels, gen, dev, [int(x) for x in
                                      argv[argv.index("--spt") + 1].split(",")])
        return 0
    if "--parent" in argv:
        parent_ab(kernels, gen, dev, argv[argv.index("--parent") + 1])
    entries = cs.check_twist_kernels(kernels, gen, dev)
    for name, entry in zip(("pair_loglik_fwd", "pair_loglik_fwd_blocked",
                            "pair_ll_bwd_wide", "pair_ll_bwd_wide_blocked",
                            "pair_ll_bwd_t", "pair_ll_bwd_t_blocked"),
                           entries):
        cs.log(f"{name}: {json.dumps(entry)}")
    cs.log(f"done in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
