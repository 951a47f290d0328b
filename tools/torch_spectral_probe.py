"""Probe the spectral models' capture and DS1 VNCSMC's repeatability on
one card: what `chip_smoke.py` does not check itself.

    python tools/torch_spectral_probe.py
        [--parts cond,sync,repeat,cost,loop] [--tree DIR]

* cond: whether this PyTorch's torch.cond runs eagerly with its
  backward, captures into a CUDA graph with it, and replays to the bits
  of the eager call, for a branch of plain torch ops and for a branch
  holding the eigh kernel's autograd.Function;
* sync: one eager SGD step of GY94, GY94+G4 and .dat+F+G4 (chip_smoke.py
  paths) after a warm-up step, under torch.cuda.set_sync_debug_mode
  ("error"): any host synchronisation raises;
* repeat: DS1 VNCSMC (GTR+G4, K=32, M=10, one 256-site batch): the loss
  and gradients of one step five times from one state, compared tensor
  by tensor; the step under torch.use_deterministic_algorithms(True,
  warn_only=True), its warnings listed; and a dispatcher trace of two
  runs (a checksum of every op's inputs and outputs) naming the first
  op whose result differs while its inputs agree;
* cost: what the device-side branch costs, `expm_reversible` with
  chain_fallback True (both branches computed, one kept by torch.where)
  against False (spectral only), forward and forward + backward, at the
  spectral paths' transition batches (GY94 and GY94+G4 K=128 on
  betacorona1's codons, .dat+F+G4 K=64: (ranks, 2K[, 4]) branch
  lengths), each captured as a CUDA graph and its replays timed
  (device time, no host dispatch), alternating in one call (CUDA
  events);
* loop: the routes that are not captured, where both branches cost
  host dispatches as well as device time: each spectral path 2 epochs
  with fused_epoch=False (the second epoch's seconds, and its device
  time and host dispatches under torch.profiler), then GY94 through the
  runner with --mesh=1 (NCCL, a world of one) and its second epoch's
  seconds.  With --tree DIR the package and chip_smoke.py are those of
  DIR (a `git archive` of another commit, unpacked under a gitignored
  directory), so two commits compare in one call: run the part once a
  tree, A, B, B, A.

Needs a CUDA card and nvcc; prints one JSON line a check and the card's
name and power limit.
"""

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
import warnings

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--tree" in sys.argv:
    ROOT = os.path.abspath(sys.argv[sys.argv.index("--tree") + 1])
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from phylo_tpu_torch import _ext  # noqa: E402


def emit(**row):
    print(json.dumps(row, default=str), flush=True)


def cond_part():
    from phylo_tpu_torch.models import eigh_kernel

    x0 = torch.randn(64, device="cuda", dtype=torch.float64)
    S0 = cs.eigh_cases()["dat 20"].to("cuda")

    def plain(pred, x):
        return torch.cond(pred, lambda x: torch.sin(x) * 2.0,
                          lambda x: torch.cos(x) + 1.0, (x,))

    def with_kernel(pred, x):
        def t(x):
            w, U = eigh_kernel.eigh(S0 * x[0])
            return (U * w).sum() * x
        return torch.cond(pred, t, lambda x: x * 3.0, (x,))

    for label, fn in (("plain ops", plain), ("eigh kernel", with_kernel)):
        row = {"part": "cond", "branch": label}
        pred = torch.tensor(True, device="cuda")
        x = x0.clone().requires_grad_(True)
        try:
            y = fn(pred, x)
            g, = torch.autograd.grad(y.sum(), x)
            row["eager"] = "ok"
        except Exception as e:   # noqa: BLE001 -- the probe reports it
            row["eager"] = f"{type(e).__name__}: {str(e)[:300]}"
            emit(**row)
            continue
        try:
            graph = torch.cuda.CUDAGraph()
            xs = x0.clone().requires_grad_(True)
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                fn(pred, xs)
            torch.cuda.current_stream().wait_stream(s)
            with torch.cuda.graph(graph):
                ys = fn(pred, xs)
                gs, = torch.autograd.grad(ys.sum(), xs)
            graph.replay()
            torch.cuda.synchronize()
            row["capture"] = "ok"
            row["replay_bits"] = bool(torch.equal(ys, y)
                                      and torch.equal(gs, g))
        except Exception as e:   # noqa: BLE001
            row["capture"] = f"{type(e).__name__}: {str(e)[:300]}"
        emit(**row)


SPECTRAL = ("gy94_codon", "gy94_g4", "protein_dat_f_g4")


def path_state(name):
    from phylo_tpu_torch.train import TrainConfig
    from phylo_tpu_torch.train.trainer import (
        _optimizer, _sweep_config, init_params, param_tensors,
    )

    path = cs.PATHS[name]
    ds = cs.load(path["dataset"], path.get("codons", False))
    cfg = TrainConfig(batch_size=cs.S_BATCH, device="cuda",
                      save_artifacts=False, **path["train"])
    model, params = init_params(ds, cfg)
    genome = (model.expand_leaves(ds.genome)
              if hasattr(model, "expand_leaves") else ds.genome)
    leaves = torch.tensor(genome, dtype=torch.float32, device="cuda")
    batch = leaves[:, :cs.S_BATCH].contiguous()
    opt = _optimizer(cfg, param_tensors(params))
    return model, params, _sweep_config(cfg), batch, opt


def sync_part():
    from phylo_tpu_torch.train.trainer import sgd_step

    for name in SPECTRAL:
        model, params, sweep_cfg, batch, opt = path_state(name)
        row = {"part": "sync", "path": name}
        gen = torch.Generator(device="cuda").manual_seed(3)
        sgd_step(model, params, opt, sweep_cfg, gen, batch)   # warm-up
        torch.cuda.synchronize()
        gen.manual_seed(4)
        try:
            torch.cuda.set_sync_debug_mode("error")
            loss = sgd_step(model, params, opt, sweep_cfg, gen, batch)
            torch.cuda.set_sync_debug_mode(0)
            row["sync_free_step"] = True
            row["loss"] = float(loss)
        except Exception as e:   # noqa: BLE001
            torch.cuda.set_sync_debug_mode(0)
            row["sync_free_step"] = False
            row["error"] = f"{type(e).__name__}: {str(e)[:300]}"
            row["where"] = traceback.format_exc()[-1500:]
        emit(**row)


class _Trace(torch.utils._python_dispatch.TorchDispatchMode):
    """Checksums (int64 sums of the bits) of every op's tensor inputs
    and outputs, kept on the card."""

    def __init__(self):
        super().__init__()
        self.rows = []

    @staticmethod
    def _sum(t):
        if not isinstance(t, torch.Tensor) or not t.is_cuda or not t.numel():
            return None
        t = t.detach().contiguous()
        if t.dtype == torch.float32:
            t = t.view(torch.int32)
        elif t.dtype == torch.float64:
            t = t.view(torch.int64)
        elif t.is_floating_point() or t.is_complex():
            return None
        return t.to(torch.int64).sum()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat_in = torch.utils._pytree.tree_leaves((args, kwargs))
        ins = [self._sum(t) for t in flat_in]
        out = func(*args, **kwargs)
        outs = [self._sum(t) for t in torch.utils._pytree.tree_leaves(out)]
        shapes = [tuple(t.shape) for t in flat_in
                  if isinstance(t, torch.Tensor)]
        self.rows.append((str(func), ins, outs, shapes))
        return out


def repeat_part():
    from phylo_tpu_torch.smc.sweep import sample_phylogenies
    from phylo_tpu_torch.train import TrainConfig
    from phylo_tpu_torch.train.trainer import (
        _sweep_config, init_params, param_tensors,
    )

    path = cs.PATHS["vncsmc_gtr_g4_ds1"]
    ds = cs.load(path["dataset"])
    cfg = TrainConfig(batch_size=cs.S_BATCH, device="cuda",
                      save_artifacts=False, **path["train"])
    model, params = init_params(ds, cfg)
    leaves = torch.tensor(model.expand_leaves(ds.genome),
                          dtype=torch.float32, device="cuda")
    batch = leaves[:, :cs.S_BATCH].contiguous()
    sweep_cfg = _sweep_config(cfg)
    tensors = param_tensors(params)

    def step():
        for t in tensors:
            t.grad = None
        gen = torch.Generator(device="cuda").manual_seed(11)
        loss = -sample_phylogenies(gen, batch, model, params,
                                   sweep_cfg).elbo
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach().clone(), [t.grad.clone() for t in tensors]

    runs = [step() for _ in range(5)]
    names = [f"{i}:{tuple(t.shape)}" for i, t in enumerate(tensors)]
    differ = {}
    for r in runs[1:]:
        for n, a, b in zip(names, runs[0][1], r[1]):
            if not torch.equal(a, b):
                differ[n] = max(differ.get(n, 0.0),
                                float((a - b).abs().max()))
    emit(part="repeat", losses=[float(r[0]) for r in runs],
         losses_equal=all(torch.equal(r[0], runs[0][0]) for r in runs),
         grads_that_differ=differ)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step()
        finally:
            torch.use_deterministic_algorithms(False)
    msgs = sorted({str(w.message)[:240] for w in caught})
    emit(part="repeat", deterministic_warnings=msgs)

    traces = []
    check = _ext.check
    for _ in range(2):
        tr = _Trace()

        def marked(code, what, tr=tr):
            tr.rows.append((f"kernel {what}", [], [], []))
            return check(code, what)

        _ext.check = marked
        try:
            with tr:
                step()
        finally:
            _ext.check = check
        traces.append(tr.rows)
    a, b = traces
    emit(part="repeat", ops=[len(a), len(b)])

    def host(xs):
        return [None if x is None else int(x) for x in xs]

    # an op whose inputs agree and outputs differ varies by itself; one
    # whose inputs differ first after agreeing ops read a hand-written
    # kernel's output (the kernel rows say which ran before)
    varies, fed = [], []
    for i, (ra, rb) in enumerate(zip(a, b)):
        if ra[0] != rb[0]:
            varies.append({"op": i, "kind": "different op", "a": ra[0],
                           "b": rb[0]})
            break
        if "empty" in ra[0]:
            continue
        ia, ib = host(ra[1]), host(rb[1])
        oa, ob = host(ra[2]), host(rb[2])
        row = {"op": i, "name": ra[0], "shapes": ra[3],
               "previous": [r[0] for r in a[max(0, i - 8):i]]}
        if ia == ib and oa != ob and len(varies) < 6:
            varies.append(row)
        elif ia != ib and oa != ob and len(fed) < 6:
            row["inputs_that_differ"] = [
                k for k, (x, y) in enumerate(zip(ia, ib)) if x != y]
            fed.append(row)
        if len(varies) >= 6 and len(fed) >= 6:
            break
    emit(part="repeat", varies_by_itself=varies, reads_a_difference=fed)


def graph_of(fn):
    """fn captured as a CUDA graph (`_ext.CountedGraph`, as the fused
    epoch captures: a warm-up call and the capture on one side stream):
    its replay times the device work alone, not the host's dispatch."""
    graph = _ext.CountedGraph(torch.device("cuda"))
    graph.capture(fn)
    return graph


def cost_part():
    from phylo_tpu_torch.models.expm import expm_reversible

    for name in SPECTRAL:
        model, params, _, batch, _ = path_state(name)
        base = getattr(model, "base", model)
        bp = params["model"].get("base", params["model"])
        f64 = dict(dtype=torch.float64, device="cuda")
        # detached: their autograd history was recorded on the default
        # stream, which a capture may not make wait
        Q = base.Q(bp, **f64).detach().to(torch.float64)
        pi = base.stationary(bp, **f64).detach().to(torch.float64)
        R, K = batch.shape[0] - 1, cs.PATHS[name]["train"]["n_particles"]
        shape = (R, 2 * K) + ((4,) if hasattr(model, "blocks") else ())
        gen = torch.Generator(device="cuda").manual_seed(0)
        b = torch.empty(shape, device="cuda").exponential_(generator=gen)
        b = (0.1 * b).requires_grad_(True)
        Qg = Q.clone().requires_grad_(True)
        G = torch.randn(shape + Q.shape, device="cuda", generator=gen)

        def fwd(fallback):
            with torch.no_grad():
                expm_reversible(Q, pi, b, chain_fallback=fallback)

        def fwd_bwd(fallback):
            P = expm_reversible(Qg, pi, b, chain_fallback=fallback)
            torch.autograd.grad(torch.sum(G * P), (Qg, b))

        row = {"part": "cost", "path": name, "batch": list(shape)}
        for label, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
            graphs = {f: graph_of(lambda f=f: fn(f)) for f in (False, True)}
            t = {True: [], False: []}
            for fallback in (False, True, True, False):
                t[fallback].append(cs.time_ms(graphs[fallback].replay,
                                              iters=10))
            row[label] = {"spectral_only_ms": t[False],
                          "both_branches_ms": t[True]}
        emit(**row)


def loop_part():
    import torch.distributed as dist

    from phylo_tpu_torch.cli import runner

    tree = os.path.relpath(ROOT, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for name in SPECTRAL:
        r = cs.fused_run(_ext, name, False, profiled=True)
        t = r["profile"]["trace"]
        emit(part="loop", tree=tree, path=name, s_per_epoch=r["epoch_s"],
             device_ms=t["device_ms"], busy=t["device_ms"]
             / r["profile"]["wall_ms"], host_dispatches=t["dispatches"],
             captured=r["res"].graphs["captured"])
        del r
        torch.cuda.empty_cache()
    path = cs.PATHS["gy94_codon"]
    res = runner.run([f"--dataset={path['dataset']}",
                      f"--batch_size={cs.S_BATCH}", "--num_epoch=2",
                      "--no_artifacts", "--device=cuda", "--mesh=1"]
                     + path["argv"])
    emit(part="loop", tree=tree, path="gy94_codon --mesh=1",
         backend=dist.get_backend(),
         s_per_epoch=res.history["epoch_seconds"][-1],
         captured=res.graphs["captured"])
    dist.destroy_process_group()


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="cond,sync,repeat,cost,loop")
    ap.add_argument("--tree", default=None,
                    help="another checkout whose package and chip_smoke.py "
                    "to run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.time()
    _ext.build_all()
    emit(card=cs.card_line(), torch=torch.__version__,
         cuda=torch.version.cuda, built_s=round(time.time() - t0, 1))
    cs.protein_files()
    for part in args.parts.split(","):
        t = time.time()
        try:
            globals()[f"{part}_part"]()
        except Exception:   # noqa: BLE001 -- report and go on
            emit(part=part, failed=traceback.format_exc()[-3000:])
        emit(part=part, seconds=round(time.time() - t, 1))
    return 0


if __name__ == "__main__":
    with contextlib.suppress(KeyboardInterrupt):
        sys.exit(main(sys.argv[1:]))
