"""Variational training loop: SGD/Adam ascent on the log Z_SMC ELBO (port
of phylo_tpu/train/trainer.py).

Each epoch runs floor(S / batch_size) minibatch SGD steps and then one
full-S eval sweep, as the reference does (vcsmc.py:466-591).  Random
streams are a pure function of (seed, epoch, step): every step and eval
draws from a torch.Generator seeded from numpy's SeedSequence of that
triple, and the site batches come from numpy's default_rng((seed,
epoch)) exactly as in the JAX package.

The fused epoch (TrainConfig.fused_epoch, on by default, as in the JAX
package, which runs an epoch's steps as one jitted lax.scan): on the
card the SGD step and the eval sweep are each captured once as a CUDA
graph and replayed, one host dispatch a step and one an eval in place
of one a kernel.  The first call of each runs eagerly (it is the run's
real first step / first eval and the warm-up that builds and binds the
kernels); the graph is captured right after it and replayed at every
later call.  A replay reads the batch's site indices from a static device
tensor and draws from a generator registered with the graph and
reseeded to the loop's (seed, epoch, step) seed, so the values are the
loop's.  `capture_plan` says, from the configuration alone, whether a
run is captured: every model on one card (the spectral GY94 and .dat
models too: `expm_reversible` decides its eigengap on the device and
decomposes with a kernel), not on the CPU (no graphs; the loop gives
the same values), nor on a mesh (gloo cannot be captured; NCCL capture
is not tried).  A failed capture or replay raises.

Checkpoints (train/checkpoint.py) hold the parameters, the optimizer's
state and the history; with those streams, a run resumed from the
epoch-e checkpoint replays epochs e.. bit for bit on the CPU.  A restore
copies into the tensors the graphs hold, before they are captured.

On a mesh (TrainConfig.mesh_shape; one process per device, see
parallel/) every rank draws the same site batches and random streams,
pads a batch to the 's' size with weight-0 all-ones columns and sweeps
its block; the sweep sums the gradients over the mesh, so every rank's
optimizer steps on the same gradients and the parameters stay
bit-identical across ranks (checked every epoch).  Rank 0 alone writes
results, trees and checkpoints; a resume restores on every rank.

Runs on ``cuda`` unless TrainConfig.device says "cpu".
"""

from __future__ import annotations

import math
import os
import signal
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from phylo_tpu_torch import _ext
from phylo_tpu_torch.device import resolve_device, resolve_dtype
from phylo_tpu_torch.models.branches import branch_rates, init_branch_params
from phylo_tpu_torch.models.substitution import (
    FreeRates, GammaSites, clear_memos, get_model,
)
from phylo_tpu_torch.params import flatten
from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies
from phylo_tpu_torch.smc.twist import TwistConfig
from phylo_tpu_torch.train.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint,
)
from phylo_tpu_torch.train.minibatch import site_batches
from phylo_tpu_torch.viz.trees import _lineage, jump_chain_evolution, to_newick

INITIAL_EVAL_STEP = 2 ** 31 - 1


@dataclass
class TrainConfig:
    """Training configuration; field names mirror the JAX package's
    TrainConfig (reference runner.py:12-58).  A gy94 model takes the
    dataset's F61 codon frequencies."""

    n_particles: int = 128
    batch_size: int = 256            # sites per SGD step
    learning_rate: float = 0.001
    num_epoch: int = 100
    M: int = 10                      # twisting subparticles (nested=True)
    nested: bool = False             # VNCSMC (twisted proposals)
    optimizer: str = "GradientDescentOptimizer"   # or 'Adam' / 'sgd' / 'adam'
    branch_prior: float = float(np.log(10.0))
    jcmodel: bool = False
    substitution_model: Optional[str] = None
    # empirical amino-acid model from a PAML .dat file (LG/WAG/JTT...):
    # overrides substitution_model; plus_f makes the stationary
    # frequencies learnable (+F), initialized at the file's values
    paml_dat: Optional[str] = None
    plus_f: bool = False
    # across-site rate mixtures (the spec's +g/+i/+r as flags):
    # discrete Gamma with this many categories (0/1 = off), a learnable
    # proportion of invariant sites, or FreeRates with gamma_categories
    # learnable categories (exclusive with invariant_sites)
    gamma_categories: int = 0
    invariant_sites: bool = False
    free_rates: bool = False
    resampling: str = "multinomial"
    dtype: str = "float32"
    seed: int = 0
    q_raw_subtraction: bool = True
    resample_branch_history: bool = False
    right_multiplier_bug: bool = True
    fixed_partition: bool = False
    ess_threshold: Optional[float] = None
    carried_weights: bool = False
    results_dir: Optional[str] = None
    save_artifacts: bool = True
    # the best particle's Newick each epoch (history["newick_best"])
    collect_trees: bool = True
    # all K particles' jump chains each epoch (reference
    # jump_chain_evolution, vcsmc.py:324,424-425,622-642), decoded on the
    # host only when artifacts are saved
    collect_jump_chains: bool = True
    checkpoint_every: int = 0        # epochs; 0 = off
    # stable checkpoint directory; None = <save_dir>/ckpt (timestamped,
    # so not found again after a restart: set it for elastic runs)
    checkpoint_dir: Optional[str] = None
    # a checkpoint (or its directory) to resume from, or "auto": the
    # latest one in checkpoint_dir (a fresh run when there is none yet)
    resume_from: Optional[str] = None
    # "sigkill:E" kills the process (as a preemption would) and
    # "raise:E" raises RuntimeError, at the start of epoch E; only when
    # the run reached E by training (start_epoch < E), so a resumed run
    # passes the fault point
    fault_injection: Optional[str] = None
    # sharding: a mesh shape over the process group (a 1-element shape
    # is a site mesh ('s',), two elements ('k', 's')), None = one device
    mesh_shape: Optional[tuple] = None
    log_every: int = 1
    log_params: bool = False
    # an epoch's SGD steps and its eval sweep as CUDA graph replays, one
    # host dispatch each (where `capture_plan` admits the run); the
    # values are the step-by-step loop's
    fused_epoch: bool = True
    device: Optional[str] = None     # None = cuda


@dataclass
class TrainState:
    params: dict
    opt_state: object
    epoch: int = 0


@dataclass
class TrainResult:
    params: dict
    history: dict = field(repr=False)
    save_dir: Optional[str] = None
    elbo: float = float("nan")
    # the fused epoch: {"captured", "reason", "capture_seconds",
    # "replays" (graph replays an epoch)}
    graphs: dict = field(default_factory=dict, repr=False)


def step_seed(seed, epoch, step):
    """The 64-bit generator seed of (seed, epoch, step); step 0 is the
    epoch's eval sweep, 1.. its SGD steps (the JAX package's fold_in
    layout)."""
    word = np.random.SeedSequence([seed, epoch, step]).generate_state(
        2, dtype=np.uint32)
    return int(word[0]) << 32 | int(word[1])


def step_generator(seed, epoch, step, device):
    """A torch.Generator seeded with `step_seed(seed, epoch, step)`."""
    g = torch.Generator(device=device)
    g.manual_seed(step_seed(seed, epoch, step))
    return g


def _optimizer(config, tensors):
    name = config.optimizer.lower()
    if name == "adam":
        # capturable on the card, fused epoch or not, so both give the
        # same bits: its step count and bias corrections stay there
        cuda = any(t.is_cuda for t in tensors)
        return torch.optim.Adam(tensors, lr=config.learning_rate,
                                capturable=cuda)
    if name in ("gradientdescentoptimizer", "sgd", "gradient_descent"):
        return torch.optim.SGD(tensors, lr=config.learning_rate)
    raise KeyError(f"unknown optimizer {config.optimizer!r}")


def _sweep_config(config):
    twist = TwistConfig(M=config.M) if config.nested else None
    return SweepConfig(
        K=config.n_particles,
        resampling=config.resampling,
        q_raw_subtraction=config.q_raw_subtraction,
        resample_branch_history=config.resample_branch_history,
        right_multiplier_bug=config.right_multiplier_bug,
        ess_threshold=config.ess_threshold,
        carried_weights=config.carried_weights,
        twist=twist,
        # the trainer differentiates params only: the twist's reverse
        # pass skips the data cotangents
        data_grads=False,
    )


def param_tensors(params):
    """The leaf tensors of a nested parameter dict, in sorted key order."""
    return flatten(params)[1]


def init_params(dataset, config, device=None):
    """(model, params) with params a {"model", "branches"} dict of leaf
    tensors that require grad."""
    dev = resolve_device(config.device if device is None else device)
    dtype = resolve_dtype(config.dtype, dev)
    if config.paml_dat:
        from phylo_tpu_torch.models.empirical import EmpiricalProtein

        model = EmpiricalProtein.from_paml(config.paml_dat,
                                           plus_f=config.plus_f)
        if model.A != dataset.A:
            raise ValueError(
                f"empirical protein model has A={model.A} states but the "
                f"dataset has A={dataset.A}")
    else:
        name = config.substitution_model or (
            "jc69" if config.jcmodel else "reference")
        model = _resolve_codon_frequencies(get_model(name, A=dataset.A),
                                           dataset)
    model = _rate_mixture(model, config)
    params = {
        "model": model.init_params(dtype, dev),
        "branches": init_branch_params(
            dataset.N, branch_prior=config.branch_prior, dtype=dtype,
            device=dev),
    }
    for t in param_tensors(params):
        t.requires_grad_(True)
    return model, params


def _resolve_codon_frequencies(model, dataset):
    """GY94 from the spec parser carries uniform codon frequencies;
    replace them with the alignment's empirical F61 counts (the standard
    default), and refuse a dataset that is not codon-encoded."""
    from phylo_tpu_torch.models.codon import GY94

    base = getattr(model, "base", model)
    if not isinstance(base, GY94):
        return model
    if dataset.A != GY94.A:
        raise ValueError(
            f"GY94 needs a codon-encoded dataset (A={GY94.A}); this "
            f"dataset has A={dataset.A} -- pass --codons (or "
            "dataio.codons.codon_dataset)")
    from phylo_tpu_torch.dataio.codons import empirical_codon_frequencies

    freqs = empirical_codon_frequencies(dataset.genome)
    new_base = GY94(freqs, plus_f=base.plus_f, normalize=base.normalize,
                    spectral=base.spectral)
    if base is model:
        return new_base
    import copy

    wrapped = copy.copy(model)
    wrapped.base = new_base
    return wrapped


def _rate_mixture(model, config):
    """Wrap `model` in the rate mixture the flags ask for (the JAX
    trainer's rule); a spec that already has one refuses the flags."""
    flags = (config.gamma_categories or config.invariant_sites
             or config.free_rates)
    if hasattr(model, "expand_leaves") and flags:
        raise ValueError(
            "substitution_model spec already includes a rate mixture "
            "(+g/+i/+r); drop the gamma_categories/invariant_sites/"
            "free_rates flags")
    if config.free_rates:
        if config.invariant_sites:
            raise ValueError(
                "free_rates and invariant_sites are mutually exclusive "
                "(FreeRates can learn a near-zero-rate category)")
        return FreeRates(model, G=max(config.gamma_categories, 2))
    if config.gamma_categories > 1 or config.invariant_sites:
        return GammaSites(model, G=max(config.gamma_categories, 1),
                          invariant=config.invariant_sites)
    return model


def sgd_step(model, params, optimizer, sweep_cfg, generator, batch, *,
             decisions=None, shardings=None, set_to_none=True):
    """One ascent step on the ELBO of `batch` (N, B, A); returns the
    loss (-ELBO) as a 0-d tensor (not synchronised).  On a mesh `batch`
    is the whole batch and each rank sweeps its block of it.
    set_to_none=False zeroes existing gradients in place (the fused
    epoch's graphs keep them outside their memory pool)."""
    optimizer.zero_grad(set_to_none=set_to_none)
    batch, weights = shard_batch(batch, shardings)
    loss = -sample_phylogenies(generator, batch, model, params, sweep_cfg,
                               decisions=decisions, site_weights=weights,
                               shardings=shardings).elbo
    loss.backward()
    optimizer.step()
    return loss.detach()


def shard_batch(batch, shardings):
    """(this rank's block of the (N, B, A) batch, its site weights): the
    batch padded to a multiple of the 's' size with weight-0 all-ones
    columns (weights None where nothing was padded)."""
    if shardings is None:
        return batch, None
    N, B, A = batch.shape
    pad = (-B) % shardings.site_multiple()
    weights = None
    if pad:
        batch = torch.cat([batch, batch.new_ones((N, pad, A))], dim=1)
        weights = torch.cat([batch.new_ones((B,)), batch.new_zeros((pad,))])
        weights = weights[shardings.sites(B + pad)]
    return batch[:, shardings.sites(B + pad)].contiguous(), weights


def evaluate(model, params, sweep_cfg, generator, leaves, *,
             site_weights=None, shardings=None):
    """Full-data sweep without gradients (the per-epoch eval)."""
    with torch.no_grad():
        return sample_phylogenies(generator, leaves, model, params,
                                  sweep_cfg, site_weights=site_weights,
                                  shardings=shardings)


def capture_plan(config, shardings=None, device=None):
    """(captured, reason): whether `train` runs this configuration's SGD
    steps and eval sweeps as CUDA graph replays (TrainConfig.fused_epoch),
    decided from the configuration before the run (every model alike);
    touches no device."""
    dev = torch.device(device or config.device or "cuda")
    if not config.fused_epoch:
        return False, "off (fused_epoch=False): one host dispatch a kernel"
    if dev.type != "cuda":
        return False, ("not captured on the CPU: no CUDA graphs there; "
                       "the loop gives the same values")
    if shardings is not None or config.mesh_shape:
        return False, ("not captured on a mesh: gloo cannot be captured "
                       "and NCCL capture is not tried")
    return True, ("captured: one CUDA graph replay an SGD step and one an "
                  "eval sweep")


class _FusedEpoch:
    """The fused epoch's two CUDA graphs, the SGD step's and the eval
    sweep's, sharing one memory pool (they never run at once).  Each
    runs eagerly at its first call, is captured right after it and
    replayed at every later call; a replay's inputs are the static
    site-index tensor and the generator reseeded before it.  The
    gradients stay outside the pool (zeroed in place), so neither graph's
    replay can overwrite them; the eval's static outputs are read before
    the next step.  The rate mixtures' memo is cleared around a capture
    and after each replay (a replay bumps no tensor version)."""

    def __init__(self, model, params, optimizer, sweep_cfg, leaves, B,
                 dev):
        self.model, self.params = model, params
        self.optimizer, self.sweep_cfg = optimizer, sweep_cfg
        self.leaves, self.dev = leaves, dev
        self.idx = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.gens = {"step": torch.Generator(device=dev),
                     "eval": torch.Generator(device=dev)}
        self.graphs, self.outs = {}, {}
        self.pool = None

    def _step(self):
        return sgd_step(self.model, self.params, self.optimizer,
                        self.sweep_cfg, self.gens["step"],
                        self.leaves.index_select(1, self.idx),
                        set_to_none=False)

    def _eval(self):
        return evaluate(self.model, self.params, self.sweep_cfg,
                        self.gens["eval"], self.leaves)

    def _run(self, name, fn, seed):
        self.gens[name].manual_seed(seed)
        g = self.graphs.get(name)
        if g is not None:
            g.replay()
            clear_memos(self.model)
            return self.outs[name]
        g = _ext.CountedGraph(self.dev, generators=(self.gens[name],),
                              pool=self.pool)
        # the eager call is the run's own call and the warm-up
        out, self.outs[name] = g.capture(
            fn, reset=lambda: clear_memos(self.model))
        clear_memos(self.model)
        if self.pool is None:
            self.pool = g.graph.pool()
        self.graphs[name] = g
        return out

    def step(self, seed, idx):
        """One SGD step on the sites `idx` (B,), a device tensor."""
        self.idx.copy_(idx)
        self._run("step", self._step, seed)

    def evaluate(self, seed):
        """The eval sweep; its SweepResult holds the graph's static
        outputs after a replay: read it before the next step."""
        return self._run("eval", self._eval, seed)

    def release(self):
        """Drop the graphs and their static outputs."""
        self.graphs.clear()
        self.outs.clear()
        clear_memos(self.model)

    def replays(self):
        return sum(g.replays for g in self.graphs.values())

    def capture_seconds(self):
        return sum(g.capture_seconds for g in self.graphs.values())


def train(dataset, config: TrainConfig):
    """Train on a PhyloDataset; returns TrainResult."""
    dev = resolve_device(config.device)
    dtype = resolve_dtype(config.dtype, dev)
    model, params = init_params(dataset, config, device=dev)
    sweep_cfg = _sweep_config(config)
    optimizer = _optimizer(config, param_tensors(params))
    genome = dataset.genome
    if hasattr(model, "expand_leaves"):
        genome = model.expand_leaves(genome)     # rate mixture: A -> G*A
    leaves = torch.tensor(genome, dtype=dtype, device=dev)
    S = dataset.S
    # on a mesh: the eval's leaves padded to the 's' size (weight-0
    # columns) and this rank's block of them; rank 0 writes
    shardings, eval_leaves, eval_weights, writer = None, leaves, None, True
    if config.mesh_shape:
        from phylo_tpu_torch.parallel import (
            make_mesh, pad_sites, shard_leaves, sweep_sharding,
        )

        shardings = sweep_sharding(make_mesh(tuple(config.mesh_shape),
                                             device=dev))
        writer = shardings.mesh.rank == 0
        padded, w = pad_sites(genome, shardings.site_multiple())
        eval_leaves = torch.tensor(shard_leaves(padded, shardings),
                                   dtype=dtype, device=dev)
        if padded.shape[1] != genome.shape[1]:
            eval_weights = torch.tensor(w[shardings.sites(len(w))],
                                        dtype=dtype, device=dev)

    start_epoch, restored_history = 0, None
    resume_from = config.resume_from
    if resume_from == "auto":
        if not config.checkpoint_dir:
            raise ValueError("resume_from='auto' needs checkpoint_dir")
        resume_from = latest_checkpoint(config.checkpoint_dir)
    if resume_from:
        start_epoch, restored_history = restore_checkpoint(
            resume_from, params, optimizer)

    captured, reason = capture_plan(config, shardings, dev)
    if writer and config.log_every:
        print(f"Fused epoch: {reason}")
    fused = None
    if captured:
        fused = _FusedEpoch(model, params, optimizer, sweep_cfg, leaves,
                            config.batch_size, dev)
    graphs = {"captured": captured, "reason": reason,
              "capture_seconds": 0.0, "replays": []}

    def eval_sweep(seed):
        if fused is not None:
            return fused.evaluate(seed)
        return evaluate(model, params, sweep_cfg,
                        torch.Generator(device=dev).manual_seed(seed),
                        eval_leaves, site_weights=eval_weights,
                        shardings=shardings)

    try:
        initial_elbo = None
        if config.log_every:
            res0 = eval_sweep(step_seed(config.seed, INITIAL_EVAL_STEP, 0))
            initial_elbo = float(res0.elbo)
            if writer:
                print(f"Initial evaluation of ELBO: {initial_elbo:.3f}")

        save_dir = None
        if config.save_artifacts and writer:
            from phylo_tpu_torch.train.results import (
                make_save_dir, write_run_params,
            )

            save_dir = make_save_dir(config, dataset)
            write_run_params(save_dir, config, dataset)

        history = {
            "elbo": [], "Qmatrices": [], "stationary": [],
            "left_branches": [], "right_branches": [],
            "log_weights": [], "log_lik": [], "log_lik_R": [],
            "rates_l": [], "rates_r": [], "epoch_seconds": [],
            "newick_best": [], "jump_chain_evolution": [],
            "ancestors": [], "merged_nodes": [],
        }
        if restored_history is not None:
            # keep the epochs before the resume, so results.p indices match
            # epoch numbers
            for k, v in restored_history.items():
                if k in history:
                    history[k] = list(v)
        ckpt_dir = config.checkpoint_dir or (
            os.path.join(save_dir, "ckpt") if save_dir else None)
        if not writer:
            ckpt_dir = None
        fixed_batches = None
        if config.fixed_partition:
            fixed_batches = list(site_batches(
                np.random.default_rng(config.seed), S, config.batch_size,
                drop_last=True))

        for epoch in range(start_epoch, config.num_epoch):
            if config.fault_injection:
                _inject_fault(config.fault_injection, epoch, start_epoch)
            t0 = time.time()
            batches = fixed_batches if fixed_batches is not None else list(
                site_batches(np.random.default_rng((config.seed, epoch)), S,
                             config.batch_size, drop_last=True))
            replays = fused.replays() if fused is not None else 0
            if fused is not None and batches:
                # the epoch's site indices in one copy; a step's is a device
                # copy into the graph's static input
                all_idx = torch.as_tensor(np.stack(batches), device=dev)
                for i, idx in enumerate(all_idx):
                    fused.step(step_seed(config.seed, epoch, 1 + i), idx)
            else:
                for i, site_idx in enumerate(batches):
                    idx = torch.as_tensor(np.asarray(site_idx), device=dev)
                    sgd_step(model, params, optimizer, sweep_cfg,
                             step_generator(config.seed, epoch, 1 + i, dev),
                             leaves.index_select(1, idx), shardings=shardings)
            res = eval_sweep(step_seed(config.seed, epoch, 0))
            elbo = float(res.elbo)
            if fused is not None:
                graphs["replays"].append(fused.replays() - replays)
                graphs["capture_seconds"] = fused.capture_seconds()
            dt = time.time() - t0
            if shardings is not None:
                from phylo_tpu_torch.parallel.collectives import (
                    check_replicated,
                )

                check_replicated(shardings, param_tensors(params))

            with torch.no_grad():
                history["elbo"].append(elbo)
                history["Qmatrices"].append(_np(model.Q(
                    params["model"], dtype=dtype, device=dev)))
                history["stationary"].append(_np(model.stationary(
                    params["model"], dtype=dtype, device=dev)))
                history["left_branches"].append(_np(res.left_branches))
                history["right_branches"].append(_np(res.right_branches))
                history["log_weights"].append(_np(res.log_weights))
                history["log_lik"].append(_np(res.log_likelihood))
                history["log_lik_R"].append(_np(res.log_likelihood_R))
                rl, rr = branch_rates(params["branches"])
                history["rates_l"].append(_np(rl))
                history["rates_r"].append(_np(rr))
                history["epoch_seconds"].append(dt)
                history["ancestors"].append(_np(res.ancestors))
                history["merged_nodes"].append(_np(res.merged_nodes))
            if config.collect_trees:
                history["newick_best"].append(best_newick(
                    dataset.taxa, history["ancestors"][-1],
                    history["merged_nodes"][-1], history["left_branches"][-1],
                    history["right_branches"][-1], history["log_weights"][-1]))
            if config.collect_jump_chains and save_dir:
                history["jump_chain_evolution"].append(jump_chain_evolution(
                    dataset.taxa, history["ancestors"][-1],
                    history["merged_nodes"][-1]))

            if (config.log_every and writer
                    and epoch % config.log_every == 0):
                llr_max = float(np.max(history["log_lik_R"][-1]))
                print(f"epoch {epoch + 1}/{config.num_epoch}  "
                      f"ELBO {elbo:.3f}  log_lik_R max {llr_max:.3f}  "
                      f"{dt:.2f}s")
                if config.log_params:
                    with np.printoptions(precision=4, suppress=True):
                        print(f"Q matrix:\n{history['Qmatrices'][-1]}")
                        print(f"stationary: {history['stationary'][-1]}")
                        print(f"branch rates L: {history['rates_l'][-1]}")
                        print(f"branch rates R: {history['rates_r'][-1]}")

            if (config.checkpoint_every and ckpt_dir
                    and (epoch + 1) % config.checkpoint_every == 0):
                save_checkpoint(ckpt_dir, params, optimizer, epoch + 1,
                                history=history)
    finally:
        # the graphs' memory pool is freed once nothing holds them: a
        # reference cycle can keep this frame alive until the collector
        # runs, so drop them (and the eval's static outputs) here
        res0 = res = None
        if fused is not None:
            fused.release()

    if save_dir:
        from phylo_tpu_torch.train.results import save_results

        save_results(save_dir, config, dataset, history)
    final_elbo = history["elbo"][-1] if history["elbo"] else math.nan
    return TrainResult(params=params, history=history, save_dir=save_dir,
                       elbo=final_elbo, graphs=graphs)


def best_newick(taxa, ancestors, merged_nodes, left_branches,
                right_branches, log_weights):
    """Newick of the particle with the largest last-rank log weight: the
    string of JAX's decode_genealogy(...)[best] (phylo_tpu/train/
    trainer.py:446-457), from that particle's lineage alone, O(R) in
    place of O(K R)."""
    k = int(np.argmax(log_weights[-1]))
    ranks = np.arange(ancestors.shape[0])
    j = _lineage(ancestors, k)
    return to_newick(taxa, {
        "merges": merged_nodes[ranks, j],
        "branches": np.stack([left_branches[ranks, j],
                              right_branches[ranks, j]], axis=1)})


def _inject_fault(spec, epoch, start_epoch):
    kind, at = spec.split(":")
    if epoch != int(at) or start_epoch >= int(at):
        return
    if kind == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif kind == "raise":
        raise RuntimeError(f"injected fault at epoch {epoch}")
    else:
        raise ValueError(f"unknown fault kind {kind!r}")


def _np(t):
    return t.detach().cpu().numpy()
