"""Variational training loop: SGD/Adam ascent on the log Z_SMC ELBO (port
of phylo_tpu/train/trainer.py).

Each epoch runs floor(S / batch_size) minibatch SGD steps (a Python loop;
the JAX package fuses them into one lax.scan) and then one full-S eval
sweep, as the reference does (vcsmc.py:466-591).  Random streams are a
pure function of (seed, epoch, step): every step and eval gets its own
torch.Generator seeded from numpy's SeedSequence of that triple, and the
site batches come from numpy's default_rng((seed, epoch)) exactly as in
the JAX package.

Runs on ``cuda`` unless TrainConfig.device says "cpu".
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from phylo_tpu_torch.device import resolve_device, resolve_dtype
from phylo_tpu_torch.models.branches import branch_rates, init_branch_params
from phylo_tpu_torch.models.substitution import (
    FreeRates, GammaSites, get_model,
)
from phylo_tpu_torch.params import flatten
from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies
from phylo_tpu_torch.smc.twist import TwistConfig
from phylo_tpu_torch.train.minibatch import site_batches

INITIAL_EVAL_STEP = 2 ** 31 - 1


@dataclass
class TrainConfig:
    """Training configuration; field names mirror the JAX package's
    TrainConfig (reference runner.py:12-58).  Options of later slices
    (PAML empirical models, mesh, checkpoints) are not fields yet: the
    runner rejects their flags.  A gy94 model takes the dataset's F61
    codon frequencies."""

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
    log_every: int = 1
    log_params: bool = False
    device: Optional[str] = None     # None = cuda


@dataclass
class TrainResult:
    params: dict
    history: dict = field(repr=False)
    save_dir: Optional[str] = None
    elbo: float = float("nan")


def step_generator(seed, epoch, step, device):
    """The torch.Generator of (seed, epoch, step); step 0 is the epoch's
    eval sweep, 1.. its SGD steps (the JAX package's fold_in layout)."""
    word = np.random.SeedSequence([seed, epoch, step]).generate_state(
        2, dtype=np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(word[0]) << 32 | int(word[1]))
    return g


def _optimizer(config, tensors):
    name = config.optimizer.lower()
    if name == "adam":
        return torch.optim.Adam(tensors, lr=config.learning_rate)
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
    )


def param_tensors(params):
    """The leaf tensors of a nested parameter dict, in sorted key order."""
    return flatten(params)[1]


def init_params(dataset, config, device=None):
    """(model, params) with params a {"model", "branches"} dict of leaf
    tensors that require grad."""
    dev = resolve_device(config.device if device is None else device)
    dtype = resolve_dtype(config.dtype, dev)
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
             decisions=None):
    """One ascent step on the ELBO of `batch` (N, B, A); returns the
    loss (-ELBO) as a 0-d tensor (not synchronised)."""
    optimizer.zero_grad(set_to_none=True)
    loss = -sample_phylogenies(generator, batch, model, params, sweep_cfg,
                               decisions=decisions).elbo
    loss.backward()
    optimizer.step()
    return loss.detach()


def evaluate(model, params, sweep_cfg, generator, leaves):
    """Full-data sweep without gradients (the per-epoch eval)."""
    with torch.no_grad():
        return sample_phylogenies(generator, leaves, model, params,
                                  sweep_cfg)


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

    initial_elbo = None
    if config.log_every:
        res0 = evaluate(model, params, sweep_cfg,
                        step_generator(config.seed, INITIAL_EVAL_STEP, 0,
                                       dev), leaves)
        initial_elbo = float(res0.elbo)
        print(f"Initial evaluation of ELBO: {initial_elbo:.3f}")

    save_dir = None
    if config.save_artifacts:
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
        "ancestors": [], "merged_nodes": [],
    }
    fixed_batches = None
    if config.fixed_partition:
        fixed_batches = list(site_batches(
            np.random.default_rng(config.seed), S, config.batch_size,
            drop_last=True))

    for epoch in range(config.num_epoch):
        t0 = time.time()
        batches = fixed_batches if fixed_batches is not None else list(
            site_batches(np.random.default_rng((config.seed, epoch)), S,
                         config.batch_size, drop_last=True))
        for i, site_idx in enumerate(batches):
            idx = torch.as_tensor(np.asarray(site_idx), device=dev)
            sgd_step(model, params, optimizer, sweep_cfg,
                     step_generator(config.seed, epoch, 1 + i, dev),
                     leaves.index_select(1, idx))
        res = evaluate(model, params, sweep_cfg,
                       step_generator(config.seed, epoch, 0, dev), leaves)
        elbo = float(res.elbo)
        dt = time.time() - t0

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

        if config.log_every and (epoch % config.log_every == 0):
            llr_max = float(np.max(history["log_lik_R"][-1]))
            print(f"epoch {epoch + 1}/{config.num_epoch}  ELBO {elbo:.3f}  "
                  f"log_lik_R max {llr_max:.3f}  {dt:.2f}s")
            if config.log_params:
                with np.printoptions(precision=4, suppress=True):
                    print(f"Q matrix:\n{history['Qmatrices'][-1]}")
                    print(f"stationary: {history['stationary'][-1]}")
                    print(f"branch rates L: {history['rates_l'][-1]}")
                    print(f"branch rates R: {history['rates_r'][-1]}")

    if save_dir:
        from phylo_tpu_torch.train.results import save_results

        save_results(save_dir, config, dataset, history)
    final_elbo = history["elbo"][-1] if history["elbo"] else math.nan
    return TrainResult(params=params, history=history, save_dir=save_dir,
                       elbo=final_elbo)


def _np(t):
    return t.detach().cpu().numpy()
