"""Seed replicas: R independent VCSMC runs of one configuration (port of
phylo_tpu/train/replicas.py).

The reference's autorun.sh repeats each configuration by launching
separate processes (reference autorun.sh:3-12).  The JAX package vmaps
the replicas into one program; here they run one after another inside
each step, each with its own parameters, optimizer and generators from
(seed + r, epoch, step).  The site batches follow the JAX schedule
exactly: one numpy generator seeded with config.seed, and each epoch one
permutation per replica, in replica order, cut into S // batch_size
steps (phylo_tpu/train/replicas.py:67-80).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from phylo_tpu_torch.device import resolve_device, resolve_dtype
from phylo_tpu_torch.train.trainer import (
    _optimizer, _sweep_config, evaluate, init_params, param_tensors,
    sgd_step, step_generator,
)


def train_replicas(dataset, config, n_replicas):
    """Train `n_replicas` independent runs (seeds config.seed + r) of
    `config`.  Returns {"params": the final params stacked on a leading
    replica axis, "history": {"elbo": (epochs, R) array,
    "epoch_seconds": [...]}}."""
    dev = resolve_device(config.device)
    dtype = resolve_dtype(config.dtype, dev)
    model, first = init_params(dataset, config, device=dev)
    if hasattr(model, "expand_leaves"):
        # the JAX function feeds dataset.genome without expand_leaves
        # (replicas.py:34), so it has no rate-mixture case to port
        raise ValueError(
            "train_replicas does not take a rate mixture (gamma "
            "categories, +I or FreeRates); train the replicas one by one "
            "with trainer.train")
    # every replica starts from the same initial params, as JAX
    # broadcasts one set
    replicas = [first] + [init_params(dataset, config, device=dev)[1]
                          for _ in range(n_replicas - 1)]
    sweep_cfg = _sweep_config(config)
    optimizers = [_optimizer(config, param_tensors(p)) for p in replicas]
    leaves = torch.tensor(dataset.genome, dtype=dtype, device=dev)
    S = dataset.S

    rng = np.random.default_rng(config.seed)
    history = {"elbo": [], "epoch_seconds": []}
    bs = min(config.batch_size, S)
    n_steps = max(1, S // bs)
    for epoch in range(config.num_epoch):
        t0 = time.time()
        perms = np.stack([rng.permutation(S) for _ in range(n_replicas)])
        for step in range(n_steps):
            for r, params in enumerate(replicas):
                idx = torch.as_tensor(perms[r, step * bs:(step + 1) * bs],
                                      device=dev)
                sgd_step(model, params, optimizers[r], sweep_cfg,
                         step_generator(config.seed + r, epoch, 1 + step,
                                        dev),
                         leaves.index_select(1, idx))
        elbos = np.array([
            float(evaluate(model, params, sweep_cfg,
                           step_generator(config.seed + r, epoch, 0, dev),
                           leaves).elbo)
            for r, params in enumerate(replicas)])
        history["elbo"].append(elbos)
        history["epoch_seconds"].append(time.time() - t0)
        if config.log_every and epoch % config.log_every == 0:
            print(f"epoch {epoch + 1}: ELBO mean {elbos.mean():.3f} "
                  f"min {elbos.min():.3f} max {elbos.max():.3f}")
    history["elbo"] = np.stack(history["elbo"])       # (epochs, R)
    return {"params": _stack(replicas), "history": history}


def _stack(params_list):
    first = params_list[0]
    if isinstance(first, dict):
        return {k: _stack([p[k] for p in params_list]) for k in first}
    return torch.stack([p.detach() for p in params_list])
