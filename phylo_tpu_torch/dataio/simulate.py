"""Simulate sequence evolution along a tree under a substitution model
(port of phylo_tpu/dataio/simulate.py; NumPy, with the model's own
transitions).

Root states come from the stationary distribution and evolve down a
given topology through the model's transition matrices: the generative
counterpart of the pruning likelihood.  Trees use the sweep's merge-record
convention (leaves 0..N-1, internal node N+q created at rank q).
"""

from __future__ import annotations

import numpy as np
import torch


def simulate_on_tree(record, model, params, S, *, seed=0, taxa=None,
                     name=None):
    """Evolve S iid sites down the tree in `record`.

    record: {'merges': (R, 2) node ids (leaves 0..N-1, internal N+q in
        postorder), 'branches': (R, 2) child edge lengths}.
    model/params: a port substitution model and its {'model': ...}
        parameters; root states ~ stationary(params['model']).
    Returns a PhyloDataset with one-hot (N, S, A) genomes.

    The root's state is stationary, and each child's state follows the
    parent's COLUMN of the model's merge-oriented transition matrix,
    Categorical(M(b)[:, parent_state]), drawn by inverse CDF from
    numpy's default_rng(seed) in the JAX package's order, so the same
    seed and parameters give the same genomes.
    """
    from phylo_tpu_torch.dataio.datasets import PhyloDataset

    merges = np.asarray(record["merges"])
    branches = np.asarray(record["branches"], dtype=np.float64)
    R = merges.shape[0]
    N = R + 1
    A = model.A
    rng = np.random.default_rng(seed)

    with torch.no_grad():
        pi = model.stationary(params["model"], dtype=torch.float64)
        # (R, 2, A, A) merge-oriented matrices in one batched call
        P = model.transition(params["model"], torch.tensor(branches))
    pi = np.asarray(pi.cpu().numpy(), np.float64)
    pi = pi / pi.sum()
    # rows index the PARENT state (generative orientation); guard tiny
    # negative or unnormalized rows of a float32 expm
    P = np.swapaxes(np.asarray(P.cpu().numpy(), np.float64), -1, -2)
    P = np.clip(P, 0.0, None)
    P = P / P.sum(axis=-1, keepdims=True)

    states = {N + R - 1: rng.choice(A, size=S, p=pi)}
    # children resolve in reverse postorder (parents before children)
    for q in range(R - 1, -1, -1):
        parent = states[N + q]
        for side in (0, 1):
            child = int(merges[q, side])
            rows = P[q, side][parent]              # (S, A)
            u = rng.random(S)
            states[child] = (rows.cumsum(axis=1) < u[:, None]).sum(
                axis=1).clip(0, A - 1)

    genome = np.zeros((N, S, A), dtype=np.float64)
    for n in range(N):
        genome[n, np.arange(S), states[n]] = 1.0
    if taxa is None:
        taxa = [f"S{i}" for i in range(N)]
    return PhyloDataset(name=name or f"simulated_tree_{N}x{S}",
                        taxa=list(taxa), genome=genome)
