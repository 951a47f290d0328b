"""Neighbor-joining starting trees (Saitou & Nei 1987, Studier & Keppler
1988 O(N^3) form); the port's own copy of phylo_tpu/search/nj.py, which
is NumPy only.

The reference has no tree-construction outside the SMC sweep; every
classical-ML workflow (fixed-tree scoring, NNI search, model selection)
needs a starting topology, and NJ on a JC-corrected distance matrix is
the standard one (PhyML/RAxML/IQ-TREE all start from NJ/BioNJ
variants).  Host-side NumPy: tree construction is O(N^3) scalar
bookkeeping, not a device workload.

Produces the same merge-record convention the sweep emits and
`pruning.fixed_tree.tree_log_likelihood` consumes (leaves 0..N-1,
internal node q at id N+q, one (R, 2) row per join in postorder), so NJ
trees plug straight into scoring / optimization / NNI:

    D = jc_distance_matrix(dataset.genome)
    record = neighbor_joining(D)
    ll = tree_log_likelihood(leaves, model, params, record)

NJ is defined on unrooted trees; the final two clusters are joined by a
single edge, which we root at its midpoint (the likelihood of a
reversible model is root-placement-invariant, and midpoint keeps both
child branch lengths nonnegative).  Negative estimated branch lengths —
routine NJ output on noisy distances — are clamped to 0, the standard
convention (Kuhner & Felsenstein 1994).
"""

from __future__ import annotations

import numpy as np

__all__ = ["neighbor_joining", "jc_distance_matrix", "p_distance_matrix"]


def p_distance_matrix(genome, *, site_weights=None):
    """Pairwise proportion-of-differing-sites matrix from (N, S, A)
    one-hot / ambiguity-coded genomes.

    Sites where either sequence is not a definite single state (gaps:
    all-ones rows; ambiguity codes: fractional rows; missing: NaN-
    flagged rows) are excluded PAIRWISE, matching the usual pairwise-
    deletion convention.  Returns (N, N) float64; pairs with zero
    comparable sites get distance 0 with a warning.
    """
    g = np.asarray(genome, dtype=np.float64)
    N, S, A = g.shape
    w = (np.ones(S) if site_weights is None
         else np.asarray(site_weights, dtype=np.float64))
    # definite = exactly one state with weight 1 and the rest 0
    finite = np.all(np.isfinite(g), axis=2)
    onehot = finite & (np.abs(g.sum(axis=2) - 1.0) < 1e-9) \
        & (np.abs(g.max(axis=2) - 1.0) < 1e-9)
    state = g.argmax(axis=2)                     # (N, S)

    D = np.zeros((N, N))
    for i in range(N):
        for j in range(i + 1, N):
            ok = onehot[i] & onehot[j]
            tot = float((w * ok).sum())
            if tot <= 0.0:
                import warnings

                warnings.warn(
                    f"sequences {i} and {j} share no comparable sites; "
                    "p-distance set to 0"
                )
                continue
            diff = float((w * (ok & (state[i] != state[j]))).sum())
            D[i, j] = D[j, i] = diff / tot
    return D


def jc_distance_matrix(genome, *, site_weights=None, max_distance=5.0):
    """Jukes-Cantor-corrected pairwise distances for an A-state
    alphabet: d = -(A-1)/A * log(1 - A/(A-1) * p).

    p at or beyond the saturation point (A-1)/A has no finite JC
    distance; such pairs are capped at `max_distance` (expected
    substitutions per site), the standard practical convention.
    """
    g = np.asarray(genome)
    A = g.shape[2]
    p = p_distance_matrix(g, site_weights=site_weights)
    c = (A - 1.0) / A
    arg = 1.0 - p / c
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.where(arg > 0, -c * np.log(np.maximum(arg, 1e-300)),
                     np.inf)
    d = np.minimum(d, max_distance)
    np.fill_diagonal(d, 0.0)
    return d


def neighbor_joining(D, *, clamp_negative=True):
    """NJ tree from an (N, N) distance matrix.

    Returns a merge-record dict {'merges': (N-1, 2) int32,
    'branches': (N-1, 2) float64} in the sweep/fixed_tree convention
    (see module docstring).  With an exactly additive (tree-metric) D
    the output path lengths reproduce D exactly — pinned by
    tests/test_nj.py.

    clamp_negative: clamp negative branch-length estimates to 0
    (default; pass False to keep the raw Studier-Keppler values, e.g.
    for distance-matrix diagnostics).
    """
    D = np.array(D, dtype=np.float64, copy=True)
    N = D.shape[0]
    if D.shape != (N, N):
        raise ValueError(f"distance matrix must be square, got {D.shape}")
    if N < 2:
        raise ValueError("need at least 2 taxa")
    if not np.allclose(D, D.T, atol=1e-8):
        raise ValueError("distance matrix must be symmetric")

    merges = []
    branches = []

    def clamp(b):
        return max(b, 0.0) if clamp_negative else b

    if N == 2:
        merges.append((0, 1))
        h = D[0, 1] / 2.0
        branches.append((clamp(h), clamp(h)))
        return {"merges": np.asarray(merges, np.int32),
                "branches": np.asarray(branches, np.float64)}

    ids = list(range(N))          # active node ids, row k of D <-> ids[k]
    next_id = N

    while len(ids) > 2:
        n = len(ids)
        r = D.sum(axis=1)                       # (n,)
        # Q matrix; diagonal excluded via +inf
        Q = (n - 2.0) * D - r[:, None] - r[None, :]
        np.fill_diagonal(Q, np.inf)
        i, j = np.unravel_index(np.argmin(Q), Q.shape)
        if i > j:
            i, j = j, i
        dij = D[i, j]
        # Studier-Keppler branch lengths to the new node
        bi = 0.5 * dij + (r[i] - r[j]) / (2.0 * (n - 2.0))
        bj = dij - bi
        merges.append((ids[i], ids[j]))
        branches.append((clamp(bi), clamp(bj)))

        # distances from the new node u to every other active node
        du = 0.5 * (D[i] + D[j] - dij)          # (n,)
        keep = [k for k in range(n) if k not in (i, j)]
        D_new = np.empty((n - 1, n - 1))
        D_new[:-1, :-1] = D[np.ix_(keep, keep)]
        D_new[-1, :-1] = D_new[:-1, -1] = du[keep]
        D_new[-1, -1] = 0.0
        D = D_new
        ids = [ids[k] for k in keep] + [next_id]
        next_id += 1

    # root the remaining edge at its midpoint
    h = D[0, 1] / 2.0
    merges.append((ids[0], ids[1]))
    branches.append((clamp(h), clamp(h)))
    return {"merges": np.asarray(merges, np.int32),
            "branches": np.asarray(branches, np.float64)}
