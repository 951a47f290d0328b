"""Maximum-likelihood tree search by NNI hill-climbing (port of
phylo_tpu/search/nni.py).

Topologies are scored as DATA: a rooted binary tree is exactly one
deterministic trajectory of the SMC sweep, so a merge record converts to
the sweep's injected `decisions` (pair POSITIONS under the sweep's slot
compaction, plus branch lengths), and a batch of candidate topologies
becomes one K-particle sweep with resampling pinned to identity.
`SweepResult.log_likelihood_R` is then each candidate's Felsenstein
log-likelihood.  On the card that sweep runs the rank kernel (K1; K10 for
a rate mixture, K9f for a wide alphabet) and the expm kernel K4 for the
transitions.  A rooted binary tree over N taxa has exactly 2(N-2) NNI
neighbors, so the batch shape K = 2(N-2) + 1 is constant across
hill-climbing steps.

Branch lengths ride along as differentiable decision inputs, so
`branch_opt_steps > 0` refits every candidate's lengths jointly (one
Adam loop over the (R, K, 2) batch) through the sweep's manual VJP (the
rank backward K2 / K3, K4's backward) before comparing scores.

Identifiability: under a time-reversible model the likelihood depends
only on the UNROOTED topology (pulley principle), so the search, which
moves through rooted representatives, converges to the ML unrooted tree
with an arbitrary rooting.  Compare results with
`viz.trees.robinson_foulds(..., rooted=False)`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


# ---------------------------------------------------------------------
# merge records <-> sweep decisions
# ---------------------------------------------------------------------

def records_to_decisions(records, N, *, dtype=torch.float64, device="cpu"):
    """Convert K merge records into the sweep's injected `decisions`.

    Replays the sweep's slot bookkeeping host-side (merged positions drop
    out, survivors keep their order, the new node id N+r appends at the
    end) to recover per-rank pair POSITIONS from node-id merges.
    Ancestor indices are the identity (deterministic scoring, no
    resampling shuffle).

    records: list of {'merges': (R, 2) node ids, 'branches': (R, 2)}.
    Returns the decisions dict for `sample_phylogenies`, tensors on
    `device`.
    """
    K = len(records)
    R = N - 1
    pairs = np.zeros((R, K, 2), dtype=np.int32)
    bl = np.zeros((R, K))
    br = np.zeros((R, K))
    for k, rec in enumerate(records):
        merges = np.asarray(rec["merges"])
        branches = np.asarray(rec["branches"], dtype=np.float64)
        if merges.shape[0] != R:
            raise ValueError(
                f"record {k} has {merges.shape[0]} merges; need {R}"
            )
        active = list(range(N))
        for r in range(R):
            u, v = int(merges[r, 0]), int(merges[r, 1])
            pairs[r, k, 0] = active.index(u)
            pairs[r, k, 1] = active.index(v)
            active = [x for x in active if x != u and x != v]
            active.append(N + r)
        bl[:, k] = branches[:, 0]
        br[:, k] = branches[:, 1]
    ancestors = np.tile(np.arange(K, dtype=np.int32)[None], (R, 1))
    return dict(
        ancestors=torch.as_tensor(ancestors, device=device),
        pairs=torch.as_tensor(pairs, device=device),
        branches_l=torch.as_tensor(bl, device=device).to(dtype),
        branches_r=torch.as_tensor(br, device=device).to(dtype),
    )


def _ensure_branch_params(params, N, dtype, device):
    """The sweep prices branch proposals with params['branches'] even
    under injected decisions; the rates cancel out of
    `log_likelihood_R`, so fixed-tree scoring synthesizes defaults when
    the caller (e.g. cli.score_tree) has none."""
    if "branches" in params:
        return params
    from phylo_tpu_torch.models.branches import init_branch_params

    return dict(params, branches=init_branch_params(N, dtype=dtype,
                                                    device=device))


def tree_log_likelihoods_batch(leaves, model, params, records, *,
                               site_weights=None):
    """Felsenstein log-likelihood of K fixed trees in ONE sweep call.

    Equivalent to [tree_log_likelihood(leaves, model, params, r) for r
    in records], batched over the particle axis.  Returns (K,)
    log-likelihoods (differentiable in params where they require grad).
    """
    from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies

    N = leaves.shape[0]
    params = _ensure_branch_params(params, N, leaves.dtype, leaves.device)
    dec = records_to_decisions(records, N, dtype=leaves.dtype,
                               device=leaves.device)
    res = sample_phylogenies(
        None, leaves, model, params, SweepConfig(K=len(records)),
        decisions=dec, site_weights=site_weights,
    )
    return res.log_likelihood_R


# ---------------------------------------------------------------------
# NNI move set on merge records
# ---------------------------------------------------------------------

def _to_tree(record, N):
    """children[parent] = [c1, c2]; elen[child] = branch length."""
    merges = np.asarray(record["merges"])
    branches = np.asarray(record["branches"], dtype=np.float64)
    children = {}
    elen = {}
    for q in range(merges.shape[0]):
        p = N + q
        children[p] = [int(merges[q, 0]), int(merges[q, 1])]
        elen[int(merges[q, 0])] = float(branches[q, 0])
        elen[int(merges[q, 1])] = float(branches[q, 1])
    return children, elen


def _to_record(children, elen, root, N):
    """Rebuild a postorder merge record from a children map."""
    merges = []
    branches = []

    def visit(v):
        if v < N:
            return v
        a, b = children[v]
        ia, ib = visit(a), visit(b)
        merges.append((ia, ib))
        branches.append((elen[a], elen[b]))
        return N + len(merges) - 1

    # iterative-safe depth: trees here are small (host-side search
    # bookkeeping), recursion is fine up to the parser's own bound
    visit(root)
    return {
        "merges": np.asarray(merges, dtype=np.int32),
        "branches": np.asarray(branches, dtype=np.float64),
    }


def nni_neighbors(record, N):
    """All 2(N-2) nearest-neighbor-interchange neighbors of a rooted
    binary tree.

    For every internal non-root node c (children a, b) with parent p
    and sibling s, the two moves swap s with a and s with b.  Subtrees
    carry their root edge lengths with them (standard NNI convention);
    the p--c edge keeps its length.
    """
    children, elen = _to_tree(record, N)
    root = N + np.asarray(record["merges"]).shape[0] - 1
    out = []
    for p, kids in list(children.items()):
        for ci in (0, 1):
            c = kids[ci]
            if c < N:
                continue                      # leaf child: no move
            s = kids[1 - ci]
            a, b = children[c]
            for swap_with in (0, 1):
                ch2 = {k: list(v) for k, v in children.items()}
                grand = ch2[c][swap_with]     # a or b
                ch2[c][swap_with] = s
                ch2[p][1 - ci] = grand
                out.append(_to_record(ch2, elen, root, N))
    return out


# ---------------------------------------------------------------------
# hill climbing
# ---------------------------------------------------------------------

@dataclass
class TreeSearchResult:
    record: dict            # best tree found (merges + branches)
    log_likelihood: float
    iterations: int
    history: list = field(default_factory=list)   # best ll per iteration


# back-compat alias (pre-SPR name)
NNISearchResult = TreeSearchResult


def nni_search(leaves, model, params, record, *, max_iters=50,
               branch_opt_steps=0, learning_rate=0.05, tol=1e-6,
               site_weights=None, verbose=False, max_particles=None):
    """Greedy NNI hill-climbing from a starting tree.

    Each iteration scores the current tree plus its 2(N-2) NNI
    neighbors in one K-particle sweep (a constant batch shape), accepts
    the best strictly-improving neighbor, and stops at a local optimum
    or `max_iters`.

    branch_opt_steps > 0 additionally refits all candidates' branch
    lengths (jointly, log-parameterized Adam through the sweep's
    transitions) before comparing; the accepted tree keeps its refitted
    lengths.

    Returns TreeSearchResult.
    """
    N = leaves.shape[0]
    return hill_climb(
        leaves, model, params, record, nni_neighbors, 2 * (N - 2) + 1,
        max_iters=max_iters, branch_opt_steps=branch_opt_steps,
        learning_rate=learning_rate, tol=tol, site_weights=site_weights,
        verbose=verbose, tag="NNI", max_particles=max_particles,
    )


def hill_climb(leaves, model, params, record, neighbor_fn, K, *,
               max_iters=50, branch_opt_steps=0, learning_rate=0.05,
               tol=1e-6, site_weights=None, verbose=False, tag="search",
               max_particles=None):
    """Greedy hill-climbing over an arbitrary move set.

    `neighbor_fn(record, N)` returns the candidate neighbors of a tree;
    `K` is a fixed particle count >= 1 + max neighbors, so every sweep of
    the search has one shape (shorter candidate lists are padded with
    copies of the current tree, which tie with slot 0 and are never
    accepted).  Used by `nni_search` (exact K) and `spr_search`
    (topology-dependent neighborhood size, padded).

    `max_particles` caps the per-sweep batch: neighborhoods larger than
    max_particles - 1 are split into equal-shape chunks (slot 0 of every
    chunk is the current tree).  Sweep memory scales as K*N*S*A, so
    large-N SPR (K ~ 4N^2) needs this -- e.g. 64 taxa is ~15k
    candidates.

    With `branch_opt_steps` each chunk's lengths are refitted by a plain
    loop of Adam steps over the sweep (the JAX package scans the same
    steps inside one jitted program).
    """
    from phylo_tpu_torch.smc.sweep import SweepConfig, sample_phylogenies

    N = leaves.shape[0]
    dev = leaves.device
    params = _ensure_branch_params(params, N, leaves.dtype, dev)
    if "branches" not in record:
        record = dict(record,
                      branches=np.full((N - 1, 2), 0.1))
    if max_particles is not None:
        K = max(2, min(K, int(max_particles)))
    config = SweepConfig(K=K)
    ancestors = torch.arange(K, dtype=torch.int32,
                             device=dev)[None].repeat(N - 1, 1)

    def scores_fn(pairs, log_bl, log_br):
        dec = dict(ancestors=ancestors, pairs=pairs,
                   branches_l=torch.exp(log_bl).to(leaves.dtype),
                   branches_r=torch.exp(log_br).to(leaves.dtype))
        res = sample_phylogenies(None, leaves, model, params, config,
                                 decisions=dec, site_weights=site_weights)
        return res.log_likelihood_R

    def evaluate(pairs, log_bl, log_br):
        if branch_opt_steps:
            lb = torch.stack([log_bl, log_br]).requires_grad_(True)
            opt = torch.optim.Adam([lb], lr=learning_rate, eps=1e-8)
            for _ in range(branch_opt_steps):
                opt.zero_grad(set_to_none=True)
                (-torch.sum(scores_fn(pairs, lb[0], lb[1]))).backward()
                opt.step()
            log_bl, log_br = lb.detach()[0], lb.detach()[1]
        with torch.no_grad():
            return scores_fn(pairs, log_bl, log_br), log_bl, log_br

    def refit(cand, k, lls, bl, br):
        rec = dict(cand)
        rec["branches"] = np.stack([bl[:, k], br[:, k]], axis=1)
        return rec, float(lls[k])

    current = dict(record)
    best_ll = -np.inf
    history = []
    it = 0
    floor = 1e-6      # log(0) guard for zero-length input edges
    for it in range(1, max_iters + 1):
        neighbors = neighbor_fn(current, N)
        if max_particles is None and len(neighbors) + 1 > K:
            raise ValueError(
                f"neighbor_fn produced {len(neighbors)} candidates, "
                f"exceeding the declared padding bound K={K}"
            )
        cur_refit = None      # current tree refit (chunk 0, slot 0)
        cand_refit = None     # best candidate across chunks
        for start in range(0, max(1, len(neighbors)), K - 1):
            chunk = [current] + neighbors[start:start + K - 1]
            chunk = chunk + [current] * (K - len(chunk))
            dec = records_to_decisions(chunk, N, dtype=leaves.dtype,
                                       device=dev)
            log_bl = torch.log(torch.clamp(dec["branches_l"], min=floor))
            log_br = torch.log(torch.clamp(dec["branches_r"], min=floor))
            lls, log_bl, log_br = evaluate(dec["pairs"], log_bl, log_br)
            lls = lls.cpu().numpy().astype(np.float64)
            bl = np.exp(log_bl.cpu().numpy().astype(np.float64))
            br = np.exp(log_br.cpu().numpy().astype(np.float64))
            if cur_refit is None:
                # per-particle refits are column-independent, so the
                # current tree scores identically in every chunk
                cur_refit = refit(chunk[0], 0, lls, bl, br)
            k_best = int(lls.argmax())
            if cand_refit is None or float(lls[k_best]) > cand_refit[1]:
                cand_refit = refit(chunk[k_best], k_best, lls, bl, br)
        history.append(max(cur_refit[1], cand_refit[1]))
        if verbose:
            print(f"{tag} iter {it}: current ll {cur_refit[1]:.6f}, "
                  f"best candidate ll {cand_refit[1]:.6f}")
        if cand_refit[1] <= cur_refit[1] + tol:
            # local optimum: keep the current topology (with its
            # refitted branch lengths when branch_opt_steps > 0)
            current, best_ll = cur_refit
            break
        current, best_ll = cand_refit
    return TreeSearchResult(record=current, log_likelihood=best_ll,
                            iterations=it, history=history)
