"""Maximum-likelihood tree search by SPR hill-climbing (port of
phylo_tpu/search/spr.py).

Subtree prune-and-regraft generalizes NNI: detach any non-root subtree,
suppress its (now degree-2) parent, and reattach it onto any remaining
edge or above the root.  SPR escapes local optima that trap NNI (every
NNI move is an SPR move, but not vice versa); classic ML programs
(RAxML's lazy SPR) rely on it as the main search operator.  The
reference (amoretti86/phylo) has no tree search at all outside its SMC
samplers.

Like `nni.py`, every candidate topology is one injected deterministic
trajectory of the SMC sweep, so scoring the whole SPR neighborhood is
ONE K-particle sweep (the rank kernels on the card).  Unlike NNI
(exactly 2(N-2) neighbors), the rooted SPR neighborhood size depends on
the current topology: pruning node c leaves a tree with
2N-2-|subtree(c)| nodes, so the move count is (2N-2)(2N-3) - sum_c
|subtree(c)|.  To keep the batch shape constant across hill-climbing
steps, `spr_search` pads the candidate list to the topology-independent
upper bound K = 1 + (2N-2)(2N-4) (valid because sum_c |subtree(c)| >=
2N-2 -- every pruned subtree contains at least its own root -- though
never tight for N >= 3, since internal subtrees have |subtree| >= 3)
with copies of the current tree; pads tie with slot 0 and are never
accepted.

Branch-length conventions on regraft (standard; any choice is washed
out by `branch_opt_steps` refitting):
  - the pruned subtree keeps its root edge length;
  - the merged edge at the suppressed parent gets the SUM of the two
    collapsed lengths;
  - a split target edge divides its length evenly between the two
    halves;
  - regrafting above the root gives the old root a default 0.1 edge.
"""

from __future__ import annotations

import numpy as np

from phylo_tpu_torch.search.nni import _to_record, _to_tree, hill_climb

_ROOT_GRAFT_LEN = 0.1


def spr_neighborhood_size(N):
    """Upper bound on the rooted-SPR neighborhood, constant in N."""
    return (2 * N - 2) * (2 * N - 4)


def spr_neighbors(record, N):
    """All rooted SPR neighbors of a rooted binary tree.

    Returns (2N-2)(2N-3) - sum_c |subtree(c)| records: every non-root
    node c is pruned (its parent suppressed) and regrafted onto every
    edge of the remaining tree plus the above-root position, except the
    single regraft that recreates the input tree.  Distinct moves can
    reach the same topology (e.g. the two NNI-equivalent regrafts
    around a cherry); duplicates are harmless for hill-climbing.
    """
    children, elen = _to_tree(record, N)
    R = np.asarray(record["merges"]).shape[0]
    root = N + R - 1
    parent = {c: p for p, kids in children.items() for c in kids}
    out = []
    for c in list(parent):
        p = parent[c]
        kids = children[p]
        s = kids[0] if kids[1] == c else kids[1]

        # prune subtree(c); suppress p
        ch = {k: list(v) for k, v in children.items() if k != p}
        el = dict(elen)
        sub = set()
        stack = [c]
        while stack:
            v = stack.pop()
            sub.add(v)
            ch.pop(v, None)
            stack.extend(children.get(v, []))
        sub_children = {k: list(children[k]) for k in sub if k in children}
        if p == root:
            new_root = s
            trivial_edge = None          # above-root regraft is trivial
        else:
            gp = parent[p]
            ch[gp] = [s if x == p else x for x in ch[gp]]
            el[s] = el[s] + el[p]        # collapse the two p-edges
            del el[p]
            new_root = root
            trivial_edge = s             # the merged gp--s edge

        # edges of the pruned tree, identified by their child endpoint
        edges = []
        stack = [new_root]
        while stack:
            v = stack.pop()
            for w in ch.get(v, []):
                edges.append(w)
                stack.append(w)
        pruned_parent = {cc: pp for pp, kk in ch.items() for cc in kk}
        newp = N + 2 * R                 # id above every existing node

        for target in edges + [None]:    # None = regraft above the root
            if target is None:
                trivial = trivial_edge is None     # p was the root
            else:
                trivial = target == trivial_edge   # the merged gp--s edge
            if trivial:
                continue
            ch2 = {k: list(v) for k, v in ch.items()}
            ch2.update(sub_children)
            el2 = dict(el)
            if target is None:
                ch2[newp] = [new_root, c]
                el2[new_root] = _ROOT_GRAFT_LEN
                rec_root = newp
            else:
                pv = pruned_parent[target]
                ch2[pv] = [newp if x == target else x for x in ch2[pv]]
                ch2[newp] = [target, c]
                el2[newp] = el2[target] * 0.5
                el2[target] = el2[target] * 0.5
                rec_root = new_root
            out.append(_to_record(ch2, el2, rec_root, N))
    return out


def spr_search(leaves, model, params, record, *, max_iters=50,
               branch_opt_steps=0, learning_rate=0.05, tol=1e-6,
               site_weights=None, verbose=False, max_particles=None):
    """Greedy SPR hill-climbing from a starting tree.

    Each iteration scores the current tree plus its full SPR
    neighborhood in one K-particle sweep with K = 1 + (2N-2)(2N-4)
    (constant across the search), accepts the best strictly-improving
    neighbor, and stops at a local optimum or
    `max_iters`.  See `nni.hill_climb` for `branch_opt_steps`.

    Sweep memory scales as K*N*S*A with K ~ 4N^2, so moderate N (64
    taxa -> ~15k candidates) needs `max_particles` to chunk the
    neighborhood into equal-shape sub-batches (see `nni.hill_climb`).

    Returns TreeSearchResult.
    """
    N = leaves.shape[0]
    return hill_climb(
        leaves, model, params, record, spr_neighbors,
        1 + spr_neighborhood_size(N),
        max_iters=max_iters, branch_opt_steps=branch_opt_steps,
        learning_rate=learning_rate, tol=tol, site_weights=site_weights,
        verbose=verbose, tag="SPR", max_particles=max_particles,
    )
