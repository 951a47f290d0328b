"""Host-side genealogy decoding: integer merge records -> named trees
(port of phylo_tpu/viz/trees.py, the same NumPy code).

The reference carries *string* jump-chain tensors through its TF
while_loop (reference vcsmc.py:311-313,424-425), which no device kernel can
carry.  The sweep instead records, per rank, the resampling ancestor
indices and the two coalesced node ids (SweepResult.ancestors /
merged_nodes); this module reconstructs, on the host:

* per-particle merge-name chains ("Homo_sapiens+Pan" style, the
  reference's jump chain entries),
* Newick strings with branch lengths,
* tree posterior probabilities by grouping identical topologies
  (reference csmc.py:335-349).

Node id convention: ids < N are leaves (taxa order); id N + q is the
internal node created at rank q.  Because particles are resampled, node
N + q of the particle that survives to the end is the one created by its
*ancestor* at rank q -- the lineage is resolved by walking the ancestor
indices backwards (standard SMC genealogy tracing).
"""

from __future__ import annotations

import numpy as np


def _lineage(ancestors, k):
    """Per-rank particle index of final particle k's lineage.

    ancestors: (R, K) ancestor indices applied at the START of each rank
    (identity at rank 0).  Returns array j of length R with j[R-1] = k and
    j[r-1] = ancestors[r, j[r]].
    """
    R = ancestors.shape[0]
    j = np.zeros(R, dtype=int)
    j[R - 1] = k
    for r in range(R - 1, 0, -1):
        j[r - 1] = ancestors[r, j[r]]
    return j


def decode_genealogy(ancestors, merged_nodes, left_branches=None,
                     right_branches=None):
    """Resolve per-particle lineages.

    Returns a list (length K) of dicts with:
      'lineage'  (R,) per-rank particle row of this particle's ancestry
      'merges'   (R, 2) node ids coalesced per rank along the lineage
      'branches' (R, 2) branch lengths per rank (if provided)
    """
    ancestors = np.asarray(ancestors)
    merged_nodes = np.asarray(merged_nodes)
    R, K = ancestors.shape
    out = []
    for k in range(K):
        j = _lineage(ancestors, k)
        merges = merged_nodes[np.arange(R), j]
        rec = {"lineage": j, "merges": merges}
        if left_branches is not None:
            lb = np.asarray(left_branches)[np.arange(R), j]
            rb = np.asarray(right_branches)[np.arange(R), j]
            rec["branches"] = np.stack([lb, rb], axis=1)
        out.append(rec)
    return out


def jump_chain_evolution(taxa, ancestors, merged_nodes):
    """Full per-particle jump-chain history for ALL K particles.

    Reconstructs, per rank, the post-resample forest root names of every
    particle slot -- the content the reference accumulates as its
    ``jump_chains`` string tensor (reference vcsmc.py:324,424-425: each
    rank concatenates the resampled-but-not-yet-merged ``jump_chain_tensor``;
    history rows are SLOT-indexed, i.e. not re-gathered on resampling).

    Returns a list of length K; element k is a list of per-rank
    snapshots, each a list of root-name strings.  Snapshot 0 is the
    initial taxa list; snapshot r is slot k's forest after rank r's
    resampling; a final single-root snapshot (the completed tree, which
    the reference's pre-merge convention omits) is appended last.
    Root order is this sweep's canonical compaction order (stable
    original order with the merged root appended); the reference's
    top_k-based remaining order is sampling noise, not semantics.
    """
    ancestors = np.asarray(ancestors)
    merged_nodes = np.asarray(merged_nodes)
    R, K = ancestors.shape
    N = len(taxa)
    names = [{i: taxa[i] for i in range(N)} for _ in range(K)]
    roots = [list(range(N)) for _ in range(K)]
    chains = [[] for _ in range(K)]
    for r in range(R):
        idx = ancestors[r]
        names = [dict(names[i]) for i in idx]
        roots = [list(roots[i]) for i in idx]
        for k in range(K):
            chains[k].append([names[k][n] for n in roots[k]])
            n1, n2 = (int(x) for x in merged_nodes[r, k])
            nm = names[k][n1] + "+" + names[k][n2]
            names[k][N + r] = nm
            roots[k].remove(n1)
            roots[k].remove(n2)
            roots[k].append(N + r)
    for k in range(K):
        chains[k].append([names[k][n] for n in roots[k]])
    return chains


def _node_namer(taxa, merges):
    N = len(taxa)

    cache = {}

    def name(n):
        n = int(n)
        if n < N:
            return taxa[n]
        if n in cache:
            return cache[n]
        c1, c2 = merges[n - N]
        s = name(c1) + "+" + name(c2)
        cache[n] = s
        return s

    return name


def merge_name_chains(taxa, genealogy):
    """Per-particle list of merged-clade names per rank, the analogue of
    the reference's jump chain strings (vcsmc.py:311)."""
    out = []
    for rec in genealogy:
        name = _node_namer(taxa, rec["merges"])
        out.append(
            [name(len(taxa) + r) for r in range(rec["merges"].shape[0])]
        )
    return out


def to_newick(taxa, record):
    """Newick string (with branch lengths when available) for one decoded
    particle record."""
    N = len(taxa)
    merges = record["merges"]
    branches = record.get("branches")

    def nwk(n):
        n = int(n)
        if n < N:
            return taxa[n]
        q = n - N
        c1, c2 = merges[q]
        if branches is not None:
            b1, b2 = branches[q]
            return f"({nwk(c1)}:{b1:.6g},{nwk(c2)}:{b2:.6g})"
        return f"({nwk(c1)},{nwk(c2)})"

    root = N + merges.shape[0] - 1
    return nwk(root) + ";"


def to_nexus(taxa, records, probs=None, names=None):
    """NEXUS TREES block (translate table + one TREE line per record).

    records: decoded particle records (decode_genealogy output);
    probs: optional per-record posterior probabilities annotated as
    tree comments; names: optional tree names (default tree_<i>).
    The reference emits no tree files at all -- its tree output is the
    pickled string jump chain (vcsmc.py:622-642); Newick/NEXUS export is
    a framework extension for downstream tools (FigTree, DendroPy).
    """
    lines = ["#NEXUS", "BEGIN TREES;", "    TRANSLATE"]
    for i, t in enumerate(taxa):
        sep = "," if i < len(taxa) - 1 else ";"
        safe = t.replace(" ", "_")
        lines.append(f"        {i + 1} {safe}{sep}")
    idx_names = [str(i + 1) for i in range(len(taxa))]
    for i, rec in enumerate(records):
        name = names[i] if names else f"tree_{i + 1}"
        comment = (f" [&W {probs[i]:.6g}]" if probs is not None else "")
        nwk = to_newick(idx_names, rec)
        lines.append(f"    TREE {name}{comment} = [&U] {nwk}")
    lines.append("END;")
    return "\n".join(lines) + "\n"


def _topology_key(taxa, record):
    """Canonical frozenset-of-clades key identifying an unrooted-labeled
    topology (reference csmc.py:335-343 groups particles by their vertex
    dict key sets)."""
    N = len(taxa)
    merges = record["merges"]

    sets = {}

    def clade(n):
        n = int(n)
        if n < N:
            return frozenset([taxa[n]])
        if n in sets:
            return sets[n]
        c1, c2 = merges[n - N]
        s = clade(c1) | clade(c2)
        sets[n] = s
        return s

    keys = []
    for q in range(merges.shape[0]):
        keys.append(clade(N + q))
    return frozenset(keys)


def _clade_sets(taxa, record):
    """All non-trivial clades (frozensets of taxon names) of one record,
    paired with the internal node id that roots each."""
    N = len(taxa)
    merges = record["merges"]
    sets = {}

    def clade(n):
        n = int(n)
        if n < N:
            return frozenset([taxa[n]])
        if n not in sets:
            c1, c2 = merges[n - N]
            sets[n] = clade(c1) | clade(c2)
        return sets[n]

    return [(clade(N + q), N + q) for q in range(merges.shape[0])]


def majority_consensus(taxa, genealogy, log_weights_last=None,
                       threshold=0.5):
    """Weighted majority-rule consensus tree over the final particles.

    Standard phylogenetic summary neither the reference nor the raw
    sweep output provides: clades appearing in more than `threshold` of
    the (weight-normalized) posterior mass are kept — any such set is
    automatically pairwise compatible for threshold >= 0.5 — and
    assembled into a (possibly multifurcating) rooted tree.

    Returns (newick, supports): a Newick string with the clade support
    fraction as each internal node's label, and a {frozenset: support}
    dict for programmatic use.  Branch lengths are omitted (a consensus
    topology has no single coherent length assignment).
    """
    if not 0.5 <= threshold < 1.0:
        raise ValueError("threshold must be in [0.5, 1)")
    K = len(genealogy)
    if log_weights_last is None:
        w = np.full((K,), 1.0 / K)
    else:
        log_w = np.asarray(log_weights_last, dtype=np.float64)
        w = np.exp(log_w - log_w.max())
        w = w / w.sum()

    support = {}
    for k, rec in enumerate(genealogy):
        for clade, _ in set(_clade_sets(taxa, rec)):
            support[clade] = support.get(clade, 0.0) + w[k]
    return consensus_from_supports(taxa, support, threshold=threshold)


def consensus_from_supports(taxa, support, threshold=0.5):
    """Assemble a majority-rule consensus tree from clade supports.

    support: {frozenset(taxon names): fraction in [0, 1]} from any
    estimator (posterior particle mass -- majority_consensus -- or
    bootstrap replicate frequency, smc/bootstrap.py).  Clades above
    `threshold` are pairwise compatible by the >1/2 argument and nest
    into a (possibly multifurcating) rooted tree.

    Returns (newick, supports) as `majority_consensus`.
    """
    if not 0.5 <= threshold < 1.0:
        raise ValueError("threshold must be in [0.5, 1)")
    all_taxa = frozenset(taxa)
    kept = {c: s for c, s in support.items()
            if s > threshold and 1 < len(c)}
    kept[all_taxa] = max(kept.get(all_taxa, 0.0), 1.0)

    # nest kept clades: parent = smallest kept strict superset
    by_size = sorted(kept, key=len)
    children = {c: [] for c in kept}
    leaf_parent = {}
    for c in by_size:
        if c == all_taxa:
            continue
        parent = min(
            (p for p in kept if len(p) > len(c) and c < p), key=len
        )
        children[parent].append(c)
    for t in taxa:
        owner = min((c for c in kept if t in c), key=len)
        leaf_parent.setdefault(owner, []).append(t)

    def nwk(c):
        parts = [nwk(ch) for ch in
                 sorted(children[c], key=lambda x: (len(x), sorted(x)))]
        parts += sorted(leaf_parent.get(c, []))
        label = "" if c == all_taxa else f"{kept[c]:.3f}"
        return "(" + ",".join(parts) + ")" + label

    supports = {c: s for c, s in kept.items() if c != all_taxa}
    return nwk(all_taxa) + ";", supports


def robinson_foulds(taxa, rec1, rec2, *, normalized=False, rooted=True):
    """Robinson-Foulds (symmetric clade-difference) distance between two
    trees in merge-record form.

    rooted=True (default) counts internal clades present in exactly one
    tree (root clade excluded — shared by construction); maximum 2(N-2)
    for binary rooted trees.  rooted=False compares UNROOTED
    bipartitions instead (each clade keyed together with its
    complement; the root's two child clades collapse into one split):
    use this when the model is time-reversible, where the likelihood —
    and so any ML search, e.g. search/nni.py — identifies trees only up
    to root placement.  `normalized=True` divides by the total
    count of (clades|splits) across both trees.
    """
    all_taxa = frozenset(taxa)

    def keys(rec):
        clades = {c for c, _ in _clade_sets(taxa, rec)} - {all_taxa}
        if rooted:
            return clades
        return {
            frozenset({c, all_taxa - c})
            for c in clades
            if 1 < len(c) < len(all_taxa) - 1   # drop trivial splits
        }

    c1, c2 = keys(rec1), keys(rec2)
    d = len(c1 ^ c2)
    if normalized:
        m = len(c1) + len(c2)
        return d / m if m else 0.0
    return d


def tree_probabilities(taxa, genealogy, log_weights_last):
    """Aggregate final-rank particle weights by identical topology.

    Mirrors reference csmc.py:335-349 but in log space: returns a list of
    (probability, representative particle index) sorted descending, where
    probability is the normalized sum of final weights over particles
    sharing the topology.
    """
    log_w = np.asarray(log_weights_last, dtype=np.float64)
    w = np.exp(log_w - log_w.max())
    groups = {}
    for k, rec in enumerate(genealogy):
        key = _topology_key(taxa, rec)
        groups.setdefault(key, []).append(k)
    total = w.sum()
    out = [
        (float(w[idxs].sum() / total), idxs[0])
        for idxs in groups.values()
    ]
    out.sort(reverse=True)
    return out
