"""Fixed-tree likelihood: parse a Newick topology and score it (port of
phylo_tpu/pruning/fixed_tree.py).

The reference can only *sample* trees; scoring a user-supplied topology
(evaluating a published tree under a model, fitting branch lengths on a
fixed topology) is the other half of everyday phylogenetics.  This module
does it with the node-major pruning primitives
(felsenstein.merge_messages / root_log_likelihood, the rescaled
float32-safe forms of reference vcsmc.py:180-188, 231-245):

    taxa, record = parse_newick("((A:0.1,B:0.2):0.05,(C:0.1,D:0.3));")
    ll = tree_log_likelihood(leaves, model, params, record)

`record` uses the merge-record convention the sweep emits and
`viz.trees.to_newick` consumes (leaves 0..N-1 in taxa order, internal
node q at id N+q, one (R, 2) row per coalescence in postorder), so
decoded SMC genealogies and parsed Newick trees are interchangeable.

`tree_log_likelihood` is differentiable in the model parameters and the
branch lengths.  Every transition goes through `model.transition`, so on
the card the expm kernel K4 (forward and Frechet-adjoint backward) runs
for every learned-rate model of up to 8 states; the merges are plain
torch ops, as the JAX package leaves them to XLA.  `optimize_tree` and
`optimize_branch_lengths` fit by Adam (`torch.optim.Adam(lr,
eps=1e-8)`, the update of `optax.adam`).
"""

from __future__ import annotations

import numpy as np
import torch

from phylo_tpu_torch.params import flatten, unflatten
from phylo_tpu_torch.pruning.felsenstein import (
    merge_messages,
    root_log_likelihood,
)


def _strip_ws(text):
    """Drop whitespace outside quoted labels (the Newick format allows
    line breaks / indentation between tokens — FigTree and hand-edited
    exports use them)."""
    out = []
    in_quote = False
    for ch in text:
        if ch == "'":
            in_quote = not in_quote
        if in_quote or not ch.isspace():
            out.append(ch)
    return "".join(out)


def parse_newick(text, taxa=None, *, clamp_negative=False):
    """Parse a rooted binary Newick string.

    Returns (taxa, record): the leaf names in id order and a merge
    record dict with 'merges' (R, 2) int32 — children of internal node
    N+q in postorder — and 'branches' (R, 2) float64 (the children's
    edge lengths), or 'branches' absent when the string carries no
    lengths at all.

    taxa: optional list fixing the leaf-name -> id mapping (required
    when the record must line up with an existing genome array whose
    rows follow dataset order).  Without it, leaves are numbered in
    first-appearance order.

    clamp_negative: neighbor-joining trees routinely carry tiny
    negative branch lengths, which would make the pruning likelihood
    NaN; True clamps them to 0, False (default) rejects them with an
    error naming the option.

    Multifurcations and unrooted trifurcating roots are rejected with a
    clear error (the CSMC state space is rooted binary trees); internal
    node labels are accepted and ignored; quoted labels ('...') are
    supported; whitespace between tokens is fine; the root's own branch
    length, if present, is ignored (a root edge has no effect on the
    likelihood).
    """
    s = _strip_ws(text)
    if s.endswith(";"):
        s = s[:-1]
    pos = [0]

    def error(msg):
        raise ValueError(
            f"Newick parse error at char {pos[0]}: {msg}\n  {text!r}"
        )

    def peek():
        return s[pos[0]] if pos[0] < len(s) else ""

    def parse_label():
        if peek() == "'":
            end = s.find("'", pos[0] + 1)
            if end < 0:
                error("unterminated quoted label")
            lab = s[pos[0] + 1:end]
            pos[0] = end + 1
            return lab
        start = pos[0]
        while pos[0] < len(s) and s[pos[0]] not in "(),:;":
            pos[0] += 1
        return s[start:pos[0]].strip()

    def parse_length():
        if peek() != ":":
            return None
        pos[0] += 1
        start = pos[0]
        while pos[0] < len(s) and s[pos[0]] not in "(),;":
            pos[0] += 1
        try:
            b = float(s[start:pos[0]])
        except ValueError:
            error(f"bad branch length {s[start:pos[0]]!r}")
        if b < 0:
            if not clamp_negative:
                error(
                    f"negative branch length {b}; the pruning "
                    "likelihood is undefined for negative lengths "
                    "(NJ trees often carry tiny ones -- pass "
                    "clamp_negative=True to clamp them to 0)"
                )
            b = 0.0
        return b

    leaf_names = []
    merges = []
    branch_rows = []

    # returns (node_payload, edge_length); internal payloads are
    # ('int', (left, right)) resolved to ids in a second pass so leaf
    # ids can follow either taxa order or first-appearance order
    def parse_node():
        if peek() == "(":
            pos[0] += 1
            children = [parse_node()]
            while peek() == ",":
                pos[0] += 1
                children.append(parse_node())
            if peek() != ")":
                error("expected ')'")
            pos[0] += 1
            parse_label()              # optional internal label, ignored
            length = parse_length()
            if len(children) != 2:
                error(
                    f"node has {len(children)} children; rooted BINARY "
                    "trees only (resolve multifurcations / root an "
                    "unrooted tree first)"
                )
            return ("int", children), length
        name = parse_label()
        if not name:
            error("empty leaf label")
        leaf_names.append(name)
        return ("leaf", name), parse_length()

    # caterpillar (ladder) trees nest ~N deep; give the recursive
    # descent and the resolve pass headroom beyond the default 1000
    import sys

    depth_bound = 8 * s.count("(") + 1000
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, depth_bound))
    try:
        root, _ = parse_node()
    finally:
        sys.setrecursionlimit(old_limit)
    if pos[0] != len(s):
        error(f"trailing characters {s[pos[0]:]!r}")

    if taxa is None:
        taxa = list(leaf_names)
    if len(set(leaf_names)) != len(leaf_names):
        dupes = sorted({n for n in leaf_names if leaf_names.count(n) > 1})
        raise ValueError(f"duplicate leaf labels: {dupes}")
    idx = {name: i for i, name in enumerate(taxa)}
    missing = [n for n in leaf_names if n not in idx]
    if missing:
        raise ValueError(
            f"leaves not in taxa list: {missing}; taxa={list(taxa)}"
        )
    if len(leaf_names) != len(taxa):
        absent = sorted(set(taxa) - set(leaf_names))
        raise ValueError(f"tree is missing taxa: {absent}")
    N = len(taxa)

    def resolve(node):
        """Postorder id assignment; returns (node_id, edge_length)."""
        (kind, payload), length = node
        if kind == "leaf":
            return idx[payload], length
        (lid, llen), (rid, rlen) = resolve(payload[0]), resolve(payload[1])
        merges.append((lid, rid))
        branch_rows.append((llen, rlen))
        return N + len(merges) - 1, length

    sys.setrecursionlimit(max(old_limit, depth_bound))
    try:
        resolve((root, None))
    finally:
        sys.setrecursionlimit(old_limit)

    record = {"merges": np.asarray(merges, dtype=np.int32)}
    flat = [b for row in branch_rows for b in row]
    if all(b is not None for b in flat):
        record["branches"] = np.asarray(branch_rows, dtype=np.float64)
    elif any(b is not None for b in flat):
        raise ValueError(
            "Newick string has branch lengths on some edges but not "
            "others; provide all or none"
        )
    return list(taxa), record


def tree_log_likelihood(leaves, model, params, record, *, branches=None,
                        site_weights=None, rescale=True):
    """log P(Y | tree, theta) by Felsenstein pruning over a fixed tree.

    leaves: (N, S, A) one-hot / ambiguity-coded genomes, a tensor on the
        device to run on.
    model/params: substitution model and {'model': ...} as the sweep's.
    record: merge record from `parse_newick` or a decoded SMC particle
        (viz.trees.decode_genealogy): 'merges' (R, 2) node ids.
    branches: optional (R, 2) branch lengths overriding
        record['branches'] -- pass a tensor that requires grad to
        differentiate or fit branch lengths on the fixed topology.

    Differentiable in params and branches.  Matches the sweep's
    decoded-tree semantics (its `log_likelihood_R`).
    """
    merges = np.asarray(record["merges"])
    R = merges.shape[0]
    N = leaves.shape[0]
    if R != N - 1:
        raise ValueError(
            f"record has {R} merges for {N} leaves; need N-1"
        )
    if branches is None:
        if "branches" not in record:
            raise ValueError(
                "record carries no branch lengths; pass branches=(R, 2)"
            )
        branches = record["branches"]
    dtype, dev = leaves.dtype, leaves.device
    branches = torch.as_tensor(branches, device=dev).to(dtype)

    # one batched transition solve for all 2(N-1) edges
    P = model.transition(params["model"], branches).to(dtype)
    pi = model.stationary(params["model"], dtype=dtype,
                          device=dev).to(dtype)
    if site_weights is not None:
        site_weights = torch.as_tensor(site_weights, device=dev).to(dtype)

    msgs = list(leaves) + [None] * R
    total_scale = torch.zeros((), dtype=dtype, device=dev)
    for q in range(R):
        c1, c2 = int(merges[q, 0]), int(merges[q, 1])
        msg, lsc = merge_messages(
            msgs[c1], msgs[c2], P[q, 0], P[q, 1],
            rescale=rescale, site_weights=site_weights,
        )
        msgs[N + q] = msg
        total_scale = total_scale + lsc
    return root_log_likelihood(
        msgs[N + R - 1], pi, total_scale, site_weights=site_weights
    )


def _initial_log_branches(record, init, leaves):
    """log of the starting lengths (R, 2): `init`, else the record's,
    else 0.1; zero-length edges floored at 1e-6 (log 0 = -inf would
    freeze them)."""
    R = np.asarray(record["merges"]).shape[0]
    if init is None:
        init = record.get("branches")
    if init is None:
        init = np.full((R, 2), 0.1)
    init = np.maximum(np.asarray(init, dtype=np.float64), 1e-6)
    return torch.log(torch.as_tensor(init, device=leaves.device)
                     .to(leaves.dtype))


def _adam_ascent(leaves, model, params, record, fit_model, *, steps,
                 learning_rate, site_weights, init):
    """Adam ascent on `tree_log_likelihood` over log branch lengths and,
    when `fit_model`, the model parameters; returns (params, branches,
    log_likelihood) at the final step, detached."""
    log_b = _initial_log_branches(record, init, leaves).requires_grad_(True)
    model_p, tensors = params["model"], []
    if fit_model:
        skeleton, tensors = flatten({"model": model_p})
        tensors = [t.detach().clone().requires_grad_(True) for t in tensors]
        model_p = unflatten(skeleton, tensors)["model"]
    opt = torch.optim.Adam(tensors + [log_b], lr=learning_rate, eps=1e-8)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = -tree_log_likelihood(
            leaves, model, {"model": model_p}, record,
            branches=torch.exp(log_b), site_weights=site_weights)
        loss.backward()
        opt.step()
    fit_params = dict(params, model=model_p)
    b = torch.exp(log_b.detach())
    with torch.no_grad():
        ll = tree_log_likelihood(leaves, model, fit_params, record,
                                 branches=b, site_weights=site_weights)
    if fit_model:
        fit_params = dict(params, model=unflatten(
            skeleton, [t.detach() for t in tensors])["model"])
    return fit_params, b, ll


def optimize_tree(leaves, model, params, record, *, steps=300,
                  learning_rate=0.05, site_weights=None, init=None):
    """Joint ML fit of substitution-model parameters AND branch lengths
    on a fixed topology (model selection, final-tree polishing;
    `optimize_branch_lengths` fits lengths only).

    Adam ascent on `tree_log_likelihood` over {model params,
    log-branch-lengths}.  Returns (params, branches (R, 2),
    log_likelihood) at the final step; `params` has the input's structure
    with params['model'] refitted (models with no free parameters, e.g.
    JC69, get a branch-only fit).
    """
    return _adam_ascent(leaves, model, params, record, True, steps=steps,
                        learning_rate=learning_rate,
                        site_weights=site_weights, init=init)


def optimize_branch_lengths(leaves, model, params, record, *, steps=200,
                            learning_rate=0.05, site_weights=None,
                            init=None):
    """Maximum-likelihood branch lengths on a fixed topology.

    Adam ascent on `tree_log_likelihood` over log-parameterized branch
    lengths (positive by construction).  Returns (branches (R, 2),
    log_likelihood) at the final step.
    """
    _, b, ll = _adam_ascent(leaves, model, params, record, False,
                            steps=steps, learning_rate=learning_rate,
                            site_weights=site_weights, init=init)
    return b, ll
