"""Marginal ancestral state reconstruction on a fixed tree (port of
phylo_tpu/pruning/ancestral.py).

Standard two-pass belief propagation.  The up pass is Felsenstein
pruning (reference vcsmc.py:180-188's recursion); the down pass has no
reference equivalent (the reference samples topologies, it does not
read states at their internal nodes):

    post[v, s, a] = P(state at node v, site s is a | Y, tree, theta)

Orientation follows the merge convention (models/substitution.py module
docstring): transition matrices are M[a, b] = P(child a | parent b), so

    up pass:    up_parent(b)  = prod_children sum_a up_child(a) M[a, b]
    down pass:  down_child(a) = sum_b M[a, b] down_parent(b) *
                                      (sibling's up pushed through its M)(b)
    marginal:   post_v propto up_v * down_v   (down_root = pi)

Per-site rescaling keeps float32 safe on deep trees; marginals are
normalized per site, so the scale factors cancel.  Ambiguity-coded and
gapped leaves get the model's posterior over their compatible states.
"""

from __future__ import annotations

import numpy as np
import torch

from phylo_tpu_torch.models.expm import _matmul
from phylo_tpu_torch.pruning.felsenstein import root_log_likelihood


def ancestral_marginals(leaves, model, params, record, *, branches=None,
                        site_weights=None):
    """Posterior state marginals at EVERY node of a fixed tree.

    leaves: (N, S, A) one-hot / ambiguity-coded genomes (a tensor).
    model/params/record/branches: as `fixed_tree.tree_log_likelihood`.

    Returns (post, ll):
      post (N + R, S, A) -- post[v, s, :] sums to 1; rows 0..N-1 are the
          leaves, rows N..N+R-1 the internal nodes in the record's
          postorder (root last);
      ll   the data log-likelihood (tree_log_likelihood's value: the up
          pass is that computation).
    """
    merges = np.asarray(record["merges"])
    R = merges.shape[0]
    N = leaves.shape[0]
    if R != N - 1:
        raise ValueError(f"record has {R} merges for {N} leaves; need N-1")
    if branches is None:
        if "branches" not in record:
            raise ValueError(
                "record carries no branch lengths; pass branches=(R, 2)"
            )
        branches = record["branches"]
    dtype, dev = leaves.dtype, leaves.device
    branches = torch.as_tensor(branches, device=dev).to(dtype)
    if site_weights is not None:
        site_weights = torch.as_tensor(site_weights, device=dev).to(dtype)

    M = model.transition(params["model"], branches).to(dtype)
    pi = model.stationary(params["model"], dtype=dtype,
                          device=dev).to(dtype)
    tiny = torch.finfo(dtype).tiny

    # ---- up pass, saving each child's pushed message
    # lp_c(b) = sum_a up_c(a) M_c[a, b] for the down pass
    up = list(leaves) + [None] * R
    pushed = [None] * R
    total_scale = torch.zeros((), dtype=dtype, device=dev)
    for q in range(R):
        c1, c2 = int(merges[q, 0]), int(merges[q, 1])
        lp1 = _matmul(up[c1], M[q, 0])
        lp2 = _matmul(up[c2], M[q, 1])
        pushed[q] = (lp1, lp2)
        msg = lp1 * lp2
        scale = torch.clamp(torch.amax(msg, dim=-1, keepdim=True), min=tiny)
        up[N + q] = msg / scale
        log_scale = torch.log(scale[..., 0])
        if site_weights is not None:
            log_scale = log_scale * site_weights
        total_scale = total_scale + torch.sum(log_scale, dim=-1)
        # the pushed messages pair with the RESCALED parent: down-pass
        # products need lp only up to a per-site factor, and marginals
        # renormalize
    ll = root_log_likelihood(up[N + R - 1], pi, total_scale,
                             site_weights=site_weights)

    # ---- down pass, root to leaves (reverse postorder: merges[q] names
    # only nodes < N + q, so parents resolve before their children)
    S = leaves.shape[1]
    down = [None] * (N + R)
    down[N + R - 1] = pi.expand(S, pi.shape[0])
    for q in range(R - 1, -1, -1):
        v = N + q
        lp1, lp2 = pushed[q]
        for child, M_c, lp_sib in (
            (int(merges[q, 0]), M[q, 0], lp2),
            (int(merges[q, 1]), M[q, 1], lp1),
        ):
            d = _matmul(down[v] * lp_sib, M_c.transpose(-1, -2))
            scale = torch.clamp(torch.amax(d, dim=-1, keepdim=True),
                                min=tiny)
            down[child] = d / scale

    post = torch.stack([up[v] * down[v] for v in range(N + R)])
    post = post / torch.sum(post, dim=-1, keepdim=True)
    return post, ll


def collapse_categories(post, G):
    """Split product-space marginals (GammaSites: A = G * A_base) into
    (base_post, cat_post): (..., S, G*A) -> ((..., S, A), (..., S, G)).

    base_post marginalizes the hidden rate category out of the state;
    cat_post is the per-site posterior over rate categories (at the root
    row, the "which sites are fast" readout; the category is shared
    along the tree, so every node's agrees up to numerics).
    """
    post = torch.as_tensor(post)
    GA = post.shape[-1]
    if GA % G:
        raise ValueError(f"state count {GA} not divisible by G={G}")
    blocks = post.reshape(*post.shape[:-1], G, GA // G)
    return torch.sum(blocks, dim=-2), torch.sum(blocks, dim=-1)


def decode_states(post, alphabet="ACGT"):
    """Argmax-decode marginals to sequences: (V, S, A) -> V strings.

    A convenience for reports; the distribution in `post` is the result
    (argmax sequences are not a jointly likely reconstruction).
    """
    post = (post.detach().cpu().numpy() if isinstance(post, torch.Tensor)
            else np.asarray(post))
    if post.shape[-1] != len(alphabet):
        raise ValueError(
            f"posterior has {post.shape[-1]} states but alphabet "
            f"{alphabet!r} has {len(alphabet)}"
        )
    idx = post.argmax(axis=-1)
    return ["".join(alphabet[a] for a in row) for row in idx]
