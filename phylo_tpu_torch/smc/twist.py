"""VNCSMC look-ahead twisting (port of phylo_tpu/smc/twist.py, its
unrolled-rank form `_twisted_extend_static`).

At every rank each particle scores every candidate (pair, subsample)
with the potential (reference vncsmc.py:341-374)

    pot(pair, m, k) = ll_merge(pair, m, k) - ll(left) - ll(right)
                      + [topology-prior deltas]

where ll_merge is the data log-likelihood of merging the pair's two
scaled messages through the subsample's branch lengths and ll(pos) =
root_ll(pos) - logscale(node at pos) comes off the carried per-root
tables.  The potentials are normalized per particle and one (pair, m)
is drawn; its log probability is the proposal term q_pen.

The rank loop is a Python loop, so rank r enumerates exactly the first
C(N - r, 2) pairs of the prefix-ordered pair table (sorted by (j, i)):
no masking and no chunk skipping.  Flat choice indices inside the port
are prefix-flat (pair_prefix * M + m); injected decisions carry the
JAX package's lexicographic flat index (pair_lex * M + m) and are mapped
through `_prefix_order`'s inverse.  The proposal law is order-invariant.

A rate mixture (GammaSites, +I, FreeRates) scores its candidates
through its per-category transitions, (G, A_b, A_b) blocks, and the
blocked forms of the pair-loglik kernels (`pruning.kernels.twist_blocks`:
every mixture of 2 <= G <= 32 blocks of up to 64 states, under either
backward), which skip the zero off-block terms of the dense (G A_b)-state
transitions the JAX package enumerates: the same values.

Branch pools are unit-rate exponential draws (R, P, M, K) made once per
sweep in prefix order, divided by the rank's rate; the manual VJP keeps
them instead of regenerating them.

A rank's pairs are evaluated in chunks whose size `resolve_chunk` takes
from the shapes alone (TwistConfig.chunk_budget_mb, the JAX package's
field): the forward and the manual VJP's re-evaluation chunk alike, and
the chunks give the one-chunk values.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from phylo_tpu_torch.parallel import collectives as _coll
from phylo_tpu_torch.pruning.kernels import (
    fused_pair_loglik,
    pair_loglik,
    twist_blocks,
)
from phylo_tpu_torch.smc.sweep import (
    enter_tree,
    gather_messages,
    lookup_nodes,
    node_logscales,
)
from phylo_tpu_torch.utils.math import topology_log_prior


@dataclass(frozen=True)
class TwistConfig:
    """M: subparticle branch samples per candidate pair (reference
    runner.py:42-45).  pair_chunk: pairs evaluated in one batch; None
    sizes the chunks from chunk_budget_mb (`resolve_chunk`), the JAX
    package's field of that name: the bytes a chunk holds live on the card
    stay within it, and a rank whose whole table fits takes one chunk.
    The default differs from JAX's 32 MB, which came from TPU timings of
    the messages alone: the port counts the transitions and the spectral
    models' branch not taken too, and at this budget every twist that
    does not need chunks takes one a rank (ROADMAP.md "Deliberate
    divergences").  use_pallas_ll: on the card, the pair log-likelihoods'
    forward is kernel K11b (`fused_pair_loglik`, the JAX package's field
    of the same name); False runs the plain multiply-add expression
    there.  The CPU always runs the plain expression, and both give the
    same values and gradients.  The default differs from JAX's (False,
    from TPU timings): on the H100 K11b beat the plain forward (PERF.md,
    ROADMAP.md "Deliberate divergences")."""

    M: int = 10
    pair_chunk: Optional[int] = None
    chunk_budget_mb: int = 20480
    use_pallas_ll: bool = True


# What a candidate pair holds live at a chunk's peak, the reverse pass's
# re-evaluation under autograd, counted from the code.  The messages:
# gathered, split into m_l and m_r, their cotangents.
MESSAGE_COPIES = 3
# A spectral transition (models.expm.expm_reversible, float64): left,
# PT, torch.maximum's zeros and its output, the branch not taken
# (expm_poisson: P, lin, its where), the final where.
SPECTRAL_COPIES = 8
# expm_poisson's transitions in the working dtype (A_b > 8): P, lin,
# its where; expm_ctmc's kernel (A_b <= 8) gives one.
POISSON_COPIES = 3
# Working-dtype copies any route adds: the permuted P_l and P_r of a
# chunk, and the spectral models' cast out of float64.
SPLIT_COPIES = 1
# expm_poisson's rows of n_max + 1 weights a transition: d, its mask,
# d_safe, the two logs, log_ratio, log_w, w.
WEIGHT_ROWS = 8
POISSON_TERMS = 161


def pair_bytes(twist, model, K, planes, S, itemsize):
    """Bytes one candidate pair holds live on the card while its chunk is
    evaluated: 2K message slabs of `planes` x S (the working dtype's
    `itemsize`) MESSAGE_COPIES times, and the 2 M K transitions, G blocks
    of A_b x A_b each (`kernels.twist_blocks`; dense: 1 of `planes`), as
    many times as the route that computes them holds them (the counts
    above), with expm_poisson's weights where it runs.  A pure function
    of shapes."""
    blocks = twist_blocks(model)
    G, Ab = blocks if blocks is not None else (1, planes)
    # the model whose `transition` a chunk calls: a mixture's base where
    # the twist takes its blocks
    base = model.base if blocks is not None else model
    if getattr(base, "spectral", False):
        per_matrix = (Ab * Ab * (8 * SPECTRAL_COPIES
                                 + itemsize * (SPLIT_COPIES + 1))
                      + 8 * WEIGHT_ROWS * POISSON_TERMS)
    elif Ab > 8:
        per_matrix = itemsize * (Ab * Ab * (POISSON_COPIES + SPLIT_COPIES)
                                 + WEIGHT_ROWS * POISSON_TERMS)
    else:
        per_matrix = itemsize * Ab * Ab * (1 + SPLIT_COPIES)
    return 2 * K * (MESSAGE_COPIES * planes * S * itemsize
                    + twist.M * G * per_matrix)


def resolve_chunk(twist, model, P, K, planes, S, itemsize):
    """Pairs a chunk of a rank's P candidate pairs: `twist.pair_chunk`
    where set (as in JAX, it wins), else as many as `twist.chunk_budget_mb`
    holds by `pair_bytes` (JAX's rule for its chunks' memory), at least
    one: a rank whose whole table fits takes one chunk, and every full
    chunk of a sweep has one shape, whatever its rank, so the allocator
    reuses its blocks.  Static shapes only, so the forward and the manual
    VJP's re-evaluation chunk alike and no device value is read."""
    C = twist.pair_chunk
    if C is None:
        per_pair = pair_bytes(twist, model, K, planes, S, itemsize)
        C = twist.chunk_budget_mb * 2 ** 20 // per_pair
    return max(1, min(C, P))


def upper_tri_pairs(N):
    """Static (P, 2) int32 table of position pairs i < j over N slots,
    lexicographic (the reference's nested loops, vncsmc.py:324-339)."""
    return np.asarray([(i, j) for i in range(N) for j in range(i + 1, N)],
                      dtype=np.int32).reshape(-1, 2)


def _prefix_order(N):
    """Permutation of the lexicographic pair table sorting it by (j, i),
    so the pairs valid at any active-prefix size n (j < n) come first.
    Returns (order, inverse): order[s] = lex index of the s-th sorted
    pair, inverse[lex] = sorted position."""
    pairs = upper_tri_pairs(N)
    order = np.lexsort((pairs[:, 0], pairs[:, 1])).astype(np.int32)
    inverse = np.argsort(order).astype(np.int32)
    return order, inverse


@functools.lru_cache(maxsize=None)
def _tables(N, device):
    """(prefix-ordered pairs (P, 2), order (P,), inverse (P,)) as int64
    tensors on `device`, made once per (N, device): a host-to-device copy
    in the rank loop would synchronise with the card."""
    order, inverse = _prefix_order(N)
    pairs = upper_tri_pairs(N)[order]
    return tuple(torch.as_tensor(x, dtype=torch.int64, device=device)
                 for x in (pairs, order, inverse))


def pool_draws(generator, N, M, K, dtype, device):
    """Unit-rate exponential pools (R, P, M, K) x2, prefix-ordered."""
    shape = (N - 1, N * (N - 1) // 2, M, K)
    eps_l = torch.empty(shape, dtype=dtype, device=device)
    eps_r = torch.empty(shape, dtype=dtype, device=device)
    eps_l.exponential_(generator=generator)
    eps_r.exponential_(generator=generator)
    return eps_l, eps_r


def injected_pools(decisions, N, dtype, device):
    """The injected lexicographic branch-length pools `twist_pool_l/r`
    (R, P, M, K), constants, in prefix order."""
    order = _tables(N, device)[1]
    return tuple(torch.as_tensor(decisions[k], device=device).to(dtype)
                 [:, order] for k in ("twist_pool_l", "twist_pool_r"))


def lex_to_prefix_choice(choice, N, M):
    """Lexicographic flat (pair * M + m) -> prefix flat."""
    inverse = _tables(N, choice.device)[2]
    choice = choice.long()
    return inverse[choice // M] * M + choice % M


def pick(pool, choice, M):
    """pool (P, M, K) entries at each particle's flat choice -> (K,)."""
    ks = torch.arange(pool.shape[-1], device=pool.device)
    return pool[choice // M, choice % M, ks]


class _FixedOrderGather(torch.autograd.Function):
    """torch.gather(x, 1, index) for a 2-D x whose cotangent sums the
    duplicate columns by index_put_(accumulate=True), which adds each run
    of equal indices in order (on the card after sorting them): the same
    bits every run, and torch.gather's own on the CPU.  torch.gather's
    CUDA backward, scatter_add_, adds them with float atomics, in any
    order once three or more meet (each root of a forest of n stands in
    n - 1 candidate pairs)."""

    @staticmethod
    def forward(ctx, x, index):
        ctx.save_for_backward(index)
        ctx.width = x.shape[1]
        return torch.gather(x, 1, index)

    @staticmethod
    def backward(ctx, g):
        index, = ctx.saved_tensors
        K, n = index.shape[0], ctx.width
        flat = (torch.arange(K, device=index.device)[:, None] * n
                + index).reshape(-1)
        gx = g.new_zeros((K * n,)).index_put_((flat,), g.reshape(-1),
                                              accumulate=True)
        return gx.view(K, n), None


gather_cols = _FixedOrderGather.apply


def add_cols(dst, index, src):
    """dst (K, n, ...) += src (K, C, ...) at the columns index (C,), the
    duplicate columns summed by index_put_(accumulate=True) in a fixed
    order as `gather_cols`' backward sums them: the same bits every run,
    where index_add_'s CUDA kernel adds with float atomics.  dst is
    contiguous; returns it."""
    K, n = dst.shape[:2]
    flat = (torch.arange(K, device=dst.device)[:, None] * n
            + index[None]).reshape(-1)
    dst.view(K * n, -1).index_put_((flat,), src.reshape(flat.shape[0], -1),
                                   accumulate=True)
    return dst


def pair_positions(pairs, K):
    """(K, 2C) positions [i..., j...] of a (C, 2) pair table."""
    return pairs.T.reshape(-1)[None].expand(K, -1)


def chunk_loglik(twist, model, model_params, stationary, weights, m_l, m_r,
                 bl, br):
    """Pair-merge data log-likelihoods of one chunk, (C, M, K).

    m_l, m_r (K * C, A, S) in K-major flat order (k * C + c); bl, br
    (C, M, K) branch lengths.  One batched transition call (2C, M, K) and
    one pair log-likelihood call: K11b forward on the card with
    `twist.use_pallas_ll`, else the plain expression; the backward is K7 /
    K7 wide / K11c on the card (pruning.kernels.pair_ll_bwd).  A rate
    mixture (`kernels.twist_blocks`) takes its per-category transitions
    (`transition_blocks`, (2C, M, K, G, A_b, A_b)) and the blocked forms
    of those kernels, under either backward; other models their dense
    transitions."""
    C, M, K = bl.shape
    b = torch.cat([bl, br])
    fn = (model.transition_blocks if twist_blocks(model) is not None
          else model.transition)
    P_lr = fn(model_params, b).to(m_l.dtype)          # (2C, M, K, ...)
    tail = P_lr.shape[3:]
    order = (1, 2, 0) + tuple(range(3, P_lr.ndim))
    P_l = P_lr[:C].permute(order).reshape(M, K * C, *tail)
    P_r = P_lr[C:].permute(order).reshape(M, K * C, *tail)
    fn = (fused_pair_loglik if twist.use_pallas_ll and m_l.is_cuda
          else pair_loglik)
    ll = fn(m_l.contiguous(), m_r.contiguous(), P_l.contiguous(),
            P_r.contiguous(), stationary, weights)            # (M, K * C)
    return ll.reshape(M, K, C).permute(2, 0, 1)


def pot_terms(pairs, slot, leaf_counts, row_of_node, node_lsc, root_ll, N,
              dtype):
    """Non-message potential terms for the pairs (C, 2), (K, C):

        -ll(left) - ll(right) + [prior(merged) - prior(l) - prior(r)]

    with ll(pos) = root_ll(pos) - logscale(node at pos).  `node_lsc`
    (K, r) holds the internal nodes' log-scales (None at rank 0).
    root_ll's cotangent sums each root's pairs in a fixed order
    (`gather_cols`)."""
    C = pairs.shape[0]
    pos = pair_positions(pairs, slot.shape[0])
    _, rows, q, is_leaf = lookup_nodes(slot, row_of_node, pos, N)
    rll = gather_cols(root_ll, pos) - node_logscales(
        node_lsc, rows, q, is_leaf, dtype)
    cts = torch.gather(leaf_counts, 1, pos)
    c1, c2 = cts[:, :C], cts[:, C:]
    d_prior = (topology_log_prior(c1 + c2) - topology_log_prior(c1)
               - topology_log_prior(c2)).to(dtype)
    return d_prior - rll[:, :C] - rll[:, C:]


def root_messages(shardings, leaves_sm, buf, slot, row_of_node, n_active):
    """On a 'k' mesh: the messages (K/k, n_active, A, S) of this rank's
    particles' active roots, by one exchange over 'k' (the candidate
    pairs are formed from them locally)."""
    K, N = slot.shape
    pos = torch.arange(n_active, device=slot.device)[None].expand(K, -1)
    return _coll.fetch_messages(shardings, leaves_sm, buf,
                                *lookup_nodes(slot, row_of_node, pos, N))


def candidate_pairs(roots, pc):
    """Left and right messages (Kl * C, A, S), K-major, of the pairs pc
    (C, 2) from the roots (Kl, n, A, S)."""
    Kl, _, A, S = roots.shape
    C = pc.shape[0]
    return (roots[:, pc[:, 0]].reshape(Kl * C, A, S),
            roots[:, pc[:, 1]].reshape(Kl * C, A, S))


def twisted_extend(generator, twist, model, model_params, stationary,
                   leaves_sm, buf, slot, leaf_counts, row_of_node, node_lsc,
                   root_ll, n_active, pool_l, pool_r, weights, *, llm=None,
                   choice=None, shardings=None):
    """Twisted proposal for one rank with n_active active roots.

    pool_l, pool_r: this rank's prefix-ordered branch pools (P, M, K).
    llm: injected (Pv, M, K) merge log-likelihoods (the manual VJP's
    scalar replay; no message is touched then).  choice: injected
    prefix-flat choices (K,); otherwise drawn by Gumbel-max from
    `generator`.  On a mesh (`shardings`) each rank scores its block
    (sites on 's', particles on 'k'; the roots fetched over 'k') and the
    log-likelihoods are summed over 's' and gathered over 'k'; the draw
    is made over all K particles on every rank.

    Returns (p1, p2, b_l, b_r, q_pen, llm, choice): the chosen pair
    positions, branch lengths, the normalized log proposal probability
    of the chosen (pair, m), the merge log-likelihoods and the choice.
    """
    N = leaves_sm.shape[0]
    K = slot.shape[0]
    M = twist.M
    dtype = root_ll.dtype
    Pv = n_active * (n_active - 1) // 2
    pairs = _tables(N, slot.device)[0][:Pv]
    pool_l, pool_r = pool_l[:Pv], pool_r[:Pv]
    if llm is None:
        sh = shardings
        kmesh = sh is not None and sh.has_k
        ks = sh.particles(K) if kmesh else slice(None)
        # the replicated inputs enter this rank's block
        leaves_m = _coll.enter(sh, leaves_sm, ("k",))
        mp = enter_tree(sh, model_params, ("k", "s"))
        stat = _coll.enter(sh, stationary)
        w = _coll.enter(sh, weights, ("k",))
        pl_m = _coll.enter(sh, pool_l)[..., ks]
        pr_m = _coll.enter(sh, pool_r)[..., ks]
        if kmesh:
            roots = root_messages(sh, leaves_m, buf, slot, row_of_node,
                                  n_active)
        A, S = leaves_m.shape[-2:]
        C = resolve_chunk(twist, model, Pv, pl_m.shape[-1], A, S,
                          leaves_m.element_size())
        parts = []
        for c0 in range(0, Pv, C):
            pc = pairs[c0:c0 + C]
            Cc = pc.shape[0]
            if kmesh:
                m_l, m_r = candidate_pairs(roots, pc)
            else:
                looked_up = lookup_nodes(slot, row_of_node,
                                         pair_positions(pc, K), N)
                msgs = gather_messages(leaves_m, buf, *looked_up)
                m_l = msgs[:, :Cc].reshape(K * Cc, A, S)
                m_r = msgs[:, Cc:].reshape(K * Cc, A, S)
            parts.append(chunk_loglik(
                twist, model, mp, stat, w, m_l, m_r,
                pl_m[c0:c0 + Cc], pr_m[c0:c0 + Cc]))
        # (Pv, M, K): one call a collective
        llm = _coll.gather_particles(sh, _coll.site_sum(
            sh, torch.cat(parts)))
    terms = pot_terms(pairs, slot, leaf_counts, row_of_node, node_lsc,
                      root_ll, N, dtype)                     # (K, Pv)
    pots = llm + terms.T[:, None, :]
    flat = pots.permute(2, 0, 1).reshape(K, Pv * M)
    flat = flat - torch.logsumexp(flat, dim=1, keepdim=True)
    if choice is None:
        u = torch.rand(flat.shape, generator=generator, dtype=flat.dtype,
                       device=flat.device)
        choice = torch.argmax(flat.detach() - torch.log(-torch.log(u)),
                              dim=1)
    q_pen = torch.gather(flat, 1, choice[:, None])[:, 0]
    pair = pairs[choice // M]
    return (pair[:, 0], pair[:, 1], pick(pool_l, choice, M),
            pick(pool_r, choice, M), q_pen, llm, choice)
