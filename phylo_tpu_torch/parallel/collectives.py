"""Every exchange between the ranks of a sweep on a mesh.

The sweep keeps its collectives here so that a reader finds them all.
Only `all_reduce`, `all_gather`, `all_to_all_single` and `broadcast` are
called: NCCL and gloo both take them on CUDA tensors (gloo through the
host), so ranks that share one card run the same code over gloo.
`CALLS` and `BYTES` count each call and the bytes this rank hands to
it.

Under autograd a collective whose output feeds a loss that every rank
holds whole must treat that loss as *one* loss:

* `site_sum` (a per-particle sum over the 's' axis) passes the
  cotangent through unchanged;
* `gather_particles` (an all-gather over 'k') keeps this rank's slice
  of the cotangent;
* `enter` marks where a replicated tensor feeds a sharded computation:
  the identity forward, and a sum of the ranks' partial cotangents
  backward;
* `fetch_messages` (the child exchange, an all-to-all) sends every
  rank's cotangent back to each rank that sent it rows (an all-gather).

`torch.distributed.nn`'s collectives would sum the replicated loss's
cotangents over the ranks again and scale gradients by the mesh size.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

CALLS = collections.Counter()
BYTES = collections.Counter()


def reset_counts():
    CALLS.clear()
    BYTES.clear()


def _count(op, t):
    CALLS[op] += 1
    BYTES[op] += t.numel() * t.element_size()


def _all_reduce(t, group):
    """Sum `t` over `group`, in place (the caller owns `t`)."""
    _count("all_reduce", t)
    dist.all_reduce(t, group=group)
    return t


def _all_gather(t, group, n):
    """(n * t.shape[0], ...) of every rank's `t` in rank order."""
    t = t.contiguous()
    _count("all_gather", t)
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t, group=group)
    return torch.cat(out)


class _SiteSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Exchange(torch.autograd.Function):
    """This rank's block of the sum over the ranks of their (K, ...)
    slabs: an all-to-all of the blocks and a local sum (a reduce-scatter;
    gloo has no reduce_scatter).  Backward, every rank's block cotangent
    goes to every rank (an all-gather)."""

    @staticmethod
    def forward(ctx, slab, group, n):
        ctx.group, ctx.n = group, n
        slab = slab.contiguous()
        out = torch.empty_like(slab)
        _count("all_to_all", slab)
        dist.all_to_all_single(out, slab, group=group)
        return out.view(n, -1, *slab.shape[1:]).sum(0)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.n), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.block = (index * x.shape[0], x.shape[0])
        return _all_gather(x, group, n)

    @staticmethod
    def backward(ctx, g):
        start, size = ctx.block
        return g.narrow(0, start, size), None, None, None


class _SumBack(torch.autograd.Function):
    """The identity forward; the ranks' cotangents summed backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


def _group(sh, axes):
    """The process group spanning `axes` (those the mesh shards), or
    None where it shards none of them."""
    present = [a for a in axes
               if (a == "s" and sh.has_s) or (a == "k" and sh.has_k)]
    if not present:
        return None
    if len(present) == 2:
        return dist.group.WORLD
    return sh.group(present[0])


def site_sum(sh, x):
    """Per-particle partial site sums -> the sums over all sites ('s')."""
    if sh is None or not sh.has_s:
        return x
    return _SiteSum.apply(x, sh.group("s"))


def gather_particles(sh, x, dim=-1):
    """This rank's particle block of `x` along `dim` -> all K particles,
    in rank order over 'k'."""
    if sh is None or not sh.has_k:
        return x
    x = x.movedim(dim, 0)
    out = _Gather.apply(x, sh.group("k"), sh.k, sh.mesh.coords["k"])
    return out.movedim(0, dim)


def enter(sh, x, axes=("k", "s")):
    """`x`, replicated over the mesh, feeding a computation sharded over
    `axes`: its cotangent is summed over them."""
    if sh is None or x is None or not torch.is_grad_enabled():
        return x
    group = _group(sh, axes)
    if group is None:
        return x
    return _SumBack.apply(x, group)


def sum_partials(sh, tensors, axes=("k", "s")):
    """Sums a list of per-rank partial tensors over `axes` in one call
    (flattened and packed); returns them in their shapes."""
    group = None if sh is None else _group(sh, axes)
    if group is None or not tensors:
        return list(tensors)
    flat = _all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def fetch_messages(sh, leaves_sm, buf, nodes, rows, q, is_leaf):
    """Messages (Kl, n, A, S) of this rank's particles' looked-up nodes
    on a 'k' mesh, from the global (K, n) lookups (sweep.lookup_nodes):
    leaves from the shared leaves, internal nodes by one exchange over
    'k' (the JAX package's shard_gather_pair).  Each rank writes the rows
    it owns into a zero (K, n, A, S) slab; the slabs' sum over 'k' holds
    every child once, and the all-to-all hands each rank its particles'
    block of it."""
    Kl = buf.shape[0]
    k0 = sh.mesh.coords["k"] * Kl
    mine = slice(k0, k0 + Kl)
    own = (~is_leaf) & (rows >= k0) & (rows < k0 + Kl)
    lrow = torch.where(own, rows - k0, torch.zeros_like(rows))
    slab = torch.where(own[..., None, None], buf[lrow, q],
                       torch.zeros((), dtype=buf.dtype, device=buf.device))
    got = _Exchange.apply(slab, sh.group("k"), sh.k)
    N = leaves_sm.shape[0]
    leaf_part = leaves_sm[torch.clamp(nodes[mine], 0, N - 1)]
    return torch.where(is_leaf[mine][..., None, None], leaf_part, got)


def scatter_rows(sh, pending, col, rows, dm):
    """pending[col, row] += dm for every particle's children on a 'k'
    mesh (the JAX package's shard_scatter_pair_add): this rank's child
    cotangents dm (Kl, n, A, S) are all-gathered over 'k' and each rank
    adds the rows it owns.  col (K, n) is the buffer column (the spare
    column for a leaf); rows (K, n) the global rows."""
    Kl = pending.shape[1]
    k0 = sh.mesh.coords["k"] * Kl
    dm_all = _all_gather(dm, sh.group("k"), sh.k)            # (K, n, ...)
    own = (rows >= k0) & (rows < k0 + Kl)
    spare = pending.shape[0] - 1
    col = torch.where(own, col, torch.full_like(col, spare))
    lrow = torch.where(own, rows - k0, torch.zeros_like(rows))
    pending.index_put_((col.reshape(-1), lrow.reshape(-1)),
                       dm_all.reshape(-1, *dm_all.shape[2:]),
                       accumulate=True)
    return pending


def check_replicated(sh, tensors):
    """Raises unless `tensors` hold the same bits on every rank of the
    mesh: rank 0's copy is broadcast and compared."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    ref = flat.clone()
    _count("broadcast", ref)
    dist.broadcast(ref, src=0)
    if not torch.equal(ref, flat):
        raise RuntimeError(
            f"rank {sh.mesh.rank}'s parameters differ from rank 0's")
