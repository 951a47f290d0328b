"""Manual whole-sweep VJP for the CSMC sweep (port of
phylo_tpu/smc/sweep_vjp.py, the non-twist and the twist halves).

Two structural facts of the sweep carry the reverse pass:

1. The message buffer is write-once, so the forward's saved children are
   exactly the messages every rank read, and the final buffer holds
   every message any rank read.
2. Messages reach the loss only through per-rank scalars: the unscaled
   root log-lik `rootll_raw` and the merge's log-scale `d_lsc`, and
   under twist the candidate pairs' merge log-likelihoods `twist_llm`.

So the backward is (a) a *scalar replay* of the sweep with those
scalars, the ancestors, pairs (or twist choices) and branch draws
injected, differentiated by autograd (no message tensors at all); (b)
under twist, `_twist_messages_bwd`: per rank, the candidate children
re-gathered from the final buffer, their transitions rebuilt under
autograd (K4) and the pair log-liks pulled back through K7 / K7 wide /
K11c, with the child cotangents scattered into a pending-cotangent
buffer; (c) the *prologue* (rates -> branches -> transitions (K4) and
the stationary vector) re-linearized once, per-category blocks for a
blocked merge; and
(d) `_messages_bwd`, a reverse loop over ranks that runs kernel K2 on the
saved children -- or K3, which re-gathers them from the final buffer,
when the residuals would exceed SAVE_CHILDREN_CAP; K11a on the twist's
explicit children -- and carries the pending buffer for the internal
nodes.

Gradient semantics are the reference's biased VSMC gradient: resampling,
topology and twist-choice indices are constants, gathered values carry
gradients.
Parameter gradients are produced, and the gradients of the injected
float decisions that require grad (the branch lengths a tree search
refits, the twist's branch pools): they enter the scalar replay as
leaves, and their transitions' cotangents from (c) are pulled back
through the replay's graph.  Leaves and site weights that require grad
get their cotangents too (the JAX package's data cotangents): the
replay's leaf log-likelihoods, the leaf children's dm from (b) and (d)
and the site-weight terms of the rank and pair-loglik backwards.  Under
twist with SweepConfig(data_grads=False) they are exact zeros and (b)
skips them, as in the JAX package.

On a mesh the replay runs on every rank alike from the gathered
scalars; (b) and (d) run on this rank's block (K2 / K3 / K11a / K7 per
shard; on a 'k' mesh the children fetched again by the forward's
exchange and the child cotangents routed by an all-gather over 'k'),
and their parameter cotangents are summed over the mesh in one call.
The data cotangents are per site: summed over 'k' only.
"""

from __future__ import annotations

import torch

from phylo_tpu_torch.parallel import collectives as _coll
from phylo_tpu_torch.params import flatten as _flatten
from phylo_tpu_torch.params import unflatten as _unflatten
from phylo_tpu_torch.pruning.kernels import (
    fused_rank_bwd,
    fused_rank_bwd_saved,
    merge_bwd,
)

_DIFF_FIELDS = ("elbo", "log_weights", "log_likelihood", "log_likelihood_R",
                "left_branches", "right_branches", "q_proposal")
_INT_FIELDS = ("ancestors", "merged_nodes", "v_minus")


def _with_decisions(spec, tensors):
    """(params, decisions) of the flat inputs of _ManualSweep: the
    parameters first, then the differentiable decisions by name (then
    the data tensors that require grad, read from `spec`)."""
    n_p = spec["n_params"]
    decisions = spec["decisions"]
    if spec["dec_names"]:
        decisions = dict(decisions, **dict(zip(
            spec["dec_names"], tensors[n_p:n_p + len(spec["dec_names"])])))
    return _unflatten(spec["names"], tensors[:n_p]), decisions


class _ManualSweep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, *tensors):
        from phylo_tpu_torch.smc.sweep import _sample_body

        params, decisions = _with_decisions(spec, tensors)
        res, aux = _sample_body(
            spec["generator"], spec["leaves"], spec["model"], params,
            spec["config"], decisions=decisions,
            site_weights=spec["site_weights"], want_aux=True,
            fused_rank=True, shardings=spec["shardings"])
        ctx.spec = spec
        ctx.aux = aux
        ctx.save_for_backward(*tensors)
        outs = tuple(getattr(res, f) for f in _DIFF_FIELDS + _INT_FIELDS)
        ctx.mark_non_differentiable(*outs[len(_DIFF_FIELDS):])
        return outs

    @staticmethod
    def backward(ctx, *cts):
        spec, aux = ctx.spec, ctx.aux
        tensors = ctx.saved_tensors
        cts = cts[:len(_DIFF_FIELDS)]
        grads = _manual_bwd(spec, aux, tensors, cts)
        ctx.aux = None
        return (None,) + tuple(grads)


def _grad(outputs, inputs, cts, retain_graph=False):
    """autograd.grad over the outputs that require grad; None-safe."""
    pairs = [(o, c) for o, c in zip(outputs, cts)
             if o is not None and o.requires_grad]
    want = [i for i in inputs if i.requires_grad]
    if not pairs or not want:
        return [torch.zeros_like(i) for i in inputs]
    got = torch.autograd.grad([o for o, _ in pairs], want,
                              [c for _, c in pairs], allow_unused=True,
                              retain_graph=retain_graph)
    it = iter(got)
    out = []
    for i in inputs:
        g = next(it) if i.requires_grad else None
        out.append(torch.zeros_like(i) if g is None else g)
    return out


def _manual_bwd(spec, aux, tensors, cts):
    from phylo_tpu_torch.models.branches import branch_rates
    from phylo_tpu_torch.smc.sweep import _sample_body, transitions

    model, config = spec["model"], spec["config"]
    names = spec["names"]
    leaves = spec["leaves"]
    N = leaves.shape[0]
    dtype = leaves.dtype
    n_p = spec["n_params"]
    n_d = len(spec["dec_names"])
    sh = spec["shardings"]

    twist = config.twist
    data_names = spec["data_names"]
    # under twist data_grads=False returns zeros and skips their work
    live = twist is None or config.data_grads
    want_leaves = live and "leaves" in data_names
    want_w = live and "site_weights" in data_names
    sw = spec["site_weights"]
    with torch.enable_grad():
        # (a) scalar replay: merge scalars injected as leaves of the graph,
        # and so the differentiable decisions, whose graph is kept for (c),
        # and the data that require grad (the leaves' log-likelihoods)
        d_leaf = [t.detach().requires_grad_(True)
                  for t in tensors[n_p:n_p + n_d]]
        _, decisions = _with_decisions(spec, tensors[:n_p] + tuple(d_leaf))
        p_leaf = [t.detach().requires_grad_(True) for t in tensors[:n_p]]
        leaves_in = leaves.detach().requires_grad_(want_leaves)
        sw_in = None if sw is None else sw.detach().requires_grad_(want_w)
        data_leaf = ([leaves_in] if want_leaves else []) + (
            [sw_in] if want_w else [])
        rootll = aux["rootll_raw"].detach().requires_grad_(True)
        dlsc = aux["d_lsc"].detach().requires_grad_(True)
        injected = dict(
            ancestors=aux["ancestors"], do_resample=aux["do_resample"],
            pairs=aux["pairs"], eps_l=aux["eps_l"], eps_r=aux["eps_r"],
            rootll_raw=rootll, d_lsc=dlsc)
        llm = []
        if twist is not None:
            llm = [t.detach().requires_grad_(True) for t in aux["twist_llm"]]
            injected.update(twist_llm=llm, twist_choice=aux["twist_choice"],
                            twist_eps_pool=aux["twist_eps_pool"])
        res2 = _sample_body(
            None, leaves_in, model, _unflatten(names, p_leaf), config,
            decisions=decisions, site_weights=sw_in, injected=injected,
            shardings=sh)
        outs = [getattr(res2, f) for f in _DIFF_FIELDS]
        n_llm = len(llm)
        got = _grad(outs, p_leaf + [rootll, dlsc] + llm + d_leaf
                    + data_leaf, cts, retain_graph=bool(d_leaf))
        d_replay, (g_rootll, g_dlsc) = got[:n_p], got[n_p:n_p + 2]
        g_llm = got[n_p + 2:n_p + 2 + n_llm]
        d_dec = got[n_p + 2 + n_llm:n_p + 2 + n_llm + n_d]
        d_data_replay = got[n_p + 2 + n_llm + n_d:]

        # (b) twist: pair log-liks -> candidate children, transitions, pi
        # (partial cotangents: this rank's block)
        pending = d_twist = None
        d_dec_part = [torch.zeros_like(t) for t in d_dec]
        data_part = None
        if twist is not None:
            pending, d_twist, d_pools, data_part = _twist_messages_bwd(
                spec, aux, tensors[:n_p], decisions, g_llm, want_leaves,
                want_w)
            if d_pools is not None:
                from phylo_tpu_torch.smc import twist as tw

                pools = tw.injected_pools(decisions, N, dtype, leaves.device)
                d_dec_part = _grad(list(pools), d_leaf, d_pools,
                                   retain_graph=True)

        # (c) prologue: (P_all, pi) re-linearized at the forward's values,
        # per-category blocks (R, 2K, G, A, A) for a blocked merge (on a
        # 'k' mesh this rank's particles'); the injected branch lengths
        # as leaves where decisions carry a gradient
        p_pro = [t.detach().requires_grad_(True) for t in tensors[:n_p]]
        params = _unflatten(names, p_pro)
        rates_l, rates_r = branch_rates(params["branches"])
        if decisions is not None:
            b_l, b_r = (aux[k].detach().requires_grad_(bool(d_leaf))
                        for k in ("b_l", "b_r"))
        else:
            b_l = aux["eps_l"] / rates_l.to(dtype)[:, None]
            b_r = aux["eps_r"] / rates_r.to(dtype)[:, None]
        ks = (sh.particles(b_l.shape[1]) if sh is not None and sh.has_k
              else slice(None))
        P_all = transitions(model, params["model"],
                            torch.cat([b_l[:, ks], b_r[:, ks]], dim=1),
                            aux["blocks"] is not None, dtype)
        pi = model.stationary(params["model"], dtype=dtype,
                              device=leaves.device).to(dtype)

        # (d) reverse pass over the message DAG (K2, K3 or K11a per rank)
        with torch.no_grad():
            dP_all, dpi, data_msgs = _messages_bwd(
                aux, P_all.detach(), pi.detach(), g_rootll, g_dlsc, N,
                pending, want_leaves, want_w)
        b_leaf = [b_l, b_r] if d_leaf else []
        d_pro = _grad([P_all, pi], p_pro + b_leaf, [dP_all, dpi])
        if d_leaf:
            # the branch lengths' cotangents back to the decisions through
            # the replay's graph (the identity, or the twist's pick)
            d_dec_part = [a + b for a, b in zip(d_dec_part, _grad(
                [res2.left_branches, res2.right_branches], d_leaf,
                d_pro[n_p:]))]
    part = d_pro[:n_p]
    if d_twist is not None:
        part = [a + b for a, b in zip(part, d_twist)]
    # this rank's block's cotangents, summed over the mesh in one call
    part = _coll.sum_partials(sh, part + list(d_dec_part))
    out = [a + b for a, b in zip(d_replay, part[:n_p])]
    d_dec = [a + b for a, b in zip(d_dec, part[n_p:])]
    return out + d_dec + _data_cotangents(
        spec, sh, d_data_replay, data_msgs, data_part, want_leaves,
        want_w)


def _data_cotangents(spec, sh, replay, msgs, twist, want_leaves, want_w):
    """The cotangents of the data inputs in spec["data_names"] order:
    the replay's plus the message passes' (states-major with a spare
    leaf row, summed over 'k' in one call), or zeros when the twist's
    data_grads is off."""
    leaves, sw = spec["leaves"], spec["site_weights"]
    names = spec["data_names"]
    if not (want_leaves or want_w):
        return [torch.zeros_like(leaves if n == "leaves" else sw)
                for n in names]
    parts = [p for p in msgs if p is not None]
    if twist is not None:
        parts = [a + b for a, b in zip(parts, [p for p in twist
                                               if p is not None])]
    parts = _coll.sum_partials(sh, parts, ("k",))
    it = iter(parts)
    out = []
    for rep in replay:
        part = next(it)
        if rep.dim() == 3:       # leaves (N, S, A) <- (N + 1, A, S)
            part = part[:-1].transpose(1, 2)
        out.append(rep + part.to(rep.dtype))
    return out


def _twist_messages_bwd(spec, aux, tensors, decisions, g_llm,
                        want_leaves=False, want_w=False):
    """Reverse pass over the twist potentials (port of the JAX package's
    `_twist_messages_bwd_unrolled`).

    The scalar replay returns the cotangents g_llm of each rank's
    (C(N-r, 2), M, K) pair-merge log-likelihoods.  Per rank and pair
    chunk: re-gather the candidate children from the FINAL write-once
    buffer with the pre-rank tables saved by the forward (slot_t,
    rows_t), rebuild the candidate transitions from the saved pools under
    autograd (K4 forward and backward on the card), pull g_llm back
    through the pair log-liks' autograd rule (K7 / K7 wide / K11c on the
    card), and scatter-add the child cotangents into the pending buffer
    (leaf children into its spare column R, and into the leaves'
    cotangent with `want_leaves`).  On a 'k' mesh the candidates come
    from this rank's particles' roots (fetched as the forward did) and
    the roots' cotangents are routed to their rows by one all-gather a
    rank.  Returns (pending (R+1, K, A, S), parameter cotangents, the
    prefix-ordered injected pools' cotangents where those require grad,
    else None, (dleaves (N+1, A, S), dw (S,)) with None where not
    wanted); all of this rank's block.
    """
    from phylo_tpu_torch.models.branches import branch_rates
    from phylo_tpu_torch.smc import twist as tw
    from phylo_tpu_torch.smc.sweep import gather_messages, lookup_nodes

    model, config = spec["model"], spec["config"]
    names = spec["names"]
    M = config.twist.M
    leaves_sm, buf, w_vec = aux["leaves_sm"], aux["buf"], aux["site_weights"]
    N, A, S = leaves_sm.shape
    R = N - 1
    sh = aux["shardings"]
    kmesh = sh is not None and sh.has_k
    K = buf.shape[0]                       # this rank's particles
    Kg = aux["slot_t"][0].shape[0]
    ks = sh.particles(Kg) if kmesh else slice(None)
    dtype, dev = buf.dtype, buf.device
    eps_l, eps_r = aux["twist_eps_pool"]
    pairs_all = tw._tables(N, dev)[0]
    w_in = w_vec.detach().requires_grad_(want_w)
    dleaves = (torch.zeros((N + 1, A, S), dtype=dtype, device=dev)
               if want_leaves else None)
    dw = torch.zeros_like(w_vec) if want_w else None
    # injected pools: leaves here when they carry a gradient; otherwise
    # b = eps / rate per chunk
    const_pools = d_pools = None
    if decisions is not None:
        const_pools = [p.detach() for p in
                       tw.injected_pools(decisions, N, dtype, dev)]
        if any(decisions[k].requires_grad
               for k in ("twist_pool_l", "twist_pool_r")):
            d_pools = [torch.zeros_like(p) for p in const_pools]

    pending = torch.zeros((R + 1, K, A, S), dtype=dtype, device=dev)
    dparams = [torch.zeros_like(t) for t in tensors]
    for r in range(R):
        n_active = N - r
        Pv = n_active * (n_active - 1) // 2
        C = tw.resolve_chunk(config.twist, model, Pv, K, A, S,
                             buf.element_size())
        if kmesh:
            roots = tw.root_messages(sh, leaves_sm, buf, aux["slot_t"][r],
                                     aux["rows_t"][r], n_active)
            droots = torch.zeros_like(roots)
        for c0 in range(0, Pv, C):
            pc = pairs_all[c0:min(c0 + C, Pv)]
            Cc = pc.shape[0]
            sl = slice(c0, c0 + Cc)
            if kmesh:
                m_l, m_r = tw.candidate_pairs(roots, pc)
            else:
                nodes, rows, q, is_leaf = lookup_nodes(
                    aux["slot_t"][r], aux["rows_t"][r],
                    tw.pair_positions(pc, K), N)
                msgs = gather_messages(leaves_sm, buf, nodes, rows, q,
                                       is_leaf)
                m_l, m_r = (msgs[:, half].reshape(K * Cc, A, S)
                            for half in (slice(None, Cc), slice(Cc, None)))
            m_l, m_r = (m.detach().requires_grad_(True) for m in (m_l, m_r))
            p_leaf = [t.detach().requires_grad_(True) for t in tensors]
            params = _unflatten(names, p_leaf)
            pi = model.stationary(params["model"], dtype=dtype,
                                  device=dev).to(dtype)
            if const_pools is not None:
                bl, br = (p[r, sl][..., ks].detach().requires_grad_(
                    d_pools is not None) for p in const_pools)
            else:
                rates_l, rates_r = branch_rates(params["branches"])
                bl = eps_l[r, sl][..., ks] / rates_l[r].to(dtype)
                br = eps_r[r, sl][..., ks] / rates_r[r].to(dtype)
            ll = tw.chunk_loglik(config.twist, model, params["model"], pi,
                                 w_in, m_l, m_r, bl, br)
            pool_leaf = [bl, br] if d_pools is not None else []
            w_leaf = [w_in] if want_w else []
            dm_l, dm_r, *dp = _grad(
                [ll], [m_l, m_r] + p_leaf + pool_leaf + w_leaf,
                [g_llm[r][sl][..., ks]])
            n_pl = len(p_leaf)
            dparams = [a + b for a, b in zip(dparams, dp[:n_pl])]
            if d_pools is not None:
                for d, g in zip(d_pools, dp[n_pl:n_pl + 2]):
                    d[r, sl, :, ks] += g
            if want_w:
                dw = dw + dp[-1]
            with torch.no_grad():
                if kmesh:
                    for dm, j in ((dm_l, 0), (dm_r, 1)):
                        tw.add_cols(droots, pc[:, j],
                                    dm.reshape(K, Cc, A, S))
                    continue
                for dm, half in ((dm_l, slice(None, Cc)),
                                 (dm_r, slice(Cc, None))):
                    col = torch.where(is_leaf[:, half], R,
                                      nodes[:, half] - N)
                    pending.index_put_(
                        (col.reshape(-1), rows[:, half].reshape(-1)),
                        dm.reshape(K * Cc, A, S), accumulate=True)
                    if want_leaves:
                        idl = torch.where(is_leaf[:, half], nodes[:, half],
                                          N)
                        dleaves.index_put_((idl.reshape(-1),),
                                           dm.reshape(K * Cc, A, S),
                                           accumulate=True)
        if kmesh:
            # the roots' cotangents to the rows that own them
            with torch.no_grad():
                pos = torch.arange(n_active, device=dev)[None].expand(Kg, -1)
                nodes, rows, _, is_leaf = lookup_nodes(
                    aux["slot_t"][r], aux["rows_t"][r], pos, N)
                col = torch.where(is_leaf, R, nodes - N)
                _coll.scatter_rows(sh, pending, col, rows, droots)
                if want_leaves:
                    idl = torch.where(is_leaf, nodes, N)[ks]
                    dleaves.index_put_((idl.reshape(-1),),
                                       droots.reshape(-1, A, S),
                                       accumulate=True)
    return pending, dparams, d_pools, (dleaves, dw)


def _messages_bwd(aux, P_all, pi, g_rootll, g_dlsc, N, pending=None,
                  want_leaves=False, want_dw=False):
    """Reverse pass over the message DAG, ranks in reverse order.

    `pending` (R+1, K, GA, S) holds the accumulated cotangent of each
    internal node's scaled message in the absolute buffer frame: node
    q = r of particle row k at pending[r, k].  Column r is written at
    rank r and read only at ranks > r, so by the time reverse step r
    consumes pending[r], every contribution is in.  Per rank: K11a on
    the twist's explicit children, K2 on the saved children, or K3
    re-gathering them from the leaves and the final buffer when the
    forward did not save them (the sweep's SAVE_CHILDREN_CAP gate), with
    cotangents (pending[r], g_rootll[r], g_dlsc[r]); then the
    internal-child cotangents are scatter-added into pending.  Leaf
    children are routed to the spare slot pending[R] explicitly
    (index_put_ has no drop mode, and a -1 index would silently hit the
    last column).  `pending` may arrive pre-filled (the
    twist reverse pass's contributions).  Leaf children's cotangents go
    to the leaves' (N + 1, GA, S) cotangent with `want_leaves` (row N a
    spare), and the site-weight terms of the rank backwards to dw with
    `want_dw`.

    On a 'k' mesh the rank runs its particles: their explicit children
    fetched again by the forward's exchange, K11a, and the child
    cotangents routed to the rows that own them by an all-gather over
    'k' (collectives.scatter_rows).

    Returns (dP_all (R, 2K, A, A) or (R, 2K, G, A, A), dpi (GA,),
    (dleaves or None, dw or None)), this rank's block's.
    """
    from phylo_tpu_torch.smc.sweep import gather_messages

    child_l, child_r = aux["child_l"], aux["child_r"]
    leaves_sm, buf = aux["leaves_sm"], aux["buf"]
    ids_all = aux["merged"]                   # R x (K, 2) node ids
    rows_all = aux["rows"]                    # R x (K, 2) buffer rows
    w_vec = aux["site_weights"]
    sh = aux["shardings"]
    kmesh = sh is not None and sh.has_k
    R = len(ids_all)
    Kg = ids_all[0].shape[0]
    ks = sh.particles(Kg) if kmesh else slice(None)
    K = P_all.shape[1] // 2                   # this rank's particles
    _, GA, S = leaves_sm.shape
    dtype, dev = leaves_sm.dtype, leaves_sm.device
    P_l_all = P_all[:, :K]
    P_r_all = P_all[:, K:]
    pi = pi.contiguous()
    g_rootll = g_rootll.to(dtype)[:, ks]
    g_dlsc = g_dlsc.to(dtype)[:, ks]

    if pending is None:
        pending = torch.zeros((R + 1, K, GA, S), dtype=dtype, device=dev)
    dPl_out = [None] * R
    dPr_out = [None] * R
    dpi = torch.zeros_like(pi)
    dleaves = (torch.zeros((N + 1, GA, S), dtype=dtype, device=dev)
               if want_leaves else None)
    dw = torch.zeros_like(w_vec) if want_dw else None
    for r in range(R - 1, -1, -1):
        ids, rows = ids_all[r], rows_all[r]
        is_leaf = ids < N
        cts = (pending[r], g_rootll[r].contiguous(), g_dlsc[r].contiguous(),
               P_l_all[r].contiguous(), P_r_all[r].contiguous(), pi, w_vec)
        if aux["explicit_children"]:
            # explicit children (the twist's merges, dense or a wide
            # mixture's blocks; a 'k' mesh's merges): K11a
            if child_l[r] is None:
                q = torch.clamp(ids - N, 0, R - 1)
                m = (_coll.fetch_messages(sh, leaves_sm, buf, ids, rows, q,
                                          is_leaf) if kmesh else
                     gather_messages(leaves_sm, buf, ids, rows, q, is_leaf))
                m1, m2 = m[:, 0].contiguous(), m[:, 1].contiguous()
            else:
                m1, m2 = child_l[r], child_r[r]
            dm1, dm2, dPl, dPr, dpi_p, dw_p = merge_bwd(
                m1, m2, *cts[3:], *cts[:3], want_dw)
            dpi_p = dpi_p[None]
            dw_p = None if dw_p is None else dw_p[None]
        elif child_l[r] is not None:
            dm1, dm2, dPl, dPr, dpi_p, dw_p = fused_rank_bwd_saved(
                child_l[r], child_r[r], *cts, want_dw)
        else:
            idx4 = torch.stack([rows[:, 0], ids[:, 0], rows[:, 1],
                                ids[:, 1]]).to(torch.int32).contiguous()
            dm1, dm2, dPl, dPr, dpi_p, dw_p = fused_rank_bwd(
                leaves_sm, buf, idx4, *cts, want_dw)
        dPl_out[r], dPr_out[r] = dPl, dPr
        dpi = dpi + torch.sum(dpi_p, dim=0)
        if want_dw:
            dw = dw + torch.sum(dw_p, dim=0)
        if want_leaves:
            idl = torch.where(is_leaf, ids, N)[ks]
            for j, dm in ((0, dm1), (1, dm2)):
                dleaves.index_put_((idl[:, j],), dm, accumulate=True)
        if r:
            col = torch.where(is_leaf, torch.full_like(ids, R), ids - N)
            if kmesh:
                _coll.scatter_rows(sh, pending, col, rows,
                                   torch.stack([dm1, dm2], dim=1))
                continue
            for j, dm in ((0, dm1), (1, dm2)):
                pending.index_put_((col[:, j], rows[:, j]), dm,
                                   accumulate=True)
    dP_all = torch.cat([torch.stack(dPl_out), torch.stack(dPr_out)], dim=1)
    return dP_all, dpi, (dleaves, dw)


def sweep_manual_vjp(generator, leaves, model, params, config, *,
                     decisions=None, site_weights=None, shardings=None):
    """`sample_phylogenies` with the manual whole-sweep VJP attached;
    returns a SweepResult whose float fields are differentiable in
    `params`, in the injected float decisions that require grad and in
    `leaves` and `site_weights` where they require grad."""
    from phylo_tpu_torch.smc.sweep import SweepResult, differentiable_decisions

    names, tensors = _flatten(params)
    dec_names = differentiable_decisions(decisions)
    data = {"leaves": leaves, "site_weights": site_weights}
    data_names = tuple(k for k, t in data.items()
                       if t is not None and t.requires_grad)
    spec = dict(generator=generator, leaves=leaves, model=model,
                config=config, decisions=decisions,
                site_weights=site_weights, names=names,
                n_params=len(tensors), dec_names=dec_names,
                data_names=data_names, shardings=shardings)
    outs = _ManualSweep.apply(spec, *tensors,
                              *(decisions[k] for k in dec_names),
                              *(data[k] for k in data_names))
    return SweepResult(**dict(zip(_DIFF_FIELDS + _INT_FIELDS, outs)))
