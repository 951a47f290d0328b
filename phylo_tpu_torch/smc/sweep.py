"""The combinatorial SMC sweep (port of phylo_tpu/smc/sweep.py): VCSMC
with uniform pair proposals, and VNCSMC with the twisted proposals of
smc.twist (SweepConfig.twist).

State is carried with fixed shapes over the N-1 ranks, as in the JAX
package:

* ``buf`` (K, N-1, A, S): the **write-once** internal-message buffer.
  Rank r writes every particle's merged message into column r and never
  touches it again.
* ``row_of_node`` (K, N-1): ancestry indirection.  After resampling,
  particle k's internal node q lives at ``buf[row_of_node[k, q], q]``,
  so resampling permutes index tables only, never the message payload.
* position tables ``slot`` / ``leaf_counts`` / ``root_ll`` (K, N): the
  compacted forest (active roots in positions 0..N-r-1).
* per-root data log-likelihoods are maintained incrementally.

Messages are states-major (A, S) and per-site rescaled.  The rank loop is
a Python loop (n_active is static per rank; nothing syncs with the
host).  With ``fused_rank`` each non-twist rank is one call of kernel K1
(pruning.kernels.fused_rank_update, in place; K10, its blocked form, for
a rate mixture; K9, the wide form, for A > 8 such as codons, blocked for
a rate mixture over a wide base such as protein + Gamma4).
Otherwise, and always under twist (as in the JAX package, where K1 is
off under twist), the children are gathered explicitly and merged by K8
(pruning.kernels.fused_merge_loglik), which autograd differentiates
through K11a -- or, for a rate mixture's blocked merge and for A > 8, by
plain torch ops, as JAX's merge kernel is off there.  Under twist the
candidate pairs' log-likelihoods run on K11b forward and K7 / K7 wide /
K11c backward (smc.twist) for up to 64 dense states.

The reference quirks stay default-on (``q_raw_subtraction``,
``right_multiplier_bug``), see ``SweepConfig``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from phylo_tpu_torch.models.branches import branch_rates
from phylo_tpu_torch.parallel import collectives as _coll
from phylo_tpu_torch.params import flatten
from phylo_tpu_torch.pruning import kernels as _kernels
from phylo_tpu_torch.pruning.felsenstein import (
    merge_messages_sm,
    root_log_likelihood_sm,
)
from phylo_tpu_torch.pruning.kernels import (
    alloc_rank_buffer,
    fused_merge_loglik,
    fused_rank_update,
)
from phylo_tpu_torch.pruning.posterior import (
    forest_log_prior,
    overcounting_correction,
)
from phylo_tpu_torch.smc.proposals import uniform_pair
from phylo_tpu_torch.smc.resampling import resample_indices
from phylo_tpu_torch.utils.math import log_double_factorial_odd, n_choose_2


@dataclass(frozen=True)
class SweepConfig:
    """Static configuration of a sweep (field meanings as in the JAX
    package's SweepConfig).

    K: particle count.
    resampling: 'multinomial' (reference), 'systematic', 'stratified',
        'none'.
    q_raw_subtraction: subtract the probability 1/C(n,2) from the log
        weight instead of its log (reference quirk vcsmc.py:298,392).
    resample_branch_history: re-gather the cumulative branch sums when
        resampling (the reference does not, vcsmc.py:318-325).
    right_multiplier_bug: price the right branches with the left rates'
        multiplier in log_likelihood_R (reference quirk vcsmc.py:262).
    rescale: per-site Felsenstein rescaling (the kernel path requires it).
    ess_threshold: resample only when ESS/K drops below this fraction.
    carried_weights: carried-accumulated-weights estimator of log Z.
    manual_vjp: True differentiates through the manual whole-sweep
        VJP (smc.sweep_vjp: K1 or K8 forward, K2/K3 reverse; under
        twist K11a for the chosen merges and K7 / K7 wide / K11c for the
        pair log-liks); False runs plain torch autograd through the sweep
        (K8 forward, K11a backward; the twist's pair log-liks through
        their autograd rule; plain torch for a blocked merge).
    twist: optional smc.twist.TwistConfig enabling VNCSMC look-ahead
        proposals.

    A rate-mixture model (one with `blocks`, e.g. GammaSites) merges with
    per-category (G, A, A) transitions instead of the dense (GA, GA)
    block-diagonal ones (K10 on the card; K9 blocked for more than 8
    states per category), except under twist, whose chosen merges take
    the dense ones; its candidate pair log-likelihoods take the blocks
    (smc.twist.chunk_loglik).
    """

    K: int
    resampling: str = "multinomial"
    q_raw_subtraction: bool = True
    resample_branch_history: bool = False
    right_multiplier_bug: bool = True
    rescale: bool = True
    ess_threshold: Optional[float] = None
    carried_weights: bool = False
    manual_vjp: bool = True
    twist: Optional[Any] = None
    # False declares that the caller never differentiates `leaves` or
    # `site_weights`: under twist the manual VJP then skips their
    # cotangents and returns exact zeros (the JAX package's field; the
    # trainer sets it).  Without twist it changes nothing.
    data_grads: bool = True


@dataclass
class SweepResult:
    log_weights: torch.Tensor        # (N-1, K)
    log_likelihood: torch.Tensor     # (N-1, K) forest posterior + priors
    elbo: torch.Tensor               # scalar log Z_SMC
    log_likelihood_R: torch.Tensor   # (K,) de-biased data log-likelihood
    left_branches: torch.Tensor      # (N-1, K)
    right_branches: torch.Tensor     # (N-1, K)
    ancestors: torch.Tensor          # (N-1, K) resampling indices
    merged_nodes: torch.Tensor       # (N-1, K, 2) node ids per rank
    v_minus: torch.Tensor            # (N-1, K)
    q_proposal: torch.Tensor         # (N-1, K)


def compute_log_zsmc(log_weights):
    """log Z_SMC = sum_r logsumexp_k(log w_rk - log K) (vcsmc.py:270-277)."""
    K = log_weights.shape[-1]
    return torch.sum(torch.logsumexp(log_weights - math.log(K), dim=-1))


def _presample_transitions(model, model_params, rates_l, rates_r, eps_l,
                           eps_r, dtype, blocked=False, shardings=None):
    """Branch lengths b = eps / rate (pathwise-differentiable in the
    rates) and ONE batched transition call for all ranks' branches,
    (R, 2K, A, A), or (R, 2K, G, A, A) per-category blocks when
    `blocked`; on a 'k' mesh only this rank's particles', (R, 2K/k, ...)
    (`local_transitions`)."""
    b_l_all = eps_l / rates_l[:, None]
    b_r_all = eps_r / rates_r[:, None]
    P_all = local_transitions(model, model_params, b_l_all, b_r_all,
                              blocked, dtype, shardings)
    return b_l_all, b_r_all, P_all


def local_transitions(model, model_params, b_l, b_r, blocked, dtype,
                      shardings=None):
    """Transitions of the branch lengths b_l, b_r (..., K) of this
    rank's particles, concatenated left then right along the last batch
    axis: all K without a 'k' mesh; on one, this rank's block only (the
    JAX package's per-shard transitions, phylo_tpu/smc/sweep.py:281-330),
    its inputs entering the shard (their cotangents summed over 'k')."""
    if shardings is not None and shardings.has_k:
        ks = shardings.particles(b_l.shape[-1])
        model_params = enter_tree(shardings, model_params, ("k",))
        b_l = _coll.enter(shardings, b_l, ("k",))[..., ks]
        b_r = _coll.enter(shardings, b_r, ("k",))[..., ks]
    return transitions(model, model_params, torch.cat([b_l, b_r], dim=-1),
                       blocked, dtype)


def enter_tree(sh, tree, axes):
    """`collectives.enter` over a nested parameter dict."""
    if isinstance(tree, dict):
        return {k: enter_tree(sh, v, axes) for k, v in tree.items()}
    return _coll.enter(sh, tree, axes)


def transitions(model, model_params, b, blocked, dtype):
    """The model's transitions for branch lengths b: per-category blocks
    (..., G, A, A) when `blocked`, else dense (..., A, A)."""
    fn = model.transition_blocks if blocked else model.transition
    return fn(model_params, b).to(dtype)


def card_refusals(config, model, planes):
    """Raises where the card has no kernel for a sweep of `model` on
    messages of `planes` planes under `config`; touches no tensor, so a
    refusal comes before any work.  The twist takes the route
    `kernels.twist_route` names: a rate mixture's per-category blocks (G
    <= 32 of up to 64 states: K11b, K7 wide and K11c blocked, in block
    groups), else dense transitions of up to 64 states (K7 / K7 wide,
    K11b, K11c).  A rate mixture's rank (and, under the twist, the chosen
    merges' backward K11a over blocks of more than 8 states) runs on K10
    (A <= 8 a category) or K9 blocked (8 < A <= 128 a category, in block
    groups where one does not fit: protein + Gamma8, GY94 + Gamma4),
    up to MAX_G = 32 blocks: more blocks, or a block of more than 128
    states, raise.  A sweep without rescaling merges with plain torch
    ops (K1 and K8 always rescale), as the JAX package falls back to jnp
    there."""
    if config.twist is not None:
        _kernels.twist_route(model, planes)
    blocks = getattr(model, "blocks", None)
    if blocks is not None:
        _kernels.wide_planes(*blocks, blocked=True)


def _check_supported(config, leaves, model, shardings=None):
    if config.resampling not in ("multinomial", "systematic",
                                 "stratified", "none"):
        raise ValueError(
            f"unknown resampling strategy {config.resampling!r}")
    if shardings is not None:
        shardings.particles(config.K)       # K a multiple of 'k'
    if leaves.is_cuda:
        card_refusals(config, model, leaves.shape[-1])


def differentiable_decisions(decisions):
    """Sorted names of the injected decisions that carry a gradient:
    the float tensors that require grad ('branches_l' / 'branches_r',
    under twist 'twist_pool_l' / 'twist_pool_r')."""
    if decisions is None:
        return ()
    return tuple(k for k in sorted(decisions)
                 if isinstance(decisions[k], torch.Tensor)
                 and decisions[k].is_floating_point()
                 and decisions[k].requires_grad)


def make_leaf_buffer(leaves, config, dtype=None, model=None):
    """The unified message buffer (K, 2N-1, A, S) of
    `sample_phylogenies_with_buffer` (the JAX package's make_leaf_buffer):
    the leaves (N, S, A), states-major, replicated into columns 0..N-1
    and zeros in the N-1 internal columns.  The sweep writes the internal
    columns only, so a returned buffer is reused as it is.  `model` is
    the JAX signature's (its site padding for the TPU kernel); the card
    pads no sites."""
    N, S, A = leaves.shape
    dtype = dtype or leaves.dtype
    buf = torch.zeros((config.K, 2 * N - 1, A, S), dtype=dtype,
                      device=leaves.device)
    buf[:, :N] = leaves.to(dtype).transpose(1, 2)
    return buf


def sample_phylogenies_with_buffer(generator, leaves, model, params, config,
                                   leaf_buffer, *, shardings=None,
                                   site_weights=None, decisions=None):
    """`sample_phylogenies` writing its merged messages into the internal
    columns of a pre-built `make_leaf_buffer` (no buffer allocated a
    sweep); returns (SweepResult, leaf_buffer), whose leaf columns are
    untouched, so the next call takes it as it is.  Value-only sweeps
    (eval loops), without twist or a particle mesh, as in the JAX
    package; `decisions` as in `sample_phylogenies`."""
    N, S, A = leaves.shape
    if config.twist is not None:
        raise ValueError("sample_phylogenies_with_buffer takes no twist")
    if shardings is not None and shardings.has_k:
        raise NotImplementedError(
            "sample_phylogenies_with_buffer holds all K particles: no "
            "particle mesh")
    if tuple(leaf_buffer.shape) != (config.K, 2 * N - 1, A, S):
        raise ValueError(
            f"leaf buffer {tuple(leaf_buffer.shape)} is not make_leaf_"
            f"buffer's {(config.K, 2 * N - 1, A, S)}")
    _check_supported(config, leaves, model, shardings)
    with torch.no_grad():
        res = _sample_body(generator, leaves, model, params, config,
                           decisions=decisions, site_weights=site_weights,
                           fused_rank=config.rescale, shardings=shardings,
                           buf=leaf_buffer[:, N:])
    return res, leaf_buffer


def sample_phylogenies(generator, leaves, model, params, config, *,
                       decisions=None, site_weights=None, shardings=None):
    """Run one full CSMC sweep.

    generator: torch.Generator on leaves' device (unused when every
        decision is injected).
    leaves: (N, S, A) one-hot / ambiguity-coded genomes; on a mesh
        this rank's site block (parallel.shard_leaves), and site_weights
        its weights.
    params: {'model': {...}, 'branches': {'log_rates_l', 'log_rates_r'}}.
    decisions: optional pre-drawn randomness ('ancestors' (N-1, K),
        'pairs' (N-1, K, 2), 'branches_l'/'branches_r' (N-1, K); under
        twist 'twist_pool_l'/'twist_pool_r' (N-1, P, M, K) branch
        lengths over the lexicographic pair table and 'twist_choice'
        (N-1, K) lexicographic flat indices pair * M + m); the sweep is
        then deterministic.  Its float tensors (branch lengths, pools)
        are constants unless they require grad.
    shardings: optional parallel.SweepSharding (one process per mesh
        device, every rank calling with the same generator seed): on a
        site mesh each rank runs the kernels on its site block and the
        per-particle site sums are all-reduced over 's'; on a particle
        mesh each rank merges its K/k particles, children on other ranks
        come by one exchange over 'k' and the merge scalars are gathered
        (parallel.collectives).  Every rank draws the whole sweep's
        random numbers, so a seeded sharded sweep repeats the one-process
        sweep, and every rank returns the whole SweepResult.

    Differentiable in `params`, in the injected float decisions that
    require grad (tree search refits its candidates' branch lengths so)
    and in `leaves` and `site_weights` when they require grad and grad
    is enabled: through the manual whole-sweep VJP (smc.sweep_vjp) by
    default, or plain autograd with SweepConfig(manual_vjp=False).
    Injected decisions reach both routes.
    """
    _check_supported(config, leaves, model, shardings)
    data = [t for t in (leaves, site_weights)
            if t is not None and t.requires_grad]
    tensors = flatten(params)[1] + data + [
        decisions[k] for k in differentiable_decisions(decisions)]
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)
    if not needs_grad:
        with torch.no_grad():
            return _sample_body(generator, leaves, model, params, config,
                                decisions=decisions,
                                site_weights=site_weights,
                                fused_rank=config.rescale,
                                shardings=shardings)
    if config.manual_vjp and config.rescale:
        from phylo_tpu_torch.smc.sweep_vjp import sweep_manual_vjp

        return sweep_manual_vjp(generator, leaves, model, params, config,
                                decisions=decisions,
                                site_weights=site_weights,
                                shardings=shardings)
    return _sample_body(generator, leaves, model, params, config,
                        decisions=decisions, site_weights=site_weights,
                        shardings=shardings)


def _sample_body(generator, leaves, model, params, config, *,
                 decisions=None, site_weights=None, injected=None,
                 want_aux=False, fused_rank=False, shardings=None,
                 buf=None):
    """One sweep.  Modes:

    * plain (fused_rank=False): K8 merge (or plain torch ops without
      rescaling), differentiable;
    * fused_rank=True: kernel K1 per rank (no autograd rule), or K8
      under twist; want_aux also saves the children and the records
      the manual VJP needs;
    * injected: scalar replay for the manual VJP -- ancestors, pairs,
      resample gates and the per-rank merge scalars (rootll_raw, d_lsc)
      come from the forward run, and no message is touched.  Under
      twist the pair-merge log-likelihoods (twist_llm) and the choices
      are injected as well, with the forward's unit-rate pools.

    On a mesh (`shardings`) the forest's tables stay whole on every
    rank; the messages, the merges and the twist's candidates are this
    rank's blocks (sites on 's', particles on 'k'), and the scalars they
    give are summed over 's' and gathered over 'k' before anything reads
    them.  K1 is off on a 'k' mesh (explicit children fetched over 'k',
    then K8), as in the JAX package.

    `buf` is the internal-message buffer to write (a leaf buffer's
    internal columns), else one is allocated.

    Returns SweepResult, or (SweepResult, aux) with want_aux.
    """
    N, S, A = leaves.shape
    K = config.K
    R = N - 1
    dtype = leaves.dtype
    dev = leaves.device
    leaves_sm = leaves.transpose(1, 2).contiguous()         # (N, A, S)
    # (G, A) of a rate mixture's blocked merge; the twist enumerates with
    # dense transitions
    blocks = getattr(model, "blocks", None) if config.twist is None else None
    # the reverse pass's transitions: under the twist too a mixture's
    # blocks where they are wide (K11a on K9bs blocked's body; the dense
    # form's zero off-block terms change no bit of dm or of dP's blocks)
    mix = getattr(model, "blocks", None)
    bwd_blocks = (mix if config.twist is not None and mix is not None
                  and mix[1] > _kernels.MAX_A else blocks)
    sh = shardings
    kmesh = sh is not None and sh.has_k
    Kl = K // sh.k if kmesh else K
    if kmesh:
        fused_rank = False

    stationary = model.stationary(params["model"], dtype=dtype,
                                  device=dev).to(dtype)
    rates_l, rates_r = branch_rates(params["branches"])
    rates_l = rates_l.to(dtype)
    rates_r = rates_r.to(dtype)
    w_vec = (site_weights.to(dtype) if site_weights is not None
             else torch.ones((S,), dtype=dtype, device=dev))
    # (N,); on a mesh the leaves' site sums over 's'
    leaf_ll = _coll.site_sum(sh, root_log_likelihood_sm(
        leaves_sm, _coll.enter(sh, stationary, ("s",)),
        site_weights=site_weights))
    # what the sharded merges read: the replicated stationary vector and
    # the leaves and weights of this site block enter the shard
    stat_m = _coll.enter(sh, stationary)
    leaves_m = _coll.enter(sh, leaves_sm, ("k",))
    w_m = _coll.enter(sh, w_vec, ("k",))
    sw_m = None if site_weights is None else w_m
    logK = math.log(K)

    # ---- branch lengths + transitions for ALL ranks, one batched call
    # (the scalar replay needs the branch lengths only); under twist the
    # (R, P, M, K) branch pools instead, the transitions in the rank loop
    twist = config.twist
    eps_l = eps_r = P_all = None
    tw_eps_l = tw_eps_r = None
    if twist is not None:
        from phylo_tpu_torch.smc import twist as tw

        M = twist.M
        if decisions is not None:
            pool_l_all, pool_r_all = tw.injected_pools(decisions, N, dtype,
                                                       dev)
        else:
            if injected is not None:
                tw_eps_l, tw_eps_r = injected["twist_eps_pool"]
            else:
                tw_eps_l, tw_eps_r = tw.pool_draws(generator, N, M, K,
                                                   dtype, dev)
            # pathwise-differentiable in the rates
            pool_l_all = tw_eps_l / rates_l[:, None, None, None]
            pool_r_all = tw_eps_r / rates_r[:, None, None, None]
    elif decisions is not None:
        b_l_all = decisions["branches_l"].to(dtype)
        b_r_all = decisions["branches_r"].to(dtype)
        if injected is None:
            P_all = local_transitions(model, params["model"], b_l_all,
                                      b_r_all, blocks is not None, dtype, sh)
    elif injected is not None:
        eps_l, eps_r = injected["eps_l"], injected["eps_r"]
        b_l_all = eps_l / rates_l[:, None]
        b_r_all = eps_r / rates_r[:, None]
    else:
        eps_l = torch.empty((R, K), dtype=dtype, device=dev)
        eps_r = torch.empty((R, K), dtype=dtype, device=dev)
        eps_l.exponential_(generator=generator)
        eps_r.exponential_(generator=generator)
        b_l_all, b_r_all, P_all = _presample_transitions(
            model, params["model"], rates_l, rates_r, eps_l, eps_r, dtype,
            blocked=blocks is not None, shardings=sh)

    if injected is None and buf is None:
        buf = alloc_rank_buffer(Kl, R, A, S, dtype, dev)
    # the manual VJP's reverse pass reads the saved children (K2) while
    # they fit under the cap, else re-gathers them (K3)
    save_children = (want_aux and fused_rank and twist is None
                     and _kernels.save_children_ok(R, K, A, S,
                                                   leaves.element_size()))

    ar_K = torch.arange(K, device=dev)
    pos_idx = torch.arange(N, device=dev)
    slot = pos_idx[None].repeat(K, 1)
    leaf_counts = torch.ones((K, N), dtype=torch.int64, device=dev)
    root_ll = leaf_ll[None].expand(K, N)
    row_of_node = torch.zeros((K, R), dtype=torch.int64, device=dev)
    logscale_cols = []                  # per-rank (K,) node log-scales
    zK = torch.zeros((K,), dtype=dtype, device=dev)
    sum_bl, sum_br = zK, zK
    prev_log_w, prev_log_ll, acc_log_w = zK, zK, zK
    log_z = torch.zeros((), dtype=dtype, device=dev)

    outs = {k: [] for k in ("log_w", "log_ll", "b_l", "b_r", "ancestors",
                            "merged", "v_minus", "q_pen", "rows", "pairs",
                            "rootll_raw", "d_lsc", "do_resample",
                            "child_l", "child_r", "twist_llm",
                            "twist_choice", "slot_t", "rows_t",
                            "eps_l", "eps_r")}

    for r in range(R):
        n_active = N - r

        # ---- 1. resample (rank > 0), reference vcsmc.py:279-330 ----
        gate_lw = acc_log_w if config.carried_weights else prev_log_w
        if injected is not None:
            sampled = injected["ancestors"][r]
            do_resample = injected["do_resample"][r]
        else:
            do_resample = r > 0
            if config.carried_weights and config.resampling == "none":
                do_resample = False
            sampled = None
            if decisions is not None:
                sampled = decisions["ancestors"][r].long()
            elif do_resample:
                sampled = resample_indices(generator, gate_lw.detach(),
                                           config.resampling)
            if config.ess_threshold is not None and do_resample:
                lw = gate_lw - torch.logsumexp(gate_lw, dim=0)
                ess = torch.exp(-torch.logsumexp(2.0 * lw, dim=0))
                do_resample = (ess < config.ess_threshold * K).detach()
        if isinstance(do_resample, bool):
            idx = sampled if do_resample else ar_K
        else:
            idx = torch.where(do_resample, sampled, ar_K)
        if config.carried_weights:
            seg = torch.logsumexp(acc_log_w, dim=0) - logK
            if isinstance(do_resample, bool):
                if do_resample:
                    log_z = log_z + seg
                    acc_base = torch.zeros_like(acc_log_w)
                else:
                    acc_base = acc_log_w
            else:
                log_z = log_z + torch.where(do_resample, seg,
                                            torch.zeros_like(seg))
                acc_base = torch.where(do_resample,
                                       torch.zeros_like(acc_log_w),
                                       acc_log_w)
        else:
            acc_base = acc_log_w
        # indices are constants under the gradient; gathered values carry
        # it (the reference's biased VSMC gradient)
        slot = slot[idx]
        leaf_counts = leaf_counts[idx]
        root_ll = root_ll[idx]
        row_of_node = row_of_node[idx]
        prev_ll_g = prev_log_ll[idx]
        tilde = prev_ll_g if r > 0 else torch.full_like(prev_ll_g, -logK)
        if config.resample_branch_history and r > 0:
            sum_bl, sum_br = sum_bl[idx], sum_br[idx]
        rate_l = rates_l[r]
        rate_r = rates_r[r]

        ils = torch.stack(logscale_cols, dim=1) if r else None    # (K, r)

        # ---- 2. pair proposal + branches ----
        if twist is not None:
            # twisted proposal (smc.twist); the post-resample tables are
            # what the manual twist reverse pass re-resolves pairs with
            slot_t, rows_t = slot, row_of_node
            if injected is not None:
                llm_in = injected["twist_llm"][r]
                choice_in = injected["twist_choice"][r]
            else:
                llm_in = None
                choice_in = (None if decisions is None else
                             tw.lex_to_prefix_choice(
                                 torch.as_tensor(decisions["twist_choice"][r],
                                                 device=dev), N, M))
            p1, p2, b_l, b_r, q_pen, llm, choice = tw.twisted_extend(
                generator, twist, model, params["model"], stationary,
                leaves_sm, buf, slot, leaf_counts, row_of_node, ils,
                root_ll, n_active, pool_l_all[r], pool_r_all[r], w_vec,
                llm=llm_in, choice=choice_in, shardings=sh)
            P_l_r = P_r_r = None
            if injected is None:
                P_lr = local_transitions(model, params["model"], b_l, b_r,
                                         False, dtype, sh)
                P_l_r, P_r_r = P_lr[:Kl], P_lr[Kl:]
        else:
            if injected is not None:
                p1, p2 = injected["pairs"][r][:, 0], injected["pairs"][r][:, 1]
            elif decisions is not None:
                p1 = decisions["pairs"][r][:, 0].long()
                p2 = decisions["pairs"][r][:, 1].long()
            else:
                p1, p2 = uniform_pair(generator, K, N, n_active, dtype, dev)
            b_l = b_l_all[r]
            b_r = b_r_all[r]
            n_pairs = n_choose_2(n_active)
            if config.q_raw_subtraction:
                q_pen = torch.full((K,), 1.0 / n_pairs, dtype=dtype,
                                   device=dev)
            else:
                q_pen = torch.full((K,), -math.log(n_pairs), dtype=dtype,
                                   device=dev)
            if P_all is not None:
                P_l_r, P_r_r = P_all[r, :Kl], P_all[r, Kl:]

        # ---- 3. child lookups ----
        pair_pos = torch.stack([p1, p2], dim=1)                   # (K, 2)
        nodes, rows_n, q_n, is_leaf_n = lookup_nodes(slot, row_of_node,
                                                     pair_pos, N)
        counts = torch.gather(leaf_counts, 1, pair_pos)
        lscs = node_logscales(ils, rows_n, q_n, is_leaf_n, dtype)
        lsc1, lsc2 = lscs[:, 0], lscs[:, 1]

        child_l = child_r = None
        if injected is not None:
            # ---- 4'. scalar replay: merge scalars injected ----
            rootll_raw = injected["rootll_raw"][r]
            d_lsc = injected["d_lsc"][r]
        elif fused_rank and twist is None:
            # ---- 4''. kernel K1: gather + merge + in-place write ----
            idx4 = torch.stack([rows_n[:, 0], nodes[:, 0], rows_n[:, 1],
                                nodes[:, 1]]).to(torch.int32).contiguous()
            res = fused_rank_update(
                leaves_sm, buf, idx4, r, P_l_r.contiguous(),
                P_r_r.contiguous(), stationary, w_vec,
                save_children=save_children)
            rootll_raw, d_lsc = res[0], res[1]
            if save_children:
                child_l, child_r = res[2], res[3]
        else:
            # ---- 4. explicit children + K8 merge (autograd: K11a) ----
            if kmesh:
                # this rank's particles; children on other ranks come by
                # one exchange over 'k'
                msgs = _coll.fetch_messages(sh, leaves_m, buf, nodes,
                                            rows_n, q_n, is_leaf_n)
            else:
                msgs = gather_messages(leaves_m, buf, nodes, rows_n, q_n,
                                       is_leaf_n)         # (K, 2, A, S)
            m1, m2 = msgs[:, 0].contiguous(), msgs[:, 1].contiguous()
            Pl_m = _coll.enter(sh, P_l_r, ("s",))
            Pr_m = _coll.enter(sh, P_r_r, ("s",))
            if blocks is not None:
                # plain torch, as the JAX package's blocked merge (its
                # merge kernel is off for blocked models)
                merged, d_lsc = merge_messages_sm(
                    m1, m2, Pl_m, Pr_m, rescale=config.rescale,
                    site_weights=sw_m, blocks=blocks)
                rootll_raw = root_log_likelihood_sm(
                    merged, stat_m, site_weights=sw_m) + d_lsc
            elif config.rescale and A <= _kernels.MAX_A:
                merged, rootll_raw, d_lsc = fused_merge_loglik(
                    m1, m2, Pl_m.contiguous(), Pr_m.contiguous(),
                    stat_m, w_m)
            else:
                # no rescaling, or a wide alphabet (K8, like JAX's merge
                # kernel, takes A <= 8): plain torch ops
                merged, d_lsc = merge_messages_sm(
                    m1, m2, Pl_m, Pr_m, rescale=config.rescale,
                    site_weights=sw_m)
                rootll_raw = root_log_likelihood_sm(
                    merged, stat_m, site_weights=sw_m) + d_lsc
            buf[:, r] = merged
            if want_aux and not kmesh:
                # (a 'k' mesh's reverse pass fetches them again)
                child_l, child_r = m1, m2
        if injected is None and sh is not None:
            # one call a collective: the pair summed over 's', then
            # gathered over 'k'
            pair = _coll.gather_particles(sh, _coll.site_sum(
                sh, torch.stack([rootll_raw, d_lsc])))
            rootll_raw, d_lsc = pair[0], pair[1]
        node_lsc = d_lsc + lsc1 + lsc2
        ll_new = rootll_raw + lsc1 + lsc2
        logscale_cols.append(node_lsc)
        row_of_node[:, r] = ar_K

        # ---- 5. compact positions ----
        is_coal = (pos_idx[None, :] == p1[:, None]) | (
            pos_idx[None, :] == p2[:, None])
        perm = torch.argsort(pos_idx[None, :] + N * is_coal.long(), dim=1,
                             stable=True)
        merge_pos = n_active - 2
        at_merge = pos_idx[None, :] == merge_pos
        slot = torch.where(at_merge, N + r, torch.gather(slot, 1, perm))
        leaf_counts = torch.where(at_merge, (counts[:, 0] + counts[:, 1])
                                  [:, None],
                                  torch.gather(leaf_counts, 1, perm))
        root_ll = torch.where(at_merge, ll_new[:, None],
                              torch.gather(root_ll, 1, perm))
        active = pos_idx[None, :] < (n_active - 1)

        # ---- 6. forest posterior (incremental), vcsmc.py:376-384 ----
        data_ll = torch.sum(torch.where(active, root_ll,
                                        torch.zeros_like(root_ll)), dim=1)
        topo_lp = forest_log_prior(leaf_counts, active).to(dtype)
        sum_bl = sum_bl + b_l
        sum_br = sum_br + b_r
        # reference quirk: rank-r rates price ALL branches so far
        branch_lp = ((r + 1.0) * torch.log(rate_l) - rate_l * sum_bl
                     + (r + 1.0) * torch.log(rate_r) - rate_r * sum_br)
        log_ll_r = data_ll + topo_lp + branch_lp

        # ---- 7. weight update, vcsmc.py:386-394 ----
        v_minus = overcounting_correction(leaf_counts, active)
        q_branch = (torch.log(rate_l) - rate_l * b_l + torch.log(rate_r)
                    - rate_r * b_r)
        log_w = (log_ll_r - tilde - q_branch
                 + torch.log(v_minus.to(dtype)) - q_pen)

        prev_log_w, prev_log_ll = log_w, log_ll_r
        acc_log_w = acc_base + log_w
        outs["log_w"].append(log_w)
        outs["log_ll"].append(log_ll_r)
        outs["b_l"].append(b_l)
        outs["b_r"].append(b_r)
        outs["ancestors"].append(idx)
        outs["merged"].append(nodes)
        outs["v_minus"].append(v_minus)
        outs["q_pen"].append(q_pen)
        if want_aux:
            outs["rows"].append(rows_n)
            outs["pairs"].append(pair_pos)
            outs["rootll_raw"].append(rootll_raw)
            outs["d_lsc"].append(d_lsc)
            outs["do_resample"].append(do_resample)
            outs["child_l"].append(child_l)
            outs["child_r"].append(child_r)
            if twist is not None:
                outs["twist_llm"].append(llm)
                outs["twist_choice"].append(choice)
                outs["slot_t"].append(slot_t)
                outs["rows_t"].append(rows_t)
                if tw_eps_l is not None:
                    outs["eps_l"].append(tw.pick(tw_eps_l[r], choice, M))
                    outs["eps_r"].append(tw.pick(tw_eps_r[r], choice, M))

    log_weights = torch.stack(outs["log_w"])
    log_likelihood = torch.stack(outs["log_ll"])
    if config.carried_weights:
        elbo = log_z + (torch.logsumexp(acc_log_w, dim=0) - logK)
    else:
        elbo = compute_log_zsmc(log_weights)
    left = torch.stack(outs["b_l"])
    right = torch.stack(outs["b_r"])
    log_likelihood_R = _debiased_log_likelihood(
        log_likelihood, left, right, rates_l, rates_r, N, config)
    result = SweepResult(
        log_weights=log_weights,
        log_likelihood=log_likelihood,
        elbo=elbo,
        log_likelihood_R=log_likelihood_R,
        left_branches=left,
        right_branches=right,
        ancestors=torch.stack(outs["ancestors"]),
        merged_nodes=torch.stack(outs["merged"]),
        v_minus=torch.stack(outs["v_minus"]),
        q_proposal=torch.stack(outs["q_pen"]),
    )
    if not want_aux:
        return result
    # without saved children the reverse pass re-gathers them from the
    # final write-once buffer (K3), as the twist reverse pass does every
    # candidate pair; with them, the buffer is not kept
    aux = dict(
        site_weights=w_vec, eps_l=eps_l, eps_r=eps_r, b_l=left, b_r=right,
        ancestors=outs["ancestors"], do_resample=outs["do_resample"],
        merged=outs["merged"], pairs=outs["pairs"], rows=outs["rows"],
        rootll_raw=torch.stack(outs["rootll_raw"]),
        d_lsc=torch.stack(outs["d_lsc"]),
        child_l=outs["child_l"], child_r=outs["child_r"],
        buf=None if save_children else buf, leaves_sm=leaves_sm,
        blocks=bwd_blocks,
        explicit_children=not (fused_rank and twist is None),
        shardings=sh,
    )
    if twist is not None:
        # the twist reverse pass re-gathers every candidate pair from the
        # final write-once buffer with the saved pre-rank tables
        aux.update(
            twist_llm=outs["twist_llm"],
            twist_choice=outs["twist_choice"], slot_t=outs["slot_t"],
            rows_t=outs["rows_t"], twist_eps_pool=(tw_eps_l, tw_eps_r))
        if tw_eps_l is not None:
            aux.update(eps_l=torch.stack(outs["eps_l"]),
                       eps_r=torch.stack(outs["eps_r"]))
    return result, aux


def lookup_nodes(slot, row_of_node, pos, N):
    """Node ids at positions pos (K, n) of the forest, with their buffer
    rows and columns (row_of_node resolution; clamped for leaves) and
    leaf flags: (nodes, rows, q, is_leaf), each (K, n)."""
    R = row_of_node.shape[1]
    nodes = torch.gather(slot, 1, pos)
    is_leaf = nodes < N
    q = torch.clamp(nodes - N, 0, R - 1)
    rows = torch.gather(row_of_node, 1, q)
    return nodes, rows, q, is_leaf


def node_logscales(node_lsc, rows, q, is_leaf, dtype):
    """Carried log-scale totals of looked-up nodes (0 for leaves);
    node_lsc (K, r) holds the internal nodes' columns so far, None at
    rank 0."""
    if node_lsc is None:
        return torch.zeros(q.shape, dtype=dtype, device=q.device)
    lsc = node_lsc[rows, torch.clamp(q, max=node_lsc.shape[1] - 1)]
    return torch.where(is_leaf, torch.zeros_like(lsc), lsc)


def gather_messages(leaves_sm, buf, nodes, rows, q, is_leaf):
    """Scaled messages (K, n, A, S) of looked-up nodes: leaves from the
    shared (N, A, S) array, internal nodes from buf[row, node - N]."""
    N = leaves_sm.shape[0]
    leaf_part = leaves_sm[torch.clamp(nodes, 0, N - 1)]
    return torch.where(is_leaf[..., None, None], leaf_part, buf[rows, q])


def _debiased_log_likelihood(log_likelihood, branches_l, branches_r,
                             rates_l, rates_r, N, config):
    """P(Y|t, theta) at the final rank: strip the branch prior and
    restore the (2N-3)!! topology count (reference vcsmc.py:254-268);
    the right branches take the LEFT rates' multiplier when
    config.right_multiplier_bug (vcsmc.py:262)."""
    lp_l = torch.sum(torch.log(rates_l)[:, None]
                     - rates_l[:, None] * branches_l, dim=0)
    r_mult = rates_l if config.right_multiplier_bug else rates_r
    lp_r = torch.sum(torch.log(r_mult)[:, None]
                     - rates_r[:, None] * branches_r, dim=0)
    return (log_likelihood[-1] + log_double_factorial_odd(2 * N - 3)
            - lp_l - lp_r)
