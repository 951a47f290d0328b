"""The combinatorial SMC sweep (port of phylo_tpu/smc/sweep.py, the
non-twist path).

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
host).  With ``fused_rank`` each rank is one call of kernel K1
(pruning.kernels.fused_rank_update, in place); otherwise the merge is
plain torch that autograd differentiates.  On the card the sweep always
takes the kernel path.

The reference quirks stay default-on (``q_raw_subtraction``,
``right_multiplier_bug``), see ``SweepConfig``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from phylo_tpu_torch.models.branches import branch_rates
from phylo_tpu_torch.pruning.felsenstein import (
    merge_messages_sm,
    root_log_likelihood_sm,
)
from phylo_tpu_torch.pruning.kernels import (
    alloc_rank_buffer,
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
        VJP (smc.sweep_vjp: K1 forward, K2 reverse); False runs plain
        torch autograd through the sweep (CPU only: its merge kernel,
        K8, is not ported).
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
                           eps_r, dtype):
    """Branch lengths b = eps / rate (pathwise-differentiable in the
    rates) and ONE batched transition call for all ranks' branches,
    (R, 2K, A, A).  Shared by the sweep and the manual-VJP prologue so
    both linearize at identical values."""
    b_l_all = eps_l / rates_l[:, None]
    b_r_all = eps_r / rates_r[:, None]
    P_all = model.transition(
        model_params, torch.cat([b_l_all, b_r_all], dim=1)).to(dtype)
    return b_l_all, b_r_all, P_all


def _check_supported(config, leaves):
    if config.resampling not in ("multinomial", "systematic",
                                 "stratified", "none"):
        raise ValueError(
            f"unknown resampling strategy {config.resampling!r}")
    if leaves.is_cuda and not config.rescale:
        raise NotImplementedError(
            "rescale=False has no CUDA kernel (K1 always rescales)")


def sample_phylogenies(generator, leaves, model, params, config, *,
                       decisions=None, site_weights=None):
    """Run one full CSMC sweep.

    generator: torch.Generator on leaves' device (unused when every
        decision is injected).
    leaves: (N, S, A) one-hot / ambiguity-coded genomes.
    params: {'model': {...}, 'branches': {'log_rates_l', 'log_rates_r'}}.
    decisions: optional pre-drawn randomness ('ancestors' (N-1, K),
        'pairs' (N-1, K, 2), 'branches_l'/'branches_r' (N-1, K)); the
        sweep is then deterministic and the branch lengths are constants.

    Differentiable in `params` when grad is enabled: through the manual
    whole-sweep VJP (smc.sweep_vjp) by default, or plain autograd with
    SweepConfig(manual_vjp=False) on the CPU.  Injected decisions reach
    both routes.
    """
    _check_supported(config, leaves)
    tensors = [t for sub in params.values() for t in sub.values()]
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)
    if not needs_grad:
        with torch.no_grad():
            return _sample_body(generator, leaves, model, params, config,
                                decisions=decisions,
                                site_weights=site_weights,
                                fused_rank=config.rescale)
    if config.manual_vjp and config.rescale:
        from phylo_tpu_torch.smc.sweep_vjp import sweep_manual_vjp

        return sweep_manual_vjp(generator, leaves, model, params, config,
                                decisions=decisions,
                                site_weights=site_weights)
    if leaves.is_cuda:
        raise NotImplementedError(
            "plain autograd through the sweep has no CUDA kernel (K8 "
            "fused_merge_loglik is not ported: ROADMAP.md Queue 2); use "
            "manual_vjp=True")
    return _sample_body(generator, leaves, model, params, config,
                        decisions=decisions, site_weights=site_weights)


def _sample_body(generator, leaves, model, params, config, *,
                 decisions=None, site_weights=None, injected=None,
                 want_aux=False, fused_rank=False):
    """One sweep.  Modes:

    * plain (fused_rank=False): torch merge ops, differentiable;
    * fused_rank=True: kernel K1 per rank (no autograd rule);
      want_aux also saves the children and the records the manual VJP
      needs;
    * injected: scalar replay for the manual VJP -- ancestors, pairs,
      resample gates and the per-rank merge scalars (rootll_raw, d_lsc)
      come from the forward run, and no message is touched.

    Returns SweepResult, or (SweepResult, aux) with want_aux.
    """
    N, S, A = leaves.shape
    K = config.K
    R = N - 1
    dtype = leaves.dtype
    dev = leaves.device
    leaves_sm = leaves.transpose(1, 2).contiguous()         # (N, A, S)

    stationary = model.stationary(params["model"], dtype=dtype,
                                  device=dev).to(dtype)
    rates_l, rates_r = branch_rates(params["branches"])
    rates_l = rates_l.to(dtype)
    rates_r = rates_r.to(dtype)
    w_vec = (site_weights.to(dtype) if site_weights is not None
             else torch.ones((S,), dtype=dtype, device=dev))
    leaf_ll = root_log_likelihood_sm(leaves_sm, stationary,
                                     site_weights=site_weights)   # (N,)
    logK = math.log(K)

    # ---- branch lengths + transitions for ALL ranks, one batched call
    # (the scalar replay needs the branch lengths only)
    eps_l = eps_r = P_all = None
    if decisions is not None:
        b_l_all = decisions["branches_l"].to(dtype)
        b_r_all = decisions["branches_r"].to(dtype)
        if injected is None:
            P_all = model.transition(
                params["model"], torch.cat([b_l_all, b_r_all], dim=1)
            ).to(dtype)
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
            model, params["model"], rates_l, rates_r, eps_l, eps_r, dtype)

    buf = None
    if injected is None:
        buf = alloc_rank_buffer(K, R, A, S, dtype, dev)

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
                            "child_l", "child_r")}

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

        # ---- 2. pair proposal + presampled branches ----
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
            q_pen = torch.full((K,), 1.0 / n_pairs, dtype=dtype, device=dev)
        else:
            q_pen = torch.full((K,), -math.log(n_pairs), dtype=dtype,
                               device=dev)

        # ---- 3. child lookups ----
        pair_pos = torch.stack([p1, p2], dim=1)                   # (K, 2)
        nodes = torch.gather(slot, 1, pair_pos)
        counts = torch.gather(leaf_counts, 1, pair_pos)
        is_leaf_n = nodes < N
        q_n = torch.clamp(nodes - N, 0, R - 1)
        rows_n = torch.gather(row_of_node, 1, q_n)
        if r:
            ils = torch.stack(logscale_cols, dim=1)       # (K, r)
            lsc_int = ils[rows_n, torch.clamp(q_n, max=r - 1)]
            lscs = torch.where(is_leaf_n, torch.zeros_like(lsc_int),
                               lsc_int)
        else:
            lscs = torch.zeros((K, 2), dtype=dtype, device=dev)
        lsc1, lsc2 = lscs[:, 0], lscs[:, 1]

        child_l = child_r = None
        if injected is not None:
            # ---- 4'. scalar replay: merge scalars injected ----
            rootll_raw = injected["rootll_raw"][r]
            d_lsc = injected["d_lsc"][r]
        elif fused_rank:
            # ---- 4''. kernel K1: gather + merge + in-place write ----
            idx4 = torch.stack([rows_n[:, 0], nodes[:, 0], rows_n[:, 1],
                                nodes[:, 1]]).to(torch.int32).contiguous()
            res = fused_rank_update(
                leaves_sm, buf, idx4, r, P_all[r, :K].contiguous(),
                P_all[r, K:].contiguous(), stationary, w_vec,
                save_children=want_aux)
            rootll_raw, d_lsc = res[0], res[1]
            if want_aux:
                child_l, child_r = res[2], res[3]
        else:
            # ---- 4. plain merge (autograd-differentiable) ----
            leaf_part = leaves_sm[torch.clamp(nodes, 0, N - 1)]
            int_part = buf[rows_n, q_n]
            msgs = torch.where(is_leaf_n[..., None, None], leaf_part,
                               int_part)                  # (K, 2, A, S)
            merged, d_lsc = merge_messages_sm(
                msgs[:, 0], msgs[:, 1], P_all[r, :K], P_all[r, K:],
                rescale=config.rescale, site_weights=site_weights)
            rootll_raw = root_log_likelihood_sm(
                merged, stationary, site_weights=site_weights) + d_lsc
            buf[:, r] = merged
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
    aux = dict(
        site_weights=w_vec, eps_l=eps_l, eps_r=eps_r,
        ancestors=outs["ancestors"], do_resample=outs["do_resample"],
        merged=outs["merged"], pairs=outs["pairs"], rows=outs["rows"],
        rootll_raw=torch.stack(outs["rootll_raw"]),
        d_lsc=torch.stack(outs["d_lsc"]),
        child_l=outs["child_l"], child_r=outs["child_r"],
    )
    return result, aux


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
