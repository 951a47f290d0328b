"""Felsenstein pruning primitives (port of
phylo_tpu/pruning/felsenstein.py): the node-major forms merge_messages /
root_log_likelihood, which fixed-tree scoring and ancestral states use,
and the sweep's states-major forms merge_messages_sm (with its blocked
contraction and that contraction's hand-written backward) and
root_log_likelihood_sm.

The reference's hot op (vcsmc.py:180-188, 231-245): message =
(l_data @ P_l) * (r_data @ P_r), then a stationary dot, log and site sum.
Messages are rescaled per site (divide by the per-site max, carry the log
of the scale) so float32 does not underflow.
"""

from __future__ import annotations

import torch

from phylo_tpu_torch.models.expm import _matmul, exact_matmul


def merge_messages(l_msg, r_msg, P_l, P_r, *, rescale=True,
                   site_weights=None):
    """Combine two child messages through their branch transitions.

    l_msg, r_msg: (..., S, A) partial likelihoods (possibly scaled).
    P_l, P_r:     (..., A, A) transition matrices.  The products are
        explicit multiply-adds up to 8 states, float32-exact matmuls
        above (`models.expm._matmul`).
    site_weights: optional (S,) per-site weights (0 masks a site out of
        the accumulated log scale).

    Returns (msg (..., S, A), log_scale_total (...,)): the merged message,
    per-site rescaled if requested, and the (weighted) sum over sites of
    the log scale factors (zeros when rescale=False).
    """
    msg = _matmul(l_msg, P_l) * _matmul(r_msg, P_r)
    if not rescale:
        return msg, torch.zeros(msg.shape[:-2], dtype=msg.dtype,
                                device=msg.device)
    scale = torch.amax(msg, dim=-1, keepdim=True)
    scale = torch.clamp(scale, min=torch.finfo(msg.dtype).tiny)
    msg = msg / scale
    log_scale = torch.log(scale[..., 0])
    if site_weights is not None:
        log_scale = log_scale * site_weights
    return msg, torch.sum(log_scale, dim=-1)


def root_log_likelihood(msg, stationary, log_scale_total=None,
                        site_weights=None):
    """Data log-likelihood of a root message (..., S, A):
    sum_s [w_s] log(sum_a pi_a msg_{s,a}) (+ accumulated log scales),
    the stationary dot and log-sum of the reference's tree and forest
    posteriors (vcsmc.py:197-198, 225-226, 240-242)."""
    site_lik = torch.sum(msg * stationary, dim=-1)
    log_site = torch.log(site_lik)
    if site_weights is not None:
        log_site = log_site * site_weights
    ll = torch.sum(log_site, dim=-1)
    if log_scale_total is not None:
        ll = ll + log_scale_total
    return ll


# ---------------------------------------------------------------------
# States-major (..., A, S) forms: the sweep's layout
# ---------------------------------------------------------------------

def _contract(msg, P):
    """sum_a msg[..., a, s] P[..., a, b] -> (..., b, s), as explicit
    multiply-add (exact in the working precision)."""
    return torch.sum(msg[..., :, None, :] * P[..., :, :, None], dim=-3)


class _ContractBlocked(torch.autograd.Function):
    """(..., G, A, S) x (..., G, A, A) -> (..., G, A, S): each block's
    states-major contraction.  The forward is `_contract`'s explicit
    multiply-add; the backward is written by hand as two block-batched
    products, dm = P du over the target state and dP = m du^T over the
    sites, the block-diagonal part of the JAX package's dense backward
    (its off-block terms are discarded there)."""

    @staticmethod
    def forward(ctx, m, P):
        ctx.save_for_backward(m, P)
        return _contract(m, P)

    @staticmethod
    def backward(ctx, du):
        m, P = ctx.saved_tensors
        dm = dP = None
        if ctx.needs_input_grad[0]:
            dm = exact_matmul(P, du)
        if ctx.needs_input_grad[1]:
            dP = exact_matmul(m, du.transpose(-1, -2))
        return dm, dP


def _contract_blocked_sm(msg, P, G, A):
    """States-major contraction with a block-diagonal transition given by
    its blocks: msg (..., G*A, S), P (..., G, A, A) -> (..., G*A, S).
    Rate categories never mix along a branch, so each block contracts
    alone (G x fewer operations than the dense (GA, GA) form)."""
    lead = msg.shape[:-2]
    S = msg.shape[-1]
    out = _ContractBlocked.apply(msg.reshape(*lead, G, A, S), P)
    return out.reshape(*lead, G * A, S)


def merge_messages_sm(l_msg, r_msg, P_l, P_r, *, rescale=True,
                      site_weights=None, blocks=None):
    """States-major merge: l_msg/r_msg (..., A, S), P (..., A, A) ->
    (msg (..., A, S), log_scale_total (...,)).

    blocks: optional (G, A_base); P_l/P_r are then per-category
    transitions (..., G, A_base, A_base) of a block-diagonal generator
    and the messages have G * A_base planes."""
    if blocks is not None:
        G, A = blocks
        msg = (_contract_blocked_sm(l_msg, P_l, G, A)
               * _contract_blocked_sm(r_msg, P_r, G, A))
    else:
        msg = _contract(l_msg, P_l) * _contract(r_msg, P_r)
    if not rescale:
        return msg, torch.zeros(msg.shape[:-2], dtype=msg.dtype,
                                device=msg.device)
    scale = torch.amax(msg, dim=-2, keepdim=True)
    scale = torch.clamp(scale, min=torch.finfo(msg.dtype).tiny)
    msg = msg / scale
    log_scale = torch.log(scale[..., 0, :])
    if site_weights is not None:
        log_scale = log_scale * site_weights
    return msg, torch.sum(log_scale, dim=-1)


def root_log_likelihood_sm(msg, stationary, log_scale_total=None,
                           site_weights=None):
    """States-major root log-likelihood: msg (..., A, S) -> (...,),
    sum_s [w_s] log(sum_a pi_a msg_{a,s}) (+ accumulated log scales)."""
    site_lik = torch.sum(msg * stationary[:, None], dim=-2)
    log_site = torch.log(site_lik)
    if site_weights is not None:
        log_site = log_site * site_weights
    ll = torch.sum(log_site, dim=-1)
    if log_scale_total is not None:
        ll = ll + log_scale_total
    return ll
