"""Felsenstein pruning primitives in the sweep's states-major layout
(port of phylo_tpu/pruning/felsenstein.py: merge_messages_sm with its
blocked contraction, root_log_likelihood_sm).

The reference's hot op (vcsmc.py:180-188, 231-245): message =
(l_data @ P_l) * (r_data @ P_r), then a stationary dot, log and site sum.
Messages are rescaled per site (divide by the per-site max, carry the log
of the scale) so float32 does not underflow.
"""

from __future__ import annotations

import torch


def _contract(msg, P):
    """sum_a msg[..., a, s] P[..., a, b] -> (..., b, s), as explicit
    multiply-add (exact in the working precision)."""
    return torch.sum(msg[..., :, None, :] * P[..., :, :, None], dim=-3)


def _contract_blocked_sm(msg, P, G, A):
    """States-major contraction with a block-diagonal transition given by
    its blocks: msg (..., G*A, S), P (..., G, A, A) -> (..., G*A, S).
    Rate categories never mix along a branch, so each block contracts
    alone (G x fewer operations than the dense (GA, GA) form)."""
    lead = msg.shape[:-2]
    S = msg.shape[-1]
    out = _contract(msg.reshape(*lead, G, A, S), P)
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
