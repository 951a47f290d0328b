"""Parameters carried between the JAX package and the port.

The JAX tree is {"model": {...}, "branches": {"log_rates_l",
"log_rates_r"}}, nested further for the rate mixtures ({"model":
{"base": {...}, "log_alpha": ...}}).  With numpy leaves (e.g.
``jax.tree.map(np.asarray, params)``) it becomes the port's parameters,
the same nesting with leaf tensors, and back -- so both packages can be
made to compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, dtype=None, device="cpu", requires_grad=True):
    """Nested {name: array} dicts -> the same nesting of leaf tensors.
    dtype defaults to each array's own; leaves require grad unless told
    not.  The top level always has "model" and "branches"."""
    def conv(sub):
        if isinstance(sub, dict):
            return {name: conv(v) for name, v in sub.items()}
        arr = np.asarray(sub)
        t = torch.tensor(arr, dtype=dtype or torch.from_numpy(
            np.ascontiguousarray(arr)).dtype, device=device)
        return t.requires_grad_(requires_grad)

    out = {"model": {}, "branches": {}}
    out.update(conv(dict(tree)))
    return out


def params_to_numpy(params):
    """The port's parameters (or their gradients' tree) as numpy."""
    if isinstance(params, dict):
        return {name: params_to_numpy(v) for name, v in params.items()}
    return params.detach().cpu().numpy()


def flatten(params):
    """(skeleton, tensors) of a nested parameter dict: the tensors in
    sorted key order at every level, and the same nesting with each
    tensor replaced by its position (empty groups kept), which
    `unflatten(skeleton, tensors)` fills back in."""
    tensors = []

    def walk(sub):
        if not isinstance(sub, dict):
            tensors.append(sub)
            return len(tensors) - 1
        return {name: walk(sub[name]) for name in sorted(sub)}

    return walk(params), tensors


def unflatten(skeleton, tensors):
    def fill(sub):
        if isinstance(sub, dict):
            return {name: fill(v) for name, v in sub.items()}
        return tensors[sub]

    out = {"model": {}, "branches": {}}
    out.update(fill(skeleton))
    return out
