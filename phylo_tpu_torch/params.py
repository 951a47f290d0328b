"""Parameters carried between the JAX package and the port.

The JAX tree is {"model": {"y_q", "y_station"} (ReferenceQ; {} for JC69),
"branches": {"log_rates_l", "log_rates_r"}}.  With numpy leaves (e.g.
``jax.tree.map(np.asarray, params)``) it becomes the port's parameters,
the same nesting with leaf tensors, and back -- so both packages can be
made to compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, dtype=None, device="cpu", requires_grad=True):
    """{group: {name: array}} -> {group: {name: leaf tensor}}.  dtype
    defaults to each array's own; leaves require grad unless told not."""
    out = {"model": {}, "branches": {}}
    for group, sub in tree.items():
        out.setdefault(group, {})
        for name, value in sub.items():
            arr = np.asarray(value)
            t = torch.tensor(arr, dtype=dtype or torch.from_numpy(
                np.ascontiguousarray(arr)).dtype, device=device)
            out[group][name] = t.requires_grad_(requires_grad)
    return out


def params_to_numpy(params):
    """The port's parameters (or their gradients' tree) as numpy."""
    return {group: {name: t.detach().cpu().numpy()
                    for name, t in sub.items()}
            for group, sub in params.items()}
