"""Device and dtype resolution shared by the port's entry points.

The card is the default: ``resolve_device(None)`` is ``cuda``, and asking
for ``cuda`` without a visible GPU raises instead of carrying on on the
CPU.  The CPU is used only when the caller names it (the tests do).
"""

from __future__ import annotations

import functools

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@functools.lru_cache(maxsize=None)
def device_constant(values, dtype, device):
    """torch.tensor(values) on `device`, made once per (values, dtype,
    device): `values` a hashable nesting of tuples.  A host-to-device
    copy inside a sweep would synchronise with the card, and a CUDA
    graph cannot capture one.  Callers must not write into the tensor."""
    return torch.tensor(values, dtype=dtype, device=device)


def resolve_device(device=None):
    """torch.device for an entry point; ``None`` means ``cuda``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "phylo_tpu_torch runs on a CUDA device by default and none "
                "is visible; pass device='cpu' (--device=cpu) to run on "
                "the CPU"
            )
        # the A x A contractions must stay exact float32 (on the TPU,
        # bf16 contractions flipped DS1's ELBO sign; TF32 is the Hopper
        # analogue)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_dtype(name, device):
    """torch dtype for a config dtype name on `device`.  The slice runs
    float32 on the card and float32/float64 on the CPU; None names the
    device's default, float64 on the CPU and float32 on the card (the
    tree tools' CLIs)."""
    if name is None:
        name = "float32" if torch.device(device).type == "cuda" else \
            "float64"
    if name not in _DTYPES:
        raise NotImplementedError(
            f"dtype {name!r} is not ported (float32, and float64 on the "
            "CPU); see ROADMAP.md Queue 1"
        )
    dtype = _DTYPES[name]
    if dtype == torch.float64 and torch.device(device).type == "cuda":
        raise NotImplementedError(
            "float64 on cuda is not ported: the CUDA kernels are float32 "
            "only; see ROADMAP.md Queue 2"
        )
    return dtype
