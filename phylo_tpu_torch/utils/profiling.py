"""Profiling and timing helpers (port of phylo_tpu/utils/profiling.py).

The reference's only instrumentation is per-epoch datetime deltas
(reference vcsmc.py:530,590-591).  Here: a torch.profiler context that
writes a Chrome trace of the host and the card, and timers that wait for
the card's queued work before they read the clock (CUDA calls return
before the device finishes).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

from phylo_tpu_torch.device import resolve_device


@contextlib.contextmanager
def device_trace(logdir, device=None):
    """Trace the host and, on ``cuda`` (the default), the card's kernels
    with torch.profiler; writes ``<logdir>/trace.json`` (Chrome trace
    format, for Perfetto or chrome://tracing) and yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(logdir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        synchronize(dev)
    prof.export_chrome_trace(os.path.join(str(logdir), "trace.json"))


def synchronize(x):
    """Wait for the CUDA devices that `x` lives on: a tensor, a device
    (or its name), or a tuple, list, dict or dataclass holding them."""
    if isinstance(x, str):
        x = torch.device(x)
    for dev in _devices(x):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _devices(x):
    if isinstance(x, torch.Tensor):
        return {x.device}
    if isinstance(x, torch.device):
        return {x}
    if isinstance(x, dict):
        x = list(x.values())
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (list, tuple)):
        return set().union(*(_devices(v) for v in x))
    return set()


class BlockTimer:
    """Wall-clock timer that waits for the card.

    Usage:
        with BlockTimer("epoch", sync="cuda") as t: ...
        print(t.seconds)

    sync: a tensor or device (anything `synchronize` takes) whose queued
    work is waited for before each reading of the clock; None reads the
    host clock alone.
    """

    def __init__(self, name="", sync=None):
        self.name = name
        self.sync = sync
        self.seconds = None

    def __enter__(self):
        synchronize(self.sync)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        synchronize(self.sync)
        self.seconds = time.perf_counter() - self.t0
        return False


def timed(fn, *args, warmup=1, iters=3, **kwargs):
    """Time `fn(*args, **kwargs)` after `warmup` calls (the first builds
    the kernels); returns (seconds_per_call, last_output).  Waits for the
    devices of the output's tensors before each reading of the clock."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
    synchronize(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    synchronize(out)
    return (time.perf_counter() - t0) / iters, out
