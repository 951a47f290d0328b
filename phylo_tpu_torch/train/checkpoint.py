"""Checkpoint and resume (port of phylo_tpu/train/checkpoint.py, which
writes Orbax directories).

The checkpoint of epoch e is one file, ``<path>/epoch_<e>``, written by
torch.save: the parameters, the optimizer's state_dict, e and the
training history, so a resumed run's results.p covers the epochs before
the resume too.  It is written under a temporary name, flushed to disk
and moved into place with os.replace, so a process killed during a save
leaves the earlier checkpoints whole and never a torn ``epoch_<e>``.
"""

from __future__ import annotations

import os

import torch

from phylo_tpu_torch.params import flatten


def save_checkpoint(path, params, optimizer, epoch, history=None):
    """Write ``<path>/epoch_<epoch>`` and return its path."""
    path = os.path.abspath(str(path))
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"epoch_{epoch}")
    tmp = f"{final}.tmp-{os.getpid()}"
    skeleton, tensors = flatten(params)
    payload = {
        "params": [t.detach() for t in tensors],
        "skeleton": skeleton,
        "optimizer": optimizer.state_dict(),
        "epoch": int(epoch),
        "history": history,
    }
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    return final


def latest_checkpoint(path):
    """The complete checkpoint of the largest epoch under `path`, or None
    (temporary files of an interrupted save are not checkpoints)."""
    path = os.path.abspath(str(path))
    if not os.path.isdir(path):
        return None
    epochs = [int(d[6:]) for d in os.listdir(path)
              if d.startswith("epoch_") and d[6:].isdigit()]
    if not epochs:
        return None
    return os.path.join(path, f"epoch_{max(epochs)}")


def restore_checkpoint(path, params, optimizer):
    """Restore a checkpoint, or the latest one in a directory, into the
    run's own leaf tensors (in place, so the optimizer keeps them) and
    optimizer; returns (epoch, history).  The file is loaded onto the
    host (map_location="cpu"), so a checkpoint written on the card
    restores on a machine without one; copy_ and the optimizer's
    load_state_dict then place each value on its parameter's device, and
    Adam's step counter where a fresh run keeps it (on the card for the
    trainer's capturable Adam, on the host on the CPU).  The trainer
    restores before its fused epoch captures anything, so the graphs
    hold the restored tensors.  history is None for checkpoints written
    without one."""
    path = os.path.abspath(str(path))
    if not os.path.basename(path).startswith("epoch_"):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = latest
    skeleton, tensors = flatten(params)
    # the file is this program's own checkpoint: its history holds numpy
    # arrays and strings, which a weights-only load refuses
    payload = torch.load(path, map_location="cpu", weights_only=False)
    saved = payload["params"]
    if payload["skeleton"] != skeleton or any(
            s.shape != t.shape or s.dtype != t.dtype
            for s, t in zip(saved, tensors)):
        raise ValueError(
            f"checkpoint {path} holds parameters of another model or "
            "dtype than this run's")
    with torch.no_grad():
        for t, s in zip(tensors, saved):
            t.copy_(s)
    optimizer.load_state_dict(payload["optimizer"])
    return payload["epoch"], payload["history"]
