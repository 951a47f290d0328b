"""Elastic training: automatic resume from checkpoint on failure (port of
phylo_tpu/train/elastic.py).

The reference has no failure story at all -- a dead run loses
everything except the end-of-run pickle (SURVEY.md section 5).  Here
two mechanisms compose:

1. **Crash-consistent checkpoints** (train.checkpoint): each is written
   under a temporary name and moved into place, so a process killed
   mid-save leaves the earlier checkpoints, never a torn one.
2. **Deterministic per-epoch random streams** (trainer.step_generator):
   every generator is a pure function of (seed, epoch, step), so a run
   resumed from the epoch-e checkpoint replays epochs e.. bit for bit on
   the CPU (tests/test_torch_lifecycle.py, also after a SIGKILL).

`train_elastic` is the in-process supervisor on top: it retries `train`
after transient failures (device resets, preemption-style exceptions),
resuming from the latest checkpoint each time.  Process death (SIGKILL,
machine loss) is covered by re-running the same command --
`resume_from="auto"` finds the latest checkpoint in the stable
`checkpoint_dir`.
"""

from __future__ import annotations

import dataclasses
import time

from phylo_tpu_torch.device import resolve_device


def train_elastic(dataset, config, max_restarts=3, retry_delay_s=0.0,
                  on_failure=None):
    """Run `trainer.train` with automatic resume on failure.

    config must set `checkpoint_every` > 0 and a stable `checkpoint_dir`
    (the timestamped per-run default cannot be found again after a
    restart).  Returns the TrainResult of the successful attempt;
    re-raises the last failure after `max_restarts` retries.  A missing
    GPU raises at once and is not retried.

    on_failure: optional callback (attempt:int, exc:Exception) -> None,
    e.g. for alerting; exceptions it raises abort the supervisor.
    """
    from phylo_tpu_torch.train.trainer import train

    if not config.checkpoint_every or not config.checkpoint_dir:
        raise ValueError(
            "train_elastic needs checkpoint_every > 0 and a stable "
            "checkpoint_dir")
    resolve_device(config.device)
    # the first attempt honours an explicit resume_from (e.g. a warm start
    # from another run's checkpoint); retries always pick up the latest
    # checkpoint in this run's stable checkpoint_dir
    retry_cfg = dataclasses.replace(config, resume_from="auto")
    cfg = config if config.resume_from else retry_cfg
    last_exc = None
    for attempt in range(max_restarts + 1):
        try:
            return train(dataset, cfg if attempt == 0 else retry_cfg)
        except KeyboardInterrupt:
            raise
        except Exception as exc:  # noqa: BLE001 -- supervisor boundary
            last_exc = exc
            if on_failure is not None:
                on_failure(attempt, exc)
            if attempt < max_restarts:
                print(f"train_elastic: attempt {attempt + 1} failed "
                      f"({type(exc).__name__}: {exc}); resuming from the "
                      f"latest checkpoint in {config.checkpoint_dir}")
                if retry_delay_s:
                    time.sleep(retry_delay_s)
    raise last_exc
