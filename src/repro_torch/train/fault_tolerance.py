"""Fault tolerance for the train loop (counterpart of
``repro/train/fault_tolerance.py``, the same semantics).

* :class:`StragglerMonitor` -- an EWMA of step times that flags outliers;
* :class:`FaultInjector` -- a deterministic failure source: it raises at
  given steps, once each.  Every rank of a mesh holds the same one, so
  all of them raise at the same step, before that step's collective;
* :func:`run_with_recovery` -- the restart policy: on a failed step,
  restore the latest checkpoint and replay (the data is addressed by
  step, so the replay is exact); gives up after ``max_restarts``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable


class StragglerMonitor:
    """Flags steps slower than ``threshold`` times the EWMA of recent
    steps (after ``warmup`` steps)."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: float | None = None
        self.n = 0
        self.flagged: list[tuple[int, float, float]] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = self.n > self.warmup and dt > self.threshold * self.ewma
        if is_straggler:
            self.flagged.append((step, dt, self.ewma))
        else:
            # a straggler does not move the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


class FaultInjector:
    """Raises at each of ``fail_at``'s steps exactly once (a preemption)."""

    def __init__(self, fail_at: set[int] | None = None):
        self.fail_at = set(fail_at or ())
        self.fired: set[int] = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected fault at step {step}")


@dataclass
class RecoveryStats:
    restarts: int = 0
    restored_steps: list[int] = field(default_factory=list)
    straggler_steps: list[int] = field(default_factory=list)


def run_with_recovery(
    *,
    n_steps: int,
    do_step: Callable[[int], dict],
    save: Callable[[int], None],
    restore: Callable[[], int],
    ckpt_every: int,
    max_restarts: int = 3,
    monitor: StragglerMonitor | None = None,
    on_metrics: Callable[[int, dict], None] | None = None,
) -> RecoveryStats:
    """Drive steps ``[resume, n_steps)`` with checkpoint / restart.

    ``do_step(step)`` advances model and data by one step and returns its
    metrics; ``save(step)`` checkpoints AFTER that step; ``restore()``
    loads the latest checkpoint and returns the step to resume from.
    """
    stats = RecoveryStats()
    monitor = monitor or StragglerMonitor()
    step = restore()
    while step < n_steps:
        try:
            t0 = time.perf_counter()
            metrics = do_step(step)
            dt = time.perf_counter() - t0
            if monitor.record(step, dt):
                stats.straggler_steps.append(step)
            if on_metrics:
                on_metrics(step, metrics)
            step += 1
            if step % ckpt_every == 0 or step == n_steps:
                save(step)
        except Exception:
            stats.restarts += 1
            if stats.restarts > max_restarts:
                raise
            step = restore()
            stats.restored_steps.append(step)
    return stats
