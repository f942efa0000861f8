"""Admission policies for the serving engine (counterpart of
``repro/serving/scheduler.py``; pure host-side bookkeeping).

* ``fcfs`` -- strict arrival order, fill every free slot.
* ``sjf`` -- shortest-prompt-first (stable on arrival order).
* ``gemv_aware`` -- shortest-prompt-first, capped so the number of
  concurrently decoding slots never exceeds ``gemv_batch_threshold``:
  above it the dispatcher's batch gate sends every decode GEMV to ``ref``,
  so the cap keeps decode on the GEMV kernels.

``max_queue`` bounds the waiting queue (:class:`QueueFull` on overflow).
A request whose absolute ``deadline`` passes while still *queued* is
expired by :meth:`Scheduler.expire` and never admitted; running requests
are left to finish.  Preemption and expert-aware admission are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

POLICIES = ("fcfs", "sjf", "gemv_aware")


class QueueFull(RuntimeError):
    """Waiting-queue backpressure: the submission was not enqueued."""


@dataclass
class SchedulerConfig:
    policy: str = "fcfs"              # fcfs | sjf | gemv_aware
    max_queue: int = 0                # 0 = unbounded
    gemv_batch_threshold: int = 8     # gemv_aware: max concurrent decode slots

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown scheduler policy {self.policy!r}; "
                             f"expected one of {POLICIES}")


@dataclass
class Scheduler:
    """Waiting queue + admission policy."""

    config: SchedulerConfig = field(default_factory=SchedulerConfig)
    queue: list = field(default_factory=list)
    _seq: int = 0                     # arrival tiebreak for stable ordering

    def __len__(self) -> int:
        return len(self.queue)

    def submit(self, req, now: float = 0.0) -> None:
        cfg = self.config
        if cfg.max_queue and len(self.queue) >= cfg.max_queue:
            raise QueueFull(f"waiting queue full ({cfg.max_queue}); request "
                            f"{req.rid} not enqueued")
        req.submit_time = now
        req.arrival_seq = self._seq
        self._seq += 1
        self.queue.append(req)

    def expire(self, now: float) -> list:
        """Remove (and return) queued requests whose deadline has passed."""
        expired = [r for r in self.queue
                   if r.deadline is not None and now >= r.deadline]
        if expired:
            dead = set(id(r) for r in expired)
            self.queue = [r for r in self.queue if id(r) not in dead]
        return expired

    def select(self, free_slots: int, n_active: int,
               now: float = 0.0) -> list:
        """Pop the requests to admit this step, in admission order."""
        cfg = self.config
        cap = free_slots
        if cfg.policy == "gemv_aware":
            cap = min(free_slots,
                      max(0, cfg.gemv_batch_threshold - n_active))
        if cap <= 0 or not self.queue:
            return []
        if cfg.policy == "fcfs":
            order = list(self.queue)
        else:  # sjf and gemv_aware: shortest prompt first, stable
            order = sorted(self.queue,
                           key=lambda r: (len(r.prompt), r.arrival_seq))
        picked = order[:cap]
        taken = set(id(r) for r in picked)
        self.queue = [r for r in self.queue if id(r) not in taken]
        return picked
