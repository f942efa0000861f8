"""Admission policies for the serving engine (counterpart of
``repro/serving/scheduler.py``; pure host-side bookkeeping).

* ``fcfs`` -- strict arrival order, fill every free slot.
* ``sjf`` -- shortest-prompt-first (stable on arrival order).
* ``gemv_aware`` -- shortest-prompt-first, capped so the number of
  concurrently decoding slots never exceeds ``gemv_batch_threshold``:
  above it the dispatcher's batch gate sends every decode GEMV to ``ref``,
  so the cap keeps decode on the GEMV kernels.  On an MoE model
  (``moe_experts > 1``) the cap also keeps the predicted per-expert decode
  batch, :func:`expert_batch_bound` of the active slots (the formula the
  MoE layer prices its ragged programs with), within
  ``expert_batch_threshold``; the router-skew prior ``expert_skew`` is
  refined by :meth:`Scheduler.observe_expert_load` from the dispatcher's
  ``expert_load`` counters.  This gate only ever tightens the dense one.

``max_queue`` bounds the waiting queue (:class:`QueueFull` on overflow).
A request whose absolute ``deadline`` passes while still *queued* is
expired by :meth:`Scheduler.expire` and never admitted; running requests
are left to finish.  Preemption is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.kernels.backends.base import expert_batch_bound

POLICIES = ("fcfs", "sjf", "gemv_aware")


class QueueFull(RuntimeError):
    """Waiting-queue backpressure: the submission was not enqueued."""


@dataclass
class SchedulerConfig:
    policy: str = "fcfs"              # fcfs | sjf | gemv_aware
    max_queue: int = 0                # 0 = unbounded
    gemv_batch_threshold: int = 8     # gemv_aware: max concurrent decode slots
    # expert-aware batch shaping (gemv_aware on MoE models): with
    # moe_experts > 1 admission also keeps the predicted per-expert decode
    # batch within expert_batch_threshold (None: gemv_batch_threshold)
    moe_experts: int = 0
    moe_top_k: int = 1
    expert_batch_threshold: int | None = None
    expert_skew: float = 2.0          # router-imbalance prior

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
    # router-imbalance estimate from dispatch feedback (None: the config's
    # expert_skew prior); at least 1.0, the even split
    _observed_skew: float | None = None

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

    def observe_expert_load(self, expert_load: dict) -> None:
        """Refine the skew estimate from ``dispatch_stats()``'s
        ``expert_load`` section (the engine passes its delta since it
        started): the planned per-expert bound over the even split
        ``routed / (decisions * E)``."""
        cfg = self.config
        routed = int(expert_load.get("routed_tokens", 0) or 0)
        if cfg.moe_experts <= 1 or routed <= 0:
            return
        max_tokens = int(expert_load.get("max_tokens", 0) or 0)
        self._observed_skew = max(1.0, max_tokens * cfg.moe_experts / routed)

    def _admission_cap(self, free_slots: int, n_active: int) -> int:
        """gemv_aware: the dense batch gate, then (MoE) the per-expert
        gate, which only ever tightens it."""
        cfg = self.config
        cap = min(free_slots, max(0, cfg.gemv_batch_threshold - n_active))
        if cfg.moe_experts > 1:
            t_e = cfg.expert_batch_threshold or cfg.gemv_batch_threshold
            skew = (self._observed_skew if self._observed_skew is not None
                    else cfg.expert_skew)
            while cap > 0 and expert_batch_bound(
                    n_active + cap, cfg.moe_top_k, cfg.moe_experts,
                    skew=skew) > t_e:
                cap -= 1
        return cap

    def select(self, free_slots: int, n_active: int,
               now: float = 0.0) -> list:
        """Pop the requests to admit this step, in admission order."""
        cfg = self.config
        cap = free_slots
        if cfg.policy == "gemv_aware":
            cap = self._admission_cap(free_slots, n_active)
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
