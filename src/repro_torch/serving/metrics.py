"""Serving telemetry: latency histograms + GEMV dispatcher counters (the
numpy code of the JAX package's ``serving/metrics.py``, for the sections
this slice serves).

* ``ttft_ms`` -- submit-to-first-token (queueing + prefill);
* ``per_token_ms`` -- decode-step wall time, one sample per step (every
  active slot advances one token per step, so this IS the per-token decode
  latency distribution);
* ``step_ms`` -- every engine iteration, including admission-only ones;

plus throughput counters and a per-step snapshot of the dispatcher's
decision counters (:func:`repro_torch.kernels.dispatch.dispatch_stats`),
as deltas against the engine's start.  Everything exports as one JSON
document (:meth:`ServingMetrics.to_dict` / :meth:`to_json`).
"""

from __future__ import annotations

import json
import time

import numpy as np

# JSON-document version of the port's layout (the JAX package's v3 minus
# the prefix-cache and expert-load sections, which are not ported yet).
SCHEMA_VERSION = 1

# Per-step snapshots kept in memory; older entries are dropped (the
# aggregate histograms/counters keep full fidelity).
MAX_STEP_RECORDS = 4096


class Histogram:
    """Bounded-memory histogram: exact percentiles up to ``max_samples``,
    reservoir sampling (Algorithm R, fixed seed) past it; ``count``,
    ``mean`` and ``max`` stay exact either way."""

    DEFAULT_MAX_SAMPLES = 65536

    def __init__(self, name: str = "", max_samples: int | None = None):
        self.name = name
        self.max_samples = (self.DEFAULT_MAX_SAMPLES if max_samples is None
                            else int(max_samples))
        if self.max_samples <= 0:
            raise ValueError("max_samples must be positive")
        self.samples: list[float] = []
        self._n = 0
        self._sum = 0.0
        self._max = float("-inf")
        self._rng = np.random.default_rng(0)

    def record(self, value: float) -> None:
        v = float(value)
        self._n += 1
        self._sum += v
        if v > self._max:
            self._max = v
        if len(self.samples) < self.max_samples:
            self.samples.append(v)
        else:
            j = int(self._rng.integers(self._n))
            if j < self.max_samples:
                self.samples[j] = v

    @property
    def count(self) -> int:
        return self._n

    def summary(self) -> dict:
        if not self._n:
            return {"count": 0}
        a = np.asarray(self.samples)
        out = {
            "count": self._n,
            "mean": self._sum / self._n,
            "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)),
            "max": self._max,
        }
        if self._n > a.size:
            out["sampled"] = int(a.size)
        return out


def _dispatch_snapshot() -> dict:
    from repro_torch.kernels.dispatch import dispatch_stats

    return dispatch_stats()


def _diff_counters(cur, base):
    """Recursive int-diff of nested counter dicts (cur - base)."""
    if isinstance(cur, dict):
        base = base or {}
        return {k: _diff_counters(v, base.get(k)) for k, v in cur.items()}
    return cur - (base or 0)


class ServingMetrics:
    """Mutable per-engine telemetry; one instance per engine."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.start_time = clock()
        self.ttft_ms = Histogram("ttft_ms")
        self.per_token_ms = Histogram("per_token_ms")
        self.step_ms = Histogram("step_ms")
        self.batch_sizes = Histogram("decode_batch")
        self.counters = {
            "submitted": 0, "rejected": 0, "expired": 0, "finished": 0,
            "tokens_out": 0, "decode_tokens": 0, "prefill_tokens": 0,
            "prefill_waves": 0, "decode_steps": 0, "engine_steps": 0,
        }
        self.decode_s = 0.0
        self.steps: list[dict] = []
        # dispatch counters are process-global: report deltas
        self._dispatch_base = _dispatch_snapshot()

    # -- request lifecycle ---------------------------------------------------

    def request_submitted(self) -> None:
        self.counters["submitted"] += 1

    def request_rejected(self) -> None:
        self.counters["rejected"] += 1

    def requests_expired(self, n: int) -> None:
        self.counters["expired"] += n

    def first_token(self, req, now: float) -> None:
        if req.first_token_time is not None:
            return
        req.first_token_time = now
        self.ttft_ms.record((now - req.submit_time) * 1e3)

    def request_finished(self, req, now: float) -> None:
        req.finish_time = now
        self.counters["finished"] += 1

    def tokens_generated(self, n: int, *, decode: bool = False) -> None:
        self.counters["tokens_out"] += n
        if decode:
            self.counters["decode_tokens"] += n

    def prefill_wave(self, n_requests: int, n_tokens: int) -> None:
        self.counters["prefill_waves"] += 1
        self.counters["prefill_tokens"] += n_tokens

    # -- per-step snapshot ---------------------------------------------------

    def dispatch_delta(self) -> dict:
        return _diff_counters(_dispatch_snapshot(), self._dispatch_base)

    def record_step(self, now: float, *, step_s: float, decode_batch: int,
                    n_active: int, queue_depth: int,
                    decode_s: float = 0.0) -> None:
        self.counters["engine_steps"] += 1
        self.step_ms.record(step_s * 1e3)
        if decode_batch:
            self.counters["decode_steps"] += 1
            self.decode_s += decode_s
            self.per_token_ms.record(decode_s * 1e3)
            self.batch_sizes.record(decode_batch)
        self.steps.append({
            "t": now - self.start_time,
            "step_ms": step_s * 1e3,
            "decode_batch": decode_batch,
            "active": n_active,
            "queue": queue_depth,
            "dispatch": self.dispatch_delta(),
        })
        if len(self.steps) > MAX_STEP_RECORDS:
            del self.steps[:len(self.steps) - MAX_STEP_RECORDS]

    # -- export --------------------------------------------------------------

    def to_dict(self, *, include_steps: bool = True) -> dict:
        elapsed = max(self.clock() - self.start_time, 1e-9)
        doc = {
            "schema": SCHEMA_VERSION,
            "elapsed_s": elapsed,
            "ttft_ms": self.ttft_ms.summary(),
            "per_token_ms": self.per_token_ms.summary(),
            "step_ms": self.step_ms.summary(),
            "decode_batch": self.batch_sizes.summary(),
            "tokens_per_s": self.counters["tokens_out"] / elapsed,
            # decode tokens over the wall time of the decode steps alone
            "decode_tokens_per_s": (self.counters["decode_tokens"]
                                    / self.decode_s if self.decode_s
                                    else 0.0),
            "counters": dict(self.counters),
            "dispatch": self.dispatch_delta(),
        }
        if include_steps:
            doc["steps"] = list(self.steps)
        return doc

    def to_json(self, path: str | None = None, *,
                include_steps: bool = True) -> str:
        text = json.dumps(self.to_dict(include_steps=include_steps),
                          indent=1, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text
