"""Flight recorder: bounded ring buffers of typed spans and events (the
port of ``repro/observability/trace.py``).

One :class:`Tracer` per observed engine run.  Three design rules:

1. **Bounded.**  Every buffer is a ``deque(maxlen=...)`` ring; a run that
   outlives its budget drops the *oldest* entries and counts the drops
   (``tracer.dropped``): tracing never grows without bound and never
   throws at the recording site.
2. **Monotonic.**  All timestamps are µs on the tracer's own host clock
   (``time.monotonic`` by default; injectable for tests), zeroed at
   construction, so a trace is self-consistent even across engines with
   different wall-clock bases.
3. **Zero-cost when absent.**  Hot paths guard on
   ``current_tracer() is None``: a module-global read and an ``is`` check.
   The dispatch hook runs only on plan-cache *misses*, so the cached
   decode path (and every replayed decode graph, which runs no Python)
   never reaches it.

Request phase machine
---------------------
A request's lifetime is partitioned into phases -- ``queued`` ->
``prefill`` -> ``decode`` (-> ``preempted`` -> ``prefill`` -> ...) -- by
:meth:`Tracer.request_submit` / :meth:`Tracer.request_phase` /
:meth:`Tracer.request_finish`.  Each transition closes the previous phase
and opens the next **at the same timestamp**, so per-phase durations sum
to the request's end-to-end latency exactly, up to float rounding.

Dispatch attribution
--------------------
``kernels/dispatch.py`` records one :class:`DispatchRecord` per fresh
decision: backend, kernel or program mode, shape key, ``predicted_us``
from the backend's active cost model and its ``cost_model_source``; with
``Tracer.timing`` also the trial times of the decision's kernel on
synthesized inputs on the caller's device (on the card: CUDA events
around replays of a captured graph over weight copies read cold, the
clock the calibration fits against).  :meth:`Tracer.drift_report`
reduces those into ``pred_over_measured`` percentiles per kernel (the
calibration's median/MAD ``robust_us``) and flags kernels whose median
ratio leaves ``[STALE_LO, STALE_HI]``.  A record the hook could not time
carries an ``untimed`` attribute saying why (``"capturing"``: the decision
was met inside a CUDA-graph capture), and the report counts them.

Nothing here imports torch: a tracer is importable, and its absence
checkable, everywhere.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

# summary-document / trace-buffer layout version (export.py stamps it);
# the reference's number, so either package's documents load in the other
SCHEMA_VERSION = 1

# the request phase taxonomy: "preempted" re-enters "prefill" on
# readmission; every other transition is forward-only
PHASES = ("queued", "prefill", "decode", "preempted")

# a kernel whose median predicted/measured ratio leaves this band is
# flagged stale: the cost model is off by more than 2x either way
STALE_LO = 0.5
STALE_HI = 2.0


@dataclass(frozen=True)
class Span:
    """One closed interval on a track."""

    name: str
    cat: str          # "phase" | "request" | "engine" | "overlap"
    track: str        # "engine" | "requests" | "slot<N>"
    start_us: float
    dur_us: float
    rid: int | None = None
    attrs: dict = field(default_factory=dict)


@dataclass(frozen=True)
class Event:
    """One instant (point-in-time) record."""

    name: str
    cat: str
    ts_us: float
    attrs: dict = field(default_factory=dict)


@dataclass(frozen=True)
class CounterSample:
    """One gauge sample (queue depth, slot occupancy, decode batch)."""

    name: str
    ts_us: float
    value: float


@dataclass(frozen=True)
class DispatchRecord:
    """One fresh dispatch decision, priced and (optionally) timed."""

    backend: str
    kind: str                  # "single" | "fused" | "grouped" | "ragged"
    kernel: str                # kernel name (single) or program mode
    shape: str                 # GemvKey/ProgramKey.table_key()
    predicted_us: float
    source: str                # "seed" | "calibrated"
    trials_us: tuple[float, ...] | None = None
    attrs: dict = field(default_factory=dict)

    @property
    def measured_us(self) -> float | None:
        """Robust (median/MAD-rejected) trial time; None when untimed."""
        if not self.trials_us:
            return None
        from repro_torch.calibration.measure import robust_us

        return robust_us(self.trials_us)


def _percentile(sorted_vals: list[float], p: float) -> float:
    """Linear-interpolated percentile of an already-sorted list."""
    if not sorted_vals:
        return float("nan")
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    idx = (len(sorted_vals) - 1) * p / 100.0
    lo = int(idx)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = idx - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class Tracer:
    """Bounded flight recorder; one instance per observed run.

    Thread-safe: every mutation sits under one lock, and recording is O(1)
    appends.
    """

    def __init__(self, *, clock=time.monotonic, timing: bool = False,
                 max_spans: int = 65536, max_events: int = 16384,
                 max_counters: int = 65536, max_dispatches: int = 8192,
                 max_requests: int = 65536):
        self.clock = clock
        self.t0 = clock()
        # the dispatch hook also times each fresh decision's kernel on the
        # caller's device (serve bench --trace-timing)
        self.timing = bool(timing)
        self.spans: deque[Span] = deque(maxlen=max_spans)
        self.events: deque[Event] = deque(maxlen=max_events)
        self.counters: deque[CounterSample] = deque(maxlen=max_counters)
        self.dispatches: deque[DispatchRecord] = deque(maxlen=max_dispatches)
        self.requests: deque[dict] = deque(maxlen=max_requests)
        self.dropped = {"spans": 0, "events": 0, "counters": 0,
                        "dispatches": 0, "requests": 0}
        self._open: dict[int, dict] = {}   # rid -> in-flight request state
        self._lock = threading.Lock()

    # -- clock ---------------------------------------------------------------

    def now_us(self) -> float:
        return (self.clock() - self.t0) * 1e6

    # -- ring-buffer append (caller holds self._lock) ------------------------

    def _append(self, buf: deque, kind: str, item) -> None:
        if buf.maxlen is not None and len(buf) == buf.maxlen:
            self.dropped[kind] += 1
        buf.append(item)

    # -- generic recording ---------------------------------------------------

    def event(self, name: str, *, cat: str = "engine",
              ts_us: float | None = None, **attrs) -> None:
        t = self.now_us() if ts_us is None else ts_us
        with self._lock:
            self._append(self.events, "events", Event(name, cat, t, attrs))

    def counter(self, name: str, value: float,
                ts_us: float | None = None) -> None:
        t = self.now_us() if ts_us is None else ts_us
        with self._lock:
            self._append(self.counters, "counters",
                         CounterSample(name, t, float(value)))

    def add_span(self, name: str, start_us: float, end_us: float, *,
                 cat: str = "engine", track: str = "engine",
                 rid: int | None = None, **attrs) -> None:
        with self._lock:
            self._append(self.spans, "spans",
                         Span(name, cat, track, start_us,
                              end_us - start_us, rid, attrs))

    @contextmanager
    def span(self, name: str, *, cat: str = "engine",
             track: str = "engine", rid: int | None = None, **attrs):
        """Measure a with-block as one span.  Yields the (mutable) attrs
        dict so the body can attach results."""
        t0 = self.now_us()
        a = dict(attrs)
        try:
            yield a
        finally:
            t1 = self.now_us()
            with self._lock:
                self._append(self.spans, "spans",
                             Span(name, cat, track, t0, t1 - t0, rid, a))

    # -- request phase machine ----------------------------------------------

    def request_submit(self, rid: int, **attrs) -> None:
        """Open the request span; the request enters the ``queued`` phase."""
        t = self.now_us()
        with self._lock:
            self._open[rid] = {
                "rid": rid, "submit_us": t, "phase": "queued",
                "phase_start_us": t, "phases": {}, "slot": None,
                "preemptions": 0, "attrs": dict(attrs),
            }
            self._append(self.events, "events",
                         Event("submit", "request", t, {"rid": rid, **attrs}))

    def _close_phase(self, st: dict, t: float) -> None:
        """Close the current phase at ``t`` (caller holds the lock)."""
        dur = t - st["phase_start_us"]
        ph = st["phase"]
        st["phases"][ph] = st["phases"].get(ph, 0.0) + dur
        # prefill/decode happen on a slot; queued/preempted off-slot time
        # renders on the per-request track
        on_slot = st["slot"] is not None and ph in ("prefill", "decode")
        track = f"slot{st['slot']}" if on_slot else "requests"
        span_attrs = {"rid": st["rid"]}
        if st["slot"] is not None:
            span_attrs["slot"] = st["slot"]
        self._append(self.spans, "spans",
                     Span(ph, "phase", track, st["phase_start_us"], dur,
                          st["rid"], span_attrs))

    def request_phase(self, rid: int, phase: str, **attrs) -> None:
        """Move ``rid`` into ``phase``: closes the previous phase and opens
        the new one at the same instant.  Unknown rids are ignored (a
        tracer installed mid-run must not throw on requests it never saw
        submitted)."""
        t = self.now_us()
        with self._lock:
            st = self._open.get(rid)
            if st is None:
                return
            self._close_phase(st, t)
            st["phase"] = phase
            st["phase_start_us"] = t
            if phase == "preempted":
                st["preemptions"] += 1
                st["slot"] = None
            if "slot" in attrs:
                st["slot"] = attrs["slot"]
            st["attrs"].update(attrs)

    def request_annotate(self, rid: int, **attrs) -> None:
        """Attach attrs (e.g. the slot chosen at admission) to ``rid``'s
        in-flight state without a phase transition."""
        with self._lock:
            st = self._open.get(rid)
            if st is None:
                return
            if "slot" in attrs:
                st["slot"] = attrs["slot"]
            st["attrs"].update(attrs)

    def request_finish(self, rid: int, outcome: str = "finished",
                       **attrs) -> None:
        """Close ``rid``'s span tree; ``outcome`` is "finished" or
        "expired"."""
        t = self.now_us()
        with self._lock:
            st = self._open.pop(rid, None)
            if st is None:
                return
            self._close_phase(st, t)
            total = t - st["submit_us"]
            st["attrs"].update(attrs)
            self._append(self.requests, "requests", {
                "rid": rid, "outcome": outcome,
                "submit_us": st["submit_us"], "finish_us": t,
                "total_us": total, "phases": dict(st["phases"]),
                "preemptions": st["preemptions"],
                "attrs": dict(st["attrs"]),
            })
            self._append(self.spans, "spans",
                         Span(f"request {rid}", "request", "requests",
                              st["submit_us"], total, rid,
                              {"outcome": outcome,
                               "preemptions": st["preemptions"]}))

    @property
    def open_requests(self) -> tuple[int, ...]:
        with self._lock:
            return tuple(self._open)

    # -- dispatch attribution ------------------------------------------------

    def record_dispatch(self, *, backend: str, kind: str, kernel: str,
                        shape: str, predicted_us: float, source: str,
                        trials_us: tuple[float, ...] | None = None,
                        **attrs) -> None:
        with self._lock:
            self._append(self.dispatches, "dispatches",
                         DispatchRecord(backend=backend, kind=kind,
                                        kernel=kernel, shape=shape,
                                        predicted_us=float(predicted_us),
                                        source=source, trials_us=trials_us,
                                        attrs=attrs))

    def drift_report(self) -> dict:
        """Predicted-vs-measured attribution per ``backend:kernel``.

        ``pred_over_measured`` percentiles come from per-record
        ``predicted_us / robust_us(trials)`` ratios; a kernel is ``stale``
        when its median ratio leaves ``[STALE_LO, STALE_HI]``.  Records
        without trials still contribute their predicted price and count.
        Two sections the reference lacks, present only when some record
        carries the attribute: ``untimed`` counts the records the hook
        could not time, by reason, and ``timing_s`` sums the host seconds
        the hook spent timing.
        """
        with self._lock:
            records = list(self.dispatches)
        groups: dict[str, dict] = {}
        untimed: dict[str, int] = {}
        timing_s = [r.attrs["timing_s"] for r in records
                    if "timing_s" in r.attrs]
        for r in records:
            g = groups.setdefault(f"{r.backend}:{r.kernel}", {
                "n": 0, "kind": r.kind, "predicted": [], "pairs": [],
                "sources": set()})
            g["n"] += 1
            g["predicted"].append(r.predicted_us)
            g["sources"].add(r.source)
            m = r.measured_us
            if m is not None and m > 0:
                g["pairs"].append((r.predicted_us, m))
            why = r.attrs.get("untimed")
            if why is not None:
                untimed[why] = untimed.get(why, 0) + 1
        kernels: dict[str, dict] = {}
        stale: list[str] = []
        n_timed = 0
        for name in sorted(groups):
            g = groups[name]
            entry = {
                "n": g["n"],
                "kind": g["kind"],
                "cost_model_source": sorted(g["sources"]),
                "predicted_us_p50": _percentile(sorted(g["predicted"]), 50),
            }
            if g["pairs"]:
                n_timed += len(g["pairs"])
                meas = sorted(m for _, m in g["pairs"])
                ratios = sorted(p / m for p, m in g["pairs"])
                entry["measured_us_p50"] = _percentile(meas, 50)
                entry["pred_over_measured"] = {
                    "p50": _percentile(ratios, 50),
                    "p90": _percentile(ratios, 90),
                }
                entry["stale"] = not (
                    STALE_LO <= entry["pred_over_measured"]["p50"]
                    <= STALE_HI)
                if entry["stale"]:
                    stale.append(name)
            kernels[name] = entry
        doc = {"n_dispatches": len(records), "n_timed": n_timed,
               "kernels": kernels, "stale_kernels": stale}
        if untimed:
            doc["untimed"] = untimed
        if timing_s:
            doc["timing_s"] = sum(timing_s)
        return doc


# ---------------------------------------------------------------------------
# The install slot: the dispatch hook's zero-cost discovery point
# ---------------------------------------------------------------------------

_INSTALL_LOCK = threading.Lock()
_INSTALLED: Tracer | None = None


def install_tracer(tracer: Tracer | None) -> Tracer | None:
    """Make ``tracer`` the process-wide tracer; returns the previous one.
    ``Engine(tracer=...)`` calls this so the dispatch hook, a layer the
    engine does not call directly, finds the recorder."""
    global _INSTALLED
    with _INSTALL_LOCK:
        prev, _INSTALLED = _INSTALLED, tracer
        return prev


def uninstall_tracer(tracer: Tracer | None = None) -> Tracer | None:
    """Clear the slot (only if it still holds ``tracer``, when given)."""
    global _INSTALLED
    with _INSTALL_LOCK:
        if tracer is None or _INSTALLED is tracer:
            prev, _INSTALLED = _INSTALLED, None
            return prev
        return None


def current_tracer() -> Tracer | None:
    """The installed tracer, or None: a plain module-global read, no lock
    (the hot-path guard)."""
    return _INSTALLED
