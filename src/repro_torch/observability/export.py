"""Trace export: Chrome trace-event JSON (Perfetto) and the schema-1
summary (the port of ``repro/observability/export.py``; a document written
here loads wherever the reference's does).

* :func:`chrome_trace` -- the Chrome trace-event format Perfetto loads
  (https://ui.perfetto.dev, "Open trace file"): one process; the
  engine's own spans (prefill waves, chunks, decode steps) on the
  ``engine`` thread track; one thread track per KV slot carrying that
  slot's prefill/decode residency; per-request async spans (``b``/``e``
  pairs keyed by request id, each request one bar with its phases
  nested inside); and counter tracks for the per-step gauges.
* :func:`summary` -- a schema-versioned JSON document for machines:
  every finished request's phase breakdown (ms), the dispatch drift
  report, gauge summaries, ring-buffer drop counts and, when overlap
  spans were recorded, the ``overlap`` section.

Timestamps are the tracer's µs host clock, the unit the trace-event
format wants.
"""

from __future__ import annotations

import json

from repro_torch.observability.trace import SCHEMA_VERSION, Tracer

_PID = 1
_ENGINE_TID = 0
_REQUESTS_TID = 1
_SLOT_TID_BASE = 10


def _track_tid(track: str) -> int:
    if track == "engine":
        return _ENGINE_TID
    if track == "requests":
        return _REQUESTS_TID
    if track.startswith("slot"):
        return _SLOT_TID_BASE + int(track[4:])
    return _REQUESTS_TID


def chrome_trace(tracer: Tracer) -> dict:
    """Render the tracer's buffers as a Chrome trace-event document."""
    events: list[dict] = [
        {"ph": "M", "pid": _PID, "name": "process_name",
         "args": {"name": "repro serving engine"}},
        {"ph": "M", "pid": _PID, "tid": _ENGINE_TID, "name": "thread_name",
         "args": {"name": "engine"}},
        {"ph": "M", "pid": _PID, "tid": _REQUESTS_TID, "name": "thread_name",
         "args": {"name": "requests"}},
    ]
    named_slots: set[int] = set()
    with tracer._lock:
        spans = list(tracer.spans)
        points = list(tracer.events)
        counters = list(tracer.counters)
    for s in spans:
        tid = _track_tid(s.track)
        if s.track.startswith("slot") and tid not in named_slots:
            named_slots.add(tid)
            events.append({"ph": "M", "pid": _PID, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": s.track}})
        if s.cat in ("request", "phase") and s.rid is not None:
            # async pair keyed by rid: phases nest inside the request bar
            common = {"cat": "request", "id": s.rid, "pid": _PID,
                      "tid": _REQUESTS_TID, "name": s.name}
            events.append({**common, "ph": "b", "ts": s.start_us,
                           "args": dict(s.attrs)})
            events.append({**common, "ph": "e",
                           "ts": s.start_us + s.dur_us})
            if not s.track.startswith("slot"):
                continue
            # on-slot phases also render as residency on the slot's own
            # track (the complete event below)
        events.append({"ph": "X", "cat": s.cat, "name": s.name,
                       "pid": _PID, "tid": tid, "ts": s.start_us,
                       "dur": max(s.dur_us, 0.0),
                       "args": {**s.attrs,
                                **({"rid": s.rid}
                                   if s.rid is not None else {})}})
    for e in points:
        events.append({"ph": "i", "s": "p", "cat": e.cat, "name": e.name,
                       "pid": _PID, "tid": _ENGINE_TID, "ts": e.ts_us,
                       "args": dict(e.attrs)})
    for c in counters:
        events.append({"ph": "C", "pid": _PID, "name": c.name,
                       "ts": c.ts_us, "args": {c.name: c.value}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": SCHEMA_VERSION}}


def _overlap_section(spans) -> dict | None:
    """Reduce ``cat="overlap"`` spans into the hidden-fraction report.

    Each overlap span covers one issue->await window; its ``blocked_us``
    attr is the host time spent waiting inside it, so
    ``hidden_fraction = sum(dur - blocked) / sum(dur)``.  None when no
    overlap span was recorded.
    """
    ov = [s for s in spans if s.cat == "overlap"]
    if not ov:
        return None
    by_name: dict[str, dict] = {}
    for s in ov:
        g = by_name.setdefault(s.name, {"n": 0, "total_us": 0.0,
                                        "blocked_us": 0.0})
        g["n"] += 1
        g["total_us"] += max(s.dur_us, 0.0)
        g["blocked_us"] += min(max(float(s.attrs.get("blocked_us", 0.0)),
                                   0.0), max(s.dur_us, 0.0))
    total = sum(g["total_us"] for g in by_name.values())
    blocked = sum(g["blocked_us"] for g in by_name.values())
    for g in by_name.values():
        g["hidden_fraction"] = ((g["total_us"] - g["blocked_us"])
                                / g["total_us"] if g["total_us"] > 0
                                else 0.0)
    return {
        "n_spans": len(ov),
        "total_us": total,
        "blocked_us": blocked,
        "hidden_us": total - blocked,
        "hidden_fraction": (total - blocked) / total if total > 0 else 0.0,
        "by_name": by_name,
    }


def summary(tracer: Tracer, extra: dict | None = None) -> dict:
    """The schema-1 machine-readable run summary."""
    with tracer._lock:
        requests = [dict(r) for r in tracer.requests]
        counters = list(tracer.counters)
        spans = list(tracer.spans)
        n_spans = len(tracer.spans)
        n_events = len(tracer.events)
        dropped = dict(tracer.dropped)
    reqs = []
    for r in requests:
        phases_ms = {k: v / 1e3 for k, v in r["phases"].items()}
        reqs.append({
            "rid": r["rid"], "outcome": r["outcome"],
            "submit_ms": r["submit_us"] / 1e3,
            "total_ms": r["total_us"] / 1e3,
            "phases_ms": phases_ms,
            "preemptions": r["preemptions"],
            "attrs": r["attrs"],
        })
    gauge: dict[str, dict] = {}
    for c in counters:
        g = gauge.setdefault(c.name, {"n": 0, "last": 0.0, "max": 0.0})
        g["n"] += 1
        g["last"] = c.value
        g["max"] = max(g["max"], c.value)
    doc = {
        "schema": SCHEMA_VERSION,
        "requests": reqs,
        "open_requests": list(tracer.open_requests),
        "drift": tracer.drift_report(),
        "gauges": gauge,
        "n_spans": n_spans,
        "n_events": n_events,
        "dropped": dropped,
    }
    overlap = _overlap_section(spans)
    if overlap is not None:
        doc["overlap"] = overlap
    if extra:
        doc.update(extra)
    return doc


def summary_path(trace_path: str) -> str:
    """``TRACE.json`` -> ``TRACE.summary.json`` (the side file the serve
    bench's ``--trace-out`` writes next to the Perfetto trace)."""
    if trace_path.endswith(".json"):
        return trace_path[: -len(".json")] + ".summary.json"
    return trace_path + ".summary.json"


def write_chrome_trace(tracer: Tracer, path: str) -> dict:
    doc = chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def write_summary(tracer: Tracer, path: str,
                  extra: dict | None = None) -> dict:
    doc = summary(tracer, extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return doc
