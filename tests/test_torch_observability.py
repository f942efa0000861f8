"""The port's observability (``repro_torch.observability``) held against the
JAX package's on the CPU.

* The tracer and its export: the same scripted calls, under one
  ``FakeClock`` each, go to the reference's ``Tracer`` and the port's;
  the Chrome trace, the summary and the drift report must be equal as
  JSON, and small ring buffers must drop and count alike.
* ``warn_once``: per key, per call site, prefix reset and the mirror into
  an installed tracer, the reference's behaviour call for call.
* The engine: reduced olmo-1b, the same params (the JAX init through
  ``params_from_numpy``), the same prompts and a ``FakeClock`` each; the
  port's traced ``Engine`` must record the JAX ``Engine(tracer=)``'s
  spans, events, gauges and request records exactly (timestamps
  included: both read the fake clock at the same points) over a wave,
  chunked prefill, a prefix hit, a deadline preemption with its
  readmission, and compaction; greedy tokens equal with and without the
  tracer.
* The dispatch hook: nothing without a tracer, one record per fresh
  decision (as ``dispatch_stats()`` counts them), trial times with
  ``timing``, the re-entrancy guard, decisions met inside a capture (the
  graph stand-in of ``test_torch_graphs``) left untimed and marked, and a
  failure while timing raised, not hidden.
* ``record_overlap``'s ``inflight == issued - awaited`` under threads, and
  ``run_serve_trace(trace_out=)``'s files and ``flight_trace`` section.
"""

import json
import sys
import threading
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from test_torch_graphs import Recorder, _graphed  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.observability import export as jexport  # noqa: E402
from repro.observability import log as jlog  # noqa: E402
from repro.observability import trace as jtrace  # noqa: E402
from repro.serving import bench as jbench  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.scheduler import \
    SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.backends import DispatchPolicy  # noqa: E402
from repro_torch.kernels.backends.base import get_backend  # noqa: E402
from repro_torch.observability import export  # noqa: E402
from repro_torch.observability import log as tlog  # noqa: E402
from repro_torch.observability import trace as ttrace  # noqa: E402
from repro_torch.serving import bench  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

MAX_LEN = 64
TICK = 0.001          # fake seconds a step


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def _clean_slots():
    """No test leaks an installed tracer (either package's) or a plan."""
    ttrace.uninstall_tracer()
    jtrace.uninstall_tracer()
    dispatch.clear_plan_cache()
    yield
    ttrace.uninstall_tracer()
    jtrace.uninstall_tracer()
    dispatch.clear_plan_cache()


def _json(doc) -> str:
    return json.dumps(doc, sort_keys=True)


# --------------------------------------------------------------------------
# Tracer and export against the reference
# --------------------------------------------------------------------------


def _script(mod, **kw):
    """The same calls on ``mod.Tracer``: submits, phases, a preemption and
    its re-entry, unknown rids, spans (direct, as a block, an overlap
    window), counters, events, an expiry, an open request, and dispatch
    records with and without trials (one with an outlier trial)."""
    clk = FakeClock()
    tr = mod.Tracer(clock=clk, **kw)
    tr.request_submit(0, prompt_len=7)
    clk.advance(0.010)
    tr.request_submit(1, prompt_len=5)
    tr.request_phase(0, "prefill", slot=2, admit_seq=0)
    clk.advance(0.005)
    tr.add_span("prefill_wave", tr.now_us() - 5e3, tr.now_us(),
                requests=1, tokens=7)
    tr.request_phase(0, "decode", slot=2)
    tr.request_phase(1, "prefill", slot=0, admit_seq=1)
    clk.advance(0.002)
    tr.request_phase(1, "decode", slot=0)
    clk.advance(0.002)
    tr.request_phase(1, "preempted", evicted_from=0, evictions=1)
    tr.event("requeue", cat="scheduler", rid=1, evictions=1)
    clk.advance(0.003)
    tr.request_phase(1, "prefill", slot=3, admit_seq=2)
    t0 = tr.now_us()
    with tr.span("decode_step", bucket=4, active=3) as attrs:
        clk.advance(0.001)
        attrs["finished"] = 1
    tr.counter("queue_depth", 1)
    tr.counter("active_slots", 2)
    tr.counter("decode_batch", 4)
    tr.event("defrag_move", src=3, dst=1, rid=1)
    tr.request_annotate(1, slot=1)
    tr.add_span("prefill_chunk", t0, tr.now_us(), track="slot1", rid=1,
                slot=1, tokens=8, consumed=8)
    tr.add_span("async_prefill", t0, tr.now_us() + 500.0, cat="overlap",
                track="slot1", rid=1, slot=1, blocked_us=200.0, chunks=2)
    # unknown rids are ignored
    tr.request_phase(99, "decode")
    tr.request_annotate(99, slot=1)
    tr.request_finish(99)
    tr.request_phase(1, "decode", slot=1)
    clk.advance(0.004)
    tr.request_finish(0, tokens=4, evictions=0)
    tr.request_finish(1, outcome="finished", tokens=6, evictions=1)
    tr.request_submit(2)
    clk.advance(0.001)
    tr.request_finish(2, outcome="expired")
    tr.request_submit(3)               # still open at the end
    tr.event("reject", cat="request", rid=4, reason="queue_full")
    for p in (100.0, 110.0, 90.0):
        tr.record_dispatch(backend="h100", kind="single", kernel="pim",
                           shape="50304x2048xb8_w16g32_bfloat16",
                           predicted_us=p, source="calibrated",
                           trials_us=(p, p, p), batch=8)
    tr.record_dispatch(backend="h100", kind="single", kernel="splitk",
                       shape="2048x8192xb8_w16g32_bfloat16",
                       predicted_us=500.0, source="seed",
                       trials_us=(50.0, 51.0, 49.0, 5000.0), batch=8)
    tr.record_dispatch(backend="h100", kind="fused", kernel="fused",
                       shape="fused[2048+2048]x2048xb1", predicted_us=7.0,
                       source="seed", batch=1)
    return tr


def test_tracer_and_export_equal_the_reference_under_scripted_calls():
    mine, ref = _script(ttrace), _script(jtrace)
    assert _json(export.chrome_trace(mine)) == \
        _json(jexport.chrome_trace(ref))
    extra = {"arch": "olmo-1b", "policy": "sjf"}
    assert _json(export.summary(mine, extra)) == \
        _json(jexport.summary(ref, extra))
    assert _json(mine.drift_report()) == _json(ref.drift_report())
    # the script reaches every section: overlap, staleness, an open request
    doc = export.summary(mine)
    assert doc["overlap"]["n_spans"] == 1
    assert doc["drift"]["stale_kernels"] == ["h100:splitk"]
    assert doc["open_requests"] == [3]
    assert [r.measured_us for r in mine.dispatches] == \
        [r.measured_us for r in ref.dispatches]
    assert export.SCHEMA_VERSION == jtrace.SCHEMA_VERSION == 1
    assert ttrace.PHASES == jtrace.PHASES
    assert (ttrace.STALE_LO, ttrace.STALE_HI) == (jtrace.STALE_LO,
                                                  jtrace.STALE_HI)
    for p in ("/x/TRACE.json", "/x/t"):
        assert export.summary_path(p) == jexport.summary_path(p)


def test_ring_buffers_drop_and_count_as_the_reference():
    small = dict(max_spans=3, max_events=2, max_counters=2,
                 max_dispatches=2, max_requests=1)
    mine, ref = _script(ttrace, **small), _script(jtrace, **small)
    assert mine.dropped == ref.dropped
    assert all(v > 0 for v in mine.dropped.values()), mine.dropped
    assert _json(export.chrome_trace(mine)) == \
        _json(jexport.chrome_trace(ref))
    assert _json(export.summary(mine)) == _json(jexport.summary(ref))


def test_files_written_load_as_the_references_do(tmp_path):
    mine, ref = _script(ttrace), _script(jtrace)
    paths = {}
    for tag, ex, tr in (("port", export, mine), ("ref", jexport, ref)):
        p = str(tmp_path / f"{tag}.json")
        ex.write_chrome_trace(tr, p)
        ex.write_summary(tr, ex.summary_path(p), extra={"tag": "x"})
        paths[tag] = p
    for suffix in ("", ".summary"):
        a, b = (json.loads(open(paths[t].replace(".json", suffix + ".json"))
                           .read()) for t in ("port", "ref"))
        assert a == b


def test_untimed_and_hook_seconds_are_counted_only_when_present():
    tr = ttrace.Tracer()
    tr.record_dispatch(backend="h100", kind="single", kernel="pim",
                       shape="s", predicted_us=5.0, source="seed",
                       untimed="capturing")
    tr.record_dispatch(backend="h100", kind="single", kernel="pim",
                       shape="s", predicted_us=5.0, source="seed",
                       trials_us=(4.0, 5.0, 6.0), timing_s=0.25)
    rep = tr.drift_report()
    assert rep["untimed"] == {"capturing": 1}
    assert rep["timing_s"] == 0.25
    assert rep["n_timed"] == 1 and rep["kernels"]["h100:pim"]["n"] == 2


# --------------------------------------------------------------------------
# warn_once
# --------------------------------------------------------------------------


def _warn_sequence(log_mod, trace_mod, tag: str) -> list:
    """Per key, prefix reset and the tracer mirror; returns what warned."""
    out = []
    log_mod.reset_warn_once(f"{tag}:")
    tr = trace_mod.Tracer()
    trace_mod.install_tracer(tr)
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out.append(log_mod.warn_once(f"{tag}:a", "first a"))
            out.append(log_mod.warn_once(f"{tag}:a", "again a"))
            out.append(log_mod.warn_once(f"{tag}:b", "first b",
                                         category=DeprecationWarning))
            log_mod.reset_warn_once(f"{tag}:a")
            out.append(log_mod.warn_once(f"{tag}:a", "a again"))
            out.append(log_mod.warn_once(f"{tag}:b", "b again"))
        out.append([(str(w.message), w.category.__name__) for w in rec])
    finally:
        trace_mod.uninstall_tracer(tr)
        log_mod.reset_warn_once(f"{tag}:")
    out.append([(e.name, e.cat, e.attrs["key"].split(":")[1],
                 e.attrs["category"], e.attrs["message"])
                for e in tr.events])
    return out


def test_warn_once_per_key_prefix_reset_and_mirror_as_the_reference():
    mine = _warn_sequence(tlog, ttrace, "t27p")
    ref = _warn_sequence(jlog, jtrace, "t27r")
    assert mine == ref
    assert mine[:5] == [True, False, True, True, False]
    assert [m for m, _ in mine[5]] == ["first a", "first b", "a again"]
    assert len(mine[6]) == 3 and mine[6][0][:2] == ("warn_once", "log")


def test_warn_once_per_site_memoizes_on_the_call_site():
    tlog.reset_warn_once("t27site")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(3):                   # one site, looped: one warning
            tlog.warn_once("t27site", "looped", per_site=True)
        tlog.warn_once("t27site", "other site", per_site=True)
    tlog.reset_warn_once("t27site")
    assert [str(w.message) for w in rec] == ["looped", "other site"]
    # the warning points at the caller (depth 1), as the reference's does
    assert rec[0].filename == __file__


def test_dispatch_warns_invalid_calibration_once_through_warn_once():
    dispatch.clear_autotune_table()
    tr = ttrace.Tracer()
    try:
        dispatch.autotune_table().put_calibration(
            "cpu", {"schema": 1, "constants": {"bogus_term": 1.0}})
        ttrace.install_tracer(tr)
        x = torch.ones((1, 256))
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            dispatch.dispatch_gemv(x, torch.ones((512, 256)))
            dispatch.clear_plan_cache()
            dispatch.dispatch_gemv(x, torch.ones((384, 256)))
        assert sum("invalid calibration" in str(w.message)
                   for w in rec) == 1
        assert [e.attrs["key"] for e in tr.events
                if e.name == "warn_once"] == ["calibration:cpu"]
        # clearing the table re-arms the key
        dispatch.clear_autotune_table()
        dispatch.autotune_table().put_calibration(
            "cpu", {"schema": 1, "constants": {"bogus_term": 1.0}})
        dispatch.clear_plan_cache()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            dispatch.dispatch_gemv(x, torch.ones((512, 256)))
        assert sum("invalid calibration" in str(w.message)
                   for w in rec) == 1
    finally:
        dispatch.clear_autotune_table()


# --------------------------------------------------------------------------
# The traced engine against the JAX Engine(tracer=)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def olmo():
    jcfg = ARCHS["olmo-1b"].reduced()
    tcfg = get_config("olmo-1b").reduced()
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, jparams, tcfg, tparams


def _shared(vocab, prefix_len, tails, seed):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len)
    return [np.concatenate([prefix, rng.integers(0, vocab, n)]).astype(
        np.int32) for n in tails]


def _random(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _scenario(name, vocab):
    """(plan [(step, rid, prompt, new tokens, deadline_in)], engine kw,
    scheduler config kw or None)."""
    if name == "wave":
        ps = _random(vocab, [5, 9, 3, 12], 1)
        return [(0, i, p, 4, None) for i, p in enumerate(ps)], {}, None
    if name == "chunk8":
        ps = _random(vocab, [30, 5, 25, 3], 2)
        return ([(0, i, p, 4, None) for i, p in enumerate(ps)],
                {"prefill_chunk": 8}, None)
    if name == "prefix_hit":
        ps = _shared(vocab, 16, [3, 5, 4], 3)
        return ([(0, 0, ps[0], 3, None), (3, 1, ps[1], 3, None),
                 (3, 2, ps[2], 4, None)], {"prefix_cache": True}, None)
    if name == "preempt":
        ps = _random(vocab, [5, 6, 4], 12)
        return ([(0, 0, ps[0], 10, None), (0, 1, ps[1], 10, None),
                 (2, 2, ps[2], 3, 3.0)],
                {"batch_slots": 2, "prefix_cache": True},
                dict(policy="gemv_aware", gemv_batch_threshold=4,
                     preempt_margin=5.0))
    if name == "compaction":
        ps = _random(vocab, [7, 4, 9, 5], 4)
        return ([(0, i, p, n, None)
                 for i, (p, n) in enumerate(zip(ps, [2, 3, 5, 8]))], {},
                None)
    raise KeyError(name)


SCENARIOS = ("wave", "chunk8", "prefix_hit", "preempt", "compaction")


def _drive(eng, make_req, plan, clk):
    reqs, pending, step = {}, list(plan), 0
    while (pending or eng.active or eng._prefilling
           or eng.scheduler.queue):
        for item in [p for p in pending if p[0] <= step]:
            _, rid, prompt, n, dl = item
            reqs[rid] = make_req(rid=rid, prompt=prompt, max_new_tokens=n,
                                 deadline=None if dl is None else clk() + dl)
            eng.submit(reqs[rid])
            pending.remove(item)
        eng.step()
        clk.advance(TICK)
        step += 1
        assert step < 300
    return {rid: list(r.generated) for rid, r in reqs.items()}


def _port_run(olmo, name, *, traced: bool, timing: bool = False,
              graph_recorder=None):
    _, _, tcfg, tparams = olmo
    plan, kw, sched = _scenario(name, tcfg.vocab)
    clk = FakeClock()
    tr = ttrace.Tracer(clock=clk, timing=timing) if traced else None
    kw = {"batch_slots": 4, **kw}
    eng = Engine(tcfg, tparams, max_len=MAX_LEN, device="cpu", clock=clk,
                 scheduler=(SchedulerConfig(**sched) if sched else "fcfs"),
                 tracer=tr, **kw)
    if graph_recorder is not None:
        graph_recorder(eng)
    try:
        tokens = _drive(eng, Request, plan, clk)
    finally:
        if tr is not None:
            ttrace.uninstall_tracer(tr)
    return tokens, tr


def _jax_run(olmo, name):
    jcfg, jparams, _, _ = olmo
    plan, kw, sched = _scenario(name, jcfg.vocab)
    clk = FakeClock()
    tr = jtrace.Tracer(clock=clk)
    kw = {"batch_slots": 4, **kw}
    eng = JaxEngine(jcfg, jparams, max_len=MAX_LEN, clock=clk,
                    scheduler=(JSchedulerConfig(**sched) if sched
                               else "fcfs"), tracer=tr, **kw)
    try:
        tokens = _drive(eng, JaxRequest, plan, clk)
    finally:
        jtrace.uninstall_tracer(tr)
    return tokens, tr


def _plain(v):
    """numpy scalars as Python numbers (the JAX engine's attrs hold some)."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v.item() if isinstance(v, np.generic) else v


def _recording(tr) -> dict:
    return {
        "spans": [(s.name, s.cat, s.track, s.rid, s.start_us, s.dur_us,
                   _plain(s.attrs)) for s in tr.spans],
        "events": [(e.name, e.cat, e.ts_us, _plain(e.attrs))
                   for e in tr.events],
        "counters": [(c.name, c.ts_us, c.value) for c in tr.counters],
        "requests": [_plain(r) for r in tr.requests],
        "phases": {rid: [s.name for s in tr.spans
                         if s.cat == "phase" and s.rid == rid]
                   for rid in sorted({s.rid for s in tr.spans
                                      if s.rid is not None})},
        "open": tr.open_requests, "dropped": tr.dropped,
    }


@pytest.mark.parametrize("name", SCENARIOS)
def test_traced_engine_records_what_the_jax_engine_records(olmo, name):
    jtokens, jtr = _jax_run(olmo, name)
    tokens, tr = _port_run(olmo, name, traced=True)
    plain_tokens, _ = _port_run(olmo, name, traced=False)
    assert tokens == plain_tokens == jtokens
    mine, ref = _recording(tr), _recording(jtr)
    for key in ("spans", "events", "counters", "requests", "phases",
                "open", "dropped"):
        assert mine[key] == ref[key], key
    # every request finished with a complete tree that partitions its time
    assert mine["open"] == () and len(mine["requests"]) == len(tokens)
    for r in mine["requests"]:
        assert {"queued", "prefill", "decode"} <= set(r["phases"])
        assert sum(r["phases"].values()) == pytest.approx(r["total_us"],
                                                          rel=1e-9)
    names = {s[0] for s in mine["spans"]}
    events = {e[0] for e in mine["events"]}
    want = {"wave": {"prefill_wave", "decode_step"},
            "chunk8": {"prefill_chunk", "prefill_wave"},
            "prefix_hit": {"prefix_match", "prefill_chunk"},
            "preempt": {"prefix_match", "preempted"},
            "compaction": {"decode_step"}}[name]
    assert want <= names
    if name == "preempt":
        assert "requeue" in events
        victim = [r for r in mine["requests"] if r["preemptions"]]
        assert len(victim) == 1 and victim[0]["phases"]["preempted"] > 0
        assert mine["phases"][victim[0]["rid"]].count("prefill") == 2
    if name == "compaction":
        assert "defrag_move" in events
    if name == "prefix_hit":
        assert any(s[0] == "prefix_match" and s[6]["hit"]
                   for s in mine["spans"])


def test_timing_tracer_leaves_tokens_unchanged(olmo):
    tokens, tr = _port_run(olmo, "chunk8", traced=True, timing=True)
    plain, _ = _port_run(olmo, "chunk8", traced=False)
    assert tokens == plain
    rep = tr.drift_report()
    assert rep["n_dispatches"] == rep["n_timed"] > 0
    assert rep["timing_s"] > 0 and "untimed" not in rep


# --------------------------------------------------------------------------
# The dispatch hook
# --------------------------------------------------------------------------


def _gemv(M, K, B=1, seed=3):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32))
    return dispatch.dispatch_gemv(x, w)


def test_dispatch_hook_is_a_no_op_without_a_tracer(monkeypatch):
    calls = []
    monkeypatch.setattr(dispatch, "_trace_gemv_decision",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(dispatch, "_trace_program_decision",
                        lambda *a, **k: calls.append(a))
    assert ttrace.current_tracer() is None
    _gemv(512, 256)
    x = torch.ones((1, 256))
    dispatch.dispatch_prepacked(x, torch.ones((256, 768)), (512, 256))
    assert dispatch.dispatch_stats()["plan_cache"]["misses"] >= 1
    assert calls == []


def test_dispatch_hook_records_one_record_per_fresh_decision():
    tr = ttrace.Tracer(timing=False)
    ttrace.install_tracer(tr)
    try:
        for M, K, B in ((512, 256, 1), (512, 256, 1), (384, 256, 2),
                        (512, 256, 4)):
            _gemv(M, K, B)                       # the repeat is a cache hit
        x = torch.ones((2, 256))
        for fuse in (True, False):
            pol = DispatchPolicy(fuse_programs=fuse)
            dispatch.dispatch_prepacked(x, torch.ones((256, 768)),
                                        (512, 256), policy=pol)
    finally:
        ttrace.uninstall_tracer(tr)
    stats = dispatch.dispatch_stats()
    singles = Counter(f"{r.backend}:{r.kernel}" for r in tr.dispatches
                      if r.kind == "single")
    programs = Counter(f"{r.backend}:{r.kernel}" for r in tr.dispatches
                       if r.kind != "single")
    assert dict(singles) == stats["kernel_picks"]
    assert dict(programs) == stats["program_modes"]
    assert len(tr.dispatches) == (stats["plan_cache"]["misses"]
                                  + stats["plan_cache"]["program_misses"])
    assert sum(stats["cost_model_source"].values()) == len(tr.dispatches)
    cpu = get_backend("cpu")
    for r in tr.dispatches:
        assert r.trials_us is None and r.attrs.get("untimed") is None
        assert r.source == "seed" and r.predicted_us > 0
        if r.kind == "single":
            assert r.attrs["gate"] == "gemv_path"
    first = tr.dispatches[0]
    assert first.shape == "512x256xb1_w16g32_float32"
    assert first.predicted_us == cpu.estimate_cost_us(
        first.kernel, 512, 256, 1, x_bytes=4)
    rep = tr.drift_report()
    assert rep["n_dispatches"] == len(tr.dispatches) and rep["n_timed"] == 0


def test_dispatch_hook_timing_yields_drift_pairs():
    tr = ttrace.Tracer(timing=True)
    ttrace.install_tracer(tr)
    try:
        _gemv(512, 256)
        dispatch.dispatch_prepacked(torch.ones((1, 256)),
                                    torch.ones((256, 768)), (512, 256))
    finally:
        ttrace.uninstall_tracer(tr)
    assert len(tr.dispatches) >= 2
    for r in tr.dispatches:
        assert len(r.trials_us) == 3 and r.measured_us > 0
        assert r.attrs["timing_s"] > 0
    rep = tr.drift_report()
    assert rep["n_timed"] == len(tr.dispatches)
    for entry in rep["kernels"].values():
        assert entry["measured_us_p50"] > 0
        assert "pred_over_measured" in entry and "stale" in entry
    assert rep["timing_s"] == pytest.approx(
        sum(r.attrs["timing_s"] for r in tr.dispatches))


def test_dispatch_hook_reentrancy_guard(monkeypatch):
    """A fresh decision met while another decision's kernel is timed is
    recorded predicted-only and marked, and is not timed in its turn."""
    real = dispatch.time_trials_us
    nested = []

    def timing_with_a_nested_decision(run, *a, **k):
        if not nested:
            nested.append(True)
            _gemv(320, 256, seed=5)          # a fresh shape, mid-timing
        return real(run, *a, **k)

    monkeypatch.setattr(dispatch, "time_trials_us",
                        timing_with_a_nested_decision)
    tr = ttrace.Tracer(timing=True)
    ttrace.install_tracer(tr)
    try:
        _gemv(512, 256)
    finally:
        ttrace.uninstall_tracer(tr)
    inner, outer = tr.dispatches
    assert inner.shape.startswith("320x256") and inner.trials_us is None
    assert inner.attrs["untimed"] == "nested"
    assert outer.shape.startswith("512x256") and len(outer.trials_us) == 3
    assert not getattr(dispatch._TIMING_TLS, "active", False)
    assert tr.drift_report()["untimed"] == {"nested": 1}


def test_a_failure_while_timing_raises(monkeypatch):
    """No hidden fallback: the reference leaves such a record untimed; the
    port raises out of the dispatch."""
    cpu = get_backend("cpu")
    real = cpu.execute

    def broken(kernel, x, pw, plan):
        if not getattr(dispatch._TIMING_TLS, "active", False):
            return real(kernel, x, pw, plan)
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(cpu, "execute", broken)
    tr = ttrace.Tracer(timing=True)
    ttrace.install_tracer(tr)
    try:
        with pytest.raises(RuntimeError, match="failed to launch"):
            _gemv(512, 256)
    finally:
        ttrace.uninstall_tracer(tr)
    assert len(tr.dispatches) == 0
    assert not getattr(dispatch._TIMING_TLS, "active", False)
    # the same dispatch without timing never reaches the timer
    tr = ttrace.Tracer(timing=False)
    ttrace.install_tracer(tr)
    try:
        dispatch.clear_plan_cache()
        _gemv(512, 256)
    finally:
        ttrace.uninstall_tracer(tr)
    assert len(tr.dispatches) == 1


class CapturingRecorder(Recorder):
    """The graph stand-in whose capture looks like a real one to the
    dispatcher: ``is_current_stream_capturing`` answers True while the
    body is captured, and the plan cache is cleared first, so the body's
    decisions are met inside the capture."""

    def __init__(self, state, monkeypatch):
        super().__init__(state)
        self.mp = monkeypatch

    def capture(self, body):
        first = []

        def under_capture():
            if first:
                return body()              # a replay
            first.append(True)
            dispatch.clear_plan_cache()
            with self.mp.context() as m:
                m.setattr(torch.cuda, "is_initialized", lambda: True)
                m.setattr(torch.cuda, "is_current_stream_capturing",
                          lambda: True)
                assert dispatch._capturing()
                return body()

        return super().capture(under_capture)


def test_decisions_inside_a_capture_are_untimed_and_marked(olmo,
                                                          monkeypatch):
    def graphed(eng):
        rec = _graphed(eng)
        eng.graphs.capture = CapturingRecorder(rec.state, monkeypatch)

    tokens, tr = _port_run(olmo, "wave", traced=True, timing=True,
                           graph_recorder=graphed)
    plain, _ = _port_run(olmo, "wave", traced=False)
    assert tokens == plain
    assert not dispatch._capturing()
    untimed = [r for r in tr.dispatches if "untimed" in r.attrs]
    assert untimed and all(r.attrs["untimed"] == "capturing"
                           and r.trials_us is None for r in untimed)
    # every other decision (the warm steps') was timed
    assert all(r.trials_us for r in tr.dispatches
               if "untimed" not in r.attrs)
    rep = export.summary(tr)["drift"]
    assert rep["untimed"] == {"capturing": len(untimed)}
    assert rep["n_timed"] == len(tr.dispatches) - len(untimed)


# --------------------------------------------------------------------------
# record_overlap
# --------------------------------------------------------------------------


def test_record_overlap_keeps_inflight_equal_to_issued_minus_awaited():
    n_writers = 4                    # each holds at most 2 chunks in flight
    errors: list = []
    stop = threading.Event()

    def writer():
        try:
            while not stop.is_set():
                dispatch.record_overlap("async_prefill", issued=2)
                dispatch.record_overlap("async_prefill", awaited=1)
                dispatch.record_overlap("async_prefill", awaited=1)
                dispatch.record_overlap("deferred", deferred_collectives=1)
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    def reader():
        try:
            for _ in range(400):
                ap = dispatch.dispatch_stats()["overlap"]["async_prefill"]
                assert ap["inflight"] == ap["issued"] - ap["awaited"]
                assert 0 <= ap["inflight"] <= ap["max_inflight"] \
                    <= 2 * n_writers
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        writers = [threading.Thread(target=writer)
                   for _ in range(n_writers)]
        readers = [threading.Thread(target=reader) for _ in range(2)]
        for t in writers + readers:
            t.start()
        for t in readers:
            t.join(timeout=60)
        stop.set()
        for t in writers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in writers + readers)
    assert not errors
    ov = dispatch.dispatch_stats()["overlap"]
    assert ov["async_prefill"]["inflight"] == 0
    assert ov["async_prefill"]["max_inflight"] >= 2 or \
        ov["async_prefill"]["issued"] == 0
    assert ov["deferred"]["collectives"] * 2 == ov["async_prefill"]["issued"]
    with pytest.raises(ValueError, match="unknown overlap kind"):
        dispatch.record_overlap("bogus")
    dispatch.clear_plan_cache()
    assert dispatch.dispatch_stats()["overlap"] == {
        "async_prefill": {"issued": 0, "awaited": 0, "inflight": 0,
                          "max_inflight": 0},
        "deferred": {"collectives": 0}}


# --------------------------------------------------------------------------
# The serve bench's flight trace
# --------------------------------------------------------------------------


def test_serve_trace_writes_the_flight_trace_as_the_reference(tmp_path):
    tcfg = bench.TraceConfig(n_requests=4, arrival_rate=0.8,
                             prompt_len_range=(2, 5), max_new_range=(2, 3),
                             kind="shared-prefix", n_tenants=2,
                             prefix_len_range=(10, 14))
    kw = dict(policies=("fcfs", "sjf"), smoke=True,
              trace_kind="shared-prefix", prefix_cache=True,
              prefill_chunk=4)
    out, jout = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    doc = bench.run_serve_trace("olmo-1b", trace_config=tcfg, device="cpu",
                                trace_out=out, **kw)
    jdoc = jbench.run_serve_trace(
        "olmo-1b", trace_config=jbench.TraceConfig(**tcfg.__dict__),
        trace_out=jout, trace_timing=False, **kw)
    assert ttrace.current_tracer() is None       # uninstalled after the run
    ft, jft = doc["flight_trace"], jdoc["flight_trace"]
    assert set(ft) == set(jft)
    assert ft["path"] == out and ft["policy"] == jft["policy"] == "sjf"
    assert ft["timing"] is True and ft["hidden_fraction"] is None
    assert ft["summary"] == export.summary_path(out)
    chrome = json.loads(open(out).read())
    summ = json.loads(open(ft["summary"]).read())
    jsumm = json.loads(open(jft["summary"]).read())
    assert chrome["otherData"]["schema"] == summ["schema"] == 1
    # the reference's summary fields, plus the per-decision records
    assert set(summ) - set(jsumm) == {"dispatches"}
    assert summ["policy"] == "sjf" and summ["arch"] == "olmo-1b"
    assert len(summ["requests"]) == len(jsumm["requests"]) == 4
    assert summ["open_requests"] == [] and not any(summ["dropped"].values())
    assert [r["rid"] for r in summ["requests"]] == \
        [r["rid"] for r in jsumm["requests"]]
    for r, jr in zip(summ["requests"], jsumm["requests"]):
        assert set(r["phases_ms"]) == set(jr["phases_ms"])
        assert sum(r["phases_ms"].values()) == pytest.approx(r["total_ms"])
    drift = summ["drift"]
    assert drift["n_timed"] == drift["n_dispatches"] == \
        len(summ["dispatches"]) > 0
    rec = summ["dispatches"][0]
    assert {"backend", "kind", "kernel", "shape", "predicted_us",
            "measured_us", "trials_us", "source", "attrs"} <= set(rec)
    slots = {e["tid"] for e in chrome["traceEvents"]
             if e["ph"] == "X" and e["tid"] >= 10}
    named = [e["tid"] for e in chrome["traceEvents"]
             if e["ph"] == "M" and e.get("tid", 0) >= 10]
    assert slots and sorted(named) == sorted(slots)
    # an untraced run records nothing and has no flight_trace
    plain = bench.run_serve_trace("olmo-1b", trace_config=tcfg,
                                  device="cpu", **kw)
    assert "flight_trace" not in plain


def test_bench_cli_trace_out(tmp_path, capsys):
    out = tmp_path / "TRACE.json"
    assert bench.main(["--smoke", "--device", "cpu", "--policy", "fcfs",
                       "--trace", "shared-prefix", "--prefix-cache",
                       "--no-trace-timing", "--trace-out", str(out)]) == 0
    assert "flight trace (fcfs)" in capsys.readouterr().out
    summ = json.loads(open(export.summary_path(str(out))).read())
    assert summ["drift"]["n_timed"] == 0 < summ["drift"]["n_dispatches"]
    assert json.loads(out.read_text())["traceEvents"]


def test_phase_partition_survives_a_real_clock(olmo):
    """On the host's own clock (no fake) each request's phases still sum
    to its total: the machine closes and opens phases at one instant."""
    _, _, tcfg, tparams = olmo
    tr = ttrace.Tracer()
    eng = Engine(tcfg, tparams, batch_slots=2, max_len=MAX_LEN,
                 device="cpu", tracer=tr, prefill_chunk=8)
    try:
        for i, p in enumerate(_random(tcfg.vocab, [20, 5, 9], 21)):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=3))
        done = eng.run_until_drained()
    finally:
        ttrace.uninstall_tracer(tr)
    assert len(done) == 3 and tr.open_requests == ()
    for r in tr.requests:
        assert sum(r["phases"].values()) == pytest.approx(r["total_us"],
                                                          rel=1e-6)
