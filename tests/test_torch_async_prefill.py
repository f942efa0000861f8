"""``Engine(async_prefill=True)`` against the JAX engine and the port's
serial engine, on the CPU.

With ``async_prefill`` every miss prefills through the chunk chain on its
own row of the prefill sub-cache, and the step after the final chunk
harvests it (on the card the chain runs on a side stream; here in order,
with the same rows, harvest and counters).  The cases are the
reference's ``tests/test_overlap.py``: mixed lengths with and without
chunking, admission mid-decode, preemption of an in-flight chain (no
chain leaks), every registered family, the traced run's
``hidden_fraction`` and the nesting of its overlap spans, the overlap
counters after a drain, and the bench's field.  Greedy tokens equal the
JAX ``Engine(async_prefill=True)``'s and the serial engine's; sampled
logits rows equal the JAX engine's within ``ATOL`` (f32 on both sides,
sums in other orders).  The graph stand-in of ``test_torch_graphs``
(decode) and ``test_torch_prefill_graphs`` (prefill) runs the chains'
chunks through the prefill graphs.
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from test_torch_graphs import _graphed, _jax_tree  # noqa: E402
from test_torch_multimodal import _pair as mm_pair  # noqa: E402
from test_torch_prefill_graphs import prefill_graphed  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.scheduler import \
    SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.observability import export  # noqa: E402
from repro_torch.observability.trace import Tracer, \
    uninstall_tracer  # noqa: E402
from repro_torch.serving import bench  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

ATOL = 1e-4
MAX_LEN = 64

_MODELS: dict = {}


def _model(name="olmo-1b"):
    """(jcfg, jparams, tcfg, tparams): the port's init, bridged to the JAX
    tree (whisper: its test file's pair)."""
    if name not in _MODELS:
        if name == "whisper-small":
            _MODELS[name] = mm_pair(name, gate=0.75)
        else:
            tcfg = get_config(name).reduced()
            tparams = lm.init_lm(tcfg, seed=0, device="cpu")
            _MODELS[name] = (JARCHS[name].reduced(), _jax_tree(tparams),
                             tcfg, tparams)
    return _MODELS[name]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _drive(eng, make_req, plan, *, clock=None):
    """Submit (step, prompt, new tokens, deadline or None) at each step,
    step until drained; returns ({rid: tokens}, {rid: logits rows},
    {rid: request})."""
    rows, sample = {}, eng._sample

    def logged(r, row):
        rows.setdefault(r.rid, []).append(np.array(row, np.float32))
        return sample(r, row)

    eng._sample = logged
    reqs, pending, step = {}, list(enumerate(plan)), 0
    while pending or eng.active or eng._prefilling or eng.scheduler.queue:
        for i, (at, p, n, dl) in [e for e in pending if e[1][0] <= step]:
            reqs[i] = make_req(rid=i, prompt=p, max_new_tokens=n,
                               deadline=None if dl is None
                               else clock() + dl)
            eng.submit(reqs[i])
            pending.remove((i, (at, p, n, dl)))
        eng.step()
        step += 1
        assert step < 300
    return ({rid: list(r.generated) for rid, r in reqs.items()},
            {rid: np.stack(r) for rid, r in rows.items()}, reqs)


def _port(plan, name="olmo-1b", graphs=False, clock=None, **kw):
    _, _, tcfg, tparams = _model(name)
    eng = Engine(tcfg, tparams, device="cpu", max_len=MAX_LEN,
                 **({"clock": clock} if clock else {}), **kw)
    if graphs:
        _graphed(eng)
        prefill_graphed(eng)
    return eng, _drive(eng, Request, plan, clock=clock)


def _jax(plan, name="olmo-1b", clock=None, **kw):
    jcfg, jparams, _, _ = _model(name)
    eng = JaxEngine(jcfg, jparams, max_len=MAX_LEN,
                    **({"clock": clock} if clock else {}), **kw)
    return eng, _drive(eng, JaxRequest, plan, clock=clock)


def _same_rows(got, want):
    for rid in got:
        np.testing.assert_allclose(got[rid], want[rid], atol=ATOL, rtol=0,
                                   err_msg=f"request {rid}")


def _balanced():
    ap = dispatch.dispatch_stats()["overlap"]["async_prefill"]
    assert ap["issued"] == ap["awaited"] > 0 and ap["inflight"] == 0
    return ap


@pytest.mark.parametrize("chunk", [None, 8], ids=["whole", "chunk8"])
def test_mixed_lengths_match_the_jax_async_engine_and_the_serial_one(chunk):
    """Prompts [30, 5, 25, 3, 12]: the async engine (eager and through the
    graph stand-ins) against the JAX async engine and the port's serial
    engine; every issued chunk awaited."""
    plan = [(0, p, 5, None) for p in
            _prompts(_model()[2].vocab, [30, 5, 25, 3, 12], seed=20)]
    kw = dict(batch_slots=4, prefill_chunk=chunk)
    _, (serial, _, _) = _port(plan, batch_slots=4)
    jeng, (jtok, jrows, _) = _jax(plan, async_prefill=True, **kw)
    for graphs in (False, True):
        dispatch.clear_plan_cache()
        eng, (tok, rows, _) = _port(plan, graphs=graphs, async_prefill=True,
                                    **kw)
        assert tok == jtok == serial
        _same_rows(rows, jrows)
        assert not eng._inflight and eng.metrics.counters[
            "prefill_chunks"] == jeng.metrics.counters["prefill_chunks"]
        assert _balanced()["issued"] == \
            eng.metrics.counters["prefill_chunks"]
        if graphs:
            assert eng.prefill_graphs.replays


def test_admission_mid_decode():
    """Two requests decode while two more arrive and chain their prefill
    (chunk 6, 2 slots)."""
    p = _prompts(_model()[2].vocab, [6, 22, 4, 17], seed=22)
    plan = [(0, p[0], 5, None), (0, p[1], 5, None), (2, p[2], 5, None),
            (2, p[3], 5, None)]
    kw = dict(batch_slots=2, prefill_chunk=6)
    _, (serial, _, _) = _port(plan, batch_slots=2)
    _, (jtok, jrows, _) = _jax(plan, async_prefill=True, **kw)
    _, (tok, rows, _) = _port(plan, async_prefill=True, **kw)
    assert tok == jtok == serial
    _same_rows(rows, jrows)


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graph"])
def test_preemption_lands_an_inflight_chain_first(graphs):
    """One slot mid-chain when an imminent request arrives: the chain is
    landed, filed and its slot freed; the victim re-prefills on
    readmission; no chain leaks, and every stream is the JAX async
    engine's and the serial one's."""
    p = _prompts(_model()[2].vocab, [20, 4], seed=23)
    plan = [(0, p[0], 3, None), (1, p[1], 2, 3.0)]
    out = {}
    for side in ("port", "jax", "serial"):
        clk = FakeClock()
        if side == "serial":
            _, out[side] = _port(plan, clock=clk, batch_slots=1)
            continue
        sched = (SchedulerConfig if side == "port" else JSchedulerConfig)(
            policy="gemv_aware", gemv_batch_threshold=4, preempt_margin=5.0)
        run = _port if side == "port" else _jax
        kw = dict(graphs=graphs) if side == "port" else {}
        eng, out[side] = run(plan, clock=clk, batch_slots=1,
                             async_prefill=True, prefill_chunk=4,
                             scheduler=sched, **kw)
        assert eng.metrics.counters["evicted"] == 1
        assert out[side][2][0].evictions == 1
        assert not eng._inflight
    assert out["port"][0] == out["jax"][0] == out["serial"][0]
    _same_rows(out["port"][1], out["jax"][1])
    _balanced()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_family_gives_the_serial_engines_tokens(arch):
    """Every registered family, reduced, with async prefill and chunk 6
    against its serial engine (prompts [5, 17, 3], 2 slots)."""
    cfg = get_config(arch).reduced()
    params = lm.init_lm(cfg, seed=0, device="cpu")
    prompts = _prompts(cfg.vocab, [5, 17, 3], seed=25)
    outs = []
    for kw in ({}, {"async_prefill": True, "prefill_chunk": 6}):
        eng = Engine(cfg, params, batch_slots=2, max_len=MAX_LEN,
                     device="cpu", **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=3))
        outs.append({r.rid: r.generated for r in eng.run_until_drained()})
        assert not eng._inflight
    assert outs[0] == outs[1]


@pytest.mark.parametrize("name", ["olmo-1b", "whisper-small"])
def test_defrag_moves_an_inflight_chain_with_its_slot(name):
    """Two short requests finish while a long one's chain is in flight in
    the slot above them: compaction moves the chain (and swaps the slot's
    feature rows; the chain keeps its own copy), and the tokens are the
    JAX async engine's and the serial engine's."""
    p = _prompts(_model(name)[2].vocab, [3, 4, 30], seed=27)
    plan = [(0, p[0], 2, None), (0, p[1], 2, None), (1, p[2], 4, None)]
    kw = dict(batch_slots=3, prefill_chunk=4)
    _, (serial, _, _) = _port(plan, name, batch_slots=3)
    _, (jtok, jrows, _) = _jax(plan, name, async_prefill=True, **kw)
    _, _, tcfg, tparams = _model(name)
    eng = Engine(tcfg, tparams, device="cpu", max_len=MAX_LEN,
                 async_prefill=True, **kw)
    moved, compact = [], eng._compact

    def spy():
        before = set(eng._inflight)
        compact()
        moved.extend(before - set(eng._inflight))

    eng._compact = spy
    tok, rows, _ = _drive(eng, Request, plan)
    assert moved, "no chain moved with its slot"
    assert tok == jtok == serial
    _same_rows(rows, jrows)


def test_a_failing_chain_raises():
    """No fallback: a chunk of a chain that fails raises out of the
    step."""
    _, _, tcfg, tparams = _model()
    eng = Engine(tcfg, tparams, device="cpu", max_len=MAX_LEN,
                 async_prefill=True, prefill_chunk=4)
    calls, run = [], eng._run_prefill

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("an illegal memory access was encountered")
        return run(*a, **k)

    eng._run_prefill = failing
    eng.submit(Request(rid=0, prompt=_prompts(tcfg.vocab, [12], 1)[0],
                       max_new_tokens=2))
    eng.step()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.step()


def test_traced_run_reports_hidden_fraction_and_nests_its_spans():
    """A traced async run: the summary's overlap section has
    hidden_fraction in (0, 1] and its totals tie out with the spans, and
    every overlap span lies inside its request's prefill phase."""
    plan = [(0, p, 4, None) for p in
            _prompts(_model()[2].vocab, [20, 6, 15, 4], seed=26)]
    tr = Tracer()
    try:
        _port(plan, batch_slots=4, async_prefill=True, prefill_chunk=6,
              tracer=tr)
    finally:
        uninstall_tracer(tr)
    ov = export.summary(tr)["overlap"]
    assert ov["n_spans"] == 4
    assert 0.0 < ov["hidden_fraction"] <= 1.0
    assert ov["hidden_us"] == pytest.approx(ov["total_us"] - ov["blocked_us"])
    spans = list(tr.spans)
    overlaps = [s for s in spans if s.cat == "overlap"]
    prefills = [s for s in spans if s.cat == "phase" and s.name == "prefill"]
    eps = 1e-3
    for s in overlaps:
        assert s.name == "async_prefill" and s.attrs["chunks"] >= 1
        assert s.attrs["blocked_us"] <= s.dur_us + eps
        assert any(p.rid == s.rid and p.start_us <= s.start_us + eps
                   and p.start_us + p.dur_us + eps >= s.start_us + s.dur_us
                   for p in prefills), s


def test_overlap_counters_balance_in_the_metrics_delta():
    dispatch.clear_plan_cache()
    plan = [(0, p, 3, None) for p in
            _prompts(_model()[2].vocab, [10, 6], seed=21)]
    eng, _ = _port(plan, batch_slots=2, async_prefill=True, prefill_chunk=4)
    ap = eng.metrics.dispatch_delta()["overlap"]["async_prefill"]
    assert ap["issued"] == ap["awaited"] == 3 + 2
    assert ap["inflight"] == 0 and ap["max_inflight"] >= 1


def test_the_bench_carries_async_prefill(tmp_path):
    """``run_serve_trace(async_prefill=True)``: the document and its runs
    say so, a traced run reports hidden_fraction, and the tokens are the
    synchronous bench's; the CLI flag sets it."""
    kw = dict(policies=("fcfs",), smoke=True, trace_kind="shared-prefix",
              prefix_cache=True, prefill_chunk=8, device="cpu", tokens=True)
    sync = bench.run_serve_trace("olmo-1b", **kw)
    doc = bench.run_serve_trace("olmo-1b", async_prefill=True,
                                trace_out=str(tmp_path / "t.json"), **kw)
    json.dumps(doc)
    assert doc["async_prefill"] is True and sync["async_prefill"] is False
    assert doc["runs"][0]["async_prefill"] is True
    assert doc["runs"][0]["generated"] == sync["runs"][0]["generated"]
    assert 0.0 < doc["flight_trace"]["hidden_fraction"] <= 1.0
    out = tmp_path / "serve.json"
    assert bench.main(["--smoke", "--device", "cpu", "--policy", "sjf",
                       "--async-prefill", "--json", str(out)]) == 0
    assert json.loads(out.read_text())["runs"][0]["async_prefill"] is True
