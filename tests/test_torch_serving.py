"""Chunked prefill, preemption and the scheduler's deadline rules of the
port's ``Engine``, held against the JAX ``Engine`` on the CPU.

Both engines get the same params (the port's seeded init, converted to the
JAX tree), the same prompts and a ``FakeClock`` each, and must give the
same greedy tokens, eagerly and through the graph stand-in of
``test_torch_graphs`` (``Recorder``: the step's body runs at the warm step
and the capture, and is called again at every replay).  Reduced olmo-1b
and deepseek-moe-16b; fp, int8 and int4 KV stores.

Near ``max_len`` the JAX engine is no oracle (its own test there fails),
so the port's chunked KV is held bit for bit against its own unchunked KV.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from test_torch_graphs import _graphed, _jax_tree  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as JScheduler  # noqa: E402
from repro.serving.scheduler import \
    SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    Scheduler,
    SchedulerConfig,
)

MAX_LEN = 64
MOE = "deepseek-moe-16b"
MOE_KW = {"gemv_backend": "h100", "gemv_expert_shape": "ragged"}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("olmo-1b", MOE):
        tcfg = get_config(arch).reduced()
        tparams = lm.init_lm(tcfg, seed=0, device="cpu")
        out[arch] = (ARCHS[arch].reduced(), _jax_tree(tparams), tcfg,
                     tparams)
    return out


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _alloc(eng) -> dict[int, int]:
    """{slot: pos} over the alloc'd slots (decoding and mid-prefill)."""
    pos = np.asarray(eng.kv.cache["pos"])
    return {s: int(pos[s]) for s in sorted({*eng.active, *eng._prefilling})}


def _drive(eng, make_req, plan, clk, *, tick=0.0, after_step=None):
    """Serve ``plan`` [(step, rid, prompt, new_tokens, deadline_in)]: each
    request is submitted at its step (deadline ``deadline_in`` after the
    clock then, or none); the clock advances ``tick`` a step.  Returns
    {rid: request}."""
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
        if after_step is not None:
            after_step(eng)
        clk.advance(tick)
        step += 1
        assert step < 300
    return reqs


def _sched(policy_kw, jax_side: bool):
    if not policy_kw:
        return "fcfs"
    return (JSchedulerConfig if jax_side else SchedulerConfig)(**policy_kw)


def _run(models, arch, plan, route, *, sched=None, tick=0.0,
         after_step=None, **kw):
    """The port's engine over ``plan`` on ``route`` ("eager" or "graph");
    returns (engine, requests, recorder or None)."""
    _, _, tcfg, tparams = models[arch]
    clk = FakeClock()
    eng = Engine(tcfg, tparams, max_len=kw.pop("max_len", MAX_LEN),
                 device="cpu", clock=clk, scheduler=_sched(sched, False),
                 **kw)
    rec = _graphed(eng) if route == "graph" else None
    reqs = _drive(eng, Request, plan, clk, tick=tick, after_step=after_step)
    return eng, reqs, rec


_JAX_RUNS: dict = {}


def _jax_run(models, key, arch, plan, *, sched=None, tick=0.0,
             after_step=None, **kw):
    """The JAX engine over ``plan`` (once per ``key``: the eager and graph
    cases share it); returns (tokens, counters, per-step record)."""
    if key not in _JAX_RUNS:
        jcfg, jparams, _, _ = models[arch]
        clk = FakeClock()
        jkw = {k: v for k, v in kw.items() if k != "gemv_backend"}
        eng = JaxEngine(jcfg, jparams, max_len=jkw.pop("max_len", MAX_LEN),
                        clock=clk, scheduler=_sched(sched, True), **jkw)
        steps = []
        reqs = _drive(eng, JaxRequest, plan, clk, tick=tick,
                      after_step=lambda e: steps.append(_alloc(e)))
        _JAX_RUNS[key] = ({rid: list(r.generated) for rid, r in reqs.items()},
                          dict(eng.metrics.counters), steps)
    return _JAX_RUNS[key]


def _tokens(reqs) -> dict:
    return {rid: list(r.generated) for rid, r in reqs.items()}


ROUTES = ("eager", "graph")
PREEMPT = dict(policy="gemv_aware", gemv_batch_threshold=4,
               preempt_margin=5.0)


# --------------------------------------------------------------------------
# chunked prefill
# --------------------------------------------------------------------------

CHUNK_CASES = [("olmo-1b", "fp"), ("olmo-1b", "int8"), ("olmo-1b", "int4"),
               (MOE, "fp")]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("arch,store", CHUNK_CASES)
def test_chunked_prefill_gives_the_jax_engines_tokens(models, arch, store,
                                                      route):
    """Prompts [30, 5, 25, 3] with chunk 8: the long ones prefill a chunk
    a step while the short ones decode, token for token as the JAX
    engine does."""
    vocab = models[arch][2].vocab
    plan = [(0, i, p, 5, None) for i, p in
            enumerate(_prompts(vocab, [30, 5, 25, 3], seed=14))]
    kw = dict(batch_slots=4, prefill_chunk=8, kv_store=store,
              **(MOE_KW if arch == MOE else {}))
    want, counters, _ = _jax_run(models, ("chunk", arch, store), arch, plan,
                                 **kw)
    eng, reqs, rec = _run(models, arch, plan, route, **kw)
    assert _tokens(reqs) == want
    assert eng.metrics.counters["prefill_chunks"] == \
        counters["prefill_chunks"] == 4 + 4
    if rec is not None:
        assert rec.replayed > 0


def _decode_while_prefilling_plan(vocab):
    p = _prompts(vocab, [4, 32], seed=15)
    return [(0, 0, p[0], 12, None), (1, 1, p[1], 2, None)]


@pytest.mark.parametrize("route", ROUTES)
def test_decode_keeps_running_while_a_long_prompt_prefills(models, route):
    """A 32-token prompt prefills in chunks of 4 while the active slot
    decodes; on the graph route the mid-prefill row rides replayed
    buckets, and after every step each alloc'd slot's ``pos`` equals the
    JAX engine's (a chunk's ``consumed`` for the row mid-prefill)."""
    plan = _decode_while_prefilling_plan(models["olmo-1b"][2].vocab)
    kw = dict(batch_slots=2, prefill_chunk=4)
    want, counters, jax_steps = _jax_run(models, ("decode_while",),
                                         "olmo-1b", plan, **kw)
    steps, seen = [], []

    def record(eng):
        steps.append(_alloc(eng))
        seen.append((dict(eng._prefilling) and len(eng.active),
                     rec.replayed if rec is not None else 0))

    rec = None
    _, _, tcfg, tparams = models["olmo-1b"]
    clk = FakeClock()
    eng = Engine(tcfg, tparams, max_len=MAX_LEN, device="cpu", clock=clk,
                 **kw)
    if route == "graph":
        rec = _graphed(eng)
    reqs = _drive(eng, Request, plan, clk, after_step=record)
    assert _tokens(reqs) == want
    assert steps == jax_steps
    assert counters["prefill_chunks"] == \
        eng.metrics.counters["prefill_chunks"] >= 32 // 4
    # the first request decoded in the steps the second one prefilled
    mid = [i for i, (both, _) in enumerate(seen) if both]
    assert len(mid) >= 32 // 4 - 1
    if rec is not None:
        replays = [seen[i][1] - (seen[i - 1][1] if i else 0) for i in mid]
        assert sum(replays) >= len(mid) - 1 > 0


@pytest.mark.parametrize("earlier", [0, 20])
@pytest.mark.parametrize("store", ["fp", "int8", "int4"])
def test_chunked_kv_near_max_len_equals_the_unchunked_kv(models, store,
                                                         earlier):
    """max_len 24, chunk 9, a 23-token prompt: the last chunk (consumed
    18, 5 tokens) pads to 6, not 8, so no write clamps back over earlier
    chunks; the chunked KV over [0, 23) equals a fresh engine's unchunked
    KV bit for bit (codes and scales of a quantized store), also when the
    slot first held an ``earlier``-token request's KV (every chunk, the
    first too, runs on the slot's own row)."""
    _, _, tcfg, tparams = models["olmo-1b"]
    prompt = _prompts(tcfg.vocab, [23], seed=18)[0]
    before = _prompts(tcfg.vocab, [earlier], seed=19) if earlier else []
    caches, outs = [], []
    for chunk, first in ((None, []), (9, before)):
        eng = Engine(tcfg, tparams, batch_slots=1, max_len=24,
                     prefill_chunk=chunk, kv_store=store, device="cpu")
        for i, p in enumerate(first + [prompt]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=1))
        outs.append(eng.run_until_drained()[-1].generated)
        caches.append({n: t[:, 0, :len(prompt)].clone()
                       for n, t in eng.kv.cache.items() if n != "pos"})
        assert eng.metrics.counters["prefill_chunks"] == \
            (3 * (1 + len(first)) if chunk else 0)
    assert outs[0] == outs[1]
    for name, t in caches[0].items():
        assert torch.equal(t, caches[1][name]), name


# --------------------------------------------------------------------------
# preemption
# --------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
def test_preemption_evicts_the_youngest_decoding_slot(models, route):
    """Two slots busy decoding, a queued deadline inside the margin: the
    youngest admission is evicted, re-prefills prompt plus generated on
    readmission, and every stream equals the JAX engine's."""
    p = _prompts(models["olmo-1b"][2].vocab, [5, 6, 4], seed=12)
    plan = [(0, 0, p[0], 10, None), (0, 1, p[1], 10, None),
            (2, 2, p[2], 3, 3.0)]
    kw = dict(batch_slots=2)
    want, counters, _ = _jax_run(models, ("preempt_young",), "olmo-1b",
                                 plan, sched=PREEMPT, **kw)
    eng, reqs, _ = _run(models, "olmo-1b", plan, route, sched=PREEMPT, **kw)
    assert _tokens(reqs) == want
    assert eng.metrics.counters["evicted"] == counters["evicted"] == 1
    assert reqs[1].admit_seq > reqs[0].admit_seq
    assert (reqs[0].evictions, reqs[1].evictions) == (0, 1)
    assert reqs[2].done and not reqs[2].expired


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("arch", ["olmo-1b", MOE])
def test_preemption_evicts_a_slot_mid_chunk(models, arch, route):
    """The only slot is mid-chunked-prefill when an imminent request
    arrives: it is the victim (no decode work lost) and re-prefills from
    the start on readmission."""
    p = _prompts(models[arch][2].vocab, [20, 4], seed=17)
    plan = [(0, 0, p[0], 3, None), (1, 1, p[1], 2, 3.0)]
    kw = dict(batch_slots=1, prefill_chunk=4,
              **(MOE_KW if arch == MOE else {}))
    want, counters, _ = _jax_run(models, ("preempt_chunk", arch), arch,
                                 plan, sched=PREEMPT, **kw)
    eng, reqs, _ = _run(models, arch, plan, route, sched=PREEMPT, **kw)
    assert _tokens(reqs) == want
    assert eng.metrics.counters["evicted"] == counters["evicted"] == 1
    assert reqs[0].evictions == 1
    assert reqs[1].done and not reqs[1].expired


def test_no_preemption_without_a_margin(models):
    """With no ``preempt_margin`` the running request finishes and the
    late one expires in the queue, as in the JAX engine."""
    p = _prompts(models["olmo-1b"][2].vocab, [4, 4], seed=13)
    plan = [(0, 0, p[0], 6, None), (1, 1, p[1], 2, 5.0)]
    sched = dict(policy="gemv_aware", gemv_batch_threshold=4)
    kw = dict(batch_slots=1)
    want, counters, _ = _jax_run(models, ("no_margin",), "olmo-1b", plan,
                                 sched=sched, tick=10.0, **kw)
    eng, reqs, _ = _run(models, "olmo-1b", plan, "eager", sched=sched,
                        tick=10.0, **kw)
    assert _tokens(reqs) == want
    assert eng.metrics.counters["evicted"] == counters["evicted"] == 0
    assert reqs[1].expired and reqs[1].generated == []
    assert eng.metrics.counters["expired"] == counters["expired"] == 1


@pytest.mark.parametrize("route", ROUTES)
def test_prepack_off_gives_the_same_tokens(models, route):
    """``prepack_weights=False`` decodes from the unpacked weights: the
    same tokens as the JAX engine with prepacking off, and as the port's
    prepacked engine."""
    vocab = models["olmo-1b"][2].vocab
    plan = [(0, i, p, 6, None) for i, p in
            enumerate(_prompts(vocab, [5, 9, 3], seed=4))]
    want, _, _ = _jax_run(models, ("prepack_off",), "olmo-1b", plan,
                          batch_slots=4, prepack_weights=False)
    out = {}
    for prepack in (False, True):
        eng, reqs, _ = _run(models, "olmo-1b", plan, route, batch_slots=4,
                            prepack_weights=prepack)
        assert ("head_t" in eng.params) == prepack
        out[prepack] = _tokens(reqs)
    assert out[False] == out[True] == want


# --------------------------------------------------------------------------
# the scheduler's deadline rules against the JAX Scheduler
# --------------------------------------------------------------------------


def _request_set(seed):
    """A seeded request set with deadlines, started (evicted) requests and
    mixed prompt lengths, as port and JAX requests; and a clock reading."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 12))
    specs = []
    for rid in range(n):
        deadline = (float(rng.uniform(0.0, 10.0))
                    if rng.random() < 0.6 else None)
        started = [int(rng.integers(0, 50))] if rng.random() < 0.3 else []
        specs.append((rid, int(rng.integers(1, 20)), deadline, started))
    now = float(rng.uniform(0.0, 8.0))
    free, active = int(rng.integers(0, 6)), int(rng.integers(0, 8))

    def build(cls):
        return [cls(rid=rid, prompt=np.zeros(n, np.int32), deadline=dl,
                    generated=list(g)) for rid, n, dl, g in specs]

    return build(Request), build(JaxRequest), now, free, active


def _cost(r):
    return len(r.prompt) % 7 + len(r.generated)


@pytest.mark.parametrize("seed", range(10))
def test_scheduler_deadline_rules_match_jax(seed):
    """expire, wants_preemption and select equal the JAX Scheduler's on
    the same request sets, for every policy, with and without a margin
    and a prefill-cost hook.  Also: a request that already streamed tokens
    never expires; under gemv_aware with a margin imminent requests are
    selected first; sjf's order does not depend on the margin."""
    treqs, jreqs, now, free, active = _request_set(seed)
    picked_sjf = {}
    for policy in ("fcfs", "sjf", "gemv_aware"):
        for margin in (None, 2.0):
            for hook in (None, _cost):
                ts = Scheduler(SchedulerConfig(policy=policy,
                                               gemv_batch_threshold=6,
                                               preempt_margin=margin))
                js = JScheduler(JSchedulerConfig(policy=policy,
                                                 gemv_batch_threshold=6,
                                                 preempt_margin=margin))
                ts.prefill_cost = js.prefill_cost = hook
                for r in treqs:
                    ts.submit(r, 0.0)
                for r in jreqs:
                    js.submit(r, 0.0)
                t_exp = [r.rid for r in ts.expire(now)]
                assert t_exp == [r.rid for r in js.expire(now)]
                assert not any(treqs[rid].generated for rid in t_exp)
                assert ts.wants_preemption(now) == js.wants_preemption(now)
                assert ts.wants_preemption(now) == (
                    policy == "gemv_aware" and margin is not None
                    and any(r.deadline is not None
                            and now + margin >= r.deadline
                            for r in ts.queue))
                t_sel = [r.rid for r in ts.select(free, active, now)]
                assert t_sel == [r.rid for r in js.select(free, active, now)]
                assert [r.rid for r in ts.queue] == [r.rid for r in js.queue]
                if policy == "gemv_aware" and margin is not None:
                    imm = [ts._imminent(treqs[rid], now) for rid in t_sel]
                    assert imm == sorted(imm, reverse=True)
                if policy == "sjf":
                    picked_sjf.setdefault(hook, []).append(t_sel)
    for picks in picked_sjf.values():
        assert picks[0] == picks[1]


@pytest.mark.parametrize("sides", [(Scheduler, SchedulerConfig, Request),
                                   (JScheduler, JSchedulerConfig,
                                    JaxRequest)], ids=["port", "jax"])
def test_requeue_bypasses_backpressure(sides):
    """An evicted request goes back in the queue past ``max_queue`` and
    keeps its submit time and arrival order."""
    sched_cls, cfg_cls, req_cls = sides
    s = sched_cls(cfg_cls(policy="sjf", max_queue=1))
    a = req_cls(rid=0, prompt=np.zeros(5, np.int32))
    b = req_cls(rid=1, prompt=np.zeros(3, np.int32))
    s.submit(b, 1.0)
    s.select(1, 0)
    s.submit(a, 2.0)
    b.generated = [7]
    s.requeue(b)
    assert [r.rid for r in s.queue] == [0, 1]
    assert (b.submit_time, b.arrival_seq) == (1.0, 0)
    assert [r.rid for r in s.select(2, 0)] == [1, 0]
