"""Prefill as captured graphs, on the CPU.

On the card every prefill forward (a wave of ``nb`` right-padded prompts,
or one chunk) is one captured CUDA graph per ``(rows, length)`` over the
engine's prefill sub-cache (``PrefillGraphs``).  Here the decode graphs'
stand-in of ``test_torch_graphs`` (``Recorder``: its capture runs the
body's Python and undoes its writes, its replay runs the body with the
dispatcher's counters kept) stands in for both captures, and the port's
``Engine`` on that route must give the JAX ``Engine``'s greedy tokens and
sampled logits rows (``ATOL`` 1e-4: f32 on both sides, sums in other
orders, through the whole model): dense fp / int8 / int4 KV, the MoE
model on its ragged decode, rwkv6-3b and hymba-1.5b (perturbed as their
own test files perturb them) and whisper-small, each as a wave and with
chunk 8 on prompts [30, 5, 25, 3]; a prompt whose last chunk is cut short
by ``max_len``; a prefix hit's tail.

MoE prefill runs its experts as grouped products over the expert-sorted
pairs with the offsets on the device (``layers._moe_prefill``): held
against the JAX ``apply_moe`` (1e-5 absolute) and against its plain
version, the per-expert loop, with and without drops, at a chunk's shape
and a wave's, with every host read refused; the card's route for a
non-bf16 stack (``ragged_products``: ``ragged_gemv``, here its plain
version) against the loop too.  A chunk writes only its slot's chunk
positions, state rows and ``pos``.
"""

import contextlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_graphs import Recorder, _graphed, _jax_tree  # noqa: E402
from test_torch_hybrid import _pair as hymba_pair  # noqa: E402
from test_torch_multimodal import _pair as mm_pair  # noqa: E402
from test_torch_ssm import _pair as rwkv_pair  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import disable_graphs  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.step_graph import PrefillGraphs  # noqa: E402

ATOL = 1e-4
MOE_ATOL = 1e-5
MAX_LEN = 64
MOE = "deepseek-moe-16b"
LENGTHS = [30, 5, 25, 3]

_MODELS: dict = {}


def _model(name):
    """(jcfg, jparams, tcfg, tparams) by name, built once a module."""
    if name not in _MODELS:
        if name in ("olmo-1b", MOE):
            tcfg = get_config(name).reduced()
            tparams = lm.init_lm(tcfg, seed=0, device="cpu")
            _MODELS[name] = (ARCHS[name].reduced(), _jax_tree(tparams), tcfg,
                             tparams)
        elif name == "rwkv6-3b":
            _MODELS[name] = rwkv_pair()
        elif name == "hymba-1.5b":
            _MODELS[name] = hymba_pair()
        else:
            _MODELS[name] = mm_pair(name, gate=0.75)
    return _MODELS[name]


def prefill_graphed(eng: Engine) -> Recorder:
    """Put ``eng``'s prefill (on the CPU) on the graph route through a
    Recorder over the sub-cache and its feature rows."""
    eng.prefill_graphs = PrefillGraphs(
        eng._prefill_body, eng.sub, vocab=eng.cfg.vocab, device=eng.device,
        capture=None, inputs=eng.sub_features)
    rec = eng.prefill_graphs.capture = Recorder(
        [*eng.sub.values(), *eng.sub_features.values()])
    return rec


def _logged(eng):
    """Record every logits row ``eng`` samples from, by request."""
    rows, sample = {}, eng._sample

    def logged(r, row):
        rows.setdefault(r.rid, []).append(np.array(row, np.float32))
        return sample(r, row)

    eng._sample = logged
    return rows


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _serve(eng, make_req, plan):
    """Submit each (step, prompt, new tokens) of ``plan`` at its step and
    step until drained; returns ({rid: tokens}, {rid: logits rows})."""
    rows = _logged(eng)
    done, pending, step = {}, list(enumerate(plan)), 0
    while pending or eng.active or eng._prefilling or eng.scheduler.queue:
        for i, (at, p, n) in [e for e in pending if e[1][0] <= step]:
            eng.submit(make_req(rid=i, prompt=p, max_new_tokens=n))
            pending.remove((i, (at, p, n)))
        done.update({r.rid: list(r.generated) for r in eng.step()})
        step += 1
        assert step < 300
    return done, {rid: np.stack(r) for rid, r in rows.items()}


_JAX: dict = {}


def _jax(name, key, plan, **kw):
    """The JAX engine's tokens and rows for ``plan`` (once a key)."""
    if key not in _JAX:
        jcfg, jparams, _, _ = _model(name)
        jkw = {k: v for k, v in kw.items() if k != "gemv_backend"}
        _JAX[key] = _serve(JaxEngine(jcfg, jparams, **jkw), JaxRequest, plan)
    return _JAX[key]


def _graph_engine(name, **kw):
    _, _, tcfg, tparams = _model(name)
    eng = Engine(tcfg, tparams, device="cpu", **kw)
    return eng, _graphed(eng), prefill_graphed(eng)


def _assert_same(got, want):
    (tdone, trows), (jdone, jrows) = got, want
    assert tdone == jdone
    for rid in tdone:
        np.testing.assert_allclose(trows[rid], jrows[rid], atol=ATOL, rtol=0,
                                   err_msg=f"request {rid}")


# (model, engine options): every family the cases of the module docstring
# name, each as a wave and with chunk 8
CASES = [("olmo-1b", {}), ("olmo-1b", {"kv_store": "int8"}),
         ("olmo-1b", {"kv_store": "int4"}),
         (MOE, {"gemv_backend": "h100", "gemv_expert_shape": "ragged"}),
         ("rwkv6-3b", {}), ("hymba-1.5b", {}), ("whisper-small", {})]


@pytest.mark.parametrize("chunk", [None, 8], ids=["wave", "chunk8"])
@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{'-'.join(map(str, k.values())) or 'fp'}"
                              for n, k in CASES])
def test_prefill_graphs_give_the_jax_engines_tokens_and_logits(name, kw,
                                                               chunk):
    vocab = _model(name)[2].vocab
    plan = [(0, p, 3) for p in _prompts(vocab, LENGTHS, seed=14)]
    kw = dict(batch_slots=4, max_len=MAX_LEN, prefill_chunk=chunk, **kw)
    want = _jax(name, (name, chunk, tuple(kw.items())), plan, **kw)
    eng, rec, prec = _graph_engine(name, **kw)
    _assert_same(_serve(eng, Request, plan), want)
    g = eng.prefill_graphs
    # one eager run and one capture a shape, replays for the rest; a
    # state family's waves and short last chunks run eagerly, counted
    assert prec.warmed == prec.captured == len(g.replays)
    assert prec.replayed == sum(g.runs.values()) - len(g.replays)
    assert rec.replayed > 0
    exact = eng.exact_prefill
    if chunk is None:
        assert (g.eager.get("exact_wave", 0) > 0) == exact
        assert bool(g.replays) != exact
    else:
        # the long prompts' full chunks replay one graph
        assert (1, 8) in g.replays and g.runs[(1, 8)] > 1
        assert (g.eager.get("exact_last_chunk", 0) > 0) == exact


def test_a_chunk_cut_short_by_max_len_runs_eagerly_and_gives_jax_tokens():
    """max_len 24, chunk 9, a 23-token prompt: the last chunk (consumed
    18, 5 tokens) pads to 6, not 8 -- a shape of its own, run eagerly and
    counted -- and the tokens and rows are the JAX engine's; the KV over
    [0, 23) is bit-equal to the eager route's."""
    _, _, tcfg, _ = _model("olmo-1b")
    plan = [(0, p, 1) for p in _prompts(tcfg.vocab, [23], seed=18)]
    kw = dict(batch_slots=1, max_len=24, prefill_chunk=9)
    want = _jax("olmo-1b", "near_max_len", plan, **kw)
    eng, _, prec = _graph_engine("olmo-1b", **kw)
    _assert_same(_serve(eng, Request, plan), want)
    assert eng.prefill_graphs.eager == {"max_len_cut": 1}
    assert sorted(eng.prefill_graphs.replays) == [(1, 9)]
    eager = Engine(tcfg, _model("olmo-1b")[3], device="cpu", **kw)
    _serve(eager, Request, plan)
    for n, t in eng.kv.cache.items():
        if n != "pos":
            assert torch.equal(t[:, 0, :23], eager.kv.cache[n][:, 0, :23]), n


@pytest.mark.parametrize("name", ["olmo-1b", "rwkv6-3b"])
def test_a_prefix_hits_tail_replays_a_chunk_graph(name):
    """A second request sharing a cached 20-token prefix: its tail runs
    as one chunk on the spliced row, through a chunk graph (rwkv6: its
    exact length, eagerly), with the JAX engine's tokens and rows."""
    vocab = _model(name)[2].vocab
    pre, t1, t2 = _prompts(vocab, [20, 4, 8], seed=21)
    plan = [(0, np.concatenate([pre, t1]), 3),
            (4, np.concatenate([pre, t2]), 3)]
    kw = dict(batch_slots=2, max_len=MAX_LEN, prefix_cache=True,
              prefill_chunk=8)
    want = _jax(name, ("hit", name), plan, **kw)
    eng, _, _ = _graph_engine(name, **kw)
    _assert_same(_serve(eng, Request, plan), want)
    assert eng.metrics.counters["prefix_hits"] == 1


def test_graph_and_eager_prefill_give_equal_tokens_and_kv():
    """Both routes of one engine configuration: the same tokens, and the
    same KV in every slot row they leave."""
    _, _, tcfg, tparams = _model("olmo-1b")
    plan = [(0, p, 3) for p in _prompts(tcfg.vocab, LENGTHS, seed=3)]
    out = []
    for route in ("graph", "eager"):
        eng, _, _ = _graph_engine("olmo-1b", batch_slots=4, max_len=MAX_LEN,
                                  prefill_chunk=8)
        ctx = disable_graphs() if route == "eager" else \
            contextlib.nullcontext()
        with ctx:
            out.append((_serve(eng, Request, plan)[0],
                        {n: t.clone() for n, t in eng.kv.cache.items()}))
        assert bool(eng.prefill_graphs.replays) == (route == "graph")
    assert out[0][0] == out[1][0]
    for n in out[0][1]:
        assert torch.equal(out[0][1][n], out[1][1][n]), n


def test_counters_tick_at_the_eager_run_and_the_capture_only():
    """A host counter the prefill body ticks (through the dispatcher,
    whose counters a replay keeps) ticks twice a shape -- the eager run
    and the capture -- however often the shape replays."""
    eng, _, _ = _graph_engine("olmo-1b", batch_slots=4, max_len=MAX_LEN,
                              prefill_chunk=8)
    g = eng.prefill_graphs
    body = g.body

    def counted(tok, last):
        dispatch.record_expert_load(routed_tokens=1, experts=1,
                                    max_tokens=1, padded_slots=0)
        return body(tok, last)

    g.body = counted
    dispatch.clear_plan_cache()
    _serve(eng, Request, [(0, p, 2) for p in
                          _prompts(eng.cfg.vocab, LENGTHS, seed=5)])
    runs = sum(g.runs.values())
    assert runs > len(g.replays) > 0
    assert dispatch.dispatch_stats()["expert_load"]["decisions"] == \
        2 * len(g.replays)


def test_a_replay_raises_when_a_sub_cache_leaf_moved():
    eng, _, prec = _graph_engine("olmo-1b", batch_slots=2, max_len=MAX_LEN,
                                 prefill_chunk=8)
    p = _prompts(eng.cfg.vocab, [20], seed=6)[0]
    eng.submit(Request(rid=0, prompt=p, max_new_tokens=4))
    eng.step()
    assert prec.captured == 1
    eng.sub["k"] = eng.sub["k"].clone()
    with pytest.raises(RuntimeError, match="reassigned"):
        eng.step()
    assert prec.replayed == 0


def test_a_failing_capture_raises_out_of_the_step():
    """No fallback: a capture that fails raises; nothing runs the chunk
    eagerly instead."""
    eng, _, prec = _graph_engine("olmo-1b", batch_slots=2, max_len=MAX_LEN,
                                 prefill_chunk=8)

    def refuse(body):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    prec.capture = refuse
    eng.submit(Request(rid=0, prompt=_prompts(eng.cfg.vocab, [12])[0],
                       max_new_tokens=2))
    with pytest.raises(RuntimeError, match="capturing"):
        eng.step()
    assert eng.metrics.counters["prefill_chunks"] == 0


# --------------------------------------------------------------------------
# MoE prefill: grouped products over device offsets
# --------------------------------------------------------------------------


def _moe_layer():
    jcfg, jparams, tcfg, tparams = _model(MOE)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])["moe"]
    return jcfg, jp, tcfg, tparams["layers"][0]["moe"]


def _refuse_host_reads(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("host read of a tensor value")

    for name in ("item", "tolist", "numpy", "cpu", "__int__", "__index__",
                 "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("drops", [False, True], ids=["dropless", "drops"])
@pytest.mark.parametrize("shape", [(1, 8), (4, 32)], ids=["chunk", "wave"])
def test_moe_prefill_matches_jax_and_its_loop_and_reads_nothing_back(
        monkeypatch, shape, drops):
    """``apply_moe`` at a chunk's shape (1 x 8) and a wave's (4 x 32):
    equal to the JAX ``apply_moe`` within 1e-5 and to the per-expert loop
    bit for bit (the routed experts, before the shared MLP), with every
    host read refused.  With ``drops`` both packages' ``_capacity`` is
    pinned (2 slots at the chunk's 16 pairs over 8 experts, 8 at the
    wave's 64 a sequence) so that pairs drop."""
    jcfg, jp, tcfg, tp = _moe_layer()
    capacity = (2 if shape[1] == 8 else 8) if drops else None
    if capacity is not None:
        monkeypatch.setattr(jL, "_capacity", lambda n, cfg: capacity)
        monkeypatch.setattr(L, "_capacity", lambda n, cfg: capacity)
    x = np.random.default_rng(9).standard_normal(
        (*shape, tcfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: jL.apply_moe(p, x, jcfg))(
        jp, jnp.asarray(x))
    xt = torch.from_numpy(x)
    _, top_p, top_i = L._router(tp, xt, tcfg)
    loop, _ = L._moe_prefill_loop(tp, xt, tcfg, top_i, top_p)
    keep = L._capacity_plan(top_i, top_p, L._capacity(shape[1], tcfg),
                            tcfg.moe.n_experts)[5]
    assert bool(keep.all()) == (capacity is None)
    with monkeypatch.context() as m:
        _refuse_host_reads(m)
        y, aux = L.apply_moe(tp, xt, tcfg)
        routed, _ = L._moe_prefill(tp, xt, tcfg, top_i, top_p)
    assert torch.equal(routed, loop)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=MOE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-7, rtol=0)


def test_moe_engine_prefill_reads_nothing_back(monkeypatch):
    """Whole MoE prefill forwards through the engine's body -- a wave of 4
    rows, then a chunk on the sub-cache's row 0 -- with every host read
    refused (after one run that makes the forward's one-time host
    work)."""
    _, _, tcfg, tparams = _model(MOE)
    eng = Engine(tcfg, tparams, batch_slots=4, max_len=MAX_LEN, device="cpu")
    tok = torch.from_numpy(np.stack(_prompts(tcfg.vocab, [16] * 4))).long()
    last = torch.tensor([15, 3, 9, 0])
    eng._prefill_body(tok, last)
    with monkeypatch.context() as m:
        _refuse_host_reads(m)
        out = eng._prefill_body(tok, last)
        one = eng._prefill_body(tok[:1, :8], last[:1] % 8)
    assert out.shape == (4, tcfg.vocab) and one.shape == (1, tcfg.vocab)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("drops", [False, True], ids=["dropless", "drops"])
@pytest.mark.parametrize("shape", [(1, 8), (4, 32)], ids=["chunk", "wave"])
def test_moe_prefill_on_ragged_products_matches_its_loop(monkeypatch, shape,
                                                         drops):
    """The route an f32 (any non-bf16) stack takes on the card:
    ``ragged_products`` -- ``ragged_gemv`` at its streaming plan for the
    prefill's pairs, offsets ``[0, *ends]`` -- here through the kernel's
    plain version, equal to the per-expert loop bit for bit at a chunk's
    shape and a wave's, with and without drops."""
    _, _, tcfg, tp = _moe_layer()
    if drops:
        monkeypatch.setattr(L, "_capacity",
                            lambda n, cfg: 2 if shape[1] == 8 else 8)
    xt = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (*shape, tcfg.d_model)).astype(np.float32))
    _, top_p, top_i = L._router(tp, xt, tcfg)
    loop, _ = L._moe_prefill_loop(tp, xt, tcfg, top_i, top_p)
    calls = []

    def ragged(t, ends, w):
        calls.append(t.shape[0])
        return L.ragged_products(t, ends, w)

    monkeypatch.setattr(L, "expert_products", ragged)
    routed, _ = L._moe_prefill(tp, xt, tcfg, top_i, top_p)
    pairs = shape[0] * shape[1] * tcfg.moe.top_k
    assert calls == [pairs] * (3 if tcfg.act in L.GATED else 2)
    assert torch.equal(routed, loop)


@pytest.mark.parametrize("name,kw", [("olmo-1b", {"kv_store": "int8"}),
                                     ("hymba-1.5b", {})],
                         ids=["olmo-1b-int8", "hymba-1.5b"])
def test_a_chunk_writes_only_its_slots_chunk_positions_state_and_pos(name,
                                                                      kw):
    """``_run_chunk`` on slot 1 of 3 (8 tokens from position 5): slot 1's
    positions [5, 13) of every positional leaf change, its state rows and
    its ``pos`` (13); every other slot, and slot 1's positions outside the
    chunk, stay byte-equal.  The landed positions [0, 5) it continues
    from are the ones the forward reads: a chunk over junk there differs."""
    _, _, tcfg, tparams = _model(name)
    eng = Engine(tcfg, tparams, batch_slots=3, max_len=32, device="cpu", **kw)
    gen = torch.Generator().manual_seed(0)
    for n, t in eng.kv.cache.items():
        if n != "pos":
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype)
                    if t.is_floating_point()
                    else torch.randint(-8, 8, t.shape, generator=gen,
                                       dtype=t.dtype))
    eng.kv.cache["pos"].copy_(torch.tensor([3, 5, 7], dtype=torch.int32))
    before = {n: t.clone() for n, t in eng.kv.cache.items()}
    chunk = _prompts(tcfg.vocab, [8], seed=2)[0]
    feats = {k: v[1] for k, v in eng.features.items()}
    last = eng._run_chunk(eng.kv.cache, 1, feats, chunk, 5, 8).clone()
    after = eng.kv.cache
    assert after["pos"].tolist() == [3, 13, 7]
    state = set(eng.kv.state_names)
    for n, t in after.items():
        if n == "pos":
            continue
        assert torch.equal(t[:, [0, 2]], before[n][:, [0, 2]]), n
        if n in state:
            assert not torch.equal(t[:, 1], before[n][:, 1]), n
            continue
        assert torch.equal(t[:, 1, :5], before[n][:, 1, :5]), n
        assert torch.equal(t[:, 1, 13:], before[n][:, 1, 13:]), n
        assert not torch.equal(t[:, 1, 5:13], before[n][:, 1, 5:13]), n
    for n, t in eng.kv.cache.items():
        if n != "pos":
            t.copy_(before[n])
            if n not in state:
                t[:, 1, :5] = t[:, 0, :5]
    eng.kv.cache["pos"].copy_(before["pos"])
    other = eng._run_chunk(eng.kv.cache, 1, feats, chunk, 5, 8)
    assert not torch.equal(other, last)
