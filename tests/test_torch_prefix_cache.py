"""The port's shared-prefix KV reuse on the CPU, held against the JAX
package's.

* The radix index: the port's ``PrefixCache`` and the reference's run the
  same insert / match / acquire / release / ``evict_to`` sequences (fixed
  seeds, plain parametrisation) and must agree on match lengths,
  refcounts, LRU ticks, bytes, segment count, eviction order and the bytes
  of every gathered payload.
* The ``SlotKVCache`` seam: ``extract_prefix`` / ``splice_prefix`` round
  trips in every store format, a segment that outlives its slot's next
  occupant (a torch slice is a view; the port copies), and a chunk's
  splice of a slot onto itself.
* The engine: greedy tokens and prefill tokens saved equal the JAX
  ``Engine``'s with the prefix cache on, for fp / int8 / int4 stores and
  the reduced MoE, eagerly and through the graph stand-in; readmission
  after preemption goes through the matcher.
* The bench document against the reference's, field by field.
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_graphs import _graphed, _jax_tree  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.serving import bench as jbench  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.kv_cache import SlotKVCache as JSlotKVCache  # noqa: E402
from repro.serving.prefix_cache import PrefixCache as JPrefixCache  # noqa
from repro.serving.prefix_cache import \
    PrefixCacheConfig as JPrefixCacheConfig  # noqa: E402
from repro.serving.scheduler import Scheduler as JScheduler  # noqa: E402
from repro.serving.scheduler import \
    SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import bench  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.kv_cache import (  # noqa: E402
    POSITIONAL_LEAVES,
    SlotKVCache,
)
from repro_torch.serving.prefix_cache import (  # noqa: E402
    PrefixCache,
    PrefixCacheConfig,
    prefix_cacheable,
)
from repro_torch.serving.scheduler import (  # noqa: E402
    Scheduler,
    SchedulerConfig,
)

MAX_LEN = 64
MOE = "deepseek-moe-16b"


# --------------------------------------------------------------------------
# the radix index against the reference's
# --------------------------------------------------------------------------

NL, NH, HD = 2, 2, 4


def _payload(tokens):
    """The same synthetic payload for both packages: position t's K page
    holds tokens[t] and a position-dependent offset, V the K page + 0.5."""
    t = np.asarray(tokens, np.float32)
    k = (t[None, :, None, None] + np.arange(len(t))[None, :, None, None]
         * 1e-3 + np.zeros((NL, len(t), NH, HD))).astype(np.float32)
    port = {"kv": {"k": torch.from_numpy(k.copy()),
                   "v": torch.from_numpy(k + 0.5)}, "state": {}}
    ref = {"kv": {"k": jnp.asarray(k), "v": jnp.asarray(k + 0.5)},
           "state": {}}
    return port, ref


def _tree(node) -> tuple:
    """The tree under ``node`` as nested tuples of every node's tokens,
    refcount, LRU tick and bytes, children in key order."""
    return tuple((tuple(int(x) for x in c.tokens), c.refcount, c.last_used,
                  c.nbytes, _tree(c))
                 for _, c in sorted(node.children.items()))


def _port_sound(port: PrefixCache) -> None:
    """The port's accounting on its own: the accounted bytes are the live
    tree's, and the store holds what it accounts (no view keeps a larger
    parent)."""
    assert _consistent(port)
    for n in port._walk():
        for leaf in n.kv.values():
            assert leaf.untyped_storage().nbytes() == leaf.nbytes


def _same_state(port: PrefixCache, ref: JPrefixCache) -> None:
    assert _tree(port.root) == _tree(ref.root)
    assert port.bytes_used == ref.bytes_used
    assert port.n_segments == ref.n_segments
    assert port.counters == ref.counters
    assert port.stats() == ref.stats()
    _port_sound(port)


def _same_gather(pm, rm, port, ref) -> None:
    pg, rg = port.gather(pm), ref.gather(rm)
    assert set(pg["kv"]) == set(rg["kv"])
    for name in pg["kv"]:
        np.testing.assert_array_equal(pg["kv"][name].numpy(),
                                      np.asarray(rg["kv"][name]))


def _consistent(pc) -> bool:
    """The accounted bytes are the live tree's."""
    return pc.bytes_used == sum(n.nbytes for n in pc._walk())


@pytest.mark.parametrize("seed", range(10))
def test_prefix_cache_matches_the_reference_op_for_op(seed):
    """Random op sequences over a three-token alphabet (overlaps, splits,
    partial-edge matches), a capacity that forces LRU eviction, pins held
    across evictions: the two indexes stay equal after every op, up to
    the first insert after which the reference counts a segment it
    detached (test below; of these seeds, 9 reaches one).  From there the ops
    go on to the port alone, whose accounting and store are held after
    every op, down to an empty store once every pin is released."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(4, 16)) * NL * NH * HD * 4 * 2
    port = PrefixCache(PrefixCacheConfig(capacity_bytes=cap, min_tokens=2))
    ref = JPrefixCache(JPrefixCacheConfig(capacity_bytes=cap, min_tokens=2))
    held, ref_ok = [], True
    for _ in range(int(rng.integers(20, 40))):
        op = int(rng.integers(0, 5))
        t = rng.integers(0, 3, int(rng.integers(1, 12))).astype(np.int32)
        if op <= 1:
            pp, rp = _payload(t)
            filed = port.insert(t, pp)
            if ref_ok:
                ref_filed = ref.insert(t, rp)
                ref_ok = _consistent(ref)
                if ref_ok:
                    assert filed == ref_filed
        elif op == 2:
            pm = port.match(t)
            rm = ref.match(t) if ref_ok else None
            if ref_ok:
                assert port.match_len(t) == ref.match_len(t)
                assert (pm is None) == (rm is None)
                if pm is not None:
                    assert (pm.length, pm.spans) == (rm.length, rm.spans)
                    _same_gather(pm, rm, port, ref)
            if pm is not None and rng.random() < 0.6:
                port.acquire(pm)
                if ref_ok:
                    ref.acquire(rm)
                held.append((pm, rm))
        elif op == 3 and held:
            pm, rm = held.pop(int(rng.integers(0, len(held))))
            port.release(pm)
            if ref_ok:
                ref.release(rm)
        else:
            target = int(rng.integers(0, max(port.bytes_used, 1)))
            evicted = port.evict_to(target)
            if ref_ok:
                assert evicted == ref.evict_to(target)
        _port_sound(port)
        if ref_ok:
            _same_state(port, ref)
    for pm, rm in held:
        port.release(pm)
        if ref_ok:
            ref.release(rm)
    assert all(n.refcount == 0 for n in port._walk())
    evicted = port.evict_to(0)
    if ref_ok:
        assert evicted == ref.evict_to(0)
        _same_state(port, ref)
    _port_sound(port)
    assert port.bytes_used == 0 and port.n_segments == 0


def test_an_insert_never_evicts_the_node_it_attaches_to():
    """Capacity for three positions: [0, 1] is filed, then [0, 1, 2, 2]
    needs two more.  The reference evicts [0, 1] (the only zero-ref leaf)
    and attaches [2, 2] under the detached node, which it goes on counting
    with an empty tree; the port keeps [0, 1] and skips the insert."""
    per_pos = NL * NH * HD * 4 * 2
    out = []
    for cls, cfg_cls, side in ((PrefixCache, PrefixCacheConfig, 0),
                               (JPrefixCache, JPrefixCacheConfig, 1)):
        pc = cls(cfg_cls(capacity_bytes=3 * per_pos, min_tokens=2))
        for t in ([0, 1], [0, 1, 2, 2]):
            t = np.asarray(t, np.int32)
            ok = pc.insert(t, _payload(t)[side])
        out.append((ok, _tree(pc.root), pc.bytes_used, _consistent(pc)))
    assert out[0] == (False, (((0, 1), 0, 2, 2 * per_pos, ()),),
                      2 * per_pos, True)
    assert out[1] == (True, (), 2 * per_pos, False)


def test_state_families_match_only_at_snapshots():
    """``has_state``: matches stop at the deepest node holding a snapshot,
    as in the reference."""
    out = []
    for cls, cfg_cls, arr in ((PrefixCache, PrefixCacheConfig,
                               torch.ones), (JPrefixCache,
                                             JPrefixCacheConfig, jnp.ones)):
        pc = cls(cfg_cls(capacity_bytes=None), has_state=True)
        a = np.asarray([1, 2, 3, 4, 5, 6], np.int32)
        b = np.asarray([1, 2, 3, 9, 9], np.int32)
        for t in (a, b):
            pp, rp = _payload(t)
            p = pp if cls is PrefixCache else rp
            p["state"] = {"s": arr((NL, 3)) * len(t)}
            pc.insert(t, p)
        out.append([pc.match_len(np.concatenate([t, [7]]))
                    for t in (a, b, a[:3], a[:5])])
    assert out[0] == out[1] == [6, 5, 0, 0]


def test_release_below_zero_raises():
    pc = PrefixCache(PrefixCacheConfig(capacity_bytes=None))
    t = np.asarray([1, 2, 3], np.int32)
    pc.insert(t, _payload(t)[0])
    m = pc.match(np.concatenate([t, [4]]))
    pc.acquire(m)
    pc.release(m)
    with pytest.raises(AssertionError, match="negative"):
        pc.release(m)


# --------------------------------------------------------------------------
# the SlotKVCache seam
# --------------------------------------------------------------------------


def _fill(kv: SlotKVCache, gen: torch.Generator) -> None:
    """Random content in every leaf (codes and scales included)."""
    for name, leaf in kv.cache.items():
        if name == "pos":
            continue
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-128, 128, leaf.shape, generator=gen,
                                     dtype=torch.int8))
        else:
            leaf.copy_(torch.rand(leaf.shape, generator=gen))


@pytest.mark.parametrize("store", ["fp", "int8", "int4"])
def test_extract_splice_round_trip_survives_the_slots_next_occupant(store):
    """A segment extracted from a slot keeps its bytes when the slot is
    freed, reallocated and overwritten (a torch slice would be a view of
    the slot), and splices into another slot bit for bit, with ``pos`` set
    and no leaf reassigned; equal to the JAX seam's extraction."""
    cfg = get_config("olmo-1b").reduced()
    kv = SlotKVCache(cfg, 3, 16, kv_store=store, device="cpu")
    ptrs = {n: t.data_ptr() for n, t in kv.cache.items()}
    gen = torch.Generator().manual_seed(0)
    _fill(kv, gen)
    s0, s1 = kv.alloc(), kv.alloc()
    want = {n: t[:, s0, :10].clone() for n, t in kv.cache.items()
            if n in POSITIONAL_LEAVES}
    seg = kv.extract_prefix(s0, 10)
    assert set(seg["kv"]) == set(want) and seg["state"] == {}
    jkv = JSlotKVCache(ARCHS["olmo-1b"].reduced(), 3, 16, kv_store=store)
    jkv.cache = {n: jnp.asarray(t.numpy()) for n, t in kv.cache.items()}
    jseg = jkv.extract_prefix(s0, 10)
    for name in want:
        np.testing.assert_array_equal(seg["kv"][name].numpy(),
                                      np.asarray(jseg["kv"][name]))
    kv.free(s0)
    assert kv.alloc() == s0
    _fill(kv, gen)                       # the next occupant writes its row
    for name, t in want.items():
        assert torch.equal(seg["kv"][name], t), name
    kv.splice_prefix(s1, seg, 10)
    assert int(kv.cache["pos"][s1]) == 10
    for name, t in want.items():
        assert torch.equal(kv.cache[name][:, s1, :10], t), name
    assert {n: t.data_ptr() for n, t in kv.cache.items()} == ptrs


def test_splice_of_a_slot_onto_itself_only_sets_pos(monkeypatch):
    """A chunk run on ``slot_view`` wrote the slot in place: its splice
    writes ``pos`` and copies nothing onto the memory it reads from."""
    cfg = get_config("olmo-1b").reduced()
    kv = SlotKVCache(cfg, 3, 16, kv_store="int8", device="cpu")
    slot = kv.alloc()
    view = kv.slot_view(slot)
    assert all(v.data_ptr() == kv.cache[n][:, slot].data_ptr()
               if v.ndim > 1 else True for n, v in view.items())
    writes = []
    setitem = torch.Tensor.__setitem__

    def spy(self, idx, value):
        writes.append(tuple(self.shape))
        return setitem(self, idx, value)

    monkeypatch.setattr(torch.Tensor, "__setitem__", spy)
    kv.splice(view, [slot], [7])
    monkeypatch.undo()
    assert writes == [tuple(kv.cache["pos"].shape)]
    assert int(kv.cache["pos"][slot]) == 7


def test_compact_carries_slot_meta():
    cfg = get_config("olmo-1b").reduced()
    kv = SlotKVCache(cfg, 4, 8, device="cpu")
    slots = [kv.alloc() for _ in range(4)]
    for s in slots:
        kv.slot_meta[s]["tag"] = s
    kv.free(0)
    kv.free(1)
    moves = kv.compact()
    assert moves == {3: 0, 2: 1}
    assert {s: m["tag"] for s, m in kv.slot_meta.items()} == {0: 3, 1: 2}


# --------------------------------------------------------------------------
# the engine against the JAX engine
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("olmo-1b", MOE):
        tcfg = get_config(arch).reduced()
        tparams = lm.init_lm(tcfg, seed=0, device="cpu")
        out[arch] = (ARCHS[arch].reduced(), _jax_tree(tparams), tcfg,
                     tparams)
    return out


def _shared_prefix_prompts(n=6, prefix_len=18):
    shared = list(range(10, 10 + prefix_len))
    return [np.asarray(shared + [100 + 7 * i, 40 + i], np.int32)
            for i in range(n)]


def _serve(eng, make_req, prompts, new_tokens):
    reqs = [make_req(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return {r.rid: list(r.generated) for r in reqs}


_JAX_RUNS: dict = {}

PREFIX_CASES = [("olmo-1b", "fp", None), ("olmo-1b", "int8", None),
                ("olmo-1b", "int4", 8), (MOE, "fp", None)]


@pytest.mark.parametrize("route", ["eager", "graph"])
@pytest.mark.parametrize("arch,store,chunk", PREFIX_CASES)
def test_prefix_cache_gives_the_jax_engines_tokens_and_savings(
        models, arch, store, chunk, route):
    """Six requests sharing an 18-token prefix on four slots: the second
    wave hits, splices the segments and prefills only its tail; tokens,
    hits and prefill tokens saved equal the JAX engine's, and equal the
    port's own run with the cache off."""
    jcfg, jparams, tcfg, tparams = models[arch]
    prompts = _shared_prefix_prompts()
    kw = dict(batch_slots=4, max_len=MAX_LEN, kv_store=store,
              prefill_chunk=chunk)
    moe_kw = dict(gemv_backend="h100", gemv_expert_shape="ragged") \
        if arch == MOE else {}
    key = (arch, store, chunk)
    if key not in _JAX_RUNS:
        jeng = JaxEngine(jcfg, jparams, prefix_cache=True, **kw)
        _JAX_RUNS[key] = (_serve(jeng, JaxRequest, prompts, 6),
                          dict(jeng.metrics.counters),
                          jeng.prefix.stats())
    want, jcounters, jstats = _JAX_RUNS[key]
    out = {}
    for cache in (True, False):
        eng = Engine(tcfg, tparams, device="cpu", prefix_cache=cache,
                     **kw, **moe_kw)
        if route == "graph":
            _graphed(eng)
        out[cache] = _serve(eng, Request, prompts, 6)
        if cache:
            c = eng.metrics.counters
            for name in ("prefix_hits", "prefix_misses",
                         "prefill_tokens_saved", "prefill_tokens",
                         "prefill_chunks"):
                assert c[name] == jcounters[name], name
            assert c["prefix_hits"] > 0 and c["prefill_tokens_saved"] > 0
            stats = eng.prefix.stats()
            assert {k: stats[k] for k in ("segments", "inserts", "hits")} \
                == {k: jstats[k] for k in ("segments", "inserts", "hits")}
            doc = eng.metrics.to_dict(include_steps=False)
            assert doc["prefix_cache"]["ttft_hit_ms"]["count"] == \
                c["prefix_hits"]
    assert out[True] == out[False] == want


def test_readmission_routes_through_the_prefix_matcher(models):
    """A preemption victim's KV is filed before its slot is freed, so its
    readmission hits and prefills only what was generated since; tokens,
    evictions and savings equal the JAX engine's, and the leaves never
    move under the graph route."""
    jcfg, jparams, tcfg, tparams = models["olmo-1b"]
    out = []
    for side in ("jax", "port"):
        ticks = iter(range(10_000))

        def clock(t=ticks):
            return float(next(t))

        cfg_cls = JSchedulerConfig if side == "jax" else SchedulerConfig
        sched = (JScheduler if side == "jax" else Scheduler)(
            cfg_cls(policy="gemv_aware", preempt_margin=5.0))
        req = JaxRequest if side == "jax" else Request
        if side == "jax":
            eng = JaxEngine(jcfg, jparams, batch_slots=2, max_len=MAX_LEN,
                            scheduler=sched, prefix_cache=True, clock=clock)
        else:
            eng = Engine(tcfg, tparams, batch_slots=2, max_len=MAX_LEN,
                         scheduler=sched, prefix_cache=True, clock=clock,
                         device="cpu")
            _graphed(eng)
        reqs = [req(rid=i, prompt=np.arange(10, 30, dtype=np.int32),
                    max_new_tokens=12) for i in range(2)]
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        urgent = req(rid=9, prompt=np.arange(50, 60, dtype=np.int32),
                     max_new_tokens=4, deadline=eng.clock() + 3.0)
        eng.submit(urgent)
        eng.run_until_drained()
        reqs.append(urgent)
        c = eng.metrics.counters
        out.append(({r.rid: list(r.generated) for r in reqs},
                    [r.evictions for r in reqs],
                    {k: c[k] for k in ("evicted", "prefix_hits",
                                       "prefill_tokens_saved",
                                       "prefill_tokens")}))
    assert out[0] == out[1]
    toks, evictions, counters = out[1]
    assert sum(evictions) == counters["evicted"] >= 1
    assert counters["prefix_hits"] > 0 and counters["prefill_tokens_saved"] > 0
    assert all(len(toks[i]) == 12 for i in (0, 1))


def test_prefix_cache_gating_and_the_cost_hook(models):
    _, _, tcfg, tparams = models["olmo-1b"]
    assert prefix_cacheable(tcfg)
    eng = Engine(tcfg, tparams, batch_slots=2, max_len=MAX_LEN,
                 device="cpu", prefix_cache=True)
    assert eng.prefix is not None and not eng.prefix.has_state
    assert eng.scheduler.prefill_cost is not None
    t = np.arange(10, 30, dtype=np.int32)
    eng.submit(Request(rid=0, prompt=t, max_new_tokens=2))
    eng.run_until_drained()
    r = Request(rid=1, prompt=np.concatenate([t, [5, 6]]).astype(np.int32))
    assert eng.scheduler._cost(r) == 2
    eng2 = Engine(tcfg, tparams, batch_slots=2, max_len=MAX_LEN,
                  device="cpu")
    assert eng2.prefix is None and eng2.scheduler.prefill_cost is None


# --------------------------------------------------------------------------
# the bench document
# --------------------------------------------------------------------------


def _keys(doc, prefix=""):
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("dispatch",):
            out |= _keys(v, prefix + k + ".")
    return out


def test_shared_prefix_bench_document_against_the_reference():
    """``run_serve_trace`` on the shared-prefix trace: the same trace as
    the reference's (its rng draws, in its order), the same fields where
    the reference has them, and equal counters, completions and segment
    statistics (they do not depend on the weights: no stop tokens)."""
    tcfg = bench.TraceConfig(n_requests=8, arrival_rate=0.8,
                             prompt_len_range=(2, 5), max_new_range=(2, 3),
                             kind="shared-prefix", n_tenants=2,
                             prefix_len_range=(10, 14))
    jtcfg = jbench.TraceConfig(**tcfg.__dict__)
    kw = dict(policies=("sjf",), smoke=True, trace_kind="shared-prefix",
              prefix_cache=True, prefill_chunk=4)
    doc = bench.run_serve_trace("olmo-1b", trace_config=tcfg, device="cpu",
                                **kw)
    jdoc = jbench.run_serve_trace("olmo-1b", trace_config=jtcfg, **kw)
    json.dumps(doc)
    assert doc["schema"] == jdoc["schema"] == 4
    assert doc["trace"] == jdoc["trace"]
    for k in ("arch", "reduced", "prefix_cache", "kv_store"):
        assert doc[k] == jdoc[k], k
    run, jrun = doc["runs"][0], jdoc["runs"][0]
    dropped = {"mesh", "async_prefill", "overlap_collectives"}
    port_only = {"prefill_chunk", "decode_tokens_per_s",
                 "counters.decode_tokens"}
    # every field of the reference's run document is in the port's
    assert _keys(jrun) - dropped <= _keys(run)
    assert _keys(run) - _keys(jrun) <= port_only
    assert run["schema"] == jrun["schema"] == 3
    for k in ("policy", "batch_slots", "gemv_batch_threshold", "completed",
              "total_generated", "kv_store", "prefix_index"):
        assert run[k] == jrun[k], k
    jc = dict(jrun["counters"])
    assert {k: v for k, v in run["counters"].items()
            if k != "decode_tokens"} == jc
    assert run["prefix_cache"]["hits"] > 0
    assert run["prefix_cache"]["prefill_tokens_saved"] == \
        jrun["prefix_cache"]["prefill_tokens_saved"] > 0
    # the same trace from the same seed
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    t, jt = (bench.build_trace(tcfg, 256, rng),
             jbench.build_trace(jtcfg, 256, jrng))
    assert [(e["arrival_step"], e["prompt"].tolist(), e["max_new_tokens"],
             e["tenant"]) for e in t] == [
        (e["arrival_step"], e["prompt"].tolist(), e["max_new_tokens"],
         e["tenant"]) for e in jt]


def test_bench_cli_writes_its_document(tmp_path, capsys):
    out = tmp_path / "serve.json"
    assert bench.main(["--smoke", "--device", "cpu", "--policy",
                       "gemv_aware", "--trace", "shared-prefix",
                       "--prefix-cache", "--prefill-chunk", "8",
                       "--kv-store", "int8", "--json", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert [r["policy"] for r in doc["runs"]] == ["gemv_aware"]
    assert doc["runs"][0]["kv_store"] == "int8"
    assert doc["runs"][0]["prefix_cache"]["hits"] > 0
    assert "serve/gemv_aware" in capsys.readouterr().out
