"""The decode step as one captured graph per bucket, on the CPU.

A CUDA graph needs the card, so here ``Recorder`` stands in for
``CudaCapture``.  Its capture runs the step's body as a real capture does
-- the Python runs, so host-side counters tick -- and then puts back every
tensor the body wrote (the KV cache and the static logits), since a real
capture executes nothing; its replay calls the body with the counters put
back as they were, since a real replay runs no Python.  Through it the
port's ``Engine`` takes the graph route -- the eager first step at each
bucket, the capture, then replays over the static token and logits
buffers -- and must give the JAX ``Engine``'s greedy tokens: dense and
MoE reduced configs, fp / int8 / int4 KV, bucket changes and compaction.

The MoE repair that makes the step capturable off the programs (the
capacity einsum at decode, no host read) is held against the JAX
``apply_moe`` at 1e-5 absolute (f32 on both sides, sums in other
orders).
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as JScheduler  # noqa: E402
from repro.serving.scheduler import \
    SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.backends import DispatchPolicy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import disable_graphs  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    Scheduler,
    SchedulerConfig,
)
from repro_torch.serving.step_graph import DecodeGraphs  # noqa: E402

MOE_ATOL = 1e-5
MAX_LEN = 64
ARCHS_UNDER_TEST = ("olmo-1b", "deepseek-moe-16b")


def _jax_tree(tparams):
    """The port's params as the JAX package's tree (layers stacked)."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return jnp.asarray(node.numpy())

    stacked = jax.tree.map(lambda *ls: np.stack(ls),
                           *[jax.tree.map(lambda t: t.numpy(), lp)
                             for lp in tparams["layers"]])
    tree = {"embed": conv(tparams["embed"]), "ln_f": conv(tparams["ln_f"]),
            "layers": jax.tree.map(jnp.asarray, stacked)}
    if "lm_head" in tparams:
        tree["lm_head"] = conv(tparams["lm_head"])
    return tree


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS_UNDER_TEST:
        tcfg = get_config(arch).reduced()
        tparams = lm.init_lm(tcfg, seed=0, device="cpu")
        out[arch] = (ARCHS[arch].reduced(), _jax_tree(tparams), tcfg,
                     tparams)
    return out


@contextlib.contextmanager
def _counters_kept():
    """Put the dispatcher's counters back as they were on exit."""
    counters = copy.deepcopy(dispatch._DISPATCH_COUNTERS)
    cache = dict(dispatch._CACHE_STATS)
    try:
        yield
    finally:
        dispatch._DISPATCH_COUNTERS.clear()
        dispatch._DISPATCH_COUNTERS.update(counters)
        dispatch._CACHE_STATS.update(cache)


@contextlib.contextmanager
def _tensors_kept(tensors):
    """Put the values of ``tensors`` back as they were on exit."""
    saved = [t.clone() for t in tensors]
    try:
        yield
    finally:
        for t, v in zip(tensors, saved):
            t.copy_(v)


class Recorder:
    """``CudaCapture``'s stand-in: ``warm`` runs the body; ``capture`` runs
    its Python and undoes its writes to ``state`` (a capture records and
    executes nothing); a replay runs it with the counters kept."""

    def __init__(self, state):
        self.state = state
        self.warmed = self.captured = self.replayed = 0

    def warm(self, body):
        self.warmed += 1
        body()

    def capture(self, body):
        self.captured += 1
        with _tensors_kept(self.state):
            body()

        def replay():
            self.replayed += 1
            with _counters_kept():
                body()

        return replay


def _graphed(eng: Engine) -> Recorder:
    """Put ``eng`` (on the CPU) on the graph route through a Recorder; the
    graphs read the engine's modality features as its own graphs do."""
    eng.graphs = DecodeGraphs(eng._decode_body, eng.kv.cache,
                              slots=eng.slots, vocab=eng.cfg.vocab,
                              device=eng.device, capture=None,
                              inputs=eng.features)
    rec = eng.graphs.capture = Recorder(
        [*eng.kv.cache.values(), *eng.features.values(),
         eng.graphs.logits])
    return rec


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


# (prompt lengths, max_new_tokens per request, step at which each request
# is submitted): requests that join mid-decode, one that finishes at
# prefill, and tokens that make the bucket shrink 4 -> 2 -> 1 with the
# low slots freed first (compaction moves the survivors down)
SCENARIOS = {
    "mixed": ([5, 9, 3, 12, 7], [6] * 5, [0] * 5),
    "finish_at_prefill": ([6, 4, 8], [1, 5, 4], [0, 0, 0]),
    "join_mid_decode": ([5, 9, 3, 12, 7], [6, 6, 7, 5, 4], [0, 0, 2, 3, 5]),
    "shrink_4_2_1": ([7, 4, 9, 5], [2, 3, 5, 8], [0] * 4),
}


def _drive(eng, make_req, prompts, new_tokens, joins):
    """Submit each request at its step, then step until drained (chunked
    prefills included); returns {rid: generated}."""
    done, pending, step = {}, list(range(len(prompts))), 0
    while pending or eng.active or eng._prefilling or eng.scheduler.queue:
        for i in [i for i in pending if joins[i] <= step]:
            eng.submit(make_req(rid=i, prompt=prompts[i],
                                max_new_tokens=new_tokens[i]))
            pending.remove(i)
        done.update({r.rid: list(r.generated) for r in eng.step()})
        step += 1
        assert step < 200
    return done


def _both(models, arch, scenario, **kw):
    jcfg, jparams, tcfg, tparams = models[arch]
    lengths, new_tokens, joins = SCENARIOS[scenario]
    prompts = _prompts(jcfg.vocab, lengths)
    jkw = {k: v for k, v in kw.items() if k != "gemv_backend"}
    jeng = JaxEngine(jcfg, jparams, batch_slots=4, max_len=MAX_LEN, **jkw)
    teng = Engine(tcfg, tparams, batch_slots=4, max_len=MAX_LEN,
                  device="cpu", **kw)
    rec = _graphed(teng)
    jdone = _drive(jeng, JaxRequest, prompts, new_tokens, joins)
    tdone = _drive(teng, Request, prompts, new_tokens, joins)
    return jdone, tdone, teng, rec


CASES = ([("olmo-1b", s, {}) for s in SCENARIOS]
         + [("olmo-1b", "mixed", {"kv_store": "int8"}),
            ("olmo-1b", "shrink_4_2_1", {"kv_store": "int4"}),
            ("deepseek-moe-16b", "mixed",
             {"gemv_backend": "h100", "gemv_expert_shape": "ragged"}),
            ("deepseek-moe-16b", "shrink_4_2_1",
             {"gemv_backend": "h100", "gemv_expert_shape": "grouped"})])


@pytest.mark.parametrize("arch,scenario,kw", CASES,
                         ids=[f"{a}-{s}-{'-'.join(map(str, k.values()))}"
                              for a, s, k in CASES])
def test_graph_route_gives_the_jax_engines_tokens(models, arch, scenario,
                                                  kw):
    jdone, tdone, teng, rec = _both(models, arch, scenario, **kw)
    assert sorted(tdone) == list(range(len(SCENARIOS[scenario][0])))
    assert tdone == jdone
    buckets = {st["decode_batch"] for st in teng.metrics.steps
               if st["decode_batch"]}
    # one eager step and one capture per bucket, replays for the rest
    assert rec.warmed == rec.captured == len(buckets)
    assert set(teng.graphs.replays) == buckets
    steps = teng.metrics.counters["decode_steps"]
    assert rec.replayed == steps - len(buckets) > 0
    if scenario == "shrink_4_2_1":
        assert buckets == {4, 2, 1}


def test_the_shrinking_scenario_compacts_between_graph_steps(models):
    """The bucket shrinks as low slots free: compaction moves the
    survivors down in place and the graphs go on reading the same
    leaves."""
    _, _, tcfg, tparams = models["olmo-1b"]
    lengths, new_tokens, _ = SCENARIOS["shrink_4_2_1"]
    eng = Engine(tcfg, tparams, batch_slots=4, max_len=MAX_LEN, device="cpu")
    _graphed(eng)
    moved = []
    compact = eng.kv.compact

    def spy():
        moves = compact()
        moved.extend(moves.items())
        return moves

    eng.kv.compact = spy
    for i, p in enumerate(_prompts(tcfg.vocab, lengths)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens[i]))
    eng.run_until_drained()
    assert moved and all(src > dst for src, dst in moved)


@pytest.mark.parametrize("graphs", [True, False])
def test_pos_advances_exactly_once_per_step(models, graphs):
    """After every engine step each active slot's ``pos`` is its prompt
    plus the tokens it has decoded: the eager first step at a bucket
    advances it, the capture does not, every replay does."""
    _, _, tcfg, tparams = models["olmo-1b"]
    lengths, new_tokens, joins = SCENARIOS["join_mid_decode"]
    eng = Engine(tcfg, tparams, batch_slots=4, max_len=MAX_LEN, device="cpu")
    rec = _graphed(eng) if graphs else None
    prompts = _prompts(tcfg.vocab, lengths)
    pending = list(range(len(prompts)))
    for step in range(60):
        for i in [i for i in pending if joins[i] <= step]:
            eng.submit(Request(rid=i, prompt=prompts[i],
                               max_new_tokens=new_tokens[i]))
            pending.remove(i)
        eng.step()
        pos = eng.kv.cache["pos"]
        for slot, r in eng.active.items():
            assert int(pos[slot]) == len(r.prompt) + len(r.generated) - 1
        if not pending and not eng.active and not eng.scheduler.queue:
            break
    assert not eng.active
    if graphs:
        assert rec.replayed > 0 and rec.captured >= 2


def test_counters_tick_at_the_warm_step_and_capture_never_at_replay(
        models):
    """MoE ragged: ``record_expert_load`` runs once an MoE layer each time
    Python runs the step's body -- twice at a new bucket (the eager step
    and the capture), never at a replay.  Eagerly it runs every step."""
    _, _, tcfg, tparams = models["deepseek-moe-16b"]
    lengths, new_tokens, joins = SCENARIOS["shrink_4_2_1"]
    prompts = _prompts(tcfg.vocab, lengths)
    per_step = {}
    for route in ("graph", "eager"):
        eng = Engine(tcfg, tparams, batch_slots=4, max_len=MAX_LEN,
                     device="cpu", gemv_backend="h100")
        if route == "graph":
            _graphed(eng)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p,
                               max_new_tokens=new_tokens[i]))
        eng.run_until_drained()
        per_step[route] = [(st["decode_batch"],
                            st["dispatch"]["expert_load"]["decisions"])
                           for st in eng.metrics.steps if st["decode_batch"]]
    n = sum("moe" in layer for layer in tparams["layers"])
    seen, want = set(), []
    for b, _ in per_step["graph"]:
        want.append(0 if b in seen else 2 * n)
        seen.add(b)
    # the per-step deltas are cumulative since the engine started
    got = np.diff([0] + [d for _, d in per_step["graph"]]).tolist()
    assert got == want
    assert seen == {4, 2, 1} and want.count(0) > 0
    got = np.diff([0] + [d for _, d in per_step["eager"]]).tolist()
    assert got == [n] * len(per_step["eager"])


def test_skew_estimate_ignores_empty_deltas():
    """A replayed step adds nothing to ``expert_load``: an empty (or
    all-zero) delta leaves the skew estimate, and so admission, as it
    was."""
    load = {"decisions": 2, "routed_tokens": 16, "experts": 16,
            "max_tokens": 6, "padded_slots": 0}
    zeros = dict.fromkeys(load, 0)
    for sched_cls, cfg_cls in ((Scheduler, SchedulerConfig),
                               (JScheduler, JSchedulerConfig)):
        s = sched_cls(cfg_cls(policy="gemv_aware", gemv_batch_threshold=4,
                              moe_experts=8, moe_top_k=2))
        caps = [s._admission_cap(4, a) for a in range(4)]
        for delta in ({}, zeros):
            s.observe_expert_load(delta)
            assert s._observed_skew is None
            assert [s._admission_cap(4, a) for a in range(4)] == caps
        s.observe_expert_load(load)
        skew = s._observed_skew
        caps = [s._admission_cap(4, a) for a in range(4)]
        for delta in ({}, zeros):
            s.observe_expert_load(delta)
            assert s._observed_skew == skew
            assert [s._admission_cap(4, a) for a in range(4)] == caps


def test_gemv_aware_admission_on_the_graph_route_matches_jax(models):
    """The JAX engine records the expert load at trace time, once a
    bucket; the graph route at the eager step and the capture, the same
    ratio.  So the skew estimate, admission and tokens equal the JAX
    engine's."""
    jcfg, jparams, tcfg, tparams = models["deepseek-moe-16b"]
    lengths, new_tokens, joins = SCENARIOS["join_mid_decode"]
    prompts = _prompts(jcfg.vocab, lengths)
    jeng = JaxEngine(jcfg, jparams, batch_slots=4, max_len=MAX_LEN,
                     scheduler="gemv_aware", gemv_batch_threshold=4)
    teng = Engine(tcfg, tparams, batch_slots=4, max_len=MAX_LEN,
                  device="cpu", scheduler="gemv_aware",
                  gemv_batch_threshold=4, gemv_backend="h100")
    _graphed(teng)
    jdone = _drive(jeng, JaxRequest, prompts, new_tokens, joins)
    tdone = _drive(teng, Request, prompts, new_tokens, joins)
    assert tdone == jdone
    assert teng.scheduler._observed_skew is not None
    assert teng.scheduler._observed_skew == pytest.approx(
        jeng.scheduler._observed_skew, rel=1e-12)


def test_a_replay_raises_when_a_cache_leaf_moved(models):
    _, _, tcfg, tparams = models["olmo-1b"]
    eng = Engine(tcfg, tparams, batch_slots=2, max_len=MAX_LEN, device="cpu")
    rec = _graphed(eng)
    for i, p in enumerate(_prompts(tcfg.vocab, [5, 7])):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=8))
    eng.step()
    eng.step()
    assert rec.captured == 1 and rec.replayed == 1
    eng.kv.cache["k"] = eng.kv.cache["k"].clone()
    with pytest.raises(RuntimeError, match="reassigned"):
        eng.step()
    assert rec.replayed == 1


def test_disable_graphs_runs_the_step_eagerly(models):
    """Inside ``disable_graphs()`` the engine skips its graphs; the
    tokens are the graph route's."""
    _, _, tcfg, tparams = models["olmo-1b"]
    prompts = _prompts(tcfg.vocab, [5, 9, 3])
    done = {}
    for route in ("graph", "eager"):
        eng = Engine(tcfg, tparams, batch_slots=4, max_len=MAX_LEN,
                     device="cpu")
        rec = _graphed(eng)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
        ctx = disable_graphs() if route == "eager" else \
            contextlib.nullcontext()
        with ctx:
            done[route] = {r.rid: r.generated
                           for r in eng.run_until_drained()}
        assert (rec.warmed > 0) == (route == "graph")
    assert done["graph"] == done["eager"]


def test_the_cpu_engine_takes_the_eager_route(models):
    _, _, tcfg, tparams = models["olmo-1b"]
    eng = Engine(tcfg, tparams, device="cpu")
    assert eng.graphs is None


# --------------------------------------------------------------------------
# the MoE decode off the programs: capturable, against the JAX apply_moe
# --------------------------------------------------------------------------


@pytest.mark.parametrize("gemv", ["none", "unfused", "einsum"])
def test_capacity_decode_matches_jax_and_reads_nothing_back(models,
                                                            monkeypatch,
                                                            gemv):
    """``apply_moe`` at one token a sequence with no dispatcher, fusing
    off, or ``expert_shape="einsum"``: the capacity einsum, equal to the
    JAX ``apply_moe`` within 1e-5, with every host read refused."""
    jcfg, jparams, tcfg, tparams = models["deepseek-moe-16b"]
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])["moe"]
    tp = tparams["layers"][0]["moe"]
    pol = {"none": None,
           "unfused": DispatchPolicy(backend="h100", fuse_programs=False),
           "einsum": DispatchPolicy(backend="h100", expert_shape="einsum")}
    x = np.random.default_rng(11).standard_normal(
        (4, 1, tcfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: jL.apply_moe(p, x, jcfg))(
        jp, jnp.asarray(x))
    xt = torch.from_numpy(x)
    L.apply_moe(tp, xt, tcfg, gemv=pol[gemv])        # plan caches warm

    def refuse(*a, **k):
        raise AssertionError("host read of a tensor value")

    for name in ("item", "tolist", "numpy", "cpu", "__int__", "__index__",
                 "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    y, aux = L.apply_moe(tp, xt, tcfg, gemv=pol[gemv])
    monkeypatch.undo()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=MOE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-7, rtol=0)


@pytest.mark.parametrize("opts", [dict(use_pim_kernels=False),
                                  dict(gemv_fuse_programs=False),
                                  dict(gemv_expert_shape="einsum")])
def test_moe_engine_off_the_programs_on_the_graph_route(models, opts):
    """The MoE engine whose decode takes the capacity einsum gives the
    JAX engine's tokens through the graph route."""
    jcfg, jparams, tcfg, tparams = models["deepseek-moe-16b"]
    lengths, new_tokens, joins = SCENARIOS["mixed"]
    prompts = _prompts(jcfg.vocab, lengths)
    jeng = JaxEngine(jcfg, jparams, batch_slots=4, max_len=MAX_LEN, **opts)
    teng = Engine(tcfg, tparams, batch_slots=4, max_len=MAX_LEN,
                  device="cpu", **opts)
    rec = _graphed(teng)
    jdone = _drive(jeng, JaxRequest, prompts, new_tokens, joins)
    dispatch.clear_plan_cache()
    tdone = _drive(teng, Request, prompts, new_tokens, joins)
    assert tdone == jdone
    assert rec.replayed > 0
    assert dispatch.dispatch_stats()["expert_load"]["decisions"] == 0
