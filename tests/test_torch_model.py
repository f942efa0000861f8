"""The port's model, dispatcher and engine against the JAX package.

Both packages get the same weights (the JAX ``init_lm`` tree, handed to
the port through numpy by ``repro_torch.bridge``) and the same numpy
prompts.  Everything here runs on the CPU: the port's kernel wrappers take
their plain versions on CPU tensors, and the JAX side runs its Pallas
kernels in interpret mode where a kernel is pinned.
"""

import dataclasses

import numpy as np
import pytest
import torch

# One intra-op thread: the suite runs in parallel worker processes, and
# these small CPU tensors gain nothing from more threads.
torch.set_num_threads(1)

# the machine with the card has no JAX: there this file skips
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS
from repro.kernels import dispatch as jdispatch
from repro.models import lm as jlm
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs.registry import get_config
from repro_torch.kernels import dispatch
from repro_torch.kernels.backends import DispatchPolicy
from repro_torch.kernels.pim_gemv import pim_gemv
from repro_torch.kernels.splitk_gemv import splitk_gemv
from repro_torch.models import lm
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.kv_cache import SlotKVCache
from repro_torch.serving.sampling import SamplingParams, sample_token
from repro_torch.serving.scheduler import QueueFull, Scheduler, \
    SchedulerConfig

# f32 on both sides; the sums run in different orders (XLA vs ATen)
ATOL = 1e-4
MAX_LEN = 64


def _cfgs(**overrides):
    jcfg = dataclasses.replace(ARCHS["olmo-1b"].reduced(), **overrides)
    tcfg = dataclasses.replace(get_config("olmo-1b").reduced(), **overrides)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, L).astype(np.int32) for L in lengths]


def test_reduced_config_matches_the_jax_package():
    jcfg, tcfg = _cfgs()
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.hd == jcfg.hd


def test_forward_prefill_and_decode_logits_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (3, 9))
    toks = toks.astype(np.int32)
    jc = jlm.init_cache(jcfg, 3, 32, per_slot_pos=True)
    tc = lm.init_cache(tcfg, 3, 32, per_slot_pos=True, device="cpu")
    jl, jc, _ = jlm.forward(jparams, jcfg, jnp.asarray(toks), cache=jc)
    tl, tc, _ = lm.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                           cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    # two decode steps: the plain path, then the dispatcher on prepacked
    # weights (CPU backends on both sides)
    jpp = jlm.prepack_decode_params(jparams, jcfg)
    tpp = lm.prepack_decode_params(tparams, tcfg)
    for step, (jpol, tpol) in enumerate([
            (None, None),
            (jdispatch.DispatchPolicy(), DispatchPolicy())]):
        nxt = np.array(jl[:, -1:].argmax(-1), np.int32)
        jl, jc, _ = jlm.forward(jpp, jcfg, jnp.asarray(nxt), cache=jc,
                                gemv_policy=jpol)
        tl, tc, _ = lm.forward(tpp, tcfg, torch.from_numpy(nxt).long(),
                               cache=tc, gemv_policy=tpol)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"decode step {step}")
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=0)


def test_forward_without_cache_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 5))
    jl, _, _ = jlm.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32))
    tl, cache, _ = lm.forward(tparams, tcfg, torch.from_numpy(toks))
    assert cache is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("kernel", ["pim", "splitk"])
def test_decode_step_through_each_kernel_matches_jax(kernel, fuse):
    """One decode step with the kernel pinned on both sides: the JAX TPU
    backend in interpret-mode Pallas, the port's h100 backend on CPU
    tensors (the wrappers' plain versions, which run the kernels' input
    checks).  Widths are multiples of 128 so the TPU kernels apply.
    Unfused, QKV is a plain einsum and gate, up and down are single
    GEMVs, as in the JAX package."""
    jcfg, tcfg = _cfgs(d_model=256, n_heads=2, n_kv_heads=2, head_dim=128,
                       d_ff=512, vocab=512)
    jparams = jlm.init_lm(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 6))
    toks = toks.astype(np.int32)
    nxt = toks[:, -1:] + 1
    jc = jlm.init_cache(jcfg, 2, 16, per_slot_pos=True)
    tc = lm.init_cache(tcfg, 2, 16, per_slot_pos=True, device="cpu")
    _, jc, _ = jlm.forward(jparams, jcfg, jnp.asarray(toks), cache=jc)
    _, tc, _ = lm.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                          cache=tc)

    jdispatch.clear_plan_cache()
    jpol = jdispatch.DispatchPolicy(backend="tpu", min_pallas_bytes=0,
                                    kernel=kernel, fuse_programs=fuse)
    jl, _, _ = jlm.forward(jlm.prepack_decode_params(jparams, jcfg), jcfg,
                           jnp.asarray(nxt), cache=jc, gemv_policy=jpol)
    assert jdispatch.dispatch_stats()["kernel_picks"].get(
        f"tpu:{kernel}", 0) > 0

    dispatch.clear_plan_cache()
    launches = (pim_gemv.launches, splitk_gemv.launches)
    tpol = DispatchPolicy(backend="h100", min_pallas_bytes=0, kernel=kernel,
                          fuse_programs=fuse)
    tl, _, _ = lm.forward(lm.prepack_decode_params(tparams, tcfg), tcfg,
                          torch.from_numpy(nxt).long(), cache=tc,
                          gemv_policy=tpol)
    stats = dispatch.dispatch_stats()
    # two single-request shapes: fused, down and the head; unfused,
    # [256 -> 512] (gate, up, head) and down
    assert stats["kernel_picks"] == {f"h100:{kernel}": 2}
    assert stats["program_modes"] == ({"h100:fused": 2} if fuse else {})
    # CPU tensors take the plain versions: no kernel launched
    assert (pim_gemv.launches, splitk_gemv.launches) == launches
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)


def test_engine_mixed_prompt_lengths_token_identical_to_jax(models):
    """The JAX serving test's mixed-length scenario: greedy tokens of the
    port's Engine equal the JAX Engine's, request by request."""
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(jcfg.vocab, [5, 9, 3, 12, 7])
    jeng = JaxEngine(jcfg, jparams, batch_slots=4, max_len=MAX_LEN)
    teng = Engine(tcfg, tparams, batch_slots=4, max_len=MAX_LEN,
                  device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=6))
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    jdone = {r.rid: r.generated for r in jeng.run_until_drained()}
    tdone = {r.rid: r.generated for r in teng.run_until_drained()}
    assert sorted(tdone) == list(range(5))
    assert tdone == jdone
    assert teng.metrics.counters["tokens_out"] == 5 * 6
    assert teng.kv.n_active == 0


@pytest.mark.parametrize("opts", [dict(use_pim_kernels=False),
                                  dict(gemv_fuse_programs=False),
                                  dict(gemv_batch_threshold=1)])
def test_engine_tokens_do_not_depend_on_the_gemv_path(models, opts):
    """Greedy tokens with the dispatcher off, unfused, or pushed to
    ``ref`` by the batch gate equal the default engine's."""
    jcfg, _, tcfg, tparams = models
    prompts = _prompts(jcfg.vocab, [6, 11, 4], seed=7)
    done = []
    for kw in ({}, opts):
        eng = Engine(tcfg, tparams, batch_slots=4, max_len=MAX_LEN,
                     device="cpu", **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
        done.append({r.rid: r.generated for r in eng.run_until_drained()})
    assert done[0] == done[1]


def test_engine_with_no_device_raises_without_cuda(models, monkeypatch):
    _, _, tcfg, tparams = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(tcfg, tparams)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_lm(tcfg)


def test_engine_rejects_params_on_another_device(models):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="params live on"):
        Engine(tcfg, tparams, device="meta")


def test_init_lm_is_seeded_with_the_reference_scale():
    _, tcfg = _cfgs()
    a = lm.init_lm(tcfg, seed=5, device="cpu")
    b = lm.init_lm(tcfg, seed=5, device="cpu")
    torch.testing.assert_close(a["layers"][1]["mlp"]["w_down"],
                               b["layers"][1]["mlp"]["w_down"], rtol=0,
                               atol=0)
    w = a["layers"][0]["mlp"]["w_down"]            # fan_in = d_ff
    assert w.shape == (tcfg.d_ff, tcfg.d_model)
    assert abs(w.std().item() * tcfg.d_ff ** 0.5 - 1.0) < 0.1
    assert a["ln_f"] == {} and len(a["layers"]) == tcfg.n_layers


def test_prepack_builds_contiguous_fused_weights(models):
    _, _, tcfg, tparams = models
    packed = lm.prepack_decode_params(tparams, tcfg)
    a, m = packed["layers"][0]["attn"], packed["layers"][0]["mlp"]
    assert a["wqkv"].is_contiguous() and m["w_gateup"].is_contiguous()
    assert packed["head_t"].is_contiguous()
    torch.testing.assert_close(packed["head_t"], tparams["embed"].t())
    orig = tparams["layers"][0]
    torch.testing.assert_close(a["wqkv"][:, -tcfg.n_kv_heads * tcfg.hd:],
                               orig["attn"]["wv"].reshape(tcfg.d_model, -1))
    torch.testing.assert_close(m["w_gateup"][:, tcfg.d_ff:],
                               orig["mlp"]["w_up"])
    # the originals stay (contiguous, for prefill and unfused decode)
    assert m["w_up"] is orig["mlp"]["w_up"]
    assert "wqkv" not in orig["attn"]


def test_kv_write_clamps_like_dynamic_update_slice():
    from repro_torch.models.layers import write_kv

    cache = torch.zeros(2, 8, 1, 1)
    new = torch.ones(2, 3, 1, 1) * torch.tensor([1.0, 2.0])[:, None, None,
                                                            None]
    write_kv(cache, new, torch.tensor([2, 7]))   # row 1 would run past 8
    ref = jax.vmap(lambda c, u, p: jax.lax.dynamic_update_slice_in_dim(
        c, u, p, axis=0))(jnp.zeros((2, 8, 1, 1)), jnp.asarray(new.numpy()),
                          jnp.asarray([2, 7]))
    np.testing.assert_array_equal(cache.numpy(), np.asarray(ref))


def test_slot_cache_alloc_splice_compact():
    _, tcfg = _cfgs()
    kv = SlotKVCache(tcfg, 4, 16, device="cpu")
    slots = [kv.alloc() for _ in range(3)]
    assert slots == [0, 1, 2] and kv.n_free == 1
    sub = lm.init_cache(tcfg, 2, 16, per_slot_pos=True, device="cpu")
    sub["k"] += 1.0
    kv.splice(sub, [1, 2], [5, 7])
    assert kv.kv_valid_len().tolist() == [0, 5, 7, 0]
    kv.free(0)
    assert kv.compact() == {2: 0}
    assert kv.active_slots() == (0, 1)
    assert kv.kv_valid_len().tolist()[:2] == [7, 5]
    assert float(kv.cache["k"][:, 0].min()) == 1.0
    # a bucket decoded through slice_prefix views needs no copy back
    view = kv.slice_prefix(2)
    view["k"][:, 0, 0] = 9.0
    kv.merge_prefix({**view, "pos": view["pos"] + 1}, 2)
    assert float(kv.cache["k"][0, 0, 0].max()) == 9.0
    assert kv.kv_valid_len().tolist()[:2] == [8, 6]
    with pytest.raises(ValueError):
        kv.free(3)


def test_decode_bucket_is_pow2_clamped_to_the_gemv_threshold(models):
    _, _, tcfg, tparams = models
    eng = Engine(tcfg, tparams, batch_slots=8, max_len=MAX_LEN,
                 gemv_batch_threshold=6, device="cpu")
    for _ in range(5):
        eng.kv.alloc()
    assert eng.decode_bucket() == 6     # pow2 would be 8 > threshold
    eng.kv.alloc()
    eng.kv.alloc()
    assert eng.decode_bucket() == 8     # 7 actives exceed the threshold


def test_engine_stops_on_eos_and_respects_max_len(models):
    jcfg, _, tcfg, tparams = models
    eng = Engine(tcfg, tparams, batch_slots=2, max_len=12, device="cpu")
    p = _prompts(jcfg.vocab, [4, 10], seed=4)
    eng.submit(Request(rid=0, prompt=p[0], max_new_tokens=50))
    eng.submit(Request(rid=1, prompt=p[1], max_new_tokens=50))
    done = {r.rid: r for r in eng.run_until_drained()}
    assert len(done[0].generated) == 12 - 4
    assert len(done[1].generated) == 12 - 10
    first = done[0].generated[0]
    eng.submit(Request(rid=2, prompt=p[0], max_new_tokens=50,
                       eos_ids={first}))
    (r,) = eng.run_until_drained()
    assert r.generated == [first] and r.done
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(rid=3, prompt=np.zeros(13, np.int32)))


def test_scheduler_policies_backpressure_and_expiry():
    def req(rid, n, deadline=None):
        return Request(rid=rid, prompt=np.zeros(n, np.int32),
                       deadline=deadline)

    s = Scheduler(SchedulerConfig(policy="sjf", max_queue=3))
    for rid, n in ((0, 9), (1, 3), (2, 5)):
        s.submit(req(rid, n))
    with pytest.raises(QueueFull):
        s.submit(req(3, 1))
    assert [r.rid for r in s.select(2, 0)] == [1, 2]
    g = Scheduler(SchedulerConfig(policy="gemv_aware",
                                  gemv_batch_threshold=4))
    for rid in range(6):
        g.submit(req(rid, 6 - rid))
    assert [r.rid for r in g.select(8, 1)] == [5, 4, 3]
    f = Scheduler(SchedulerConfig(policy="fcfs"))
    f.submit(req(0, 2, deadline=1.0))
    f.submit(req(1, 2))
    assert [r.rid for r in f.expire(1.0)] == [0]
    assert [r.rid for r in f.select(4, 0)] == [1]
    with pytest.raises(ValueError):
        SchedulerConfig(policy="lifo")


def test_sampling_matches_the_jax_package():
    from repro.serving.sampling import SamplingParams as JaxSampling
    from repro.serving.sampling import sample_token as jax_sample

    rng = np.random.default_rng(5)
    for _ in range(4):
        z = rng.standard_normal(64).astype(np.float32)
        assert sample_token(z) == jax_sample(z) == int(z.argmax())
        sp = dict(temperature=0.8, top_k=10, top_p=0.9, seed=3)
        assert (sample_token(z, SamplingParams(**sp),
                             np.random.default_rng(7))
                == jax_sample(z, JaxSampling(**sp),
                              np.random.default_rng(7)))


def test_bridge_carries_bf16_bits_exactly():
    a = jnp.asarray(np.random.default_rng(6).standard_normal((3, 4)),
                    jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(a), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a, np.float32))


def test_metrics_document(models):
    _, _, tcfg, tparams = models
    eng = Engine(tcfg, tparams, batch_slots=2, max_len=MAX_LEN,
                 device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                       max_new_tokens=3))
    eng.run_until_drained()
    doc = eng.metrics.to_dict()
    assert doc["counters"]["tokens_out"] == 3
    assert doc["counters"]["decode_tokens"] == 2
    assert doc["per_token_ms"]["count"] == 2
    assert doc["decode_tokens_per_s"] > 0
    assert doc["dispatch"]["gemv_path"] >= 0
    eng.metrics.to_json()
