"""rwkv6-3b (the ssm family) against the JAX package, on the CPU.

Both packages get the same weights: the JAX ``init_lm`` tree of the
reduced config, perturbed in numpy and handed to the port through
``repro_torch.bridge``.  The init hides exactly what a port could get
wrong (``u`` is all zeros, every token-shift mix is 0.5, the decay bias a
constant, the group-norm scale all ones, and the tied head echoes the
last token), so every test here draws ``u`` ~ N(0, 1), each ``mu`` row ~
U(0, 1), ``w0`` ~ N(-0.5, 1), ``ln_scale`` ~ U(0.5, 1.5) and scales the
five time-mix projections by 4, and holds logits as well as tokens.

Modules (f32 on both sides, atol and rtol 1e-5, state as well as output):
the time-mix and channel-mix at S 1 with a carried state and at S 7 from
zero and from a state; the whole model's prefill and 4 decode steps;
the cache (no ``k``); the bridge; the family gate (hymba admitted, grok
unregistered).  The engine: greedy tokens and every
sampled row of logits equal the JAX ``Engine``'s (mixed lengths, chunked
prefill, the prefix cache, buckets 4 -> 2 -> 1 through the graph
stand-in), and one test for each latent fault the slice repaired: a
decode step over a row mid-prefill, a first chunk on a freed slot, and a
wave of unequal lengths.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_graphs import _graphed  # noqa: E402
from test_torch_prefix_cache import _consistent, _tree  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.prefix_cache import PrefixCache as JPrefixCache  # noqa
from repro.serving.prefix_cache import \
    PrefixCacheConfig as JPrefixCacheConfig  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import ModelConfig, SSMConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS as TARCHS  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.backends import DispatchPolicy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.prefix_cache import (  # noqa: E402
    PrefixCache,
    PrefixCacheConfig,
)

ARCH = "rwkv6-3b"
# f32 on both sides; the sums run in other orders (XLA vs ATen)
TOL = dict(atol=1e-5, rtol=1e-5)
ATOL = 1e-4       # logits through the whole model and the engine
MAX_LEN = 64
STATE = ("rwkv_s", "rwkv_x_tm", "rwkv_x_cm")


def perturb(tree: dict, seed: int = 0) -> dict:
    """The JAX tree (numpy leaves, layers stacked) with the parameters the
    init hides drawn afresh (module docstring)."""
    rng = np.random.default_rng(seed)
    tm = tree["layers"]["time_mix"]

    def like(a, x):
        return np.asarray(x, np.float32).astype(a.dtype)

    tm["u"] = like(tm["u"], rng.standard_normal(tm["u"].shape))
    tm["mu"] = like(tm["mu"], rng.uniform(0, 1, tm["mu"].shape))
    tm["w0"] = like(tm["w0"], rng.standard_normal(tm["w0"].shape) - 0.5)
    tm["ln_scale"] = like(tm["ln_scale"],
                          rng.uniform(0.5, 1.5, tm["ln_scale"].shape))
    for name in ("wr", "wk", "wv", "wg", "wo"):
        tm[name] = like(tm[name], np.asarray(tm[name], np.float32) * 4)
    cm = tree["layers"]["channel_mix"]
    cm["mu"] = like(cm["mu"], rng.uniform(0, 1, cm["mu"].shape))
    return tree


def _cfgs(**overrides):
    return (dataclasses.replace(ARCHS[ARCH].reduced(), **overrides),
            dataclasses.replace(get_config(ARCH).reduced(), **overrides))


def _pair(seed=0, **overrides):
    """(jcfg, jparams, tcfg, tparams): one perturbed JAX init, both
    packages."""
    jcfg, tcfg = _cfgs(**overrides)
    tree = perturb(jax.tree.map(np.array,
                                jlm.init_lm(jax.random.PRNGKey(seed), jcfg)),
                   seed)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_numpy(tree, tcfg, "cpu"))


@pytest.fixture(scope="module")
def model():
    return _pair()


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


# --------------------------------------------------------------------------
# configs, family gate, cache, bridge
# --------------------------------------------------------------------------


def test_config_matches_the_jax_package_full_and_reduced():
    for j, t in (_cfgs(), (ARCHS[ARCH], get_config(ARCH))):
        for f in dataclasses.fields(t):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert t.attn_free == j.attn_free is True
    tcfg = get_config(ARCH).reduced()
    assert (tcfg.ssm.head_dim, tcfg.ssm.chunk, tcfg.n_heads,
            tcfg.n_kv_heads, tcfg.head_dim) == (32, 16, 0, 0, 0)
    assert tcfg.ssm.state_dim <= 8
    assert get_config(ARCH).source == "arXiv:2404.05892"


def test_hymba_and_grok_are_still_refused():
    """hymba-1.5b itself is admitted (``family="hybrid"`` with parallel
    Mamba heads, registered, its config the JAX package's); what stays
    refused is hymba's heads outside the hybrid family (as a dense
    family, or as an ssm family of Mamba kind) and a hybrid config
    without them.  grok-1-314b is registered now (sharded serving), its
    config the JAX package's field for field."""
    j = ARCHS["hymba-1.5b"]
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in dataclasses.asdict(j).items() if k in fields}
    kw["ssm"] = SSMConfig(**kw["ssm"])
    hymba = ModelConfig(**kw)
    assert hymba.parallel_ssm and not hymba.attn_free
    assert TARCHS["hymba-1.5b"] == hymba
    for cfg in (hymba, hymba.reduced()):
        lm.check_family(cfg)
    assert "mamba" in lm.init_lm(hymba.reduced(), device="cpu")["layers"][0]
    for cfg in (dataclasses.replace(hymba, family="dense"),
                dataclasses.replace(hymba, family="ssm"),
                dataclasses.replace(hymba, parallel_ssm=False)):
        with pytest.raises(ValueError, match="not ported"):
            lm.check_family(cfg)
        with pytest.raises(ValueError, match="not ported"):
            lm.init_lm(cfg.reduced(), device="cpu")
    mamba_ssm = dataclasses.replace(get_config(ARCH),
                                    ssm=SSMConfig(kind="mamba"))
    with pytest.raises(ValueError, match="not ported"):
        lm.check_family(mamba_ssm)
    grok, jgrok = get_config("grok-1-314b"), ARCHS["grok-1-314b"]
    for f in fields:
        want = getattr(jgrok, f)
        got = getattr(grok, f)
        assert (dataclasses.asdict(got) == dataclasses.asdict(want)
                if dataclasses.is_dataclass(want) else got == want), f
    assert TARCHS["grok-1-314b"] is grok
    lm.check_family(grok)
    lm.check_family(get_config(ARCH))


@pytest.mark.parametrize("store", ["fp", "int8", "int4"])
def test_cache_has_no_kv_and_its_state_is_independent_of_max_len(store):
    """The counterpart of ``test_models.py::
    test_rwkv_state_decode_is_o1_memory``: no ``k`` leaf, the JAX leaves'
    shapes and dtypes, and a state that does not grow with the context
    (fp in every store, as in the JAX package)."""
    jcfg, tcfg = _cfgs()
    tc = lm.init_cache(tcfg, 2, 10_000, kv_store=store, device="cpu")
    jc = jlm.init_cache(jcfg, 2, 10_000, kv_store=store)
    assert "k" not in tc and "v" not in tc
    assert set(tc) == set(jc) == {"pos", *STATE}
    for name in STATE:
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)
        assert not tc[name].any()
    assert tc["rwkv_s"].dtype == torch.float32
    total = sum(t.numel() for t in tc.values())
    assert total < 1e6
    small = lm.init_cache(tcfg, 2, 16, kv_store=store, device="cpu")
    assert {n: t.shape for n, t in small.items()} == \
        {n: t.shape for n, t in tc.items()}


def test_bridge_carries_every_leaf_and_keeps_the_f32_leaves():
    """Every leaf of a bf16 JAX tree arrives bit for bit; ``w0``, ``w_a``,
    ``w_b`` and ``u`` stay f32 as the JAX init keeps them, the rest is
    bf16; the layer holds the JAX block's four entries."""
    jcfg, tcfg = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    jtree = jax.tree.map(np.asarray,
                         jlm.init_lm(jax.random.PRNGKey(1), jcfg))
    tparams = params_from_numpy(jtree, tcfg, "cpu")
    np.testing.assert_array_equal(
        tparams["embed"].float().numpy(),
        np.asarray(jtree["embed"], np.float32))
    flat = jax.tree_util.tree_flatten_with_path(jtree["layers"])[0]
    for i, layer in enumerate(tparams["layers"]):
        assert set(layer) == {"ln1", "ln2", "time_mix", "channel_mix"}
        for path, leaf in flat:
            node = layer
            for k in path:
                node = node[k.key]
            name = path[-1].key
            f32 = path[0].key == "time_mix" and name in ("w0", "w_a", "w_b",
                                                         "u")
            assert node.dtype == (torch.float32 if f32 else torch.bfloat16)
            np.testing.assert_array_equal(node.float().numpy(),
                                          np.asarray(leaf[i], np.float32))
    packed = lm.prepack_decode_params(tparams, tcfg)
    assert packed["layers"] is tparams["layers"]
    assert torch.equal(packed["head_t"], tparams["embed"].t())
    assert packed["head_t"].is_contiguous()


# --------------------------------------------------------------------------
# time-mix and channel-mix against the JAX package
# --------------------------------------------------------------------------


def _layer0(model):
    jcfg, jparams, tcfg, tparams = model
    return (jcfg, jax.tree.map(lambda a: a[0], jparams["layers"]), tcfg,
            tparams["layers"][0])


def _state(tcfg, B, seed):
    """A non-zero time-mix state ``(s, x_prev)`` and channel-mix carry."""
    rng = np.random.default_rng(seed)
    H, hd = ssm.rwkv_heads(tcfg)
    return (rng.standard_normal((B, H, hd, hd)).astype(np.float32),
            rng.standard_normal((B, tcfg.d_model)).astype(np.float32),
            rng.standard_normal((B, tcfg.d_model)).astype(np.float32))


@pytest.mark.parametrize("S,carried", [(1, True), (7, False), (7, True)])
def test_time_mix_and_channel_mix_match_jax(model, S, carried):
    """Output and state of both mixes; a carried state is advanced in
    place (the returned tensors are the ones given)."""
    jcfg, jp, tcfg, tp = _layer0(model)
    B = 3
    x = np.random.default_rng(S).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    s0, xtm, xcm = _state(tcfg, B, seed=S + 10)
    jstate = (jnp.asarray(s0), jnp.asarray(xtm)) if carried else None
    tstate = ((torch.from_numpy(s0.copy()), torch.from_numpy(xtm.copy()))
              if carried else None)
    jy, (js, jx) = jssm.apply_rwkv_time_mix(jp["time_mix"], jnp.asarray(x),
                                            jcfg, state=jstate)
    ty, (ts, tx) = ssm.apply_rwkv_time_mix(tp["time_mix"],
                                           torch.from_numpy(x), tcfg,
                                           state=tstate)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    if carried:
        assert ts is tstate[0] and tx is tstate[1]
        assert not np.array_equal(ts.numpy(), s0)
    jprev = jnp.asarray(xcm) if carried else None
    tprev = torch.from_numpy(xcm.copy()) if carried else None
    jy, jx = jssm.apply_rwkv_channel_mix(jp["channel_mix"], jnp.asarray(x),
                                         jcfg, prev_x=jprev)
    ty, tx = ssm.apply_rwkv_channel_mix(tp["channel_mix"],
                                        torch.from_numpy(x), tcfg,
                                        prev_x=tprev)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    if carried:
        assert tx is tprev


def test_the_perturbed_parameters_matter(model):
    """The bonus ``u`` and the order of the five mixes change the output
    (the JAX init's zeros and equal rows would hide either)."""
    _, _, tcfg, tp = _layer0(model)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 5, tcfg.d_model)).astype(np.float32))
    y, _ = ssm.apply_rwkv_time_mix(tp["time_mix"], x, tcfg)
    for change in ({"u": torch.zeros_like(tp["time_mix"]["u"])},
                   {"mu": tp["time_mix"]["mu"].flip(0)}):
        y2, _ = ssm.apply_rwkv_time_mix({**tp["time_mix"], **change}, x,
                                        tcfg)
        assert (y2 - y).abs().max().item() > 1e-2


def test_prefill_and_decode_logits_match_jax(model):
    """The whole reduced model: prefill 11 tokens into a cache, then 4
    decode steps (the dispatcher on prepacked weights from the second),
    logits and every state leaf within tolerance."""
    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (3, 11))
    toks = toks.astype(np.int32)
    jc = jlm.init_cache(jcfg, 3, 32, per_slot_pos=True)
    tc = lm.init_cache(tcfg, 3, 32, per_slot_pos=True, device="cpu")
    jl, jc, _ = jlm.forward(jparams, jcfg, jnp.asarray(toks), cache=jc)
    tl, tc, _ = lm.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                           cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    jpp = jlm.prepack_decode_params(jparams, jcfg)
    tpp = lm.prepack_decode_params(tparams, tcfg)
    leaves = {n: tc[n] for n in STATE}
    for step in range(4):
        pol = (None, None) if step == 0 else (jdispatch.DispatchPolicy(),
                                              DispatchPolicy())
        nxt = np.array(jl[:, -1:].argmax(-1), np.int32)
        jl, jc, _ = jlm.forward(jpp, jcfg, jnp.asarray(nxt), cache=jc,
                                gemv_policy=pol[0])
        tl, tc, _ = lm.forward(tpp, tcfg, torch.from_numpy(nxt).long(),
                               cache=tc, gemv_policy=pol[1])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"decode step {step}")
    for name in STATE:
        assert tc[name] is leaves[name]          # advanced in place
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=1e-5)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    # no cache: the same prefill logits
    tl0, none, _ = lm.forward(tparams, tcfg, torch.from_numpy(toks).long())
    jl0, _, _ = jlm.forward(jparams, jcfg, jnp.asarray(toks))
    assert none is None
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), atol=ATOL,
                               rtol=0)


def test_decode_step_head_through_pim_matches_jax():
    """The one kernel on this slice's path: the tied head at ``Sq == 1``
    with ``pim`` pinned on both sides (the JAX TPU backend in
    interpret-mode Pallas, the port's h100 backend on CPU tensors);
    widths that are multiples of 128 so the TPU kernel applies."""
    jcfg, jparams, tcfg, tparams = _pair(seed=3, d_model=256, vocab=512)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 9))
    toks = toks.astype(np.int32)
    jc = jlm.init_cache(jcfg, 2, 16, per_slot_pos=True)
    tc = lm.init_cache(tcfg, 2, 16, per_slot_pos=True, device="cpu")
    _, jc, _ = jlm.forward(jparams, jcfg, jnp.asarray(toks), cache=jc)
    _, tc, _ = lm.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                          cache=tc)
    nxt = toks[:, -1:] + 1
    jdispatch.clear_plan_cache()
    jpol = jdispatch.DispatchPolicy(backend="tpu", min_pallas_bytes=0,
                                    kernel="pim")
    jl, _, _ = jlm.forward(jlm.prepack_decode_params(jparams, jcfg), jcfg,
                           jnp.asarray(nxt), cache=jc, gemv_policy=jpol)
    assert jdispatch.dispatch_stats()["kernel_picks"] == {"tpu:pim": 1}
    dispatch.clear_plan_cache()
    tpol = DispatchPolicy(backend="h100", min_pallas_bytes=0, kernel="pim")
    tl, _, _ = lm.forward(lm.prepack_decode_params(tparams, tcfg), tcfg,
                          torch.from_numpy(nxt).long(), cache=tc,
                          gemv_policy=tpol)
    # the head alone goes through the dispatcher, as in the JAX package
    assert dispatch.dispatch_stats()["kernel_picks"] == {"h100:pim": 1}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)


def test_the_h100_picks_pim_for_the_full_head():
    """rwkv6-3b's tied head (K 2560, M 65536) at batch 1 and 8 on 132
    SMs: ``pim`` with the plan the JAX package's rule gives."""
    from repro_torch.kernels.backends.h100 import H100Backend

    cfg = get_config(ARCH)
    be = H100Backend(min_parallel_blocks=132)
    pol = DispatchPolicy()
    for b in (1, 8):
        kernel, plan = be.select_kernel(cfg.vocab, cfg.d_model, b,
                                        policy=pol)[:2]
        assert kernel == "pim"
        assert (plan.m_blk, plan.k_blk, plan.n_m, plan.n_k) == \
            (128, 64, 512, 40)


# --------------------------------------------------------------------------
# the engine against the JAX Engine
# --------------------------------------------------------------------------


def _logged(eng):
    """Record every logits row ``eng`` samples from, by request."""
    rows, sample = {}, eng._sample

    def logged(r, row):
        rows.setdefault(r.rid, []).append(np.array(row, np.float32))
        return sample(r, row)

    eng._sample = logged
    return rows


def _serve_both(model, prompts, new_tokens, graph=False, **kw):
    jcfg, jparams, tcfg, tparams = model
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = Engine(tcfg, tparams, device="cpu", **kw)
    rec = _graphed(teng) if graph else None
    jrows, trows = _logged(jeng), _logged(teng)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=new_tokens))
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens))
    jdone = {r.rid: list(r.generated) for r in jeng.run_until_drained()}
    tdone = {r.rid: list(r.generated) for r in teng.run_until_drained()}
    assert sorted(tdone) == list(range(len(prompts)))
    assert tdone == jdone
    for rid in tdone:
        assert len(trows[rid]) == len(jrows[rid]) == new_tokens
        np.testing.assert_allclose(np.stack(trows[rid]),
                                   np.stack(jrows[rid]), atol=ATOL, rtol=0,
                                   err_msg=f"request {rid}")
    if rec is not None:
        assert rec.replayed > 0
    return jeng, teng, tdone


# the JAX package's test_engine_mixed_lengths_rwkv and
# test_engine_chunked_prefill_rwkv cases
ENGINE_CASES = {
    "mixed_lengths": ([5, 9, 3], 9, 4, dict(batch_slots=2)),
    "chunked": ([19, 4], 16, 3, dict(batch_slots=2, prefill_chunk=6)),
}


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_tokens_and_logits_match_jax(model, case, graph):
    lengths, seed, new, kw = ENGINE_CASES[case]
    prompts = _prompts(model[0].vocab, lengths, seed)
    jeng, teng, tdone = _serve_both(model, prompts, new, graph=graph,
                                    max_len=MAX_LEN, **kw)
    assert len({tuple(t) for t in tdone.values()}) == len(prompts)
    if "prefill_chunk" in kw:
        assert teng.metrics.counters["prefill_chunks"] == \
            jeng.metrics.counters["prefill_chunks"] == 4


def _serial(tcfg, tparams, prompt, n_new):
    """One request alone: plain forward loop, no engine, no dispatcher."""
    cache = lm.init_cache(tcfg, 1, MAX_LEN, per_slot_pos=True, device="cpu")
    logits, cache, _ = lm.forward(tparams, tcfg,
                                  torch.from_numpy(prompt[None]).long(),
                                  cache=cache)
    out, rows = [int(logits[0, -1].argmax())], [logits[0, -1].numpy()]
    for _ in range(n_new - 1):
        logits, cache, _ = lm.forward(tparams, tcfg,
                                      torch.tensor([[out[-1]]]), cache=cache)
        out.append(int(logits[0, -1].argmax()))
        rows.append(logits[0, -1].numpy())
    return out, np.stack(rows)


def test_fault3_a_wave_of_unequal_lengths_gives_serial_tokens(model):
    """Three prompts of 5, 9 and 3 tokens admitted in one step: each
    prefills at its exact length (no pad runs through its state), so each
    gives the tokens and logits of the request served alone."""
    _, _, tcfg, tparams = model
    prompts = _prompts(tcfg.vocab, [5, 9, 3], seed=9)
    eng = Engine(tcfg, tparams, batch_slots=4, max_len=MAX_LEN,
                 device="cpu")
    rows = _logged(eng)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    done = {r.rid: r.generated for r in eng.run_until_drained()}
    assert eng.metrics.counters["prefill_waves"] == 3
    for i, p in enumerate(prompts):
        toks, ref_rows = _serial(tcfg, tparams, p, 5)
        assert done[i] == toks, i
        np.testing.assert_allclose(np.stack(rows[i]), ref_rows, atol=ATOL,
                                   rtol=0)


def test_fault2_a_first_chunk_on_a_freed_slot_starts_from_fresh_state(
        model):
    """One slot: a request decodes on it and finishes, then a longer one
    is admitted into the freed slot and prefills through chunks.  Its
    tokens and logits are those of a fresh engine's."""
    _, _, tcfg, tparams = model
    first, second = _prompts(tcfg.vocab, [6, 13], seed=5)
    outs = []
    for earlier in (True, False):
        eng = Engine(tcfg, tparams, batch_slots=1, max_len=MAX_LEN,
                     prefill_chunk=4, device="cpu")
        rows = _logged(eng)
        if earlier:
            eng.submit(Request(rid=0, prompt=first, max_new_tokens=5))
            eng.run_until_drained()
            assert eng.kv.cache["rwkv_s"][:, 0].abs().max() > 0
        eng.submit(Request(rid=1, prompt=second, max_new_tokens=5))
        done = {r.rid: r.generated for r in eng.run_until_drained()}
        assert eng.metrics.counters["prefill_chunks"] >= 4
        outs.append((done[1], np.stack(rows[1])))
    assert outs[0][0] == outs[1][0] == _serial(tcfg, tparams, second, 5)[0]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_fault1_a_decode_step_leaves_a_row_mid_prefill_bit_equal(model):
    """A short request decodes while a long one prefills in chunks of 4 on
    the next slot, inside the decode bucket: across every such step the
    mid-prefill row's state is bit-equal and its ``pos`` unchanged, and
    both requests give their serial tokens."""
    _, _, tcfg, tparams = model
    short, long = _prompts(tcfg.vocab, [3, 17], seed=6)
    eng = Engine(tcfg, tparams, batch_slots=2, max_len=MAX_LEN,
                 prefill_chunk=4, device="cpu")
    decode, seen = eng._decode, []

    def checked():
        mid = sorted(eng._prefilling)
        before = {n: eng.kv.cache[n][:, mid].clone() for n in STATE}
        pos = eng.kv.cache["pos"][mid].clone()
        out = decode()
        for n in STATE:
            assert torch.equal(eng.kv.cache[n][:, mid], before[n]), n
        assert torch.equal(eng.kv.cache["pos"][mid], pos)
        seen.append(len(mid))
        return out

    eng._decode = checked
    eng.submit(Request(rid=0, prompt=short, max_new_tokens=6))
    eng.submit(Request(rid=1, prompt=long, max_new_tokens=3))
    done = {r.rid: r.generated for r in eng.run_until_drained()}
    assert sum(seen) >= 3       # decode steps over the row mid-prefill
    assert done[0] == _serial(tcfg, tparams, short, 6)[0]
    assert done[1] == _serial(tcfg, tparams, long, 3)[0]


def test_fault1_the_save_and_restore_copy_no_kv_shaped_tensor():
    """A pure-KV family has no state leaves: the step's save and restore
    copy nothing, and a recurrent family's copy only its state rows."""
    olmo = get_config("olmo-1b").reduced()
    eng = Engine(olmo, lm.init_lm(olmo, device="cpu"), batch_slots=2,
                 max_len=16, device="cpu")
    assert eng.kv.state_names == () and eng.kv._saved == {}
    tcfg = get_config(ARCH).reduced()
    eng = Engine(tcfg, lm.init_lm(tcfg, device="cpu"), batch_slots=2,
                 max_len=16, device="cpu")
    assert eng.kv.state_names == STATE
    row = eng.kv.cache["rwkv_s"][:, 1]
    row.normal_()
    kept = row.clone()
    eng.kv.save_state([1])
    row.add_(1)
    eng.kv.restore_state([1])
    assert torch.equal(row, kept)


# --------------------------------------------------------------------------
# the prefix cache: state checkpoints at chunk boundaries
# --------------------------------------------------------------------------


def _shared_prefix_prompts(n=6, prefix_len=16):
    shared = list(range(10, 10 + prefix_len))
    return [np.asarray(shared + [100 + 7 * i, 40 + i], np.int32)
            for i in range(n)]


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph"])
def test_prefix_cache_family_sweep_and_the_jax_engine(model, graph):
    """The port's counterpart of the JAX family sweep for rwkv6-3b: chunk
    8, 6 shared-prefix requests on 4 slots; tokens equal with the cache on
    and off and to the JAX ``Engine``'s, logits too; hits at chunk
    boundaries and the tokens they saved equal the JAX engine's."""
    jcfg, jparams, tcfg, tparams = model
    prompts = _shared_prefix_prompts()
    kw = dict(batch_slots=4, max_len=MAX_LEN, prefill_chunk=8)
    _, off_eng, off = _serve_both(model, prompts, 4, graph=graph, **kw)
    jeng, teng, on = _serve_both(model, prompts, 4, graph=graph,
                                 prefix_cache=True, **kw)
    assert off == on
    c, jc = teng.metrics.counters, jeng.metrics.counters
    assert teng.prefix.has_state and c["prefix_hits"] > 0
    for k in ("prefix_hits", "prefix_misses", "prefill_tokens_saved",
              "prefill_chunks"):
        assert c[k] == jc[k], k
    # every snapshot is the whole state at a segment's end; no K/V span
    for node in teng.prefix._walk():
        assert node.kv == {}
        if node.state is not None:
            assert set(node.state) == set(STATE)


def test_int8_kv_store_changes_nothing_for_a_state_family(model):
    """The family sweep's int8 check: prefill 8 tokens and decode 3 with
    ``kv_store="int8"`` and ``"fp"``: rwkv6 has no K/V pages, so the
    logits agree within the sweep's 1e-6 (they are equal)."""
    _, _, tcfg, tparams = model
    prompt = torch.arange(7, 15)[None]

    def logits_for(store):
        cache = lm.init_cache(tcfg, 1, 32, kv_store=store, device="cpu")
        logits, cache, _ = lm.forward(tparams, tcfg, prompt, cache=cache)
        out = [logits[0, -1]]
        for _ in range(3):
            tok = out[-1].argmax().reshape(1, 1)
            logits, cache, _ = lm.forward(tparams, tcfg, tok, cache=cache)
            out.append(logits[0, -1])
        return torch.stack(out)

    assert (logits_for("int8") - logits_for("fp")).abs().max() < 1e-6


def test_a_preempted_row_mid_prefill_files_a_valid_snapshot(model):
    """A victim taken mid-prefill files its state at the tokens it
    consumed; readmitted, it matches that snapshot and gives the tokens
    and logits of a run that was never preempted."""
    _, _, tcfg, tparams = model
    prompt = _prompts(tcfg.vocab, [21], seed=12)[0]
    outs = []
    for preempt in (True, False):
        eng = Engine(tcfg, tparams, batch_slots=1, max_len=MAX_LEN,
                     prefill_chunk=4, prefix_cache=True, device="cpu")
        rows = _logged(eng)
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
        eng.step()
        eng.step()
        if preempt:
            eng.scheduler.wants_preemption = lambda now: True
            eng.step()
            del eng.scheduler.wants_preemption
            assert eng.metrics.counters["evicted"] == 1
        done = {r.rid: r.generated for r in eng.run_until_drained()}
        outs.append((done[0], np.stack(rows[0])))
    assert outs[0][0] == outs[1][0]
    np.testing.assert_allclose(outs[0][1], outs[1][1], atol=ATOL, rtol=0)


def _state_payload(tokens, pkg):
    """A state-family segment payload (no K/V span): a snapshot that
    depends on the whole stream."""
    s = np.full((2, 3), float(np.sum(tokens) + 0.25 * len(tokens)),
                np.float32)
    if pkg == "port":
        return {"kv": {}, "state": {"s": torch.from_numpy(s)}}
    return {"kv": {}, "state": {"s": jnp.asarray(s)}}


@pytest.mark.parametrize("seed", range(4))
def test_state_prefix_cache_matches_the_reference_op_for_op(seed):
    """``has_state=True`` with payloads that hold no K/V (rwkv6's): random
    inserts of streams and of their chunk boundaries, matches (most of
    them of a filed stream's prefix and a fresh tail), pins and evictions
    over a three-token alphabet; match lengths, spans, the
    gathered snapshot, the tree and every counter equal the reference's
    after each op, while the reference's accounting holds."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(16, 48)) * 2 * 3 * 4   # 16 to 47 snapshots
    port = PrefixCache(PrefixCacheConfig(capacity_bytes=cap, min_tokens=2),
                       has_state=True)
    ref = JPrefixCache(JPrefixCacheConfig(capacity_bytes=cap, min_tokens=2),
                       has_state=True)
    held, ref_ok, hits, streams = [], True, 0, []
    for _ in range(int(rng.integers(25, 45))):
        # insert, match, release, evict: 3 : 3 : 1 : 1
        op = (0, 0, 0, 2, 2, 2, 3, 4)[int(rng.integers(0, 8))]
        t = rng.integers(0, 3, int(rng.integers(1, 12))).astype(np.int32)
        if op == 2 and streams and rng.random() < 0.7:
            # a later request: part of a filed stream and a fresh tail
            base = streams[int(rng.integers(0, len(streams)))]
            t = np.concatenate([base[:int(rng.integers(1, len(base) + 1))],
                                t[:int(rng.integers(1, 4))]])
        if op <= 1:
            streams.append(t)
            cut = [int(c) for c in range(4, len(t), 4)] + [len(t)]
            for n in cut:       # the chunk boundaries, then the stream
                filed = port.insert(t[:n], _state_payload(t[:n], "port"))
                if ref_ok:
                    rf = ref.insert(t[:n], _state_payload(t[:n], "ref"))
                    ref_ok = _consistent(ref)
                    if ref_ok:
                        assert filed == rf
        elif op == 2:
            pm = port.match(t)
            if ref_ok:
                rm = ref.match(t)
                assert port.match_len(t) == ref.match_len(t)
                assert (pm is None) == (rm is None)
                if pm is not None:
                    hits += 1
                    assert (pm.length, pm.spans) == (rm.length, rm.spans)
                    pg, rg = port.gather(pm), ref.gather(rm)
                    assert pg["kv"] == {} and dict(rg["kv"]) == {}
                    np.testing.assert_array_equal(
                        pg["state"]["s"].numpy(),
                        np.asarray(rg["state"]["s"]))
                    # the snapshot is the one filed at exactly that length
                    want = _state_payload(t[:pm.length], "port")["state"]
                    assert torch.equal(pg["state"]["s"], want["s"])
            if pm is not None and rng.random() < 0.6:
                port.acquire(pm)
                if ref_ok:
                    ref.acquire(rm)
                held.append((pm, rm if ref_ok else None))
        elif op == 3 and held:
            pm, rm = held.pop(int(rng.integers(0, len(held))))
            port.release(pm)
            if ref_ok and rm is not None:
                ref.release(rm)
        else:
            target = int(rng.integers(0, max(port.bytes_used, 1)))
            evicted = port.evict_to(target)
            if ref_ok:
                assert evicted == ref.evict_to(target)
        assert _consistent(port)
        if ref_ok:
            assert _tree(port.root) == _tree(ref.root)
            assert port.counters == ref.counters
            assert port.bytes_used == ref.bytes_used
    assert hits > 0


# --------------------------------------------------------------------------
# the decode graphs
# --------------------------------------------------------------------------


def test_graph_route_buckets_4_2_1_with_a_row_mid_prefill(model):
    """Through the graph stand-in: four requests whose tokens shrink the
    bucket 4 -> 2 -> 1 (compaction moves survivors down), and a fifth
    that prefills in chunks of 4 inside a bucket replayed from its graph;
    tokens and logits equal the JAX ``Engine``'s, the rows mid-prefill
    come out of each replayed step bit-equal, and every state leaf keeps
    its address."""
    jcfg, jparams, tcfg, tparams = model
    lengths, new = [7, 4, 9, 5, 14], [2, 3, 5, 8, 3]
    prompts = _prompts(tcfg.vocab, lengths, seed=3)
    kw = dict(batch_slots=4, max_len=MAX_LEN, prefill_chunk=4)
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = Engine(tcfg, tparams, device="cpu", **kw)
    rec = _graphed(teng)
    ptrs = {n: teng.kv.cache[n].data_ptr() for n in STATE}
    jrows, trows = _logged(jeng), _logged(teng)
    decode, mid_steps = teng._decode, []

    def checked():
        mid = sorted(teng._prefilling)
        before = {n: teng.kv.cache[n][:, mid].clone() for n in STATE}
        replays = rec.replayed
        out = decode()
        for n in STATE:
            assert torch.equal(teng.kv.cache[n][:, mid], before[n]), n
        if mid and rec.replayed > replays:
            mid_steps.append(len(mid))
        return out

    teng._decode = checked
    done = {}
    for eng, make, key in ((jeng, JaxRequest, "j"), (teng, Request, "t")):
        for i in range(4):
            eng.submit(make(rid=i, prompt=prompts[i],
                            max_new_tokens=new[i]))
        out = {}
        for step in range(60):
            if step == 2:
                eng.submit(make(rid=4, prompt=prompts[4],
                                max_new_tokens=new[4]))
            out.update({r.rid: list(r.generated) for r in eng.step()})
            if len(out) == 5:
                break
        done[key] = out
    assert done["t"] == done["j"] and sorted(done["t"]) == list(range(5))
    for rid in range(5):
        np.testing.assert_allclose(np.stack(trows[rid]),
                                   np.stack(jrows[rid]), atol=ATOL, rtol=0)
    buckets = {st["decode_batch"] for st in teng.metrics.steps
               if st["decode_batch"]}
    assert buckets == {4, 2, 1} and set(teng.graphs.replays) == buckets
    assert mid_steps, "no replayed step covered a row mid-prefill"
    assert {n: teng.kv.cache[n].data_ptr() for n in STATE} == ptrs
