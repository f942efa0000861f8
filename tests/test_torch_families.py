"""The dense families beyond olmo-1b against the JAX package: minitron-8b
(untied head, parametric LayerNorm, GQA, a squared-ReLU FFN), gemma3-1b
(one kv head for four query heads, geglu, 5 local layers to 1 global) and
gemma3-27b (GQA, geglu, the same local/global pattern), each reduced.

Both packages get the same weights (the JAX ``init_lm`` tree, handed to
the port through numpy by ``repro_torch.bridge``) and the same numpy
prompts, on the CPU; the port's kernel wrappers take their plain versions
on CPU tensors, and the JAX side runs its Pallas kernels in interpret mode
where a kernel is pinned.  The reduced gemma3 configs have a window of 8
and a global layer every 2, so every prompt here longer than 8 tokens
reaches past a local layer's window.  Their greedy tokens vary little, so
every sampled row of logits is held too, not only the tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# the machine with the card has no JAX: there this file skips
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from test_torch_graphs import _graphed  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.backends import DispatchPolicy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

# f32 on both sides; the sums run in different orders (XLA vs ATen)
ATOL = 1e-4
MAX_LEN = 64
FAMILIES = ("minitron-8b", "gemma3-1b", "gemma3-27b")


def _cfgs(arch, **overrides):
    return (dataclasses.replace(ARCHS[arch].reduced(), **overrides),
            dataclasses.replace(get_config(arch).reduced(), **overrides))


def _pair(arch, seed=0, **overrides):
    """(jcfg, jparams, tcfg, tparams): one JAX init, both packages."""
    jcfg, tcfg = _cfgs(arch, **overrides)
    jparams = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def models():
    return {arch: _pair(arch) for arch in FAMILIES}


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_config_matches_the_jax_package(arch):
    jcfg, tcfg = _cfgs(arch)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.hd == jcfg.hd
    assert [tcfg.is_global_layer(i) for i in range(6)] == \
        [jcfg.is_global_layer(i) for i in range(6)]
    full = get_config(arch)
    for f in dataclasses.fields(full):
        assert getattr(full, f.name) == getattr(ARCHS[arch], f.name), f.name


@pytest.mark.parametrize("arch", FAMILIES)
def test_layer_windows_follow_the_jax_forward(arch):
    """Each layer's window: the reduced gemma3 configs alternate local
    (8) and global (0) layers, minitron's are all global; at full size
    gemma3's layers 5, 11, ... are global."""
    full = get_config(arch)
    tcfg = full.reduced()
    got = [lm.layer_window(tcfg, i) for i in range(tcfg.n_layers)]
    if arch == "minitron-8b":
        assert got == [0] * tcfg.n_layers
        assert lm.layer_window(full, 5) == 0
    else:
        assert got == [8, 0, 8][:tcfg.n_layers]
        assert [lm.layer_window(full, i) for i in range(12)] == \
            [1024] * 5 + [0] + [1024] * 5 + [0]
        assert all(full.is_global_layer(i) == (lm.layer_window(full, i) == 0)
                   for i in range(full.n_layers))


@pytest.mark.parametrize("arch", FAMILIES)
def test_bridge_carries_every_leaf_bit_for_bit(models, arch):
    """minitron's untied head and LayerNorm biases, gemma3's gates: every
    leaf of the JAX tree arrives unchanged, and only gated FFNs have a
    gate."""
    jcfg, jparams, tcfg, tparams = models[arch]
    jtree = jax.tree.map(np.asarray, jparams)
    assert ("lm_head" in tparams) == (not tcfg.tie_embeddings)
    for name in ("embed", "lm_head"):
        if name in jtree:
            np.testing.assert_array_equal(tparams[name].numpy(),
                                          jtree[name])
    for i, layer in enumerate(tparams["layers"]):
        flat = jax.tree_util.tree_flatten_with_path(jtree["layers"])[0]
        for path, leaf in flat:
            node = layer
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node.numpy(), leaf[i])
        assert ("w_gate" in layer["mlp"]) == (tcfg.act != "relu2")
        assert ("bias" in layer["ln1"]) == (tcfg.norm_type == "layernorm")


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_prefill_and_decode_logits_match_jax(models, arch):
    """Prefill 20 tokens (past the window of 8), then two decode steps:
    the plain path, then the dispatcher on prepacked weights (CPU
    backends on both sides)."""
    jcfg, jparams, tcfg, tparams = models[arch]
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (3, 20))
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


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_without_cache_matches_jax(models, arch):
    jcfg, jparams, tcfg, tparams = models[arch]
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 19))
    jl, _, _ = jlm.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32))
    tl, cache, _ = lm.forward(tparams, tcfg, torch.from_numpy(toks))
    assert cache is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("kernel", ["pim", "splitk"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_through_each_kernel_matches_jax(arch, kernel):
    """One decode step, 12 positions in (past the window of 8), with the
    kernel pinned on both sides: the JAX TPU backend in interpret-mode
    Pallas, the port's h100 backend on CPU tensors (the wrappers' plain
    versions).  Widths are multiples of 128 so the TPU kernels apply;
    gemma3-1b keeps its four query heads on one kv head.  A gated FFN's
    gate and up run as one fused program beside QKV; minitron's
    squared-ReLU FFN sends up and down as single requests."""
    kv = {"gemma3-1b": 1}.get(arch, 2)
    jcfg, jparams, tcfg, tparams = _pair(
        arch, seed=3, d_model=256, n_heads=4, n_kv_heads=kv, head_dim=128,
        d_ff=512, vocab=512)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 12))
    toks = toks.astype(np.int32)
    nxt = toks[:, -1:] + 1
    jc = jlm.init_cache(jcfg, 2, 16, per_slot_pos=True)
    tc = lm.init_cache(tcfg, 2, 16, per_slot_pos=True, device="cpu")
    _, jc, _ = jlm.forward(jparams, jcfg, jnp.asarray(toks), cache=jc)
    _, tc, _ = lm.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                          cache=tc)

    jdispatch.clear_plan_cache()
    jpol = jdispatch.DispatchPolicy(backend="tpu", min_pallas_bytes=0,
                                    kernel=kernel)
    jl, _, _ = jlm.forward(jlm.prepack_decode_params(jparams, jcfg), jcfg,
                           jnp.asarray(nxt), cache=jc, gemv_policy=jpol)
    assert jdispatch.dispatch_stats()["kernel_picks"].get(
        f"tpu:{kernel}", 0) > 0
    jmodes = jdispatch.dispatch_stats()["program_modes"]

    dispatch.clear_plan_cache()
    tpol = DispatchPolicy(backend="h100", min_pallas_bytes=0, kernel=kernel)
    tl, _, _ = lm.forward(lm.prepack_decode_params(tparams, tcfg), tcfg,
                          torch.from_numpy(nxt).long(), cache=tc,
                          gemv_policy=tpol)
    stats = dispatch.dispatch_stats()
    assert stats["kernel_picks"].get(f"h100:{kernel}", 0) > 0
    # the same programs as the JAX side: QKV, and gate+up when gated
    assert sum(stats["program_modes"].values()) == \
        sum(jmodes.values()) == (1 if tcfg.act == "relu2" else 2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)


def _logged(eng):
    """Record every logits row ``eng`` samples from, by request."""
    rows, sample = {}, eng._sample

    def logged(r, row):
        rows.setdefault(r.rid, []).append(np.array(row, np.float32))
        return sample(r, row)

    eng._sample = logged
    return rows


ENGINE_ROUTES = {"eager": {}, "graph": {}, "chunked": {"prefill_chunk": 8}}


@pytest.mark.parametrize("route", sorted(ENGINE_ROUTES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_tokens_and_logits_match_jax(models, arch, route):
    """Prompts [30, 5, 25, 3], 6 greedy tokens each: the port's Engine
    gives the JAX Engine's tokens, and every row of logits it sampled
    from (prefill and each decode step) within ATOL; eagerly, through
    the graph stand-in, and with chunked prefill (chunk 8) on both."""
    jcfg, jparams, tcfg, tparams = models[arch]
    kw = dict(batch_slots=4, max_len=MAX_LEN, **ENGINE_ROUTES[route])
    prompts = _prompts(jcfg.vocab, [30, 5, 25, 3], seed=21)
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = Engine(tcfg, tparams, device="cpu", **kw)
    rec = _graphed(teng) if route == "graph" else None
    jrows, trows = _logged(jeng), _logged(teng)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=6))
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    jdone = {r.rid: r.generated for r in jeng.run_until_drained()}
    tdone = {r.rid: r.generated for r in teng.run_until_drained()}
    assert sorted(tdone) == list(range(4))
    assert tdone == jdone
    for rid in range(4):
        assert len(trows[rid]) == len(jrows[rid]) == 6
        np.testing.assert_allclose(np.stack(trows[rid]),
                                   np.stack(jrows[rid]), atol=ATOL, rtol=0,
                                   err_msg=f"request {rid}")
    if rec is not None:
        assert rec.replayed > 0
    if route == "chunked":
        assert teng.metrics.counters["prefill_chunks"] == \
            jeng.metrics.counters["prefill_chunks"] == 4 + 4


def test_local_global_masking_differs():
    """The port's counterpart of the JAX package's test: with only local
    layers (window 8), the last of 32 positions does not see a change to
    token 0 through 2 layers; a global config does."""
    cfg = get_config("gemma3-1b").reduced()
    assert cfg.attn_pattern == "local_global"
    t1 = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, 32)))
    t2 = t1.clone()
    t2[0, 0] = (t2[0, 0] + 1) % cfg.vocab
    local_only = dataclasses.replace(cfg, global_every=10**6, n_layers=2)
    assert [lm.layer_window(local_only, i) for i in range(2)] == [8, 8]
    p2 = lm.init_lm(local_only, seed=0, device="cpu")
    l1, _, _ = lm.forward(p2, local_only, t1)
    l2, _, _ = lm.forward(p2, local_only, t2)
    torch.testing.assert_close(l1[0, -1], l2[0, -1], rtol=1e-5, atol=1e-5)
    glob = dataclasses.replace(cfg, attn_pattern="full", n_layers=2)
    p3 = lm.init_lm(glob, seed=0, device="cpu")
    g1, _, _ = lm.forward(p3, glob, t1)
    g2, _, _ = lm.forward(p3, glob, t2)
    assert (g1[0, -1] - g2[0, -1]).abs().max().item() > 0
    # the same weights with the window: a local layer masks, so its
    # logits differ from the global layer's on a prompt past the window
    w1, _, _ = lm.forward(p3, local_only, t1)
    assert (w1[0, -1] - g1[0, -1]).abs().max().item() > 0


def test_prepack_without_a_gate_keeps_the_decode_logits(models):
    """minitron-8b's FFN has no gate: the prepack builds ``wqkv`` and no
    ``w_gateup``, and the decode step's logits are the unpacked ones."""
    _, _, tcfg, tparams = models["minitron-8b"]
    packed = lm.prepack_decode_params(tparams, tcfg)
    for layer in packed["layers"]:
        assert "w_gateup" not in layer["mlp"]
        assert layer["attn"]["wqkv"].is_contiguous()
    assert packed["head_t"] is tparams["lm_head"] or torch.equal(
        packed["head_t"], tparams["lm_head"])
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab, (2, 10)))
    outs = []
    for params in (tparams, packed):
        cache = lm.init_cache(tcfg, 2, 16, per_slot_pos=True, device="cpu")
        _, cache, _ = lm.forward(params, tcfg, toks, cache=cache)
        logits, _, _ = lm.forward(params, tcfg, toks[:, -1:], cache=cache,
                                  gemv_policy=DispatchPolicy())
        outs.append(logits)
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
