"""whisper-small (an encoder over stub frame embeddings; every decoder
layer cross-attends, ungated) and llama-3.2-vision-11b (gated
cross-attention over stub patch embeddings on the last layer of each
group) against the JAX package, reduced, on the CPU.

Both packages get the same weights: the JAX ``init_lm`` tree, with every
``cross_gate`` set to 0.75 in its numpy copy (the JAX init's zeros would
hide llama-vision's cross-attention from every test), handed to the port
through ``repro_torch.bridge``.  llama-vision also runs at 4 layers (2
groups: the reduced config has one group, which cannot show a group-order
fault) and whisper with an encoder of width 32 (``proj`` from 32 to 64).
The greedy tokens of these reduced models barely vary, so every sampled
row of logits is held against the JAX ``Engine``'s, not only the tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# the machine with the card has no JAX: there this file skips
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from test_torch_families import _logged  # noqa: E402
from test_torch_graphs import _drive, _graphed  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.attention import \
    decode_attention_plain  # noqa: E402
from repro_torch.kernels.backends import DispatchPolicy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

# f32 on both sides; the sums run in different orders (XLA vs ATen)
ATOL = 1e-4
MAX_LEN = 64
GATE = 0.75
WHISPER, VISION = "whisper-small", "llama-3.2-vision-11b"
# name: (arch, overrides of both reduced configs)
MODELS = {
    "whisper": (WHISPER, {}),
    "whisper-enc32": (WHISPER, {"encoder": 32}),
    "vision": (VISION, {}),
    "vision-2groups": (VISION, {"n_layers": 4}),
}


def _cfgs(arch, **overrides):
    """(JAX cfg, port cfg), each reduced and given ``overrides``;
    ``encoder=w`` sets the encoder's width."""
    out = []
    for cfg in (ARCHS[arch].reduced(), get_config(arch).reduced()):
        ov = dict(overrides)
        if "encoder" in ov:
            ov["encoder"] = dataclasses.replace(cfg.encoder,
                                                d_model=ov["encoder"])
        out.append(dataclasses.replace(cfg, **ov))
    return tuple(out)


def _gated(tree, gate):
    """The numpy tree with every ``cross_gate`` leaf set to ``gate``."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, gate) if k == "cross_gate"
                    else _gated(v, gate)) for k, v in tree.items()}
    return tree


def _pair(arch, seed=0, gate=GATE, **overrides):
    """(jcfg, jparams, tcfg, tparams): one JAX init, both packages."""
    jcfg, tcfg = _cfgs(arch, **overrides)
    # one compiled init: op by op, the JAX init takes twice as long
    init = jax.jit(jlm.init_lm, static_argnums=1)
    tree = _gated(jax.tree.map(np.asarray,
                               init(jax.random.PRNGKey(seed), jcfg)), gate)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_numpy(tree, tcfg, "cpu"))


@pytest.fixture(scope="module")
def models():
    return {name: _pair(arch, **ov) for name, (arch, ov) in MODELS.items()}


def _features(cfg, B, seed):
    """Stub frame / patch embeddings of ``B`` rows, numpy f32."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.encoder is not None:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.encoder.d_model), np.float32)
    if cfg.cross_attn_every:
        out["vision"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model), np.float32)
    return out


def _j(feats):
    return {k: jnp.asarray(v) for k, v in feats.items()}


def _t(feats):
    return {k: torch.from_numpy(v) for k, v in feats.items()}


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_reduced_config_matches_the_jax_package(arch):
    """Every field of the reduced and the full config, the encoder's
    field for field (the two packages' ``EncoderConfig`` are different
    classes), and which layers cross-attend."""
    for jcfg, tcfg in (_cfgs(arch), (ARCHS[arch], get_config(arch))):
        for f in dataclasses.fields(tcfg):
            want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
            if f.name == "encoder" and got is not None:
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, f.name
        assert tcfg.hd == jcfg.hd
    tcfg = get_config(arch)
    crosses = [i for i in range(tcfg.n_layers) if tcfg.is_cross_layer(i)]
    if arch == WHISPER:
        assert crosses == list(range(12))
        assert tcfg.reduced().encoder.n_frames == 16
    else:
        assert crosses == [4, 9, 14, 19, 24, 29, 34, 39]
        red = tcfg.reduced()
        assert (red.n_layers, red.cross_attn_every, red.vision_tokens) == \
            (2, 2, 8)


def _walk(node, keys):
    for k in keys:
        node = node[k]
    return node


def _where_the_port_keeps(tparams, tcfg, keys, leaf):
    """(port tensor, JAX array) pairs for the JAX leaf at path ``keys``:
    stacked layers one pair a layer, llama-vision's groups unrolled to
    layer ``gi * g + i``."""
    g, layers = tcfg.cross_attn_every, tparams["layers"]
    if keys[0] == "groups" and keys[1] == "plain":
        return [(_walk(layers[gi * g + i], keys[2:]), leaf[gi, i])
                for gi in range(leaf.shape[0]) for i in range(g - 1)]
    if keys[0] == "groups":
        return [(_walk(layers[gi * g + g - 1], keys[2:]), leaf[gi])
                for gi in range(leaf.shape[0])]
    if keys[0] == "layers":
        return [(_walk(layers[i], keys[1:]), leaf[i])
                for i in range(leaf.shape[0])]
    if keys[:2] == ["encoder", "layers"]:
        return [(_walk(tparams["encoder"]["layers"][i], keys[2:]), leaf[i])
                for i in range(leaf.shape[0])]
    return [(_walk(tparams, keys), leaf)]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bridge_carries_every_leaf_bit_for_bit(models, name):
    """Every leaf of the JAX tree arrives unchanged where the port keeps
    it: ``groups.plain[gi, i]`` at layer ``gi * g + i`` and
    ``groups.cross_layer[gi]`` at ``gi * g + g - 1``, the encoder's
    stacked layers as a list, ``proj`` only where the widths differ."""
    jcfg, jparams, tcfg, tparams = models[name]
    pairs = [pair for path, leaf in jax.tree_util.tree_flatten_with_path(
                 jax.tree.map(np.asarray, jparams))[0]
             for pair in _where_the_port_keeps(
                 tparams, tcfg, [k.key for k in path], leaf)]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), want)
    # and the port holds nothing else
    assert len(pairs) == len(jax.tree.leaves(
        tparams, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    cross = [i for i, p in enumerate(tparams["layers"]) if "cross" in p]
    assert cross == [i for i in range(tcfg.n_layers)
                     if tcfg.is_cross_layer(i)]
    for i in cross:
        assert tparams["layers"][i]["cross_gate"].item() == GATE
    if tcfg.encoder is not None:
        assert (tparams["encoder"]["proj"] is None) == (
            tcfg.encoder.d_model == tcfg.d_model)


@pytest.mark.parametrize("name", ["whisper", "whisper-enc32"])
def test_run_encoder_matches_jax(models, name):
    jcfg, jparams, tcfg, tparams = models[name]
    frames = _features(jcfg, 2, seed=4)["frames"]
    want = jlm._run_encoder(jparams["encoder"], jnp.asarray(frames), jcfg)
    got = lm.run_encoder(tparams["encoder"], torch.from_numpy(frames), tcfg)
    assert got.shape == (2, jcfg.encoder.n_frames, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("name", ["whisper", "vision", "vision-gqa"])
def test_apply_cross_attention_matches_jax(models, name, sq):
    """One query a slot (the decode step: the causal form at ``Sk - 1``)
    and five (the plain non-causal path); ``vision-gqa`` has 2 kv heads
    for 4 query heads."""
    if name == "vision-gqa":
        jcfg, tcfg = _cfgs(VISION, n_kv_heads=2)
        p = jL.init_cross_attention(jax.random.PRNGKey(7), jcfg,
                                    jcfg.d_model, jnp.float32)
        jp = jax.tree.map(np.asarray, p)
    else:
        jcfg, jparams, tcfg, _ = models[name]
        layer = (jparams["layers"] if "layers" in jparams
                 else jparams["groups"]["cross_layer"])
        jp = jax.tree.map(lambda a: np.asarray(a[0]), layer["cross"])
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, sq, jcfg.d_model), np.float32)
    ctx = rng.standard_normal((3, 11, jcfg.d_model), np.float32)
    want = jL.apply_cross_attention(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jnp.asarray(ctx),
        jcfg)
    got = L.apply_cross_attention(tp, torch.from_numpy(x),
                                  torch.from_numpy(ctx), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("G", [1, 4])
def test_causal_query_at_the_last_key_is_the_non_causal_query(G):
    """The plain path's causal form at ``q_position = Sk - 1`` (what the
    decode step gives ``decode_attention``) equals its non-causal
    query over all ``Sk`` keys bit for bit: no key lies past it."""
    rng = np.random.default_rng(9)
    B, Sk, Hkv, D = 3, 13, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, 1, Hkv * G, D), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, Hkv, D),
                                                 np.float32))
            for _ in range(2))
    causal = decode_attention_plain(
        q, k, v, q_positions=torch.full((B, 1), Sk - 1), kv_valid_len=None,
        causal=True)
    free = decode_attention_plain(q, k, v, q_positions=None,
                                  kv_valid_len=None, causal=False)
    torch.testing.assert_close(causal, free, rtol=0, atol=0)
    # one key fewer is a different function: the form is not vacuous
    short = decode_attention_plain(
        q, k, v, q_positions=torch.full((B, 1), Sk - 2), kv_valid_len=None,
        causal=True)
    assert (short - free).abs().max().item() > 0


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_prefill_and_decode_logits_match_jax(models, name):
    """Prefill 12 tokens, then two decode steps: the plain path, then the
    dispatcher on prepacked weights (CPU backends on both sides); the
    caches after them."""
    jcfg, jparams, tcfg, tparams = models[name]
    feats = _features(jcfg, 3, seed=1)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (3, 12))
    toks = toks.astype(np.int32)
    jc = jlm.init_cache(jcfg, 3, 32, per_slot_pos=True)
    tc = lm.init_cache(tcfg, 3, 32, per_slot_pos=True, device="cpu")
    jl, jc, _ = jlm.forward(jparams, jcfg, jnp.asarray(toks), cache=jc,
                            **_j(feats))
    tl, tc, _ = lm.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                           cache=tc, **_t(feats))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    jpp = jlm.prepack_decode_params(jparams, jcfg)
    tpp = lm.prepack_decode_params(tparams, tcfg)
    assert all("wqkv" in p["attn"] for p in tpp["layers"])
    for step, (jpol, tpol) in enumerate([
            (None, None),
            (jdispatch.DispatchPolicy(), DispatchPolicy())]):
        nxt = np.array(jl[:, -1:].argmax(-1), np.int32)
        jl, jc, _ = jlm.forward(jpp, jcfg, jnp.asarray(nxt), cache=jc,
                                gemv_policy=jpol, **_j(feats))
        tl, tc, _ = lm.forward(tpp, tcfg, torch.from_numpy(nxt).long(),
                               cache=tc, gemv_policy=tpol, **_t(feats))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"decode step {step}")
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tc[leaf].numpy(), np.asarray(jc[leaf]),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("kernel", ["pim", "splitk"])
@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_decode_step_through_each_kernel_matches_jax(arch, kernel):
    """One decode step with the kernel pinned on both sides: the JAX TPU
    backend in interpret-mode Pallas, the port's h100 backend on CPU
    tensors (the wrappers' plain versions).  Widths are multiples of 128
    so the TPU kernels apply (whisper's encoder stays at 64: its output
    goes through ``proj``); llama-vision has 2 kv heads for 4."""
    jcfg, jparams, tcfg, tparams = _pair(
        arch, seed=3, d_model=256, n_heads=4, n_kv_heads=2, head_dim=128,
        d_ff=512, vocab=512)
    feats = _features(jcfg, 2, seed=3)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 9))
    toks = toks.astype(np.int32)
    nxt = toks[:, -1:] + 1
    jc = jlm.init_cache(jcfg, 2, 16, per_slot_pos=True)
    tc = lm.init_cache(tcfg, 2, 16, per_slot_pos=True, device="cpu")
    _, jc, _ = jlm.forward(jparams, jcfg, jnp.asarray(toks), cache=jc,
                           **_j(feats))
    _, tc, _ = lm.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                          cache=tc, **_t(feats))

    jdispatch.clear_plan_cache()
    jpol = jdispatch.DispatchPolicy(backend="tpu", min_pallas_bytes=0,
                                    kernel=kernel)
    jl, _, _ = jlm.forward(jlm.prepack_decode_params(jparams, jcfg), jcfg,
                           jnp.asarray(nxt), cache=jc, gemv_policy=jpol,
                           **_j(feats))
    assert jdispatch.dispatch_stats()["kernel_picks"].get(
        f"tpu:{kernel}", 0) > 0
    jmodes = jdispatch.dispatch_stats()["program_modes"]

    dispatch.clear_plan_cache()
    tpol = DispatchPolicy(backend="h100", min_pallas_bytes=0, kernel=kernel)
    tl, _, _ = lm.forward(lm.prepack_decode_params(tparams, tcfg), tcfg,
                          torch.from_numpy(nxt).long(), cache=tc,
                          gemv_policy=tpol, **_t(feats))
    stats = dispatch.dispatch_stats()
    assert stats["kernel_picks"].get(f"h100:{kernel}", 0) > 0
    # the same programs as the JAX side: QKV, and gate+up when gated
    assert sum(stats["program_modes"].values()) == \
        sum(jmodes.values()) == (2 if arch == VISION else 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)


# (model, what changes, whether the logits must move)
TEETH = [("vision-2groups", "gate", True), ("vision-2groups", "vision", True),
         ("whisper", "frames", True), ("whisper", "gate", False)]


@pytest.mark.parametrize("name,change,moves", TEETH)
def test_the_cross_path_reaches_the_logits(models, name, change, moves):
    """llama-vision's logits move when ``cross_gate`` goes back to the
    JAX init's 0 (tanh(0) switches cross-attention off) and when the
    patch embeddings change; whisper's when the frames change, and not
    with its gate, which the JAX package never applies.  The changed
    model's logits still equal the JAX package's."""
    jcfg, jparams, tcfg, tparams = models[name]
    feats = _features(jcfg, 2, seed=5)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 7))
    jp2, tp2, feats2 = jparams, tparams, dict(feats)
    if change == "gate":
        tree = _gated(jax.tree.map(np.asarray, jparams), 0.0)
        jp2 = jax.tree.map(jnp.asarray, tree)
        tp2 = params_from_numpy(tree, tcfg, "cpu")
    else:
        # fresh draws: a constant shift of the frames would vanish in the
        # encoder's LayerNorms
        feats2[change] = _features(jcfg, 2, seed=6)[change]
    t = torch.from_numpy(toks)
    base, _, _ = lm.forward(tparams, tcfg, t, **_t(feats))
    got, _, _ = lm.forward(tp2, tcfg, t, **_t(feats2))
    want, _, _ = jlm.forward(jp2, jcfg, jnp.asarray(toks, jnp.int32),
                             **_j(feats2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    moved = (got - base).abs().max().item()
    if moves:
        assert moved > 1e-2
    else:
        assert moved == 0


@pytest.mark.parametrize("name", ["whisper", "vision"])
def test_engine_features_equal_the_jax_engines(models, name):
    """``Engine.features`` holds the JAX engine's ``_make_extra`` arrays:
    the same draws of ``default_rng(0)``, frames then vision, f32."""
    jcfg, jparams, tcfg, tparams = models[name]
    jeng = JaxEngine(jcfg, jparams, batch_slots=3, max_len=MAX_LEN)
    teng = Engine(tcfg, tparams, batch_slots=3, max_len=MAX_LEN,
                  device="cpu")
    assert sorted(teng.features) == sorted(jeng._extra) == (
        ["frames"] if name == "whisper" else ["vision"])
    for k, v in jeng._extra.items():
        assert teng.features[k].dtype == torch.float32
        np.testing.assert_array_equal(teng.features[k].numpy(),
                                      np.asarray(v))


# name: (model, Engine kwargs, route, prompt lengths, new tokens a request,
# the step each request joins at, slots)
BASIC = ([9, 5, 12], [5, 5, 5], [0, 0, 0], 4)
# request 0 finishes first, so compaction moves the live slot 2 down to 0
# (its features swap with row 0's) and request 3 later joins at slot 2,
# reading the row the swap left there
DEFRAG = ([5, 9, 7, 6], [2, 8, 6, 5], [0, 0, 0, 3], 3)
ENGINE_CASES = {
    "whisper-eager": ("whisper", {}, "eager", BASIC),
    "whisper-graph": ("whisper", {}, "graph", BASIC),
    "whisper-chunked": ("whisper", {"prefill_chunk": 4}, "eager", BASIC),
    "whisper-prefix-cache": ("whisper", {"prefix_cache": True}, "eager",
                             BASIC),
    "whisper-defrag": ("whisper", {}, "graph", DEFRAG),
    "vision-eager": ("vision-2groups", {}, "eager", BASIC),
    "vision-graph": ("vision-2groups", {}, "graph", BASIC),
    "vision-chunked": ("vision", {"prefill_chunk": 4}, "eager", BASIC),
    "vision-int8": ("vision-2groups", {"kv_store": "int8"}, "graph", BASIC),
    "vision-prefix-cache": ("vision", {"prefix_cache": True}, "graph",
                            BASIC),
    "vision-defrag": ("vision-2groups", {}, "eager", DEFRAG),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_tokens_and_logits_match_jax(models, case):
    """The port's Engine gives the JAX Engine's greedy tokens, and every
    row of logits it sampled from (prefill and each decode step) within
    ATOL: eagerly or through the graph stand-in, with chunked prefill
    (chunk 4), int8 KV pages, ``prefix_cache=True`` (accepted, and inert
    for these families on both sides), and a defrag that moves a live
    slot with its features before a new request takes the freed row."""
    name, kw, route, (lengths, new_tokens, joins, slots) = \
        ENGINE_CASES[case]
    jcfg, jparams, tcfg, tparams = models[name]
    kw = dict(batch_slots=slots, max_len=MAX_LEN, **kw)
    prompts = _prompts(jcfg.vocab, lengths, seed=21)
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = Engine(tcfg, tparams, device="cpu", **kw)
    rec = _graphed(teng) if route == "graph" else None
    jrows, trows = _logged(jeng), _logged(teng)
    moves = []
    compact = teng.kv.compact

    def logged_compact():
        out = compact()
        moves.extend(out.items())
        return out

    teng.kv.compact = logged_compact
    jdone = _drive(jeng, JaxRequest, prompts, new_tokens, joins)
    tdone = _drive(teng, Request, prompts, new_tokens, joins)
    assert sorted(tdone) == list(range(len(lengths)))
    assert tdone == jdone
    for rid in tdone:
        assert len(trows[rid]) == len(jrows[rid]) == new_tokens[rid]
        np.testing.assert_allclose(np.stack(trows[rid]),
                                   np.stack(jrows[rid]), atol=ATOL, rtol=0,
                                   err_msg=f"request {rid}")
    # the features are still a permutation of the rows they were drawn as
    fresh = Engine(tcfg, tparams, device="cpu", **kw).features
    for k, v in teng.features.items():
        rows = {tuple(r.flatten()[:4].tolist()) for r in v}
        assert rows == {tuple(r.flatten()[:4].tolist()) for r in fresh[k]}
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jeng._extra[k]))
    if rec is not None:
        assert rec.replayed > 0
    if "prefill_chunk" in kw:
        assert teng.metrics.counters["prefill_chunks"] == \
            jeng.metrics.counters["prefill_chunks"] > len(lengths)
    if "prefix_cache" in kw:
        assert teng.prefix is None and jeng.prefix is None
    if lengths is DEFRAG[0]:
        assert (2, 0) in moves


def test_a_replay_raises_when_a_feature_buffer_moved(models):
    """The decode graphs read the feature rows by address: rebinding
    ``Engine.features[...]`` to a new tensor raises at the next graph
    step instead of replaying the old rows."""
    _, _, tcfg, tparams = models["vision"]
    eng = Engine(tcfg, tparams, batch_slots=2, max_len=MAX_LEN, device="cpu")
    rec = _graphed(eng)
    for i, p in enumerate(_prompts(tcfg.vocab, [5, 7])):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=8))
    eng.step()
    eng.step()
    assert rec.captured == 1 and rec.replayed == 1
    eng.features["vision"] = eng.features["vision"].clone()
    with pytest.raises(RuntimeError, match="reassigned"):
        eng.step()
    assert rec.replayed == 1
