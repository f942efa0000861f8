"""hymba-1.5b (the hybrid family: Mamba heads in parallel with
sliding-window attention) against the JAX package, on the CPU.

Both packages get the same weights: the JAX ``init_lm`` tree of the
reduced config, perturbed in numpy and handed to the port through
``repro_torch.bridge``.  The init hides what a port could get wrong (both
betas are ones, so swapping the branches changes nothing; the skip ``D``
is ones, ``dt_bias`` zeros and every row of ``A_log`` the same), and at
its scale the tied head echoes the last token.  So every test here draws
the betas ~ U(2, 6), ``D`` ~ N(0, 1), ``dt_bias`` ~ N(-2, 1) and
``A_log`` ~ N(-1, 1) (decays near 1: the state carries over many
positions), and holds logits as well as tokens.

Tolerances (f32 on both sides; XLA and ATen sum in other orders): a
module's output and state at atol and rtol 1e-5, logits through the whole
model and the engine at 1e-4 absolute.  The reduced config has one query
head a kv head; the attention of hymba's GQA groups of 5 is held here on
its own (the plain path against the JAX ``attention_core``, 10 heads over
2 kv heads, with a window and without), and the kernel against the plain
path on the card (``test_torch_gpu.py``).

The engine: greedy tokens and every sampled row of logits equal the JAX
``Engine``'s in a wave, in chunks of 8 with the prefix cache off and on
(the reference's family sweep), eager and through the graph stand-in of
``test_torch_graphs.py``; and one test for each way the state plumbing
meets a family that has K/V as well as state: the save and restore, a
first chunk, a prefix hit, compaction and preemption, the decode graph.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_graphs import _graphed  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import attention  # noqa: E402
from repro_torch.kernels.backends import DispatchPolicy  # noqa: E402
from repro_torch.kernels.gemv_plan import SMEM_PER_CTA  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.kv_cache import SlotKVCache  # noqa: E402

ARCH = "hymba-1.5b"
TOL = dict(atol=1e-5, rtol=1e-5)
ATOL = 1e-4
MAX_LEN = 64
STATE = ("mamba_conv", "mamba_h")


def perturb(tree: dict, seed: int = 0) -> dict:
    """The JAX tree (numpy leaves, layers stacked) with the parameters the
    init hides drawn afresh (module docstring)."""
    rng = np.random.default_rng(seed)
    layers, m = tree["layers"], tree["layers"]["mamba"]

    def like(a, x):
        return np.asarray(x, np.float32).astype(a.dtype)

    for name in ("beta_attn", "beta_ssm"):
        layers[name] = like(layers[name],
                            rng.uniform(2, 6, layers[name].shape))
    m["D"] = like(m["D"], rng.standard_normal(m["D"].shape))
    m["dt_bias"] = like(m["dt_bias"],
                        rng.standard_normal(m["dt_bias"].shape) - 2)
    m["A_log"] = like(m["A_log"], rng.standard_normal(m["A_log"].shape) - 1)
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
# config, family gate, cache, bridge
# --------------------------------------------------------------------------


def test_config_matches_the_jax_package_full_and_reduced():
    for j, t in (_cfgs(), (ARCHS[ARCH], get_config(ARCH))):
        for f in dataclasses.fields(t):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert t.parallel_ssm and not t.attn_free
        lm.check_family(t)
    full = get_config(ARCH)
    assert (full.n_heads // full.n_kv_heads, full.hd) == (5, 64)
    windows = [lm.layer_window(full, i) for i in range(full.n_layers)]
    assert windows.count(1024) == 30 and windows.count(0) == 2
    tcfg = get_config(ARCH).reduced()
    assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.hd, tcfg.sliding_window,
            tcfg.global_every) == (4, 4, 16, 8, 2)
    assert ssm.mamba_dims(tcfg) == jssm.mamba_dims(ARCHS[ARCH].reduced()) \
        == (128, 8, 4)
    assert full.source == "arXiv:2411.13676"


def test_the_gate_admits_only_parallel_mamba_heads_in_the_hybrid_family():
    """A hybrid config without parallel heads, with rwkv6 heads, or
    parallel heads in another family is refused."""
    full = get_config(ARCH)
    for cfg in (dataclasses.replace(full, parallel_ssm=False),
                dataclasses.replace(full, ssm=None),
                dataclasses.replace(full, ssm=dataclasses.replace(
                    full.ssm, kind="rwkv6")),
                dataclasses.replace(full, family="dense"),
                dataclasses.replace(get_config("olmo-1b"),
                                    parallel_ssm=True, ssm=full.ssm)):
        with pytest.raises(ValueError, match="not ported"):
            lm.check_family(cfg)


@pytest.mark.parametrize("store", ["fp", "int8", "int4"])
def test_cache_holds_kv_and_the_mamba_state_in_every_store(store):
    """The JAX leaves in the JAX order, shapes and dtypes: K/V (and their
    scales) beside ``mamba_conv`` (model dtype) and ``mamba_h`` (f32),
    zeros; the serving cache's state leaves are the two Mamba leaves
    alone."""
    jcfg, tcfg = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    tc = lm.init_cache(tcfg, 2, 24, kv_store=store, device="cpu")
    jc = jlm.init_cache(jcfg, 2, 24, kv_store=store)
    assert list(tc) == list(jc)
    assert set(STATE) < set(tc) and "k" in tc
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)
    assert tc["mamba_conv"].dtype == torch.bfloat16
    assert tc["mamba_h"].dtype == torch.float32
    assert not tc["mamba_conv"].any() and not tc["mamba_h"].any()
    kv = SlotKVCache(tcfg, 2, 24, kv_store=store, device="cpu")
    assert kv.state_names == STATE and set(kv._saved) == set(STATE)


def test_bridge_carries_every_leaf_and_keeps_the_f32_leaves(model):
    """Every leaf of a bf16 JAX tree (the perturbed weights in the dtypes
    the JAX init gives a bf16 config) arrives bit for bit; the Mamba
    mixer's ``dt_bias``, ``A_log`` and ``D`` stay f32 as the JAX init
    keeps them, the rest is bf16, as the port's own init makes them; the
    prepack adds the fused QKV and gate+up and carries the Mamba weights
    and betas as they are."""
    jcfg, tcfg = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    dtypes = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(1),
                                                jcfg))
    jtree = jax.tree.map(lambda s, a: np.asarray(a).astype(s.dtype), dtypes,
                         model[1])
    tparams = params_from_numpy(jtree, tcfg, "cpu")
    own = lm.init_lm(tcfg, device="cpu")
    assert jax.tree.map(lambda t: t.dtype, own) == \
        jax.tree.map(lambda t: t.dtype, tparams)
    np.testing.assert_array_equal(
        tparams["embed"].float().numpy(),
        np.asarray(jtree["embed"], np.float32))
    flat = jax.tree_util.tree_flatten_with_path(jtree["layers"])[0]
    for i, layer in enumerate(tparams["layers"]):
        assert set(layer) == {"ln1", "ln2", "attn", "mamba", "beta_attn",
                              "beta_ssm", "mlp"}
        for path, leaf in flat:
            node = layer
            for k in path:
                node = node[k.key]
            f32 = path[0].key == "mamba" and path[-1].key in (
                "dt_bias", "A_log", "D")
            assert node.dtype == (torch.float32 if f32 else torch.bfloat16)
            np.testing.assert_array_equal(node.float().numpy(),
                                          np.asarray(leaf[i], np.float32))
    packed = lm.prepack_decode_params(tparams, tcfg)
    for p, q in zip(tparams["layers"], packed["layers"]):
        assert q["mamba"] is p["mamba"] and q["beta_ssm"] is p["beta_ssm"]
        assert "wqkv" in q["attn"] and "w_gateup" in q["mlp"]
    assert packed["head_t"].is_contiguous()


# --------------------------------------------------------------------------
# the Mamba mixer against the JAX package
# --------------------------------------------------------------------------


def _layer0(model):
    jcfg, jparams, tcfg, tparams = model
    return (jcfg, jax.tree.map(lambda a: a[0], jparams["layers"]), tcfg,
            tparams["layers"][0])


def _mamba_state(tcfg, B, seed):
    """A non-zero conv window ``[B, cw - 1, di]`` and state ``[B, di,
    n]``."""
    rng = np.random.default_rng(seed)
    di, n, cw = ssm.mamba_dims(tcfg)
    return (rng.standard_normal((B, cw - 1, di)).astype(np.float32),
            rng.standard_normal((B, di, n)).astype(np.float32))


@pytest.mark.parametrize("S,carried", [(1, True), (7, False), (7, True)])
def test_apply_mamba_matches_jax(model, S, carried):
    """Output, conv window and state; a carried state is advanced in
    place (the returned tensors are the ones given)."""
    jcfg, jp, tcfg, tp = _layer0(model)
    B = 3
    x = np.random.default_rng(S).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    conv, h = _mamba_state(tcfg, B, seed=S + 10)
    jstate = (jnp.asarray(conv), jnp.asarray(h)) if carried else None
    tstate = ((torch.from_numpy(conv.copy()), torch.from_numpy(h.copy()))
              if carried else None)
    jy, (jconv, jh) = jssm.apply_mamba(jp["mamba"], jnp.asarray(x), jcfg,
                                       state=jstate)
    ty, (tconv, th) = ssm.apply_mamba(tp["mamba"], torch.from_numpy(x),
                                      tcfg, state=tstate)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    if carried:
        assert tconv is tstate[0] and th is tstate[1]
        assert not np.array_equal(th.numpy(), h)


def test_conv_window_after_two_decode_steps_matches_the_reference(model):
    """Two one-token steps from a carried window: the window is the old
    one shifted by two (bit for bit) with the two new inputs behind it,
    and equals the reference's after each step; the state too."""
    jcfg, jp, tcfg, tp = _layer0(model)
    B = 2
    conv, h = _mamba_state(tcfg, B, seed=21)
    xs = np.random.default_rng(22).standard_normal(
        (2, B, 1, tcfg.d_model)).astype(np.float32)
    tstate = (torch.from_numpy(conv.copy()), torch.from_numpy(h.copy()))
    jstate = (jnp.asarray(conv), jnp.asarray(h))
    for x in xs:
        _, jstate = jssm.apply_mamba(jp["mamba"], jnp.asarray(x), jcfg,
                                     state=jstate)
        ssm.apply_mamba(tp["mamba"], torch.from_numpy(x), tcfg,
                        state=tstate)
        np.testing.assert_allclose(tstate[0].numpy(),
                                   np.asarray(jstate[0]), **TOL)
        np.testing.assert_allclose(tstate[1].numpy(),
                                   np.asarray(jstate[1]), **TOL)
    np.testing.assert_array_equal(tstate[0][:, 0].numpy(), conv[:, 2])
    # the two new rows are the inputs' x half of w_in, as the reference's
    x1 = np.stack([(torch.from_numpy(x) @ tp["mamba"]["w_in"])[:, 0].chunk(
        2, dim=-1)[0].numpy() for x in xs], axis=1)
    np.testing.assert_allclose(tstate[0][:, 1:].numpy(), x1, **TOL)


def test_the_perturbed_parameters_matter(model):
    """The Mamba branch moves the layer: its beta, ``D``, ``dt_bias`` and
    ``A_log`` each change the mixer's or the model's output (the JAX
    init's ones and zeros would hide a branch or a term left out)."""
    _, _, tcfg, tp = _layer0(model)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 5, tcfg.d_model)).astype(np.float32))
    y, _ = ssm.apply_mamba(tp["mamba"], x, tcfg)
    m = tp["mamba"]
    for change in ({"D": torch.zeros_like(m["D"])},
                   {"dt_bias": torch.zeros_like(m["dt_bias"])},
                   {"A_log": m["A_log"].flip(0)}):
        y2, _ = ssm.apply_mamba({**m, **change}, x, tcfg)
        assert (y2 - y).abs().max().item() > 1e-2, change
    _, _, _, tparams = model
    toks = torch.arange(3, 14)[None]
    base = lm.forward(tparams, tcfg, toks)[0]
    off = {**tparams, "layers": [{**p, "beta_ssm": torch.zeros_like(
        p["beta_ssm"])} for p in tparams["layers"]]}
    assert (lm.forward(off, tcfg, toks)[0] - base).abs().max() > 1e-1


# --------------------------------------------------------------------------
# the whole model, and attention at GQA groups of 5
# --------------------------------------------------------------------------


@pytest.mark.parametrize("heads", ["g1", "g5"])
def test_prefill_and_decode_logits_match_jax(model, heads):
    """Prefill 11 tokens into a cache (past the window of 8 of the local
    layer), then 4 decode steps (the dispatcher on prepacked weights from
    the second): logits, K/V and the Mamba leaves within tolerance, the
    state advanced in place; with no cache the same prefill logits.  The
    reduced config (4 heads, one a kv head), and the same with 10 heads
    over 2 kv heads: hymba's groups of 5 through the whole model."""
    jcfg, jparams, tcfg, tparams = (model if heads == "g1" else
                                    _pair(n_heads=10, n_kv_heads=2))
    assert tcfg.n_heads // tcfg.n_kv_heads == (1 if heads == "g1" else 5)
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
    leaves = {n: tc[n] for n in (*STATE, "k", "v")}
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
    for name, leaf in leaves.items():
        assert tc[name] is leaf                  # advanced in place
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    tl0, none, _ = lm.forward(tparams, tcfg, torch.from_numpy(toks).long())
    jl0, _, _ = jlm.forward(jparams, jcfg, jnp.asarray(toks))
    assert none is None
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), atol=ATOL,
                               rtol=0)


def test_int8_kv_store_stays_inside_the_family_tolerance(model):
    """The family sweep's int8 check for hymba: prefill 8 tokens and
    decode 3 with ``kv_store="int8"`` and ``"fp"``; the logits agree
    within the reference's 0.06 for this family, and the state leaves
    stay f32."""
    _, _, tcfg, tparams = model
    prompt = torch.arange(7, 15)[None]

    def logits_for(store):
        cache = lm.init_cache(tcfg, 1, 32, kv_store=store, device="cpu")
        assert cache["mamba_h"].dtype == torch.float32
        logits, cache, _ = lm.forward(tparams, tcfg, prompt, cache=cache)
        out = [logits[0, -1]]
        for _ in range(3):
            tok = out[-1].argmax().reshape(1, 1)
            logits, cache, _ = lm.forward(tparams, tcfg, tok, cache=cache)
            out.append(logits[0, -1])
        return torch.stack(out)

    assert (logits_for("int8") - logits_for("fp")).abs().max() < 0.06


def _g5_case(dtype, seed):
    """q [3, 1, 10, 16] over k / v [3, 24, 2, 16] (G 5), numpy f32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, 1, 10, 16)).astype(np.float32)
    k = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [0, 8], ids=["global", "window8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_attention_at_g5_matches_jax(window, dtype):
    """10 query heads over 2 kv heads: valid lengths 4, 16 and 24 (below,
    past and far past a window of 8), against the JAX ``attention_core``
    with the same window; f32 at 1e-5, bf16 within one bf16 ulp of the
    output plus one of a probability times max|v|
    (``test_torch_attention.py``'s rule).  The wrapper on CPU tensors and
    the model's ``attention_core`` are the same function."""
    q, k, v = _g5_case(dtype, seed=5 + window)
    qpos = np.array([3, 15, 23], np.int32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jlayers.attention_core(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        q_positions=jnp.asarray(qpos[:, None]),
        kv_valid_len=jnp.asarray(qpos + 1), window=window, causal=True)

    def t(a):
        return torch.from_numpy(a).to(dtype)

    args = dict(q_positions=torch.from_numpy(qpos[:, None]),
                kv_valid_len=torch.from_numpy(qpos + 1), window=window)
    got = attention.decode_attention_plain(t(q), t(k), t(v), **args)
    vmax = float(np.abs(np.asarray(jnp.asarray(v, jdt).astype(
        jnp.float32))).max())
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2.0**-7, atol=2.0**-8 * vmax))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    assert torch.equal(attention.decode_attention(t(q), t(k), t(v), **args),
                       got)
    assert torch.equal(L.attention_core(t(q), t(k), t(v), causal=True,
                                        **args), got)


def test_the_routing_rule_takes_hymbas_groups_of_5():
    """At hymba's decode shape (5 kv heads of 64, G 5, bf16) the shape
    rule passes and the split planner fits a 2048-position cache at every
    bucket; groups of 3 (no instance) stay refused."""
    for B in (1, 2, 4, 8):
        q = torch.zeros((B, 1, 25, 64), dtype=torch.bfloat16)
        kv = torch.zeros((B, 2048, 5, 64), dtype=torch.bfloat16)
        assert attention._shape_rule(q, kv, kv) == ""
        s = attention.plan_splits(B, 5, 2048, 5, 64, 132)
        assert s in attention.SPLITS
        assert attention.smem_bytes(5, 64, 2048, s) <= SMEM_PER_CTA
    assert attention.plan_splits(8, 5, 2048, 5, 64, 132) == 8
    q3 = torch.zeros((2, 1, 15, 64), dtype=torch.bfloat16)
    kv = torch.zeros((2, 64, 5, 64), dtype=torch.bfloat16)
    assert "not one of" in attention._shape_rule(q3, kv, kv)


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


def _shared_prefix_prompts(n=6, prefix_len=16):
    """The reference's family sweep: a shared prefix and two private
    tokens a request."""
    shared = list(range(10, 10 + prefix_len))
    return [np.asarray(shared + [100 + 7 * i, 40 + i], np.int32)
            for i in range(n)]


# name: (prompts, new tokens, engine keywords)
ENGINE_CASES = {
    "wave": (_prompts(256, [5, 9, 3, 12], seed=9), 5,
             dict(batch_slots=2)),
    "chunk8": (_shared_prefix_prompts(), 4,
               dict(batch_slots=4, prefill_chunk=8)),
    "chunk8_prefix": (_shared_prefix_prompts(), 4,
                      dict(batch_slots=4, prefill_chunk=8,
                           prefix_cache=True)),
}
_JAX_RUNS: dict = {}


def _serve(eng, make, prompts, new):
    rows = _logged(eng)
    for i, p in enumerate(prompts):
        eng.submit(make(rid=i, prompt=p, max_new_tokens=new))
    done = {r.rid: list(r.generated) for r in eng.run_until_drained()}
    return done, rows


def _jax_run(model, case):
    """The JAX ``Engine``'s tokens, logits rows and counters for a case
    (run once a module)."""
    if case not in _JAX_RUNS:
        jcfg, jparams, _, _ = model
        prompts, new, kw = ENGINE_CASES[case]
        jeng = JaxEngine(jcfg, jparams, max_len=MAX_LEN, **kw)
        done, rows = _serve(jeng, JaxRequest, prompts, new)
        _JAX_RUNS[case] = done, rows, dict(jeng.metrics.counters)
    return _JAX_RUNS[case]


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_tokens_and_logits_match_jax(model, case, graph):
    """Greedy tokens and every sampled row of logits equal the JAX
    ``Engine``'s: a wave of unequal lengths (each request prefilled alone
    at its exact length), chunks of 8 over 4 slots with requests decoding
    beside rows mid-prefill, and the same with the prefix cache (hits at
    chunk boundaries, the tokens they saved); eager and through the graph
    stand-in."""
    _, _, tcfg, tparams = model
    prompts, new, kw = ENGINE_CASES[case]
    jdone, jrows, jcounters = _jax_run(model, case)
    teng = Engine(tcfg, tparams, max_len=MAX_LEN, device="cpu", **kw)
    rec = _graphed(teng) if graph else None
    tdone, trows = _serve(teng, Request, prompts, new)
    assert tdone == jdone and sorted(tdone) == list(range(len(prompts)))
    assert len({tuple(t) for t in tdone.values()}) > 1
    for rid in tdone:
        np.testing.assert_allclose(np.stack(trows[rid]),
                                   np.stack(jrows[rid]), atol=ATOL, rtol=0,
                                   err_msg=f"request {rid}")
    c = teng.metrics.counters
    for k in ("prefill_chunks", "prefill_waves", "prefix_hits",
              "prefill_tokens_saved"):
        assert c.get(k, 0) == jcounters.get(k, 0), k
    if "prefix_cache" in kw:
        assert teng.prefix.has_state and c["prefix_hits"] > 0
        assert tdone == _jax_run(model, "chunk8")[0]     # cache on == off
    if graph:
        assert rec.replayed > 0


# --------------------------------------------------------------------------
# the state plumbing on a family with K/V and state
# --------------------------------------------------------------------------


class _Copies(TorchDispatchMode):
    """The shapes of every tensor ``copy_`` writes into."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.copy_.default:
            self.shapes.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


def test_save_and_restore_copy_only_the_mamba_rows(model):
    """The step's save and restore of a row mid-prefill copy the
    ``mamba_*`` rows of that slot and nothing of K/V: a K/V row written
    between them keeps its write."""
    _, _, tcfg, tparams = model
    eng = Engine(tcfg, tparams, batch_slots=3, max_len=16, device="cpu")
    cache = eng.kv.cache
    for leaf in cache.values():
        if leaf.ndim > 1:
            leaf.normal_()
    kept = {n: cache[n][:, 1].clone() for n in STATE}
    with _Copies() as copies:
        eng.kv.save_state([1])
    for leaf in cache.values():
        if leaf.ndim > 1:
            leaf[:, 1].add_(1)
    written = cache["k"][:, 1].clone()
    with _Copies() as restores:
        eng.kv.restore_state([1])
    rows = sorted(tuple(cache[n][:, 1].shape) for n in STATE)
    assert sorted(copies.shapes) == sorted(restores.shapes) == rows
    for n in STATE:
        assert torch.equal(cache[n][:, 1], kept[n]), n
    assert torch.equal(cache["k"][:, 1], written)


def test_a_first_chunk_zeroes_the_slots_mamba_leaves(model):
    """One slot: a request decodes on it and finishes, leaving state in the
    row; a longer one is admitted there and prefills in chunks of 4.  Its
    first chunk runs from zeroed ``mamba_*`` leaves (the K/V row is left
    to the mask), and its tokens and logits are a fresh engine's, bit for
    bit."""
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
            for n in STATE:
                assert eng.kv.cache[n][:, 0].abs().max() > 0, n
            zero, seen = eng.kv.zero_state, []

            def spied(slot):
                zero(slot)
                seen.append({n: eng.kv.cache[n][:, slot].abs().max().item()
                             for n in STATE})

            eng.kv.zero_state = spied
        eng.submit(Request(rid=1, prompt=second, max_new_tokens=5))
        done = {r.rid: r.generated for r in eng.run_until_drained()}
        assert eng.metrics.counters["prefill_chunks"] >= 4
        outs.append((done[1], np.stack(rows[1])))
    assert seen == [{n: 0.0 for n in STATE}]
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_a_prefix_hit_splices_the_kv_and_the_state_snapshot(model):
    """A second request with the first's 16-token prefix: the hit ends at
    a node that holds a snapshot (a chunk boundary), the slot's K/V up to
    that length and its ``mamba_*`` leaves are the gathered payload's,
    and its tokens and logits are those of an engine with no cache."""
    _, _, tcfg, tparams = model
    a, b = _shared_prefix_prompts(n=2)
    outs = {}
    for cached in (True, False):
        eng = Engine(tcfg, tparams, batch_slots=1, max_len=MAX_LEN,
                     prefill_chunk=8, prefix_cache=cached, device="cpu")
        rows = _logged(eng)
        splices = []
        if cached:
            splice = eng.kv.splice_prefix

            def checked(slot, payload, length):
                splice(slot, payload, length)
                cache = eng.kv.cache
                for n, span in payload["kv"].items():
                    assert torch.equal(cache[n][:, slot, :length], span), n
                assert set(payload["state"]) == set(STATE)
                for n in STATE:
                    assert torch.equal(cache[n][:, slot],
                                       payload["state"][n]), n
                splices.append(length)

            eng.kv.splice_prefix = checked
        for rid, p in enumerate((a, b)):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=4))
            eng.run_until_drained()
        outs[cached] = np.stack(rows[1])
        if cached:
            assert splices == [16]
            assert eng.metrics.counters["prefix_hits"] == 1
            for node in eng.prefix._walk():
                assert set(node.kv) == {"k", "v"}
                assert node.state is None or set(node.state) == set(STATE)
    np.testing.assert_allclose(outs[True], outs[False], atol=ATOL, rtol=0)
    assert (outs[True].argmax(-1) == outs[False].argmax(-1)).all()


def test_compact_moves_the_kv_and_the_state_rows():
    """Defrag moves a slot's K/V, scales and ``mamba_*`` rows (and its
    ``pos``) together, in every store."""
    tcfg = get_config(ARCH).reduced()
    for store in ("fp", "int8"):
        kv = SlotKVCache(tcfg, 3, 8, kv_store=store, device="cpu")
        for s in (kv.alloc(), kv.alloc(), kv.alloc()):
            for leaf in kv.cache.values():
                if leaf.ndim == 1:
                    leaf[s] = s + 1
                else:
                    leaf[:, s] = s + 1
        kv.free(0)
        assert kv.compact() == {2: 0}
        for name, leaf in kv.cache.items():
            row = leaf[0] if leaf.ndim == 1 else leaf[:, 0]
            assert (row == 3).all(), (store, name)


@pytest.mark.parametrize("victim", ["mid_prefill", "decoding"])
def test_a_preempted_request_resumes_from_its_kv_and_state(model, victim):
    """A victim evicted mid-prefill or while decoding files its K/V and
    state at the tokens it consumed; readmitted, it matches that node
    and gives the tokens and logits of a run that was never preempted."""
    _, _, tcfg, tparams = model
    prompt = _prompts(tcfg.vocab, [21], seed=12)[0]
    at = 2 if victim == "mid_prefill" else 7      # steps before the evict
    outs = []
    for preempt in (True, False):
        eng = Engine(tcfg, tparams, batch_slots=1, max_len=MAX_LEN,
                     prefill_chunk=4, prefix_cache=True, device="cpu")
        rows = _logged(eng)
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=6))
        for _ in range(at):
            eng.step()
        if preempt:
            assert bool(eng._prefilling) == (victim == "mid_prefill")
            eng.scheduler.wants_preemption = lambda now: True
            eng.step()
            del eng.scheduler.wants_preemption
            assert eng.metrics.counters["evicted"] == 1
        done = {r.rid: r.generated for r in eng.run_until_drained()}
        outs.append((done[0], np.stack(rows[0])))
        if preempt:
            assert eng.metrics.counters["prefix_hits"] == 1
    assert outs[0][0] == outs[1][0]
    np.testing.assert_allclose(outs[0][1], outs[1][1], atol=ATOL, rtol=0)


def test_a_replayed_decode_step_advances_mamba_h_in_place(model):
    """Through the graph stand-in: every replayed step advances the
    decoding rows' ``mamba_h`` and ``mamba_conv`` in the cache's own
    tensors (their addresses never change), while a row mid-prefill
    comes out of it bit-equal."""
    _, _, tcfg, tparams = model
    eng = Engine(tcfg, tparams, batch_slots=2, max_len=MAX_LEN,
                 prefill_chunk=4, device="cpu")
    rec = _graphed(eng)
    ptrs = {n: eng.kv.cache[n].data_ptr() for n in STATE}
    decode, seen = eng._decode, []

    def checked():
        mid = sorted(eng._prefilling)
        live = sorted(eng.active)
        before = {n: eng.kv.cache[n].clone() for n in STATE}
        replays = rec.replayed
        out = decode()
        if rec.replayed > replays:
            for n in STATE:
                leaf = eng.kv.cache[n]
                assert leaf.data_ptr() == ptrs[n]
                for s in live:
                    assert not torch.equal(leaf[:, s], before[n][:, s]), n
                for s in mid:
                    assert torch.equal(leaf[:, s], before[n][:, s]), n
            seen.append(len(mid))
        return out

    eng._decode = checked
    short, long = _prompts(tcfg.vocab, [3, 17], seed=6)
    eng.submit(Request(rid=0, prompt=short, max_new_tokens=8))
    eng.submit(Request(rid=1, prompt=long, max_new_tokens=3))
    eng.run_until_drained()
    assert len(seen) >= 3 and sum(seen) >= 1
