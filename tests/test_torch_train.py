"""The port's training pieces against the JAX package on the CPU: the
synthetic data stream, both optimizers on the same numpy gradients, the
train step's accumulation, remat, bf16 gradient compression and z-loss;
and the guard every hand-kernel wrapper keeps against autograd.

Both packages get the same weights (the JAX ``init_lm`` tree through
``repro_torch.bridge``) and the same numpy batches.  Everything runs in
f32; where the two sum in different orders (XLA against ATen) a test
states its tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# the machine with the card has no JAX: there this file skips
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.kernels.attention import decode_attention  # noqa: E402
from repro_torch.kernels.gemv_plan import (  # noqa: E402
    plan_gemv,
    plan_grouped_stream,
    plan_quant,
    plan_ragged_stream,
    plan_splitk,
)
from repro_torch.kernels.backends.gpu import plan_triton_gemv  # noqa: E402
from repro_torch.kernels.grouped_gemv import (  # noqa: E402
    grouped_gemv,
    ragged_gemv,
)
from repro_torch.kernels.ops import quantize_weight  # noqa: E402
from repro_torch.kernels.pim_gemv import pim_gemv  # noqa: E402
from repro_torch.kernels.quant_gemv import (  # noqa: E402
    quant4_gemv,
    quant_gemv,
)
from repro_torch.kernels.splitk_gemv import splitk_gemv  # noqa: E402
from repro_torch.kernels.triton_gemv import triton_gemv  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

# f32 on both sides, sums in different orders
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
OPT_RTOL, OPT_ATOL = 1e-5, 1e-6


def _cfgs(arch, **overrides):
    return (dataclasses.replace(ARCHS[arch].reduced(), **overrides),
            dataclasses.replace(get_config(arch).reduced(), **overrides))


def _pair(arch, seed=0, **overrides):
    jcfg, tcfg = _cfgs(arch, **overrides)
    jp = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _batch(cfg, B=4, S=16, seed=0):
    return tdata.SyntheticLM(
        cfg, tdata.DataConfig(global_batch=B, seq_len=S, seed=seed)
    ).batch_at(0)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_tree_close(port_tree, ref_tree, rtol, atol):
    """``port_tree`` (numpy, the reference's layout) against the
    reference's tree, leaf by leaf under the same paths."""
    a = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    b = jax.tree_util.tree_flatten_with_path(port_tree)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(np.asarray(y, np.float64),
                                   np.asarray(x, np.float64), rtol=rtol,
                                   atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-small",
                                  "llama-3.2-vision-11b"])
def test_synthetic_lm_is_bit_equal_to_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    for seed, n_shards, shard in ((0, 1, 0), (3, 2, 1), (7, 4, 2)):
        kw = dict(global_batch=8, seq_len=24, seed=seed, n_shards=n_shards,
                  shard_id=shard)
        jd = jdata.SyntheticLM(jcfg, jdata.DataConfig(**kw))
        td = tdata.SyntheticLM(tcfg, tdata.DataConfig(**kw))
        for step in (0, 1, 9):
            a, b = jd.batch_at(step), td.batch_at(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k],
                                                                   b[k]), k
        # __next__, state and restore step as the reference's do
        assert np.array_equal(next(jd)["tokens"], next(td)["tokens"])
        td.restore({"step": 5})
        assert td.state() == {"step": 5}
        assert np.array_equal(next(td)["tokens"], jd.batch_at(5)["tokens"])


# --------------------------------------------------------------------------
# Optimizers
# --------------------------------------------------------------------------

# gemma3-1b reduced, widened to 128 so Adafactor factors its matrices;
# RMSNorm scales [d] a layer, stacked [L, d] in the reference (they decay)
OPT_CASES = {
    "gemma3-1b-wide": ("gemma3-1b", dict(d_model=128, d_ff=256,
                                         head_dim=32)),
    "llama-vision": ("llama-3.2-vision-11b", {}),
    "whisper": ("whisper-small", {}),
}


def _numpy_grads(tree, seed, zero=()):
    """Seeded gradients shaped like the reference's tree; paths whose
    string holds one of ``zero`` get zeros."""
    rng = np.random.default_rng(seed)
    flat, tdef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, leaf in flat:
        g = rng.standard_normal(np.shape(leaf)).astype(np.float32) * 0.1
        if any(z in jax.tree_util.keystr(path) for z in zero):
            g = np.zeros_like(g)
        out.append(g)
    return jax.tree_util.tree_unflatten(tdef, out)


@pytest.mark.parametrize("case", sorted(OPT_CASES))
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_the_reference_on_the_same_gradients(name, case):
    """Two updates from the same params and gradients: the port's params
    and state (stacked back with the bridge) within 1e-6 of the
    reference's, the factored path included (gemma3 at 128: ``embed``,
    ``w_up``...).  The norm scales get zero gradients: their change is
    the reference's decoupled decay of a stacked ``[L, d]`` leaf, which
    the port's per-layer ``[d]`` leaves must follow; ``ln_f`` (``[d]``,
    not stacked) does not decay."""
    arch, over = OPT_CASES[case]
    jcfg, jp, tcfg, tp = _pair(arch, **over)
    ocfg = jopt.OptConfig(name=name, lr=1e-2, warmup_steps=1,
                          total_steps=10, weight_decay=0.1)
    tocfg = topt.OptConfig(name=name, lr=1e-2, warmup_steps=1,
                           total_steps=10, weight_decay=0.1)
    jinit, jupd = jopt.make_optimizer(ocfg)
    tinit, tupd = topt.make_optimizer(tocfg, tcfg)
    js, ts = jinit(jp), tinit(tp)
    if name == "adafactor" and case == "gemma3-1b-wide":
        assert "vr" in ts["f"]["embed"]
        assert "vr" in ts["f"]["layers"][0]["mlp"]["w_up"]
    for i in range(2):
        g = _numpy_grads(jp, seed=i, zero=("ln1", "ln2", "ln_f", "ln_cross"))
        jp, js = jupd(ocfg, jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = tupd(tocfg, params_from_numpy(g, tcfg, "cpu"), ts, tp)
    assert not any(t.requires_grad for t in leaves(tp))
    _assert_tree_close(params_to_numpy(tp, tcfg),
                       jax.tree.map(np.asarray, jp), OPT_RTOL, OPT_ATOL)
    _assert_tree_close(opt_state_to_numpy(ts, tcfg),
                       jax.tree.map(np.asarray, js), OPT_RTOL, OPT_ATOL)
    scale = tp["layers"][0]["ln1"]["scale"]
    assert float(scale.max()) < 1.0        # a per-layer scale decayed
    assert torch.equal(tp["ln_f"]["scale"], torch.ones_like(scale))
    # the state carries back: the bridge pair is an exact round trip
    back = opt_state_from_numpy(opt_state_to_numpy(ts, tcfg), tcfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(ts), leaves(back)))


def test_adafactor_rms_clip_is_one_mean_over_the_stacked_leaf():
    """A second update whose gradients grow 100x in layer 0 and 2x in
    layer 1: each layer's update RMS exceeds 1, by different amounts.
    The reference clips both layers by the RMS over the stacked leaf; the
    port's grouped leaves follow it, while the same update without the
    model's layout (each layer its own leaf) clips each alone and
    differs."""
    jcfg, jp, tcfg, tp = _pair("olmo-1b")
    ocfg = jopt.OptConfig(name="adafactor", lr=1e-2, warmup_steps=1,
                          total_steps=10)
    tocfg = topt.OptConfig(name="adafactor", lr=1e-2, warmup_steps=1,
                           total_steps=10)
    g1 = _numpy_grads(jp, seed=3)
    scale = np.array([100.0, 2.0], np.float32)
    g2 = jax.tree.map(lambda a: a * 2, g1)
    g2["layers"] = jax.tree.map(
        lambda a: a * scale.reshape((2,) + (1,) * (a.ndim - 1)),
        g1["layers"])
    js = jopt.adafactor_init(jp, ocfg)
    jq = jp
    for g in (g1, g2):
        jq, js = jopt.adafactor_update(ocfg, jax.tree.map(jnp.asarray, g),
                                       js, jq)
    out = {}
    for name, model in (("grouped", tcfg), ("alone", None)):
        ts, tq = topt.adafactor_init(tp, tocfg, model), tp
        for g in (g1, g2):
            tq, ts = topt.adafactor_update(
                tocfg, params_from_numpy(g, tcfg, "cpu"), ts, tq, model)
        out[name] = tq["layers"][0]["attn"]["wq"].numpy()
    want = np.asarray(jq["layers"]["attn"]["wq"][0])
    np.testing.assert_allclose(out["grouped"], want, rtol=OPT_RTOL,
                               atol=OPT_ATOL)
    assert not np.allclose(out["alone"], want, rtol=OPT_RTOL,
                           atol=OPT_ATOL)


def test_a_per_layer_leaf_factored_across_layers_raises():
    """With 128 layers a stacked ``[L, d]`` norm scale would be factored
    over the layer dim; the port refuses it rather than split the
    statistics across its leaves.  (No config has 128 layers.)"""
    cfg = dataclasses.replace(get_config("gemma3-1b").reduced(),
                              n_layers=128, d_model=128)
    params = {"layers": [{"ln1": {"scale": torch.ones(128)}}
                         for _ in range(128)]}
    with pytest.raises(ValueError, match="factored across layers"):
        topt.adafactor_init(params, topt.OptConfig(name="adafactor"), cfg)


def test_lr_schedule_and_clip_match_the_reference():
    cfg = jopt.OptConfig(lr=3e-4, warmup_steps=7, total_steps=50)
    tcfg = topt.OptConfig(lr=3e-4, warmup_steps=7, total_steps=50)
    for s in (0, 1, 6, 7, 8, 30, 49, 50, 60):
        assert float(topt.lr_at(tcfg, s)) == float(
            jopt.lr_at(cfg, jnp.asarray(s)))
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": [rng.standard_normal(4).astype(np.float32)]}
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    tc, tn = topt.clip_by_global_norm(
        {"a": torch.from_numpy(tree["a"]),
         "b": [torch.from_numpy(tree["b"][0])]}, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(tc["a"].numpy(), np.asarray(jc["a"]),
                               rtol=1e-6)


# --------------------------------------------------------------------------
# The train step
# --------------------------------------------------------------------------


def _tcfg(**kw):
    return tts.TrainConfig(opt=topt.OptConfig(lr=1e-3, warmup_steps=1,
                                              total_steps=10), **kw)


def _jtcfg(**kw):
    return jts.TrainConfig(opt=jopt.OptConfig(lr=1e-3, warmup_steps=1,
                                              total_steps=10), **kw)


def _jax_grads(jcfg, jp, batch, jtcfg):
    fn = jax.jit(jax.value_and_grad(jts.loss_fn, has_aux=True),
                 static_argnums=(1, 3))
    (_, (loss, aux)), g = fn(jp, jcfg, _jbatch(batch), jtcfg)
    return float(loss), float(aux), g


def _close_grads(tgrads, tcfg, jgrads, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    _assert_tree_close(params_to_numpy(tgrads, tcfg),
                       jax.tree.map(np.asarray, jgrads), rtol, atol)


def test_grad_accumulation_matches_the_large_batch():
    """accum_steps=2 over half batches against one step over the whole
    batch (``test_system.py::test_grad_accumulation_matches_large_batch``):
    the same mean loss and gradients (within f32 order noise, 1e-6), and
    params after the step within the reference's 5e-3."""
    tcfg = get_config("olmo-1b").reduced()
    params = lm.init_lm(tcfg, seed=0, device="cpu")
    batch = _batch(tcfg, B=8, S=32)
    s1, oi1 = tts.build_train_step(tcfg, _tcfg())
    s2, oi2 = tts.build_train_step(tcfg, _tcfg(accum_steps=2))
    mb = {k: v.reshape((2, 4) + v.shape[1:]) for k, v in batch.items()}
    g1, l1, _ = s1.grads(params, batch)
    g2, l2, _ = s2.grads(params, mb)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for a, b in zip(leaves(g1), leaves(g2)):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    p1, _, m1 = s1(params, oi1(params), batch)
    p2, _, m2 = s2(params, oi2(params), mb)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=5e-2)
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(p1), leaves(p2))) < 5e-3


def test_accumulated_step_matches_the_reference():
    """The accumulated step's loss and gradient norm against the
    reference's ``lax.scan`` over the same microbatches (olmo-1b)."""
    jcfg, jp, tcfg, tp = _pair("olmo-1b")
    batch = _batch(tcfg, B=4, S=16)
    mb = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in batch.items()}
    jstep, jinit = jts.build_train_step(jcfg, _jtcfg(accum_steps=2))
    _, _, jm = jax.jit(jstep)(jp, jinit(jp), _jbatch(mb))
    tstep, tinit = tts.build_train_step(tcfg, _tcfg(accum_steps=2))
    _, _, tm = tstep(tp, tinit(tp), mb)
    for k in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b", "rwkv6-3b",
                                  "hymba-1.5b", "whisper-small",
                                  "llama-3.2-vision-11b"])
def test_remat_on_is_bit_equal_to_remat_off(arch, monkeypatch):
    """Each layer under ``checkpoint`` (one call a layer) against the
    plain forward: loss, aux and every gradient the same bits."""
    tcfg = get_config(arch).reduced()
    params = lm.init_lm(tcfg, seed=1, device="cpu")
    batch = _batch(tcfg, B=2, S=12)
    calls = []
    real = lm.checkpoint
    monkeypatch.setattr(lm, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for remat in (True, False):
        calls.clear()
        cfg = dataclasses.replace(tcfg, remat=remat)
        step, _ = tts.build_train_step(cfg, _tcfg())
        out[remat] = step.grads(params, batch)
        assert len(calls) == (cfg.n_layers if remat else 0)
    (g1, l1, a1), (g0, l0, a0) = out[True], out[False]
    assert torch.equal(l1, l0) and torch.equal(a1, a0)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g0)))


def test_remat_leaves_decode_and_prefill_alone(monkeypatch):
    """Without autograd recording (the engine's forwards) no layer runs
    under ``checkpoint``, and the MoE layer takes its prefill products."""
    tcfg = get_config("deepseek-moe-16b").reduced()
    params = lm.init_lm(tcfg, seed=0, device="cpu")
    tokens = torch.from_numpy(_batch(tcfg, B=2, S=8)["tokens"])
    monkeypatch.setattr(lm, "checkpoint", lambda *a, **k: pytest.fail(
        "checkpoint outside training"))
    from repro_torch.models import layers as L

    seen = []
    real = L._moe_prefill
    monkeypatch.setattr(L, "_moe_prefill",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    assert tcfg.remat
    lm.forward(params, tcfg, tokens)
    assert len(seen) == tcfg.n_layers


def test_bf16_compression_matches_the_reference():
    """``grad_compress="bf16"``: each gradient rounded to bf16 and back.
    The port's compressed gradients against the reference's ``_compress``
    of its own (within one bf16 ulp, 2^-7 relative: the two f32 inputs
    differ by order noise, so a value next to a rounding boundary may
    round to the neighbouring bf16), and the step's metrics."""
    jcfg, jp, tcfg, tp = _pair("deepseek-moe-16b")
    batch = _batch(tcfg, B=2, S=16)
    step, init = tts.build_train_step(tcfg, _tcfg(grad_compress="bf16"))
    tg, _, _ = step.grads(tp, batch)
    assert all(torch.equal(g, g.to(torch.bfloat16).float())
               for g in leaves(tg))
    _, _, jg = _jax_grads(jcfg, jp, batch, _jtcfg())
    _close_grads(tg, tcfg, jts._compress(jg, "bf16"), rtol=2**-7,
                 atol=1e-7)
    jstep, jinit = jts.build_train_step(jcfg, _jtcfg(grad_compress="bf16"))
    _, _, jm = jax.jit(jstep)(jp, jinit(jp), _jbatch(batch))
    _, _, tm = step(tp, init(tp), batch)
    for k in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)


def test_z_loss_matches_the_reference():
    """``z_loss`` adds ``z * mean(lse^2)``: the loss and every gradient
    against the reference's (z = 0.1, so it moves them)."""
    jcfg, jp, tcfg, tp = _pair("gemma3-1b")
    batch = _batch(tcfg, B=2, S=16)
    jl, _, jg = _jax_grads(jcfg, jp, batch, _jtcfg(z_loss=0.1))
    jl0, _, _ = _jax_grads(jcfg, jp, batch, _jtcfg())
    step, _ = tts.build_train_step(tcfg, _tcfg(z_loss=0.1))
    tg, tl, _ = step.grads(tp, batch)
    assert jl != pytest.approx(jl0, rel=1e-3)
    np.testing.assert_allclose(float(tl), jl, rtol=1e-6)
    _close_grads(tg, tcfg, jg)


def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 33)).astype(np.float32) * 4
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    for z in (0.0, 1e-2):
        want = float(jts.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels), z))
        got = float(tts.cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels), z))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_the_step_returns_new_tensors_that_need_no_grad():
    """Functional, as the reference's step: the inputs are left as they
    were, and nothing returned requires grad."""
    tcfg = get_config("olmo-1b").reduced()
    params = lm.init_lm(tcfg, seed=0, device="cpu")
    before = [t.clone() for t in leaves(params)]
    step, init = tts.build_train_step(tcfg, _tcfg())
    state = init(params)
    new, new_state, m = step(params, state, _batch(tcfg, B=2, S=8))
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(params)))
    assert not any(t.requires_grad for t in leaves((new, new_state, m)))
    assert int(new_state["step"]) == 1 and int(state["step"]) == 0


@pytest.mark.parametrize("arch, item", [("rwkv6-3b", "2b"),
                                        ("hymba-1.5b", "2b"),
                                        ("whisper-small", "2a"),
                                        ("llama-3.2-vision-11b", "2a")])
def test_a_model_parallel_mesh_raises(arch, item):
    """A 'model' axis of 2 trains every family: since ROADMAP queue 1 item
    2a whisper and llama-vision, since item 2b rwkv6 and hymba (the step
    builds, on its layout, whose specs cut their mixers: a time-mix's
    ``wr`` on its heads' columns, a Mamba ``w_in`` as the pair ``[x1_r |
    z_r]``).  A 'pod' axis folds into data parallelism, as in the
    reference: the step builds on a ``{"pod": 2, "data": 1, "model": 1}``
    mesh too, and its layout's FSDP entries read ``("pod", "data")``
    (these meshes have no process groups: nothing is communicated)."""
    from repro_torch.distributed import sharding as shd

    mesh = Mesh(shape={"data": 1, "model": 2}, rank=0,
                coords={"data": 0, "model": 0})
    cfg = get_config(arch).reduced()
    assert cfg.family in shd.MESH_FAMILIES
    step, _ = tts.build_train_step(cfg, _tcfg(), mesh=mesh)
    assert step.layout is not None
    full, specs = shd.model_specs(cfg, mesh)
    cut = {"/".join(map(str, p)): s
           for (p, _), s in zip(shd.flatten_with_paths(full), specs)}
    if item == "2b":
        mixer = ("layers/0/time_mix/wr" if cfg.family == "ssm"
                 else "layers/0/mamba/w_in")
        assert cut[mixer] == (None, "model")
        assert cut[mixer].pairs == (2 if cfg.family == "hybrid" else 1)
    pod = Mesh(shape={"pod": 2, "data": 1, "model": 1}, rank=0,
               coords={"pod": 0, "data": 0, "model": 0})
    step, _ = tts.build_train_step(get_config("olmo-1b").reduced(), _tcfg(),
                                   mesh=pod)
    entries = {a for s in step.layout.specs for a in s if a is not None}
    assert entries == {("pod", "data")}


# --------------------------------------------------------------------------
# Kernel wrappers refuse autograd
# --------------------------------------------------------------------------


def _wrapper_calls():
    """Each hand-kernel wrapper with valid CPU inputs: (fn, args, kw)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    x, w = r(2, 64), r(64, 128)
    wq = quantize_weight(r(128, 64), bits=8, block=32, device="cpu")
    w4 = quantize_weight(r(128, 64), bits=4, block=32, device="cpu")
    xs, ws = r(4, 8, 64), r(4, 64, 128)
    offsets = torch.tensor([0, 3, 5, 5, 8], dtype=torch.int32)
    q, k = r(2, 1, 4, 16), r(2, 12, 2, 16)
    pos = torch.tensor([[5], [11]])
    return {
        "pim_gemv": (pim_gemv, (x, w), dict(plan=plan_gemv(
            128, 64, 2, elem_bytes=4, sms=132))),
        "splitk_gemv": (splitk_gemv, (x, w), dict(plan=plan_splitk(
            128, 64, 2, degree=2, elem_bytes=4, sms=132))),
        "quant_gemv": (quant_gemv, (x, wq.w_t, wq.scales), dict(
            block=32, plan=plan_quant(128, 64, 2, bits=8, elem_bytes=4,
                                      sms=132))),
        "quant4_gemv": (quant4_gemv, (x, w4.w_t, w4.scales), dict(
            block=32, plan=plan_quant(128, 64, 2, bits=4, elem_bytes=4,
                                      sms=132))),
        "grouped_gemv": (grouped_gemv, (xs, ws), dict(
            plan=plan_grouped_stream(128, 64, 8, E=4, sms=132,
                                     elem_bytes=4))),
        "ragged_gemv": (ragged_gemv, (r(8, 64), offsets, ws), dict(
            plan=plan_ragged_stream(128, 64, 8, E=4, sms=132,
                                    elem_bytes=4))),
        "triton_gemv": (triton_gemv, (x, w), dict(
            plan=plan_triton_gemv(128, 64, 2))),
        "decode_attention": (decode_attention, (q, k, k.clone()), dict(
            q_positions=pos, kv_valid_len=pos[:, 0] + 1)),
    }


@pytest.mark.parametrize("name", ["pim_gemv", "splitk_gemv", "quant_gemv",
                                  "quant4_gemv", "grouped_gemv",
                                  "ragged_gemv", "triton_gemv",
                                  "decode_attention"])
def test_kernel_wrapper_raises_under_autograd(name):
    """A wrapper raises when grad mode is on and an input requires grad
    (on any device: here the CPU, where it would run its plain version),
    and runs the same inputs under ``torch.no_grad()`` or detached."""
    fn, args, kw = _wrapper_calls()[name]
    plain = fn(*args, **kw)
    first = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="has no backward"):
        fn(first, *args[1:], **kw)
    with torch.no_grad():
        assert torch.equal(fn(first, *args[1:], **kw), plain)
    if args[-1].is_floating_point():    # a weight that requires grad
        last = args[-1].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="has no backward"):
            fn(*args[:-1], last, **kw)
