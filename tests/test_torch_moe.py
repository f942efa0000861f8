"""The port's MoE path (deepseek-moe-16b, reduced) against the JAX package.

Both packages get the same numpy inputs and weights (the JAX ``init_lm``
tree through ``repro_torch.bridge``).  Everything runs on the CPU: the
port's expert-kernel wrappers take their plain versions on CPU tensors.
The JAX Pallas ``grouped_gemv`` / ``ragged_gemv`` cannot run here even in
interpret mode, so the port is held against the JAX package's portable
executors (``GemvBackend._execute_ragged`` / ``_execute_grouped``), its
``apply_moe`` and its ``Engine``.  Tolerance: f32 on both sides, sums in
other orders (XLA vs ATen): 1e-5 absolute.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels import grouped_gemv as jgg  # noqa: E402
from repro.kernels.backends import base as jbase  # noqa: E402
from repro.kernels.backends import get_backend as jget_backend  # noqa: E402
from repro.kernels.ops import PackedWeights as JPacked  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as JScheduler  # noqa: E402
from repro.serving.scheduler import \
    SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.backends import DispatchPolicy, ProgramKey  # noqa
from repro_torch.kernels.backends import get_backend  # noqa: E402
from repro_torch.kernels.backends.base import (  # noqa: E402
    GemvProgram,
    expert_batch_bound,
)
from repro_torch.kernels.backends.h100 import H100Backend  # noqa: E402
from repro_torch.kernels.gemv_plan import (  # noqa: E402
    GemvPlan,
    plan_grouped_stream,
    plan_ragged_stream,
)
from repro_torch.kernels.grouped_gemv import (  # noqa: E402
    counts_to_offsets,
    grouped_gemv,
    plan_grouped_gemv,
    ragged_gemv,
)
from repro_torch.kernels.ops import PackedWeights  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    Scheduler,
    SchedulerConfig,
)

ATOL = 1e-5
ARCH = "deepseek-moe-16b"


def _cfgs():
    return ARCHS[ARCH].reduced(), get_config(ARCH).reduced()


def _jax_tree(tparams):
    """The port's params as the JAX package's tree (layers stacked [L, ...]),
    through numpy.  Drawing the weights on the port's side skips the JAX
    ``init_lm`` compile; the tree's layout is checked against it below."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return jnp.asarray(node.numpy())

    layers = tparams["layers"]
    stacked = jax.tree.map(lambda *ls: np.stack(ls),
                           *[jax.tree.map(lambda t: t.numpy(), lp)
                             for lp in layers])
    return {"embed": conv(tparams["embed"]), "ln_f": conv(tparams["ln_f"]),
            "layers": jax.tree.map(jnp.asarray, stacked)}


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    tparams = lm.init_lm(tcfg, seed=0, device="cpu")
    return jcfg, _jax_tree(tparams), tcfg, tparams


def _jit(fn, *args):
    """Run a JAX function under jit: one compile instead of op-by-op
    dispatch (host-side counters still record once, at trace time)."""
    return jax.jit(fn)(*args)


def _np(t):
    return t.detach().cpu().numpy()


def _routing(rng, T, E, k):
    """top_i [T, k] (distinct experts per token) and renormalised top_p."""
    top_i = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    top_p = rng.random((T, k)).astype(np.float32) + 0.1
    return top_i.astype(np.int32), top_p / top_p.sum(-1, keepdims=True)


# --------------------------------------------------------------------------
# configuration, bridge, packing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("reduce", [False, True])
def test_config_matches_the_jax_package(reduce):
    jcfg, tcfg = ARCHS[ARCH], get_config(ARCH)
    if reduce:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    for f in dataclasses.fields(tcfg):
        mine, theirs = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name == "moe":
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        else:
            assert mine == theirs, f.name


def test_bridge_carries_the_moe_leaves(models):
    jcfg, jparams, tcfg, _ = models
    e = tcfg.moe
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    for i, layer in enumerate(tparams["layers"]):
        moe = layer["moe"]
        assert "mlp" not in layer
        assert moe["router"].dtype == torch.float32
        assert moe["router"].shape == (tcfg.d_model, e.n_experts)
        assert moe["w_gate"].shape == (e.n_experts, tcfg.d_model, e.d_expert)
        assert moe["w_down"].shape == (e.n_experts, e.d_expert, tcfg.d_model)
        assert moe["shared"]["w_up"].shape == (tcfg.d_model,
                                               e.n_shared * e.d_expert)
        np.testing.assert_array_equal(
            _np(moe["w_up"]), np.asarray(jparams["layers"]["moe"]["w_up"][i]))


def test_init_lm_tree_matches_the_jax_init(models):
    """Layout, shapes and dtypes of the port's MoE init against the JAX
    ``init_lm`` (abstractly evaluated), and its N(0, 1/fan_in) scale."""
    jcfg, jparams, tcfg, tparams = models
    want = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    got = jax.tree.map(lambda a: (a.shape, a.dtype), jparams)
    assert got == jax.tree.map(lambda a: (a.shape, a.dtype), want)
    w = tparams["layers"][0]["moe"]["w_down"]
    assert abs(float(w.std()) * np.sqrt(tcfg.moe.d_expert) - 1) < 0.05


def test_packed_weights_stack_member_group():
    ws = [PackedWeights(w_t=torch.randn(16, 24)) for _ in range(3)]
    st = PackedWeights.stack(ws)
    assert st.group == 3 and st.shape == (16, 24) and ws[0].group == 1
    assert torch.equal(st.member(1).w_t, ws[1].w_t)
    with pytest.raises(ValueError, match="share shape"):
        PackedWeights.stack([ws[0], PackedWeights(w_t=torch.randn(16, 8))])
    with pytest.raises(ValueError, match="stacked"):
        ws[0].member(0)


def test_prepack_fuses_the_shared_experts(models):
    _, _, tcfg, tparams = models
    pp = lm.prepack_decode_params(tparams, tcfg)
    sh = pp["layers"][0]["moe"]["shared"]
    assert torch.equal(sh["w_gateup"],
                       torch.cat([sh["w_gate"], sh["w_up"]], dim=-1))
    # the expert stacks are read in place
    assert pp["layers"][0]["moe"]["w_up"] is tparams["layers"][0]["moe"][
        "w_up"]


# --------------------------------------------------------------------------
# routing and the expert kernels' plain versions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("T,E,k", [(8, 64, 6), (5, 8, 2), (1, 4, 4)])
def test_route_tokens_order_and_counts_match_jax(T, E, k):
    top_i, top_p = _routing(np.random.default_rng(T + E), T, E, k)
    jst, jse, jsw, jcounts = jL._route_tokens(
        jnp.asarray(top_i), jnp.asarray(top_p), E, k)
    st, se, sw, counts = L._route_tokens(
        torch.from_numpy(top_i).long(), torch.from_numpy(top_p), E, k)
    np.testing.assert_array_equal(_np(st), np.asarray(jst))
    np.testing.assert_array_equal(_np(se), np.asarray(jse))
    np.testing.assert_array_equal(_np(sw), np.asarray(jsw))
    np.testing.assert_array_equal(_np(counts), np.asarray(jcounts))
    assert counts.dtype == torch.int32


def test_counts_to_offsets_and_plan_match_jax():
    counts = np.array([3, 0, 5, 1, 0], np.int32)
    np.testing.assert_array_equal(
        _np(counts_to_offsets(torch.from_numpy(counts))),
        np.asarray(jgg.counts_to_offsets(jnp.asarray(counts))))
    for M, K in [(1408, 2048), (2048, 1408), (128, 64), (24, 40), (8, 8)]:
        mine, theirs = plan_grouped_gemv(M, K), jgg.plan_grouped_gemv(M, K)
        assert (mine.m_blk, mine.k_blk, mine.n_m, mine.n_k) == (
            theirs.m_blk, theirs.k_blk, theirs.n_m, theirs.n_k)


# counts per expert: balanced, empty experts, all rows on one expert, and
# counts that leave tail rows (sum < T)
RAGGED_COUNTS = {
    "balanced": [2, 2, 2, 2, 2, 2, 2, 2],
    "empty_experts": [0, 5, 0, 0, 6, 0, 5, 0],
    "skewed": [0, 0, 16, 0, 0, 0, 0, 0],
    "tail_rows": [1, 0, 3, 0, 2, 0, 0, 4],
}


@pytest.mark.parametrize("case", sorted(RAGGED_COUNTS))
def test_ragged_plain_and_portable_match_jax_executor(case):
    counts = np.array(RAGGED_COUNTS[case], np.int32)
    E, T, K, M = 8, 16, 64, 128
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((T, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, M)) / 8).astype(np.float32)
    jprog = jbase.GemvProgram.ragged(jnp.asarray(x), jnp.asarray(counts),
                                     JPacked(w_t=jnp.asarray(w)))
    want = np.asarray(jget_backend("cpu")._execute_ragged(jprog))
    xt, wt, ct = (torch.from_numpy(a) for a in (x, w, counts))
    n0 = ragged_gemv.launches
    got = ragged_gemv(xt, counts_to_offsets(ct), wt,
                      plan=plan_ragged_stream(M, K, T, E=E, sms=132,
                                              elem_bytes=4))
    assert ragged_gemv.launches == n0          # CPU: the plain version
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)
    prog = GemvProgram.ragged(xt, ct, PackedWeights(w_t=wt))
    portable = get_backend("cpu")._execute_ragged(prog)
    np.testing.assert_allclose(_np(portable), want, atol=ATOL, rtol=0)
    assert not _np(got)[counts.sum():].any()   # tail rows zero


@pytest.mark.parametrize("C", [1, 8, 11])
def test_grouped_plain_and_portable_match_jax_executor(C):
    E, K, M = 8, 64, 128
    rng = np.random.default_rng(C)
    xs = rng.standard_normal((E, C, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, M)) / 8).astype(np.float32)
    want = np.asarray(jget_backend("cpu")._execute_grouped(
        jnp.asarray(xs), JPacked(w_t=jnp.asarray(w))))
    xt, wt = torch.from_numpy(xs), torch.from_numpy(w)
    got = grouped_gemv(xt, wt, plan=plan_grouped_stream(
        M, K, C, E=E, sms=132, elem_bytes=4))
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)
    portable = get_backend("cpu")._execute_grouped(xt, PackedWeights(w_t=wt))
    np.testing.assert_allclose(_np(portable), want, atol=ATOL, rtol=0)
    # fusing off: one request per expert, stacked back
    dispatch.clear_plan_cache()
    per_request = dispatch.dispatch_grouped(
        xt, wt, policy=DispatchPolicy(backend="cpu", fuse_programs=False))
    np.testing.assert_allclose(_np(per_request), want, atol=ATOL, rtol=0)
    assert dispatch.dispatch_stats()["program_modes"] == {
        "cpu:per_request": 1}


def test_expert_wrappers_check_their_inputs():
    E, T, K, M = 4, 6, 64, 128
    plan = plan_ragged_stream(M, K, T, E=E, sms=132, elem_bytes=4)
    x = torch.randn(T, K)
    w = torch.randn(E, K, M)
    offs = counts_to_offsets(torch.tensor([2, 0, 3, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        ragged_gemv(x, offs.long(), w, plan=plan)
    with pytest.raises(ValueError, match="int32"):
        ragged_gemv(x, offs[:-1], w, plan=plan)
    with pytest.raises(ValueError, match="row-major"):
        ragged_gemv(x, offs, w.transpose(1, 2).contiguous().transpose(1, 2),
                    plan=plan)
    with pytest.raises(TypeError, match="share"):
        ragged_gemv(x.double(), offs, w, plan=plan)
    with pytest.raises(ValueError, match="tile"):   # 3 K parts: no cluster
        ragged_gemv(x, offs, w, plan=GemvPlan(m_blk=128, k_blk=64, n_m=1,
                                              n_k=1, smem_bytes=0,
                                              split_k=3))
    with pytest.raises(ValueError, match="tile"):   # a plan for M=256
        grouped_gemv(torch.randn(E, 2, K), torch.randn(E, K, 96),
                     plan=plan_grouped_stream(256, K, 2, E=E, sms=132,
                                              elem_bytes=4))
    # T = 0 and a column view of a wider stack (strided experts, in place)
    assert ragged_gemv(x[:0], torch.zeros(E + 1, dtype=torch.int32), w,
                       plan=plan).shape == (0, M)
    wide = torch.randn(E, K, 2 * M)
    view = wide[:, :, M:]
    np.testing.assert_allclose(
        _np(ragged_gemv(x, offs, view, plan=plan)),
        _np(ragged_gemv(x, offs, view.contiguous(), plan=plan)), atol=0)


# --------------------------------------------------------------------------
# apply_moe against the JAX package
# --------------------------------------------------------------------------


def _layer(models):
    jcfg, jparams, tcfg, tparams = models
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])["moe"]
    return jcfg, jp, tcfg, tparams["layers"][0]["moe"]


@pytest.mark.parametrize("shape", ["ragged", "grouped", "einsum"])
def test_apply_moe_decode_matches_jax(models, shape):
    jcfg, jp, tcfg, tp = _layer(models)
    x = np.random.default_rng(5).standard_normal(
        (4, 1, tcfg.d_model)).astype(np.float32)
    jpol = jdispatch.DispatchPolicy(backend="cpu", expert_shape=shape)
    jdispatch.clear_plan_cache()
    jy, jaux = _jit(lambda p, x: jL.apply_moe(p, x, jcfg, gemv=jpol), jp,
                    jnp.asarray(x))
    dispatch.clear_plan_cache()
    y, aux = L.apply_moe(tp, torch.from_numpy(x), tcfg,
                         gemv=DispatchPolicy(backend="h100",
                                             expert_shape=shape))
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-7, rtol=0)
    # the expert_load counter deltas of the call
    mine = dispatch.dispatch_stats()["expert_load"]
    if shape == "einsum":
        assert mine["decisions"] == 0
    else:
        assert mine == jdispatch.dispatch_stats()["expert_load"]
        assert mine["decisions"] == 1 and mine["routed_tokens"] == 4 * 2
        assert (mine["padded_slots"] == 0) == (shape == "ragged")


@pytest.mark.parametrize("capacity", [None, 8])
def test_apply_moe_prefill_matches_jax_with_and_without_drops(
        models, monkeypatch, capacity):
    """Prefill runs the capacity semantics without the [B, E, C, d]
    buffer.  The JAX rule is dropless up to S*top_k = 4096, so the drop
    case pins both packages' ``_capacity`` to 8 slots: with 40 tokens of
    top-2 over 8 experts (10 pairs per expert on average) pairs drop."""
    jcfg, jp, tcfg, tp = _layer(models)
    if capacity is not None:
        monkeypatch.setattr(jL, "_capacity", lambda n, cfg: capacity)
        monkeypatch.setattr(L, "_capacity", lambda n, cfg: capacity)
    x = np.random.default_rng(9).standard_normal(
        (3, 40, tcfg.d_model)).astype(np.float32)
    jy, jaux = _jit(lambda p, x: jL.apply_moe(p, x, jcfg), jp,
                    jnp.asarray(x))
    y, aux = L.apply_moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-7, rtol=0)
    if capacity is not None:
        _, _, _, _, _, keep, _ = L._capacity_plan(
            L._router(tp, torch.from_numpy(x), tcfg)[2],
            torch.zeros(3, 40, 2), capacity, tcfg.moe.n_experts)
        assert not keep.all()        # the case really drops pairs


def test_ragged_decode_reads_nothing_back_to_the_host(models, monkeypatch):
    """The ragged decode keeps counts, offsets and the sort on the device:
    every way of reading a tensor's value on the host raises here.  The
    ``cpu`` backend runs the portable executor (the h100 wrapper's plain
    twin on CPU tensors reads offsets by design)."""
    _, _, tcfg, tp = _layer(models)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 1, tcfg.d_model)).astype(np.float32))
    pol = DispatchPolicy(backend="cpu")
    L.apply_moe(tp, x, tcfg, gemv=pol)          # plan caches warm

    def refuse(*a, **k):
        raise AssertionError("host read of a tensor value")

    for name in ("item", "tolist", "numpy", "cpu", "__int__", "__index__",
                 "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    y, aux = L.apply_moe(tp, x, tcfg, gemv=pol)
    monkeypatch.undo()
    assert torch.isfinite(y).all() and torch.isfinite(aux)


def test_prefill_allocates_no_capacity_buffer(models, monkeypatch):
    """Prefill computes the capacity semantics over the expert-sorted
    pairs: no allocation reaches the [B, E, C, d] buffer's size."""
    jcfg, _, tcfg, tp = _layer(models)
    B, S = 2, 48
    C = L._capacity(S, tcfg)
    limit = B * tcfg.moe.n_experts * C * tcfg.d_model
    sizes = []
    for name in ("zeros", "zeros_like", "empty", "empty_like", "full"):
        real = getattr(torch, name)

        def spy(*a, real=real, **k):
            t = real(*a, **k)
            sizes.append(t.numel())
            return t

        monkeypatch.setattr(torch, name, spy)
    x = torch.randn(B, S, tcfg.d_model)
    L.apply_moe(tp, x, tcfg)
    monkeypatch.undo()
    assert sizes and max(sizes) <= B * S * tcfg.moe.top_k * tcfg.d_model
    assert max(sizes) < limit


def test_decode_step_logits_and_aux_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (3, 7))
    toks = toks.astype(np.int32)
    jc = jlm.init_cache(jcfg, 3, 16, per_slot_pos=True)
    tc = lm.init_cache(tcfg, 3, 16, per_slot_pos=True, device="cpu")
    jl_, jc, jaux = _jit(lambda p, t, c: jlm.forward(p, jcfg, t, cache=c),
                         jparams, jnp.asarray(toks), jc)
    tl, tc, aux = lm.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                             cache=tc)
    np.testing.assert_allclose(_np(tl), np.asarray(jl_), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    nxt = (toks[:, -1:] + 1) % jcfg.vocab
    jpol = jdispatch.DispatchPolicy(backend="cpu")
    jl_, _, _ = _jit(lambda p, t, c: jlm.forward(
        jlm.prepack_decode_params(p, jcfg), jcfg, t, cache=c,
        gemv_policy=jpol), jparams, jnp.asarray(nxt), jc)
    tl, _, _ = lm.forward(lm.prepack_decode_params(tparams, tcfg), tcfg,
                          torch.from_numpy(nxt).long(), cache=tc,
                          gemv_policy=DispatchPolicy(backend="h100"))
    np.testing.assert_allclose(_np(tl), np.asarray(jl_), atol=1e-4, rtol=0)


# --------------------------------------------------------------------------
# program planning
# --------------------------------------------------------------------------

# (kind, M, K, batch, bits, policy overrides): the first rows take the
# native modes; the rest fail one gate each
PROGRAM_CASES = [
    ("ragged", 1408, 2048, 2, 16, {}),          # deepseek gate/up, batch 8
    ("ragged", 2048, 1408, 2, 16, {}),          # deepseek down
    ("grouped", 1408, 2048, 8, 16, {}),         # one slot: C = 8
    ("ragged", 128, 64, 1, 16, {}),             # reduced config
    ("grouped", 1408, 2048, 64, 16, {}),        # 8 slots: C*B over 8
    ("ragged", 1408, 2048, 9, 16, {}),          # bound over the threshold
    ("ragged", 1408, 2048, 2, 8, {}),           # int8 stack
    ("grouped", 24, 2048, 8, 16, {}),           # no power-of-two M tile
    ("ragged", 1408, 2048, 2, 16, {"use_pallas": False}),
    ("grouped", 1408, 2048, 8, 16, {"fuse_programs": False}),
]


@pytest.mark.parametrize("case", PROGRAM_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}-b{c[3]}-w{c[4]}"
                              f"{''.join(c[5])}" for c in PROGRAM_CASES])
def test_h100_program_mode_pick_matches_the_jax_gpu_backend(case):
    """The native modes correspond to the JAX ``gpu`` backend's (triton
    there, cuda here); a shape it refuses takes the portable executor on
    both."""
    kind, M, K, batch, bits, overrides = case
    E, T = 64, 48
    common = dict(kind=kind, Ms=(M,), K=K, batch=batch, group=E, bits=bits,
                  block=32, tokens=T if kind == "ragged" else 0,
                  hist="le2m1" if kind == "ragged" else "")
    jkey = jbase.ProgramKey(dtype="bfloat16", backend="gpu", **common)
    tkey = ProgramKey(dtype="torch.bfloat16", backend="h100", **common)
    jplan = jget_backend("gpu").plan_program(
        jkey, policy=jdispatch.DispatchPolicy(interpret=True, **overrides))
    tplan = H100Backend(min_parallel_blocks=132).plan_program(
        tkey, policy=DispatchPolicy(**overrides))
    assert tplan.mode == jplan.mode.replace("_triton", "_cuda")
    assert tplan.n_launches == jplan.n_launches
    if tplan.mode.endswith("_cuda"):
        assert tplan.kernel == f"{kind}_gemv"
        assert tplan.plan == (
            plan_grouped_stream(M, K, batch, E=E, sms=132)
            if kind == "grouped" else plan_ragged_stream(M, K, T, E=E,
                                                          sms=132))


def test_program_keys_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((48, 64)).astype(np.float32)
    w = rng.standard_normal((8, 64, 128)).astype(np.float32)
    counts = np.full(8, 6, np.int32)
    jkey = jbase.GemvProgram.ragged(
        jnp.asarray(x), jnp.asarray(counts), JPacked(w_t=jnp.asarray(w)),
        bound=3).key("h")
    tkey = GemvProgram.ragged(torch.from_numpy(x), torch.from_numpy(counts),
                              PackedWeights(w_t=torch.from_numpy(w)),
                              bound=3).key("h")
    for f in ("kind", "Ms", "K", "batch", "group", "bits", "tokens", "hist"):
        assert getattr(tkey, f) == getattr(jkey, f), f
    for n, E in ((8, 64), (1, 64), (4, 8), (40, 8)):
        assert expert_batch_bound(n, 6, E) == jbase.expert_batch_bound(
            n, 6, E)


@pytest.mark.parametrize("kind,mode", [("ragged", "ragged"),
                                       ("ragged", "per_request"),
                                       ("grouped", "grouped"),
                                       ("grouped", "per_request"),
                                       ("fused", "fused")])
def test_program_cost_matches_the_jax_cpu_backend(kind, mode):
    """The program cost form at the shared CPU seeds."""
    common = dict(kind=kind, Ms=(1408,) if kind != "fused" else (512, 256),
                  K=2048, batch=3, group=64 if kind != "fused" else 2,
                  bits=16, block=32, tokens=48 if kind == "ragged" else 0,
                  hist="le4m1" if kind == "ragged" else "")
    jkey = jbase.ProgramKey(dtype="bfloat16", backend="cpu", **common)
    tkey = ProgramKey(dtype="torch.bfloat16", backend="cpu", **common)
    want = jget_backend("cpu").estimate_program_cost_us(jkey, mode=mode)
    got = get_backend("cpu").estimate_program_cost_us(tkey, mode=mode)
    assert got == pytest.approx(want, rel=1e-12)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


@pytest.mark.parametrize("skew", [None, 1.0, 3.5])
@pytest.mark.parametrize("threshold", [None, 2, 4])
def test_gemv_aware_expert_gate_matches_jax(skew, threshold):
    kw = dict(policy="gemv_aware", gemv_batch_threshold=8, moe_experts=8,
              moe_top_k=2, expert_batch_threshold=threshold)
    mine, theirs = Scheduler(SchedulerConfig(**kw)), JScheduler(
        JSchedulerConfig(**kw))
    if skew is not None:
        load = {"routed_tokens": 16, "max_tokens": int(2 * skew)}
        mine.observe_expert_load(load)
        theirs.observe_expert_load(load)
    for n_active in range(0, 8):
        for free in (1, 3, 8 - n_active):
            assert mine._admission_cap(free, n_active) == \
                theirs._admission_cap(free, n_active), (n_active, free)


@pytest.mark.parametrize("shape", ["ragged", "grouped"])
def test_engine_greedy_tokens_identical_to_jax(models, shape):
    """The mixed-length scenario of the JAX serving tests: the port's
    Engine on the h100 backend (CPU tensors: the expert kernels' plain
    versions) gives the JAX Engine's greedy tokens, request by request."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3, 12, 7)]
    jeng = JaxEngine(jcfg, jparams, batch_slots=4, max_len=64,
                     gemv_expert_shape=shape)
    teng = Engine(tcfg, tparams, batch_slots=4, max_len=64, device="cpu",
                  gemv_backend="h100", gemv_expert_shape=shape)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=6))
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    dispatch.clear_plan_cache()
    jdone = {r.rid: r.generated for r in jeng.run_until_drained()}
    tdone = {r.rid: r.generated for r in teng.run_until_drained()}
    assert sorted(tdone) == list(range(5))
    assert tdone == jdone
    modes = dispatch.dispatch_stats()["program_modes"]
    native = f"h100:{shape}_cuda"
    if shape == "ragged":
        assert modes.get(native, 0) > 0
        assert "h100:ragged" not in modes
    else:   # C * B = 8 per slot: only the 1-slot bucket fits the gate
        assert modes.get(native, 0) > 0 and modes.get("h100:grouped", 0) > 0


def test_engine_builds_an_expert_aware_scheduler(models):
    _, _, tcfg, tparams = models
    eng = Engine(tcfg, tparams, device="cpu", scheduler="gemv_aware")
    assert eng.scheduler.config.moe_experts == tcfg.moe.n_experts
    assert eng.scheduler.config.moe_top_k == tcfg.moe.top_k
    assert eng.gemv_policy.expert_shape == "ragged"
    rng = np.random.default_rng(1)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=rng.integers(0, 99, 4),
                           max_new_tokens=4))
    eng.run_until_drained()
    # the engine fed the decode steps' expert load back to the scheduler
    assert eng.scheduler._observed_skew is not None
    assert eng.metrics.dispatch_delta()["expert_load"]["decisions"] > 0
