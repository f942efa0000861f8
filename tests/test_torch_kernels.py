"""The port's decode GEMV kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
side runs the Pallas kernels in interpret mode, as tests/test_kernels.py
does.  Both get the same numpy inputs.  The CUDA kernels themselves are
held against the plain versions on the card in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

# One intra-op thread: the suite runs in parallel worker processes, and
# these small CPU tensors gain nothing from more threads.
torch.set_num_threads(1)

# the machine with the card has no JAX: there this file skips, and
# ``pytest -m gpu tests/test_torch_*.py`` runs tests/test_torch_gpu.py
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.pim_gemv import pim_gemv as jax_pim_gemv
from repro.kernels.splitk_gemv import splitk_gemv as jax_splitk_gemv
from repro.kernels.tpu_plan import plan_splitk as jax_plan_splitk
from repro.kernels import ref as jref
from repro.kernels.backends import get_backend
from repro.kernels.tpu_plan import plan_tpu_gemv
from repro_torch.kernels import _build, dispatch, ref
from repro_torch.kernels import backends as tbackends
from repro_torch.kernels.backends import DispatchPolicy, resolve_backend
from repro_torch.kernels.backends.h100 import H100Backend
from repro_torch.kernels.gemv_plan import (
    K_ALIGN,
    MAX_BATCH,
    DEFAULT_STAGES,
    MAX_M_BLK,
    MAX_STAGES,
    SMEM_PER_CTA,
    STREAM_M_BLKS,
    SUBTILE_BYTES,
    THREADS,
    GemvPlan,
    ctas_per_sm,
    kernel_applicable,
    plan_fits,
    plan_gemv,
    plan_splitk,
    plan_tile,
    stream_smem,
    valid_splitk_degree,
    vec_elems,
    with_pipeline_depth,
)
from repro_torch.kernels.ops import PackedWeights
from repro_torch.kernels.pim_gemv import pim_gemv, pim_gemv_plain
from repro_torch.kernels.splitk_gemv import splitk_gemv, splitk_gemv_plain

# f32: both sides accumulate in f32 in different orders; bf16: the output
# is rounded to bf16 (8 mantissa bits), one ulp is ~0.4% relative.
TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=1e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(M, K, B, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, M)).astype(np.float32),
            rng.standard_normal((B, K)).astype(np.float32))


def _both(w_t, x, dtype):
    jw = jnp.asarray(w_t).astype(dtype)
    jx = jnp.asarray(x).astype(dtype)
    tw = torch.from_numpy(w_t).to(TORCH_DT[dtype])
    tx = torch.from_numpy(x).to(TORCH_DT[dtype])
    return jw, jx, tw, tx


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


@pytest.mark.parametrize("M,K,B", [(256, 256, 1), (512, 1024, 2),
                                   (384, 768, 4), (1024, 512, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pim_gemv_matches_pallas(M, K, B, dtype):
    w_t, x = _inputs(M, K, B)
    jw, jx, tw, tx = _both(w_t, x, dtype)
    expect = jax_pim_gemv(jx, jw, plan=plan_tpu_gemv(M, K, B), interpret=True)
    plan = plan_gemv(M, K, B, elem_bytes=tx.element_size())
    out = pim_gemv(tx, tw, plan=plan)
    assert out.dtype == tx.dtype and out.shape == (B, M)
    np.testing.assert_allclose(_np(out), _np(expect), **TOL[dtype])


@pytest.mark.parametrize("degree", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_splitk_gemv_matches_pallas(degree, dtype):
    M, K, B = 256, 1024, 2
    w_t, x = _inputs(M, K, B, seed=degree)
    jw, jx, tw, tx = _both(w_t, x, dtype)
    expect = jax_splitk_gemv(jx, jw, plan=jax_plan_splitk(M, K, B,
                                                          degree=degree),
                             interpret=True)
    plan = plan_splitk(M, K, B, degree=degree,
                       elem_bytes=tx.element_size())
    assert plan.split_k == degree
    out = splitk_gemv(tx, tw, plan=plan)
    np.testing.assert_allclose(_np(out), _np(expect), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(ref.splitk_gemv_ref(tw, tx,
                                                                 degree)),
                               **TOL[dtype])


def test_wrappers_raise_on_bad_inputs_and_never_copy_w():
    w_t, x = _inputs(256, 512, 2)
    tw, tx = torch.from_numpy(w_t), torch.from_numpy(x)
    plan = plan_gemv(256, 512, 2, elem_bytes=4)
    with pytest.raises(ValueError, match="contiguous"):
        pim_gemv(tx, tw.t().contiguous().t(), plan=plan)   # non-contiguous
    with pytest.raises(TypeError):
        pim_gemv(tx.double(), tw.double(), plan=plan)
    with pytest.raises(TypeError):
        pim_gemv(tx, tw.to(torch.bfloat16), plan=plan)
    with pytest.raises(ValueError, match="K"):
        pim_gemv(tx[:, :256].contiguous(), tw, plan=plan)
    with pytest.raises(ValueError, match="batch"):
        pim_gemv(torch.zeros(MAX_BATCH + 1, 512), tw, plan=plan)
    with pytest.raises(ValueError, match="split_k"):
        splitk_gemv(tx, tw, plan=plan)                     # degree 1 plan
    with pytest.raises(ValueError, match="tile"):
        pim_gemv(tx, tw, plan=plan_gemv(128, 512, 2, elem_bytes=4))


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    w_t, x = _inputs(256, 512, 2)
    tw, tx = torch.from_numpy(w_t), torch.from_numpy(x)
    before = (pim_gemv.launches, splitk_gemv.launches)
    out = pim_gemv(tx, tw, plan=plan_gemv(256, 512, 2, elem_bytes=4))
    torch.testing.assert_close(out, pim_gemv_plain(tx, tw), rtol=0, atol=0)
    out = splitk_gemv(tx, tw, plan=plan_splitk(256, 512, 2, degree=4,
                                                elem_bytes=4))
    torch.testing.assert_close(out, splitk_gemv_plain(tx, tw, 4), rtol=0,
                               atol=0)
    assert (pim_gemv.launches, splitk_gemv.launches) == before


@pytest.mark.parametrize("M,K,B,elem", [
    (6144, 2048, 1, 2), (16384, 2048, 8, 2), (2048, 8192, 4, 2),
    (50304, 2048, 8, 2), (192, 64, 3, 4), (64, 128, 1, 2),
])
def test_plan_sweep_tall_first_and_divides(M, K, B, elem):
    # the streaming kernels' plan on 132 SMs: a column block they are built
    # for (the last may be ragged), 16 KB sub-tiles of whole k16 steps, the
    # grid resident in one wave, 128 columns unless that grid leaves SMs
    # idle, and the default ring depth
    p = plan_gemv(M, K, B, elem_bytes=elem, sms=132)
    assert p.m_blk in STREAM_M_BLKS and p.n_m == -(-M // p.m_blk)
    assert p.k_blk % 16 == 0 and p.n_k == -(-K // p.k_blk)
    assert p.k_blk * p.m_blk * elem <= SUBTILE_BYTES
    assert plan_fits(p, M, K, B, elem) and p.split_k == 1
    assert p.smem_bytes == stream_smem(B, p.m_blk, p.k_blk, p.stages, elem)
    held = ctas_per_sm(p.smem_bytes)
    assert p.n_m <= 132 * held
    assert p.m_blk == 128 or -(-M // 128) < 132
    assert p.stages == min(DEFAULT_STAGES, p.n_k)
    # the gemv_tile body's plan (the expert kernels) keeps the first sweep
    t = plan_tile(M, K, B, elem_bytes=elem)
    vec = vec_elems(elem)
    assert t.n_m * t.m_blk == M and t.n_k * t.k_blk == K
    assert t.m_blk <= MAX_M_BLK and t.m_blk % vec == 0
    assert THREADS % (t.m_blk // vec) == 0
    # tallest: doubling the block would no longer divide M or fit the cap
    assert 2 * t.m_blk > MAX_M_BLK or M % (2 * t.m_blk)
    assert t.smem_bytes <= 48 * 1024 and t.stages == 1
    assert t.k_blk % K_ALIGN == 0 or t.k_blk == K


def test_splitk_degree_and_applicability():
    assert valid_splitk_degree(2048) == 8
    assert valid_splitk_degree(48) == 2   # 48/8 = 6 and 48/4 = 12 rows
    assert valid_splitk_degree(12) is None
    assert kernel_applicable(50304, 2048) and kernel_applicable(192, 64)
    assert not kernel_applicable(100, 64)          # not whole vectors
    assert not kernel_applicable(128, 12)          # ragged K walk
    assert not kernel_applicable(128, 64, batch=MAX_BATCH + 1)


def test_build_command_targets_hopper():
    cmd = _build.nvcc_command("pim_gemv", _build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1] == str(_build.CSRC / "pim_gemv.cu")
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}


@pytest.mark.parametrize("B", [1, 4, 8])
def test_h100_selection_at_olmo_1b_shapes(B):
    """With the H100's 132 SMs the split matches the TPU backend's picks:
    split-K for the narrow QKV and down GEMVs, the output-stationary
    kernel for the 50304-wide LM head."""
    be = H100Backend(min_parallel_blocks=132)
    assert be.select_kernel(6144, 2048, B)[0] == "splitk"      # fused QKV
    assert be.select_kernel(2048, 8192, B)[0] == "splitk"      # down
    kernel, plan = be.select_kernel(50304, 2048, B)            # LM head
    assert kernel == "pim" and plan.n_m >= 132
    assert be.select_kernel(6144, 2048, B)[1].split_k == 8
    # the TPU backend's picks for the same GEMVs
    tpu = get_backend("tpu")
    for M, K in ((6144, 2048), (2048, 8192), (50304, 2048)):
        assert tpu.select_kernel(M, K, B)[0] == be.select_kernel(M, K, B)[0]


def test_h100_gates_and_pins():
    be = H100Backend(min_parallel_blocks=132)
    assert be.select_kernel(6144, 2048, 9)[0] == "ref"         # batch gate
    assert be.select_kernel(256, 256, 1)[0] == "ref"           # tiny weight
    assert be.select_kernel(6143, 2048, 1)[0] == "ref"         # ragged M
    pinned = DispatchPolicy(kernel="pim")
    assert be.select_kernel(256, 256, 1, policy=pinned)[0] == "pim"
    assert be.select_kernel(256, 12, 1,
                            policy=DispatchPolicy(kernel="splitk"))[0] \
        == "ref"                                               # no degree
    with pytest.raises(ValueError, match="unknown kernel"):
        be.select_kernel(256, 256, 1, policy=DispatchPolicy(kernel="grouped"))
    with pytest.raises(ValueError, match="requires int8/int4"):
        be.select_kernel(256, 256, 1, policy=DispatchPolicy(kernel="quant"))
    cm = be.cost_model
    assert cm.bandwidth_gbps == 3350.0 and cm.min_parallel_blocks == 132
    # split-K buys occupancy for a narrow GEMV (its partials stay on chip)
    p8 = plan_splitk(2048, 8192, 8, degree=8, sms=132)
    p1 = plan_gemv(2048, 8192, 8, sms=132)
    assert be.estimate_cost_us("splitk", 2048, 8192, 8, plan=p8) < \
        be.estimate_cost_us("pim", 2048, 8192, 8, plan=p1)


def test_h100_sm_count_needs_a_card_or_an_explicit_value(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="SM count"):
        H100Backend().cost_model


def test_backend_resolution_follows_the_device():
    assert resolve_backend(None, torch.device("cpu")).name == "cpu"
    assert resolve_backend(None, torch.device("cuda")).name == "h100"
    assert resolve_backend(DispatchPolicy(backend="h100"),
                           torch.device("cpu")).name == "h100"
    with pytest.raises(ValueError):
        resolve_backend(None, torch.device("meta"))


def test_cpu_backend_splitk_matches_ref():
    w_t, x = _inputs(256, 1024, 3, seed=9)
    tw, tx = torch.from_numpy(w_t), torch.from_numpy(x)
    cpu = tbackends.get_backend("cpu")
    kernel, plan = cpu.select_kernel(256, 1024, 3,
                                     policy=DispatchPolicy(kernel="splitk"))
    assert kernel == "splitk" and plan.split_k == 8
    out = cpu.execute(kernel, tx, PackedWeights(w_t=tw), plan)
    np.testing.assert_allclose(out.numpy(), x @ w_t, rtol=1e-5, atol=1e-4)


def test_dispatch_entry_points_and_plan_cache():
    dispatch.clear_plan_cache()
    rng = np.random.default_rng(11)
    wq, wk = (torch.from_numpy(rng.standard_normal((64, m)).astype(
        np.float32)) for m in (32, 16))
    x = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    q, k = dispatch.dispatch_fused(x, [wq, wk])
    torch.testing.assert_close(q, x @ wq)
    torch.testing.assert_close(k, x @ wk)
    fused = torch.cat([wq, wk], dim=1)
    q2, k2 = dispatch.dispatch_prepacked(x, fused, (32, 16))
    torch.testing.assert_close(q2, q, rtol=0, atol=0)
    out = dispatch.dispatch_dense(x[:, None], wq)
    assert out.shape == (2, 1, 32)
    torch.testing.assert_close(dispatch.dispatch_gemv(x, wq.t()), x @ wq)
    stats = dispatch.dispatch_stats()
    assert stats["program_modes"] == {"cpu:fused": 1}
    assert stats["plan_cache"]["program_hits"] == 1
    assert stats["plan_cache"]["misses"] == 1      # dense and gemv share
    assert stats["gemv_path"] == 2
    unfused = DispatchPolicy(fuse_programs=False)
    q3, _ = dispatch.dispatch_fused(x, [wq, wk], policy=unfused)
    torch.testing.assert_close(q3, q, rtol=0, atol=0)
    assert dispatch.dispatch_stats()["program_modes"]["cpu:per_request"] \
        == 1
    with pytest.raises(ValueError, match="m_splits"):
        dispatch.dispatch_prepacked(x, fused, (32, 8))
    dispatch.clear_plan_cache()
    assert dispatch.dispatch_stats()["kernel_picks"] == {}


# --------------------------------------------------------------------------
# the streaming kernels' planner: ring depth, grids, ragged edges
# --------------------------------------------------------------------------

OLMO_GEMVS = {"qkv": (6144, 2048), "gate_up": (16384, 2048),
              "down": (2048, 8192), "head": (50304, 2048)}
# the picks' geometry on 132 SMs (m_blk, CTAs, CTAs an SM holds)
OLMO_GRIDS = {"qkv": ("splitk", 128, 384, 3), "gate_up": ("pim", 64, 256, 2),
              "down": ("splitk", 64, 256, 2), "head": ("pim", 128, 393, 3)}


@pytest.mark.parametrize("B", range(1, MAX_BATCH + 1))
def test_olmo_plans_fit_the_card_at_every_batch(B):
    """At olmo-1b's decode shapes both kernels' default plans fit one
    CTA's shared memory; the picked kernel's grid is resident in one wave
    of 132 SMs and keeps at least 32 KB of weights in flight per SM."""
    be = H100Backend(min_parallel_blocks=132)
    for name, (M, K) in OLMO_GEMVS.items():
        for p in (plan_gemv(M, K, B, sms=132),
                  plan_splitk(M, K, B, degree=valid_splitk_degree(K),
                              sms=132)):
            assert plan_fits(p, M, K, B, 2)
            assert p.smem_bytes == stream_smem(B, p.m_blk, p.k_blk,
                                               p.stages, 2, p.split_k)
            assert p.smem_bytes <= SMEM_PER_CTA
        kernel, m_blk, ctas, per_sm = OLMO_GRIDS[name]
        picked, p = be.select_kernel(M, K, B)
        assert picked == kernel and p.m_blk == m_blk
        assert p.n_m * p.split_k == ctas
        assert ctas_per_sm(p.smem_bytes) >= per_sm
        assert ctas <= 132 * per_sm
        in_flight = per_sm * (p.stages - 1) * p.k_blk * p.m_blk * 2
        assert in_flight >= 32 * 1024


@pytest.mark.parametrize("M,K,B,deg", [(6144, 2048, 8, 8),
                                       (16384, 2048, 8, 1),
                                       (2048, 8192, 1, 8),
                                       (50304, 2048, 4, 1),
                                       (200, 48, 3, 2)])
def test_with_pipeline_depth_restages_only_the_ring(M, K, B, deg):
    base = (plan_splitk(M, K, B, degree=deg, sms=132) if deg > 1
            else plan_gemv(M, K, B, sms=132))
    assert with_pipeline_depth(base, base.stages, batch=B) is base
    assert with_pipeline_depth(base, 0, batch=B) is None
    assert with_pipeline_depth(base, MAX_STAGES + 1, batch=B) is None
    for depth in range(1, MAX_STAGES + 1):
        p = with_pipeline_depth(base, depth, batch=B, elem_bytes=2)
        smem = stream_smem(B, base.m_blk, base.k_blk, depth, 2, deg)
        if depth > base.n_k or smem > SMEM_PER_CTA:
            assert p is None
            continue
        # the same tiles, so the same order of sums: only the ring differs
        assert (p.m_blk, p.k_blk, p.n_m, p.n_k, p.split_k) == (
            base.m_blk, base.k_blk, base.n_m, base.n_k, base.split_k)
        assert p.stages == depth and p.smem_bytes == smem
        assert plan_fits(p, M, K, B, 2)
    # the sub-tile follows from the column block alone, never from the
    # depth the SM count leads the planner to
    for sms in (1, 8, 132, 1024):
        q = (plan_splitk(M, K, B, degree=deg, sms=sms) if deg > 1
             else plan_gemv(M, K, B, sms=sms))
        if q.m_blk == base.m_blk:
            assert q.k_blk == base.k_blk


def test_plan_fits_refuses_what_the_kernels_do_not_take():
    p = plan_gemv(256, 512, 2, sms=132)
    assert plan_fits(p, 256, 512, 2)
    for bad in (dict(m_blk=32, n_m=8), dict(m_blk=256, n_m=1),
                dict(k_blk=24), dict(k_blk=272, n_k=2), dict(stages=0),
                dict(stages=MAX_STAGES + 1), dict(n_m=p.n_m + 1),
                dict(split_k=3), dict(split_k=16)):
        assert not plan_fits(GemvPlan(**{**p.__dict__, **bad}), 256, 512, 2)
    # a ring past one CTA's shared memory
    big = GemvPlan(m_blk=128, k_blk=1024, n_m=2, n_k=1, smem_bytes=0)
    assert not plan_fits(big, 256, 1024, 8)


@pytest.mark.parametrize("M,K,B,deg", [(200, 48, 3, 2), (200, 48, 8, 1),
                                       (72, 96, 5, 4), (136, 24, 1, 1),
                                       (264, 192, 7, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_edges_plan_and_match_jax_ref(M, K, B, deg, dtype):
    """M = 8 mod 16 (a ragged last column block) and K parts that are not
    whole k16 sub-tiles (24 rows of K = 48 at degree 2): the plan covers
    them (the kernels zero-fill the edge), and the port computes the JAX
    package's function there."""
    p = (plan_splitk(M, K, B, degree=deg, sms=132) if deg > 1
         else plan_gemv(M, K, B, sms=132))
    assert plan_fits(p, M, K, B, 2) and p.n_m * p.m_blk >= M
    w_t, x = _inputs(M, K, B, seed=M + K)
    jw, jx, tw, tx = _both(w_t, x, dtype)
    p = (plan_splitk(M, K, B, degree=deg, sms=132,
                     elem_bytes=tx.element_size()) if deg > 1
         else plan_gemv(M, K, B, sms=132, elem_bytes=tx.element_size()))
    if deg > 1:
        out = splitk_gemv(tx, tw, plan=p)
        expect = jref.splitk_gemv_ref(jw, jx, deg)
    else:
        out = pim_gemv(tx, tw, plan=p)
        expect = jref.gemv_ref(jw, jx)
    assert out.shape == (B, M) and out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(expect), **TOL[dtype])


def test_h100_prices_splitk_as_one_launch_without_partials():
    be = H100Backend(min_parallel_blocks=132)
    cm = be.cost_model
    for M, K in ((6144, 2048), (2048, 8192)):
        kernel, p = be.select_kernel(M, K, 8)
        assert kernel == "splitk" and p.n_m * p.split_k >= 132
        io = be.io_bytes(M, K, 8, bits=16, x_bytes=2)
        want = (io / cm.bandwidth_bps * 1e6 + cm.launch_us
                + cm.program_us * p.n_m * p.split_k)
        assert be.estimate_cost_us("splitk", M, K, 8, plan=p) == \
            pytest.approx(want)
