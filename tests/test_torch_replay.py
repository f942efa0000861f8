"""Autotune-table replays and the streaming planners of the expert and
column-block kernels.

A table entry keeps its kernel; a plan the kernel no longer takes (a table
written by an earlier build) is re-planned by the backend instead of
raising at launch.  Everything here runs on the CPU (the wrappers take
their plain versions on CPU tensors), with the backends sized for 132 SMs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.backends import DispatchPolicy, GemvKey, base
from repro_torch.kernels.backends.base import (
    GemvProgram,
    ProgramKey,
    ProgramPlan,
    plan_to_entry,
    program_plan_to_entry,
)
from repro_torch.kernels.backends.gpu import GpuBackend, plan_triton_gemv
from repro_torch.kernels.backends.h100 import H100Backend
from repro_torch.kernels import ref
from repro_torch.kernels.gemv_plan import (
    DEFAULT_STAGES,
    MAX_STAGES,
    STREAM_M_BLKS,
    SUBTILE_BYTES,
    GemvPlan,
    ctas_per_sm,
    grouped_plan_fits,
    plan_fits,
    plan_grouped_stream,
    quant_plan_fits,
    stream_rows,
    stream_smem,
    sub_rows,
    with_pipeline_depth,
)
from repro_torch.kernels.grouped_gemv import plan_expert_gemv
from repro_torch.kernels.ops import PackedWeights, quantize_weight
from repro_torch.kernels.triton_gemv import body_ctas, body_m_blk
from repro_torch.kernels.triton_gemv import plan_fits as triton_plan_fits

torch.set_num_threads(1)

SMS = 132


@pytest.fixture
def fresh_tables():
    dispatch.clear_autotune_table()
    dispatch.clear_plan_cache()
    yield dispatch.autotune_table()
    dispatch.clear_autotune_table()
    dispatch.clear_plan_cache()


def _record(monkeypatch, cls, method):
    """Record the plans ``cls.method`` is called with."""
    seen, real = [], getattr(cls, method)

    def spy(self, *args):
        seen.append(args)
        return real(self, *args)

    monkeypatch.setattr(cls, method, spy)
    return seen


def _reload(table, tmp_path):
    path = str(tmp_path / "table.json")
    table.save(path)
    dispatch.clear_autotune_table()
    dispatch.clear_plan_cache()
    dispatch.load_autotune_table(path)


# An h100 table written before the streaming kernels: one stage, a K
# chunk of 1024 rows (pim) or of the whole 512-row K part (split-K).
STALE_H100 = {
    "pim": dict(m_blk=128, k_blk=1024, n_m=2, n_k=4, split_k=1),
    "splitk": dict(m_blk=128, k_blk=512, n_m=2, n_k=1, split_k=8),
}


@pytest.mark.parametrize("bits", [8, 4])
def test_a_stale_h100_quant_entry_replays_at_its_kernel(bits, tmp_path,
                                                        monkeypatch,
                                                        fresh_tables):
    """A quant entry written before the quant kernels streamed (the
    scalar kernel's plan: a 256-column block, a K chunk of 1024 rows, no
    ring depth) replays at its kernel on a re-planned plan; the
    autotuner's own table hit does the same."""
    M, K, B = 512, 2048, 2
    kname = "quant" if bits == 8 else "quant4"
    be = H100Backend(min_parallel_blocks=SMS)
    monkeypatch.setitem(base._REGISTRY, "h100", be)
    rng = np.random.default_rng(bits)
    pw = quantize_weight(torch.from_numpy(
        rng.standard_normal((M, K)).astype(np.float32)), bits=bits)
    x = torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32))
    entry = {"kernel": kname, "us": 5.0, "m_blk": 256, "k_blk": 1024,
             "n_m": 2, "n_k": 2, "split_k": 1, "smem_bytes": 36864}
    stale = base.entry_to_plan(entry)[1]
    assert stale.stages == 1
    assert not quant_plan_fits(stale, M, K, B, bits=bits, block=32,
                               elem_bytes=4)
    key = GemvKey(M=M, K=K, batch=B, bits=bits, block=32,
                  dtype=str(x.dtype), backend="h100")
    fresh_tables.put("h100", key.table_key(), entry)
    _reload(fresh_tables, tmp_path)
    seen = _record(monkeypatch, H100Backend, "execute")
    out = dispatch.dispatch_gemv(x, pw, policy=DispatchPolicy(backend="h100"))
    fn = ref.quant_gemv_ref if bits == 8 else ref.quant4_gemv_ref
    np.testing.assert_allclose(out.numpy(),
                               fn(pw.w_t, pw.scales, x, 32).numpy(),
                               rtol=1e-5, atol=1e-5)
    (ran, _, _, plan), = seen
    assert ran == kname
    assert quant_plan_fits(plan, M, K, B, bits=bits, block=32, elem_bytes=4)
    dispatch.clear_plan_cache()
    assert be.autotune_gemv(key, policy=DispatchPolicy(backend="h100"),
                            table=fresh_tables,
                            device=torch.device("cpu")) == (kname, plan)


@pytest.mark.parametrize("kernel", sorted(STALE_H100))
def test_a_stale_h100_entry_replays_at_its_kernel(kernel, tmp_path,
                                                  monkeypatch, fresh_tables):
    M, K, B = 256, 4096, 2
    be = H100Backend(min_parallel_blocks=SMS)
    monkeypatch.setitem(base._REGISTRY, "h100", be)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32))
    w_t = torch.from_numpy(
        (rng.standard_normal((K, M)) / np.sqrt(K)).astype(np.float32))
    stale = GemvPlan(smem_bytes=0, stages=1, **STALE_H100[kernel])
    assert not plan_fits(stale, M, K, B, 4)
    key = GemvKey(M=M, K=K, batch=B, bits=16, block=32, dtype=str(x.dtype),
                  backend="h100")
    fresh_tables.put("h100", key.table_key(),
                     plan_to_entry(kernel, stale, 5.0))
    _reload(fresh_tables, tmp_path)
    seen = _record(monkeypatch, H100Backend, "execute")
    out = dispatch.dispatch_gemv(x, PackedWeights(w_t=w_t),
                                 policy=DispatchPolicy(backend="h100"))
    np.testing.assert_allclose(out.numpy(), (x @ w_t).numpy(), rtol=1e-5,
                               atol=1e-5)
    (ran, _, _, plan), = seen
    assert ran == kernel and plan_fits(plan, M, K, B, 4)
    assert plan.split_k == stale.split_k
    # the autotuner's own table hit replays the same way
    dispatch.clear_plan_cache()
    assert be.autotune_gemv(key, policy=DispatchPolicy(backend="h100"),
                            table=fresh_tables,
                            device=torch.device("cpu")) == (kernel, plan)


def test_a_ref_entry_stays_ref(tmp_path, monkeypatch, fresh_tables):
    monkeypatch.setitem(base._REGISTRY, "h100",
                        H100Backend(min_parallel_blocks=SMS))
    x = torch.randn(2, 512)
    w_t = torch.randn(512, 256)
    key = GemvKey(M=256, K=512, batch=2, bits=16, block=32,
                  dtype=str(x.dtype), backend="h100")
    fresh_tables.put("h100", key.table_key(), plan_to_entry("ref", None, 1.0))
    _reload(fresh_tables, tmp_path)
    dispatch.dispatch_gemv(x, PackedWeights(w_t=w_t),
                           policy=DispatchPolicy(backend="h100"))
    assert dispatch.dispatch_stats()["kernel_picks"] == {"h100:ref": 1}


# grouped_cuda entries from earlier builds: the gemv_tile plan of the
# first grouped kernel (one stage, a 1024-row x chunk), and a whole-K
# chunk past that kernel's x budget
STALE_GROUPED = {
    "tile_plan": dict(m_blk=128, k_blk=1024, n_m=2, n_k=2),
    "whole_k": dict(m_blk=128, k_blk=2048, n_m=2, n_k=1),
}


@pytest.mark.parametrize("case", sorted(STALE_GROUPED))
def test_a_stale_grouped_cuda_entry_replays_in_its_mode(
        case, tmp_path, monkeypatch, fresh_tables):
    E, C, K, M = 4, 8, 2048, 256
    be = H100Backend(min_parallel_blocks=SMS)
    monkeypatch.setitem(base._REGISTRY, "h100", be)
    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.standard_normal((E, C, K)).astype(np.float32))
    w = torch.from_numpy(
        (rng.standard_normal((E, K, M)) / np.sqrt(K)).astype(np.float32))
    stale = GemvPlan(smem_bytes=0, stages=1, **STALE_GROUPED[case])
    assert not grouped_plan_fits(stale, M, K, C, 4)
    pkey = GemvProgram.grouped(xs, PackedWeights(w_t=w)).key("h100")
    fresh_tables.put_program("h100", pkey.table_key(), program_plan_to_entry(
        ProgramPlan(mode="grouped_cuda", n_launches=1, kernel="grouped_gemv",
                    plan=stale), 5.0))
    _reload(fresh_tables, tmp_path)
    seen = _record(monkeypatch, H100Backend, "execute_program")
    out = dispatch.dispatch_grouped(xs, w,
                                    policy=DispatchPolicy(backend="h100"))
    np.testing.assert_allclose(out.numpy(), torch.matmul(xs, w).numpy(),
                               rtol=1e-5, atol=1e-5)
    (_, pplan), = seen
    assert pplan.mode == "grouped_cuda" and pplan.kernel == "grouped_gemv"
    assert pplan.plan == be.plan_program(pkey).plan
    assert grouped_plan_fits(pplan.plan, M, K, C, 4)
    assert dispatch.dispatch_stats()["program_modes"] == {
        "h100:grouped_cuda": 1}


def test_a_fused_entry_replays_its_inner_plan(tmp_path, monkeypatch,
                                              fresh_tables):
    """A fused program entry whose inner pim plan is stale replays as the
    fused GEMV's own entry would."""
    monkeypatch.setitem(base._REGISTRY, "h100",
                        H100Backend(min_parallel_blocks=SMS))
    B, K = 2, 4096
    ws = [torch.randn(K, 128) / 64 for _ in range(2)]
    x = torch.randn(B, K)
    program = GemvProgram.fused(x, [PackedWeights(w_t=w) for w in ws])
    pkey = program.key("h100")
    stale = GemvPlan(smem_bytes=0, stages=1, **STALE_H100["pim"])
    fresh_tables.put_program("h100", pkey.table_key(), program_plan_to_entry(
        ProgramPlan(mode="fused", n_launches=1, kernel="pim", plan=stale),
        5.0))
    _reload(fresh_tables, tmp_path)
    outs = dispatch.dispatch_fused(x, ws,
                                   policy=DispatchPolicy(backend="h100"))
    for out, w in zip(outs, ws):
        np.testing.assert_allclose(out.numpy(), (x @ w).numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_a_triton_entry_replays_at_its_plan_or_the_jax_plan(
        tmp_path, monkeypatch, fresh_tables):
    """The gpu backend keeps a triton entry's plan where the kernel takes
    it (a one-stage plan does) and re-plans one it refuses."""
    be = GpuBackend(min_parallel_blocks=SMS)
    M, K, B = 1024, 512, 3
    key = GemvKey(M=M, K=K, batch=B, bits=16, block=32,
                  dtype="torch.float32", backend="gpu")
    pol = DispatchPolicy(backend="gpu")
    jax_plan = dataclasses.replace(plan_triton_gemv(M, K, B), stages=1)
    assert be.replay_plan("triton", jax_plan, key, pol) == (
        "triton", jax_plan)
    wide = dataclasses.replace(jax_plan, m_blk=1024, n_m=1)
    assert be.replay_plan("triton", wide, key, pol) == (
        "triton", plan_triton_gemv(M, K, B))
    assert be.replay_plan("ref", None, key, pol) == ("ref", None)


def test_a_stale_ragged_entry_is_re_tiled():
    be = H100Backend(min_parallel_blocks=SMS)
    key = ProgramKey(kind="ragged", Ms=(1408,), K=2048, batch=2, group=64,
                     bits=16, block=32, dtype="torch.bfloat16",
                     backend="h100", tokens=48, hist="le2m1")
    # tiles the ragged kernel refuses: 256 columns do not divide M, and a
    # 2048-row x chunk exceeds its budget
    stale = ProgramPlan(mode="ragged_cuda", n_launches=1,
                        kernel="ragged_gemv",
                        plan=GemvPlan(m_blk=256, k_blk=2048, n_m=6, n_k=1,
                                      smem_bytes=0))
    got = be.replay_program(stale, key, DispatchPolicy())
    assert got.mode == "ragged_cuda"
    assert got.plan == plan_expert_gemv(1408, 2048)
    current = be.plan_program(key)
    assert be.replay_program(current, key, DispatchPolicy()) is current


# --------------------------------------------------------------------------
# the streaming planners of grouped_gemv and triton_gemv
# --------------------------------------------------------------------------

# deepseek-moe-16b's expert GEMVs (M, K) and, for the triton mapping,
# olmo-1b's four decode GEMVs and both models' heads
MOE_SHAPES = [(1408, 2048), (2048, 1408)]
HEAD_SHAPES = [(6144, 2048), (16384, 2048), (2048, 8192), (50304, 2048),
               (102400, 2048)]


@pytest.mark.parametrize("M,K", MOE_SHAPES)
@pytest.mark.parametrize("C", [1, 3, 8, 16, 64, 100])
@pytest.mark.parametrize("elem", [2, 4])
def test_grouped_stream_plan_fills_whole_waves(M, K, C, elem):
    E = 64
    p = plan_grouped_stream(M, K, C, E=E, sms=SMS, elem_bytes=elem)
    rows = stream_rows(C, elem)
    assert rows == min(C, 64 if elem == 2 else 8)
    assert p.m_blk in STREAM_M_BLKS and p.split_k == 1
    assert p.k_blk == sub_rows(p.m_blk, K, elem)
    assert p.k_blk * p.m_blk * elem <= SUBTILE_BYTES
    assert p.n_m == -(-M // p.m_blk) and p.n_k == -(-K // p.k_blk)
    assert p.stages == min(DEFAULT_STAGES, p.n_k)
    assert p.smem_bytes == stream_smem(rows, p.m_blk, p.k_blk, p.stages, elem)
    assert grouped_plan_fits(p, M, K, C, elem)

    def fill(m_blk):
        k_blk = sub_rows(m_blk, K, elem)
        smem = stream_smem(rows, m_blk, k_blk, min(DEFAULT_STAGES,
                                                   -(-K // k_blk)), elem)
        ctas = E * -(-M // m_blk)
        wave = SMS * ctas_per_sm(smem)
        return ctas / (-(-ctas // wave) * wave)

    assert fill(p.m_blk) >= max(fill(m) for m in STREAM_M_BLKS) - 1e-9
    if p.m_blk == 64:
        assert fill(64) > fill(128) + 1e-9     # ties go to the taller block
    for depth in range(1, MAX_STAGES + 1):
        d = with_pipeline_depth(p, depth, batch=rows, elem_bytes=elem)
        if d is None:
            continue
        assert (d.m_blk, d.k_blk, d.n_m, d.n_k) == (p.m_blk, p.k_blk, p.n_m,
                                                    p.n_k)
        assert grouped_plan_fits(d, M, K, C, elem)


def test_grouped_stream_plan_at_deepseek_moe_16b():
    """gate/up: 64 experts x 22 column blocks of 64 fill 3 waves of 528
    CTA slots to 89 % (128 columns: 67 %); down: 16 blocks of 128 fill 2
    waves to 97 %, as 64 columns do (a tie: the taller block)."""
    up = plan_grouped_stream(1408, 2048, 8, E=64, sms=SMS)
    down = plan_grouped_stream(2048, 1408, 8, E=64, sms=SMS)
    assert (up.m_blk, up.k_blk, up.n_m, up.n_k, up.stages) == (
        64, 128, 22, 16, 2)
    assert (down.m_blk, down.k_blk, down.n_m, down.n_k, down.stages) == (
        128, 64, 16, 22, 2)
    # without an SM count (no card) the plan is the 128-column one
    assert plan_grouped_stream(1408, 2048, 8, E=64, sms=0).m_blk == 128


@pytest.mark.parametrize("M,K", HEAD_SHAPES)
@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("elem", [2, 4])
def test_triton_plan_maps_onto_the_stream_body(M, K, B, elem):
    """The JAX plan's column blocks become m_blk / 128 CTAs of the body
    (one 64-column CTA for a 64-column block); the ring depth is the
    plan's, the default 2."""
    plan = plan_triton_gemv(M, K, B)
    assert plan.stages == DEFAULT_STAGES
    m_blk = body_m_blk(plan)
    assert m_blk == (64 if plan.m_blk == 64 else 128)
    assert body_ctas(plan) == M // m_blk
    assert body_ctas(plan) == plan.n_m * max(plan.m_blk // 128, 1)
    assert triton_plan_fits(plan, M, K, B, elem)
    for depth in range(1, MAX_STAGES + 1):
        fits = triton_plan_fits(dataclasses.replace(plan, stages=depth),
                                M, K, B, elem)
        smem = stream_smem(stream_rows(B, elem), m_blk,
                           sub_rows(m_blk, K, elem), depth, elem)
        assert fits == (smem <= 227 * 1024)
    assert not triton_plan_fits(dataclasses.replace(plan, stages=0), M, K,
                                B, elem)


def test_triton_cta_count_differs_from_the_plan_past_128_columns():
    """deepseek-moe-16b's head: the JAX plan's 200 blocks of 512 columns
    are 800 CTAs of 128; olmo-1b's head (blocks of 128) keeps 393."""
    big = plan_triton_gemv(102400, 2048, 8)
    assert (big.m_blk, big.n_m, body_ctas(big)) == (512, 200, 800)
    olmo = plan_triton_gemv(50304, 2048, 8)
    assert (olmo.m_blk, olmo.n_m, body_ctas(olmo)) == (128, 393, 393)
