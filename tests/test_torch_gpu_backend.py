"""The port's ``gpu`` backend, ``triton_gemv``, the autotune table and the
``plan=`` override, against the JAX package.

The reference's Pallas-Triton ``triton_gemv`` cannot run on this jax (it
calls the removed ``pl.load``), so the kernel's plain version is held
against the JAX ``gemv_ref``, and the backend against the JAX ``gpu``
backend's *selection*, which runs without lowering: the port has no
capability gate, so its picks equal the JAX backend's under
``DispatchPolicy(interpret=True)``.  Both are built with the JAX backend's
A100 constants (1555 GB/s, 108 SMs) for the comparison.  Everything runs
on the CPU, where the kernel wrappers take their plain versions.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.backends import base as jbase  # noqa: E402
from repro.kernels.backends import get_backend as jget_backend  # noqa: E402
from repro.kernels.backends.gpu import \
    plan_triton_gemv as jplan_triton  # noqa: E402
from repro.kernels.tpu_plan import plan_tpu_gemv  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import packed_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.backends import (  # noqa: E402
    DispatchPolicy,
    GemvKey,
    ProgramKey,
    base,
    get_backend,
    resolve_backend,
)
from repro_torch.kernels.backends.base import (  # noqa: E402
    AutotuneTable,
    entry_to_plan,
    entry_to_program_plan,
    plan_to_entry,
    program_plan_to_entry,
)
from repro_torch.kernels.backends.gpu import (  # noqa: E402
    GpuBackend,
    plan_triton_gemv,
)
from repro_torch.kernels.backends.h100 import H100Backend  # noqa: E402
from repro_torch.kernels.gemv_plan import (  # noqa: E402
    MAX_STAGES,
    GemvPlan,
    plan_gemv,
    plan_splitk,
    with_pipeline_depth,
)
from repro_torch.kernels.ops import PackedWeights  # noqa: E402
from repro_torch.kernels.triton_gemv import (  # noqa: E402
    triton_gemv,
    triton_gemv_plain,
)
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

A100 = dict(min_parallel_blocks=108, bandwidth_gbps=1555.0)
PLAN_FIELDS = ("m_blk", "k_blk", "n_m", "n_k", "split_k")


def _fields(plan):
    return None if plan is None else tuple(getattr(plan, f)
                                           for f in PLAN_FIELDS)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.fixture(autouse=True)
def _fresh_dispatch():
    dispatch.clear_plan_cache()
    dispatch.clear_autotune_table()
    yield
    dispatch.clear_plan_cache()
    dispatch.clear_autotune_table()


# --------------------------------------------------------------------------
# triton_gemv: the plain version and the wrapper
# --------------------------------------------------------------------------

# f32: both sides sum f32 products in other orders (chunked here, one dot in
# XLA); bf16: both round the f32 sum once to bf16, so they may differ by one
# bf16 ulp of the result (relative 2**-7) plus order noise near zero
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2.0**-7, atol=1e-3)}


@pytest.mark.parametrize("M,K", [(256, 128), (192, 64), (1024, 2048)])
@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_triton_plain_matches_jax_gemv_ref(M, K, B, dtype):
    rng = np.random.default_rng(M + K + B)
    x = rng.standard_normal((B, K)).astype(np.float32)
    w_t = (rng.standard_normal((K, M)) / np.sqrt(K)).astype(np.float32)
    plan = plan_triton_gemv(M, K, B)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jref.gemv_ref(jnp.asarray(w_t).astype(jdt),
                         jnp.asarray(x).astype(jdt))
    got = triton_gemv(_t(x, dtype), _t(w_t, dtype), plan=plan)
    assert got.dtype == dtype and got.shape == (B, M)
    assert torch.equal(got, triton_gemv_plain(_t(x, dtype), _t(w_t, dtype),
                                              plan.k_blk))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def test_triton_reads_a_column_view():
    rng = np.random.default_rng(5)
    K, M = 128, 256
    wide = _t(rng.standard_normal((K, 2 * M)) / np.sqrt(K))
    x = _t(rng.standard_normal((8, K)))
    view = wide[:, M:]
    plan = plan_triton_gemv(M, K, 8)
    got = triton_gemv(x, view, plan=plan)
    want = jref.gemv_ref(jnp.asarray(view.numpy()), jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[
        torch.float32])


def test_triton_wrapper_checks_its_inputs():
    K, M = 64, 256
    x = torch.zeros((2, K))
    w = torch.zeros((K, M))
    plan = plan_triton_gemv(M, K, 2)
    n0 = triton_gemv.launches
    with pytest.raises(ValueError, match="row-major"):
        triton_gemv(x, torch.zeros((M, K)).t(), plan=plan)
    with pytest.raises(ValueError, match="16-byte"):
        triton_gemv(x, torch.zeros((K, M + 1))[:, :M], plan=plan)
    with pytest.raises(ValueError, match="tile M"):
        triton_gemv(x, w, plan=dataclasses.replace(plan, m_blk=32, n_m=8))
    with pytest.raises(ValueError, match="tile K"):
        triton_gemv(x, w, plan=dataclasses.replace(plan, k_blk=8, n_k=8))
    with pytest.raises(TypeError):
        triton_gemv(x, w.to(torch.bfloat16), plan=plan)
    with pytest.raises(ValueError, match="disagree on K"):
        triton_gemv(torch.zeros((2, K + 8)), w, plan=plan)
    assert triton_gemv.launches == n0   # the plain version launches nothing


# --------------------------------------------------------------------------
# planner and selection against the JAX gpu backend
# --------------------------------------------------------------------------

PLAN_MS = [32, 64, 96, 128, 192, 256, 300, 512, 768, 1024, 1408, 2048, 4160,
           6144, 16384, 21888, 50304, 102400, 262144]
PLAN_KS = [8, 16, 24, 48, 64, 128, 1152, 1408, 2048, 8192, 10944]


@pytest.mark.parametrize("M", PLAN_MS)
def test_plan_triton_gemv_matches_jax(M):
    for K in PLAN_KS:
        for B in (1, 8):
            assert _fields(plan_triton_gemv(M, K, B)) == _fields(
                jplan_triton(M, K, B)), (M, K, B)
    assert plan_triton_gemv(300, 1152, 1) is None


SELECT_SHAPES = [(262144, 1152), (2048, 2048), (50304, 2048),
                 (102400, 2048), (6144, 2048), (16384, 2048), (2048, 8192),
                 (21888, 2048), (300, 1152), (1024, 24), (65536, 4096),
                 (13824, 5120)]
POLICIES = {
    "auto": {},
    "pin_triton": {"kernel": "triton"},
    "pin_ref": {"kernel": "ref"},
    "no_pallas": {"use_pallas": False},
    "small_weights": {"min_pallas_bytes": 0},
    "threshold_4": {"batch_threshold": 4},
}


@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_gpu_select_kernel_matches_jax(pol):
    """Kernel and plan over a sweep of M, K, B and bits, under each
    policy: the port's picks are the JAX backend's with interpret=True."""
    mine, theirs = GpuBackend(**A100), jget_backend("gpu")
    tpol = DispatchPolicy(backend="gpu", **POLICIES[pol])
    jpol = jdispatch.DispatchPolicy(backend="gpu", interpret=True,
                                    **POLICIES[pol])
    for M, K in SELECT_SHAPES:
        for B in (1, 3, 8, 16):
            for bits, x_bytes in ((16, 2), (16, 4), (8, 2), (4, 2)):
                if pol == "pin_triton" and bits < 16:
                    continue   # both refuse nothing: triton pins on
                kt, pt = mine.select_kernel(M, K, B, bits=bits,
                                            x_bytes=x_bytes, policy=tpol)
                kj, pj = theirs.select_kernel(M, K, B, bits=bits,
                                              x_bytes=x_bytes, policy=jpol)
                assert (kt, _fields(pt)) == (kj, _fields(pj)), (M, K, B,
                                                                bits)


def test_gpu_auto_picks_triton_only_when_grid_fills():
    """The shapes of the JAX package's own test: LM-head-sized M fills the
    grid -> triton; mid-sized M underfills -> ref."""
    gpu = GpuBackend(**A100)
    pol = DispatchPolicy(backend="gpu")
    k_big, plan = gpu.select_kernel(262144, 1152, 1, policy=pol)
    assert k_big == "triton"
    assert plan.n_m >= gpu.cost_model.min_parallel_blocks
    assert gpu.select_kernel(2048, 2048, 1, policy=pol)[0] == "ref"
    for kernel in ("pim", "quant"):   # not this backend's
        with pytest.raises(ValueError, match="unknown kernel"):
            gpu.select_kernel(64, 64, 1, policy=DispatchPolicy(kernel=kernel))
        with pytest.raises(ValueError, match="unknown kernel"):
            jget_backend("gpu").select_kernel(
                64, 64, 1, policy=jdispatch.DispatchPolicy(kernel=kernel))


def test_gpu_backend_registration_and_constants():
    be = get_backend("gpu")
    assert isinstance(be, GpuBackend)
    assert be.kernels == ("ref", "triton")
    assert be.program_modes == ("fused", "grouped", "ragged")
    # gpu claims no device: cuda tensors resolve to h100, cpu ones to cpu
    assert resolve_backend(None, torch.device("cuda", 0)).name == "h100"
    assert resolve_backend(None, torch.device("cpu")).name == "cpu"
    assert resolve_backend(DispatchPolicy(backend="gpu"),
                           torch.device("cpu")) is be
    cm = GpuBackend(min_parallel_blocks=132).cost_model
    assert (cm.bandwidth_gbps, cm.gemv_efficiency, cm.launch_us,
            cm.program_us, cm.min_parallel_blocks) == (3350.0, 0.7, 3.0,
                                                       0.02, 132)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="SM count"):
            GpuBackend().cost_model


PROGRAM_CASES = [
    # (kind, Ms, K, batch, bits, dtype, policy overrides)
    ("fused", (2048, 2048, 2048), 2048, 8, 16, "bfloat16", {}),
    ("fused", (8192, 8192), 2048, 8, 16, "bfloat16", {}),
    ("fused", (131072, 131072), 1152, 1, 16, "bfloat16", {}),
    ("fused", (131072, 131072), 1152, 1, 16, "bfloat16",
     {"fuse_programs": False}),
    ("fused", (131072, 131072), 1152, 1, 8, "bfloat16", {}),
    ("grouped", (1408,), 2048, 8, 16, "bfloat16", {}),
    ("grouped", (1408,), 2048, 64, 16, "bfloat16", {}),
    ("grouped", (128,), 64, 2, 16, "float32", {}),
    ("grouped", (24,), 2048, 8, 16, "bfloat16", {}),
    ("grouped", (1408,), 2048, 8, 16, "bfloat16", {"fuse_programs": False}),
    ("ragged", (1408,), 2048, 2, 16, "bfloat16", {}),
    ("ragged", (2048,), 1408, 2, 16, "bfloat16", {}),
    ("ragged", (1408,), 2048, 9, 16, "bfloat16", {}),
    ("ragged", (1408,), 2048, 2, 8, "bfloat16", {}),
    ("ragged", (64,), 128, 1, 16, "float32", {}),
    ("ragged", (1408,), 2048, 2, 16, "bfloat16", {"use_pallas": False}),
]


@pytest.mark.parametrize("case", PROGRAM_CASES,
                         ids=[f"{c[0]}-{'+'.join(map(str, c[1]))}x{c[2]}"
                              f"-b{c[3]}-w{c[4]}-{c[5]}{''.join(c[6])}"
                              for c in PROGRAM_CASES])
def test_gpu_plan_program_matches_jax(case):
    kind, Ms, K, batch, bits, dtype, overrides = case
    E = 64 if kind != "fused" else len(Ms)
    common = dict(kind=kind, Ms=Ms, K=K, batch=batch, group=E, bits=bits,
                  block=32, tokens=48 if kind == "ragged" else 0,
                  hist="le2m1" if kind == "ragged" else "")
    jplan = jget_backend("gpu").plan_program(
        jbase.ProgramKey(dtype=dtype, backend="gpu", **common),
        policy=jdispatch.DispatchPolicy(interpret=True, **overrides))
    tplan = GpuBackend(**A100).plan_program(
        ProgramKey(dtype=f"torch.{dtype}", backend="gpu", **common),
        policy=DispatchPolicy(**overrides))
    assert (tplan.mode, tplan.n_launches, tplan.kernel,
            _fields(tplan.plan)) == (jplan.mode, jplan.n_launches,
                                     jplan.kernel, _fields(jplan.plan))


def test_native_expert_modes_keep_the_cuda_column_rule():
    """A deliberate difference (ROADMAP): the JAX gate alone admits an
    expert width of 4 columns; the CUDA kernels need whole 16-byte
    vectors, so the port runs such a stack on the portable executor."""
    common = dict(kind="ragged", Ms=(4,), K=64, batch=2, group=8, bits=16,
                  block=32, tokens=16, hist="le2m2")
    jplan = jget_backend("gpu").plan_program(
        jbase.ProgramKey(dtype="bfloat16", backend="gpu", **common),
        policy=jdispatch.DispatchPolicy(interpret=True))
    tplan = GpuBackend(**A100).plan_program(
        ProgramKey(dtype="torch.bfloat16", backend="gpu", **common))
    assert jplan.mode == "ragged_triton" and tplan.mode == "ragged"


# --------------------------------------------------------------------------
# autotune table: format, round trips, merges
# --------------------------------------------------------------------------


def _port_entries():
    return {
        "50304x2048xb8_w16g32_bfloat16": plan_to_entry(
            "triton", plan_triton_gemv(50304, 2048, 8), 97.5),
        "6144x2048xb8_w16g32_bfloat16": plan_to_entry("ref", None, 12.0),
    }


def test_port_table_loads_in_jax(tmp_path):
    path = str(tmp_path / "t.json")
    table = AutotuneTable()
    for k, e in _port_entries().items():
        table.put("gpu", k, e)
    pkey = ProgramKey(kind="ragged", Ms=(1408,), K=2048, batch=2, group=64,
                      bits=16, block=32, dtype="torch.bfloat16",
                      backend="gpu", tokens=48, hist="le2m1")
    pplan = GpuBackend(**A100).plan_program(pkey)
    table.put_program("gpu", pkey.table_key(),
                      program_plan_to_entry(pplan, 80.0))
    table.save(path)
    jt = jbase.AutotuneTable()
    jt.load(path)
    assert jt.snapshot()["gpu"] == table.snapshot()["gpu"]
    for k, e in _port_entries().items():
        kj, pj = jbase.entry_to_plan(jt.get("gpu", k))
        kt, pt = entry_to_plan(e)
        assert (kj, _fields(pj)) == (kt, _fields(pt))
    jkey = jbase.ProgramKey(kind="ragged", Ms=(1408,), K=2048, batch=2,
                            group=64, bits=16, block=32, dtype="bfloat16",
                            backend="gpu", tokens=48, hist="le2m1")
    assert jkey.table_key() == pkey.table_key()
    jp = jbase.entry_to_program_plan(jt.get_program("gpu", jkey.table_key()))
    assert (jp.mode, jp.n_launches, jp.kernel, _fields(jp.plan)) == (
        pplan.mode, pplan.n_launches, pplan.kernel, _fields(pplan.plan))


def test_jax_table_loads_in_port(tmp_path):
    path = str(tmp_path / "t.json")
    jt = jbase.AutotuneTable()
    jgpu = jplan_triton(50304, 2048, 8)
    jtpu = plan_tpu_gemv(6144, 2048, 8)
    jt.put("gpu", "50304x2048xb8_w16g32_bfloat16",
           jbase.plan_to_entry("triton", jgpu, 90.0))
    jt.put("tpu", "6144x2048xb8_w16g32_bfloat16",
           jbase.plan_to_entry("pim", jtpu, 30.0))
    jpp = jbase.ProgramPlan(mode="fused", n_launches=1, kernel="triton",
                            plan=jgpu)
    jt.put_program("gpu", "fused[2048+2048]x2048xb8_e2_w16g32_bfloat16",
                   jbase.program_plan_to_entry(jpp, 50.0))
    jt.save(path)
    table = AutotuneTable()
    table.load(path)
    for ns, key, kernel, jplan in (
            ("gpu", "50304x2048xb8_w16g32_bfloat16", "triton", jgpu),
            ("tpu", "6144x2048xb8_w16g32_bfloat16", "pim", jtpu)):
        k, p = entry_to_plan(table.get(ns, key))
        assert (k, _fields(p)) == (kernel, _fields(jplan))
        assert p.stages == 1 and p.smem_bytes == 0
    pp = entry_to_program_plan(table.get_program(
        "gpu", "fused[2048+2048]x2048xb8_e2_w16g32_bfloat16"))
    assert (pp.mode, pp.n_launches, pp.kernel, _fields(pp.plan)) == (
        "fused", 1, "triton", _fields(jgpu))


@pytest.mark.parametrize("version", [1, 2])
def test_v1_and_v2_files_migrate_as_in_jax(tmp_path, version):
    entry = {"kernel": "pim", "us": 3.0, "m_blk": 128, "k_blk": 512,
             "n_m": 2, "n_k": 4, "split_k": 1}
    if version == 1:
        doc = {"256x2048xb1_w16g32_float32_cpu": entry,
               "512x2048xb1_w16g32_bfloat16_tpu": {"kernel": "ref",
                                                   "us": 1.0},
               "note": "not an entry"}
    else:
        doc = {"format": 2, "tables": {"tpu": {"k": entry},
                                       "h100": {"k2": dict(entry)}}}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(doc))
    table, jt = AutotuneTable(), jbase.AutotuneTable()
    assert table.load(str(path)) == jt.load(str(path))
    assert table.snapshot() == jt.snapshot()
    assert table.snapshot_programs() == {}
    if version == 1:
        assert set(table.snapshot()["tpu"]) == {
            "256x2048xb1_w16g32_float32", "512x2048xb1_w16g32_bfloat16"}


def test_save_merges_namespaces_and_keys(tmp_path):
    path = str(tmp_path / "sub" / "t.json")
    a, b = AutotuneTable(), AutotuneTable()
    a.put("h100", "k1", {"kernel": "pim", "us": 1.0})
    a.save(path)
    b.put("gpu", "k1", {"kernel": "triton", "us": 2.0})
    b.put("h100", "k2", {"kernel": "ref", "us": 3.0})
    b.save(path)
    doc = json.loads(open(path).read())
    assert doc["format"] == 3
    assert doc["tables"] == {"h100": {"k1": {"kernel": "pim", "us": 1.0},
                                      "k2": {"kernel": "ref", "us": 3.0}},
                             "gpu": {"k1": {"kernel": "triton", "us": 2.0}}}
    assert not list((tmp_path / "sub").glob("*.tmp"))


def test_unknown_and_calibration_sections_survive(tmp_path):
    path = tmp_path / "t.json"
    doc = {"format": 3, "tables": {"tpu": {"k": {"kernel": "ref", "us": 1}}},
           "programs": {}, "calibration": {"cpu": {"constants": {"a": 1}}},
           "from_a_newer_writer": {"x": [1, 2]}}
    path.write_text(json.dumps(doc))
    table = AutotuneTable()
    table.load(str(path))
    table.put("gpu", "k", {"kernel": "triton", "us": 2.0})
    table.save(str(path))
    out = json.loads(path.read_text())
    assert out["from_a_newer_writer"] == {"x": [1, 2]}
    assert out["calibration"] == {"cpu": {"constants": {"a": 1}}}
    assert out["tables"]["tpu"] == {"k": {"kernel": "ref", "us": 1}}
    jt = jbase.AutotuneTable()       # and the JAX package reads it
    jt.load(str(path))
    assert jt.get("gpu", "k") == {"kernel": "triton", "us": 2.0}


def test_table_keys_match_jax():
    for dtype in ("bfloat16", "float32"):
        for bits in (16, 8, 4):
            jk = jbase.GemvKey(M=6144, K=2048, batch=8, bits=bits, block=32,
                               dtype=dtype, backend="gpu")
            tk = GemvKey(M=6144, K=2048, batch=8, bits=bits, block=32,
                         dtype=f"torch.{dtype}", backend="gpu")
            assert tk.table_key() == jk.table_key()
        for kind in ("fused", "grouped", "ragged"):
            common = dict(kind=kind, Ms=(512, 256) if kind == "fused"
                          else (1408,), K=2048, batch=3, group=2, bits=16,
                          block=32, tokens=48 if kind == "ragged" else 0,
                          hist="le4m1" if kind == "ragged" else "")
            assert ProgramKey(dtype=f"torch.{dtype}", backend="x",
                              **common).table_key() == jbase.ProgramKey(
                dtype=dtype, backend="x", **common).table_key()


# --------------------------------------------------------------------------
# autotune through the dispatcher, and precedence
# --------------------------------------------------------------------------


def _gemv_case(M=256, K=128, B=3, seed=0):
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal((B, K)))
    w = _t(rng.standard_normal((K, M)) / np.sqrt(K))
    return x, PackedWeights(w_t=w)


@pytest.mark.parametrize("backend", ["cpu", "gpu", "h100"])
def test_autotune_tunes_persists_and_replays(tmp_path, monkeypatch,
                                             backend):
    """autotune=True times the backend's candidates (here their plain
    versions), persists the winner with every candidate's time, and a
    reloaded table replays it without tuning."""
    monkeypatch.setitem(base._REGISTRY, "gpu", GpuBackend(**A100))
    monkeypatch.setitem(base._REGISTRY, "h100",
                        H100Backend(min_parallel_blocks=132))
    path = str(tmp_path / "table.json")
    x, pw = _gemv_case()
    tune = DispatchPolicy(backend=backend, autotune=True, table_path=path,
                          min_pallas_bytes=0)
    out = dispatch.dispatch_gemv(x, pw, policy=tune)
    np.testing.assert_allclose(out.numpy(), (x @ pw.w_t).numpy(),
                               rtol=1e-5, atol=1e-5)
    key = GemvKey(M=256, K=128, batch=3, bits=16, block=32,
                  dtype=str(x.dtype), backend=backend)
    entry = json.loads(open(path).read())["tables"][backend][
        key.table_key()]
    be = get_backend(backend)
    # one label per candidate: h100's staged plans carry their ring depth
    cands = {be.candidate_label(k, p)
             for k, p in be.autotune_candidates(key, pw, tune)}
    assert set(entry["candidates_us"]) == cands and len(cands) >= 2
    assert entry["us"] == min(entry["candidates_us"].values())
    assert be.candidate_label(*entry_to_plan(entry)) == min(
        entry["candidates_us"], key=entry["candidates_us"].get)

    dispatch.clear_autotune_table()
    dispatch.clear_plan_cache()
    dispatch.load_autotune_table(path)
    monkeypatch.setattr(type(get_backend(backend)), "autotune_gemv",
                        lambda *a, **k: pytest.fail("tuned again"))
    dispatch.dispatch_gemv(x, pw, policy=DispatchPolicy(
        backend=backend, min_pallas_bytes=0))
    assert dispatch.dispatch_stats()["kernel_picks"] == {
        f"{backend}:{entry['kernel']}": 1}


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_autotune_programs_persist_and_replay(tmp_path, monkeypatch,
                                              backend):
    monkeypatch.setitem(base._REGISTRY, "gpu", GpuBackend(**A100))
    path = str(tmp_path / "table.json")
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((2, 64)))
    members = [_t(rng.standard_normal((64, m))) for m in (128, 64)]
    tune = DispatchPolicy(backend=backend, autotune=True, table_path=path)
    outs = dispatch.dispatch_fused(x, members, policy=tune)
    for o, w in zip(outs, members):
        np.testing.assert_allclose(o.numpy(), (x @ w).numpy(), rtol=1e-5,
                                   atol=1e-5)
    xr = _t(rng.standard_normal((6, 64)))
    stack = _t(rng.standard_normal((4, 64, 128)))
    counts = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    dispatch.dispatch_ragged(xr, counts, stack, bound=3, policy=tune)
    progs = json.loads(open(path).read())["programs"][backend]
    assert len(progs) == 2
    modes = {e["mode"] for e in progs.values()}
    # fused: the joint mode and the per-request form; ragged: the native
    # mode and the portable executor (cpu has only the latter)
    assert sorted(len(e["candidates_us"]) for e in progs.values()) == (
        [1, 2] if backend == "cpu" else [2, 2])

    dispatch.clear_autotune_table()
    dispatch.clear_plan_cache()
    dispatch.load_autotune_table(path)
    replay = DispatchPolicy(backend=backend)
    dispatch.dispatch_fused(x, members, policy=replay)
    dispatch.dispatch_ragged(xr, counts, stack, bound=3, policy=replay)
    got = {k.split(":", 1)[1]
           for k in dispatch.dispatch_stats()["program_modes"]}
    assert got == modes


def test_a_candidate_that_raises_is_not_skipped(monkeypatch, tmp_path):
    """The JAX tuner skips a candidate that fails; this one raises, so a
    broken kernel cannot hide behind ref.  A candidate the planner rejects
    beforehand is simply not timed."""
    gpu = GpuBackend(**A100)
    monkeypatch.setitem(base._REGISTRY, "gpu", gpu)
    real = GpuBackend.execute

    def broken(self, kernel, x, pw, plan):
        if kernel == "triton":
            raise RuntimeError("triton_gemv: CUDA error 1 at launch")
        return real(self, kernel, x, pw, plan)

    monkeypatch.setattr(GpuBackend, "execute", broken)
    tune = DispatchPolicy(backend="gpu", autotune=True)
    x, pw = _gemv_case()
    with pytest.raises(RuntimeError, match="CUDA error"):
        dispatch.dispatch_gemv(x, pw, policy=tune)
    # M = 300 has no power-of-two column block: triton is not a candidate
    x, pw = _gemv_case(M=300)
    dispatch.dispatch_gemv(x, pw, policy=tune)
    key = GemvKey(M=300, K=128, batch=3, bits=16, block=32,
                  dtype="torch.float32", backend="gpu")
    assert dispatch.autotune_table().get("gpu", key.table_key())[
        "candidates_us"].keys() == {"ref"}


@pytest.mark.parametrize("M,K", [(6144, 2048), (16384, 2048),
                                 (2048, 8192), (50304, 2048)])
def test_h100_staged_candidates_beside_the_default_depth(M, K):
    """The autotuner times pim and splitk at every ring depth the card
    holds (the TPU backend's staged candidates), each under its own
    label; the model-priced pick keeps the planner's default depth."""
    be = H100Backend(min_parallel_blocks=132)
    key = GemvKey(M=M, K=K, batch=8, bits=16, block=32,
                  dtype="torch.bfloat16", backend="h100")
    cands = be.autotune_candidates(key, None, DispatchPolicy())
    labels = [be.candidate_label(k, p) for k, p in cands]
    assert len(set(labels)) == len(labels) and labels[0] == "ref"
    defaults = {"pim": plan_gemv(M, K, 8, sms=132),
                "splitk": plan_splitk(M, K, 8, degree=8, sms=132)}
    for kernel, base in defaults.items():
        staged = sorted((p for k, p in cands if k == kernel),
                        key=lambda p: p.stages)
        assert base in staged
        assert [p.stages for p in staged] == [
            d for d in range(1, MAX_STAGES + 1)
            if with_pipeline_depth(base, d, batch=8) is not None]
        assert len(staged) >= 3
        # restaging never changes the tiles (nor the order of the sums)
        assert {(p.m_blk, p.k_blk, p.n_m, p.n_k, p.split_k)
                for p in staged} == {(base.m_blk, base.k_blk, base.n_m,
                                      base.n_k, base.split_k)}
    kernel, plan = be.select_kernel(M, K, 8)
    assert plan == defaults[kernel]
    assert be.candidate_label(kernel, plan) == f"{kernel}/s{plan.stages}"


def test_a_staged_winner_round_trips_through_the_table(tmp_path,
                                                       monkeypatch):
    """A staged plan persisted as the winner replays with its depth."""
    be = H100Backend(min_parallel_blocks=132)
    monkeypatch.setitem(base._REGISTRY, "h100", be)
    x, pw = _gemv_case(M=256, K=512, B=2)
    plan = plan_gemv(256, 512, 2, elem_bytes=4, sms=132)
    staged = with_pipeline_depth(plan, 1, batch=2, elem_bytes=4)
    assert staged is not None and staged.stages != plan.stages
    key = GemvKey(M=256, K=512, batch=2, bits=16, block=32,
                  dtype=str(x.dtype), backend="h100")
    path = str(tmp_path / "table.json")
    table = dispatch.autotune_table()
    table.put("h100", key.table_key(), plan_to_entry("pim", staged, 5.0))
    table.save(path)
    dispatch.clear_autotune_table()
    dispatch.clear_plan_cache()
    dispatch.load_autotune_table(path)
    seen = []
    real = H100Backend.execute

    def record(self, kernel, x, pw, plan):
        seen.append((kernel, plan))
        return real(self, kernel, x, pw, plan)

    monkeypatch.setattr(H100Backend, "execute", record)
    out = dispatch.dispatch_gemv(x, pw, policy=DispatchPolicy(
        backend="h100", min_pallas_bytes=0))
    np.testing.assert_allclose(out.numpy(), (x @ pw.w_t).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert seen == [("pim", staged)]
    dispatch.clear_autotune_table()
    dispatch.clear_plan_cache()


def test_table_entries_stand_in_for_the_cost_model_only():
    """Precedence, as the JAX dispatcher: an entry replaces the model under
    an auto policy; a pin, use_pallas=False and (for programs)
    fuse_programs=False outrank it."""
    x, pw = _gemv_case()
    key = GemvKey(M=256, K=128, batch=3, bits=16, block=32,
                  dtype=str(x.dtype), backend="cpu")
    table = dispatch.autotune_table()
    table.put("cpu", key.table_key(), plan_to_entry(
        "splitk", GemvPlan(m_blk=256, k_blk=32, n_m=1, n_k=1, smem_bytes=0,
                           split_k=4), 1.0))
    picks = {}
    for name, pol in (("auto", DispatchPolicy()),
                      ("pinned", DispatchPolicy(kernel="ref")),
                      ("no_pallas", DispatchPolicy(use_pallas=False))):
        dispatch.clear_plan_cache()
        out = dispatch.dispatch_gemv(x, pw, policy=pol)
        np.testing.assert_allclose(out.numpy(), (x @ pw.w_t).numpy(),
                                   rtol=1e-5, atol=1e-5)
        picks[name] = dispatch.dispatch_stats()["kernel_picks"]
    assert picks == {"auto": {"cpu:splitk": 1}, "pinned": {"cpu:ref": 1},
                     "no_pallas": {"cpu:ref": 1}}
    members = [pw.w_t, pw.w_t]
    pkey = dispatch.GemvProgram.fused(x, [pw, pw]).key("cpu")
    table.put_program("cpu", pkey.table_key(), {
        "mode": "per_request", "n_launches": 2, "us": 1.0})
    modes = {}
    for fuse in (True, False):
        dispatch.clear_plan_cache()
        dispatch.dispatch_fused(x, members,
                                policy=DispatchPolicy(fuse_programs=fuse))
        modes[fuse] = dispatch.dispatch_stats()["program_modes"]
    assert modes == {True: {"cpu:per_request": 1},
                     False: {"cpu:per_request": 1}}
    table.put_program("cpu", pkey.table_key(), {
        "mode": "fused", "n_launches": 1, "us": 1.0, "kernel": "ref"})
    dispatch.clear_plan_cache()
    dispatch.dispatch_fused(x, members,
                            policy=DispatchPolicy(fuse_programs=False))
    assert dispatch.dispatch_stats()["program_modes"] == {
        "cpu:per_request": 1}


# --------------------------------------------------------------------------
# dispatch_gemv(plan=...)
# --------------------------------------------------------------------------

COERCE_PLANS = {
    "splitk4": dict(m_blk=256, k_blk=128, n_m=1, n_k=1, split_k=4),
    "splitk3": dict(m_blk=256, k_blk=128, n_m=1, n_k=1, split_k=3),
    "tpu_tiles": dict(m_blk=128, k_blk=512, n_m=2, n_k=1, split_k=1),
    "port_tiles": dict(m_blk=64, k_blk=256, n_m=4, n_k=2, split_k=1),
    "port_splitk": dict(m_blk=64, k_blk=64, n_m=4, n_k=2, split_k=4),
}


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("name", sorted(COERCE_PLANS))
def test_plan_override_coerces_as_the_jax_backends(name, bits):
    """cpu and gpu coerce exactly as their JAX twins (gpu re-plans, cpu
    keeps only the split degree); h100 names the kernel as the TPU backend
    does and keeps the caller's tiles where its kernels take them."""
    M, K, B = 256, 512, 2
    rng = np.random.default_rng(9)
    w = rng.standard_normal((M, K)).astype(np.float32)
    x = rng.standard_normal((B, K)).astype(np.float32)
    jpw = (jops.pack_weight(jnp.asarray(w)) if bits == 16
           else jops.quantize_weight(w, bits=8, block=32))
    tpw = packed_from_numpy(np.asarray(jpw.w_t),
                            None if jpw.scales is None
                            else np.asarray(jpw.scales), bits, 32,
                            device="cpu")
    fields = COERCE_PLANS[name]
    jplan = jbase.GemvPlan(vmem_bytes=0, **fields)
    tplan = GemvPlan(smem_bytes=0, **fields)
    jpol = jdispatch.DispatchPolicy(interpret=True)
    for tname, jname, twin in (("cpu", "cpu", True), ("gpu", "gpu", True),
                               ("h100", "tpu", False)):
        tb = (H100Backend(min_parallel_blocks=132) if tname == "h100"
              else GpuBackend(**A100) if tname == "gpu"
              else get_backend("cpu"))
        kt, pt = tb.coerce_plan(tplan, M, K, B, tpw, DispatchPolicy())
        kj, pj = jget_backend(jname).coerce_plan(jplan, M, K, B, jpw, jpol)
        if twin:
            assert (kt, _fields(pt)) == (kj, _fields(pj)), tname
        else:
            assert kt == kj, (kt, kj)
            if bits == 16 and name.startswith("port"):
                assert pt == tplan        # the kernels take these tiles
    out = dispatch.dispatch_gemv(_t(x), tpw, plan=tplan)
    want = jdispatch.dispatch_gemv(jnp.asarray(x), jpw,
                                   policy=jdispatch.DispatchPolicy(
                                       backend="cpu"), plan=jplan)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    assert dispatch.dispatch_stats()["kernel_picks"] == {}


# --------------------------------------------------------------------------
# quantized expert stacks on the portable executors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["cpu", "h100", "gpu"])
@pytest.mark.parametrize("kind", ["ragged", "grouped"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_stack_matches_jax_portable_executors(backend, kind,
                                                        bits):
    """The shapes of the JAX package's test_ragged_quantized_stack: int8
    and int4 expert stacks through dispatch_ragged / dispatch_grouped,
    against the JAX cpu backend.  Both dequantize the same codes with the
    same scales in f32 and sum in other orders: 1e-5 relative, 1e-4
    absolute at outputs of magnitude ~10."""
    rng = np.random.default_rng(bits)
    counts = [2, 3, 1, 2]
    E, K, M = 4, 128, 64
    members = [jops.quantize_weight(
        rng.standard_normal((M, K)).astype(np.float32), bits=bits, block=32)
        for _ in range(E)]
    jstack = jops.PackedWeights.stack(members)
    tstack = packed_from_numpy(np.asarray(jstack.w_t),
                               np.asarray(jstack.scales), bits, 32,
                               device="cpu")
    jpol = jdispatch.DispatchPolicy(backend="cpu")
    tpol = DispatchPolicy(backend=backend)
    if backend != "cpu":
        be = (H100Backend(min_parallel_blocks=132) if backend == "h100"
              else GpuBackend(**A100))
        base._REGISTRY[backend], saved = be, get_backend(backend)
    try:
        if kind == "ragged":
            x = rng.standard_normal((8, K)).astype(np.float32)
            want = jdispatch.dispatch_ragged(jnp.asarray(x),
                                             jnp.asarray(counts), jstack,
                                             policy=jpol)
            got = dispatch.dispatch_ragged(
                _t(x), torch.tensor(counts, dtype=torch.int32), tstack,
                policy=tpol)
        else:
            xs = rng.standard_normal((E, 3, K)).astype(np.float32)
            want = jdispatch.dispatch_grouped(jnp.asarray(xs), jstack,
                                              policy=jpol)
            got = dispatch.dispatch_grouped(_t(xs), tstack, policy=tpol)
    finally:
        if backend != "cpu":
            base._REGISTRY[backend] = saved
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    assert set(dispatch.dispatch_stats()["program_modes"]) == {
        f"{backend}:{kind}"}


# --------------------------------------------------------------------------
# the engine on the gpu backend against the JAX Engine
# --------------------------------------------------------------------------


def _jax_tree(tparams):
    """The port's params as the JAX package's tree (layers stacked [L, ...])
    through numpy: drawing the weights on the port's side skips the JAX
    ``init_lm`` compile (the bridge is held to that tree elsewhere)."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return jnp.asarray(node.numpy())

    stacked = jax.tree.map(lambda *ls: np.stack(ls),
                           *[jax.tree.map(lambda t: t.numpy(), lp)
                             for lp in tparams["layers"]])
    return {"embed": conv(tparams["embed"]), "ln_f": conv(tparams["ln_f"]),
            "layers": jax.tree.map(jnp.asarray, stacked)}


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b"])
def test_gpu_engine_greedy_tokens_identical_to_jax(monkeypatch, arch):
    """Reduced configs, the mixed-length scenario.  The gpu backend gets a
    1 GB/s bandwidth and one SM as its constants, and the policy
    ``min_pallas_bytes=0``, so that the reduced shapes pick ``triton``
    (at the real constants their launch term sends them all to ``ref``).
    The JAX Engine runs its gpu backend, which its capability gate sends
    to ``ref`` on the CPU."""
    monkeypatch.setitem(base._REGISTRY, "gpu", GpuBackend(
        min_parallel_blocks=1, bandwidth_gbps=1.0))
    jcfg, tcfg = ARCHS[arch].reduced(), get_config(arch).reduced()
    tparams = lm.init_lm(tcfg, seed=0, device="cpu")
    jparams = _jax_tree(tparams)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3, 12, 7)]
    jeng = JaxEngine(jcfg, jparams, batch_slots=4, max_len=64,
                     gemv_backend="gpu")
    teng = Engine(tcfg, tparams, batch_slots=4, max_len=64, device="cpu",
                  gemv_backend="gpu")
    teng.gemv_policy = dataclasses.replace(teng.gemv_policy,
                                           min_pallas_bytes=0)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=6))
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    jdone = {r.rid: r.generated for r in jeng.run_until_drained()}
    dispatch.clear_plan_cache()
    tdone = {r.rid: r.generated for r in teng.run_until_drained()}
    assert sorted(tdone) == list(range(5))
    assert tdone == jdone
    stats = dispatch.dispatch_stats()
    assert stats["kernel_picks"].get("gpu:triton", 0) > 0
    assert stats["program_kernels"].get("gpu:triton", 0) > 0
    if arch == "deepseek-moe-16b":
        assert stats["program_modes"].get("gpu:ragged_triton", 0) > 0
        assert "gpu:ragged" not in stats["program_modes"]
