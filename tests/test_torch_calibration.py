"""The port's measured cost-model calibration on its ``cpu`` backend, case
for case with ``tests/test_calibration.py``: ``with_constants``, the
calibration slot, fit recovery / monotonicity / outliers / degeneracy,
artifact and table round trips, ``cost_model_source``, an invalid entry
and the smoke ``calibrate_backend`` end to end.  Then the port against
the reference: ``robust_us`` bit for bit, the fitted constants from the
same synthetic records, the full sweep's shapes, seed selections bit for
bit, and the deliberate differences (the bf16 sweep on the card, the
``build/calibration`` output directory)."""

import importlib.util
import json
import os
import threading
import warnings

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hypothesis not installed: the local stub fills in
    from _hypothesis_stub import given, settings, st

from repro.calibration import fit as r_fit
from repro.calibration import measure as r_measure
from repro.kernels import dispatch as r_dispatch
from repro.kernels.backends import DispatchPolicy as RPolicy
from repro.kernels.backends import GemvKey as RKey
from repro.kernels.backends import get_backend as r_get_backend

from repro_torch.calibration import (
    ARTIFACT_SCHEMA,
    MeasurementRecord,
    apply_artifact,
    calibrate_backend,
    fit_cost_model,
    load_artifact,
    run_sweep,
    table_entry,
    write_artifact,
)
from repro_torch.calibration.artifact import DEFAULT_OUT_DIR, artifact_doc
from repro_torch.calibration.fit import _swapped_cost_model, mape, predict_us
from repro_torch.calibration.measure import (
    robust_us,
    sweep_dtype,
    sweep_shapes,
)
from repro_torch.kernels import dispatch
from repro_torch.kernels.backends import (
    AutotuneTable,
    DispatchPolicy,
    GemvKey,
    ProgramKey,
    get_backend,
)
from repro_torch.kernels.backends.base import time_gemv_us
from repro_torch.kernels.backends.gpu import GpuBackend
from repro_torch.kernels.backends.h100 import H100Backend
from repro_torch.kernels.ops import pack_weight

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(11)
CPU = get_backend("cpu")
R_CPU = r_get_backend("cpu")


@pytest.fixture(autouse=True)
def _fresh_caches():
    dispatch.clear_plan_cache()
    dispatch.clear_autotune_table()
    yield
    dispatch.clear_plan_cache()
    dispatch.clear_autotune_table()


# --------------------------------------------------------------------------
# CostModel.with_constants + the calibration slot
# --------------------------------------------------------------------------


def test_with_constants_partial_override():
    seed = CPU.seed_cost_model
    cm = seed.with_constants(bandwidth_gbps=100.0, launch_us=7.0)
    assert cm.bandwidth_gbps == 100.0 and cm.launch_us == 7.0
    assert cm.gemv_efficiency == seed.gemv_efficiency
    assert cm.min_parallel_blocks == seed.min_parallel_blocks
    assert seed.bandwidth_gbps != 100.0  # frozen: the seed never mutates


def test_with_constants_rejects_unknown_and_invalid():
    seed = CPU.seed_cost_model
    with pytest.raises(ValueError, match="unknown"):
        seed.with_constants(bandwith_gbps=1.0)  # typo must not no-op
    for bad in (dict(gemv_efficiency=1.5), dict(gemv_efficiency=0.0),
                dict(bandwidth_gbps=-1.0), dict(launch_us=-0.5),
                dict(elem_ns=-1e-3), dict(collective_gbps=-1.0)):
        with pytest.raises(ValueError):
            seed.with_constants(**bad)
    assert seed.with_constants(min_parallel_blocks=4.0) \
        .min_parallel_blocks == 4
    # the collective terms: 0.0 is the "no interconnect" sentinel
    assert seed.collective_us(1e6, 4) == 0.0
    cm = seed.with_constants(collective_gbps=100.0, collective_launch_us=5.0)
    assert cm.collective_us(1e6, 1) == 0.0
    assert cm.collective_us(1e6, 4) == pytest.approx(
        2 * 3 / 4 * 1e6 / 100e9 * 1e6 + 5.0)
    assert cm.constants() == r_get_backend("cpu").seed_cost_model \
        .with_constants(collective_gbps=100.0,
                        collective_launch_us=5.0).constants()


def _seed_ref_us(M, K, B):
    with _swapped_cost_model(CPU, CPU.seed_cost_model):
        return CPU.estimate_cost_us("ref", M, K, B)


def test_apply_and_reset_calibration_shadow():
    seed = CPU.seed_cost_model
    assert CPU.cost_model_source == "seed"
    fitted = seed.with_constants(bandwidth_gbps=seed.bandwidth_gbps * 2)
    CPU.apply_calibration(fitted)
    try:
        assert CPU.cost_model_source == "calibrated"
        assert CPU.cost_model == fitted
        assert CPU.seed_cost_model == seed  # the seed survives
        assert CPU.estimate_cost_us("ref", 2048, 2048, 1) == pytest.approx(
            0.5 * _seed_ref_us(2048, 2048, 1))
        # the swap used by the fitter restores the slot as it was
        with _swapped_cost_model(CPU, seed):
            assert CPU.cost_model == seed
        assert CPU.cost_model == fitted
    finally:
        CPU.reset_calibration()
    assert CPU.cost_model_source == "seed"
    assert CPU.cost_model == seed


# --------------------------------------------------------------------------
# Fitter: recovery, outlier robustness, degeneracy
# --------------------------------------------------------------------------

SYNTH_SHAPES = ((1024, 1024, 1), (512, 4096, 1), (4096, 512, 1),
                (2048, 2048, 1), (1024, 4096, 4), (2048, 1024, 8))


def _trials(true_us, rng, noise, outlier_factor):
    trials = [true_us * (1.0 + noise * rng.standard_normal())
              for _ in range(5)]
    if outlier_factor:
        trials[2] = true_us * outlier_factor  # one wild trial
    return tuple(abs(t) for t in trials)


def _synth_records(true_cm, shapes=SYNTH_SHAPES, *, noise=0.0,
                   outlier_factor=None):
    """Records whose measurements are the TRUE model's predictions:
    ground truth the fitter must recover from the seed start."""
    rng = np.random.default_rng(3)
    records = []
    for M, K, B in shapes:
        for pin in ("ref", "splitk"):
            kernel, plan = CPU.select_kernel(
                M, K, B, x_bytes=4,
                policy=DispatchPolicy(backend="cpu", kernel=pin))
            rec = MeasurementRecord(
                backend="cpu", kind="single", label=f"{M}x{K}b{B}/{kernel}",
                kernel=kernel, M=M, K=K, batch=B, bits=16, x_bytes=4,
                trials_us=(), key=GemvKey(M=M, K=K, batch=B, bits=16,
                                          block=32, dtype="torch.float32",
                                          backend="cpu"), plan=plan)
            with _swapped_cost_model(CPU, true_cm):
                true_us = predict_us(CPU, rec)
            records.append(MeasurementRecord(
                backend=rec.backend, kind=rec.kind, label=rec.label,
                kernel=rec.kernel, M=M, K=K, batch=B, bits=16, x_bytes=4,
                trials_us=_trials(true_us, rng, noise, outlier_factor),
                key=rec.key, plan=rec.plan))
    return records


def test_fit_recovers_known_constants():
    seed = CPU.seed_cost_model
    true_cm = seed.with_constants(
        bandwidth_gbps=seed.bandwidth_gbps / 3, gemv_efficiency=0.8,
        launch_us=20.0, elem_ns=2.0)
    fit = fit_cost_model("cpu", _synth_records(true_cm, noise=0.01))
    assert not fit.degenerate
    assert fit.mape < fit.seed_mape
    assert fit.mape <= 0.05, fit.mape
    got = fit.constants
    true_stream = true_cm.bandwidth_gbps * true_cm.gemv_efficiency
    assert got["bandwidth_gbps"] * got["gemv_efficiency"] == pytest.approx(
        true_stream, rel=0.25)


def test_fit_monotone_never_worse_than_seed():
    fit = fit_cost_model("cpu", _synth_records(CPU.seed_cost_model,
                                               noise=0.3))
    assert fit.mape <= fit.seed_mape


def test_fit_robust_to_injected_outliers():
    true_cm = CPU.seed_cost_model.with_constants(gemv_efficiency=0.8,
                                                 launch_us=10.0)
    clean = fit_cost_model("cpu", _synth_records(true_cm, noise=0.01))
    dirty = fit_cost_model(
        "cpu", _synth_records(true_cm, noise=0.01, outlier_factor=50.0))
    assert dirty.mape <= 0.05, dirty.mape
    assert abs(dirty.mape - clean.mape) <= 0.04


def test_fit_degenerate_single_shape_degrades_gracefully():
    true_cm = CPU.seed_cost_model.with_constants(gemv_efficiency=0.3)
    fit = fit_cost_model("cpu", _synth_records(true_cm,
                                               shapes=((1024, 1024, 1),)))
    assert fit.degenerate
    assert set(fit.fitted) <= {"gemv_efficiency"}
    cm = CPU.seed_cost_model.with_constants(**fit.constants)
    assert 0 < cm.gemv_efficiency <= 1.0
    assert np.isfinite(fit.mape) and fit.mape <= fit.seed_mape


@settings(max_examples=20, deadline=None)
@given(n=st.integers(min_value=3, max_value=25),
       spread=st.integers(min_value=2, max_value=200))
def test_robust_us_bounded_and_outlier_immune(n, spread):
    clean = [100.0 + spread * i / n for i in range(n)]
    rec = MeasurementRecord(
        backend="cpu", kind="single", label="t", kernel="ref",
        M=8, K=8, batch=1, bits=16, x_bytes=4,
        trials_us=tuple(clean) + (1000.0 * max(clean),))
    assert min(clean) <= rec.robust_us <= max(clean)


# --------------------------------------------------------------------------
# Artifact round trip + the table's calibration section
# --------------------------------------------------------------------------


def _tiny_fit():
    true_cm = CPU.seed_cost_model.with_constants(gemv_efficiency=0.8)
    records = _synth_records(true_cm, noise=0.01)
    return fit_cost_model("cpu", records), records


def test_artifact_write_load_apply_round_trip(tmp_path):
    fit, records = _tiny_fit()
    path = str(tmp_path / "cpu.json")
    doc = write_artifact(path, fit, records)
    assert doc["schema"] == ARTIFACT_SCHEMA
    loaded = load_artifact(path)
    assert loaded["constants"] == doc["constants"]
    assert loaded["mape"] == pytest.approx(fit.mape)
    assert len(loaded["records"]) == len(records)
    assert {r["dtype"] for r in loaded["records"]} == {"float32"}
    cm = apply_artifact(path)
    assert CPU.cost_model_source == "calibrated"
    assert CPU.cost_model == cm
    assert cm.constants() == {
        k: pytest.approx(v) for k, v in doc["constants"].items()}
    entry = dispatch.autotune_table().get_calibration("cpu")
    assert entry is not None and entry["constants"] == doc["constants"]


def test_artifact_rejects_wrong_schema(tmp_path):
    fit, records = _tiny_fit()
    doc = artifact_doc(fit, records)
    doc["schema"] = ARTIFACT_SCHEMA + 1
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="schema"):
        load_artifact(str(p))


def test_table_calibration_round_trips(tmp_path):
    fit, records = _tiny_fit()
    entry = table_entry(artifact_doc(fit, records))
    path = str(tmp_path / "table.json")
    t1 = AutotuneTable()
    t1.put_calibration("cpu", entry)
    t1.put("cpu", "64x64xb1_w16g32_float32", {"kernel": "ref", "us": 1.0})
    t1.save(path)
    doc = json.load(open(path))
    assert doc["format"] == 3
    t2 = AutotuneTable()
    t2.load(path)
    assert t2.get_calibration("cpu") == entry
    assert t2.get("cpu", "64x64xb1_w16g32_float32")["kernel"] == "ref"
    assert t2.snapshot_calibration() == {"cpu": entry}
    # the JAX package reads the port's calibration section, and back
    jt = r_dispatch.autotune_table().__class__()
    jt.load(path)
    assert jt.get_calibration("cpu") == entry


def test_table_older_formats_still_load(tmp_path):
    v1 = tmp_path / "v1.json"
    v1.write_text(json.dumps(
        {"512x512xb1_w16g32_float32_cpu": {"kernel": "ref", "us": 2.0}}))
    t = AutotuneTable()
    t.load(str(v1))
    assert t.get("tpu", "512x512xb1_w16g32_float32")["kernel"] == "ref"
    assert t.snapshot_calibration() == {}
    v2 = tmp_path / "v2.json"
    v2.write_text(json.dumps({"format": 2, "tables": {
        "cpu": {"k": {"kernel": "splitk", "us": 3.0}}}}))
    t2 = AutotuneTable()
    t2.load(str(v2))
    assert t2.get("cpu", "k")["kernel"] == "splitk"
    assert t2.snapshot_calibration() == {}
    v3 = tmp_path / "v3.json"
    v3.write_text(json.dumps({"format": 3, "tables": {}, "programs": {
        "cpu": {"p": {"mode": "fused", "n_launches": 1, "us": 4.0}}}}))
    t3 = AutotuneTable()
    t3.load(str(v3))
    assert t3.get_program("cpu", "p")["mode"] == "fused"
    assert t3.snapshot_calibration() == {}


def test_table_unknown_sections_preserved(tmp_path):
    src = tmp_path / "newer.json"
    future = {"v9_placements": {"cpu": {"whole": "section"}},
              "notes": ["free-form"]}
    src.write_text(json.dumps({
        "format": 3,
        "tables": {"cpu": {"k": {"kernel": "ref", "us": 1.0}}},
        "programs": {},
        "calibration": {"gpu": {"schema": 1, "constants": {}}},
        **future,
    }))
    t = AutotuneTable()
    t.load(str(src))
    out = str(tmp_path / "resaved.json")
    t.save(out)
    doc = json.load(open(out))
    for k, v in future.items():
        assert doc[k] == v, k
    assert doc["calibration"]["gpu"] == {"schema": 1, "constants": {}}
    assert doc["tables"]["cpu"]["k"]["kernel"] == "ref"


def test_concurrent_saves_never_corrupt(tmp_path):
    path = str(tmp_path / "shared.json")
    table = AutotuneTable()
    table.put_calibration("cpu", {"schema": 1, "constants": {}})
    errs = []

    def writer(i):
        try:
            table.put(f"ns{i}", f"key{i}", {"kernel": "ref", "us": float(i)})
            for _ in range(5):
                table.save(path)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert not errs
    doc = json.load(open(path))
    assert doc["format"] == 3
    for i in range(8):
        assert doc["tables"][f"ns{i}"][f"key{i}"]["us"] == float(i)
    assert doc["calibration"]["cpu"]["schema"] == 1
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


# --------------------------------------------------------------------------
# Dispatch: calibrated constants observably price decisions
# --------------------------------------------------------------------------


def _dispatch_once(M=2048, K=2048):
    w = torch.from_numpy(RNG.standard_normal((M, K)).astype(np.float32))
    x = torch.from_numpy(RNG.standard_normal((1, K)).astype(np.float32))
    return dispatch.dispatch_gemv(x, pack_weight(w),
                                  policy=DispatchPolicy(backend="cpu"))


def test_dispatch_counts_cost_model_source():
    _dispatch_once()
    stats = dispatch.dispatch_stats()["cost_model_source"]
    assert stats["seed"] >= 1 and stats["calibrated"] == 0
    seed = CPU.seed_cost_model
    dispatch.autotune_table().put_calibration("cpu", {
        "schema": 1,
        "constants": seed.with_constants(
            bandwidth_gbps=seed.bandwidth_gbps * 2).constants(),
    })
    dispatch.clear_plan_cache()
    _dispatch_once()
    stats = dispatch.dispatch_stats()["cost_model_source"]
    assert stats["calibrated"] >= 1
    assert CPU.cost_model_source == "calibrated"
    assert CPU.cost_model.bandwidth_gbps == seed.bandwidth_gbps * 2
    # clearing the table reverts the backend to its seed constants
    dispatch.clear_autotune_table()
    dispatch.clear_plan_cache()
    assert CPU.cost_model_source == "seed"
    _dispatch_once()
    stats = dispatch.dispatch_stats()["cost_model_source"]
    assert stats["seed"] >= 1 and stats["calibrated"] == 0


def test_dispatch_ignores_invalid_calibration_entry():
    dispatch.autotune_table().put_calibration(
        "cpu", {"schema": 1, "constants": {"bogus_term": 1.0}})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _dispatch_once()
        dispatch.clear_plan_cache()
        _dispatch_once(1024, 1024)
    hits = [w for w in caught if "invalid calibration" in str(w.message)]
    assert len(hits) == 1            # once per backend, not once per miss
    assert issubclass(hits[0].category, RuntimeWarning)
    stats = dispatch.dispatch_stats()["cost_model_source"]
    assert stats["seed"] >= 1 and stats["calibrated"] == 0
    assert CPU.cost_model_source == "seed"


def test_calibration_survives_table_save_load_cycle(tmp_path):
    fit, records = _tiny_fit()
    path = str(tmp_path / "fleet.json")
    doc = artifact_doc(fit, records)
    dispatch.autotune_table().put_calibration("cpu", table_entry(doc))
    dispatch.save_autotune_table(path)
    dispatch.clear_autotune_table()  # "new process"
    dispatch.clear_plan_cache()
    assert CPU.cost_model_source == "seed"
    dispatch.load_autotune_table(path)
    _dispatch_once()
    assert dispatch.dispatch_stats()["cost_model_source"]["calibrated"] >= 1
    assert CPU.cost_model.constants() == {
        k: pytest.approx(v) for k, v in doc["constants"].items()}


# --------------------------------------------------------------------------
# End to end: the one-command loop on the CPU backend
# --------------------------------------------------------------------------


def test_calibrate_backend_smoke_end_to_end(tmp_path):
    doc = calibrate_backend("cpu", smoke=True, trials=2,
                            out_dir=str(tmp_path), device="cpu")
    assert doc["schema"] == ARTIFACT_SCHEMA
    assert os.path.exists(doc["path"])
    assert doc["n_records"] >= 10
    kinds = {r["kind"] for r in doc["records"]}
    assert {"single", "fused", "grouped", "ragged"} <= kinds
    assert doc["mape"] <= doc["seed_mape"]
    assert not doc["degenerate"]
    assert CPU.cost_model_source == "calibrated"


def test_run_sweep_smoke_covers_kernels():
    records = run_sweep("cpu", smoke=True, trials=1, device="cpu")
    kernels = {r.kernel for r in records if r.kind == "single"}
    assert {"ref", "splitk", "quant"} <= kernels
    assert all(len(r.trials_us) == 1 for r in records)
    assert all(r.robust_us > 0 for r in records)
    assert mape(CPU, CPU.seed_cost_model, records) > 0


# --------------------------------------------------------------------------
# The port against the reference
# --------------------------------------------------------------------------


@settings(max_examples=100, deadline=None)
@given(trials=st.lists(st.floats(min_value=0.0, max_value=1e7,
                                 allow_nan=False), min_size=0, max_size=40))
def test_robust_us_bit_equal_to_the_reference(trials):
    mine, ref = robust_us(trials), r_measure.robust_us(trials)
    assert (mine == ref) or (np.isnan(mine) and np.isnan(ref))


def _ref_synth_records(true_constants: dict, *, noise: float):
    """The reference's records from the same true constants, priced by
    the reference's cpu backend (its test's ``_synth_records``)."""
    rng = np.random.default_rng(3)
    true_cm = R_CPU.seed_cost_model.with_constants(**true_constants)
    records = []
    for M, K, B in SYNTH_SHAPES:
        for pin in ("ref", "splitk"):
            kernel, plan = R_CPU.select_kernel(
                M, K, B, x_bytes=4, policy=RPolicy(backend="cpu", kernel=pin))
            rec = r_measure.MeasurementRecord(
                backend="cpu", kind="single", label=f"{M}x{K}b{B}/{kernel}",
                kernel=kernel, M=M, K=K, batch=B, bits=16, x_bytes=4,
                trials_us=(), key=RKey(M=M, K=K, batch=B, bits=16, block=32,
                                       dtype="float32", backend="cpu"),
                plan=plan)
            with r_fit._swapped_cost_model(R_CPU, true_cm):
                true_us = r_fit.predict_us(R_CPU, rec)
            records.append(r_measure.MeasurementRecord(
                backend="cpu", kind="single", label=rec.label,
                kernel=kernel, M=M, K=K, batch=B, bits=16, x_bytes=4,
                trials_us=_trials(true_us, rng, noise, None), key=rec.key,
                plan=plan))
    return records


@pytest.mark.parametrize("noise", [0.0, 0.01, 0.3])
def test_fit_reaches_the_reference_constants(noise):
    """The same sweep, priced by each package's cpu backend from the same
    true constants, fits to the same constants and errors."""
    seed = CPU.seed_cost_model
    true = dict(bandwidth_gbps=seed.bandwidth_gbps / 3, gemv_efficiency=0.8,
                launch_us=20.0, elem_ns=2.0)
    mine = fit_cost_model("cpu", _synth_records(seed.with_constants(**true),
                                                noise=noise))
    ref = r_fit.fit_cost_model("cpu", _ref_synth_records(true, noise=noise))
    assert mine.constants.keys() == ref.constants.keys()
    for k, v in ref.constants.items():
        assert mine.constants[k] == pytest.approx(v, rel=1e-9), k
    assert mine.fitted.keys() == ref.fitted.keys()
    assert mine.mape == pytest.approx(ref.mape, rel=1e-9)
    assert mine.seed_mape == pytest.approx(ref.seed_mape, rel=1e-9)
    assert mine.per_kernel_mape == pytest.approx(ref.per_kernel_mape,
                                                 rel=1e-9)


def test_full_sweep_takes_the_reference_shapes():
    assert sweep_shapes(smoke=True) == r_measure.sweep_shapes(smoke=True)
    mine, ref = sweep_shapes(smoke=False), r_measure.sweep_shapes(smoke=False)
    assert mine[0] == ref[0]
    assert [p[:3] + tuple(p[3:]) for p in mine[1]] == \
        [tuple(p) for p in ref[1]]


def test_sweep_dtype_is_bf16_on_the_card_and_f32_elsewhere():
    """Deliberate difference: on the card the sweep measures bf16 with
    x_bytes 2, the dtype the port serves; the reference measures f32 with
    x_bytes 4, as the CPU sweep here does."""
    assert sweep_dtype(torch.device("cuda", 0)) is torch.bfloat16
    assert sweep_dtype(torch.device("cpu")) is torch.float32
    recs = run_sweep("cpu", smoke=True, trials=1, device="cpu")
    assert {(r.dtype, r.x_bytes) for r in recs} == {("float32", 4)}
    assert all(r.to_json()["dtype"] == "float32" for r in recs)


def test_artifacts_default_to_build_calibration():
    """Deliberate difference: artifacts go under ``build/`` (git-ignored),
    where the reference writes ``artifacts/calibration``."""
    assert DEFAULT_OUT_DIR == os.path.join("build", "calibration")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert "build/" in ignored


def _parent_gemv_us(be, kernel, M, K, B, x_bytes, plan) -> float:
    """The estimators as they stood before the per-element term."""
    cm = be.seed_cost_model
    io = M * K * 16 / 8 + B * K * x_bytes + B * M * x_bytes
    if kernel == "ref" or plan is None:
        return io / (cm.bandwidth_bps * cm.gemv_efficiency) * 1e6
    if be.name == "cpu":
        deg = plan.split_k
        t = io / (cm.bandwidth_bps * min(1.0, deg / cm.min_parallel_blocks))
        t = t * 1e6 + cm.launch_us + cm.program_us * deg
        return t + cm.splitk_reduce_factor * deg * B * M * 4 \
            / cm.bandwidth_bps * 1e6
    ctas = plan.n_m if be.name == "gpu" else plan.split_k * plan.n_m
    t = io / (cm.bandwidth_bps * min(1.0, ctas / cm.min_parallel_blocks))
    return t * 1e6 + cm.launch_us + cm.program_us * ctas


def _parent_program_us(be, key, mode, x_bytes) -> float:
    cm = be.seed_cost_model
    w_bytes = key.total_M * key.K * key.bits / 8
    if key.kind == "ragged":
        T = max(key.tokens, 1)
        io = w_bytes + T * key.K * x_bytes + T * key.Ms[0] * x_bytes
        t = io / (cm.bandwidth_bps * cm.gemv_efficiency) * 1e6
        launches = 1 if mode != "per_request" else key.group
        imbalance = min(max(key.batch * key.group / T, 1.0),
                        float(key.group))
        return (t + cm.launch_us * launches
                + cm.program_us * key.group * imbalance)
    iv = key.group if key.kind == "grouped" else (
        1 if mode == "fused" else key.n_requests)
    io = (w_bytes + iv * key.batch * key.K * x_bytes
          + key.batch * key.total_M * x_bytes)
    launches = 1 if mode in ("fused", "grouped") else key.n_requests
    return (io / (cm.bandwidth_bps * cm.gemv_efficiency) * 1e6
            + cm.launch_us * launches)


@pytest.mark.parametrize("backend", ["cpu", "h100", "gpu"])
def test_seed_selections_bit_identical_to_the_parent_estimators(backend):
    """With no calibration the estimates equal the estimators' form before
    the per-element term bit for bit, so every selection and program plan
    is the seed's; the cpu picks also equal the JAX cpu backend's."""
    be = {"cpu": CPU, "h100": H100Backend(min_parallel_blocks=132),
          "gpu": GpuBackend(min_parallel_blocks=132)}[backend]
    assert be.cost_model_source == "seed" and be.cost_model.elem_ns == 0.0
    for M, K in ((512, 4096), (2048, 2048), (6144, 2048), (16384, 2048),
                 (2048, 8192), (50304, 2048), (1000, 1000)):
        for B in (1, 4, 8):
            pol = DispatchPolicy(backend=backend)
            for kernel, plan in be.candidate_plans(M, K, B, 2) \
                    if backend == "h100" else be.candidate_plans(M, K, B, 16):
                assert be.estimate_cost_us(kernel, M, K, B, x_bytes=2,
                                           plan=plan) == \
                    _parent_gemv_us(be, kernel, M, K, B, 2, plan)
            pick = be.select_kernel(M, K, B, x_bytes=2, policy=pol)
            cands = (be.candidate_plans(M, K, B, 2) if backend == "h100"
                     else be.candidate_plans(M, K, B, 16))
            if pick[0] != "ref" or len(cands) > 1:
                assert pick in cands
            if backend == "cpu":
                assert pick[0] == R_CPU.select_kernel(
                    M, K, B, x_bytes=2, policy=RPolicy(backend="cpu"))[0]
    for kind, Ms, b, group, tokens in (("fused", (2048, 2048, 2048), 8, 3, 0),
                                       ("grouped", (1408,), 8, 64, 0),
                                       ("ragged", (1408,), 2, 64, 48)):
        key = ProgramKey(kind=kind, Ms=Ms, K=2048, batch=b, group=group,
                         bits=16, block=32, dtype="torch.bfloat16",
                         backend=backend, tokens=tokens)
        for mode in ("fused", "grouped", "ragged", "per_request"):
            assert be.estimate_program_cost_us(key, mode=mode, x_bytes=2) \
                == _parent_program_us(be, key, mode, 2)
    # every estimator carries the per-element term: 1 ns an output element
    with _swapped_cost_model(be, be.seed_cost_model.with_constants(
            elem_ns=1.0)):
        for kernel, plan in (be.candidate_plans(6144, 2048, 8, 2)
                             if backend == "h100"
                             else be.candidate_plans(6144, 2048, 8, 16)):
            assert be.estimate_cost_us(kernel, 6144, 2048, 8, x_bytes=2,
                                       plan=plan) == pytest.approx(
                _parent_gemv_us(be, kernel, 6144, 2048, 8, 2, plan)
                + 8 * 6144 * 1e-3, rel=1e-12)
        assert be.estimate_program_cost_us(key, mode="ragged", x_bytes=2) \
            == pytest.approx(_parent_program_us(be, key, "ragged", 2)
                             + 48 * 1408 * 1e-3, rel=1e-12)


def test_kernel_bench_torch_calibrates_the_cpu_backend(tmp_path, capsys):
    """``kernel_bench_torch.py --calibrate --backend cpu --smoke --device
    cpu`` writes the artifact and leaves the dispatcher pricing with the
    fitted constants."""
    path = os.path.join(REPO, "benchmarks", "kernel_bench_torch.py")
    spec = importlib.util.spec_from_file_location("_kernel_bench_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--calibrate", "--backend", "cpu", "--smoke",
                     "--device", "cpu", "--trials", "2",
                     "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("calibrate/cpu: ")
    assert os.path.exists(tmp_path / "cpu.json")
    dispatch.clear_plan_cache()      # the sweep's own decisions were seed's
    _dispatch_once()
    assert dispatch.dispatch_stats()["cost_model_source"] == {
        "seed": 0, "calibrated": 1}


def test_cpu_timing_stays_on_the_host_clock():
    calls = []

    def run(i):
        calls.append(i)
        return torch.zeros(4)

    assert time_gemv_us(run, 3, copies=5, device=torch.device("cpu")) >= 0
    assert calls == [0] * 4          # one warm-up, three timed calls
