"""The port's benchmark tools against the reference's, on the CPU:
``benchmarks/roofline_torch.py`` (every ``ok`` dry-run record of
``artifacts/dryrun_torch/`` through the reference's ``analyze``, imported
from its path, and through the twin's at H100 rates),
``kernel_bench_torch.py``'s dispatch, program and MoE tables on the
``cpu`` backend, its kernel rows' plain versions, ``run_torch.py``'s CSV
and ``embed_tables_torch.py``'s rewrite.  A few seconds in one process.
"""

import csv
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmarks"

# the reference's scripts import JAX: where it is missing this file skips
pytest.importorskip("jax")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


roof = _load("_roofline_torch", BENCH / "roofline_torch.py")
jroof = _load("_roofline_reference", BENCH / "roofline.py")
kb = _load("_kernel_bench_torch", BENCH / "kernel_bench_torch.py")
jkb = _load("_kernel_bench_reference", BENCH / "kernel_bench.py")
embed = _load("_embed_tables_torch", BENCH / "embed_tables_torch.py")

RECORDS = {mesh: roof.load_records(mesh) for mesh in ("single", "multi")}


def test_the_roofline_is_the_references_at_h100_rates():
    """Every ``ok`` record of both meshes: each term the reference's
    ``analyze`` term scaled by the ratio of its rate to the H100's, the
    model flops, their ratio to the counted flops and the correction flag
    equal."""
    scale = {"t_compute_s": jroof.PEAK_FLOPS / roof.PEAK_FLOPS,
             "t_memory_s": jroof.HBM_BW / roof.HBM_BW,
             "t_collective_s": jroof.LINK_BW / roof.LINK_BW}
    assert (roof.PEAK_FLOPS, roof.HBM_BW, roof.LINK_BW) == (989.4e12, 3.35e12,
                                                            50e9)
    ok = 0
    for recs in RECORDS.values():
        for rec in recs:
            got, want = roof.analyze(rec), jroof.analyze(rec)
            if want is None:
                assert got is None and rec["status"] != "ok"
                continue
            ok += 1
            for term, k in scale.items():
                assert got[term] == pytest.approx(want[term] * k,
                                                  rel=1e-12), term
            for k in ("arch", "shape", "model_flops_dev", "useful_ratio",
                      "corrected"):
                assert got[k] == want[k], k
    assert ok == 68


def test_the_table_has_a_line_a_record_and_the_skipped_cells():
    lines = roof.table("single").splitlines()
    body = lines[1:-2]
    assert len(RECORDS["single"]) == 40 and len(body) == 40
    skipped = [ln for ln in body if ln.rstrip().endswith("skipped")]
    assert len(skipped) == 6 and all("long_500k" in ln for ln in skipped)
    assert "upper" in lines[-1] and "not measurements" in lines[-2]
    rows = roof.roofline_rows()
    assert len(rows) == 4 * 34
    assert all(r[0].startswith("roofline/") for r in rows)


def test_dispatch_rows_are_the_references_on_the_cpu_backend(tmp_path):
    """``--dispatch --no-measure --backend cpu --json``: every
    ``registry_gemv_shapes`` row picks the reference's kernel at the
    reference's modeled µs; the program and MoE rows equal its."""
    out = tmp_path / "bench.json"
    assert kb.main(["--dispatch", "--no-measure", "--backend", "cpu",
                    "--json", str(out)]) == 0
    doc = json.loads(out.read_text())
    want = jkb.dispatch_rows(measure=False, backend_name="cpu")
    assert doc["schema"] == jkb.SCHEMA_VERSION == 5
    assert [r["shape"] for r in doc["rows"]] == [r["shape"] for r in want]
    for got, ref in zip(doc["rows"], want):
        assert got["picked"] == ref["picked"], got["shape"]
        for k in ref:
            if k.startswith("model_us/"):
                assert got[k] == pytest.approx(ref[k], rel=1e-12), k
    assert doc["program_rows"] == jkb.program_rows("cpu")
    assert doc["moe_rows"] == jkb.moe_rows("cpu")
    assert doc["pipeline_rows"] == []
    assert kb.program_rows("cpu") == jkb.program_rows("cpu")
    assert kb.moe_rows("cpu") == jkb.moe_rows("cpu")


def test_kernel_rows_on_the_cpu_are_within_tolerance():
    """The plain versions (``/plain``) at the reference's five shapes:
    the bf16 rows within the kernel tolerance of the f32 product, the
    int8 rows within the reference's quantization error."""
    rows = kb.kernel_rows("cpu", "cpu")
    assert len(rows) == 3 * len(kb.SHAPES)
    for name, us, derived in rows:
        if name.endswith("/bf16/plain"):
            assert us > 0 and derived < 2.0**-7 * 8, name
        elif name.endswith("/int8/plain"):
            assert us > 0 and 0 < derived < 2e-2, name
        else:
            assert name.endswith("/h100_hbm_bound") and us > 0, name


def test_the_bench_raises_with_no_card_and_no_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        kb.main([])
    with pytest.raises(RuntimeError, match="--device cpu"):
        kb.main(["--dispatch", "--backend", "cpu"])


def test_run_prints_roofline_and_figure_rows_as_csv():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, str(BENCH / "run_torch.py"),
                          "roofline", "figs"], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    rows = list(csv.reader(io.StringIO(out.stdout)))
    assert len(rows) > 4 * 34
    for name, us, derived in rows:
        float(us), float(derived)
    names = [r[0] for r in rows]
    assert any(n.startswith("fig14/") for n in names)
    assert sum(n.startswith("roofline/") for n in names) == 4 * 34


def test_embed_rewrites_between_the_markers_and_raises_without(tmp_path):
    doc = tmp_path / "PERF.md"
    head, tail = "# notes\n\n", "\nReading the table: terms.\n\nmore\n"
    doc.write_text(head + "### Final roofline table\n\nstale\n" + tail)
    tbl = embed.embed(str(doc))
    text = doc.read_text()
    assert text.startswith(head) and text.endswith(
        "```\n\nReading the table: terms.\n\nmore\n")
    assert "stale" not in text and tbl in text
    assert embed.embed(str(doc)) == tbl and doc.read_text() == text
    bare = tmp_path / "bare.md"
    bare.write_text("### Final roofline table\nno end marker\n")
    with pytest.raises(ValueError, match="Reading the table:"):
        embed.embed(str(bare))
    assert bare.read_text() == "### Final roofline table\nno end marker\n"
