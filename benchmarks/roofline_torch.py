"""Roofline of the PyTorch port's dry run: the twin of
``benchmarks/roofline.py``.  It reads the records of
``python -m repro_torch.launch.dryrun`` (``artifacts/dryrun_torch/``) and
gives each (arch x shape) cell three terms at H100 rates:

    compute term    = flops / 989.4e12 FLOP/s   (H100 SXM5, dense bf16)
    memory term     = bytes / 3.35e12 B/s       (H100 SXM5, HBM3)
    collective term = collective bytes / 50e9 B/s

The flops, bytes and collective bytes of a record are one rank's
(``launch/dryrun.py`` counts what each rank runs on meta tensors), so the
terms are per device, as the reference's; the L1 / L2 depth-corrected
counts (``roofline``) are used where the record has them.  The peaks are
the H100 SXM5 data sheet's.  The link rate is one 400 Gb/s NDR InfiniBand
NIC a GPU (50e9 B/s): a 16-wide 'model' axis spans two 8-GPU NVLink
nodes, so its ring crosses the NIC; NVLink's 450e9 B/s a direction holds
only within a node.

These are counts at data-sheet rates, not measurements.  The bytes are
the unfused ATen operations' (each operation's inputs read and outputs
written once, no fusion: the dry run counts the port's eager ops), so the
memory term is an upper bound.  Also ``model_flops_dev`` (6·N·D train,
2·N·D a forward; N the active params, D the cell's tokens from
``launch/shapes.py``) and its ratio to the counted flops.

    PYTHONPATH=src python benchmarks/roofline_torch.py
"""

from __future__ import annotations

import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch.shapes import SHAPES  # noqa: E402

PEAK_FLOPS = 989.4e12    # H100 SXM5 dense bf16 (data sheet)
HBM_BW = 3.35e12         # H100 SXM5 HBM3 (data sheet)
LINK_BW = 50e9           # one 400 Gb/s NDR InfiniBand NIC a GPU

ART_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "artifacts", "dryrun_torch")
FOOTER = ("(counts at H100 SXM5 data-sheet rates: 989.4 TFLOP/s bf16, "
          "3.35 TB/s HBM3, 50 GB/s a link; not measurements)\n"
          "(bytes: unfused ATen counts, so the memory term is an upper "
          "bound; 6ND/ops: model flops over counted flops)")


def load_records(mesh: str = "single") -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(ART_DIR, f"*__{mesh}.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def cell_tokens(shape: str) -> int:
    """Tokens a cell processes: its rows times its sequence (a decode
    cell, one token a row)."""
    case = SHAPES[shape]
    return case.global_batch * (1 if case.kind == "decode"
                                else case.seq_len)


def model_flops_per_device(rec: dict) -> float:
    """6·N·D for train, 2·N·D for a forward, divided by the chips (to
    match a rank's counted flops)."""
    n_active = rec.get("model_params_active") or 0
    chips = rec.get("n_chips", 256)
    per_token = 6.0 if SHAPES[rec["shape"]].kind == "train" else 2.0
    return per_token * n_active * cell_tokens(rec["shape"]) / chips


def analyze(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    rf = rec.get("roofline") or {}
    flops = rf.get("flops", rec.get("flops", 0.0))
    byts = rf.get("bytes", rec.get("bytes_accessed", 0.0))
    coll = rf.get("coll", rec.get("collective_total", 0.0))
    t_comp = flops / PEAK_FLOPS
    t_mem = byts / HBM_BW
    t_coll = coll / LINK_BW
    dominant = max(("compute", t_comp), ("memory", t_mem),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    mf = model_flops_per_device(rec)
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "t_compute_s": t_comp, "t_memory_s": t_mem,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_dev": mf,
        "useful_ratio": (mf / flops) if flops else 0.0,
        "corrected": "flops" in rf,
    }


def roofline_rows() -> list[tuple[str, float, float]]:
    """``(name, us, derived)`` rows of the single-pod mesh's cells: each
    term, then the bound and its dominant term (derived: the compute
    term's share of the bound)."""
    rows = []
    for rec in load_records("single"):
        a = analyze(rec)
        if a is None:
            continue
        tag = f"roofline/{a['arch']}/{a['shape']}"
        bound = max(a["t_compute_s"], a["t_memory_s"], a["t_collective_s"])
        rows.append((f"{tag}/compute_s", a["t_compute_s"] * 1e6,
                     a["useful_ratio"]))
        rows.append((f"{tag}/memory_s", a["t_memory_s"] * 1e6, 0.0))
        rows.append((f"{tag}/collective_s", a["t_collective_s"] * 1e6, 0.0))
        rows.append((f"{tag}/bound={a['dominant']}", bound * 1e6,
                     a["t_compute_s"] / bound if bound else 0.0))
    return rows


def table(mesh: str = "single") -> str:
    lines = [f"{'arch':22s} {'shape':12s} {'compute(s)':>11s} "
             f"{'memory(s)':>11s} {'collect(s)':>11s} {'bound':>10s} "
             f"{'6ND/ops':>8s}"]
    for rec in load_records(mesh):
        a = analyze(rec)
        if a is None:
            lines.append(f"{rec['arch']:22s} {rec['shape']:12s} "
                         f"{'—':>11s} {'—':>11s} {'—':>11s} "
                         f"{rec.get('status'):>10s}")
            continue
        lines.append(f"{a['arch']:22s} {a['shape']:12s} "
                     f"{a['t_compute_s']:11.4f} {a['t_memory_s']:11.4f} "
                     f"{a['t_collective_s']:11.4f} {a['dominant']:>10s} "
                     f"{a['useful_ratio']:8.3f}")
    lines.append(FOOTER)
    return "\n".join(lines)


if __name__ == "__main__":
    print(table())
