"""Benchmark driver of the PyTorch port: the twin of ``benchmarks/run.py``.
One function per paper figure (``paper_figs_torch``), the kernel bench's
kernel rows and the roofline of the dry-run records.  Prints
``name,us_per_call,derived`` CSV.  Where a part cannot run (the kernel
rows with no card and no ``--device cpu``) it raises: nothing is skipped
quietly.

    python benchmarks/run_torch.py                   # everything, on the card
    PYTHONPATH=src python benchmarks/run_torch.py roofline figs
    PYTHONPATH=src python benchmarks/run_torch.py fig14 kernels --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
sys.path.insert(0, HERE)


def _emit(rows) -> None:
    for name, us, derived in rows:
        print(f"{name},{us:.3f},{derived:.4f}")


def run_paper_figs(only: set[str] | None = None) -> None:
    from paper_figs_torch import ALL_FIGS

    for fn in ALL_FIGS:
        tag = fn.__name__.split("_")[0]  # fig8 ...
        if only and tag not in only and fn.__name__ not in only:
            continue
        t0 = time.perf_counter()
        rows = fn()
        dt = time.perf_counter() - t0
        _emit(rows)
        print(f"# {fn.__name__}: {len(rows)} rows in {dt * 1e3:.1f} ms",
              file=sys.stderr)


def run_kernel_bench(device=None) -> None:
    from kernel_bench_torch import kernel_rows

    _emit(kernel_rows(device))


def run_roofline() -> None:
    from roofline_torch import roofline_rows

    _emit(roofline_rows())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("parts", nargs="*",
                    help="figs, figN, kernels, roofline (default: all)")
    ap.add_argument("--device", default=None,
                    help="the kernel rows' device (default: the CUDA card)")
    args = ap.parse_args(argv)
    parts = set(args.parts)
    fig_sel = {a for a in parts if a.startswith("fig") and a != "figs"}
    if not parts or parts & {"figs", "paper"} or fig_sel:
        run_paper_figs(fig_sel or None)
    if not parts or "kernels" in parts:
        run_kernel_bench(args.device)
    if not parts or "roofline" in parts:
        run_roofline()


if __name__ == "__main__":
    main()
