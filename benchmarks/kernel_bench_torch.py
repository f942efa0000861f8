"""Cost-model calibration of the PyTorch port: the ``--calibrate`` mode of
``benchmarks/kernel_bench.py`` over ``repro_torch.calibration``.

One command runs sweep -> fit -> artifact -> activate for one backend and
prints the record count, the fitted and the seed MAPE, each kernel's and
program mode's MAPE and the fitted constants.  The sweep runs on the card
unless ``--device cpu`` is given; on the card every record is a replayed
CUDA graph timed with CUDA events.

    PYTHONPATH=src python benchmarks/kernel_bench_torch.py --calibrate \
        --backend cpu --smoke --device cpu
    python benchmarks/kernel_bench_torch.py --calibrate --backend h100
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.calibration.artifact import (  # noqa: E402
    DEFAULT_OUT_DIR,
    calibrate_backend,
)


def run_calibrate(args) -> int:
    """The --calibrate mode: sweep -> fit -> artifact -> activate.  One
    command, exit 0 on success."""
    doc = calibrate_backend(
        args.backend, smoke=args.smoke, trials=args.trials,
        out_dir=args.out_dir, table_path=args.table, device=args.device,
    )
    print(f"calibrate/{doc['backend']}: {doc['n_records']} records, "
          f"mape={doc['mape']:.3f} (seed {doc['seed_mape']:.3f})"
          + (" [degenerate]" if doc["degenerate"] else ""))
    for kern, err in sorted(doc["per_kernel_mape"].items()):
        print(f"calibrate/{doc['backend']}/{kern}: mape={err:.3f}")
    for term, val in sorted(doc["fitted"].items()):
        print(f"calibrate/{doc['backend']}/fit {term}={val:.6g}")
    print(f"wrote calibration artifact -> {doc['path']}")
    if args.table:
        print(f"merged calibration section -> {args.table}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calibrate", action="store_true", required=True,
                    help="measure + fit this backend's CostModel constants "
                         "and write <out-dir>/<backend>.json")
    ap.add_argument("--backend", default="h100",
                    choices=("cpu", "h100", "gpu"),
                    help="GemvBackend whose constants to fit")
    ap.add_argument("--smoke", action="store_true",
                    help="the small sweep tier")
    ap.add_argument("--device", default=None,
                    help="device to sweep on (default: the CUDA card)")
    ap.add_argument("--trials", type=int, default=0,
                    help="timed trials per record (0 = tier default)")
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                    help=f"artifact directory (default {DEFAULT_OUT_DIR})")
    ap.add_argument("--table", default=None,
                    help="also merge the fitted constants into this v3 "
                         "autotune table")
    return run_calibrate(ap.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
