"""Quickstart for the PyTorch port: the paper's technique end to end.

1. Plan a PIMnast placement for a GEMV and read the modeled speedup (the
   LPDDR-PIM model, ``repro_torch.core`` / ``repro_torch.pim``).
2. Select a kernel with the port's ``h100`` backend and run ``pim_gemv``
   on the card against the plain ``gemv_ref``.
3. The int8 block-scale GEMV (paper §VI-D2) against the float product.

Runs on the CUDA card; ``--device cpu`` runs the kernels' plain versions
on the CPU instead (with the H100's 132 SMs for the plans).

    python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core.pim_arch import BF16, INT8, RYZEN_LPDDR5X  # noqa: E402
from repro_torch.core.placement import GEMV  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.backends import (  # noqa: E402
    DispatchPolicy,
    get_backend,
)
from repro_torch.kernels.backends.h100 import H100Backend  # noqa: E402
from repro_torch.kernels.ops import pack_weight, quantize_weight  # noqa
from repro_torch.kernels.pim_gemv import pim_gemv  # noqa: E402
from repro_torch.kernels.ref import gemv_ref  # noqa: E402
from repro_torch.pim.timing import pim_speedup  # noqa: E402

H100_SMS = 132     # the plans' SM count off the card


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="device to run the kernels on (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = RYZEN_LPDDR5X
    print(f"PIM system: {cfg.tot_bank} banks, peak boost "
          f"{cfg.peak_pim_boost:.1f}x, roofline "
          f"{cfg.roofline_pim_boost:.2f}x\n")

    # -- 1. the paper's placement on an OPT-6.7B FC1 GEMV ------------------
    g = GEMV(16384, 4096, INT8, BF16, name="opt-6.7b/fc1")
    speedup, placement, bd = pim_speedup(g, cfg)
    print(f"GEMV {g.name}: {placement.describe()}")
    print(f"  modeled PIM time {bd.total/1e3:.1f} us, "
          f"speedup over SoC {speedup:.2f}x "
          f"(roofline {cfg.roofline_pim_boost:.2f}x)")
    print(f"  breakdown: mac={bd.t_mac/1e3:.1f}us iv={bd.t_iv/1e3:.2f}us "
          f"turn={bd.t_turn/1e3:.2f}us rows={bd.t_row/1e3:.2f}us\n")

    # -- 2. the h100 backend's pick, and pim_gemv against the oracle -------
    M, K, B = 1024, 2048, 1
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)
                         ).to(dev)
    x = torch.from_numpy(rng.standard_normal((B, K), dtype=np.float32)
                         ).to(dev)
    backend = (get_backend("h100") if dev.type == "cuda"
               else H100Backend(min_parallel_blocks=H100_SMS))
    pw = pack_weight(w)
    kernel, plan = backend.select_kernel(M, K, B, x_bytes=4)
    desc = (f"m_blk={plan.m_blk} k_blk={plan.k_blk} n_m={plan.n_m} "
            f"split_k={plan.split_k} stages={plan.stages}"
            if plan is not None else "torch.matmul")
    print(f"h100 pick for {M}x{K} on {dev}: kernel={kernel} {desc}")
    _, pim_plan = backend.select_kernel(
        M, K, B, x_bytes=4, policy=DispatchPolicy(kernel="pim"))
    launches = pim_gemv.launches
    out = pim_gemv(x, pw.w_t, plan=pim_plan)
    want = gemv_ref(pw.w_t, x)
    err = (out - want).abs().max().item()
    print(f"  pim_gemv launches {pim_gemv.launches - launches}; "
          f"kernel-vs-oracle max err: {err:.2e}")
    picked = backend.execute(kernel, x, pw, plan)
    print(f"  the pick ({kernel}) vs oracle max err: "
          f"{(picked - want).abs().max().item():.2e}\n")

    # -- 3. quantized decode GEMV (block scale-factors, paper §VI-D2) ------
    pq = quantize_weight(w, bits=8, block=32)
    qkernel, qplan = backend.select_kernel(M, K, B, bits=8, block=32,
                                           x_bytes=4)
    out_q = backend.execute(qkernel, x, pq, qplan)
    rel = ((out_q - want).abs().max() / want.abs().max()).item()
    print(f"int8 block-scale GEMV ({qkernel}) rel err vs float: {rel:.3f}")


if __name__ == "__main__":
    main()
