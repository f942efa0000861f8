"""Placement explorer: walk the paper's placement space for any GEMV.

Shows Fig. 6's tile-shape x tile-order space, Algorithm 1/2/3 decisions, the
breakdown of modeled PIM time per placement, and the split-K sweep — the
interactive version of the paper's analysis.

    PYTHONPATH=src python examples/placement_explorer.py --M 3072 --K 768
"""

import argparse

from repro_torch.core.pim_arch import FORMATS, RYZEN_LPDDR5X, ScaleFactorConfig
from repro_torch.core.placement import (
    GEMV,
    baseline_colmajor_placement,
    baseline_rowmajor_placement,
    plan_placement,
)
from repro_torch.pim.timing import (
    best_split_k,
    pim_gemv_time,
    pim_speedup,
    soc_gemv_time_ns,
)


def show(tag, placement, cfg, sf=None):
    bd = pim_gemv_time(placement, cfg, sf=sf)
    s = soc_gemv_time_ns(placement.gemv, cfg) / bd.total
    print(f"  {tag:26s} tile={placement.tile.m_tile}x"
          f"{placement.tile.k_tile:<4d} deg={placement.cr_degree} "
          f"t={bd.total/1e3:9.2f}us speedup={s:5.2f}x  "
          f"[mac {bd.t_mac/bd.total*100:4.1f}% iv {bd.t_iv/bd.total*100:4.1f}% "
          f"turn {bd.t_turn/bd.total*100:4.1f}% rows {bd.t_row/bd.total*100:4.1f}% "
          f"shift {bd.t_shift/bd.total*100:4.1f}%]")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--M", type=int, default=3072)
    ap.add_argument("--K", type=int, default=768)
    ap.add_argument("--dform", default="int8", choices=sorted(FORMATS))
    ap.add_argument("--scale-block", type=int, default=0,
                    help="block scale-factor size (0: off)")
    args = ap.parse_args()

    cfg = RYZEN_LPDDR5X
    g = GEMV(args.M, args.K, FORMATS[args.dform], FORMATS["bf16"])
    sf = ScaleFactorConfig(args.scale_block) if args.scale_block else None
    print(f"GEMV {g.M}x{g.K} {g.in_dform.name} on {cfg.tot_bank} banks "
          f"(roofline {cfg.roofline_pim_boost:.2f}x), SoC time "
          f"{soc_gemv_time_ns(g, cfg)/1e3:.1f}us\n")

    print("placements:")
    show("PIMnast (Alg 1+2)",
         plan_placement(g, cfg, opt_cr_degree=False), cfg, sf)
    show("PIMnast-opt (+Alg 3)", plan_placement(g, cfg), cfg, sf)
    show("col-major baseline", baseline_colmajor_placement(g, cfg), cfg, sf)
    show("row-major (footnote 3)", baseline_rowmajor_placement(g, cfg),
         cfg, sf)

    print("\nsplit-K sweep (paper §VI-F):")
    for deg in (2, 4, 8):
        if g.K % deg == 0:
            show(f"split-K degree {deg}",
                 plan_placement(g, cfg, split_k=deg), cfg, sf)
    d, s = best_split_k(g, cfg, sf=sf)
    print(f"\nbest: split-K degree {d} -> {s:.2f}x")

    print("\nregister-allocation sweep (paper Fig 8):")
    for in_reg in (2, 8, 14):
        s, p, bd = pim_speedup(g, cfg, in_reg_alloc=in_reg,
                               opt_cr_degree=False, sf=sf)
        print(f"  in_reg={in_reg:2d}: {s:5.2f}x (t={bd.total/1e3:.2f}us)")


if __name__ == "__main__":
    main()
