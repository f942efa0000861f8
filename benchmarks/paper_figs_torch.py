"""One benchmark per paper table/figure (paper §VI).

Each ``figN_*`` function returns CSV rows ``(name, us_per_call, derived)``:
``us_per_call`` is the modeled PIM GEMV (or per-token) latency in
microseconds; ``derived`` is the figure's headline metric (speedup over the
SoC baseline, selection breakdown, etc.).  The PyTorch port's twin of
``benchmarks/paper_figs.py`` over ``repro_torch.core`` / ``repro_torch.pim``:
every figure returns the reference's rows.  The numbers are the paper's
LPDDR5X-PIM model, not measurements of any device.

    PYTHONPATH=src python benchmarks/paper_figs_torch.py
"""

from __future__ import annotations

import sys

from repro_torch.core.opt_models import OPT_SUITE, token_gemvs
from repro_torch.core.pim_arch import (
    BF16,
    INT4,
    INT8,
    RYZEN_LPDDR5X,
    ScaleFactorConfig,
)
from repro_torch.core.placement import baseline_colmajor_placement
from repro_torch.pim.timing import (
    best_split_k,
    pim_gemv_time,
    pim_speedup,
    soc_gemv_time_ns,
)
from repro_torch.pim.e2e import e2e_latency

CFG = RYZEN_LPDDR5X
Row = tuple[str, float, float]


def _model_avg(cfg, dform=INT8, sf=None, **kw) -> list[tuple[str, float, float]]:
    """(model, avg modeled PIM time us, avg speedup) across its four GEMVs."""
    out = []
    for name, m in OPT_SUITE.items():
        ts, ss = [], []
        for g in token_gemvs(m, dform):
            s, _, bd = pim_speedup(g, cfg, sf=sf, **kw)
            ts.append(bd.total / 1e3)
            ss.append(s)
        out.append((name, sum(ts) / len(ts), sum(ss) / len(ss)))
    return out


def fig8_reg_alloc() -> list[Row]:
    """Fig. 8: baseline PIMnast under IV register allocations 2/8/14 + the
    col-major comparison point and the roofline."""
    rows: list[Row] = [
        ("fig8/roofline", 0.0, CFG.roofline_pim_boost),
    ]
    for in_reg in (2, 8, 14):
        for name, t, s in _model_avg(CFG, in_reg_alloc=in_reg,
                                     opt_cr_degree=False):
            rows.append((f"fig8/{name}/in_reg={in_reg}", t, s))
    for name, m in OPT_SUITE.items():
        ts, ss = [], []
        for g in token_gemvs(m):
            bd = pim_gemv_time(baseline_colmajor_placement(g, CFG), CFG)
            ts.append(bd.total / 1e3)
            ss.append(soc_gemv_time_ns(g, CFG) / bd.total)
        rows.append((f"fig8/{name}/col-major", sum(ts) / 4, sum(ss) / 4))
    return rows


def fig9_pimnast_opt() -> list[Row]:
    """Fig. 9a: PIMnast-opt (max CR-degree) speedups; Fig. 9b: tile-shape and
    CR-degree selection breakdown across all modeled GEMVs."""
    rows: list[Row] = []
    for name, t, s in _model_avg(CFG, opt_cr_degree=True):
        rows.append((f"fig9a/{name}/pimnast-opt", t, s))
    shapes: dict[str, int] = {}
    degs: dict[int, int] = {}
    for m in OPT_SUITE.values():
        for g in token_gemvs(m):
            _, p, _ = pim_speedup(g, CFG, opt_cr_degree=True)
            key = f"{p.tile.m_tile}x{p.tile.k_tile}"
            shapes[key] = shapes.get(key, 0) + 1
            degs[p.cr_degree] = degs.get(p.cr_degree, 0) + 1
    n = sum(shapes.values())
    for key, c in sorted(shapes.items(), key=lambda kv: -kv[1]):
        rows.append((f"fig9b/tile-shape={key}", 0.0, 100.0 * c / n))
    for d, c in sorted(degs.items()):
        rows.append((f"fig9b/cr-degree={d}", 0.0, 100.0 * c / n))
    return rows


def fig10_banks() -> list[Row]:
    """Fig. 10: resiliency to #banks (64 / 128 / 256 in the system)."""
    rows: list[Row] = []
    for bpc in (8, 16, 32):
        cfg = CFG.with_(banks_per_channel=bpc)
        rows.append(
            (f"fig10/roofline/banks={cfg.tot_bank}", 0.0,
             cfg.roofline_pim_boost)
        )
        for name, t, s in _model_avg(cfg):
            rows.append((f"fig10/{name}/banks={cfg.tot_bank}", t, s))
    return rows


def fig11_dataformats() -> list[Row]:
    """Fig. 11: 4b / 8b / 16b weight+IV formats."""
    rows: list[Row] = []
    for df in (INT4, INT8, BF16):
        for name, t, s in _model_avg(CFG, dform=df):
            rows.append((f"fig11/{name}/{df.name}", t, s))
    return rows


def fig12_scale_factors() -> list[Row]:
    """Fig. 12: block-level scale factors (block 32) for 8b/4b; plus the
    block-size study (64/128) reported in §VI-D2 text."""
    rows: list[Row] = []
    for df in (INT8, INT4):
        for bs in (32, 64, 128):
            sf = ScaleFactorConfig(block_size=bs)
            for name, t, s in _model_avg(CFG, dform=df, sf=sf):
                rows.append((f"fig12/{name}/{df.name}/bs={bs}", t, s))
    return rows


def fig13_registers() -> list[Row]:
    """Fig. 13: #PIM registers 8 / 16 / 32 (equal IV/OV allocation)."""
    rows: list[Row] = []
    for tot in (8, 16, 32):
        cfg = CFG.with_(tot_reg=tot)
        for name, t, s in _model_avg(cfg, in_reg_alloc=tot // 2):
            rows.append((f"fig13/{name}/tot_reg={tot}", t, s))
    return rows


def fig14_e2e() -> list[Row]:
    """Fig. 14: per-token and end-to-end speedups (prompt 1920 + 128 gen)."""
    rows: list[Row] = []
    for name, m in OPT_SUITE.items():
        r = e2e_latency(m, CFG)
        rows.append(
            (f"fig14/{name}/per-token", r.t_token_pim_ns / 1e3,
             r.token_speedup)
        )
        rows.append(
            (f"fig14/{name}/e2e", r.t_e2e_pim_ns / 1e3, r.e2e_speedup)
        )
        rows.append(
            (f"fig14/{name}/tokengen-frac", 0.0, r.tokengen_fraction_soc)
        )
    return rows


def fig15_deficiencies() -> list[Row]:
    """Fig. 15: 125M model fixes — cross-SIMD reduction-tree hardware and
    software split-K (degrees 2..8)."""
    rows: list[Row] = []
    m = OPT_SUITE["opt-125m"]
    for g in token_gemvs(m):
        short = g.name.split("/")[1]
        s0, _, bd0 = pim_speedup(g, CFG)
        rows.append((f"fig15/{short}/pimnast-opt", bd0.total / 1e3, s0))
        s_hw, _, bd_hw = pim_speedup(g, CFG, cross_simd_hw=True)
        rows.append((f"fig15/{short}/cross-simd-hw", bd_hw.total / 1e3, s_hw))
        for deg in (2, 4, 8):
            s_k, _, bd_k = pim_speedup(g, CFG, split_k=deg)
            rows.append(
                (f"fig15/{short}/split-k={deg}", bd_k.total / 1e3, s_k)
            )
        best_d, best_s = best_split_k(g, CFG)
        rows.append((f"fig15/{short}/best-split-k={best_d}", 0.0, best_s))
    return rows


ALL_FIGS = [
    fig8_reg_alloc,
    fig9_pimnast_opt,
    fig10_banks,
    fig11_dataformats,
    fig12_scale_factors,
    fig13_registers,
    fig14_e2e,
    fig15_deficiencies,
]


def main(argv: list[str] | None = None) -> None:
    """Print ``name,us_per_call,derived`` CSV, as ``benchmarks/run.py``
    prints the reference's figures; arguments select figures (``fig8``
    ...), none prints all of them."""
    only = set(sys.argv[1:] if argv is None else argv)
    for fn in ALL_FIGS:
        if only and fn.__name__.split("_")[0] not in only \
                and fn.__name__ not in only:
            continue
        for name, us, derived in fn():
            print(f"{name},{us:.3f},{derived:.4f}")


if __name__ == "__main__":
    main()
