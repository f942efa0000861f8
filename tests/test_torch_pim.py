"""The port's PIM model against the reference's, case for case with
``tests/test_placement.py`` and ``tests/test_timing_model.py``: equal
placements (tile shapes, orders, CR-degrees, split-K), ``Breakdown`` fields
and speedups equal to 1e-12 relative, ``materialize`` / ``untile`` through
torch bit-equal to the reference's numpy, and the twins of the paper's
scripts printing the reference's output."""

import contextlib
import importlib.util
import io
import math
import os
import sys

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional test dep: degrade to the deterministic stub
    from _hypothesis_stub import given, settings, st

from repro.core import opt_models as r_opt
from repro.core import pim_arch as r_arch
from repro.core import placement as r_pl
from repro.pim import e2e as r_e2e
from repro.pim import timing as r_tm

from repro_torch.core import opt_models as t_opt
from repro_torch.core import pim_arch as t_arch
from repro_torch.core import placement as t_pl
from repro_torch.pim import e2e as t_e2e
from repro_torch.pim import timing as t_tm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = t_arch.RYZEN_LPDDR5X
R_CFG = r_arch.RYZEN_LPDDR5X
DFORMS = ("int4", "int8", "bf16")
REL = 1e-12


def gemvs(M, K, df="int8", out="bf16", name="gemv"):
    """The same GEMV in both packages."""
    return (t_pl.GEMV(M, K, t_arch.FORMATS[df], t_arch.FORMATS[out], name),
            r_pl.GEMV(M, K, r_arch.FORMATS[df], r_arch.FORMATS[out], name))


def r_cfg_of(cfg: t_arch.PIMConfig) -> r_arch.PIMConfig:
    return r_arch.PIMConfig(**{f: getattr(cfg, f)
                               for f in cfg.__dataclass_fields__})


def r_sf_of(sf):
    return None if sf is None else r_arch.ScaleFactorConfig(
        sf.block_size, sf.scale_bits, sf.interleaved)


def placement_tuple(p) -> tuple:
    t = p.tile
    return (p.gemv.M, p.gemv.K, p.gemv.in_dform.name, t.m_tile, t.k_tile,
            t.in_reg, t.out_reg, t.even, p.order.value, p.cr_degree,
            p.split_k.degree, p.in_reg_alloc, p.banks_used, p.channels_used,
            p.m_TM, p.k_TM, p.rowblocks_per_bank, p.describe())


def assert_breakdown_equal(mine, ref):
    for f in ("t_mac", "t_shift", "t_iv", "t_turn", "t_row", "t_spill",
              "t_sf", "t_soc_reduce", "total"):
        assert getattr(mine, f) == pytest.approx(getattr(ref, f), rel=REL,
                                                 abs=0), f
    assert mine.counts == ref.counts


def speedup_both(M, K, df="int8", cfg=CFG, **kw):
    """(port speedup, placement, breakdown), asserted equal to the
    reference's."""
    tg, rg = gemvs(M, K, df)
    sf = kw.pop("sf", None)
    s, p, bd = t_tm.pim_speedup(tg, cfg, sf=sf, **kw)
    rs, rp, rbd = r_tm.pim_speedup(rg, r_cfg_of(cfg), sf=r_sf_of(sf), **kw)
    assert s == pytest.approx(rs, rel=REL, abs=0)
    assert placement_tuple(p) == placement_tuple(rp)
    assert_breakdown_equal(bd, rbd)
    return s, p, bd


def model_avg(cfg=CFG, dform="int8", **kw):
    """The port's per-model average speedup, every GEMV held to the
    reference's."""
    out = {}
    for name, m in t_opt.OPT_SUITE.items():
        ss = [speedup_both(g.M, g.K, dform, cfg, **kw)[0]
              for g in t_opt.token_gemvs(m, t_arch.FORMATS[dform])]
        out[name] = sum(ss) / len(ss)
    return out


# --------------------------------------------------------------------------
# Algorithm 1 -- tile shape
# --------------------------------------------------------------------------


def tile_tuple(t) -> tuple:
    return (t.m_tile, t.k_tile, t.in_reg, t.out_reg, t.even)


def tile_both(M, K, df="int8"):
    tg, rg = gemvs(M, K, df)
    t = t_pl.get_tile_shape(tg, CFG)
    assert tile_tuple(t) == tile_tuple(r_pl.get_tile_shape(rg, R_CFG))
    return t


def test_tile_bytes_equal_interleave_gran():
    for M, K in [(4096, 4096), (3072, 768), (768, 3072), (12288, 4096)]:
        for df in DFORMS:
            t = tile_both(M, K, df)
            assert t.m_tile * t.k_tile * t_arch.FORMATS[df].bits == \
                CFG.interleave_gran_bytes * 8


def test_tile_shape_prefers_tall():
    t = tile_both(16384, 4096)
    assert (t.m_tile, t.k_tile) == (128, 2)
    assert t.in_reg + t.out_reg <= CFG.tot_reg


def test_tile_shape_even_distribution():
    t = tile_both(4096, 4096)
    assert t.even and 4096 % (CFG.tot_bank * t.m_tile) == 0
    assert (t.m_tile, t.k_tile) == (32, 8)


def test_tile_shape_small_m_goes_wide():
    t = tile_both(768, 768)
    assert t.m_tile == 2 and t.k_tile == 128


def test_paper_register_formulas():
    tg, rg = gemvs(4096, 4096)
    assert t_pl.get_param(tg, CFG, 32, 8) == (1, 2) \
        == r_pl.get_param(rg, R_CFG, 32, 8)


@given(M=st.integers(1, 1 << 16), K=st.integers(1, 1 << 14),
       df=st.sampled_from(DFORMS))
@settings(max_examples=200, deadline=None)
def test_tile_shape_invariants(M, K, df):
    t = tile_both(M, K, df)
    elem_per_tile = CFG.interleave_gran_bytes * 8 // t_arch.FORMATS[df].bits
    assert 1 <= t.m_tile <= elem_per_tile
    assert t.m_tile * t.k_tile == elem_per_tile
    assert t.m_tile & (t.m_tile - 1) == 0
    if t.m_tile > 1:
        assert t.in_reg + t.out_reg <= CFG.tot_reg
        assert M % (CFG.tot_bank * t.m_tile) == 0


# --------------------------------------------------------------------------
# Algorithm 2 -- CR order
# --------------------------------------------------------------------------


def order_both(m_TM, k_TM, banks, deg=1):
    if deg > 1:
        mine = t_pl.cr_order_with_degree(m_TM, k_TM, banks, deg)
        ref = r_pl.cr_order_with_degree(m_TM, k_TM, banks, deg)
    else:
        mine, ref = (t_pl.cr_order(m_TM, k_TM, banks),
                     r_pl.cr_order(m_TM, k_TM, banks))
    assert mine.dtype == torch.int64
    np.testing.assert_array_equal(mine.numpy(), ref)
    return mine.tolist()


@given(m_spread=st.integers(1, 4), k_TM=st.integers(1, 32),
       banks=st.sampled_from([8, 16, 64, 128]))
@settings(max_examples=100, deadline=None)
def test_cr_order_is_permutation(m_spread, k_TM, banks):
    m_TM = m_spread * banks
    order = order_both(m_TM, k_TM, banks)
    assert sorted(order) == list(range(m_TM * k_TM))


def test_cr_order_row_stays_in_one_bank():
    banks, m_TM, k_TM = 16, 32, 8
    bank_of_tile = {tile: pos % banks
                    for pos, tile in enumerate(order_both(m_TM, k_TM, banks))}
    for rb in range(m_TM):
        assert len({bank_of_tile[rb * k_TM + c] for c in range(k_TM)}) == 1


def test_cr_order_balances_banks():
    banks, m_TM, k_TM = 16, 64, 4
    counts = np.bincount(np.arange(len(order_both(m_TM, k_TM, banks)))
                         % banks, minlength=banks)
    assert counts.min() == counts.max()


@given(deg=st.sampled_from([1, 2, 4]), spread=st.integers(1, 3),
       k_TM=st.integers(1, 8))
@settings(max_examples=50, deadline=None)
def test_cr_degree_order_permutation_and_locality(deg, spread, k_TM):
    banks = 16
    m_TM = banks * deg * spread
    order = order_both(m_TM, k_TM, banks, deg)
    assert sorted(order) == list(range(m_TM * k_TM))
    bank_of_tile = {t: p % banks for p, t in enumerate(order)}
    for rb in range(m_TM):
        assert len({bank_of_tile[rb * k_TM + c] for c in range(k_TM)}) == 1
    local = {b: [] for b in range(banks)}
    for pos, tile in enumerate(order):
        local[pos % banks].append(tile)
    for tiles in local.values():
        cols = [t % k_TM for t in tiles]
        for i in range(0, min(len(cols), deg * k_TM), deg):
            assert len(set(cols[i:i + deg])) == 1


def test_cr_order_refusals_match_the_reference():
    for call in (lambda pl: pl.cr_order(24, 4, 16),
                 lambda pl: pl.cr_order_with_degree(32, 4, 16, 0),
                 lambda pl: pl.cr_order_with_degree(48, 4, 16, 2)):
        with pytest.raises(ValueError) as mine:
            call(t_pl)
        with pytest.raises(ValueError) as ref:
            call(r_pl)
        assert str(mine.value) == str(ref.value)


# --------------------------------------------------------------------------
# Algorithm 3 -- CR degree
# --------------------------------------------------------------------------


def test_max_cr_degree_register_bound():
    for args, want in (((32 * 128 * 8, 32, 128, 8, 2, 16), 4),
                       ((32 * 128 * 3, 32, 128, 8, 2, 16), 3),
                       ((32 * 128, 32, 128, 8, 2, 16), 1)):
        assert t_pl.max_cr_degree(*args) == want == r_pl.max_cr_degree(*args)


@given(rb_pb=st.integers(1, 16), in_reg=st.integers(1, 14),
       out_reg=st.integers(1, 8))
@settings(max_examples=100, deadline=None)
def test_max_cr_degree_invariants(rb_pb, in_reg, out_reg):
    args = (32 * 128 * rb_pb, 32, 128, in_reg, out_reg, 16)
    deg = t_pl.max_cr_degree(*args)
    assert deg == r_pl.max_cr_degree(*args)
    assert 1 <= deg <= rb_pb
    if deg > 1:
        assert deg * out_reg + in_reg <= 16


# --------------------------------------------------------------------------
# Materialization, through torch, bit-equal to the reference's numpy
# --------------------------------------------------------------------------


def tiles_both(W: np.ndarray, m_tile, k_tile):
    mine = t_pl.tile_matrix_roworder(torch.from_numpy(W), m_tile, k_tile)
    ref = r_pl.tile_matrix_roworder(W, m_tile, k_tile)
    np.testing.assert_array_equal(mine.numpy(), ref)
    return mine


@given(m_TM=st.integers(1, 8), k_TM=st.integers(1, 8),
       m_tile=st.sampled_from([2, 8, 32]), k_tile=st.sampled_from([2, 8, 32]))
@settings(max_examples=50, deadline=None)
def test_tile_roundtrip(m_TM, k_TM, m_tile, k_tile):
    M, K = m_TM * m_tile, k_TM * k_tile
    W = np.arange(M * K, dtype=np.int64).reshape(M, K)
    tiles = tiles_both(W, m_tile, k_tile)
    back = t_pl.untile_matrix_roworder(tiles, M, K, m_tile, k_tile)
    np.testing.assert_array_equal(back.numpy(), r_pl.untile_matrix_roworder(
        tiles.numpy(), M, K, m_tile, k_tile))
    np.testing.assert_array_equal(back.numpy(), W)


def test_materialize_stream_covers_matrix():
    tg, rg = gemvs(4096, 4096)
    p, rp = t_pl.plan_placement(tg, CFG), r_pl.plan_placement(rg, R_CFG)
    assert placement_tuple(p) == placement_tuple(rp)
    W = np.random.default_rng(0).integers(-128, 127, size=(4096, 4096))
    stream = t_pl.materialize(torch.from_numpy(W), p)
    np.testing.assert_array_equal(stream.numpy(), r_pl.materialize(W, rp))
    assert stream.shape[0] == p.m_TM * p.k_TM
    assert int(stream.sum()) == int(W.sum())


@given(M=st.integers(1, 200), K=st.integers(1, 200),
       m_tile=st.sampled_from([2, 8, 32]), k_tile=st.sampled_from([2, 8, 32]))
@settings(max_examples=100, deadline=None)
def test_tile_roundtrip_ragged(M, K, m_tile, k_tile):
    W = (np.arange(M * K, dtype=np.int64) + 1).reshape(M, K)
    tiles = tiles_both(W, m_tile, k_tile)
    assert tuple(tiles.shape) == (math.ceil(M / m_tile) * math.ceil(
        K / k_tile), m_tile * k_tile)
    back = t_pl.untile_matrix_roworder(tiles, M, K, m_tile, k_tile)
    np.testing.assert_array_equal(back.numpy(), W)
    assert int(tiles.sum()) == int(W.sum())


def cr_placements(M, K, m_tile, k_tile, deg, banks=16):
    """A hand-made CR placement in both packages (test_placement's)."""
    tg, rg = gemvs(M, K)
    in_reg, out_reg = t_pl.get_param(tg, CFG, m_tile, k_tile)
    mine = t_pl.Placement(
        gemv=tg, tile=t_pl.TileShape(m_tile, k_tile, in_reg, out_reg, True),
        order=t_pl.TileOrder.COLUMN_ROW, cr_degree=deg,
        split_k=t_pl.SplitK(1), in_reg_alloc=8, banks_used=banks,
        channels_used=2)
    ref = r_pl.Placement(
        gemv=rg, tile=r_pl.TileShape(m_tile, k_tile, in_reg, out_reg, True),
        order=r_pl.TileOrder.COLUMN_ROW, cr_degree=deg,
        split_k=r_pl.SplitK(1), in_reg_alloc=8, banks_used=banks,
        channels_used=2)
    return mine, ref


@given(spread=st.integers(1, 3), k_TM=st.integers(1, 6),
       deg=st.sampled_from([1, 2]), m_tile=st.sampled_from([2, 8]),
       k_tile=st.sampled_from([2, 8]))
@settings(max_examples=60, deadline=None)
def test_materialize_roundtrip(spread, k_TM, deg, m_tile, k_tile):
    banks = 16
    m_TM = banks * deg * spread
    M, K = m_TM * m_tile, k_TM * k_tile
    p, rp = cr_placements(M, K, m_tile, k_tile, deg, banks)
    W = (np.arange(M * K, dtype=np.int64) % 251).reshape(M, K)
    stream = t_pl.materialize(torch.from_numpy(W), p)
    np.testing.assert_array_equal(stream.numpy(), r_pl.materialize(W, rp))
    order = (t_pl.cr_order_with_degree(m_TM, k_TM, banks, deg) if deg > 1
             else t_pl.cr_order(m_TM, k_TM, banks))
    tiles = torch.empty_like(stream)
    tiles[order] = stream
    back = t_pl.untile_matrix_roworder(tiles, M, K, m_tile, k_tile)
    np.testing.assert_array_equal(back.numpy(), W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["pimnast", "pimnast-deg1", "col-major",
                                    "row-major", "split-k"])
def test_materialize_every_order_bit_equal_to_numpy(layout, dtype):
    """Seeded float matrices with ragged edges through every tile order:
    the stream keeps the input's dtype and device and equals the
    reference's numpy stream bit for bit (bf16 compared as its f32
    widening, which is exact)."""
    M, K = 2 * 128 * 3 + 5, 300
    tg, rg = gemvs(M, K, "bf16")
    if layout.startswith("pimnast") or layout == "split-k":
        kw = dict(opt_cr_degree=layout == "pimnast",
                  split_k=2 if layout == "split-k" else 1)
        M = 128 * 2 * 4 * 3           # aligned: CR order needs whole spreads
        tg, rg = gemvs(M, K, "bf16")
        p, rp = (t_pl.plan_placement(tg, CFG, **kw),
                 r_pl.plan_placement(rg, R_CFG, **kw))
    elif layout == "col-major":
        p, rp = (t_pl.baseline_colmajor_placement(tg, CFG),
                 r_pl.baseline_colmajor_placement(rg, R_CFG))
    else:
        p, rp = (t_pl.baseline_rowmajor_placement(tg, CFG),
                 r_pl.baseline_rowmajor_placement(rg, R_CFG))
    assert placement_tuple(p) == placement_tuple(rp)
    W = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (M, K)).astype(np.float32)).to(dtype)
    stream = t_pl.materialize(W, p)
    assert stream.dtype == dtype and stream.device == W.device
    np.testing.assert_array_equal(stream.float().numpy(),
                                  r_pl.materialize(W.float().numpy(), rp))
    if p.order is t_pl.TileOrder.ROW:
        back = t_pl.untile_matrix_roworder(stream, M, K, p.tile.m_tile,
                                           p.tile.k_tile)
        assert torch.equal(back, W)


# --------------------------------------------------------------------------
# Planner end to end
# --------------------------------------------------------------------------


def plan_both(M, K, **kw):
    tg, rg = gemvs(M, K)
    p = t_pl.plan_placement(tg, CFG, **kw)
    assert placement_tuple(p) == placement_tuple(
        r_pl.plan_placement(rg, R_CFG, **kw))
    return p


def test_plan_placement_defaults():
    p = plan_both(12288, 4096)
    assert p.order is t_pl.TileOrder.COLUMN_ROW
    assert p.cr_degree == 3
    assert p.in_reg_alloc == 8


def test_split_k_uses_channel_subsets():
    p = plan_both(768, 3072, split_k=4)
    assert p.channels_used == 2 and p.banks_used == 32
    assert p.split_k.degree == 4
    with pytest.raises(ValueError):
        t_pl.SplitK(3)


def test_split_k_enables_taller_tiles():
    assert plan_both(768, 3072, split_k=4).tile.m_tile > \
        plan_both(768, 3072).tile.m_tile


def test_baselines():
    tg, rg = gemvs(4096, 4096)
    cm = t_pl.baseline_colmajor_placement(tg, CFG)
    rm = t_pl.baseline_rowmajor_placement(tg, CFG)
    assert placement_tuple(cm) == placement_tuple(
        r_pl.baseline_colmajor_placement(rg, R_CFG))
    assert placement_tuple(rm) == placement_tuple(
        r_pl.baseline_rowmajor_placement(rg, R_CFG))
    assert cm.tile.m_tile == 256 and cm.tile.k_tile == 1
    assert rm.tile.m_tile == 1 and rm.tile.k_tile == 256
    assert [t_pl.bank_of_position(j, cm) for j in (0, 127, 128, 300)] == \
        [r_pl.bank_of_position(j, r_pl.baseline_colmajor_placement(rg, R_CFG))
         for j in (0, 127, 128, 300)]


# --------------------------------------------------------------------------
# The DRAM timing model (test_timing_model.py's cases)
# --------------------------------------------------------------------------


def test_roofline_near_7x():
    assert CFG.peak_pim_boost == pytest.approx(8.0)
    assert CFG.roofline_pim_boost == R_CFG.roofline_pim_boost
    assert 6.8 <= CFG.roofline_pim_boost <= 7.3
    assert t_arch.preferred_page_bytes(CFG) == \
        r_arch.preferred_page_bytes(R_CFG)


@given(M=st.sampled_from([2048, 4096, 8192, 16384]),
       K=st.sampled_from([2048, 4096, 8192]), df=st.sampled_from(DFORMS))
@settings(max_examples=60, deadline=None)
def test_speedup_below_roofline(M, K, df):
    s, _, _ = speedup_both(M, K, df)
    assert 0 < s <= CFG.roofline_pim_boost * 1.001


def test_large_gemv_close_to_roofline():
    s, _, _ = speedup_both(16384, 4096)
    assert s > 0.9 * CFG.roofline_pim_boost


@given(deg=st.sampled_from([1, 2, 4, 8]))
@settings(max_examples=20, deadline=None)
def test_breakdown_total_is_sum(deg):
    _, _, bd = speedup_both(3072, 768, split_k=deg)
    assert bd.total == pytest.approx(
        bd.t_mac + bd.t_shift + bd.t_iv + bd.t_turn + bd.t_row
        + bd.t_spill + bd.t_sf + bd.t_soc_reduce)
    scaled, rscaled = bd.scaled(0.5), r_tm.pim_speedup(
        gemvs(3072, 768)[1], R_CFG, split_k=deg)[2].scaled(0.5)
    assert_breakdown_equal(scaled, rscaled)


def test_pimnast_opt_matches_paper_band():
    avgs = model_avg(opt_cr_degree=True)
    assert max(avgs.values()) > 6.3
    assert 5.0 <= sum(avgs.values()) / len(avgs) <= 6.5


def test_125m_weakest_and_cr_degree_helps():
    base = model_avg(opt_cr_degree=False)
    opt = model_avg(opt_cr_degree=True)
    assert min(base, key=base.get) == "opt-125m"
    assert 1.15 <= opt["opt-125m"] / base["opt-125m"] <= 1.45


def colmajor_both(g: t_pl.GEMV, cfg=CFG):
    _, rg = gemvs(g.M, g.K, g.in_dform.name)
    bd = t_tm.pim_gemv_time(t_pl.baseline_colmajor_placement(g, cfg), cfg)
    rbd = r_tm.pim_gemv_time(
        r_pl.baseline_colmajor_placement(rg, R_CFG), R_CFG)
    assert_breakdown_equal(bd, rbd)
    soc = t_tm.soc_gemv_time_ns(g, cfg)
    assert soc == r_tm.soc_gemv_time_ns(rg, R_CFG)
    return soc / bd.total


def test_colmajor_slowdowns():
    slow = sum(colmajor_both(g) < 1.0 for m in t_opt.OPT_SUITE.values()
               for g in t_opt.token_gemvs(m))
    assert slow >= len(t_opt.OPT_SUITE)


def test_pimnast_beats_colmajor_everywhere():
    for m in t_opt.OPT_SUITE.values():
        for g in t_opt.token_gemvs(m):
            s_p, _, _ = speedup_both(g.M, g.K)
            assert s_p > colmajor_both(g)


def test_bank_sweep_tracks_roofline():
    lo = model_avg(CFG.with_(banks_per_channel=8))
    hi = model_avg(CFG.with_(banks_per_channel=32))
    assert 2.5 <= sum(lo.values()) / len(lo) <= 3.6
    assert 8.0 <= sum(hi.values()) / len(hi) <= 14.2
    assert max(hi.values()) <= CFG.with_(
        banks_per_channel=32).roofline_pim_boost * 1.001


def test_dataformat_sweep():
    a4 = model_avg(dform="int4")
    a16 = model_avg(dform="bf16")
    assert 4.3 <= sum(a4.values()) / len(a4) <= 5.9
    assert 5.3 <= sum(a16.values()) / len(a16) <= 6.6


def test_scale_factors_cost_and_blocksize_trend():
    nosf = model_avg()
    for df in ("int8", "int4"):
        s32 = model_avg(dform=df, sf=t_arch.ScaleFactorConfig(block_size=32))
        s128 = model_avg(dform=df,
                         sf=t_arch.ScaleFactorConfig(block_size=128))
        for name in t_opt.OPT_SUITE:
            assert s32[name] < nosf[name] * 1.001
            assert s32[name] <= s128[name] * 1.001


def test_register_alloc_trend():
    means = [sum(a.values()) / len(a) for a in (
        model_avg(in_reg_alloc=r, opt_cr_degree=False) for r in (2, 8, 14))]
    assert means[0] < means[1] <= means[2]
    assert (means[2] - means[1]) / means[1] < 0.06


def test_register_count_sweep():
    half = model_avg(CFG.with_(tot_reg=8), in_reg_alloc=4)
    dbl = model_avg(CFG.with_(tot_reg=32), in_reg_alloc=16)
    assert sum(half.values()) / len(half) >= 4.6
    assert sum(dbl.values()) / len(dbl) >= sum(half.values()) / len(half)


def best_split_k_both(g: t_pl.GEMV, **kw):
    _, rg = gemvs(g.M, g.K, g.in_dform.name)
    got = t_tm.best_split_k(g, CFG, **kw)
    ref = r_tm.best_split_k(rg, R_CFG, **kw)
    assert got[0] == ref[0]
    assert got[1] == pytest.approx(ref[1], rel=REL, abs=0)
    return got


def test_splitk_helps_125m():
    gains = []
    for g in t_opt.token_gemvs(t_opt.OPT_SUITE["opt-125m"]):
        base, _, _ = speedup_both(g.M, g.K)
        gains.append(best_split_k_both(g)[1] / base - 1)
    assert max(gains) > 0.25
    assert sum(gains) / len(gains) > 0.10


def test_cross_simd_hw_helps_125m():
    gains = []
    for g in t_opt.token_gemvs(t_opt.OPT_SUITE["opt-125m"]):
        base, _, _ = speedup_both(g.M, g.K)
        hw, _, _ = speedup_both(g.M, g.K, cross_simd_hw=True)
        gains.append(hw / base - 1)
    assert 0.1 <= sum(gains) / len(gains) <= 0.45


def test_e2e_bands():
    rs = []
    for name, m in t_opt.OPT_SUITE.items():
        r = t_e2e.e2e_latency(m, CFG)
        ref = r_e2e.e2e_latency(r_opt.OPT_SUITE[name], R_CFG)
        for f in ("t_token_soc_ns", "t_token_pim_ns", "t_prompt_ns",
                  "t_e2e_soc_ns", "t_e2e_pim_ns", "token_speedup",
                  "e2e_speedup", "tokengen_fraction_soc"):
            assert getattr(r, f) == pytest.approx(getattr(ref, f), rel=REL,
                                                  abs=0), (name, f)
        assert m.params == r_opt.OPT_SUITE[name].params
        rs.append(r)
    tok = [r.token_speedup for r in rs]
    e2e = [r.e2e_speedup for r in rs]
    assert 4.2 <= max(tok) <= 5.5
    assert 3.0 <= sum(tok) / len(tok) <= 4.2
    assert 3.0 <= max(e2e) <= 4.0
    assert all(r.tokengen_fraction_soc >= 0.88 for r in rs)


def test_lm_head_split_k_recovers_odd_vocab():
    g = t_opt.lm_head_gemv(t_opt.OPT_SUITE["opt-6.7b"])
    assert (g.M, g.K, g.name) == (lambda r: (r.M, r.K, r.name))(
        r_opt.lm_head_gemv(r_opt.OPT_SUITE["opt-6.7b"]))
    s, p, _ = speedup_both(g.M, g.K)
    assert s > 3.0
    deg, s_k = best_split_k_both(g)
    assert s_k >= s
    if deg > 1:
        assert plan_both(g.M, g.K, split_k=deg).tile.m_tile >= p.tile.m_tile


# --------------------------------------------------------------------------
# The twins of the paper's scripts
# --------------------------------------------------------------------------


def load_script(rel: str):
    path = os.path.join(REPO, rel)
    name = "_twin_" + rel.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fig", ["fig8", "fig9", "fig10", "fig11", "fig12",
                                 "fig13", "fig14", "fig15"])
def test_paper_figs_rows_equal_the_reference(fig):
    mine, ref = (load_script("benchmarks/paper_figs_torch.py"),
                 load_script("benchmarks/paper_figs.py"))
    [fn] = [f for f in mine.ALL_FIGS if f.__name__.split("_")[0] == fig]
    [rfn] = [f for f in ref.ALL_FIGS if f.__name__ == fn.__name__]
    rows, rrows = fn(), rfn()
    assert [r[0] for r in rows] == [r[0] for r in rrows]
    for (name, us, d), (_, rus, rd) in zip(rows, rrows):
        assert us == pytest.approx(rus, rel=REL, abs=0), name
        assert d == pytest.approx(rd, rel=REL, abs=0), name


def stdout_of(mod, argv: list[str]) -> str:
    buf, saved = io.StringIO(), sys.argv
    sys.argv = ["placement_explorer"] + argv
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = saved
    return buf.getvalue()


@pytest.mark.parametrize("argv", [
    [], ["--M", "3072", "--K", "768"],
    ["--M", "50272", "--K", "4096", "--dform", "int4", "--scale-block", "32"],
    ["--M", "768", "--K", "3072", "--dform", "bf16"]])
def test_placement_explorer_prints_the_reference_output(argv):
    out = stdout_of(load_script("examples/placement_explorer_torch.py"), argv)
    assert out == stdout_of(load_script("examples/placement_explorer.py"),
                            argv)
    assert "PIMnast-opt" in out and "split-K degree" in out


def test_paper_figs_cli_prints_every_row():
    mod = load_script("benchmarks/paper_figs_torch.py")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(["fig14"])
    lines = buf.getvalue().splitlines()
    assert len(lines) == len(mod.fig14_e2e())
    assert lines[0].startswith("fig14/opt-125m/per-token,")
