"""DRAM-timing analytical model for GEMV-PIM (paper §VI-A3, "GEMV-PIM
Performance Model").

The paper uses an in-house DRAM-timing model; we rebuild it from first
principles with the mechanisms the paper describes, so every evaluation trend
(Figs. 8-15) is reproduced by construction of the same effects:

  * broadcast MAC command stream: one PIM command per 32B DRAM word PER BANK
    per ``t_pim_cmd_ns`` (= 2x the baseline column cadence -> peak 8x boost);
  * all-bank DRAM row-open overheads (``t_row_switch_ns`` per row per bank);
  * input-vector (IV) broadcast writes from the SoC, batched into ``in_reg``
    registers; each write<->MAC phase switch pays a bus-turnaround pair;
  * CR-degree IV reuse: one IV pass feeds ``deg`` row-blocks (paper §V-B2);
  * cross-SIMD-lane shifts when m_tile is smaller than the elements a DRAM
    word spans (short-wide tiles; paper §VI-F);
  * output-vector (OV) spills at row-block-group boundaries;
  * block scale-factor handling: metadata words streamed with the weights and
    per-(row-block, K-block) rescale commands (paper §VI-D2);
  * lockstep load-imbalance: broadcast forces every bank to step with the
    busiest bank (ceil distribution effects);
  * col-major / row-major baselines with their broadcast-breakdown, register
    spill, and SoC-side reduction regimes (paper Fig. 8 / footnote 3);
  * split-K: channel-subset parts in parallel + SoC reduction (paper §VI-F).

Calibration constants (documented in DESIGN.md): IV writes issue at
``iv_write_penalty`` x the PIM command period (SoC-sourced writes cross the
bus and the register-file port), cross-SIMD shifts cost
``log2(cols_per_word)`` extra commands per *tile*.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.pim_arch import PIMConfig, ScaleFactorConfig
from repro_torch.core.placement import (
    GEMV,
    Placement,
    TileOrder,
    plan_placement,
)

IV_WRITE_PENALTY = 2.0  # IV register-write period multiplier vs PIM MAC period


# --------------------------------------------------------------------------


@dataclass
class Breakdown:
    """Per-GEMV PIM execution-time breakdown (ns, per broadcast timeline)."""

    t_mac: float = 0.0        # weight-word MAC commands
    t_shift: float = 0.0      # cross-SIMD-lane reduction shifts
    t_iv: float = 0.0         # input-vector broadcast writes
    t_turn: float = 0.0       # read<->write bus turnarounds
    t_row: float = 0.0        # all-bank DRAM row switches
    t_spill: float = 0.0      # partial/final output spills to memory
    t_sf: float = 0.0         # block scale-factor metadata + rescale commands
    t_soc_reduce: float = 0.0 # host-side reduction (split-K / broken layouts)
    counts: dict = field(default_factory=dict)

    @property
    def total(self) -> float:
        return (
            self.t_mac + self.t_shift + self.t_iv + self.t_turn + self.t_row
            + self.t_spill + self.t_sf + self.t_soc_reduce
        )

    def scaled(self, f: float) -> "Breakdown":
        return Breakdown(
            self.t_mac * f, self.t_shift * f, self.t_iv * f, self.t_turn * f,
            self.t_row * f, self.t_spill * f, self.t_sf * f,
            self.t_soc_reduce * f, dict(self.counts),
        )


# --------------------------------------------------------------------------
# SoC (baseline) GEMV model — paper §VI-A3 "GEMV-SoC Performance Model"
# --------------------------------------------------------------------------


def soc_gemv_time_ns(gemv: GEMV, cfg: PIMConfig) -> float:
    """max(compute-time, memory-time) with the SoC's best IP block.

    Peak TOPS scales inversely with operand width relative to the 8b spec
    point (wider ops -> fewer per cycle), memory time is the weight bytes
    (vector/output traffic is negligible at GEMV shapes).
    """
    ops = 2.0 * gemv.M * gemv.K
    tops = cfg.soc_tops_8b * (8.0 / max(gemv.in_dform.bits, 8))
    t_compute = ops / (tops * 1e3)  # ops / (ops/ns)
    bytes_moved = gemv.weight_bytes + gemv.in_dform.bytes_for(gemv.K) \
        + gemv.out_dform.bytes_for(gemv.M)
    t_memory = bytes_moved / cfg.peak_bw_gbps  # B / (GB/s) = ns
    return max(t_compute, t_memory)


# --------------------------------------------------------------------------
# PIMnast CR-order placement timing
# --------------------------------------------------------------------------


def _sf_overhead(
    placement: Placement, cfg: PIMConfig, sf: ScaleFactorConfig,
    k_part: int, n_groups: int,
) -> tuple[float, float]:
    """(t_sf_ns, extra_iv_ns) for block scale-factors (paper §VI-D2).

    Per (row-block, K-block): stream the m_tile weight scales (interleaved with
    the weights at interleave granularity -> same DRAM row, §IV-A3) and issue
    two rescale multiplies (weight-scale, IV-scale) on the partial-output
    words. IV scales ride along with the IV broadcast.
    """
    t = placement.tile
    word_bits = cfg.dram_word_bytes * 8
    n_kblocks = max(1, math.ceil(k_part / sf.block_size))
    rb_pb = placement.rowblocks_per_bank
    sfw_words = math.ceil(t.m_tile * sf.scale_bits / word_bits)
    out_words = math.ceil(t.m_tile * placement.gemv.out_dform.bits / word_bits)
    rescale_cmds = 2 * out_words
    per_bank_cmds = rb_pb * n_kblocks * (sfw_words + rescale_cmds)
    t_sf = per_bank_cmds * cfg.t_pim_cmd_ns
    iv_sf_words = math.ceil(n_kblocks * sf.scale_bits / word_bits)
    extra_iv = n_groups * iv_sf_words * cfg.t_pim_cmd_ns * IV_WRITE_PENALTY
    return t_sf, extra_iv


def _pimnast_time(
    placement: Placement, cfg: PIMConfig, sf: ScaleFactorConfig | None,
    cross_simd_hw: bool,
) -> Breakdown:
    g, t = placement.gemv, placement.tile
    word_bits = cfg.dram_word_bytes * 8
    elems_per_word = word_bits // g.in_dform.bits
    words_per_tile = cfg.interleave_gran_bytes // cfg.dram_word_bytes

    k_part = math.ceil(g.K / placement.split_k.degree)
    k_TM = placement.k_TM
    rb_pb = placement.rowblocks_per_bank            # lockstep: ceil
    deg = min(placement.cr_degree, rb_pb)
    n_groups = math.ceil(rb_pb / deg)

    bd = Breakdown()
    # 1. MAC stream: every bank steps through its tiles under broadcast.
    n_mac = rb_pb * k_TM * words_per_tile
    bd.t_mac = n_mac * cfg.t_pim_cmd_ns

    # 2. Cross-SIMD-lane shifts: a DRAM word spanning >1 tile column puts
    #    partial products of the same output in different lane groups
    #    (paper §VI-F); merged per tile with log2 shift-adds.
    cols_per_word = max(1, elems_per_word // max(t.m_tile, 1))
    if cols_per_word > 1 and not cross_simd_hw:
        shifts_per_tile = math.ceil(math.log2(cols_per_word))
        bd.t_shift = rb_pb * k_TM * shifts_per_tile * cfg.t_pim_cmd_ns

    # 3. IV broadcast: one pass over this part's K per row-block GROUP
    #    (CR-degree reuse, §V-B2).
    iv_words = math.ceil(k_part * g.in_dform.bits / word_bits)
    bd.t_iv = n_groups * iv_words * cfg.t_pim_cmd_ns * IV_WRITE_PENALTY

    # 4. Turnarounds: IV arrives in batches of ``in_reg`` registers; each
    #    batch costs a write->read->write pair (§V-B1).
    n_batches = n_groups * math.ceil(iv_words / max(placement.in_reg_alloc, 1))
    bd.t_turn = n_batches * cfg.t_turnaround_ns

    # 5. DRAM row switches: CR-order walks each bank's rows sequentially.
    bank_bytes = rb_pb * k_TM * cfg.interleave_gran_bytes
    n_rows = math.ceil(bank_bytes / cfg.row_buffer_bytes)
    bd.t_row = n_rows * cfg.t_row_switch_ns

    # 6. OV spill at group boundaries (+ one turnaround to write mode).
    spill_words = math.ceil(deg * t.m_tile * g.out_dform.bits / word_bits)
    bd.t_spill = n_groups * (
        spill_words * cfg.t_pim_cmd_ns + cfg.t_turnaround_ns / 2
    )

    # 7. Block scale-factors.
    if sf is not None:
        bd.t_sf, extra_iv = _sf_overhead(placement, cfg, sf, k_part, n_groups)
        bd.t_iv += extra_iv

    # 8. Split-K: parts run concurrently on channel subsets; SoC gathers and
    #    reduces ``degree`` partial vectors (paper §VI-F).
    if placement.split_k.degree > 1:
        red_bytes = placement.split_k.degree * g.out_dform.bytes_for(g.M) * 2
        bd.t_soc_reduce = red_bytes / cfg.peak_bw_gbps

    bd.counts = dict(
        n_mac=n_mac, iv_words=iv_words * n_groups, n_batches=n_batches,
        n_rows=n_rows, rb_per_bank=rb_pb, deg=deg, groups=n_groups,
        m_tile=t.m_tile, k_tile=t.k_tile, cols_per_word=cols_per_word,
    )
    return bd


# --------------------------------------------------------------------------
# Col-major / row-major baseline timing (paper Fig. 8, footnote 3)
# --------------------------------------------------------------------------


def _colmajor_time(
    placement: Placement, cfg: PIMConfig, sf: ScaleFactorConfig | None
) -> Breakdown:
    """Classic column-major placement under 256B system interleaving.

    Two regimes, both broadcast-hostile (paper: "col-major layout can even
    lead to slowdowns"):

    * LARGE M (column >= one all-bank spread): every bank holds a slice of
      every column, so each bank accumulates partials for
      ``interleave_gran/in_bytes`` output rows per chunk — far beyond the
      register file. Partials spill to and reload from memory on every
      K step (read+write of out_dform per output per column).
    * SMALL/UNALIGNED M (column < spread or stride not chunk-aligned):
      different banks need DIFFERENT vector elements at the same broadcast
      step; IV writes serialize per distinct column in flight, and column
      boundaries straddling chunks split an output's partials across banks,
      which the SoC must reduce.
    Column tile-order also destroys DRAM row locality whenever the column
    stride exceeds the row buffer: every chunk opens a new row.
    """
    g = placement.gemv
    word_bits = cfg.dram_word_bytes * 8
    elems_per_word = word_bits // g.in_dform.bits
    in_bytes_per_col = g.in_dform.bytes_for(g.M)
    s_chunks = in_bytes_per_col / cfg.interleave_gran_bytes
    tot_bank = placement.banks_used

    n_chunks = math.ceil(g.weight_bytes / cfg.interleave_gran_bytes)
    chunk_steps = math.ceil(n_chunks / tot_bank)  # lockstep broadcast steps
    words_per_chunk = cfg.interleave_gran_bytes // cfg.dram_word_bytes

    bd = Breakdown()
    bd.t_mac = chunk_steps * words_per_chunk * cfg.t_pim_cmd_ns

    # Accumulator pressure: outputs covered by one chunk.
    outs_per_chunk = min(g.M, cfg.interleave_gran_bytes * 8 // g.in_dform.bits)
    accum_regs = math.ceil(outs_per_chunk * g.out_dform.bits / (cfg.reg_size_bits))
    avail = cfg.tot_reg - 1  # one register must hold IV
    if accum_regs > avail:
        # Spill/reload partials each K step: r+w of the chunk's outputs.
        spill_words = 2 * math.ceil(
            outs_per_chunk * g.out_dform.bits / word_bits
        )
        bd.t_spill = chunk_steps * spill_words * cfg.t_pim_cmd_ns
        bd.t_turn = chunk_steps * cfg.t_turnaround_ns

    if s_chunks >= tot_bank:
        # Broadcast-friendly on IV (all banks share k): one broadcast element
        # per column, and one write<->read phase switch per column.
        iv_cmds = g.K
        bd.t_iv = iv_cmds * cfg.t_pim_cmd_ns * IV_WRITE_PENALTY
        bd.t_turn += g.K * cfg.t_turnaround_ns
    else:
        # Columns narrower than a spread: several columns in flight, each
        # needing its own IV element -> serialized writes; misalignment
        # doubles them and forces SoC reduction of straddled outputs.
        cols_in_flight = max(1, math.floor(tot_bank / max(s_chunks, 1e-9)))
        misaligned = (in_bytes_per_col % cfg.interleave_gran_bytes) != 0
        iv_factor = 2 if misaligned else 1
        iv_cmds = g.K * iv_factor
        bd.t_iv = iv_cmds * cfg.t_pim_cmd_ns * IV_WRITE_PENALTY
        # A turnaround pair per batch of in-flight columns.
        bd.t_turn += (g.K / max(cols_in_flight, 1)) * cfg.t_turnaround_ns
        if misaligned:
            bd.t_soc_reduce = (
                2 * g.out_dform.bytes_for(g.M) * 2 / cfg.peak_bw_gbps
            )

    # Row locality: column-order revisits rows unless a whole column fits in
    # the per-bank row buffer footprint.
    col_rows = max(1.0, s_chunks / max(cfg.chunks_per_row, 1))
    if in_bytes_per_col >= cfg.row_buffer_bytes * tot_bank:
        n_rows = math.ceil(
            g.weight_bytes / (tot_bank * cfg.row_buffer_bytes)
        )
    else:
        # each chunk-step may open a fresh row (column-order striding)
        n_rows = chunk_steps
    bd.t_row = n_rows * cfg.t_row_switch_ns

    if sf is not None:
        # Scale factors are laid out per K-block; col-major scatters them
        # across banks — approximate with the PIMnast cost (conservative).
        t_sf, extra_iv = _sf_overhead(
            placement, cfg, sf, g.K, max(1, placement.rowblocks_per_bank)
        )
        bd.t_sf = t_sf
        bd.t_iv += extra_iv

    bd.counts = dict(
        chunk_steps=chunk_steps, s_chunks=s_chunks, accum_regs=accum_regs,
        n_rows=n_rows,
    )
    return bd


def _rowmajor_time(
    placement: Placement, cfg: PIMConfig, sf: ScaleFactorConfig | None
) -> Breakdown:
    """Row-major placement (paper footnote 3: impractical).

    Each matrix row stripes across all banks -> every output needs a
    cross-bank reduction via the SoC, and at any broadcast step banks hold
    different K ranges -> IV serializes per bank group.
    """
    g = placement.gemv
    tot_bank = placement.banks_used
    n_chunks = math.ceil(g.weight_bytes / cfg.interleave_gran_bytes)
    chunk_steps = math.ceil(n_chunks / tot_bank)
    words_per_chunk = cfg.interleave_gran_bytes // cfg.dram_word_bytes

    bd = Breakdown()
    bd.t_mac = chunk_steps * words_per_chunk * cfg.t_pim_cmd_ns
    # IV: every bank needs a different K chunk each step -> serialized.
    iv_words_total = math.ceil(g.K * g.in_dform.bits / (cfg.dram_word_bytes * 8))
    row_chunks = max(1.0, g.in_dform.bytes_for(g.K) / cfg.interleave_gran_bytes)
    banks_per_row = min(tot_bank, math.ceil(row_chunks))
    bd.t_iv = (
        iv_words_total * banks_per_row * cfg.t_pim_cmd_ns * IV_WRITE_PENALTY
    )
    bd.t_turn = chunk_steps * cfg.t_turnaround_ns
    bd.t_row = chunk_steps * cfg.t_row_switch_ns / max(cfg.chunks_per_row, 1)
    # Cross-bank reduction by SoC: read all banks' partials, reduce, write.
    partial_bytes = g.M * banks_per_row * g.out_dform.bytes_for(1)
    bd.t_soc_reduce = 2 * partial_bytes / cfg.peak_bw_gbps
    bd.counts = dict(chunk_steps=chunk_steps, banks_per_row=banks_per_row)
    return bd


# --------------------------------------------------------------------------
# Public entry points
# --------------------------------------------------------------------------


def pim_gemv_time(
    placement: Placement,
    cfg: PIMConfig,
    *,
    sf: ScaleFactorConfig | None = None,
    cross_simd_hw: bool = False,
) -> Breakdown:
    """Execution time of one GEMV on PIM under ``placement``."""
    if placement.order is TileOrder.COLUMN_ROW:
        return _pimnast_time(placement, cfg, sf, cross_simd_hw)
    if placement.order is TileOrder.COLUMN:
        return _colmajor_time(placement, cfg, sf)
    if placement.order is TileOrder.ROW:
        return _rowmajor_time(placement, cfg, sf)
    raise ValueError(placement.order)


def pim_speedup(
    gemv: GEMV,
    cfg: PIMConfig,
    *,
    in_reg_alloc: int = 8,
    opt_cr_degree: bool = True,
    split_k: int = 1,
    sf: ScaleFactorConfig | None = None,
    cross_simd_hw: bool = False,
) -> tuple[float, Placement, Breakdown]:
    """Speedup of PIMnast GEMV over the SoC baseline for one GEMV."""
    placement = plan_placement(
        gemv, cfg, in_reg_alloc=in_reg_alloc,
        opt_cr_degree=opt_cr_degree, split_k=split_k,
    )
    bd = pim_gemv_time(placement, cfg, sf=sf, cross_simd_hw=cross_simd_hw)
    t_soc = soc_gemv_time_ns(gemv, cfg)
    return t_soc / bd.total, placement, bd


def best_split_k(
    gemv: GEMV, cfg: PIMConfig, *, max_degree: int = 8, **kw
) -> tuple[int, float]:
    """Sweep split-K degrees (paper §VI-F) and return (best_degree, speedup)."""
    best = (1, 0.0)
    d = 1
    while d <= max_degree and d <= cfg.channels:
        s, _, _ = pim_speedup(gemv, cfg, split_k=d, **kw)
        if s > best[1]:
            best = (d, s)
        d *= 2
    return best
