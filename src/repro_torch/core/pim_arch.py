"""PIM system description for the PIMnast methodology (paper §II-B, §VI-A).

Models a commercially-viable PIM prototype in the style of Samsung HBM/LPDDR-PIM
[Lee+ ISCA'21] and SK Hynix AiM [Lee+ ISSCC'22]:

  * LPDDR5x-7500 memory, x16 channels (15 GB/s/channel), 8 channels -> 120 GB/s.
  * 16 banks per channel; a SIMD ALU + small register file next to every bank.
  * PIM mode activates the SAME row in all banks of a channel (all-bank ACT) and
    broadcasts the SAME command (MAC / register write / spill) to all banks.
  * PIM command rate is 2x slower than baseline column commands (paper §II-B),
    so the peak PIM bandwidth boost is  banks / 2  =  8x; DRAM row-open overheads
    bring the realizable roofline down to ~7x (paper §VI-A1).

Everything downstream (Algorithms 1-3, the DRAM-timing model, the sweeps in
benchmarks/) is parameterized by these dataclasses so the paper's resiliency
studies (#banks, #registers, interleaving granularity, data formats,
scale-factors) are one-line config changes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class DataFormat:
    """An element data format (paper §III-C3: BF16 / INT8 / INT4 ...)."""

    name: str
    bits: int

    def bytes_for(self, n_elems: int) -> int:
        return (n_elems * self.bits + 7) // 8


INT4 = DataFormat("int4", 4)
INT8 = DataFormat("int8", 8)
BF16 = DataFormat("bf16", 16)
FP16 = DataFormat("fp16", 16)
FP32 = DataFormat("fp32", 32)

FORMATS = {f.name: f for f in (INT4, INT8, BF16, FP16, FP32)}


@dataclass(frozen=True)
class ScaleFactorConfig:
    """Block-level scale factors for low-precision inference (paper §III-C3, §VI-D2).

    MX-style [OCP MX spec]: one scale per `block_size` contiguous K elements, for
    both the weight matrix and the input vector. ``interleaved=True`` places the
    weight scale factors at memory-interleaving-granularity chunks next to their
    weights (paper §IV-A3) so they land in the same DRAM row.
    """

    block_size: int = 32
    scale_bits: int = 8
    interleaved: bool = True


@dataclass(frozen=True)
class PIMConfig:
    """A PIM-enabled memory system (paper Table I + §VI-A1 defaults)."""

    # ---- topology -------------------------------------------------------
    channels: int = 8
    banks_per_channel: int = 16
    # ---- memory ---------------------------------------------------------
    interleave_gran_bytes: int = 256       # system data-interleaving granularity
    row_buffer_bytes: int = 2048           # per-bank DRAM row (Table I)
    dram_word_bytes: int = 32              # one column access = 256 bits
    channel_gbps: float = 15.0             # LPDDR5x-7500 x16: 15 GB/s per channel
    # ---- PIM ALU --------------------------------------------------------
    tot_reg: int = 16                      # registers per PIM ALU (paper §VI-A1)
    reg_size_bits: int = 256               # register width (one DRAM word)
    pim_cmd_rate_penalty: float = 2.0      # PIM commands at half the column rate
    # ---- DRAM timing (ns) ------------------------------------------------
    t_row_switch_ns: float = 36.0          # all-bank PRE+ACT between rows (tRP+tRCD)
    t_turnaround_ns: float = 20.0          # read<->write bus turnaround (pair)
    # ---- host SoC (for GEMV-SoC model + IV sourcing) ----------------------
    soc_tops_8b: float = 33.2              # peak TOPS across CPU+GPU+AIE (§VI-A1)

    # ---- derived ---------------------------------------------------------
    @property
    def tot_bank(self) -> int:
        return self.channels * self.banks_per_channel

    @property
    def peak_bw_gbps(self) -> float:
        """Baseline (non-PIM) system memory bandwidth."""
        return self.channels * self.channel_gbps

    @property
    def t_word_ns(self) -> float:
        """Baseline time to move one DRAM word on a channel's bus."""
        return self.dram_word_bytes / self.channel_gbps  # ns (B / (GB/s) = ns)

    @property
    def t_pim_cmd_ns(self) -> float:
        """Period of one broadcast PIM command (MAC / reg-write / spill)."""
        return self.t_word_ns * self.pim_cmd_rate_penalty

    @property
    def words_per_row(self) -> int:
        return self.row_buffer_bytes // self.dram_word_bytes

    @property
    def chunks_per_row(self) -> int:
        return self.row_buffer_bytes // self.interleave_gran_bytes

    @property
    def peak_pim_boost(self) -> float:
        """Best-case PIM bandwidth boost, ignoring row-open overheads (~8x)."""
        return self.banks_per_channel / self.pim_cmd_rate_penalty

    @property
    def roofline_pim_boost(self) -> float:
        """Realizable roofline: peak boost derated by row-open overheads (~7x).

        Streaming a full DRAM row costs ``words_per_row`` PIM commands plus one
        all-bank row switch; this duty cycle is the best any placement can do
        (paper §VI-A1: "roofline PIM acceleration drops to about 7x").
        """
        t_macs = self.words_per_row * self.t_pim_cmd_ns
        return self.peak_pim_boost * t_macs / (t_macs + self.t_row_switch_ns)

    def with_(self, **kw) -> "PIMConfig":
        return dataclasses.replace(self, **kw)


# The paper's baseline evaluation system: AMD Ryzen PRO 7040-class laptop SoC
# with 8ch LPDDR5x-7500 PIM-enabled memory (§VI-A1).
RYZEN_LPDDR5X = PIMConfig()


def preferred_page_bytes(cfg: PIMConfig) -> int:
    """Paper Table I / §V-A1: preferred page size.

    Minimally ``interleave_gran * tot_bank`` (so one broadcast covers all banks);
    preferred covers the row buffers too: ``row_buffer * tot_bank``.
    """
    minimal = cfg.interleave_gran_bytes * cfg.tot_bank
    preferred = cfg.row_buffer_bytes * cfg.tot_bank
    return max(minimal, preferred)
