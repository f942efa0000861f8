"""PIMnast matrix tiling and ordering (paper §IV).

Faithful implementations of:

  * Algorithm 1 — ``get_tile_shape``: pick (m_tile, k_tile) with tile bytes equal
    to the memory interleaving granularity, sweeping from column-vector (tall)
    toward row-vector (wide) until matrix rows distribute evenly over banks and
    the PIM register budget is honored.
  * Algorithm 2 — ``cr_order``: column-row order of tiles; one all-bank spread of
    row-blocks walks K before the next spread, so a matrix row lives in one bank
    in its entirety and consecutive tiles in a bank share DRAM rows.
  * Algorithm 3 — ``max_cr_degree``: raise the CR-degree (# row-blocks interleaved
    per bank, reusing each broadcast IV chunk) subject to output-register pressure.
  * Split-K (paper §VI-F): vertically decompose M x K into 2^i parts of
    K/2^i columns, each handled by a channel subset, SoC reduces partials.

Plus the generalized tile-shape x tile-order placement space of Fig. 6 (nine
placements) used by the placement explorer and the timing model's baselines.

The port's copy of ``repro.core.placement``: the planning code is the same
plain Python; the tile orders are int64 index tensors and the three array
functions (``tile_matrix_roworder``, ``untile_matrix_roworder``,
``materialize``) take and return tensors on the input's device.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass

import torch

from repro_torch.core.pim_arch import DataFormat, PIMConfig


# --------------------------------------------------------------------------
# Problem description
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class GEMV:
    """out[M] = W[M, K] @ x[K] (paper §III-A: weight matrix stationary in PIM)."""

    M: int
    K: int
    in_dform: DataFormat   # W and x format
    out_dform: DataFormat  # accumulator / output format (16b in the paper)
    name: str = "gemv"

    @property
    def weight_bytes(self) -> int:
        return self.in_dform.bytes_for(self.M * self.K)

    @property
    def macs(self) -> int:
        return self.M * self.K


# --------------------------------------------------------------------------
# Algorithm 1 — tile shape
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class TileShape:
    m_tile: int
    k_tile: int
    in_reg: int   # registers needed for the IV slice of one tile column
    out_reg: int  # registers needed for one row-block's partial outputs
    even: bool    # did the even-distribution test pass?


def get_param(
    gemv: GEMV, cfg: PIMConfig, m_tile: int, k_tile: int
) -> tuple[int, int]:
    """Algorithm 1, ``getParam``: register needs of a (m_tile, k_tile) tile.

    ``in_reg`` allows streaming reuse of IV register space at interleaving
    granularity (paper line 11-12); ``out_reg`` holds one row-block of partial
    outputs at the accumulator format.
    """
    in_reg_tot = (k_tile * gemv.in_dform.bits) / cfg.reg_size_bits
    in_reg = math.ceil(
        (in_reg_tot * cfg.reg_size_bits) / (cfg.interleave_gran_bytes * 8)
    )
    in_reg = max(in_reg, 1)
    out_reg = math.ceil((m_tile * gemv.out_dform.bits) / cfg.reg_size_bits)
    return in_reg, out_reg


def get_tile_shape(gemv: GEMV, cfg: PIMConfig) -> TileShape:
    """Algorithm 1, ``getTileShape``.

    Sweeps m_tile from ``elem_per_tile`` (column-vector) down by halving toward 1
    (row-vector). Terminates at the first shape that (a) evenly distributes
    matrix rows over all banks and (b) fits the register budget; otherwise falls
    back to the row-vector shape.
    """
    elem_per_tile = (cfg.interleave_gran_bytes * 8) // gemv.in_dform.bits
    m_tile = elem_per_tile
    k_tile = elem_per_tile // m_tile

    while m_tile >= 1:
        if gemv.M % (cfg.tot_bank * m_tile) == 0:
            in_reg, out_reg = get_param(gemv, cfg, m_tile, k_tile)
            if in_reg + out_reg <= cfg.tot_reg:
                return TileShape(m_tile, k_tile, in_reg, out_reg, even=True)
            if m_tile > 1:
                m_tile //= 2
                k_tile = elem_per_tile // m_tile
                continue
            in_reg, out_reg = get_param(gemv, cfg, m_tile, k_tile)
            return TileShape(m_tile, k_tile, in_reg, out_reg, even=True)
        if m_tile == 1:
            in_reg, out_reg = get_param(gemv, cfg, m_tile, k_tile)
            return TileShape(
                m_tile, k_tile, in_reg, out_reg,
                even=gemv.M % (cfg.tot_bank * m_tile) == 0,
            )
        m_tile //= 2
        k_tile = elem_per_tile // m_tile

    raise AssertionError("unreachable: m_tile sweep always terminates at 1")


# --------------------------------------------------------------------------
# Algorithm 2 — column-row order (CR-order)
# --------------------------------------------------------------------------


def _spread_order(m_TM: int, k_TM: int, rows_per_spread: int) -> torch.Tensor:
    """Row-order tile indices walked spread by spread: within each group of
    ``rows_per_spread`` consecutive row-blocks, every tile column in turn,
    and within it the group's row-blocks in order."""
    groups = m_TM // rows_per_spread
    return (torch.arange(m_TM * k_TM, dtype=torch.int64)
            .reshape(groups, rows_per_spread, k_TM)
            .transpose(1, 2).reshape(-1))


def cr_order(
    m_TM: int, k_TM: int, tot_bank: int, p: int = 1
) -> torch.Tensor:
    """Algorithm 2, ``getTileCROrder``.

    Input: tile indices of an [m_TM, k_TM] tile grid laid out in row-order.
    Output: a permutation (an int64 index tensor) ``order`` such that
    ``order[j]`` is the row-order tile index placed at linear memory
    position ``j``. Placement position j maps to bank ``(j // p) % tot_bank``
    under system interleaving (p contiguous tiles per bank per spread; p=1
    in the paper's Algorithm 2).

    Walks: for each all-bank spread q (a group of ``tot_bank*p`` consecutive
    row-blocks), for each tile column cj, emit the spread's row-blocks ri —
    i.e. tiles of one row-block land in one bank, walking K within a DRAM row.
    """
    if m_TM % (tot_bank * p) != 0:
        raise ValueError(
            f"CR-order requires m_TM ({m_TM}) divisible by tot_bank*p "
            f"({tot_bank}*{p}); pad the row-blocks or lower p."
        )
    return _spread_order(m_TM, k_TM, tot_bank * p)


def cr_order_with_degree(
    m_TM: int, k_TM: int, tot_bank: int, degree: int
) -> torch.Tensor:
    """CR-order generalized to CR-degree > 1 (paper §V-B2).

    With degree d, d row-blocks of a bank are interleaved column-by-column so
    one broadcast IV chunk is consumed by d row-blocks before the next chunk is
    sent. Layout per spread-group: for each tile column cj, emit the d
    interleaved spreads' row-blocks. Equivalent to Algorithm 2 with p = degree
    but bank assignment striding spreads (row-blocks r and r + tot_bank go to
    the SAME bank, consecutive in memory within a row's worth of tiles).
    """
    if degree < 1:
        raise ValueError("degree must be >= 1")
    if m_TM % (tot_bank * degree) != 0:
        raise ValueError(
            f"CR-degree {degree} requires m_TM ({m_TM}) divisible by "
            f"tot_bank*degree ({tot_bank * degree})"
        )
    return _spread_order(m_TM, k_TM, tot_bank * degree)


# --------------------------------------------------------------------------
# Algorithm 3 — maximum CR-degree
# --------------------------------------------------------------------------


def max_cr_degree(
    M: int, m_tile: int, tot_bank: int, in_reg: int, out_reg: int, tot_reg: int
) -> int:
    """Algorithm 3, ``getCROMaxDegree``.

    The largest number of row-blocks per bank whose partial outputs fit the
    register file alongside the IV allocation; bounded by row-blocks per bank.
    """
    rowblk_per_bank = M // (m_tile * tot_bank)
    max_deg = cur_deg = 1
    while cur_deg <= rowblk_per_bank:
        if (cur_deg * out_reg) + in_reg <= tot_reg:
            max_deg = cur_deg
        cur_deg += 1
    return max(max_deg, 1)


# --------------------------------------------------------------------------
# Placement space (Fig. 6) and the full PIMnast plan
# --------------------------------------------------------------------------


class TileOrder(enum.Enum):
    ROW = "row-order"           # walk K fastest (row-major tile order)
    COLUMN = "column-order"     # walk M fastest (column-major tile order)
    COLUMN_ROW = "cr-order"     # PIMnast: one all-bank spread, then walk K


class Layout(enum.Enum):
    """Classic coupled layouts (Fig. 6) used as baselines."""

    ROW_MAJOR = "row-major"        # row-vector tiles + row order
    COL_MAJOR = "col-major"        # column-vector tiles + column order
    PIMNAST = "pimnast"            # Algorithm-1 tiles + CR order


@dataclass(frozen=True)
class SplitK:
    """Split-K decomposition (paper §VI-F): K split into ``degree`` parts,
    each processed by ``channels // degree`` channels; SoC reduces partials."""

    degree: int = 1

    def __post_init__(self):
        if self.degree < 1 or (self.degree & (self.degree - 1)) != 0:
            raise ValueError("split-K degree must be a power of two >= 1")


@dataclass(frozen=True)
class Placement:
    """A fully resolved PIMnast data-placement for one GEMV."""

    gemv: GEMV
    tile: TileShape
    order: TileOrder
    cr_degree: int
    split_k: SplitK
    in_reg_alloc: int          # registers allocated to IV (orchestration knob 1)
    banks_used: int            # banks per split-K part
    channels_used: int         # channels per split-K part

    @property
    def m_TM(self) -> int:
        return math.ceil(self.gemv.M / self.tile.m_tile)

    @property
    def k_TM(self) -> int:
        k_part = math.ceil(self.gemv.K / self.split_k.degree)
        return math.ceil(k_part / self.tile.k_tile)

    @property
    def rowblocks_per_bank(self) -> int:
        return math.ceil(self.m_TM / self.banks_used)

    def describe(self) -> str:
        return (
            f"{self.gemv.name}[{self.gemv.M}x{self.gemv.K} "
            f"{self.gemv.in_dform.name}] tile={self.tile.m_tile}x{self.tile.k_tile} "
            f"order={self.order.value} deg={self.cr_degree} "
            f"splitk={self.split_k.degree} in_reg={self.in_reg_alloc}"
        )


def plan_placement(
    gemv: GEMV,
    cfg: PIMConfig,
    *,
    in_reg_alloc: int = 8,
    opt_cr_degree: bool = True,
    split_k: int = 1,
) -> Placement:
    """End-to-end PIMnast planning for one GEMV.

    1. (optional) split-K: the tile-shape algorithm then sees K/degree columns
       and tot_bank/degree banks per part (paper §VI-F).
    2. Algorithm 1 picks the tile shape.
    3. Algorithm 3 (if ``opt_cr_degree``) picks the CR-degree given the IV
       register allocation (baseline 8 of 16; paper §V-B1).
    """
    sk = SplitK(split_k)
    channels_used = max(cfg.channels // sk.degree, 1)
    banks_used = channels_used * cfg.banks_per_channel
    part_cfg = cfg.with_(channels=channels_used)
    part_gemv = GEMV(
        M=gemv.M,
        K=math.ceil(gemv.K / sk.degree),
        in_dform=gemv.in_dform,
        out_dform=gemv.out_dform,
        name=gemv.name,
    )
    tile = get_tile_shape(part_gemv, part_cfg)
    # IV allocation cannot exceed what's left after one row-block of outputs.
    in_alloc = min(in_reg_alloc, max(cfg.tot_reg - tile.out_reg, 1))
    if opt_cr_degree:
        deg = max_cr_degree(
            part_gemv.M, tile.m_tile, banks_used, in_alloc, tile.out_reg,
            cfg.tot_reg,
        )
    else:
        deg = 1
    return Placement(
        gemv=gemv,
        tile=tile,
        order=TileOrder.COLUMN_ROW,
        cr_degree=deg,
        split_k=sk,
        in_reg_alloc=in_alloc,
        banks_used=banks_used,
        channels_used=channels_used,
    )


def baseline_colmajor_placement(gemv: GEMV, cfg: PIMConfig) -> Placement:
    """The paper's comparison point: classic column-major layout.

    Column-major == column-vector tiles + column tile-order (Fig. 6 top).
    """
    elem_per_tile = (cfg.interleave_gran_bytes * 8) // gemv.in_dform.bits
    m_tile = elem_per_tile
    in_reg, out_reg = get_param(gemv, cfg, m_tile, 1)
    tile = TileShape(
        m_tile=m_tile, k_tile=1, in_reg=in_reg, out_reg=out_reg,
        even=gemv.M % (cfg.tot_bank * m_tile) == 0,
    )
    return Placement(
        gemv=gemv, tile=tile, order=TileOrder.COLUMN, cr_degree=1,
        split_k=SplitK(1), in_reg_alloc=8, banks_used=cfg.tot_bank,
        channels_used=cfg.channels,
    )


def baseline_rowmajor_placement(gemv: GEMV, cfg: PIMConfig) -> Placement:
    """Row-major layout (paper footnote 3: impractical for PIM, modeled for
    completeness): row-vector tiles + row tile-order (Fig. 6 bottom)."""
    elem_per_tile = (cfg.interleave_gran_bytes * 8) // gemv.in_dform.bits
    in_reg, out_reg = get_param(gemv, cfg, 1, elem_per_tile)
    tile = TileShape(
        m_tile=1, k_tile=elem_per_tile, in_reg=in_reg, out_reg=out_reg,
        even=gemv.M % cfg.tot_bank == 0,
    )
    return Placement(
        gemv=gemv, tile=tile, order=TileOrder.ROW, cr_degree=1,
        split_k=SplitK(1), in_reg_alloc=8, banks_used=cfg.tot_bank,
        channels_used=cfg.channels,
    )


# --------------------------------------------------------------------------
# Materialization: apply a placement to an actual matrix (paper §V-A1 step 2:
# logical view -> virtual view), as index operations on the matrix's device.
# --------------------------------------------------------------------------


def tile_matrix_roworder(W: torch.Tensor, m_tile: int,
                         k_tile: int) -> torch.Tensor:
    """Tile [M, K] into row-ordered tiles, each flattened column-major
    (intra-tile column-major avoids cross-SIMD-lane ops; paper §IV-A1).

    Returns [m_TM * k_TM, m_tile * k_tile] on ``W``'s device. Ragged edges
    are zero-padded.
    """
    M, K = W.shape
    m_TM = math.ceil(M / m_tile)
    k_TM = math.ceil(K / k_tile)
    padded = W.new_zeros((m_TM * m_tile, k_TM * k_tile))
    padded[:M, :K] = W
    tiles = padded.reshape(m_TM, m_tile, k_TM, k_tile).permute(0, 2, 3, 1)
    # (..., k_tile, m_tile) flattened = column-major within the (m x k) tile.
    return tiles.reshape(m_TM * k_TM, m_tile * k_tile)


def untile_matrix_roworder(
    tiles: torch.Tensor, M: int, K: int, m_tile: int, k_tile: int
) -> torch.Tensor:
    """Inverse of :func:`tile_matrix_roworder` (drops padding)."""
    m_TM = math.ceil(M / m_tile)
    k_TM = math.ceil(K / k_tile)
    t = tiles.reshape(m_TM, k_TM, k_tile, m_tile).permute(0, 3, 1, 2)
    return t.reshape(m_TM * m_tile, k_TM * k_tile)[:M, :K]


def materialize(W: torch.Tensor, placement: Placement) -> torch.Tensor:
    """Produce the linear (virtual-address-order) tile stream for a placement.

    Returns [n_tiles, tile_elems] on ``W``'s device: position j of the
    stream is what the memory system maps to bank ``j % banks_used`` (256B
    interleaving).
    """
    t = placement.tile
    tiles = tile_matrix_roworder(W, t.m_tile, t.k_tile)
    m_TM, k_TM = placement.m_TM, placement.k_TM
    if placement.order is TileOrder.ROW:
        order = torch.arange(m_TM * k_TM, dtype=torch.int64)
    elif placement.order is TileOrder.COLUMN:
        order = (
            torch.arange(m_TM * k_TM, dtype=torch.int64)
            .reshape(m_TM, k_TM)
            .T.reshape(-1)
        )
    else:
        if placement.cr_degree > 1:
            order = cr_order_with_degree(
                m_TM, k_TM, placement.banks_used, placement.cr_degree
            )
        else:
            order = cr_order(m_TM, k_TM, placement.banks_used)
    return tiles[order.to(tiles.device)]


def bank_of_position(j: int, placement: Placement) -> int:
    """Which bank a tile-stream position lands in under system interleaving."""
    return j % placement.banks_used
