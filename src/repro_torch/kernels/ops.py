"""Weight packing: the K-major layout every decode GEMV consumes.

Counterpart of ``repro/kernels/ops.py``.  A weight is prepacked once at
deployment into ``w_t [K, M]`` (the M axis contiguous, so each K row is one
coalesced stream for the kernels); shared-input projections are
concatenated along M into one fused weight.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PackedWeights:
    """A float weight in transposed (K-major) storage."""

    w_t: torch.Tensor   # [K, M]

    @property
    def shape(self) -> tuple[int, int]:
        """Logical (K, M)."""
        K, M = self.w_t.shape
        return int(K), int(M)


def pack_weight(w: torch.Tensor) -> PackedWeights:
    """[M, K] -> contiguous K-major storage (one copy, at deployment)."""
    return PackedWeights(w_t=w.t().contiguous())


def from_transposed(w_t: torch.Tensor) -> PackedWeights:
    """Wrap an already K-major [K, M] weight without copying (model layers
    store projections as [d_in, d_out] = [K, M])."""
    return PackedWeights(w_t=w_t)


def pack_fused(members: list[PackedWeights]
               ) -> tuple[PackedWeights, tuple[int, ...]]:
    """Concatenate shared-input projections along M into one fused weight.

    Returns the fused weight and the per-member output widths.
    """
    if not members:
        raise ValueError("cannot fuse an empty projection group")
    K = members[0].shape[0]
    for pw in members[1:]:
        if pw.w_t.ndim != 2 or pw.shape[0] != K:
            raise ValueError(f"fused weights must share K={K}; got "
                             f"{tuple(pw.w_t.shape)}")
    splits = tuple(pw.shape[1] for pw in members)
    fused = PackedWeights(w_t=torch.cat([pw.w_t for pw in members], dim=1))
    return fused, splits
