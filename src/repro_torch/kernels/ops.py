"""Weight packing: the K-major layout every decode GEMV consumes.

Counterpart of ``repro/kernels/ops.py``.  A weight is prepacked once at
deployment into ``w_t [K, M]`` (the M axis contiguous, so each K row is one
coalesced stream for the kernels); shared-input projections are
concatenated along M into one fused weight.  :func:`quantize_weight` stores
a weight as int8 or packed int4 codes with MX-style per-(K-block, column)
f32 scales (the paper's GenAI-needs placement, §III-C3 / §VI-D2).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.gemv_plan import GemvPlan


@dataclass(frozen=True)
class PackedWeights:
    """A weight in transposed (K-major) storage.

    Float weights carry ``w_t [K, M]`` and ``bits=16``.  Quantized ones
    carry int8 codes ``w_t [K, M]`` (``bits=8``) or packed int4 codes
    ``[K // 2, M]`` (``bits=4``: row 2i in the low nibble of packed row i,
    row 2i+1 in the high one) plus f32 ``scales [K // block, M]``.
    """

    w_t: torch.Tensor                    # [K, M], or [K // 2, M] for int4
    scales: torch.Tensor | None = None   # [K // block, M] when quantized
    bits: int = 16
    block: int = 32

    @property
    def shape(self) -> tuple[int, int]:
        """Logical (K, M): int4 packs two K rows per byte."""
        K, M = self.w_t.shape[-2], self.w_t.shape[-1]
        if self.bits == 4:
            K *= 2
        return int(K), int(M)

    def columns(self, lo: int, hi: int) -> "PackedWeights":
        """Columns ``[lo, hi)`` (views of the codes and the scales)."""
        return PackedWeights(
            w_t=self.w_t[:, lo:hi],
            scales=None if self.scales is None else self.scales[:, lo:hi],
            bits=self.bits, block=self.block)


def pack_weight(w: torch.Tensor) -> PackedWeights:
    """[M, K] -> contiguous K-major storage (one copy, at deployment)."""
    return PackedWeights(w_t=w.t().contiguous())


def from_transposed(w_t: torch.Tensor) -> PackedWeights:
    """Wrap an already K-major [K, M] weight without copying (model layers
    store projections as [d_in, d_out] = [K, M])."""
    return PackedWeights(w_t=w_t)


def quantize_weight(w, *, bits: int = 8, block: int = 32,
                    device=None) -> PackedWeights:
    """Symmetric per-(K-block, column) quantization (MX-style, §VI-D2).

    ``w [M, K]`` float -> int8 codes ``[K, M]`` (packed int4 ``[K // 2,
    M]``) plus f32 scales ``[K // block, M]``: ``scale = amax / qmax`` over
    each block of ``block`` K rows (1.0 for an all-zero block), codes
    rounded half-to-even and clipped to ``[-qmax - 1, qmax]``.  The codes
    and scales are byte-equal to the JAX package's ``quantize_weight`` (all
    f32 arithmetic, each step correctly rounded).

    A tensor is quantized on its own device unless ``device`` names
    another; anything else (a numpy array) goes to
    ``resolve_device(device)``.
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if isinstance(w, torch.Tensor):
        dev = w.device if device is None else resolve_device(device)
        wf = w.to(dev, torch.float32)
    else:
        wf = torch.from_numpy(np.asarray(w, np.float32)).to(
            resolve_device(device))
    wf = wf.t()                                      # [K, M]
    K, M = wf.shape
    if K % block:
        raise ValueError(f"K={K} is not a multiple of block={block}")
    if bits == 4 and K % 2:
        raise ValueError(f"int4 packs K rows in pairs; K={K} is odd")
    g = wf.reshape(K // block, block, M)
    qmax = 127.0 if bits == 8 else 7.0
    amax = g.abs().amax(dim=1)                       # [K // block, M]
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its rounded reciprocal, which is not the correctly rounded quotient
    scales = amax / torch.full_like(amax, qmax)
    scales = torch.where(scales == 0, torch.ones_like(scales), scales)
    q = torch.clamp(torch.round(g / scales[:, None, :]), -qmax - 1, qmax)
    q = q.reshape(K, M).to(torch.int8)
    if bits == 4:
        lo = q[0::2].to(torch.int16) & 0xF
        hi = (q[1::2].to(torch.int16) & 0xF) << 4
        q = (lo | hi).to(torch.uint8).view(torch.int8)   # [K // 2, M]
    return PackedWeights(w_t=q.contiguous(), scales=scales.contiguous(),
                         bits=bits, block=block)


def pack_fused(members: list[PackedWeights]
               ) -> tuple[PackedWeights, tuple[int, ...]]:
    """Concatenate shared-input projections along M into one fused weight.

    Members must share K, bits and block; quantized members concatenate
    their scales along M too.  Returns the fused weight and the per-member
    output widths.
    """
    if not members:
        raise ValueError("cannot fuse an empty projection group")
    head = members[0]
    for pw in members[1:]:
        if (pw.w_t.ndim != 2 or pw.w_t.shape[0] != head.w_t.shape[0]
                or pw.bits != head.bits or pw.block != head.block):
            raise ValueError(
                f"fused weights must share K/bits/block; got "
                f"{tuple(pw.w_t.shape)}/w{pw.bits} vs "
                f"{tuple(head.w_t.shape)}/w{head.bits}")
    splits = tuple(int(pw.w_t.shape[1]) for pw in members)
    fused = PackedWeights(
        w_t=torch.cat([pw.w_t for pw in members], dim=1),
        scales=(None if head.scales is None
                else torch.cat([pw.scales for pw in members], dim=1)),
        bits=head.bits, block=head.block)
    return fused, splits


def align_plan_to_block(plan: GemvPlan, M: int, K: int,
                        block: int) -> GemvPlan:
    """Make a plan executable by the quant kernels (the counterpart of
    ``repro/kernels/ops.py::_align_plan_to_block``): the K chunk covers
    whole scale blocks, and a split-K plan becomes one K walk."""
    if plan.split_k == 1 and plan.k_blk % block == 0:
        return plan
    k_blk = max(block, (plan.k_blk // block) * block)
    while K % k_blk:
        k_blk -= block
        if k_blk <= 0:
            k_blk = K
            break
    return GemvPlan(m_blk=plan.m_blk, k_blk=k_blk, n_m=M // plan.m_blk,
                    n_k=K // k_blk, smem_bytes=plan.smem_bytes, split_k=1)
