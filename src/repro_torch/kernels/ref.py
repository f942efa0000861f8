"""Plain PyTorch oracles for the decode GEMV kernels.

Counterparts of ``repro/kernels/ref.py``: ``gemv_ref``,
``splitk_gemv_ref`` and the block-scale dequant oracles ``quant_gemv_ref``
/ ``quant4_gemv_ref`` (with ``unpack_int4``, the one place the int4 nibble
order is spelled out), all accumulating in f32 and casting the output to
``x.dtype``.
"""

from __future__ import annotations

import torch


def gemv_ref(w_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[B, M] = x[B, K] @ w_t[K, M], f32 accumulation."""
    return torch.matmul(x.float(), w_t.float()).to(x.dtype)


def quant_gemv_ref(w_q: torch.Tensor, scales: torch.Tensor, x: torch.Tensor,
                   block: int) -> torch.Tensor:
    """Block-scale-factor GEMV: ``w_q [K, M]`` int8 codes times f32
    ``scales [K // block, M]`` (one per K-block and column), dequantized in
    f32, then an f32 product cast to ``x.dtype``."""
    K, M = w_q.shape
    w = w_q.float().reshape(K // block, block, M) * scales.float()[:, None]
    return torch.matmul(x.float(), w.reshape(K, M)).to(x.dtype)


def unpack_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """``[..., K // 2, M]`` int8 holding two nibbles per byte along K ->
    ``[..., K, M]`` int8 in [-8, 7].

    Even K rows live in the low nibble, odd rows in the high nibble; both
    are sign-extended by an arithmetic right shift.  Leading dims pass
    through.
    """
    lo = (w_packed << 4) >> 4     # int8 shifts: the left one wraps, the
    hi = w_packed >> 4            # right one is arithmetic
    K2, M = w_packed.shape[-2], w_packed.shape[-1]
    return torch.stack([lo, hi], dim=-2).reshape(
        *w_packed.shape[:-2], 2 * K2, M)


def quant4_gemv_ref(w_packed: torch.Tensor, scales: torch.Tensor,
                    x: torch.Tensor, block: int) -> torch.Tensor:
    """Packed-int4 block-scale GEMV."""
    return quant_gemv_ref(unpack_int4(w_packed), scales, x, block)


def splitk_gemv_ref(w_t: torch.Tensor, x: torch.Tensor,
                    degree: int) -> torch.Tensor:
    """Per-part f32 partials summed left to right (part 0, 1, ...)."""
    K = w_t.shape[0]
    kp = K // degree
    acc = None
    for i in range(degree):
        part = torch.matmul(x[:, i * kp:(i + 1) * kp].float(),
                            w_t[i * kp:(i + 1) * kp].float())
        acc = part if acc is None else acc + part
    return acc.to(x.dtype)
