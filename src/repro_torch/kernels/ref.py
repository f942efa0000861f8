"""Plain PyTorch oracles for the decode GEMV kernels.

Counterparts of ``repro/kernels/ref.py``: ``gemv_ref`` and
``splitk_gemv_ref``, both accumulating in f32 and casting the output to
``x.dtype``.
"""

from __future__ import annotations

import torch


def gemv_ref(w_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[B, M] = x[B, K] @ w_t[K, M], f32 accumulation."""
    return torch.matmul(x.float(), w_t.float()).to(x.dtype)


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
