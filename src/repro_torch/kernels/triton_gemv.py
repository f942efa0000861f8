"""Column-block decode GEMV on the tensor cores: ``csrc/triton_gemv.cu`` and
its plain twin.

Replaces the Pallas-Triton kernel ``repro/kernels/triton_gemv.py::
triton_gemv``, the ``triton`` kernel of the ``gpu`` backend:
``out[B, M] = x[B, K] @ w_t[K, M]`` with f32 accumulation, output in
``x.dtype``, one CTA per ``plan.m_blk`` column block (exactly
``plan.n_m`` blocks) and the K walk inside the CTA.

What bounds it on an H100: at decode batch each weight element feeds
``2 * B`` flops, so the floor is the weight bytes over HBM bandwidth
(3.35 TB/s).  In bf16 the kernel runs the multiply-adds on the tensor
cores (``mma.sync.m16n8k16``, x as the 8-row operand; batches above 8 run
in chunks of 8 rows inside the launch), reading each K sub-tile of the
weight once into shared memory; in f32 it runs scalar FMAs (no TF32
rounding of the operands).  See the source for the design.

The plan comes from ``backends/gpu.py::plan_triton_gemv``: ``m_blk`` a
power of two in [64, 512] dividing M, ``k_blk`` a power of two of at least
16 dividing K.  The plain version walks K in ``k_blk`` chunks and adds
their f32 products in order, as the Pallas body does.

A CPU tensor takes the plain version (:func:`triton_gemv_plain`); a CUDA
tensor launches the kernel or raises.  ``triton_gemv.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemv_plan import GemvPlan
from repro_torch.kernels.pim_gemv import DTYPES, row_stride

M_BLKS = (64, 128, 256, 512)   # the column blocks the kernel is built for
MIN_K_BLK = 16                 # one mma's k


def check_inputs(x: torch.Tensor, w_t: torch.Tensor,
                 plan: GemvPlan) -> tuple[int, int, int, int]:
    """Validate what the kernel takes; returns (B, K, M, ld), ``ld`` being
    ``w_t``'s row stride (:func:`~repro_torch.kernels.pim_gemv.row_stride`:
    contiguous columns, rows on 16-byte boundaries; nothing is copied)."""
    if x.ndim != 2 or w_t.ndim != 2:
        raise ValueError(f"expected x [B, K] and w_t [K, M], got "
                         f"{tuple(x.shape)} and {tuple(w_t.shape)}")
    B, K = x.shape
    K2, M = w_t.shape
    if K != K2:
        raise ValueError(f"x {tuple(x.shape)} and w_t {tuple(w_t.shape)} "
                         f"disagree on K")
    if x.dtype not in DTYPES or w_t.dtype != x.dtype:
        raise TypeError(f"x and w_t must share bf16 or f32, got {x.dtype} "
                        f"and {w_t.dtype}")
    if x.device != w_t.device:
        raise ValueError(f"x on {x.device} but w_t on {w_t.device}")
    ld = row_stride(w_t, "w_t")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and start on a 16-byte "
                         "boundary (the kernel reads it as 16-byte vectors)")
    if B < 1:
        raise ValueError(f"batch {B} < 1")
    if (plan.split_k != 1 or plan.m_blk not in M_BLKS
            or plan.n_m * plan.m_blk != M):
        raise ValueError(f"plan {plan} does not tile M={M}")
    if (plan.k_blk < MIN_K_BLK or plan.k_blk % MIN_K_BLK
            or plan.n_k * plan.k_blk != K):
        raise ValueError(f"plan {plan} does not tile K={K}")
    return B, K, M, ld


def triton_gemv_plain(x: torch.Tensor, w_t: torch.Tensor,
                      k_blk: int) -> torch.Tensor:
    """The same function in plain PyTorch: f32 products of ``k_blk``-row
    chunks of K added in order, cast to x.dtype."""
    acc = torch.zeros((x.shape[0], w_t.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, w_t.shape[0], k_blk):
        acc = acc + torch.matmul(x[:, k0:k0 + k_blk].float(),
                                 w_t[k0:k0 + k_blk].float())
    return acc.to(x.dtype)


def triton_gemv(x: torch.Tensor, w_t: torch.Tensor, *,
                plan: GemvPlan) -> torch.Tensor:
    """x [B, K], w_t [K, M] -> [B, M] through the column-block kernel."""
    B, K, M, ld = check_inputs(x, w_t, plan)
    if x.device.type == "cpu":
        return triton_gemv_plain(x, w_t, plan.k_blk)
    if x.device.type != "cuda":
        raise ValueError(f"triton_gemv runs on cuda or cpu, not {x.device}")
    lib = _build.load("triton_gemv")
    out = torch.empty((B, M), dtype=x.dtype, device=x.device)
    fn = getattr(lib, f"triton_gemv_{DTYPES[x.dtype]}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), w_t.data_ptr(), out.data_ptr(), B, K, M,
                    ld, plan.m_blk, plan.k_blk, stream), "triton_gemv")
    triton_gemv.launches += 1
    return out


triton_gemv.launches = 0
