"""Column-block decode GEMV: ``csrc/triton_gemv.cu`` and its plain twin.

Replaces the Pallas-Triton kernel ``repro/kernels/triton_gemv.py::
triton_gemv``, the ``triton`` kernel of the ``gpu`` backend:
``out[B, M] = x[B, K] @ w_t[K, M]`` with f32 accumulation, output in
``x.dtype``, a column block a program and the K walk inside it.

What bounds it on an H100: at decode batch each weight element feeds
``2 * B`` flops, so the floor is the weight bytes over HBM bandwidth
(3.35 TB/s).  The kernel is a third set of entry points on the streaming
body of ``pim_gemv`` (``csrc/gemv_stream.cuh``): a ring of TMA-filled
16 KB weight sub-tiles, bf16 on the tensor cores, f32 on scalar FMAs.

The plan stays the JAX package's (``backends/gpu.py::plan_triton_gemv``:
``m_blk`` a power of two in [64, 512] dividing M, ``k_blk`` a power of two
of at least 16 dividing K), because table entries and the ``gpu`` cost
model name it.  The wrapper maps each plan column block onto
``m_blk / 128`` CTAs of the body (a 64-column block onto one 64-column
CTA: :func:`body_m_blk`), walks K in the body's own sub-tiles
(:func:`~repro_torch.kernels.gemv_plan.sub_rows`), and takes the plan's
ring depth.  Batches above 8 run as up to eight n = 8 tiles that share
each weight sub-tile (64 rows a launch; row chunks of 64 beyond); f32
runs row chunks of 8.  The plain version walks K in ``k_blk`` chunks and
adds their f32 products in order, as the Pallas body does.

A CPU tensor takes the plain version (:func:`triton_gemv_plain`); a CUDA
tensor launches the kernel or raises.  ``triton_gemv.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemv_plan import (
    MAX_STAGES,
    SMEM_PER_CTA,
    GemvPlan,
    stream_rows,
    stream_smem,
    sub_rows,
)
from repro_torch.kernels.pim_gemv import DTYPES, row_stride

M_BLKS = (64, 128, 256, 512)   # the JAX plan's column blocks
MIN_K_BLK = 16                 # one mma's k


def body_m_blk(plan: GemvPlan) -> int:
    """Columns of one CTA of the streaming body for a plan column block:
    128 (a block of m_blk is m_blk / 128 CTAs), or 64 for a 64-column
    block."""
    return 128 if plan.m_blk >= 128 else 64


def body_ctas(plan: GemvPlan) -> int:
    """CTAs of one launch: ``plan.n_m`` for blocks of 64 or 128 columns,
    ``m_blk / 128`` times that for wider ones."""
    return plan.n_m * plan.m_blk // body_m_blk(plan)


def plan_fits(plan: GemvPlan, M: int, K: int, batch: int = 1,
              elem_bytes: int = 2) -> bool:
    """Whether the kernel takes ``plan`` at this shape: the JAX plan's
    tiles, and a ring of ``plan.stages`` body sub-tiles within one CTA's
    shared memory at the rows one launch holds."""
    if (plan.split_k != 1 or plan.m_blk not in M_BLKS
            or plan.n_m * plan.m_blk != M or plan.k_blk < MIN_K_BLK
            or plan.k_blk % MIN_K_BLK or plan.n_k * plan.k_blk != K
            or not 1 <= plan.stages <= MAX_STAGES or batch < 1):
        return False
    m_blk = body_m_blk(plan)
    return stream_smem(stream_rows(batch, elem_bytes), m_blk,
                       sub_rows(m_blk, K, elem_bytes), plan.stages,
                       elem_bytes) <= SMEM_PER_CTA


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
    if not plan_fits(plan, M, K, B, x.element_size()):
        raise ValueError(f"plan {plan}: a ring of {plan.stages} sub-tiles "
                         f"does not fit the card's shared memory")
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
    m_blk = body_m_blk(plan)
    _build.check(fn(x.data_ptr(), w_t.data_ptr(), out.data_ptr(), B, K, M,
                    ld, m_blk, sub_rows(m_blk, K, x.element_size()),
                    plan.stages, stream), "triton_gemv")
    triton_gemv.launches += 1
    return out


triton_gemv.launches = 0
