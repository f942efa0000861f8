"""Output-stationary decode GEMV: ``csrc/pim_gemv.cu`` and its plain twin.

Replaces the Pallas TPU kernel ``repro/kernels/pim_gemv.py::pim_gemv``:
``out[B, M] = x[B, K] @ w_t[K, M]`` with f32 accumulation, output in
``x.dtype``.

What bounds it on an H100: at decode batch (B <= 8) each weight element
feeds 2*B flops, so the kernel is bound by the weight bytes over HBM
bandwidth (3.35 TB/s).  The kernel streams each weight byte once through
a ring of ``plan.stages`` asynchronous K sub-tiles in shared memory and
runs bf16 on the tensor cores (``csrc/gemv_stream.cuh``); the plan
(``gemv_plan.plan_gemv``) sizes the column block and the ring so the grid
is resident on the card's SMs.

A CPU or meta tensor (the dry run) takes the plain version
(:func:`pim_gemv_plain`); a CUDA tensor launches the kernel or raises.
``pim_gemv.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemv_plan import (
    MAX_BATCH,
    GemvPlan,
    kernel_applicable,
    plan_fits,
)

DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def row_stride(t: torch.Tensor, name: str) -> int:
    """Row stride, in elements, of a ``[rows, M]`` operand the kernels
    stream as 16-byte vectors.  Its columns must be contiguous and every
    row must start on a 16-byte boundary; the rows may lie further apart
    than M, so a column slice of a wider prepacked weight (a fused
    program's member) runs without a copy.  Copying here instead would
    move a whole weight (206 MB for olmo-1b's tied head) on every call.
    """
    ld = t.stride(0) if t.shape[0] > 1 else t.shape[1]
    if (t.shape[1] > 1 and t.stride(1) != 1) or ld < t.shape[1]:
        raise ValueError(f"{name} {tuple(t.shape)} with strides "
                         f"{t.stride()} is not row-major with contiguous "
                         f"columns; prepack it once instead of copying it "
                         f"per call")
    if t.data_ptr() % 16 or ld * t.element_size() % 16:
        raise ValueError(f"{name} rows must start on 16-byte boundaries "
                         f"(the kernels read them as 16-byte vectors)")
    return ld


def check_inputs(x: torch.Tensor, w_t: torch.Tensor,
                 plan: GemvPlan) -> tuple[int, int, int, int]:
    """Validate what the kernels take; returns (B, K, M, ld), ``ld``
    being ``w_t``'s row stride (:func:`row_stride`)."""
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
                         "boundary")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"batch {B} outside 1..{MAX_BATCH}")
    if not kernel_applicable(M, K, B, x.element_size()):
        raise ValueError(f"M={M}, K={K}: the kernels take whole 16-byte "
                         f"column vectors and a K walk of whole 8-row "
                         f"groups")
    if not plan_fits(plan, M, K, B, x.element_size()):
        raise ValueError(f"plan {plan} does not tile M={M}, K={K} at "
                         f"B={B} within the card's shared memory")
    return B, K, M, ld


def pim_gemv_plain(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: f32 product, cast to x.dtype."""
    return torch.matmul(x.float(), w_t.float()).to(x.dtype)


def pim_gemv(x: torch.Tensor, w_t: torch.Tensor, *,
             plan: GemvPlan) -> torch.Tensor:
    """x [B, K], w_t [K, M] -> [B, M] through the output-stationary kernel."""
    _build.refuse_grad("pim_gemv", x, w_t)
    B, K, M, ld = check_inputs(x, w_t, plan)
    if plan.split_k != 1:
        raise ValueError(f"pim_gemv takes a plan with split_k=1, got {plan}")
    if _build.runs_plain("pim_gemv", x):
        return pim_gemv_plain(x, w_t)
    lib = _build.load("pim_gemv")
    out = torch.empty((B, M), dtype=x.dtype, device=x.device)
    fn = getattr(lib, f"pim_gemv_{DTYPES[x.dtype]}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), w_t.data_ptr(), out.data_ptr(), B, K, M,
                    ld, plan.m_blk, plan.k_blk, plan.stages, stream),
                 "pim_gemv")
    pim_gemv.launches += 1
    return out


pim_gemv.launches = 0
