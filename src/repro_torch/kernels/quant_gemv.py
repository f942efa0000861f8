"""Block-scaled quantized decode GEMV: ``csrc/quant_gemv.cu`` and its plain
twins.

Replaces the Pallas TPU kernels ``repro/kernels/quant_gemv.py::quant_gemv``
(int8 codes ``[K, M]``) and ``::quant4_gemv`` (packed int4 codes ``[K // 2,
M]``, row 2i in the low nibble, row 2i + 1 in the high one): each weight
element is dequantized as ``q * s`` with its per-(K-block, column) f32
scale, the product with ``x`` runs in f32, and ``out`` is written in
``x.dtype``.

What bounds it on an H100: the code bytes plus the scales over HBM
bandwidth (3.35 TB/s), about half (int8) or a quarter (int4) of the bf16
weight stream.  The kernels run on the streaming body of ``pim_gemv`` /
``splitk_gemv`` (``csrc/gemv_stream.cuh``): a ring of TMA slots that carry
codes, x and scales together, codes turned into bf16 in registers and
multiplied on the tensor cores (f32 x: scalar FMAs), each scale block
summed apart and scaled into the f32 sum, and a split-K cluster where the
plan asks for one (``gemv_plan.plan_quant``).  One launch holds up to 64
rows of bf16 x (8 of f32); more run in row chunks inside the call.

A CPU or meta tensor (the dry run) takes the plain version
(:func:`quant_gemv_plain`, :func:`quant4_gemv_plain`); a CUDA tensor
launches the kernel or raises.  ``quant_gemv.launches`` /
``quant4_gemv.launches`` count kernel calls.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.gemv_plan import GemvPlan, quant_plan_fits
from repro_torch.kernels.pim_gemv import DTYPES, row_stride


def check_quant_inputs(x: torch.Tensor, w_q: torch.Tensor,
                       scales: torch.Tensor, block: int, bits: int,
                       plan: GemvPlan) -> tuple[int, int, int, int, int]:
    """Validate what the quant kernels take; returns (B, K, M, ldw, lds),
    the row strides of the codes and the scales.

    Nothing is copied: the codes' and scales' rows must already be
    contiguous and start on 16-byte boundaries (the tensor maps' rule), as
    a column slice of a prepacked weight's are (:func:`row_stride`).
    """
    if x.ndim != 2 or w_q.ndim != 2 or scales.ndim != 2:
        raise ValueError(f"expected x [B, K], codes [K', M] and scales "
                         f"[K / block, M], got {tuple(x.shape)}, "
                         f"{tuple(w_q.shape)} and {tuple(scales.shape)}")
    B, K = x.shape
    rows, M = w_q.shape
    if rows * (2 if bits == 4 else 1) != K:
        raise ValueError(f"x {tuple(x.shape)} and int{bits} codes "
                         f"{tuple(w_q.shape)} disagree on K")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be bf16 or f32, got {x.dtype}")
    if w_q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"codes must be int8 and scales f32, got "
                        f"{w_q.dtype} and {scales.dtype}")
    if not (x.device == w_q.device == scales.device):
        raise ValueError(f"x on {x.device}, codes on {w_q.device}, scales "
                         f"on {scales.device}")
    if block <= 0 or K % block or (bits == 4 and block % 2):
        raise ValueError(f"K={K} is not a whole number of scale blocks "
                         f"of {block}")
    if tuple(scales.shape) != (K // block, M):
        raise ValueError(f"scales {tuple(scales.shape)} are not "
                         f"[K / block, M] = {(K // block, M)}")
    ldw, lds = row_stride(w_q, "codes"), row_stride(scales, "scales")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and start on a 16-byte "
                         "boundary")
    if B < 1:
        raise ValueError("empty batch")
    if not quant_plan_fits(plan, M, K, B, bits=bits, block=block,
                           elem_bytes=x.element_size()):
        raise ValueError(f"plan {plan} does not tile M={M}, K={K} in whole "
                         f"blocks of {block} at B={B} within the card's "
                         f"shared memory")
    return B, K, M, ldw, lds


def quant_gemv_plain(x: torch.Tensor, w_q: torch.Tensor,
                     scales: torch.Tensor, block: int) -> torch.Tensor:
    """The same function in plain PyTorch: dequantize in f32, f32 product,
    cast to x.dtype."""
    return ref.quant_gemv_ref(w_q, scales, x, block)


def quant4_gemv_plain(x: torch.Tensor, w_packed: torch.Tensor,
                      scales: torch.Tensor, block: int) -> torch.Tensor:
    """Packed int4: unpack the nibbles, then as :func:`quant_gemv_plain`."""
    return ref.quant4_gemv_ref(w_packed, scales, x, block)


def _launch(fn_name: str, counter, x, w_q, scales, block, plan, B, K, M,
            ldw, lds):
    lib = _build.load("quant_gemv")
    out = torch.empty((B, M), dtype=x.dtype, device=x.device)
    fn = getattr(lib, f"{fn_name}_{DTYPES[x.dtype]}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                    out.data_ptr(), B, K, M, ldw, lds, block, plan.split_k,
                    plan.m_blk, plan.k_blk, plan.stages, stream), fn_name)
    counter.launches += 1
    return out


def quant_gemv(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor, *,
               block: int, plan: GemvPlan) -> torch.Tensor:
    """x [B, K], int8 codes [K, M], scales [K / block, M] -> [B, M]."""
    _build.refuse_grad("quant_gemv", x, w_q, scales)
    B, K, M, ldw, lds = check_quant_inputs(x, w_q, scales, block, 8, plan)
    if _build.runs_plain("quant_gemv", x):
        return quant_gemv_plain(x, w_q, scales, block)
    return _launch("quant_gemv", quant_gemv, x, w_q, scales, block, plan,
                   B, K, M, ldw, lds)


def quant4_gemv(x: torch.Tensor, w_packed: torch.Tensor,
                scales: torch.Tensor, *, block: int,
                plan: GemvPlan) -> torch.Tensor:
    """x [B, K], packed int4 codes [K / 2, M], scales [K / block, M] ->
    [B, M]."""
    _build.refuse_grad("quant4_gemv", x, w_packed, scales)
    B, K, M, ldw, lds = check_quant_inputs(x, w_packed, scales, block, 4,
                                           plan)
    if _build.runs_plain("quant4_gemv", x):
        return quant4_gemv_plain(x, w_packed, scales, block)
    return _launch("quant4_gemv", quant4_gemv, x, w_packed, scales, block,
                   plan, B, K, M, ldw, lds)


quant_gemv.launches = 0
quant4_gemv.launches = 0
