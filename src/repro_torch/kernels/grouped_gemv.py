"""Expert-stack decode GEMVs: ``csrc/grouped_gemv.cu`` and their plain twins.

Replace the Pallas TPU kernels of ``repro/kernels/grouped_gemv.py``:

* :func:`grouped_gemv` (``grouped_gemv``): ``[E, C, K] @ [E, K, M] ->
  [E, C, M]``, a uniform C rows per expert;
* :func:`ragged_gemv` (``ragged_gemv``): one flat ``[T, K]`` buffer sorted
  by expert, expert ``e``'s rows at ``offsets[e]:offsets[e + 1]``, times
  ``[E, K, M]`` -> ``[T, M]``; rows at or beyond ``offsets[E]`` come back
  zero.  The offsets are device data (int32 ``[E + 1]``): nothing here
  reads them on the host, so a decode step costs no host sync.

Both accumulate in f32 and round once to ``x.dtype``.

What bounds them on an H100: at decode an expert gets a handful of rows,
so the floor is the weight bytes of the experts that HAVE rows over HBM
bandwidth (3.35 TB/s).  ``grouped_gemv`` runs the dense kernels' streaming
body (``csrc/gemv_stream.cuh``: a TMA ring of weight sub-tiles,
``mma.sync`` in bf16) with the expert as the third dimension of its
tensor maps, one CTA per (column block, expert), each expert's weights
streamed once a launch.  ``ragged_gemv`` runs the same body over a grid
of ``min(E, T)`` expert slots: each CTA finds its expert (the slot-th
with rows) from the offsets on the device, a slot with none exits before
it reads a weight, and when few experts have rows an expert's K walk
splits over a cluster whose partials meet in shared memory.

:func:`plan_grouped_gemv` is the JAX package's tile rule (power-of-two
blocks); the backends gate the native modes on it, as the JAX ``gpu``
backend does.  The CUDA kernels tile with their own plans:
``gemv_plan.plan_grouped_stream`` for ``grouped_gemv``,
``gemv_plan.plan_ragged_stream`` (column block and split degree from T,
E and the SM count) for ``ragged_gemv``.

A CPU or meta tensor (the dry run) takes the plain version; a CUDA
tensor launches the kernel or raises.  ``grouped_gemv.launches`` /
``ragged_gemv.launches`` count kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemv_plan import (
    GemvPlan,
    grouped_plan_fits,
    kernel_applicable,
    ragged_plan_fits,
)
from repro_torch.kernels.pim_gemv import DTYPES

MIN_DOT_DIM = 16     # the JAX kernels' smallest dot extent (triton_gemv)


def _pow2_divisor(n: int, cap: int, floor: int) -> int:
    """Largest power-of-two divisor of ``n`` in [floor, cap]; ``n`` itself
    when none divides it (the JAX package's rule)."""
    best = 0
    p = floor
    while p <= min(n, cap):
        if n % p == 0:
            best = p
        p *= 2
    return best if best else n


def plan_grouped_gemv(M: int, K: int) -> GemvPlan:
    """The JAX package's tile plan for the grouped/ragged kernels
    (``repro/kernels/grouped_gemv.py::plan_grouped_gemv``, depth 1)."""
    m_blk = _pow2_divisor(M, cap=512, floor=MIN_DOT_DIM)
    k_blk = _pow2_divisor(K, cap=1024, floor=MIN_DOT_DIM)
    return GemvPlan(m_blk=m_blk, k_blk=k_blk, n_m=M // m_blk,
                    n_k=K // k_blk, smem_bytes=0)


def counts_to_offsets(counts: torch.Tensor) -> torch.Tensor:
    """Per-expert row counts ``[E]`` -> int32 row offsets ``[E + 1]`` on the
    same device (``offsets[E] == T`` when the counts sum to the rows)."""
    return torch.nn.functional.pad(
        torch.cumsum(counts, 0, dtype=torch.int32), (1, 0))


def _strides(w_t: torch.Tensor) -> tuple[int, int]:
    """(row stride, expert stride) of an ``[E, K, M]`` stack, in elements.
    Columns must be contiguous and every row of every expert must start on
    a 16-byte boundary; nothing is copied (a copy would move the whole
    stack on every call)."""
    E, K, M = w_t.shape
    ld = w_t.stride(1) if K > 1 else M
    es = w_t.stride(0) if E > 1 else K * ld
    if (M > 1 and w_t.stride(2) != 1) or ld < M or es < K * ld:
        raise ValueError(f"w_t {tuple(w_t.shape)} with strides "
                         f"{w_t.stride()} is not a stack of row-major "
                         f"matrices with contiguous columns")
    size = w_t.element_size()
    if w_t.data_ptr() % 16 or ld * size % 16 or es * size % 16:
        raise ValueError("w_t rows must start on 16-byte boundaries (the "
                         "kernels read them as 16-byte vectors)")
    return ld, es


def _check_stack(x: torch.Tensor, w_t: torch.Tensor,
                 K: int) -> tuple[int, int, int, int]:
    """Type, device and shape checks shared by both kernels; returns (E,
    M, ld, es)."""
    if w_t.ndim != 3:
        raise ValueError(f"expected stacked w_t [E, K, M], got "
                         f"{tuple(w_t.shape)}")
    E, K2, M = w_t.shape
    if K != K2:
        raise ValueError(f"x has K={K} but w_t {tuple(w_t.shape)}")
    if x.dtype not in DTYPES or w_t.dtype != x.dtype:
        raise TypeError(f"x and w_t must share bf16 or f32, got {x.dtype} "
                        f"and {w_t.dtype}")
    if x.device != w_t.device:
        raise ValueError(f"x on {x.device} but w_t on {w_t.device}")
    ld, es = _strides(w_t)
    return E, M, ld, es


# --------------------------------------------------------------------------
# grouped: [E, C, K] @ [E, K, M]
# --------------------------------------------------------------------------


def grouped_gemv_plain(xs: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: f32 batched product, cast to
    xs.dtype."""
    return torch.matmul(xs.float(), w_t.float()).to(xs.dtype)


def _x_strides(xs: torch.Tensor) -> tuple[int, int]:
    """(expert stride, row stride) of ``xs [E, C, K]``, in elements: an
    expert or row view runs in place, as long as its rows are contiguous
    and start on 16-byte boundaries (the copy engine's rule)."""
    E, C, K = xs.shape
    x_rs = xs.stride(1) if C > 1 else K
    x_es = xs.stride(0) if E > 1 else C * x_rs
    size = xs.element_size()
    if (K > 1 and xs.stride(2) != 1) or x_rs < K or x_es < 1:
        raise ValueError(f"xs {tuple(xs.shape)} with strides {xs.stride()} "
                         f"does not have contiguous rows")
    if xs.data_ptr() % 16 or x_rs * size % 16 or x_es * size % 16:
        raise ValueError("xs rows and experts must start on 16-byte "
                         "boundaries")
    return x_es, x_rs


def grouped_gemv(xs: torch.Tensor, w_t: torch.Tensor, *,
                 plan: GemvPlan) -> torch.Tensor:
    """xs [E, C, K], w_t [E, K, M] -> [E, C, M], ``plan`` from
    ``gemv_plan.plan_grouped_stream``: one launch for up to 64 rows an
    expert in bf16 (8 in f32), a launch per row chunk beyond."""
    _build.refuse_grad("grouped_gemv", xs, w_t)
    if xs.ndim != 3:
        raise ValueError(f"expected xs [E, C, K], got {tuple(xs.shape)}")
    E, M, ld, es = _check_stack(xs, w_t, xs.shape[2])
    if xs.shape[0] != E:
        raise ValueError(f"xs has {xs.shape[0]} experts, w_t {E}")
    C, K = xs.shape[1], xs.shape[2]
    x_es, x_rs = _x_strides(xs)
    if not kernel_applicable(M, K, 1, xs.element_size()):
        raise ValueError(f"M={M}, K={K}: the kernel takes whole 16-byte "
                         f"column vectors and a K walk of whole 8-row "
                         f"groups")
    if C and not grouped_plan_fits(plan, M, K, C, xs.element_size()):
        raise ValueError(f"plan {plan} does not tile M={M}, K={K} at C={C} "
                         f"within the card's shared memory")
    if _build.runs_plain("grouped_gemv", xs):
        return grouped_gemv_plain(xs, w_t)
    out = torch.empty((E, C, M), dtype=xs.dtype, device=xs.device)
    if C == 0:
        return out
    lib = _build.load("grouped_gemv")
    fn = getattr(lib, f"grouped_gemv_{DTYPES[xs.dtype]}")
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    _build.check(fn(xs.data_ptr(), w_t.data_ptr(), out.data_ptr(), E, C, K,
                    M, ld, es, x_es, x_rs, plan.m_blk, plan.k_blk,
                    plan.stages, stream), "grouped_gemv")
    grouped_gemv.launches += 1
    return out


grouped_gemv.launches = 0


# --------------------------------------------------------------------------
# ragged: expert-sorted [T, K] by offsets [E + 1]
# --------------------------------------------------------------------------


def ragged_gemv_plain(x: torch.Tensor, offsets: torch.Tensor,
                      w_t: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: each expert's row range times its
    matrix in f32, cast to x.dtype; rows from ``offsets[E]`` on are zero.
    Reads the offsets on the host: a test and comparison twin, never on
    the decode path.  On the meta device, where no offset can be read,
    every row is one product with a ``[K, M]`` matrix (the experts'
    sum): the shape, the products' operations, and each expert's weight
    read once."""
    T, M = x.shape[0], w_t.shape[2]
    if x.device.type == "meta":
        return torch.matmul(x.float(), w_t.float().sum(0)).to(x.dtype)
    out = torch.zeros((T, M), dtype=torch.float32, device=x.device)
    offs = [min(max(int(o), 0), T) for o in offsets.tolist()]
    for e in range(w_t.shape[0]):
        lo, hi = offs[e], max(offs[e + 1], offs[e])
        if hi > lo:
            out[lo:hi] = torch.matmul(x[lo:hi].float(), w_t[e].float())
    return out.to(x.dtype)


def ragged_gemv(x: torch.Tensor, offsets: torch.Tensor, w_t: torch.Tensor,
                *, plan: GemvPlan) -> torch.Tensor:
    """x [T, K] sorted by expert, int32 offsets [E + 1], w_t [E, K, M] ->
    [T, M] in one launch, ``plan`` from ``gemv_plan.plan_ragged_stream``;
    rows no expert's range holds (those at or beyond ``offsets[E]``) are
    zero."""
    _build.refuse_grad("ragged_gemv", x, w_t)
    if x.ndim != 2:
        raise ValueError(f"expected x [T, K], got {tuple(x.shape)}")
    E, M, ld, es = _check_stack(x, w_t, x.shape[1])
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    if not kernel_applicable(M, x.shape[1], 1, x.element_size()):
        raise ValueError(f"M={M}, K={x.shape[1]}: the kernel takes whole "
                         f"16-byte column vectors and a K walk of whole "
                         f"8-row groups")
    if x.shape[0] and not ragged_plan_fits(plan, M, x.shape[1], x.shape[0],
                                           x.element_size()):
        raise ValueError(f"plan {plan} does not tile M={M}, K={x.shape[1]} "
                         f"at T={x.shape[0]} within the card's shared "
                         f"memory")
    if offsets.shape != (E + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"offsets must be int32 [{E + 1}], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if offsets.device != x.device or not offsets.is_contiguous():
        raise ValueError(f"offsets must be contiguous on {x.device}")
    T, K = x.shape
    if _build.runs_plain("ragged_gemv", x):
        return ragged_gemv_plain(x, offsets, w_t)
    out = torch.empty((T, M), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    lib = _build.load("grouped_gemv")
    fn = getattr(lib, f"ragged_gemv_{DTYPES[x.dtype]}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), offsets.data_ptr(), w_t.data_ptr(),
                    out.data_ptr(), T, K, M, ld, es, E, plan.split_k,
                    plan.m_blk, plan.k_blk, plan.stages, stream),
                 "ragged_gemv")
    ragged_gemv.launches += 1
    return out


ragged_gemv.launches = 0
