"""Split-K decode GEMV: ``csrc/splitk_gemv.cu`` and its plain twin.

Replaces the Pallas TPU kernel ``repro/kernels/splitk_gemv.py::splitk_gemv``:
K splits into ``plan.split_k`` parts, each computing f32 partials
``[deg, B, M]``; the partials are summed in a fixed order and cast to
``x.dtype``.

What bounds it on an H100: the weight bytes over HBM bandwidth, as for
``pim_gemv``.  A narrow matrix has too few column blocks to occupy all 132
SMs; splitting K multiplies the CTA count by the degree.  Each part runs
``pim_gemv``'s streaming body; the ``deg`` CTAs of a column block form one
thread block cluster and sum their partials in shared memory, part 0
first (no atomics, nothing in HBM), in the same launch.

A CPU or meta tensor (the dry run) takes the plain version
(:func:`splitk_gemv_plain`); a CUDA tensor launches the kernel or
raises.  ``splitk_gemv.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemv_plan import GemvPlan
from repro_torch.kernels.pim_gemv import DTYPES, check_inputs


def splitk_gemv_plain(x: torch.Tensor, w_t: torch.Tensor,
                      degree: int) -> torch.Tensor:
    """The same function in plain PyTorch: per-part f32 partials summed
    part 0 first, cast to x.dtype."""
    K = w_t.shape[0]
    kp = K // degree
    partials = torch.stack([
        torch.matmul(x[:, i * kp:(i + 1) * kp].float(),
                     w_t[i * kp:(i + 1) * kp].float())
        for i in range(degree)])
    acc = partials[0]
    for p in partials[1:]:
        acc = acc + p
    return acc.to(x.dtype)


def splitk_gemv(x: torch.Tensor, w_t: torch.Tensor, *,
                plan: GemvPlan) -> torch.Tensor:
    """x [B, K], w_t [K, M] -> [B, M] through the split-K kernel."""
    _build.refuse_grad("splitk_gemv", x, w_t)
    B, K, M, ld = check_inputs(x, w_t, plan)
    deg = plan.split_k
    if deg < 2:
        raise ValueError(f"splitk_gemv takes a plan with split_k >= 2, "
                         f"got {plan}")
    if _build.runs_plain("splitk_gemv", x):
        return splitk_gemv_plain(x, w_t, deg)
    lib = _build.load("splitk_gemv")
    out = torch.empty((B, M), dtype=x.dtype, device=x.device)
    fn = getattr(lib, f"splitk_gemv_{DTYPES[x.dtype]}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), w_t.data_ptr(), out.data_ptr(), B, K, M,
                    ld, deg, plan.m_blk, plan.k_blk, plan.stages, stream),
                 "splitk_gemv")
    splitk_gemv.launches += 1
    return out


splitk_gemv.launches = 0
