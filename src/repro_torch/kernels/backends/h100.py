"""H100 ``GemvBackend``: the hand-written Hopper kernel set behind
``dispatch_gemv``.

The counterpart of ``repro/kernels/backends/tpu.py``'s kernel set:

* ``ref`` — ``torch.matmul`` on the K-major weight (the JAX ``ref`` is
  XLA's dot, outside any Pallas kernel);
* ``pim`` — ``kernels/pim_gemv.py`` (``csrc/pim_gemv.cu``);
* ``splitk`` — ``kernels/splitk_gemv.py`` (``csrc/splitk_gemv.cu``).

Selection keeps the TPU backend's gates (kernel not applicable, batch above
``batch_threshold``, weight under ``min_pallas_bytes`` -> ``ref``) and its
cost form: bytes over HBM bandwidth scaled by grid occupancy, plus the
launch and per-CTA terms, plus the split-K partial traffic.  The bandwidth
is the H100 SXM data sheet's 3.35 TB/s; the occupancy target is the SM
count, read from the device (a test passes it explicitly).  The other
constants are uncalibrated seeds.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.backends.base import (
    DEFAULT_POLICY,
    CostModel,
    DispatchPolicy,
    GemvBackend,
    register_backend,
)
from repro_torch.kernels.gemv_plan import (
    GemvPlan,
    kernel_applicable,
    plan_gemv,
    plan_splitk,
    valid_splitk_degree,
)
from repro_torch.kernels.ops import PackedWeights
from repro_torch.kernels.pim_gemv import pim_gemv
from repro_torch.kernels.splitk_gemv import splitk_gemv

H100_HBM_GBPS = 3350.0     # H100 SXM data sheet


def sm_count() -> int:
    """SMs of the current CUDA device (132 on an H100 SXM)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the h100 backend's cost model needs the SM count "
                           "of a CUDA device; pass min_parallel_blocks on a "
                           "host without one")
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return props.multi_processor_count


class H100Backend(GemvBackend):
    name = "h100"
    kernels = ("ref", "pim", "splitk")
    # a fused program runs ONE kernel over the concatenated [K, sum(Ms)]
    # weight: one launch and one read of x for the whole head group
    program_modes = ("fused",)

    def __init__(self, min_parallel_blocks: int | None = None):
        self._sms = min_parallel_blocks
        self._cm: CostModel | None = None

    @property
    def cost_model(self) -> CostModel:
        if self._cm is None:
            self._cm = CostModel(
                bandwidth_gbps=H100_HBM_GBPS,
                gemv_efficiency=0.5,    # seed: untuned matmul at N = B <= 8
                launch_us=2.0,          # seed: one eager kernel launch
                program_us=0.002,       # seed: per-CTA scheduling cost
                min_parallel_blocks=self._sms or sm_count(),
            )
        return self._cm

    # -- cost model ---------------------------------------------------------

    def estimate_cost_us(self, kernel, M, K, batch, *, x_bytes=2,
                         plan: GemvPlan | None = None) -> float:
        if kernel == "ref":
            return super().estimate_cost_us(kernel, M, K, batch,
                                            x_bytes=x_bytes)
        cm = self.cost_model
        io = self.io_bytes(M, K, batch, x_bytes=x_bytes)
        ctas = plan.split_k * plan.n_m
        occupancy = min(1.0, ctas / cm.min_parallel_blocks)
        t = io / (cm.bandwidth_bps * occupancy) * 1e6
        t += cm.launch_us + cm.program_us * ctas
        if plan.split_k > 1:
            # f32 partials written then re-read, and the reduce's launch
            t += (cm.splitk_reduce_factor * plan.split_k * batch * M * 4
                  / cm.bandwidth_bps * 1e6) + cm.launch_us
        return t

    # -- planning / selection ---------------------------------------------------

    def candidate_plans(self, M, K, batch, x_bytes=2):
        cands: list[tuple[str, GemvPlan | None]] = [("ref", None)]
        if not kernel_applicable(M, K, batch, x_bytes):
            return cands
        cands.append(("pim", plan_gemv(M, K, batch, elem_bytes=x_bytes)))
        deg = valid_splitk_degree(K)
        if deg is not None:  # highest valid degree; lower ones are dominated
            cands.append(("splitk", plan_splitk(M, K, batch, degree=deg,
                                                elem_bytes=x_bytes)))
        return cands

    def select_kernel(self, M, K, batch, *, x_bytes=2,
                      policy: DispatchPolicy = DEFAULT_POLICY):
        if policy.kernel != "auto":
            return self._pinned(M, K, batch, x_bytes, policy.kernel)
        if not kernel_applicable(M, K, batch, x_bytes):
            return "ref", None
        if (batch > policy.batch_threshold
                or M * K * x_bytes < policy.min_pallas_bytes):
            return "ref", None
        return min(self.candidate_plans(M, K, batch, x_bytes),
                   key=lambda kp: self.estimate_cost_us(
                       kp[0], M, K, batch, x_bytes=x_bytes, plan=kp[1]))

    def _pinned(self, M, K, batch, x_bytes, name):
        self._check_pin(name)
        if name == "ref" or not kernel_applicable(M, K, batch, x_bytes):
            return "ref", None
        if name == "splitk":
            deg = valid_splitk_degree(K)
            if deg is None:
                return "ref", None
            return "splitk", plan_splitk(M, K, batch, degree=deg,
                                         elem_bytes=x_bytes)
        return "pim", plan_gemv(M, K, batch, elem_bytes=x_bytes)

    # -- execution ----------------------------------------------------------

    def execute(self, kernel: str, x: torch.Tensor, pw: PackedWeights,
                plan: GemvPlan | None) -> torch.Tensor:
        if kernel == "ref":
            return torch.matmul(x, pw.w_t)
        if kernel == "pim":
            return pim_gemv(x, pw.w_t, plan=plan)
        if kernel == "splitk":
            return splitk_gemv(x, pw.w_t, plan=plan)
        raise ValueError(f"unknown kernel {kernel!r}")


BACKEND = register_backend(H100Backend(), devices=("cuda",))
