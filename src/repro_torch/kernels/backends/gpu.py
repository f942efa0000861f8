"""GPU ``GemvBackend``: the library product plus a hand-written column-block
GEMV, the counterpart of ``repro/kernels/backends/gpu.py``.

The kernel set is deliberately small -- decode GEMV on a GPU is served well
by the library product (``ref``) except where a custom placement wins:

* ``ref`` -- ``torch.matmul`` on the K-major weight (the JAX ``ref`` is
  XLA's dot); quantized weights take the block-scale dequant oracle, as
  the JAX backend takes its XLA dequant contraction;
* ``triton`` -- :func:`repro_torch.kernels.triton_gemv.triton_gemv`
  (``csrc/triton_gemv.cu``, CUDA on the tensor cores; the name is the JAX
  kernel's, a key of this backend's autotune namespace), one CTA per
  column block with an in-kernel K walk.  The cost model's occupancy term
  makes it the pick only when the shape yields enough column blocks to
  cover the SMs (the paper's grid-fill rule, ``min_parallel_blocks`` = the
  SM count): LM heads; mid-size GEMVs stay on ``ref``;

and for MoE expert programs the native modes ``grouped_triton`` /
``ragged_triton`` (the JAX mode names), which run the CUDA
``grouped_gemv`` / ``ragged_gemv`` kernels under the JAX backend's gates
(16-bit weights, ``use_pallas``, the per-expert batch within
``batch_threshold``, power-of-two tiles from ``plan_grouped_gemv``) plus
the CUDA kernels' own: whole 16-byte column vectors and a bf16 or f32
type.  The tiles the kernels run are ``plan_expert_gemv``'s.

Unlike the JAX backend there is no capability gate (``_can_lower_triton``
there): on a CUDA tensor the kernel runs or raises, and on a CPU tensor the
wrapper runs its plain version.  The picks therefore equal the JAX
backend's under ``DispatchPolicy(interpret=True)``.

Constants: the bandwidth is the H100 SXM data sheet's 3.35 TB/s, the
occupancy target the SM count read from the device (a test passes both);
``gemv_efficiency``, ``launch_us`` and ``program_us`` are the JAX
backend's seeds, not calibrated on this card.  The backend claims no
device: ``cuda`` resolves to ``h100``, and this one is chosen by name
(``DispatchPolicy(backend="gpu")``, ``Engine(gemv_backend="gpu")``).
A caller's ``plan=`` is re-planned by this backend's selection (the base
``coerce_plan``): another backend's tiles do not transfer.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.backends.base import (
    DEFAULT_POLICY,
    CostModel,
    DispatchPolicy,
    GemvBackend,
    GemvKey,
    GemvProgram,
    ProgramKey,
    ProgramPlan,
    dtype_bytes,
    register_backend,
)
from repro_torch.kernels.backends.h100 import H100_HBM_GBPS, sm_count
from repro_torch.kernels.gemv_plan import GemvPlan, kernel_applicable
from repro_torch.kernels.grouped_gemv import (
    counts_to_offsets,
    grouped_gemv,
    plan_expert_gemv,
    plan_grouped_gemv,
    ragged_gemv,
)
from repro_torch.kernels.ops import PackedWeights
from repro_torch.kernels.pim_gemv import DTYPES
from repro_torch.kernels.triton_gemv import triton_gemv


def _pow2_divisor(n: int, cap: int, floor: int) -> int | None:
    """Largest power-of-two divisor of ``n`` in [floor, cap], else None."""
    d = 1
    while d * 2 <= cap and n % (d * 2) == 0:
        d *= 2
    return d if d >= floor and n % d == 0 else None


def plan_triton_gemv(M: int, K: int, batch: int) -> GemvPlan | None:
    """The JAX package's plan builder: power-of-two column blocks of 64 to
    512 and K chunks of 16 to 1024; a shape with neither divisor is left to
    ``ref``."""
    m_blk = _pow2_divisor(M, cap=512, floor=64)
    k_blk = _pow2_divisor(K, cap=1024, floor=16)
    if m_blk is None or k_blk is None:
        return None
    return GemvPlan(m_blk=m_blk, k_blk=k_blk, n_m=M // m_blk,
                    n_k=K // k_blk, smem_bytes=0, split_k=1)


class GpuBackend(GemvBackend):
    name = "gpu"
    kernels = ("ref", "triton")
    program_modes = ("fused", "grouped", "ragged")

    def __init__(self, min_parallel_blocks: int | None = None,
                 bandwidth_gbps: float = H100_HBM_GBPS):
        self._sms = min_parallel_blocks
        self._bandwidth = bandwidth_gbps
        self._cm: CostModel | None = None

    @property
    def cost_model(self) -> CostModel:
        if self._cm is None:
            self._cm = CostModel(
                bandwidth_gbps=self._bandwidth,
                gemv_efficiency=0.7,    # JAX seed, uncalibrated here
                launch_us=3.0,          # JAX seed, uncalibrated here
                program_us=0.02,        # JAX seed, uncalibrated here
                min_parallel_blocks=self._sms or sm_count(),
            )
        return self._cm

    # -- cost model ---------------------------------------------------------

    def estimate_cost_us(self, kernel, M, K, batch, *, bits=16, x_bytes=2,
                         plan: GemvPlan | None = None) -> float:
        if kernel != "triton" or plan is None:
            return super().estimate_cost_us(kernel, M, K, batch, bits=bits,
                                            x_bytes=x_bytes)
        cm = self.cost_model
        io = self.io_bytes(M, K, batch, bits=bits, x_bytes=x_bytes)
        occupancy = min(1.0, plan.n_m / cm.min_parallel_blocks)
        t = io / (cm.bandwidth_bps * occupancy) * 1e6
        return t + cm.launch_us + cm.program_us * plan.n_m

    # -- planning / selection ---------------------------------------------

    def candidate_plans(self, M, K, batch, bits):
        cands: list[tuple[str, GemvPlan | None]] = [("ref", None)]
        if bits < 16:
            return cands       # quantized weights: the dequant oracle only
        plan = plan_triton_gemv(M, K, batch)
        if plan is not None:
            cands.append(("triton", plan))
        return cands

    def select_kernel(self, M, K, batch, *, bits=16, block=32, x_bytes=2,
                      policy: DispatchPolicy = DEFAULT_POLICY):
        if policy.kernel != "auto":
            return self._pinned(M, K, batch, bits, policy.kernel)
        if (bits < 16 or not policy.use_pallas
                or batch > policy.batch_threshold
                or M * K * bits / 8 < policy.min_pallas_bytes):
            return "ref", None
        return min(self.candidate_plans(M, K, batch, bits),
                   key=lambda kp: self.estimate_cost_us(
                       kp[0], M, K, batch, bits=bits, x_bytes=x_bytes,
                       plan=kp[1]))

    def _pinned(self, M, K, batch, bits, name):
        self._check_pin(name, bits)
        if name == "triton" and bits == 16:
            plan = plan_triton_gemv(M, K, batch)
            if plan is not None:
                return "triton", plan
        return "ref", None

    def autotune_candidates(self, key: GemvKey, pw: PackedWeights,
                            policy: DispatchPolicy):
        return self.candidate_plans(key.M, key.K, key.batch, key.bits)

    # -- MoE expert programs ------------------------------------------------

    def plan_program(self, key: ProgramKey, *,
                     policy: DispatchPolicy = DEFAULT_POLICY) -> ProgramPlan:
        """Grouped/ragged programs take the native kernels where the JAX
        backend's gates and the CUDA kernels' own let them; the plan is the
        JAX tile plan, as that backend records it."""
        if key.kind in ("grouped", "ragged") and policy.fuse_programs:
            M, K = key.Ms[0], key.K
            cand = plan_grouped_gemv(M, K)
            if (key.bits == 16 and policy.use_pallas
                    and key.batch <= policy.batch_threshold
                    and cand.m_blk & (cand.m_blk - 1) == 0
                    and cand.k_blk & (cand.k_blk - 1) == 0
                    and key.dtype in {str(d) for d in DTYPES}
                    and kernel_applicable(M, K, 1, dtype_bytes(key.dtype))):
                return ProgramPlan(mode=f"{key.kind}_triton", n_launches=1,
                                   kernel="triton", plan=cand)
        return super().plan_program(key, policy=policy)

    def execute_program(self, program: GemvProgram,
                        pplan: ProgramPlan) -> torch.Tensor:
        if pplan.mode in ("grouped_triton", "ragged_triton"):
            # the CUDA expert kernels tile with their own plan, whatever
            # tile the program plan (or a table entry) names
            K, M = program.weights.shape
            plan = plan_expert_gemv(M, K,
                                    elem_bytes=program.x.element_size())
            if pplan.mode == "grouped_triton":
                return grouped_gemv(program.x, program.weights.w_t,
                                    plan=plan)
            return ragged_gemv(program.x, counts_to_offsets(program.counts),
                               program.weights.w_t, plan=plan)
        return super().execute_program(program, pplan)

    # -- execution ----------------------------------------------------------

    def execute(self, kernel: str, x: torch.Tensor, pw: PackedWeights,
                plan: GemvPlan | None) -> torch.Tensor:
        if kernel == "triton":
            return triton_gemv(x, pw.w_t, plan=plan)
        if kernel == "ref":
            if pw.bits < 16:
                return self._execute_ref(x, pw)
            return torch.matmul(x, pw.w_t)
        raise ValueError(f"unknown kernel {kernel!r}")


BACKEND = register_backend(GpuBackend())
