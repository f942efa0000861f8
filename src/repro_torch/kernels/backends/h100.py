"""H100 ``GemvBackend``: the hand-written Hopper kernel set behind
``dispatch_gemv``.

The counterpart of ``repro/kernels/backends/tpu.py``'s kernel set:

* ``ref`` — ``torch.matmul`` on the K-major weight (the JAX ``ref`` is
  XLA's dot, outside any Pallas kernel);
* ``pim`` — ``kernels/pim_gemv.py`` (``csrc/pim_gemv.cu``);
* ``splitk`` — ``kernels/splitk_gemv.py`` (``csrc/splitk_gemv.cu``);
* ``quant`` / ``quant4`` — ``kernels/quant_gemv.py``
  (``csrc/quant_gemv.cu``) for int8 / packed-int4 weights;

and for MoE expert programs the native modes ``grouped_cuda`` /
``ragged_cuda`` (``kernels/grouped_gemv.py``, ``csrc/grouped_gemv.cu``),
the counterparts of the JAX ``gpu`` backend's ``grouped_triton`` /
``ragged_triton``, under that backend's gates: 16-bit weights,
``use_pallas``, the per-expert batch within ``batch_threshold``, and
power-of-two tiles from ``plan_grouped_gemv``; besides, the kernels' own
16-byte column vectors and a bf16 or f32 type.  A shape that fails a gate
takes the portable executor (``grouped`` / ``ragged``), as in the JAX
package.  There is no capability gate: the card always runs the kernels.

As on the TPU backend, a quantized weight takes ``quant``/``quant4``
whenever the kernel applies, whatever the batch threshold and
``min_pallas_bytes`` say (``ref`` would stream the weight dequantized);
the quantized paths are output-stationary only, and any kernel pin but
``ref`` on quantized weights resolves to them.  The kernel holds 8 x rows
and a larger batch runs in row chunks, so the pick does not depend on B.

For float weights selection keeps the TPU backend's gates (kernel not
applicable, batch above ``batch_threshold``, weight under
``min_pallas_bytes`` -> ``ref``) and its
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
    GemvProgram,
    ProgramKey,
    ProgramPlan,
    dtype_bytes,
    register_backend,
)
from repro_torch.kernels.gemv_plan import (
    GemvPlan,
    kernel_applicable,
    plan_gemv,
    plan_quant,
    plan_splitk,
    quant_applicable,
    valid_splitk_degree,
)
from repro_torch.kernels.grouped_gemv import (
    counts_to_offsets,
    grouped_gemv,
    plan_expert_gemv,
    plan_grouped_gemv,
    ragged_gemv,
)
from repro_torch.kernels.ops import PackedWeights
from repro_torch.kernels.pim_gemv import DTYPES, pim_gemv
from repro_torch.kernels.quant_gemv import quant4_gemv, quant_gemv
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
    kernels = ("ref", "pim", "splitk", "quant", "quant4")
    # a fused program runs ONE kernel over the concatenated [K, sum(Ms)]
    # weight: one launch and one read of x for the whole head group;
    # grouped / ragged are the portable expert executors a shape falls back
    # to when it fails the native modes' gates
    program_modes = ("fused", "grouped", "ragged")

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

    def estimate_cost_us(self, kernel, M, K, batch, *, bits=16, x_bytes=2,
                         plan: GemvPlan | None = None) -> float:
        if kernel == "ref":
            return super().estimate_cost_us(kernel, M, K, batch, bits=bits,
                                            x_bytes=x_bytes)
        cm = self.cost_model
        io = self.io_bytes(M, K, batch, bits=bits, x_bytes=x_bytes)
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

    def quant_plan(self, M, K, batch, bits, block) -> GemvPlan:
        """The quant kernels' plan, its column block narrowed to fill the
        card's SMs (the quant path has no split-K).  Off the card the plan
        only feeds the plain versions' checks, so the target is 1 there
        unless the backend was given one."""
        target = self._sms or (sm_count() if torch.cuda.is_available()
                               else 1)
        return plan_quant(M, K, batch, bits=bits, block=block,
                          min_blocks=target)

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

    def select_kernel(self, M, K, batch, *, bits=16, block=32, x_bytes=2,
                      policy: DispatchPolicy = DEFAULT_POLICY):
        if policy.kernel != "auto":
            return self._pinned(M, K, batch, bits, block, x_bytes,
                                policy.kernel)
        if not policy.use_pallas:
            return "ref", None
        if bits < 16:
            return self._quant_pick(M, K, batch, bits, block)
        if not kernel_applicable(M, K, batch, x_bytes):
            return "ref", None
        if (batch > policy.batch_threshold
                or M * K * x_bytes < policy.min_pallas_bytes):
            return "ref", None
        return min(self.candidate_plans(M, K, batch, x_bytes),
                   key=lambda kp: self.estimate_cost_us(
                       kp[0], M, K, batch, x_bytes=x_bytes, plan=kp[1]))

    def _quant_pick(self, M, K, batch, bits, block):
        if not quant_applicable(M, K, bits=bits, block=block):
            return "ref", None
        return ("quant" if bits == 8 else "quant4",
                self.quant_plan(M, K, batch, bits, block))

    def _pinned(self, M, K, batch, bits, block, x_bytes, name):
        """A pin cannot override the weight's storage: quantized weights
        need a dequantizing kernel, and ``quant`` on float weights has no
        scales (``_check_pin`` refuses it)."""
        self._check_pin(name, bits)
        if name == "ref":
            return "ref", None
        if bits < 16:
            return self._quant_pick(M, K, batch, bits, block)
        if not kernel_applicable(M, K, batch, x_bytes):
            return "ref", None
        if name == "splitk":
            deg = valid_splitk_degree(K)
            if deg is None:
                return "ref", None
            return "splitk", plan_splitk(M, K, batch, degree=deg,
                                         elem_bytes=x_bytes)
        return "pim", plan_gemv(M, K, batch, elem_bytes=x_bytes)

    # -- MoE expert programs ------------------------------------------------

    def plan_program(self, key: ProgramKey, *,
                     policy: DispatchPolicy = DEFAULT_POLICY) -> ProgramPlan:
        """Grouped/ragged programs take the native kernels where the JAX
        ``gpu`` backend's gates let its Pallas kernels run."""
        if key.kind in ("grouped", "ragged") and policy.fuse_programs:
            M, K = key.Ms[0], key.K
            x_bytes = dtype_bytes(key.dtype)
            cand = plan_grouped_gemv(M, K)
            if (key.bits == 16 and policy.use_pallas
                    and key.batch <= policy.batch_threshold
                    and cand.m_blk & (cand.m_blk - 1) == 0
                    and cand.k_blk & (cand.k_blk - 1) == 0
                    and key.dtype in {str(d) for d in DTYPES}
                    and kernel_applicable(M, K, 1, x_bytes)):
                return ProgramPlan(
                    mode=f"{key.kind}_cuda", n_launches=1,
                    kernel=f"{key.kind}_gemv",
                    plan=plan_expert_gemv(M, K, elem_bytes=x_bytes))
        return super().plan_program(key, policy=policy)

    def execute_program(self, program: GemvProgram,
                        pplan: ProgramPlan) -> torch.Tensor:
        if pplan.mode == "grouped_cuda":
            return grouped_gemv(program.x, program.weights.w_t,
                                plan=pplan.plan)
        if pplan.mode == "ragged_cuda":
            return ragged_gemv(program.x, counts_to_offsets(program.counts),
                               program.weights.w_t, plan=pplan.plan)
        return super().execute_program(program, pplan)

    # -- execution ----------------------------------------------------------

    def execute(self, kernel: str, x: torch.Tensor, pw: PackedWeights,
                plan: GemvPlan | None) -> torch.Tensor:
        if kernel == "ref":
            if pw.bits < 16:
                return self._execute_ref(x, pw)
            return torch.matmul(x, pw.w_t)
        if kernel == "quant":
            return quant_gemv(x, pw.w_t, pw.scales, block=pw.block,
                              plan=plan)
        if kernel == "quant4":
            return quant4_gemv(x, pw.w_t, pw.scales, block=pw.block,
                               plan=plan)
        if kernel == "pim":
            return pim_gemv(x, pw.w_t, plan=plan)
        if kernel == "splitk":
            return splitk_gemv(x, pw.w_t, plan=plan)
        raise ValueError(f"unknown kernel {kernel!r}")


BACKEND = register_backend(H100Backend(), devices=("cuda",))
