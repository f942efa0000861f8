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
``min_pallas_bytes`` say (``ref`` would stream the weight dequantized),
and any kernel pin but ``ref`` on quantized weights resolves to them.
Their plan (``plan_quant``) may split K over a cluster to fill the SMs;
the kernel holds 64 rows of bf16 x a launch and runs more in row chunks,
so the pick does not depend on B.

For float weights selection keeps the TPU backend's gates (kernel not
applicable, batch above ``batch_threshold``, weight under
``min_pallas_bytes`` -> ``ref``) and its
cost form: bytes over HBM bandwidth scaled by grid occupancy, plus the
launch and per-CTA terms.  Unlike the TPU's split-K, this one reduces its
partials inside the launch (a thread block cluster), so it pays no
partial traffic and no second launch.  The bandwidth is the H100 SXM data
sheet's 3.35 TB/s; the occupancy target is the SM count, read from the
device (a test passes it explicitly), which also sizes the plans.  The
other constants are seeds; ``repro_torch.calibration`` fits them from a
measured sweep on the card (``benchmarks/kernel_bench_torch.py
--calibrate --backend h100``), and the seeds stay the default.

Selection keeps the planner's default ring depth; the autotuner also
times every other depth the card's shared memory holds
(``PIPELINE_DEPTHS``, as the TPU backend's staged candidates), each under
its own label in the table's ``candidates_us``.
"""

from __future__ import annotations

from dataclasses import replace

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
from repro_torch.kernels.gemv_plan import (
    K_ALIGN,
    MAX_STAGES,
    SPLITK_DEGREES,
    GemvPlan,
    device_sms,
    grouped_plan_fits,
    kernel_applicable,
    plan_fits,
    plan_gemv,
    plan_grouped_stream,
    plan_quant,
    plan_ragged_stream,
    plan_splitk,
    quant_applicable,
    quant_plan_fits,
    ragged_plan_fits,
    valid_splitk_degree,
    with_pipeline_depth,
)
from repro_torch.kernels.grouped_gemv import (
    counts_to_offsets,
    grouped_gemv,
    plan_grouped_gemv,
    ragged_gemv,
)
from repro_torch.kernels.ops import PackedWeights
from repro_torch.kernels.pim_gemv import DTYPES, pim_gemv
from repro_torch.kernels.quant_gemv import quant4_gemv, quant_gemv
from repro_torch.kernels.splitk_gemv import splitk_gemv

H100_HBM_GBPS = 3350.0     # H100 SXM data sheet
# ring depths the autotuner tries beside the planner's default (those
# with_pipeline_depth admits at the shape: the card's shared memory and
# the K part's sub-tile count bound them)
PIPELINE_DEPTHS = tuple(range(1, MAX_STAGES + 1))


def sm_count() -> int:
    """SMs of the current CUDA device (132 on an H100 SXM)."""
    sms = device_sms()
    if sms is None:
        raise RuntimeError("the h100 backend's cost model needs the SM count "
                           "of a CUDA device; pass min_parallel_blocks on a "
                           "host without one")
    return sms


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
    def seed_cost_model(self) -> CostModel:
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
        # one launch: split-K sums its partials in the clusters' shared
        # memory, so no partial traffic and no reduce launch; the
        # per-output-element term as on the other backends
        return (t + cm.launch_us + cm.program_us * ctas
                + batch * M * cm.elem_ns * 1e-3)

    # -- planning / selection ---------------------------------------------------

    def _plan_sms(self) -> int | None:
        """The SM count the plans fill: the one the backend was
        given, else the device's (None without a card: the plan then
        only feeds the plain versions' checks)."""
        return self._sms or device_sms()

    def _pim_plan(self, M, K, batch, x_bytes) -> GemvPlan:
        return plan_gemv(M, K, batch, elem_bytes=x_bytes,
                         sms=self._plan_sms())

    def _splitk_plan(self, M, K, batch, x_bytes, degree) -> GemvPlan:
        return plan_splitk(M, K, batch, degree=degree, elem_bytes=x_bytes,
                           sms=self._plan_sms())

    def quant_plan(self, M, K, batch, bits, block,
                   x_bytes: int = 2) -> GemvPlan:
        """The quant kernels' plan (``plan_quant``): the split degree and
        column block that fill this backend's SMs.  Off the card, and with
        no SM count given, the plan only feeds the plain versions'
        checks."""
        return plan_quant(M, K, batch, bits=bits, block=block,
                          elem_bytes=x_bytes, sms=self._plan_sms())

    def candidate_plans(self, M, K, batch, x_bytes=2):
        cands: list[tuple[str, GemvPlan | None]] = [("ref", None)]
        if not kernel_applicable(M, K, batch, x_bytes):
            return cands
        cands.append(("pim", self._pim_plan(M, K, batch, x_bytes)))
        deg = valid_splitk_degree(K)
        if deg is not None:  # highest valid degree; lower ones are dominated
            cands.append(("splitk", self._splitk_plan(M, K, batch, x_bytes,
                                                     deg)))
        return cands

    def select_kernel(self, M, K, batch, *, bits=16, block=32, x_bytes=2,
                      policy: DispatchPolicy = DEFAULT_POLICY):
        if policy.kernel != "auto":
            return self._pinned(M, K, batch, bits, block, x_bytes,
                                policy.kernel)
        if not policy.use_pallas:
            return "ref", None
        if bits < 16:
            return self._quant_pick(M, K, batch, bits, block, x_bytes)
        if not kernel_applicable(M, K, batch, x_bytes):
            return "ref", None
        if (batch > policy.batch_threshold
                or M * K * x_bytes < policy.min_pallas_bytes):
            return "ref", None
        return min(self.candidate_plans(M, K, batch, x_bytes),
                   key=lambda kp: self.estimate_cost_us(
                       kp[0], M, K, batch, x_bytes=x_bytes, plan=kp[1]))

    def _quant_pick(self, M, K, batch, bits, block, x_bytes=2):
        if not quant_applicable(M, K, bits=bits, block=block):
            return "ref", None
        return ("quant" if bits == 8 else "quant4",
                self.quant_plan(M, K, batch, bits, block, x_bytes))

    def _pinned(self, M, K, batch, bits, block, x_bytes, name):
        """A pin cannot override the weight's storage: quantized weights
        need a dequantizing kernel, and ``quant`` on float weights has no
        scales (``_check_pin`` refuses it)."""
        self._check_pin(name, bits)
        if name == "ref":
            return "ref", None
        if bits < 16:
            return self._quant_pick(M, K, batch, bits, block, x_bytes)
        if not kernel_applicable(M, K, batch, x_bytes):
            return "ref", None
        if name == "splitk":
            deg = valid_splitk_degree(K)
            if deg is None:
                return "ref", None
            return "splitk", self._splitk_plan(M, K, batch, x_bytes, deg)
        return "pim", self._pim_plan(M, K, batch, x_bytes)

    def coerce_plan(self, plan: GemvPlan, M: int, K: int, batch: int,
                    pw: PackedWeights, policy: DispatchPolicy):
        """A caller's plan names the kernel, as on the TPU backend: split-K
        above 1 is ``splitk``, else ``pim``; quantized weights take
        ``quant``/``quant4`` with this backend's plan.  Tiles these kernels
        cannot run (another backend's) are re-planned at the same split
        degree (the highest valid one if that degree does not split K into
        whole 8-row parts, or is not a cluster size); a shape no kernel
        takes is ``ref``."""
        if not policy.use_pallas:
            return "ref", None
        if pw.bits < 16:
            return self._quant_pick(M, K, batch, pw.bits, pw.block)
        return self._coerce_float(plan, M, K, batch, pw.w_t.element_size())


    def _coerce_float(self, plan: GemvPlan, M: int, K: int, batch: int,
                      x_bytes: int):
        """``coerce_plan`` for float weights: a plan the kernels take as it
        stands (its split degree names the kernel), else this backend's
        plan at the same split degree."""
        if not kernel_applicable(M, K, batch, x_bytes):
            return "ref", None
        if plan_fits(plan, M, K, batch, x_bytes):
            return ("splitk" if plan.split_k > 1 else "pim"), plan
        if plan.split_k == 1:
            return "pim", self._pim_plan(M, K, batch, x_bytes)
        deg = plan.split_k
        if deg not in SPLITK_DEGREES or K % deg or (K // deg) % K_ALIGN:
            deg = valid_splitk_degree(K)
            if deg is None:
                return "ref", None
        return "splitk", self._splitk_plan(M, K, batch, x_bytes, deg)

    def replay_plan(self, kernel, plan, key: GemvKey,
                    policy: DispatchPolicy):
        """An entry whose plan its kernel no longer takes is re-planned at
        that kernel: a ``pim`` / ``splitk`` plan written before the
        streaming kernels (m_blk 128, a 1024-row K chunk, one stage) at its
        split degree, as ``coerce_plan`` does; a ``quant`` / ``quant4`` plan
        written before the quant kernels streamed (a K chunk of many scale
        blocks, no ring) by ``plan_quant``.  ``ref`` replays as it
        stands."""
        if plan is None:
            return kernel, plan
        x_bytes = dtype_bytes(key.dtype)
        if kernel in ("quant", "quant4"):
            if quant_plan_fits(plan, key.M, key.K, key.batch, bits=key.bits,
                               block=key.block, elem_bytes=x_bytes):
                return kernel, plan
            return self._quant_pick(key.M, key.K, key.batch, key.bits,
                                    key.block, x_bytes)
        if kernel not in ("pim", "splitk"):
            return kernel, plan
        return self._coerce_float(plan, key.M, key.K, key.batch, x_bytes)

    def replay_program(self, pplan: ProgramPlan, key: ProgramKey,
                       policy: DispatchPolicy) -> ProgramPlan:
        """A ``grouped_cuda`` or ``ragged_cuda`` entry keeps its mode; a
        plan its kernel no longer takes (one written before the kernel
        streamed: a one-stage tile plan with a long x chunk) is re-planned
        by :meth:`plan_program`'s planner."""
        M, K = key.Ms[0], key.K
        x_bytes = dtype_bytes(key.dtype)
        if pplan.mode == "grouped_cuda":
            if pplan.plan is not None and grouped_plan_fits(
                    pplan.plan, M, K, key.batch, x_bytes):
                return pplan
            return replace(pplan, kernel="grouped_gemv",
                           plan=self._grouped_plan(key))
        if pplan.mode == "ragged_cuda":
            if pplan.plan is not None and ragged_plan_fits(
                    pplan.plan, M, K, max(key.tokens, 1), x_bytes):
                return pplan
            return replace(pplan, kernel="ragged_gemv",
                           plan=self._ragged_plan(key))
        return super().replay_program(pplan, key, policy)

    def autotune_candidates(self, key: GemvKey, pw: PackedWeights,
                            policy: DispatchPolicy):
        """``ref`` and every kernel the planners accept: ``pim`` and
        ``splitk`` at the planner's default depth, then each at every
        other depth of ``PIPELINE_DEPTHS`` that ``with_pipeline_depth``
        admits (only a measured win puts one in the table); for quantized
        weights the dequant oracle and the quant kernel, staged the same
        way."""
        x_bytes = dtype_bytes(key.dtype)
        if key.bits < 16:
            cands = [("ref", None)]
            if quant_applicable(key.M, key.K, bits=key.bits,
                                block=key.block):
                cands.append(self._quant_pick(key.M, key.K, key.batch,
                                              key.bits, key.block, x_bytes))
        else:
            cands = self.candidate_plans(key.M, key.K, key.batch, x_bytes)
        staged = []
        for kernel, plan in cands:
            if plan is None:
                continue
            for depth in PIPELINE_DEPTHS:
                deep = with_pipeline_depth(plan, depth, batch=key.batch,
                                           elem_bytes=x_bytes,
                                           bits=key.bits, block=key.block)
                if deep is not None and deep is not plan:
                    staged.append((kernel, deep))
        return cands + staged

    def candidate_label(self, kernel: str, plan: GemvPlan | None) -> str:
        """Staged plans of one kernel are distinct candidates: the label
        carries the ring depth (``pim/s4``, ``quant/s3``)."""
        if kernel != "ref" and plan is not None:
            return f"{kernel}/s{plan.stages}"
        return kernel

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
                plan = (self._grouped_plan(key) if key.kind == "grouped"
                        else self._ragged_plan(key))
                return ProgramPlan(mode=f"{key.kind}_cuda", n_launches=1,
                                   kernel=f"{key.kind}_gemv", plan=plan)
        return super().plan_program(key, policy=policy)

    def _grouped_plan(self, key: ProgramKey) -> GemvPlan:
        """``grouped_gemv``'s streaming plan for a grouped program: C rows
        an expert over ``group`` experts, filling this backend's SMs."""
        return plan_grouped_stream(key.Ms[0], key.K, key.batch,
                                   E=key.group, sms=self._plan_sms(),
                                   elem_bytes=dtype_bytes(key.dtype))

    def _ragged_plan(self, key: ProgramKey) -> GemvPlan:
        """``ragged_gemv``'s streaming plan for a ragged program: the
        key's ``tokens`` rows over ``group`` experts, filling this
        backend's SMs."""
        return plan_ragged_stream(key.Ms[0], key.K, max(key.tokens, 1),
                                  E=key.group, sms=self._plan_sms(),
                                  elem_bytes=dtype_bytes(key.dtype))

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
