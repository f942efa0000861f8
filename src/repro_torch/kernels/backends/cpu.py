"""CPU ``GemvBackend``: plain PyTorch, the twin of ``backends/cpu.py``.

* ``ref`` — the f32-accumulating product on the K-major weight;
* ``splitk`` — K cut into ``degree`` chunks, f32 partials summed in order
  (the paper's split-K reduce in plain form);
* ``quant`` / ``quant4`` — the block-scale dequant oracles: every quantized
  weight takes them, whatever the batch or a kernel pin says;

and MoE expert programs through the portable ``grouped`` / ``ragged``
executors of the base class.

The cost constants are the JAX CPU backend's seeds (a DDR-class host).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.backends.base import (
    DEFAULT_POLICY,
    CostModel,
    DispatchPolicy,
    GemvBackend,
    GemvKey,
    register_backend,
)
from repro_torch.kernels.gemv_plan import GemvPlan, valid_splitk_degree
from repro_torch.kernels.ops import PackedWeights

COST_MODEL = CostModel(bandwidth_gbps=51.2, gemv_efficiency=0.55,
                       launch_us=1.5, program_us=3.0, min_parallel_blocks=8)


def plan_cpu_splitk(M: int, K: int) -> GemvPlan | None:
    """Chunk K at the highest valid split degree."""
    deg = valid_splitk_degree(K)
    if deg is None:
        return None
    return GemvPlan(m_blk=M, k_blk=K // deg, n_m=1, n_k=1, smem_bytes=0,
                    split_k=deg)


class CpuBackend(GemvBackend):
    name = "cpu"
    kernels = ("ref", "splitk", "quant", "quant4")
    program_modes = ("fused", "grouped", "ragged")

    @property
    def seed_cost_model(self) -> CostModel:
        return COST_MODEL

    def estimate_cost_us(self, kernel, M, K, batch, *, bits=16, x_bytes=2,
                         plan=None) -> float:
        if kernel != "splitk" or plan is None:
            return super().estimate_cost_us(kernel, M, K, batch, bits=bits,
                                            x_bytes=x_bytes)
        cm = self.cost_model
        deg = plan.split_k
        io = self.io_bytes(M, K, batch, bits=bits, x_bytes=x_bytes)
        occupancy = min(1.0, deg / cm.min_parallel_blocks)
        t = io / (cm.bandwidth_bps * occupancy) * 1e6
        t += cm.launch_us + cm.program_us * deg
        t += cm.splitk_reduce_factor * deg * batch * M * 4 / cm.bandwidth_bps \
            * 1e6
        return t + batch * M * cm.elem_ns * 1e-3

    def candidate_plans(self, M, K, batch, bits):
        if bits < 16:
            # quantized weights keep the dequantizing contraction: there is
            # no lower-traffic path on this backend
            return [("quant" if bits == 8 else "quant4", None)]
        cands: list[tuple[str, GemvPlan | None]] = [("ref", None)]
        plan = plan_cpu_splitk(M, K)
        if plan is not None:
            cands.append(("splitk", plan))
        return cands

    def select_kernel(self, M, K, batch, *, bits=16, block=32, x_bytes=2,
                      policy: DispatchPolicy = DEFAULT_POLICY):
        if policy.kernel != "auto":
            self._check_pin(policy.kernel, bits)
        if bits < 16:
            # the dequantizing contraction, pinned or not
            return self.candidate_plans(M, K, batch, bits)[0]
        if policy.kernel != "auto":
            plan = plan_cpu_splitk(M, K)
            if policy.kernel == "splitk" and plan is not None:
                return "splitk", plan
            return "ref", None
        if batch > policy.batch_threshold:
            return "ref", None
        return min(self.candidate_plans(M, K, batch, bits),
                   key=lambda kp: self.estimate_cost_us(
                       kp[0], M, K, batch, bits=bits, x_bytes=x_bytes,
                       plan=kp[1]))

    def coerce_plan(self, plan: GemvPlan, M: int, K: int, batch: int,
                    pw: PackedWeights, policy: DispatchPolicy):
        """A caller's plan carries one decision this backend can use: its
        split degree.  Everything else (blocks, grid) is another kernel's."""
        if pw.bits < 16:
            return self.candidate_plans(M, K, batch, pw.bits)[0]
        if plan.split_k > 1 and K % plan.split_k == 0:
            return "splitk", GemvPlan(m_blk=M, k_blk=K // plan.split_k,
                                      n_m=1, n_k=1, smem_bytes=0,
                                      split_k=plan.split_k)
        return "ref", None

    def autotune_candidates(self, key: GemvKey, pw: PackedWeights,
                            policy: DispatchPolicy):
        return self.candidate_plans(key.M, key.K, key.batch, key.bits)

    def execute(self, kernel: str, x: torch.Tensor, pw: PackedWeights,
                plan: GemvPlan | None) -> torch.Tensor:
        if kernel == "splitk":
            return ref.splitk_gemv_ref(pw.w_t, x, plan.split_k)
        if kernel in ("ref", "quant", "quant4"):
            # quant/quant4 here ARE the dequant oracles, picked by pw.bits
            return self._execute_ref(x, pw)
        raise ValueError(f"unknown kernel {kernel!r}")


BACKEND = register_backend(CpuBackend(), devices=("cpu",))
