"""The ``GemvBackend`` contract: one pluggable target per memory system.

Counterpart of ``repro/kernels/backends/base.py`` for the slice the port
runs: a backend bundles its kernel set and executors, a frozen
:class:`CostModel`, and the selection and program planning the dispatcher
delegates to it.  Keys carry the weight's ``bits`` (16 float, 8 int8, 4
packed int4) and scale ``block``; a quantized weight's ``ref`` path is the
block-scale dequant oracle.  Programs come in the JAX package's three
kinds: ``fused`` (shared-input projections), ``grouped`` (an expert stack
with a uniform C rows per expert) and ``ragged`` (an expert-sorted flat
buffer with per-expert counts).  Autotune tables, calibration, quantized
expert stacks and sharding are not ported yet.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass

import torch

from repro_torch.kernels.gemv_plan import GemvPlan
from repro_torch.kernels.ops import PackedWeights


@dataclass(frozen=True)
class CostModel:
    """Constants of the analytical GEMV latency model of one backend."""

    bandwidth_gbps: float      # sustained memory bandwidth, GB/s (1e9 B/s)
    gemv_efficiency: float     # fraction of it the untuned ref GEMV gets
    launch_us: float           # fixed kernel-launch overhead
    program_us: float          # per-CTA (or per-chunk) overhead
    min_parallel_blocks: int   # grid fill target: fewer blocks starve it
    # each of ``degree`` f32 partial outputs is written, then re-read
    splitk_reduce_factor: float = 2.0

    @property
    def bandwidth_bps(self) -> float:
        return self.bandwidth_gbps * 1e9


def _next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1): histogram bucket edges."""
    return 1 << max(int(n) - 1, 0).bit_length()


def expert_batch_bound(n_tokens: int, top_k: int, n_experts: int, *,
                       skew: float = 2.0) -> int:
    """Predicted per-expert token bound of a ragged MoE dispatch: the even
    split ``n_tokens * top_k / n_experts`` times ``skew``, clamped to
    ``[1, n_tokens]``.  A statistic, not a correctness bound: it prices the
    program (``ProgramKey.batch``) and gates expert-aware admission (the
    scheduler shares this formula)."""
    even = n_tokens * top_k / max(n_experts, 1)
    return max(1, min(int(n_tokens), math.ceil(even * skew)))


@dataclass(frozen=True)
class DispatchPolicy:
    """How :func:`repro_torch.kernels.dispatch.dispatch_gemv` picks a kernel.

    ``backend=None`` resolves from the input's device (``cuda`` -> h100,
    ``cpu`` -> cpu).  ``kernel="auto"`` uses the backend's cost model; any
    other value pins one of the backend's kernels.  ``use_pallas=False``
    (the JAX package's name) keeps auto selection and MoE expert programs
    off the hand-written kernels.  ``expert_shape`` picks the MoE decode
    execution shape: ``"ragged"`` (the capacity-free expert-sorted buffer),
    ``"grouped"`` (the capacity-padded ``[E, C, K]`` buffers) or
    ``"einsum"`` (no program dispatch); prefill always runs the einsum
    semantics.
    """

    kernel: str = "auto"
    backend: str | None = None
    use_pallas: bool = True
    batch_threshold: int = 8         # above this decode is matmul-shaped
    min_pallas_bytes: int = 1 << 20  # tiny weights: launch cost dominates
    fuse_programs: bool = True       # plan shared-input GEMVs jointly
    expert_shape: str = "ragged"     # ragged | grouped | einsum


DEFAULT_POLICY = DispatchPolicy()


@dataclass(frozen=True)
class GemvKey:
    """Plan-cache key: shape + weight storage + dtype + backend name."""

    M: int
    K: int
    batch: int
    bits: int
    block: int
    dtype: str
    backend: str


@dataclass(frozen=True)
class GemvRequest:
    """One GEMV: out[B, M] = x[B, K] @ weights."""

    x: torch.Tensor
    weights: PackedWeights
    tag: str = ""


@dataclass(frozen=True)
class ProgramKey:
    """Plan-cache key of one program shape (``repro``'s ``ProgramKey``).

    ``Ms`` is the per-request width tuple of a fused program and the single
    per-expert ``(M,)`` of a grouped/ragged one; ``group`` is the request
    count (fused) or the expert count; ``batch`` is B (fused), the rows per
    expert C (grouped) or the predicted per-expert bound (ragged, see
    :func:`expert_batch_bound`).  Ragged keys also carry the flat buffer
    length ``tokens`` and the pow2 count-histogram bucket ``hist``.
    """

    kind: str
    Ms: tuple[int, ...]
    K: int
    batch: int
    group: int
    bits: int
    block: int
    dtype: str
    backend: str
    tokens: int = 0      # ragged: flat routed-token buffer length T
    hist: str = ""       # ragged: pow2 count-histogram bucket

    @property
    def n_requests(self) -> int:
        return self.group

    @property
    def total_M(self) -> int:
        return (sum(self.Ms) if self.kind == "fused"
                else self.group * self.Ms[0])


@dataclass(frozen=True)
class GemvProgram:
    """GEMVs planned jointly, in three kinds:

    * ``fused`` -- shared input, per-request widths (QKV, MLP gate+up):
      ``x [B, K]``, ``weights`` the prepacked ``[K, sum(m_splits)]``
      concatenation; output ``[B, sum(m_splits)]`` (:meth:`split`);
    * ``grouped`` -- an expert stack: ``x [E, C, K]``, ``weights.w_t
      [E, K, M]``; output ``[E, C, M]``;
    * ``ragged`` -- a capacity-free expert stack: ``x [T, K]`` sorted by
      expert, ``counts [E]`` device data; output ``[T, M]``, rows past
      ``sum(counts)`` zero.

    ``requests`` carries a fused program's per-request decomposition;
    :meth:`decompose` builds a grouped one's on demand (one request per
    expert: building 64 of them on every decode call cost 0.28 ms of host
    time, for a decomposition the native mode never reads) and a ragged
    program has none (its split is data, not a shape).
    """

    kind: str                          # "fused" | "grouped" | "ragged"
    x: torch.Tensor
    weights: PackedWeights
    m_splits: tuple[int, ...]
    requests: tuple[GemvRequest, ...]
    # ragged only: per-expert counts [E] (device data) and the predicted
    # per-expert bound used as the costing batch (expert_batch_bound)
    counts: torch.Tensor | None = None
    bound: int = 0

    @classmethod
    def grouped(cls, xs: torch.Tensor,
                stacked: PackedWeights) -> "GemvProgram":
        if stacked.w_t.ndim != 3:
            raise ValueError(f"grouped programs need stacked [E, K, M] "
                             f"weights, got {tuple(stacked.w_t.shape)}")
        E = stacked.group
        if xs.ndim != 3 or xs.shape[0] != E:
            raise ValueError(f"grouped inputs must be [E, C, K] with E={E}, "
                             f"got {tuple(xs.shape)}")
        _, M = stacked.shape
        return cls(kind="grouped", x=xs, weights=stacked, m_splits=(M,),
                   requests=())

    @classmethod
    def ragged(cls, x: torch.Tensor, counts: torch.Tensor,
               stacked: PackedWeights, *, bound: int = 0) -> "GemvProgram":
        if stacked.w_t.ndim != 3:
            raise ValueError(f"ragged programs need stacked [E, K, M] "
                             f"weights, got {tuple(stacked.w_t.shape)}")
        if x.ndim != 2:
            raise ValueError(f"ragged inputs must be a flat sorted [T, K] "
                             f"buffer, got {tuple(x.shape)}")
        if tuple(counts.shape) != (stacked.group,):
            raise ValueError(f"ragged counts must be [E]={stacked.group}, "
                             f"got {tuple(counts.shape)}")
        _, M = stacked.shape
        return cls(kind="ragged", x=x, weights=stacked, m_splits=(M,),
                   requests=(), counts=counts,
                   bound=bound or int(x.shape[0]))

    def decompose(self) -> tuple[GemvRequest, ...]:
        """The per-request form: the fused members, or one request per
        expert of a grouped program."""
        if self.kind == "grouped":
            return tuple(GemvRequest(x=self.x[e],
                                     weights=self.weights.member(e),
                                     tag=f"expert{e}")
                         for e in range(self.weights.group))
        if self.kind == "ragged":
            raise ValueError("a ragged program has no per-request form")
        return self.requests

    def split(self, out: torch.Tensor) -> list[torch.Tensor]:
        """Slice a fused program's [B, sum(M_i)] output back per request."""
        if self.kind != "fused":
            raise ValueError(f"split() is for fused programs, not "
                             f"{self.kind}")
        return list(torch.split(out, list(self.m_splits), dim=-1))

    def key(self, backend_name: str) -> ProgramKey:
        pw = self.weights
        K = pw.shape[0]
        common = dict(Ms=self.m_splits, K=K, bits=pw.bits, block=pw.block,
                      dtype=str(self.x.dtype), backend=backend_name)
        if self.kind == "ragged":
            # batch is the predicted bound (counts are device data); the
            # histogram bucket rounds it and the even split to powers of 2
            T, E = int(self.x.shape[0]), pw.group
            hist = (f"le{_next_pow2(self.bound)}"
                    f"m{_next_pow2(-(-T // max(E, 1)))}")
            return ProgramKey(kind="ragged", batch=self.bound, group=E,
                              tokens=T, hist=hist, **common)
        if self.kind == "grouped":
            return ProgramKey(kind="grouped", batch=int(self.x.shape[1]),
                              group=pw.group, **common)
        return ProgramKey(kind=self.kind, batch=int(self.x.shape[0]),
                          group=len(self.m_splits), **common)


@dataclass(frozen=True)
class ProgramPlan:
    """``mode`` is ``fused`` (one kernel on the concatenated weight;
    ``kernel``/``plan`` name the inner decision), ``grouped`` / ``ragged``
    (the portable plain-PyTorch executors), a backend's native expert mode
    (``kernel``/``plan`` name the kernel and its tiles) or
    ``per_request``.  ``n_launches`` is the launches the mode costs."""

    mode: str
    n_launches: int
    kernel: str = ""
    plan: GemvPlan | None = None


def dtype_bytes(dtype_name: str) -> int:
    """Element size of a key's dtype string (``"torch.bfloat16"`` -> 2)."""
    return getattr(torch, dtype_name.removeprefix("torch.")).itemsize


class GemvBackend:
    """One execution target behind ``dispatch_gemv``."""

    name: str = ""
    kernels: tuple[str, ...] = ("ref",)
    program_modes: tuple[str, ...] = ()

    @property
    def cost_model(self) -> CostModel:
        raise NotImplementedError

    # -- cost model ---------------------------------------------------------

    @staticmethod
    def io_bytes(M: int, K: int, batch: int, *, bits: int = 16,
                 x_bytes: int = 2) -> float:
        """Weight codes + x + out, as the JAX contract counts them (no
        scale bytes, so selections stay comparable)."""
        return M * K * bits / 8 + batch * K * x_bytes + batch * M * x_bytes

    def estimate_cost_us(self, kernel: str, M: int, K: int, batch: int, *,
                         bits: int = 16, x_bytes: int = 2,
                         plan: GemvPlan | None = None) -> float:
        """Default: the memory-bound ref path."""
        cm = self.cost_model
        io = self.io_bytes(M, K, batch, bits=bits, x_bytes=x_bytes)
        return io / (cm.bandwidth_bps * cm.gemv_efficiency) * 1e6

    # -- selection / execution ------------------------------------------------

    def select_kernel(self, M: int, K: int, batch: int, *, bits: int = 16,
                      block: int = 32, x_bytes: int = 2,
                      policy: DispatchPolicy = DEFAULT_POLICY
                      ) -> tuple[str, GemvPlan | None]:
        raise NotImplementedError

    def _check_pin(self, name: str, bits: int) -> None:
        if name not in self.kernels:
            raise ValueError(f"unknown kernel {name!r} for backend "
                             f"{self.name!r}; expected one of {self.kernels}")
        if name in ("quant", "quant4") and bits == 16:
            raise ValueError(f"kernel={name!r} requires int8/int4 weights")

    def execute(self, kernel: str, x: torch.Tensor, pw: PackedWeights,
                plan: GemvPlan | None) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def _execute_ref(x: torch.Tensor, pw: PackedWeights) -> torch.Tensor:
        """The shared plain path: the f32 product for float weights, the
        block-scale dequant oracles for int8 / packed int4."""
        from repro_torch.kernels import ref

        if pw.bits == 16:
            return ref.gemv_ref(pw.w_t, x)
        if pw.bits == 8:
            return ref.quant_gemv_ref(pw.w_t, pw.scales, x, pw.block)
        return ref.quant4_gemv_ref(pw.w_t, pw.scales, x, pw.block)

    # -- programs -------------------------------------------------------------

    def estimate_program_cost_us(self, key: ProgramKey, *, mode: str,
                                 x_bytes: int = 2) -> float:
        """Modeled latency of one program under a mode (the JAX package's
        form, whose per-element term is 0 at its seeds and is left out):
        weight and output traffic, the input reads the mode makes, and the
        launches it costs.  A ragged program reads exactly its
        routed rows; its per-program term scales with the predicted load
        imbalance (the bound over the even split)."""
        cm = self.cost_model
        w_bytes = key.total_M * key.K * key.bits / 8
        if key.kind == "ragged":
            T = max(key.tokens, 1)
            io = w_bytes + T * key.K * x_bytes + T * key.Ms[0] * x_bytes
            t = io / (cm.bandwidth_bps * cm.gemv_efficiency) * 1e6
            launches = 1 if mode != "per_request" else key.group
            imbalance = min(max(key.batch * key.group / T, 1.0),
                            float(key.group))
            return (t + cm.launch_us * launches
                    + cm.program_us * key.group * imbalance)
        out_bytes = key.batch * key.total_M * x_bytes
        if key.kind == "grouped":
            iv_reads = key.group       # every expert has its own rows
        else:
            iv_reads = 1 if mode == "fused" else key.n_requests
        io = w_bytes + iv_reads * key.batch * key.K * x_bytes + out_bytes
        launches = 1 if mode in ("fused", "grouped") else key.n_requests
        t = io / (cm.bandwidth_bps * cm.gemv_efficiency) * 1e6
        return t + cm.launch_us * launches

    def plan_program(self, key: ProgramKey, *,
                     policy: DispatchPolicy = DEFAULT_POLICY) -> ProgramPlan:
        """(mode, launches, inner decision) for one program shape.

        A ragged program is always one launch of the portable executor (its
        split is data, so it has no per-request form).  With fusing off
        every other kind decomposes per request; a grouped one runs the
        portable batched product when the backend lists ``grouped``; a
        fused one runs the kernel selected for the concatenated [K,
        sum(Ms)] GEMV exactly as a single GEMV of that shape would be.
        """
        if key.kind == "ragged":
            return ProgramPlan(mode="ragged", n_launches=1)
        if not policy.fuse_programs:
            return ProgramPlan(mode="per_request", n_launches=key.n_requests)
        if key.kind == "grouped":
            if "grouped" in self.program_modes:
                return ProgramPlan(mode="grouped", n_launches=1)
            return ProgramPlan(mode="per_request", n_launches=key.group)
        if "fused" not in self.program_modes:
            return ProgramPlan(mode="per_request", n_launches=key.n_requests)
        kernel, plan = self.select_kernel(sum(key.Ms), key.K, key.batch,
                                          bits=key.bits, block=key.block,
                                          x_bytes=dtype_bytes(key.dtype),
                                          policy=policy)
        return ProgramPlan(mode="fused", n_launches=1, kernel=kernel,
                           plan=plan)

    def execute_program(self, program: GemvProgram,
                        pplan: ProgramPlan) -> torch.Tensor:
        """Run a program under a joint mode: ``[B, sum(Ms)]`` for fused,
        ``[E, C, M]`` for grouped, ``[T, M]`` for ragged (the per-request
        decomposition runs in the dispatcher)."""
        if pplan.mode == "fused":
            return self.execute(pplan.kernel, program.x, program.weights,
                                pplan.plan)
        if pplan.mode == "grouped":
            return self._execute_grouped(program.x, program.weights)
        if pplan.mode == "ragged":
            return self._execute_ragged(program)
        raise ValueError(f"execute_program runs joint modes, got {pplan}")

    @staticmethod
    def _float_stack(pw: PackedWeights) -> torch.Tensor:
        if pw.bits != 16:
            raise NotImplementedError(
                "quantized expert stacks are not ported yet (ROADMAP)")
        return pw.w_t

    def _execute_grouped(self, xs: torch.Tensor,
                         pw: PackedWeights) -> torch.Tensor:
        """Portable batched expert product: out[E, C, M] = xs[E, C, K] @
        w[E, K, M], f32 accumulation, cast to xs.dtype."""
        w = self._float_stack(pw)
        return torch.matmul(xs.float(), w.float()).to(xs.dtype)

    def _execute_ragged(self, program: GemvProgram) -> torch.Tensor:
        """Portable ragged executor: row t against the expert whose count
        range holds it, f32 accumulation, rows at or beyond ``sum(counts)``
        zero.  Every expert's product is taken over all T rows and each row
        keeps its own expert's: no host sync on the counts, at E times the
        arithmetic (only the native kernels skip experts with no rows)."""
        from repro_torch.kernels.grouped_gemv import counts_to_offsets

        x = program.x
        w = self._float_stack(program.weights)
        E, T = w.shape[0], x.shape[0]
        ends = counts_to_offsets(program.counts)[1:]
        rows = torch.arange(T, dtype=torch.int32, device=x.device)
        eid = torch.searchsorted(ends, rows, right=True)     # E: tail row
        every = torch.matmul(x.float().unsqueeze(0), w.float())  # [E, T, M]
        out = every[eid.clamp(max=E - 1), rows.long()]
        return torch.where((eid < E)[:, None], out, 0.0).to(x.dtype)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, GemvBackend] = {}
_DEVICE_MAP: dict[str, str] = {}
_REG_LOCK = threading.Lock()


def register_backend(backend: GemvBackend, *,
                     devices: tuple[str, ...] = ()) -> GemvBackend:
    """Register a backend instance, optionally claiming the torch device
    types (``"cuda"``, ``"cpu"``) it serves by default."""
    if not backend.name:
        raise ValueError("backend must set a non-empty name")
    with _REG_LOCK:
        _REGISTRY[backend.name] = backend
        for d in devices:
            _DEVICE_MAP[d] = backend.name
    return backend


def get_backend(name: str) -> GemvBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown GEMV backend {name!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None


def resolve_backend(policy: DispatchPolicy | None,
                    device: torch.device) -> GemvBackend:
    """Explicit ``policy.backend``, else the backend serving ``device``."""
    if policy is not None and policy.backend:
        return get_backend(policy.backend)
    try:
        return get_backend(_DEVICE_MAP[device.type])
    except KeyError:
        raise ValueError(f"no GEMV backend serves device {device}") from None
