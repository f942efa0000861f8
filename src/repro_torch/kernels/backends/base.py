"""The ``GemvBackend`` contract: one pluggable target per memory system.

Counterpart of ``repro/kernels/backends/base.py`` for the slice the port
runs: a backend bundles its kernel set and executors, a frozen
:class:`CostModel`, and the selection and program planning the dispatcher
delegates to it.  Keys carry the weight's ``bits`` (16 float, 8 int8, 4
packed int4) and scale ``block``; a quantized weight's ``ref`` path is the
block-scale dequant oracle.  Autotune tables, calibration, grouped and ragged
programs and sharding are not ported yet.
"""

from __future__ import annotations

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


@dataclass(frozen=True)
class DispatchPolicy:
    """How :func:`repro_torch.kernels.dispatch.dispatch_gemv` picks a kernel.

    ``backend=None`` resolves from the input's device (``cuda`` -> h100,
    ``cpu`` -> cpu).  ``kernel="auto"`` uses the backend's cost model; any
    other value pins one of the backend's kernels.
    """

    kernel: str = "auto"
    backend: str | None = None
    batch_threshold: int = 8         # above this decode is matmul-shaped
    min_pallas_bytes: int = 1 << 20  # tiny weights: launch cost dominates
    fuse_programs: bool = True       # plan shared-input GEMVs jointly


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
    """Plan-cache key of one fused program shape."""

    kind: str
    Ms: tuple[int, ...]
    K: int
    batch: int
    bits: int
    block: int
    dtype: str
    backend: str

    @property
    def n_requests(self) -> int:
        return len(self.Ms)


@dataclass(frozen=True)
class GemvProgram:
    """Shared-input GEMVs planned jointly (QKV, MLP gate+up).

    ``weights`` is the prepacked ``[K, sum(m_splits)]`` concatenation
    (codes and scales for quantized members); ``requests`` carries the
    per-member decomposition.
    """

    kind: str                          # "fused"
    x: torch.Tensor
    weights: PackedWeights
    m_splits: tuple[int, ...]
    requests: tuple[GemvRequest, ...]

    def split(self, out: torch.Tensor) -> list[torch.Tensor]:
        """Slice the [B, sum(M_i)] output back per request."""
        return list(torch.split(out, list(self.m_splits), dim=-1))

    def key(self, backend_name: str) -> ProgramKey:
        return ProgramKey(kind=self.kind, Ms=self.m_splits,
                          K=self.weights.shape[0], batch=int(self.x.shape[0]),
                          bits=self.weights.bits, block=self.weights.block,
                          dtype=str(self.x.dtype), backend=backend_name)


@dataclass(frozen=True)
class ProgramPlan:
    """``mode`` is ``fused`` (one kernel on the concatenated weight;
    ``kernel``/``plan`` name the inner decision) or ``per_request``."""

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

    # -- fused programs -------------------------------------------------------

    def plan_program(self, key: ProgramKey, *,
                     policy: DispatchPolicy = DEFAULT_POLICY) -> ProgramPlan:
        """``fused``: one kernel on the concatenated [K, sum(Ms)] weight,
        selected exactly as a single GEMV of that shape would be."""
        if not policy.fuse_programs or "fused" not in self.program_modes:
            return ProgramPlan(mode="per_request", n_launches=key.n_requests)
        kernel, plan = self.select_kernel(sum(key.Ms), key.K, key.batch,
                                          bits=key.bits, block=key.block,
                                          x_bytes=dtype_bytes(key.dtype),
                                          policy=policy)
        return ProgramPlan(mode="fused", n_launches=1, kernel=kernel,
                           plan=plan)

    def execute_program(self, program: GemvProgram,
                        pplan: ProgramPlan) -> torch.Tensor:
        """Run a program planned ``fused``: returns [B, sum(Ms)]."""
        if pplan.mode != "fused":
            raise ValueError(f"execute_program runs fused plans, got {pplan}")
        return self.execute(pplan.kernel, program.x, program.weights,
                            pplan.plan)


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
