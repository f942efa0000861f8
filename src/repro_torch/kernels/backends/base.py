"""The ``GemvBackend`` contract: one pluggable target per memory system.

Counterpart of ``repro/kernels/backends/base.py`` for the slice the port
runs: a backend bundles its kernel set and executors, a frozen
:class:`CostModel`, and the selection and program planning the dispatcher
delegates to it.  Keys carry the weight's ``bits`` (16 float, 8 int8, 4
packed int4) and scale ``block``; a quantized weight's ``ref`` path is the
block-scale dequant oracle.  Programs come in the JAX package's three
kinds: ``fused`` (shared-input projections), ``grouped`` (an expert stack
with a uniform C rows per expert) and ``ragged`` (an expert-sorted flat
buffer with per-expert counts); a quantized expert stack runs on the
portable executors, dequantized per expert.

Measured selection: :class:`AutotuneTable` is the JAX package's format-3
JSON table (per-backend namespaces of single-GEMV and program winners,
plus a ``calibration`` section kept as data), and
:meth:`GemvBackend.autotune_gemv` / :meth:`GemvBackend.autotune_program`
time a backend's candidates on synthetic inputs and persist the winner.
Table keys and plan entries are the JAX package's, so either package
reads the other's table.  Calibration (fitting the constants) and sharding
are not ported yet.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from dataclasses import dataclass

import torch

from repro_torch.kernels.gemv_plan import GemvPlan
from repro_torch.kernels.ops import PackedWeights, pack_fused, quantize_weight


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
    other value pins one of the backend's kernels.  ``autotune=True``
    replaces the cost model with measured timings, memoized per backend
    namespace in the JSON table at ``table_path`` when set.
    ``use_pallas=False``
    (the JAX package's name) keeps auto selection and MoE expert programs
    off the hand-written kernels.  ``expert_shape`` picks the MoE decode
    execution shape: ``"ragged"`` (the capacity-free expert-sorted buffer),
    ``"grouped"`` (the capacity-padded ``[E, C, K]`` buffers) or
    ``"einsum"`` (no program dispatch); prefill always runs the einsum
    semantics.
    """

    kernel: str = "auto"
    backend: str | None = None
    autotune: bool = False
    table_path: str | None = None
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

    def table_key(self) -> str:
        """The autotune-table key, the JAX package's (``dtype`` without the
        ``torch.`` prefix; the namespace carries the backend)."""
        return (f"{self.M}x{self.K}xb{self.batch}_w{self.bits}g{self.block}"
                f"_{_dtype_name(self.dtype)}")


def _dtype_name(dtype: str) -> str:
    return dtype.removeprefix("torch.")


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

    def table_key(self) -> str:
        """The JAX package's program key of the table's ``programs``
        section."""
        ms = "+".join(str(m) for m in self.Ms)
        base = (f"{self.kind}[{ms}]x{self.K}xb{self.batch}_e{self.group}"
                f"_w{self.bits}g{self.block}_{_dtype_name(self.dtype)}")
        if self.kind == "ragged":
            return f"{base}_t{self.tokens}.{self.hist}"
        return base


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
    def fused(cls, x: torch.Tensor,
              members: "list[PackedWeights]") -> "GemvProgram":
        """Shared-input projections: the members concatenated along M (one
        copy; hot paths prepack instead)."""
        fused_pw, splits = pack_fused(members)
        reqs = tuple(GemvRequest(x=x, weights=pw, tag=f"m{i}")
                     for i, pw in enumerate(members))
        return cls(kind="fused", x=x, weights=fused_pw, m_splits=splits,
                   requests=reqs)

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


def key_dtype(dtype_name: str) -> torch.dtype:
    """The torch dtype a key's dtype string names (with or without the
    ``torch.`` prefix: a JAX-written key has none)."""
    return getattr(torch, _dtype_name(dtype_name))


def dtype_bytes(dtype_name: str) -> int:
    """Element size of a key's dtype string (``"torch.bfloat16"`` -> 2)."""
    return key_dtype(dtype_name).itemsize


# ---------------------------------------------------------------------------
# Autotune table entries
# ---------------------------------------------------------------------------


def entry_to_plan(entry: dict) -> tuple[str, GemvPlan | None]:
    """Rebuild a (kernel, plan) decision from a table entry.  The JAX keys
    (``m_blk, k_blk, n_m, n_k, split_k``) carry the plan; the port's
    ``smem_bytes`` / ``stages`` sit beside them (absent from a JAX-written
    entry, whose TPU ``vmem_bytes`` / ``pipeline_depth`` mean nothing
    here)."""
    if entry.get("m_blk") is None:
        return entry["kernel"], None
    return entry["kernel"], GemvPlan(
        m_blk=entry["m_blk"], k_blk=entry["k_blk"], n_m=entry["n_m"],
        n_k=entry["n_k"], smem_bytes=entry.get("smem_bytes", 0),
        split_k=entry.get("split_k", 1), stages=entry.get("stages", 1))


def plan_to_entry(kernel: str, plan: GemvPlan | None,
                  elapsed_us: float) -> dict:
    entry = {"kernel": kernel, "us": elapsed_us}
    if plan is not None:
        entry.update(m_blk=plan.m_blk, k_blk=plan.k_blk, n_m=plan.n_m,
                     n_k=plan.n_k, split_k=plan.split_k,
                     smem_bytes=plan.smem_bytes, stages=plan.stages)
    return entry


def program_plan_to_entry(pplan: ProgramPlan, elapsed_us: float) -> dict:
    entry = {"mode": pplan.mode, "n_launches": pplan.n_launches,
             "us": elapsed_us}
    if pplan.kernel:
        entry.update(plan_to_entry(pplan.kernel, pplan.plan, elapsed_us))
    return entry


def entry_to_program_plan(entry: dict) -> ProgramPlan:
    if entry.get("kernel"):
        kernel, plan = entry_to_plan(entry)
        return ProgramPlan(mode=entry["mode"], n_launches=entry["n_launches"],
                           kernel=kernel, plan=plan)
    return ProgramPlan(mode=entry["mode"], n_launches=entry["n_launches"])


# ---------------------------------------------------------------------------
# Synthetic inputs: the autotuner never times the caller's tensors
# ---------------------------------------------------------------------------


def _synth_weight(gen: torch.Generator, M: int, K: int, key,
                  device: torch.device) -> PackedWeights:
    w = torch.randn((M, K), generator=gen, device=device)
    if key.bits < 16:
        return quantize_weight(w, bits=key.bits, block=key.block)
    return PackedWeights(w_t=w.t().contiguous().to(key_dtype(key.dtype)))


def synthesize_gemv(key: GemvKey, device: torch.device
                    ) -> tuple[torch.Tensor, PackedWeights]:
    """Random ``(x, packed weights)`` matching a single-GEMV key, on
    ``device``, from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((key.batch, key.K), generator=gen, device=device)
    return (x.to(key_dtype(key.dtype)),
            _synth_weight(gen, key.M, key.K, key, device))


def _synthesize_program(key: ProgramKey,
                        device: torch.device) -> GemvProgram:
    """A program with random data matching a key, on ``device``.  A ragged
    one gets balanced counts with the remainder on expert 0: a
    representative distribution, not an adversarial one."""
    gen = torch.Generator(device=device).manual_seed(0)
    dtype = key_dtype(key.dtype)

    def x_of(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    if key.kind in ("ragged", "grouped"):
        rows = ((key.tokens or key.batch * key.group,)
                if key.kind == "ragged" else (key.group, key.batch))
        x = x_of(*rows, key.K)
        stacked = PackedWeights.stack([
            _synth_weight(gen, key.Ms[0], key.K, key, device)
            for _ in range(key.group)])
        if key.kind == "grouped":
            return GemvProgram.grouped(x, stacked)
        base_c, rem = divmod(rows[0], key.group)
        counts = torch.full((key.group,), base_c, dtype=torch.int32,
                            device=device)
        counts[0] += rem
        return GemvProgram.ragged(x, counts, stacked, bound=key.batch)
    x = x_of(key.batch, key.K)
    return GemvProgram.fused(x, [_synth_weight(gen, M, key.K, key, device)
                                 for M in key.Ms])


# ---------------------------------------------------------------------------
# Autotune table: per-backend namespaces, one JSON file
# ---------------------------------------------------------------------------

# the JAX package's format: v3 has the per-backend "programs" section; v2
# namespaced single-GEMV tables and v1 flat files still load
_TABLE_FORMAT = 3


class AutotuneTable:
    """Measured (kernel, plan) winners, namespaced per backend: the JAX
    package's format-3 document::

        {"format": 3,
         "tables":      {"h100": {<shape key>: entry, ...}, "gpu": {...}},
         "programs":    {"h100": {<program key>: entry, ...}, ...},
         "calibration": {"cpu": {"constants": {...}, ...}}}

    Tuners on different backends merge into one file without key
    collisions.  ``calibration`` holds fitted constants; this package keeps
    it as data (fitting and applying them is not ported).  Top-level
    sections it does not know are kept verbatim through load and save.
    All mutation holds a lock.
    """

    _KNOWN_SECTIONS = ("format", "tables", "programs", "calibration")
    # v1 keys ended with the platform the tuner ran on
    _V1_KEY_SUFFIXES = ("cpu", "tpu", "gpu", "cuda", "rocm")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tables: dict[str, dict[str, dict]] = {}
        self._programs: dict[str, dict[str, dict]] = {}
        self._calibration: dict[str, dict] = {}
        self._extras: dict = {}
        self._loaded_paths: set[str] = set()

    # -- in-memory access ---------------------------------------------------

    def get(self, namespace: str, key: str) -> dict | None:
        with self._lock:
            entry = self._tables.get(namespace, {}).get(key)
            return dict(entry) if entry is not None else None

    def put(self, namespace: str, key: str, entry: dict) -> None:
        with self._lock:
            self._tables.setdefault(namespace, {})[key] = dict(entry)

    def get_program(self, namespace: str, key: str) -> dict | None:
        with self._lock:
            entry = self._programs.get(namespace, {}).get(key)
            return dict(entry) if entry is not None else None

    def put_program(self, namespace: str, key: str, entry: dict) -> None:
        with self._lock:
            self._programs.setdefault(namespace, {})[key] = dict(entry)

    def snapshot(self) -> dict[str, dict[str, dict]]:
        with self._lock:
            return {ns: {k: dict(e) for k, e in t.items()}
                    for ns, t in self._tables.items()}

    def snapshot_programs(self) -> dict[str, dict[str, dict]]:
        with self._lock:
            return {ns: {k: dict(e) for k, e in t.items()}
                    for ns, t in self._programs.items()}

    def clear(self) -> None:
        with self._lock:
            self._tables.clear()
            self._programs.clear()
            self._calibration.clear()
            self._extras.clear()
            self._loaded_paths.clear()

    # -- persistence --------------------------------------------------------

    @classmethod
    def _parse(cls, doc: dict):
        """``(tables, programs, calibration, extras)`` of a v3/v2 document,
        or of a v1 flat table (suffixed shape keys; loaded into the ``tpu``
        namespace, the kernel set those tables named, suffix stripped)."""
        if isinstance(doc.get("tables"), dict):
            def section(name):
                sec = doc.get(name, {})
                return ({ns: dict(v) for ns, v in sec.items()}
                        if isinstance(sec, dict) else {})

            extras = {k: v for k, v in doc.items()
                      if k not in cls._KNOWN_SECTIONS}
            return (section("tables"), section("programs"),
                    section("calibration"), extras)
        flat = {}
        for k, v in doc.items():
            if not (isinstance(v, dict) and "kernel" in v):
                continue
            head, _, tail = k.rpartition("_")
            if head and tail in cls._V1_KEY_SUFFIXES:
                k = head
            flat[k] = v
        return ({"tpu": flat} if flat else {}), {}, {}, {}

    def load(self, path: str) -> dict[str, dict[str, dict]]:
        """Merge the table at ``path`` into memory; returns the single-GEMV
        ``{backend: {key: entry}}`` section that was read."""
        with open(path) as f:
            tables, programs, calibration, extras = self._parse(json.load(f))
        with self._lock:
            for mine, theirs in ((self._tables, tables),
                                 (self._programs, programs)):
                for ns, entries in theirs.items():
                    mine.setdefault(ns, {}).update(
                        {k: dict(e) for k, e in entries.items()})
            for ns, entry in calibration.items():
                self._calibration[ns] = dict(entry)
            self._extras.update(extras)
            self._loaded_paths.add(os.path.abspath(path))
        return tables

    def ensure_loaded(self, path: str) -> None:
        """Load ``path`` once per process, if it exists."""
        p = os.path.abspath(path)
        with self._lock:
            if p in self._loaded_paths:
                return
            self._loaded_paths.add(p)
        if os.path.exists(p):
            self.load(p)

    def save(self, path: str) -> None:
        """Merge this process's namespaces into the file at ``path``:
        read, merge per namespace and per key, write a temporary file and
        rename it into place, all under the lock.  A tuner on one backend
        never erases another's entries, nor entries for shapes it did not
        tune."""
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._lock:
            tables, programs, calibration, extras = {}, {}, {}, {}
            try:
                with open(path) as f:
                    tables, programs, calibration, extras = self._parse(
                        json.load(f))
            except (FileNotFoundError, json.JSONDecodeError):
                pass
            for merged, mine in ((tables, self._tables),
                                 (programs, self._programs)):
                for ns, entries in mine.items():
                    merged.setdefault(ns, {}).update(entries)
            calibration.update(self._calibration)
            extras.update(self._extras)
            doc = dict(extras)
            doc.update({"format": _TABLE_FORMAT, "tables": tables,
                        "programs": programs})
            if calibration:
                doc["calibration"] = calibration
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump(doc, f, indent=1, sort_keys=True)
                os.replace(tmp, path)
            except BaseException:
                with contextlib.suppress(OSError):
                    os.unlink(tmp)
                raise


# ---------------------------------------------------------------------------
# Timing harness
# ---------------------------------------------------------------------------


def time_gemv_us(run, reps: int = 3) -> float:
    """Best-of-``reps`` wall clock (us) of a thunk returning a tensor,
    after one warm-up call (which builds and loads a kernel on first use).
    On the card each timed call sits between two ``synchronize()``s."""
    out = run()
    dev = out.device if out.is_cuda else None

    def sync():
        if dev is not None:
            torch.cuda.synchronize(dev)

    best = float("inf")
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


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

    def coerce_plan(self, plan: GemvPlan, M: int, K: int, batch: int,
                    pw: PackedWeights, policy: DispatchPolicy
                    ) -> tuple[str, GemvPlan | None]:
        """Map a caller-supplied plan (``dispatch_gemv(plan=...)``) to this
        backend's (kernel, plan).  Default: ignore it and select."""
        return self.select_kernel(M, K, batch, bits=pw.bits, block=pw.block,
                                  policy=policy)

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

    # -- autotune: the backend's candidates, timed on synthetic inputs ------

    def autotune_candidates(self, key: GemvKey, pw: PackedWeights,
                            policy: DispatchPolicy
                            ) -> list[tuple[str, GemvPlan | None]]:
        """The (kernel, plan) pairs the autotuner times: those the planners
        accept for this shape (a shape a kernel cannot take never appears).
        Default: ``ref`` alone."""
        return [("ref", None)]

    def candidate_label(self, kernel: str, plan: GemvPlan | None) -> str:
        """A candidate's name in an entry's ``candidates_us``: the kernel,
        unless a backend times several plans of one kernel."""
        return kernel

    def autotune_gemv(self, key: GemvKey, *, policy: DispatchPolicy,
                      table: AutotuneTable,
                      device: torch.device) -> tuple[str, GemvPlan | None]:
        """The table's entry for ``key`` in this backend's namespace, else
        every candidate timed on synthetic inputs on ``device`` and the
        fastest persisted (with each candidate's time beside it).

        A candidate that fails to build or launch raises: unlike the JAX
        package's tuner, nothing is skipped here, so a broken kernel can
        never hide behind ``ref``.
        """
        if policy.table_path:
            table.ensure_loaded(policy.table_path)
        tkey = key.table_key()
        entry = table.get(self.name, tkey)
        if entry is not None:
            return entry_to_plan(entry)
        x, pw = synthesize_gemv(key, device)
        timed = [(time_gemv_us(lambda k=kernel, p=plan:
                               self.execute(k, x, pw, p)), kernel, plan)
                 for kernel, plan in self.autotune_candidates(key, pw,
                                                              policy)]
        us, kernel, plan = min(timed, key=lambda t: t[0])
        entry = plan_to_entry(kernel, plan, us)
        entry["candidates_us"] = {self.candidate_label(k, p): t
                                  for t, k, p in timed}
        table.put(self.name, tkey, entry)
        if policy.table_path:
            table.save(policy.table_path)
        return kernel, plan

    def autotune_program(self, key: ProgramKey, *, policy: DispatchPolicy,
                         table: AutotuneTable,
                         device: torch.device) -> ProgramPlan:
        """The planner's mode timed against the alternative on a synthetic
        program (a ragged program against the portable ragged executor,
        any other against its per-request form); the winner persists in
        this backend's ``programs`` section.  A failing mode raises."""
        if policy.table_path:
            table.ensure_loaded(policy.table_path)
        tkey = key.table_key()
        entry = table.get_program(self.name, tkey)
        if entry is not None:
            return entry_to_program_plan(entry)
        program = _synthesize_program(key, device)
        cands = [self.plan_program(key, policy=policy)]
        alt = (ProgramPlan(mode="ragged", n_launches=1)
               if key.kind == "ragged"
               else ProgramPlan(mode="per_request",
                                n_launches=key.n_requests))
        if cands[0].mode != alt.mode:
            cands.append(alt)

        def run(pplan):
            if pplan.mode == "per_request":
                return self._execute_per_request(program, policy)
            return self.execute_program(program, pplan)

        timed = [(time_gemv_us(lambda p=c: run(p)), i)
                 for i, c in enumerate(cands)]
        us, best = min(timed)
        entry = program_plan_to_entry(cands[best], us)
        entry["candidates_us"] = {cands[i].mode: t for t, i in timed}
        table.put_program(self.name, tkey, entry)
        if policy.table_path:
            table.save(policy.table_path)
        return cands[best]

    def _execute_per_request(self, program: GemvProgram,
                             policy: DispatchPolicy) -> torch.Tensor:
        """A fused or grouped program as independent requests, each
        selected and run on this backend (the autotuner's per-request
        candidate; the dispatcher decomposes through its plan cache)."""
        outs = []
        for req in program.decompose():
            K, M = req.weights.shape
            kernel, plan = self.select_kernel(
                M, K, req.x.shape[0], bits=req.weights.bits,
                block=req.weights.block, x_bytes=req.x.element_size(),
                policy=policy)
            outs.append(self.execute(kernel, req.x.contiguous(),
                                     req.weights, plan))
        if program.kind == "grouped":
            return torch.stack(outs)
        return torch.cat(outs, dim=-1)

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
    def _dequant_stack(pw: PackedWeights) -> torch.Tensor:
        """An ``[E, K, M]`` stack as floats: the 16-bit stack itself, or
        int8 / packed int4 codes times each expert's block scales
        (``[E, K // block, M]``), in f32."""
        from repro_torch.kernels import ref

        w = pw.w_t
        if pw.bits == 4:
            w = ref.unpack_int4(w)
        if pw.bits < 16:
            E, K, M = w.shape
            w = (w.float().reshape(E, K // pw.block, pw.block, M)
                 * pw.scales.float()[:, :, None, :]).reshape(E, K, M)
        return w

    def _execute_grouped(self, xs: torch.Tensor,
                         pw: PackedWeights) -> torch.Tensor:
        """Portable batched expert product: out[E, C, M] = xs[E, C, K] @
        w[E, K, M], f32 accumulation, cast to xs.dtype; a quantized stack
        is dequantized per expert first."""
        w = self._dequant_stack(pw)
        return torch.matmul(xs.float(), w.float()).to(xs.dtype)

    def _execute_ragged(self, program: GemvProgram) -> torch.Tensor:
        """Portable ragged executor: row t against the expert whose count
        range holds it, f32 accumulation, rows at or beyond ``sum(counts)``
        zero.  Every expert's product is taken over all T rows and each row
        keeps its own expert's: no host sync on the counts, at E times the
        arithmetic (only the native kernels skip experts with no rows)."""
        from repro_torch.kernels.grouped_gemv import counts_to_offsets

        x = program.x
        w = self._dequant_stack(program.weights)
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
