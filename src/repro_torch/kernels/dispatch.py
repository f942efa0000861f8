"""GEMV dispatch: programs of requests over pluggable backends.

Counterpart of ``repro/kernels/dispatch.py`` for the slice the port runs.
Every entry point

1. resolves a backend: ``DispatchPolicy.backend`` when set, else the one
   serving the input's device (``cuda`` -> ``h100``, ``cpu`` -> ``cpu``);
2. normalizes the weight into one :class:`PackedWeights` (K-major
   ``w_t [K, M]``, or int8 / packed-int4 codes with block scales);
3. delegates selection and program planning to the backend; and
4. memoizes the decision in a process-level, lock-guarded plan cache keyed
   on shape + dtype + backend + policy.

A decision comes, in the JAX package's order, from the plan cache, then
(``policy.autotune``) the backend's autotuner, then (auto policies only)
the backend's namespace of the process-level autotune table
(:func:`load_autotune_table`), then the cost model.  A table entry keeps
its kernel, and the backend re-plans a plan that kernel no longer takes
(``replay_plan`` / ``replay_program``: a table written by an earlier build
replays instead of raising at launch).  ``dispatch_gemv``'s ``plan=``
bypasses all four: the backend coerces the plan to one of its own kernels
(``coerce_plan``).

On every plan-cache miss, before selection, the backend takes the
fitted constants of the table's ``calibration`` section when it has an
entry for it (:func:`_maybe_apply_calibration`; an invalid entry warns
once and is ignored).

Decisions are counted once per plan-cache miss, as in the JAX package:
``dispatch_stats()`` reports the kernel picks, program modes and the
``gemv_path`` / ``matmul_fallback`` mix of every fresh (shape, policy),
(``program_kernels``) the kernel inside each fused program plan, and
(``cost_model_source``) whether the seed or the calibrated constants
priced it.
Kernel *launches* are counted by the kernel wrappers themselves
(``pim_gemv.launches``, ``splitk_gemv.launches``, ``quant_gemv.launches``,
``quant4_gemv.launches``, ``grouped_gemv.launches``,
``ragged_gemv.launches``, ``triton_gemv.launches``).  The MoE layer adds
its per-expert load statistics (``record_expert_load``) to the
``expert_load`` section, once per call.

Every counter here, and every wrapper's, ticks when Python runs the code.
The engine's decode step on the card is a captured CUDA graph
(``serving/step_graph.py``): it counts at the bucket's eager first step and
at its capture, never at a replay -- the counterpart of the JAX package's
counting at trace time.  A replayed step's kernels are seen by the
profiler only.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import warnings

import torch

from repro_torch.kernels.backends import (
    DEFAULT_POLICY,
    DispatchPolicy,
    GemvKey,
    GemvProgram,
    GemvRequest,
    ProgramKey,
    ProgramPlan,
    resolve_backend,
)
from repro_torch.kernels.backends.base import (
    AutotuneTable,
    available_backends,
    dtype_bytes,
    entry_to_plan,
    entry_to_program_plan,
    get_backend,
)
from repro_torch.kernels.gemv_plan import GemvPlan
from repro_torch.kernels.ops import (
    PackedWeights,
    from_transposed,
    pack_weight,
)

__all__ = [
    "DispatchPolicy", "DEFAULT_POLICY", "as_packed", "dispatch_gemv",
    "dispatch_dense", "dispatch_program", "dispatch_fused",
    "dispatch_prepacked", "dispatch_grouped", "dispatch_ragged",
    "dispatch_stats", "record_expert_load", "clear_plan_cache",
    "load_autotune_table", "save_autotune_table", "clear_autotune_table",
    "autotune_table",
]

_LOCK = threading.Lock()
_PLAN_CACHE: dict[tuple[GemvKey, DispatchPolicy],
                  tuple[str, GemvPlan | None]] = {}
_PROGRAM_CACHE: dict[tuple[ProgramKey, DispatchPolicy], ProgramPlan] = {}
_CACHE_STATS = {"hits": 0, "misses": 0, "program_hits": 0,
                "program_misses": 0}
_AUTOTUNE_TABLE = AutotuneTable()
# backends warned about an invalid calibration entry since the table was
# last cleared (the entry cannot get better between misses)
_CALIBRATION_WARNED: set[str] = set()


def _fresh_counters() -> dict:
    return {
        "kernel_picks": {},     # "backend:kernel" -> decisions
        "program_modes": {},    # "backend:mode"   -> decisions
        "program_kernels": {},  # "backend:kernel" -> fused program plans
        "gemv_path": 0,         # decisions with batch <= batch_threshold
        "matmul_fallback": 0,   # decisions the batch gate sent to ref
        # per-expert load of every MoE dispatch (record_expert_load), all
        # monotonic so serving metrics can delta them: max_tokens sums the
        # planned per-expert bound, padded_slots the capacity slots the
        # grouped shape allocates beyond the routed tokens (ragged: 0)
        "expert_load": {"decisions": 0, "routed_tokens": 0, "experts": 0,
                        "max_tokens": 0, "padded_slots": 0},
        # which constants priced each decision: "seed" = the backend's
        # hand-seeded ones, "calibrated" = fitted by repro_torch.calibration
        "cost_model_source": {"seed": 0, "calibrated": 0},
    }


_DISPATCH_COUNTERS = _fresh_counters()


def dispatch_stats() -> dict:
    """Snapshot of the decision counters plus the plan-cache stats (one
    lock hold, deep-copied).  Reset by :func:`clear_plan_cache`."""
    with _LOCK:
        return {"plan_cache": dict(_CACHE_STATS),
                **copy.deepcopy(_DISPATCH_COUNTERS)}


def clear_plan_cache() -> None:
    global _DISPATCH_COUNTERS
    with _LOCK:
        _PLAN_CACHE.clear()
        _PROGRAM_CACHE.clear()
        _CACHE_STATS.update(hits=0, misses=0, program_hits=0,
                            program_misses=0)
        _DISPATCH_COUNTERS = _fresh_counters()


def load_autotune_table(path: str) -> dict[str, dict[str, dict]]:
    """Load a persisted autotune table (v3/v2 namespaced or v1 flat) into
    the process-level table; returns the parsed ``{backend: {key:
    entry}}`` single-GEMV section."""
    return _AUTOTUNE_TABLE.load(path)


def save_autotune_table(path: str) -> None:
    """Merge this process's per-backend namespaces into the table at
    ``path`` (read, merge, atomic rename)."""
    _AUTOTUNE_TABLE.save(path)


def clear_autotune_table() -> None:
    """Drop every loaded or tuned table entry and put every backend back on
    its seed constants (the plan cache keeps its decisions: clear it too
    to re-resolve)."""
    _AUTOTUNE_TABLE.clear()
    for name in available_backends():
        get_backend(name).reset_calibration()
    with _LOCK:
        # a reloaded table's entry may differ: let a bad one warn again
        _CALIBRATION_WARNED.clear()


def _maybe_apply_calibration(backend) -> str:
    """Apply the table's fitted constants to ``backend``; returns the
    source ("seed" | "calibrated") of the constants that price the next
    decision.  Called on every plan-cache miss, before selection: when the
    table's ``calibration`` section holds an entry for this backend, its
    constants replace the seed's (``with_constants``).  An entry that does
    not validate warns once per backend and is ignored."""
    entry = _AUTOTUNE_TABLE.get_calibration(backend.name)
    if entry is None or not isinstance(entry.get("constants"), dict):
        return backend.cost_model_source
    try:
        cm = backend.seed_cost_model.with_constants(**entry["constants"])
    except (TypeError, ValueError) as e:
        with _LOCK:
            first = backend.name not in _CALIBRATION_WARNED
            _CALIBRATION_WARNED.add(backend.name)
        if first:
            warnings.warn(f"ignoring invalid calibration entry for backend "
                          f"{backend.name!r}: {e}", RuntimeWarning,
                          stacklevel=3)
        return backend.cost_model_source
    if backend.cost_model != cm:
        backend.apply_calibration(cm)
    return "calibrated"


def autotune_table() -> AutotuneTable:
    """The process-level table every dispatch reads."""
    return _AUTOTUNE_TABLE


def record_expert_load(*, routed_tokens: int, experts: int,
                       max_tokens: int, padded_slots: int) -> None:
    """Accumulate one MoE dispatch's per-expert load statistics (host
    integers known from shapes: ``max_tokens`` is the PLANNED bound)."""
    with _LOCK:
        el = _DISPATCH_COUNTERS["expert_load"]
        el["decisions"] += 1
        el["routed_tokens"] += int(routed_tokens)
        el["experts"] += int(experts)
        el["max_tokens"] += int(max_tokens)
        el["padded_slots"] += int(padded_slots)


def _count_decision(backend_name: str, batch: int, policy: DispatchPolicy,
                    *, kernel: str | None = None, mode: str | None = None,
                    program_kernel: str | None = None,
                    source: str = "seed") -> None:
    with _LOCK:
        sources = _DISPATCH_COUNTERS["cost_model_source"]
        sources[source] = sources.get(source, 0) + 1
        for section, name in (("kernel_picks", kernel),
                              ("program_modes", mode),
                              ("program_kernels", program_kernel)):
            if name is not None:
                counts = _DISPATCH_COUNTERS[section]
                k = f"{backend_name}:{name}"
                counts[k] = counts.get(k, 0) + 1
        if batch > policy.batch_threshold:
            _DISPATCH_COUNTERS["matmul_fallback"] += 1
        else:
            _DISPATCH_COUNTERS["gemv_path"] += 1


def _resolve(backend, key: GemvKey, policy: DispatchPolicy,
             device: torch.device) -> tuple[str, GemvPlan | None]:
    """Memoized (kernel, plan) for one shape under one policy: cache ->
    autotune -> table -> cost model.  Table entries stand in for the cost
    model only, so only under an unpinned auto policy: pins and
    ``use_pallas=False`` outrank them.  The autotuner times its candidates
    on synthetic inputs on ``device``."""
    with _LOCK:
        cached = _PLAN_CACHE.get((key, policy))
        if cached is not None:
            _CACHE_STATS["hits"] += 1
            return cached
        _CACHE_STATS["misses"] += 1
    source = _maybe_apply_calibration(backend)
    # two racers compute the same selection; racing tuners may time
    # different winners, and the cache keeps the last (both are valid)
    tuned = policy.kernel == "auto" and policy.use_pallas
    if tuned and policy.autotune:
        decision = backend.autotune_gemv(key, policy=policy,
                                         table=_AUTOTUNE_TABLE,
                                         device=device)
    elif tuned and (entry := _AUTOTUNE_TABLE.get(
            backend.name, key.table_key())) is not None:
        decision = backend.replay_plan(*entry_to_plan(entry), key, policy)
    else:
        decision = backend.select_kernel(
            key.M, key.K, key.batch, bits=key.bits, block=key.block,
            x_bytes=dtype_bytes(key.dtype), policy=policy)
    with _LOCK:
        _PLAN_CACHE[(key, policy)] = decision
    _count_decision(backend.name, key.batch, policy, kernel=decision[0],
                    source=source)
    return decision


def _resolve_program(backend, key: ProgramKey, policy: DispatchPolicy,
                     device: torch.device) -> ProgramPlan:
    """Memoized ProgramPlan for one program shape under one policy: cache
    -> autotune -> table (the ``programs`` section) -> planner, as
    :func:`_resolve`.  ``fuse_programs=False`` outranks table and autotune
    too: it always means the per-request decomposition."""
    with _LOCK:
        cached = _PROGRAM_CACHE.get((key, policy))
        if cached is not None:
            _CACHE_STATS["program_hits"] += 1
            return cached
        _CACHE_STATS["program_misses"] += 1
    source = _maybe_apply_calibration(backend)
    tuned = (policy.kernel == "auto" and policy.use_pallas
             and policy.fuse_programs)
    if tuned and policy.autotune:
        pplan = backend.autotune_program(key, policy=policy,
                                         table=_AUTOTUNE_TABLE,
                                         device=device)
    elif tuned and (entry := _AUTOTUNE_TABLE.get_program(
            backend.name, key.table_key())) is not None:
        pplan = backend.replay_program(entry_to_program_plan(entry), key,
                                       policy)
    else:
        pplan = backend.plan_program(key, policy=policy)
    with _LOCK:
        _PROGRAM_CACHE[(key, policy)] = pplan
    _count_decision(backend.name, key.batch, policy, mode=pplan.mode,
                    program_kernel=(pplan.kernel if pplan.mode == "fused"
                                    else None), source=source)
    return pplan


def _dispatch_request(req: GemvRequest, policy: DispatchPolicy,
                      plan: GemvPlan | None = None) -> torch.Tensor:
    """Execute ONE request: the shared path under every entry point.  A
    caller's ``plan`` is coerced by the backend instead of resolved (no
    cache, no counters: it is the caller's decision)."""
    backend = resolve_backend(policy, req.x.device)
    pw = req.weights
    K, M = pw.shape
    B = req.x.shape[0]
    if req.x.shape[1] != K:
        raise ValueError(f"x {tuple(req.x.shape)} does not match weight "
                         f"(K, M) = {pw.shape}")
    if plan is not None:
        kernel, plan = backend.coerce_plan(plan, M, K, B, pw, policy)
    else:
        key = GemvKey(M=M, K=K, batch=B, bits=pw.bits, block=pw.block,
                      dtype=str(req.x.dtype), backend=backend.name)
        kernel, plan = _resolve(backend, key, policy, req.x.device)
    return backend.execute(kernel, req.x.contiguous(), pw, plan)


def as_packed(weights) -> PackedWeights:
    """Normalize any accepted weight form to :class:`PackedWeights`.

    Accepts a :class:`PackedWeights`, a dense ``[M, K]`` tensor (packed on
    the fly), or a ``(w_q, scales)`` tuple of UNPACKED int8 ``[K, M]``
    codes with ``[K // block, M]`` block scales.  Nibble-packed int4 is
    ambiguous in tuple form (K halves, block doubles, and the decode would
    be silently wrong), so it must come wrapped in PackedWeights.
    """
    if isinstance(weights, PackedWeights):
        return weights
    if isinstance(weights, tuple) and len(weights) == 2:
        w_q, scales = weights
        if w_q.dtype != torch.int8:
            raise ValueError(f"(w_q, scales) tuples must hold unpacked int8 "
                             f"weights, got {w_q.dtype}; wrap other forms "
                             f"in PackedWeights")
        K = w_q.shape[0]
        if (scales.ndim != 2 or scales.shape[1] != w_q.shape[1]
                or K % scales.shape[0]):
            raise ValueError(f"scales {tuple(scales.shape)} do not tile int8 "
                             f"weights {tuple(w_q.shape)} as [K // block, M]")
        return PackedWeights(w_t=w_q, scales=scales, bits=8,
                             block=K // scales.shape[0])
    return pack_weight(weights)


def dispatch_gemv(x: torch.Tensor, weights, *,
                  policy: DispatchPolicy | None = None,
                  plan: GemvPlan | None = None) -> torch.Tensor:
    """Single-GEMV entry point: out[B, M] = x[B, K] @ W.T.

    ``weights`` is anything :func:`as_packed` takes: a
    :class:`PackedWeights` (float or quantized), an int8 ``(w_q, scales)``
    tuple, or a dense ``[M, K]`` tensor (transposed on every call: prepack
    once instead on a hot path).  A ``plan`` bypasses selection: the
    backend coerces it to one of its own kernels.
    """
    return _dispatch_request(GemvRequest(x=x, weights=as_packed(weights)),
                             policy or DEFAULT_POLICY, plan)


def dispatch_dense(x: torch.Tensor, w_t: torch.Tensor, *,
                   policy: DispatchPolicy | None = None) -> torch.Tensor:
    """Dense-layer adapter: x [B, S, d_in] @ w_t [d_in, d_out] -> [B, S,
    d_out].  Model layers store projections K-major already, so this wraps
    without a transpose and flattens (B, S) into the GEMV batch."""
    B, S, d = x.shape
    out = _dispatch_request(
        GemvRequest(x=x.reshape(B * S, d), weights=from_transposed(w_t)),
        policy or DEFAULT_POLICY)
    return out.reshape(B, S, out.shape[-1])


def dispatch_program(program: GemvProgram, *,
                     policy: DispatchPolicy | None = None) -> torch.Tensor:
    """Execute a :class:`GemvProgram`: returns ``[B, sum(Ms)]`` (fused),
    ``[E, C, M]`` (grouped) or ``[T, M]`` (ragged).

    The backend plans the group as one joint launch (a kernel on the
    concatenated weight, an expert kernel or a portable executor), or as
    the per-request decomposition (never for ragged: its split is data).
    """
    policy = policy or DEFAULT_POLICY
    backend = resolve_backend(policy, program.x.device)
    pplan = _resolve_program(backend, program.key(backend.name), policy,
                             program.x.device)
    if pplan.mode == "per_request":
        outs = [_dispatch_request(req, policy)
                for req in program.decompose()]
        if program.kind == "grouped":
            return torch.stack(outs)
        return torch.cat(outs, dim=-1)
    return backend.execute_program(
        dataclasses.replace(program, x=program.x.contiguous()), pplan)


def dispatch_fused(x: torch.Tensor, weights, *,
                   policy: DispatchPolicy | None = None
                   ) -> list[torch.Tensor]:
    """Shared-input projections as one program: ``x`` [B, K], ``weights``
    K-major ``[K, M_i]`` tensors or :class:`PackedWeights`.  The members
    are concatenated here, on every call; hot paths prepack instead
    (:func:`dispatch_prepacked`)."""
    program = GemvProgram.fused(
        x, [w if isinstance(w, PackedWeights) else from_transposed(w)
            for w in weights])
    return program.split(dispatch_program(program, policy=policy))


def dispatch_prepacked(x: torch.Tensor, fused, m_splits, *,
                       policy: DispatchPolicy | None = None
                       ) -> list[torch.Tensor]:
    """Fused program over a PREPACKED ``[K, sum(Ms)]`` weight (the decode
    hot path: the concat was paid once at deployment).  ``fused`` is a
    K-major tensor or a :class:`PackedWeights` (quantized ones included:
    each member takes its columns of the codes and of the scales).  When
    the program runs per request, each member's kernel reads its columns
    in place, as a view with the fused weight's row stride.  Returns the
    per-member ``[B, M_i]`` outputs in order."""
    pw = fused if isinstance(fused, PackedWeights) else from_transposed(fused)
    splits = tuple(int(m) for m in m_splits)
    K, M = pw.shape
    if sum(splits) != M:
        raise ValueError(f"m_splits {splits} do not tile M={M}")
    reqs, off = [], 0
    for i, m in enumerate(splits):
        reqs.append(GemvRequest(x=x, weights=pw.columns(off, off + m),
                                tag=f"m{i}"))
        off += m
    program = GemvProgram(kind="fused", x=x, weights=pw, m_splits=splits,
                          requests=tuple(reqs))
    return program.split(dispatch_program(program, policy=policy))


def dispatch_grouped(xs: torch.Tensor, weights, *,
                     policy: DispatchPolicy | None = None) -> torch.Tensor:
    """Expert group: out[E, C, M] = xs[E, C, K] @ W[E, K, M].  ``weights``
    is a stacked :class:`PackedWeights` or a raw K-major ``[E, K, M]``
    tensor (the layout MoE layers store)."""
    if not isinstance(weights, PackedWeights):
        weights = from_transposed(weights)
    return dispatch_program(GemvProgram.grouped(xs, weights), policy=policy)


def dispatch_ragged(x: torch.Tensor, counts: torch.Tensor, weights, *,
                    bound: int = 0,
                    policy: DispatchPolicy | None = None) -> torch.Tensor:
    """Capacity-free expert group: out[T, M] for ``x [T, K]`` sorted by
    expert with per-expert row ``counts [E]`` (device data, never read on
    the host; rows past their sum come back zero).  ``bound`` is the
    predicted per-expert bound the program is priced at (default T)."""
    if not isinstance(weights, PackedWeights):
        weights = from_transposed(weights)
    program = GemvProgram.ragged(x, counts, weights, bound=bound)
    return dispatch_program(program, policy=policy)
