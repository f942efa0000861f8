"""Synthetic multi-tenant serving trace (counterpart of
``repro/serving/bench.py``).

Drives the port's :class:`~repro_torch.serving.engine.Engine` with a seeded
workload -- mixed prompt lengths, Poisson arrivals in units of engine steps,
and with ``kind="shared-prefix"`` a Zipf mixture of tenants whose prompts
share a system prefix -- once per scheduler policy, and emits one JSON
document with TTFT / per-token-latency percentiles, throughput, the
dispatcher's decision counters and, with the prefix cache on, its hit rate
and segment store per run.

Runs on the CUDA card unless ``device="cpu"`` is given; ``reduced=True``
(the default, as in the JAX bench) serves the config's ``reduced()`` form,
``reduced=False`` the published widths and depth.

``async_prefill=True`` (``--async-prefill``) serves every run with the
engine's overlapped prefill (``Engine(async_prefill=True)``); the runs and
the document say so, and a traced run's ``hidden_fraction`` is the share
of the chains' issue-to-harvest time the host did not wait for.

``trace_out=PATH`` (``--trace-out``) flight-records the last policy's run
(``repro_torch.observability``): a Perfetto-loadable Chrome trace at
``PATH`` and the schema-1 summary beside it (``export.summary_path``),
with each fresh dispatch decision timed on the run's device unless
``trace_timing=False`` (``--no-trace-timing``).

    python -m repro_torch.serving.bench --smoke --device cpu
    python -m repro_torch.serving.bench --trace shared-prefix --prefix-cache \\
        --prefill-chunk 128 --full-size --json serve.json
    python -m repro_torch.serving.bench --trace shared-prefix --prefix-cache \\
        --trace-out TRACE.json
    python -m repro_torch.serving.bench --smoke --device cpu --mesh 1x2

``mesh_shape=(d, m)`` (``--mesh DxM``) serves every run on a ``(data,
model)`` mesh of ``d * m`` ranks started by ``launch.mesh.spawn`` (on the
card: one rank a card under NCCL, or ranks sharing the card over gloo;
``--device cpu``: gloo on the CPU); the document is rank 0's, each run
records the mesh and ``overlap_collectives`` and its dispatch counters
carry the per-shard sections (``sharded_axes``, ``shard_picks``: the
kernel each rank's block of a weight selected, by that block's shape).
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models import lm
from repro_torch.observability import export
from repro_torch.observability.trace import Tracer, uninstall_tracer
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.scheduler import POLICIES, QueueFull

# --json document version, the JAX bench's numbering: v4 is its layout
# (the per-run ``mesh`` record and ``overlap_collectives``); the port adds
# ``device``, ``reduced`` and ``prefill_chunk``.  As in the reference, tracing and overlapped serving
# are additive, not a schema bump: ``trace_out`` adds the
# ``flight_trace`` section (its files carry their own schema,
# ``repro_torch.observability.SCHEMA_VERSION``) with the summary's
# ``hidden_fraction``, and every run and the document carry
# ``async_prefill``.
SCHEMA_VERSION = 4

TRACE_KINDS = ("uniform", "shared-prefix")


@dataclass(frozen=True)
class TraceConfig:
    n_requests: int = 24
    arrival_rate: float = 1.5       # mean arrivals per engine step (Poisson)
    prompt_len_range: tuple[int, int] = (4, 24)   # inclusive
    max_new_range: tuple[int, int] = (4, 12)
    eos_ids: tuple[int, ...] = ()   # stop set (empty: none)
    seed: int = 0
    # "uniform": i.i.d. random prompts.  "shared-prefix": each tenant owns
    # one seeded system prefix (length from prefix_len_range), tenants are
    # picked Zipf(zipf_a) per request, and the prompt is that prefix plus
    # a private suffix (prompt_len_range).
    kind: str = "uniform"
    n_tenants: int = 4
    zipf_a: float = 1.5
    prefix_len_range: tuple[int, int] = (8, 16)

    def __post_init__(self):
        if self.kind not in TRACE_KINDS:
            raise ValueError(f"unknown trace kind {self.kind!r}; "
                             f"expected one of {TRACE_KINDS}")

    @classmethod
    def smoke(cls, **kw) -> "TraceConfig":
        if kw.get("kind") == "shared-prefix":
            base = dict(n_requests=16, arrival_rate=0.6,
                        prompt_len_range=(2, 6), max_new_range=(3, 5),
                        n_tenants=3, prefix_len_range=(16, 24))
            base.update(kw)
            return cls(**base)
        return cls(n_requests=10, arrival_rate=4.0,
                   prompt_len_range=(2, 10), max_new_range=(3, 5), **kw)


def build_trace(tcfg: TraceConfig, vocab: int,
                rng: np.random.Generator) -> list[dict]:
    """[{arrival_step, prompt, max_new_tokens, eos_ids, tenant}]: arrivals
    are cumulative exponential gaps from the caller's seeded rng (the JAX
    bench's draws, in its order)."""
    lo, hi = tcfg.prompt_len_range
    nlo, nhi = tcfg.max_new_range
    prefixes, weights = [], None
    if tcfg.kind == "shared-prefix":
        plo, phi = tcfg.prefix_len_range
        prefixes = [
            rng.integers(0, vocab,
                         int(rng.integers(plo, phi + 1))).astype(np.int32)
            for _ in range(tcfg.n_tenants)
        ]
        w = 1.0 / np.arange(1, tcfg.n_tenants + 1) ** tcfg.zipf_a
        weights = w / w.sum()
    t = 0.0
    out = []
    for _ in range(tcfg.n_requests):
        t += rng.exponential(1.0 / tcfg.arrival_rate)
        plen = int(rng.integers(lo, hi + 1))
        prompt = rng.integers(0, vocab, plen).astype(np.int32)
        tenant = None
        if tcfg.kind == "shared-prefix":
            tenant = int(rng.choice(tcfg.n_tenants, p=weights))
            prompt = np.concatenate([prefixes[tenant], prompt])
        out.append({
            "arrival_step": int(t),
            "prompt": prompt,
            "max_new_tokens": int(rng.integers(nlo, nhi + 1)),
            "eos_ids": tuple(tcfg.eos_ids),
            "tenant": tenant,
        })
    return out


def run_policy(cfg, params, policy: str, trace: list[dict], *,
               batch_slots: int, max_len: int, gemv_batch_threshold: int,
               gemv_backend: str | None = None, max_queue: int = 0,
               prefill_chunk: int | None = None,
               async_prefill: bool = False, prefix_cache=False,
               kv_store: str = "fp", tracer: Tracer | None = None,
               tokens: bool = False, max_iters: int = 5000, mesh=None,
               overlap_collectives: bool = False) -> dict:
    """Serve one trace under one scheduler policy on ``params``' device;
    returns the metrics document (aggregates only) tagged with the run's
    configuration, and with ``tokens`` each finished request's tokens
    (``generated``, by request id).

    ``tracer`` flight-records this run (the engine's spans and the
    dispatcher's per-decision attribution) and is uninstalled before
    returning, so a traced run never leaks recording into later runs."""
    dispatch.clear_plan_cache()  # attribute dispatch decisions to this run
    eng = Engine(cfg, params, batch_slots=batch_slots, max_len=max_len,
                 gemv_batch_threshold=gemv_batch_threshold,
                 gemv_backend=gemv_backend, scheduler=policy,
                 max_queue=max_queue, prefill_chunk=prefill_chunk,
                 async_prefill=async_prefill,
                 prefix_cache=prefix_cache, kv_store=kv_store,
                 device=params["embed"].device, tracer=tracer, mesh=mesh,
                 overlap_collectives=overlap_collectives)
    pending = [
        Request(rid=i, prompt=t["prompt"],
                max_new_tokens=t["max_new_tokens"],
                eos_ids=(set(t["eos_ids"]) if t.get("eos_ids") else None))
        for i, t in enumerate(trace)
    ]
    arrivals = [t["arrival_step"] for t in trace]
    done, retry = [], []
    try:
        for step_i in range(max_iters):
            due, retry = retry, []
            while pending and arrivals[0] <= step_i:
                due.append(pending.pop(0))
                arrivals.pop(0)
            for req in due:
                try:
                    eng.submit(req)
                except QueueFull:
                    retry.append(req)  # backpressure: retry next step
            done.extend(eng.step())
            if (not pending and not retry and not eng.active
                    and not eng._prefilling and not eng.scheduler.queue):
                break
    finally:
        if tracer is not None:
            uninstall_tracer(tracer)
    doc = eng.metrics.to_dict(include_steps=False)
    doc.update(
        policy=policy,
        batch_slots=batch_slots,
        gemv_batch_threshold=gemv_batch_threshold,
        async_prefill=bool(async_prefill),
        completed=len(done),
        total_generated=sum(len(r.generated) for r in done),
        kv_store=kv_store,
        prefill_chunk=prefill_chunk,
        prefix_index=(eng.prefix.stats() if eng.prefix is not None
                      else None),
        mesh=None if mesh is None else dict(mesh.shape),
        overlap_collectives=bool(overlap_collectives),
    )
    if tokens:
        doc["generated"] = {str(r.rid): list(r.generated) for r in done}
    return doc


def dispatch_docs(tracer: Tracer) -> list[dict]:
    """The tracer's dispatch records, one JSON document each (the summary's
    ``dispatches``, which the reference's lacks: the drift report's
    per-decision rows, with the batch and the device trials)."""
    return [{"backend": r.backend, "kind": r.kind, "kernel": r.kernel,
             "shape": r.shape, "predicted_us": r.predicted_us,
             "measured_us": r.measured_us,
             "trials_us": list(r.trials_us) if r.trials_us else None,
             "source": r.source, "attrs": dict(r.attrs)}
            for r in list(tracer.dispatches)]


def run_serve_trace(
    arch: str = "olmo-1b", *,
    policies: tuple[str, ...] = ("fcfs", "sjf", "gemv_aware"),
    smoke: bool = False,
    seed: int = 0,
    batch_slots: int = 8,
    max_len: int = 96,
    gemv_batch_threshold: int = 4,
    gemv_backend: str | None = None,
    prefill_chunk: int | None = None,
    async_prefill: bool = False,
    trace_kind: str = "uniform",
    prefix_cache=False,
    kv_store: str = "fp",
    trace_config: TraceConfig | None = None,
    reduced: bool = True,
    device=None,
    trace_out: str | None = None,
    trace_timing: bool | None = None,
    tokens: bool = False,
    out: str | None = None,
    mesh_shape: tuple[int, int] | None = None,
    overlap_collectives: bool = False,
    mesh=None,
) -> dict:
    """Serve one synthetic trace under each policy; returns (and with
    ``out`` writes) the comparison document.  Weights are random from
    ``seed`` 0 on ``device`` (the card unless ``"cpu"`` is given).

    ``trace_out=PATH`` flight-records the last policy's run (the plan
    cache is cleared per run, so every decision of the traced run lands
    in the record) and writes the Chrome trace to ``PATH`` and the
    summary to ``export.summary_path(PATH)`` (with the reference's fields
    and each decision's record, :func:`dispatch_docs`); the document gains
    a ``flight_trace`` section pointing at both.  ``trace_timing`` (default
    on with ``trace_out``) times each fresh decision's kernel on the
    run's device beside its predicted price.  ``tokens`` keeps each
    run's tokens (:func:`run_policy`).

    ``mesh_shape=(d, m)`` runs this function on each rank of a ``(data,
    model)`` mesh (``launch.mesh.spawn``, ``device`` as above) and returns
    rank 0's document (written to ``out`` here); a rank receives its
    ``mesh``.  Only rank 0 traces."""
    if mesh_shape is not None and mesh is None:
        from repro_torch.launch.mesh import spawn

        # every argument but the launcher's own, for each rank's call
        kw = {k: v for k, v in locals().items()
              if k not in ("mesh_shape", "mesh", "out", "spawn")}
        doc = spawn(_serve_rank, tuple(mesh_shape), device=device,
                    timeout_s=3600, kwargs=kw)[0]
        if out:
            with open(out, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
        return doc
    dev = resolve_device(device if mesh is None else mesh.device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    params = lm.init_lm(cfg, seed=0, device=dev, mesh=mesh)
    if smoke:
        batch_slots = min(batch_slots, 4)
        gemv_batch_threshold = min(gemv_batch_threshold, 2)
        tcfg = trace_config or TraceConfig.smoke(kind=trace_kind)
    else:
        tcfg = trace_config or TraceConfig(kind=trace_kind)
    tcfg = TraceConfig(**{**tcfg.__dict__, "seed": seed})
    trace = build_trace(tcfg, cfg.vocab, np.random.default_rng(tcfg.seed))
    tracer = None
    if trace_out and (mesh is None or mesh.rank == 0):
        tracer = Tracer(timing=True if trace_timing is None
                        else bool(trace_timing))
    runs = [run_policy(cfg, params, policy, trace, batch_slots=batch_slots,
                       max_len=max_len,
                       gemv_batch_threshold=gemv_batch_threshold,
                       gemv_backend=gemv_backend,
                       prefill_chunk=prefill_chunk,
                       async_prefill=async_prefill,
                       prefix_cache=prefix_cache, kv_store=kv_store,
                       tracer=tracer if i == len(policies) - 1 else None,
                       tokens=tokens, mesh=mesh,
                       overlap_collectives=overlap_collectives)
            for i, policy in enumerate(policies)]
    shared = tcfg.kind == "shared-prefix"
    doc = {
        "schema": SCHEMA_VERSION,
        "arch": arch,
        "reduced": bool(reduced),
        "device": str(dev),
        "trace": {
            "kind": tcfg.kind,
            "n_requests": tcfg.n_requests,
            "arrival_rate": tcfg.arrival_rate,
            "prompt_len_range": list(tcfg.prompt_len_range),
            "max_new_range": list(tcfg.max_new_range),
            "eos_ids": list(tcfg.eos_ids),
            "seed": tcfg.seed,
            "n_tenants": tcfg.n_tenants if shared else None,
            "zipf_a": tcfg.zipf_a if shared else None,
            "prefix_len_range": (list(tcfg.prefix_len_range) if shared
                                 else None),
        },
        "prefix_cache": bool(prefix_cache),
        "kv_store": kv_store,
        "prefill_chunk": prefill_chunk,
        "async_prefill": bool(async_prefill),
        "mesh": None if mesh is None else dict(mesh.shape),
        "overlap_collectives": bool(overlap_collectives),
        "runs": runs,
    }
    if tracer is not None:
        export.write_chrome_trace(tracer, trace_out)
        spath = export.summary_path(trace_out)
        sdoc = export.write_summary(
            tracer, spath, extra={"arch": arch, "policy": policies[-1],
                                  "run": runs[-1] if runs else None,
                                  "dispatches": dispatch_docs(tracer)})
        doc["flight_trace"] = {
            "path": trace_out,
            "summary": spath,
            "policy": policies[-1],
            "timing": tracer.timing,
            "hidden_fraction": (sdoc.get("overlap") or {}).get(
                "hidden_fraction"),
        }
    if out and (mesh is None or mesh.rank == 0):
        with open(out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
    return doc


def _serve_rank(mesh, **kw) -> dict:
    """One rank of a mesh run of :func:`run_serve_trace`."""
    return run_serve_trace(mesh=mesh, **kw)


def summary_line(run: dict) -> str:
    """One line per run: completions, TTFT, per-token latency, throughput,
    the dispatch mix and the prefix cache's hits."""
    ttft, ptok, disp = run["ttft_ms"], run["per_token_ms"], run["dispatch"]
    nan = float("nan")
    mesh = run.get("mesh")
    line = (f"serve/{run['policy']} slots={run['batch_slots']} "
            f"thresh={run['gemv_batch_threshold']} kv={run['kv_store']} "
            f"chunk={run['prefill_chunk']}"
            f"{' async' if run.get('async_prefill') else ''}"
            f"{f' mesh={mesh}' if mesh else ''}"
            f"{' overlap' if run.get('overlap_collectives') else ''}: "
            f"completed={run['completed']} "
            f"ttft p50={ttft.get('p50', nan):.1f}ms "
            f"p99={ttft.get('p99', nan):.1f}ms | "
            f"tok p50={ptok.get('p50', nan):.2f}ms "
            f"p99={ptok.get('p99', nan):.2f}ms | "
            f"{run['tokens_per_s']:.1f} tok/s | "
            f"dispatch gemv={disp['gemv_path']} "
            f"matmul_fallback={disp['matmul_fallback']}")
    pc = run.get("prefix_cache")
    if pc:
        line += (f" | prefix hit_rate={pc['hit_rate']:.2f} "
                 f"saved={pc['prefill_tokens_saved']}tok "
                 f"ttft(hit/miss) p50="
                 f"{pc['ttft_hit_ms'].get('p50', nan):.1f}/"
                 f"{pc['ttft_miss_ms'].get('p50', nan):.1f}ms")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.bench",
        description="Serve a synthetic multi-tenant trace through the "
                    "port's Engine, one run per scheduler policy.")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--policy", choices=POLICIES, action="append",
                    help="repeatable; default: every policy")
    ap.add_argument("--trace", choices=TRACE_KINDS, default="uniform")
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--async-prefill", action="store_true",
                    help="overlapped prefill: every miss through the "
                         "chunk chain, on a side stream on the card")
    ap.add_argument("--kv-store", choices=("fp", "int8", "int4"),
                    default="fp")
    ap.add_argument("--gemv-backend", default=None)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--threshold", type=int, default=4,
                    help="gemv_batch_threshold")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--full-size", action="store_true",
                    help="the published widths and depth, not reduced()")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run here")
    ap.add_argument("--json", default=None, help="write the document here")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve on a (data, model) mesh of D*M ranks")
    ap.add_argument("--overlap-collectives", action="store_true",
                    help="defer each decode layer's FFN all-reduce by one "
                         "layer (with --mesh)")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="flight-record the last policy's run: the "
                         "Perfetto-loadable Chrome trace to PATH, the "
                         "summary beside it")
    ap.add_argument("--trace-timing", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="time each fresh dispatch decision's kernel on the "
                         "run's device (default: on with --trace-out)")
    a = ap.parse_args(argv)
    mesh_shape = None
    if a.mesh:
        from repro_torch.launch.mesh import parse_mesh_arg

        mesh_shape = parse_mesh_arg(a.mesh)
    doc = run_serve_trace(
        a.arch, policies=tuple(a.policy or POLICIES), smoke=a.smoke,
        seed=a.seed, batch_slots=a.slots, max_len=a.max_len,
        gemv_batch_threshold=a.threshold, gemv_backend=a.gemv_backend,
        prefill_chunk=a.prefill_chunk, async_prefill=a.async_prefill,
        trace_kind=a.trace,
        prefix_cache=a.prefix_cache, kv_store=a.kv_store,
        reduced=not a.full_size, device=a.device, trace_out=a.trace_out,
        trace_timing=a.trace_timing, out=a.json, mesh_shape=mesh_shape,
        overlap_collectives=a.overlap_collectives)
    for run in doc["runs"]:
        print(summary_line(run))
    if "flight_trace" in doc:
        ft = doc["flight_trace"]
        print(f"flight trace ({ft['policy']}): {ft['path']}, summary "
              f"{ft['summary']}, hidden_fraction {ft['hidden_fraction']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
