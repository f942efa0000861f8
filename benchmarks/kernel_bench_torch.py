"""Kernel micro-bench of the PyTorch port: the twin of
``benchmarks/kernel_bench.py`` over ``repro_torch.kernels``.

* kernel rows (the default): the reference's five decode GEMV shapes,
  bf16 and int8, through the dispatcher (``dispatch_gemv``, the
  counterpart of ``ops.placed_gemv``): µs of one call (CUDA events over
  replays of a captured graph on the card), the max abs error against the
  plain product (int8: the reference's relative error against the float
  weight's product), and the H100's HBM bound of the bf16 weight's bytes
  at 3.35 TB/s where the reference modeled the v5e's;
* ``--dispatch``: for each decode GEMV shape of the registry's small
  archs the backend's picked kernel and the modeled µs of every fixed
  kernel, and unless ``--no-measure`` each measured (with its max abs
  error against the plain product, which the reference does not have);
* the program and MoE tables: model-only, as in the reference;
* ``--pipeline-depth``: the h100 kernels' plans at every ring depth the
  card holds (``gemv_plan.with_pipeline_depth``), modeled and measured,
  with the max abs difference between depths (which must be 0); the
  reference has these rows for its ``tpu`` backend only;
* ``--json OUT``: the schema-5 document (``rows``, ``program_rows``,
  ``moe_rows``, ``pipeline_rows``);
* ``--calibrate``: sweep -> fit -> artifact -> activate for one backend
  (``repro_torch.calibration``).

Everything runs on the card unless ``--device cpu`` is given; there the
kernel wrappers run their plain versions and the kernel rows say
``/plain``.  On a host without CUDA and without ``--device cpu`` this
raises.

    python benchmarks/kernel_bench_torch.py                 # all tables
    python benchmarks/kernel_bench_torch.py --dispatch --json bench.json
    PYTHONPATH=src python benchmarks/kernel_bench_torch.py --dispatch \
        --no-measure --backend cpu --device cpu
    python benchmarks/kernel_bench_torch.py --calibrate --backend h100
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.calibration.artifact import (  # noqa: E402
    DEFAULT_OUT_DIR,
    calibrate_backend,
)
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.backends import (  # noqa: E402
    DispatchPolicy,
    ProgramKey,
    get_backend,
)
from repro_torch.kernels.backends.base import (  # noqa: E402
    expert_batch_bound,
    time_gemv_us,
    weight_copies,
)
from repro_torch.kernels.gemv_plan import (  # noqa: E402
    MAX_STAGES,
    with_pipeline_depth,
)
from repro_torch.kernels.ops import pack_weight, quantize_weight  # noqa: E402

SCHEMA_VERSION = 5      # the reference's --json layout
BACKENDS = ("cpu", "h100", "gpu")
H100_HBM_BPS = 3.35e12  # H100 SXM5 data sheet, HBM3

SHAPES = [
    # (name, M, K, B): the reference's decode-path GEMVs
    ("gemma3-1b/ffn_up", 6912, 1152, 1),
    ("gemma3-27b/ffn_up", 21504, 5376, 1),
    ("minitron/qkv", 4096 + 2 * 1024, 4096, 1),
    ("olmo/ffn_down", 2048, 8192, 4),
    ("grok/expert_up", 4096, 6144, 8),
]
DISPATCH_ARCHS = ("gemma3-1b", "olmo-1b", "minitron-8b")
MOE_ARCHS = ("deepseek-moe-16b", "grok-1-314b")
MOE_DECODE_BATCH = 8    # decode tokens a step (one a slot)
MEASURE_BYTES = 256 * 2**20     # the largest weight a measured row reads
# a kernel and the plain product both sum f32 products in other orders
# and the kernel rounds once to bf16: one bf16 ulp of the result
# (relative 2**-7) plus f32 order noise near zero, as chip_smoke.py holds
RTOL, ATOL = 2.0**-7, 1e-3


def bench_device(device=None) -> torch.device:
    """The device the bench runs on: ``device``, else the card; raise where
    there is none (never a quiet fall back to the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel bench runs on the "
                           "card (pass --device cpu for the plain versions)")
    return torch.device("cuda", 0)


def fixed_kernels(backend_name: str) -> tuple[str, ...]:
    """The backend's non-quant kernels (the dispatch rows are float)."""
    return tuple(k for k in get_backend(backend_name).kernels
                 if not k.startswith("quant"))


def _suffix(dev: torch.device) -> str:
    return "" if dev.type == "cuda" else "/plain"


def _inputs(rng, M: int, K: int, B: int, dev, dtype):
    """``w [M, K]`` (unit-scale outputs) and ``x [B, K]`` on ``dev``."""
    w = rng.standard_normal((M, K)).astype(np.float32) / np.sqrt(K)
    x = rng.standard_normal((B, K)).astype(np.float32)
    return (torch.from_numpy(w).to(dev, dtype),
            torch.from_numpy(x).to(dev, dtype))


def _timed_us(x, pw, policy, dev) -> float:
    """µs of one ``dispatch_gemv`` call: replays of a captured graph over
    weight copies read cold on the card, the host clock on the CPU."""
    copies = weight_copies(pw, dev)
    return time_gemv_us(
        lambda i: dispatch.dispatch_gemv(x, copies[i], policy=policy),
        copies=len(copies), device=dev)


def _held(name: str, out: torch.Tensor, plain: torch.Tensor) -> float:
    """Max abs error of ``out`` against ``plain``; raise past the kernel
    tolerance or on a non-finite value."""
    err = (out.float() - plain.float()).abs()
    if not torch.isfinite(out.float()).all() or (
            err > ATOL + RTOL * plain.float().abs()).any():
        raise AssertionError(f"{name}: off the plain product (max abs err "
                             f"{err.max().item():.3e})")
    return err.max().item()


def kernel_rows(device=None, backend_name: str = "h100"
                ) -> list[tuple[str, float, float]]:
    """``(name, us, derived)`` per reference shape: the bf16 GEMV through
    the dispatcher (derived: max abs error against the f32 product of the
    same bf16 values), the H100 HBM bound of its weight bytes, and the
    int8 GEMV (derived: the reference's relative error against the float
    weight's product; held against its plain version too).  Raises where
    a kernel is off its plain version."""
    dev = bench_device(device)
    tag = _suffix(dev)
    policy = DispatchPolicy(backend=backend_name)
    rng = np.random.default_rng(0)
    rows = []
    for name, M, K, B in SHAPES:
        w, x = _inputs(rng, M, K, B, dev, torch.bfloat16)
        pw = pack_weight(w)
        dispatch.clear_plan_cache()
        out = dispatch.dispatch_gemv(x, pw, policy=policy)
        err = _held(f"kernel/{name}/bf16", out, x.float() @ w.float().T)
        rows.append((f"kernel/{name}/bf16{tag}",
                     _timed_us(x, pw, policy, dev), err))
        rows.append((f"kernel/{name}/h100_hbm_bound",
                     M * K * 2 / H100_HBM_BPS * 1e6, 0.0))
        pq = quantize_weight(w.float(), bits=8, block=32)
        oq = dispatch.dispatch_gemv(x, pq, policy=policy)
        _held(f"kernel/{name}/int8", oq, x.float() @ (
            pq.w_t.float().reshape(K // 32, 32, M)
            * pq.scales[:, None]).reshape(K, M))
        full = x.float() @ w.float().T
        rel = ((oq.float() - full).abs().max() / full.abs().max()).item()
        rows.append((f"kernel/{name}/int8{tag}",
                     _timed_us(x, pq, policy, dev), rel))
    return rows


def registry_gemv_shapes(archs=DISPATCH_ARCHS
                         ) -> list[tuple[str, int, int, int]]:
    """Decode-path GEMV shapes (M, K, B) of ``archs``."""
    shapes = []
    for name in archs:
        cfg = get_config(name)
        shapes.append((f"{name}/ffn_up", cfg.d_ff, cfg.d_model, 1))
        shapes.append((f"{name}/ffn_down", cfg.d_model, cfg.d_ff, 1))
        shapes.append((f"{name}/lm_head", cfg.vocab, cfg.d_model, 1))
    return shapes


def dispatch_rows(measure: bool = True, backend_name: str = "h100",
                  device=None, archs=DISPATCH_ARCHS) -> list[dict]:
    """Backend-picked vs fixed-kernel rows per registry shape: the picked
    kernel, the modeled µs of every fixed kernel, and with ``measure``
    each measured (bf16 on the card, f32 on the CPU, as the reference
    measures f32) beside its prediction and its max abs error against
    the plain product.  Raises where a kernel is off it."""
    backend = get_backend(backend_name)
    fixed = fixed_kernels(backend_name)
    dev = bench_device(device) if measure else None
    rng = np.random.default_rng(0)
    rows = []
    for name, M, K, B in registry_gemv_shapes(archs):
        picked, _ = backend.select_kernel(
            M, K, B, policy=DispatchPolicy(backend=backend_name))
        row: dict = {"shape": name, "M": M, "K": K, "B": B,
                     "backend": backend_name, "picked": picked}
        for kern in fixed:
            _, plan = backend.select_kernel(
                M, K, B, policy=DispatchPolicy(backend=backend_name,
                                               kernel=kern))
            row[f"model_us/{kern}"] = backend.estimate_cost_us(
                "ref" if plan is None else kern, M, K, B, plan=plan)
        row["model_us/picked"] = row[f"model_us/{picked}"]
        row["cost_model_source"] = backend.cost_model_source
        if measure and M * K * 4 <= MEASURE_BYTES:
            dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
            w, x = _inputs(rng, M, K, B, dev, dtype)
            pw = pack_weight(w)
            plain = x.float() @ w.float().T
            row["device"] = dev.type
            for kern in ("auto",) + fixed:
                pol = DispatchPolicy(backend=backend_name, kernel=kern)
                dispatch.clear_plan_cache()
                row[f"max_abs_err/{kern}"] = _held(
                    f"dispatch/{name}/{kern}",
                    dispatch.dispatch_gemv(x, pw, policy=pol), plain)
                measured = _timed_us(x, pw, pol, dev)
                row[f"measured_us/{kern}"] = measured
                run_kern, run_plan = backend.select_kernel(
                    M, K, B, x_bytes=x.element_size(), policy=pol)
                predicted = backend.estimate_cost_us(
                    run_kern, M, K, B, x_bytes=x.element_size(),
                    plan=run_plan)
                row[f"predicted_us/{kern}"] = predicted
                row[f"pred_over_measured/{kern}"] = predicted / measured
        rows.append(row)
    return rows


def registry_program_shapes() -> list[tuple]:
    """(name, kind, Ms, K, batch, group): fused QKV and gate+up of the
    dense archs, expert groups of the MoE archs (batch: tokens an expert
    at a decode step)."""
    shapes = []
    for name in ("gemma3-1b", "minitron-8b"):
        cfg = get_config(name)
        hd = cfg.hd
        qkv = (cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_kv_heads * hd)
        shapes.append((f"{name}/qkv", "fused", qkv, cfg.d_model, 1, 3))
        if cfg.act in ("silu", "geglu"):
            shapes.append((f"{name}/gate_up", "fused",
                           (cfg.d_ff, cfg.d_ff), cfg.d_model, 1, 2))
    for name in MOE_ARCHS:
        cfg = get_config(name)
        e = cfg.moe
        shapes.append((f"{name}/expert_up", "grouped", (e.d_expert,),
                       cfg.d_model, 8, e.n_experts))
    return shapes


def program_rows(backend_name: str = "h100") -> list[dict]:
    """The planned program against N independent dispatches per registry
    program shape: mode, launches, modeled µs of both (model-only)."""
    backend = get_backend(backend_name)
    policy = DispatchPolicy(backend=backend_name)
    rows = []
    for name, kind, Ms, K, batch, group in registry_program_shapes():
        key = ProgramKey(kind=kind, Ms=Ms, K=K, batch=batch, group=group,
                         bits=16, block=32, dtype="float32",
                         backend=backend_name)
        pplan = backend.plan_program(key, policy=policy)
        rows.append({
            "shape": name, "kind": kind, "Ms": list(Ms), "K": K,
            "B": batch, "group": group, "backend": backend_name,
            "mode": pplan.mode, "kernel": pplan.kernel or None,
            "launches_program": pplan.n_launches,
            "launches_independent": key.n_requests,
            "model_us/program": backend.estimate_program_cost_us(
                key, mode=pplan.mode),
            "model_us/independent": backend.estimate_program_cost_us(
                key, mode="per_request"),
        })
    return rows


def moe_rows(backend_name: str = "h100") -> list[dict]:
    """Capacity-padded (einsum, grouped) against ragged expert dispatch of
    the MoE archs at a decode step of ``MOE_DECODE_BATCH`` tokens,
    model-only (no expert weights are drawn); ``mode`` is the backend's
    planned mode for the ragged key."""
    from repro_torch.models.layers import _capacity

    backend = get_backend(backend_name)
    policy = DispatchPolicy(backend=backend_name)
    B = MOE_DECODE_BATCH
    rows = []
    for name in MOE_ARCHS:
        cfg = get_config(name)
        e = cfg.moe
        C = _capacity(1, cfg)
        routed = B * e.top_k
        grouped_key = ProgramKey(
            kind="grouped", Ms=(e.d_expert,), K=cfg.d_model, batch=C,
            group=e.n_experts, bits=16, block=32, dtype="float32",
            backend=backend_name)
        ragged_key = ProgramKey(
            kind="ragged", Ms=(e.d_expert,), K=cfg.d_model,
            batch=expert_batch_bound(B, e.top_k, e.n_experts),
            group=e.n_experts, bits=16, block=32, dtype="float32",
            backend=backend_name, tokens=routed)
        pplan = backend.plan_program(ragged_key, policy=policy)
        rows.append({
            "arch": name, "experts": e.n_experts, "top_k": e.top_k,
            "M": e.d_expert, "K": cfg.d_model, "B": B,
            "capacity": C, "routed_tokens": routed,
            "padded_slots": max(B * e.n_experts * C - routed, 0),
            "backend": backend_name, "mode": pplan.mode,
            "model_us/einsum": backend.estimate_program_cost_us(
                grouped_key, mode="per_request"),
            "model_us/grouped": backend.estimate_program_cost_us(
                grouped_key, mode="grouped"),
            "model_us/ragged": backend.estimate_program_cost_us(
                ragged_key, mode="ragged"),
        })
    return rows


def pipeline_rows(backend_name: str = "h100", measure: bool = True,
                  device=None) -> list[dict]:
    """The h100 kernels (``pim``, ``splitk``) at every ring depth their
    plan takes (``with_pipeline_depth``: 1 .. MAX_STAGES slots that fit a
    CTA's shared memory) per registry shape: modeled µs at each depth,
    and with ``measure`` (weights up to ``MEASURE_BYTES`` in bf16) µs of
    each and ``max_abs_diff`` of every depth's output against the
    default plan's, which must be 0 (the tiles, and so the order of the
    sums, stay).  A ring is an h100 plan: other backends return no
    rows."""
    if backend_name != "h100":
        return []
    backend = get_backend("h100")
    dev = bench_device(device) if measure else None
    rng = np.random.default_rng(0)
    rows = []
    for name, M, K, B in registry_gemv_shapes():
        small = M * K * 2 <= MEASURE_BYTES
        if measure and small:
            w, x = _inputs(rng, M, K, B, dev, torch.bfloat16)
            pw = pack_weight(w)
        for kern in ("pim", "splitk"):
            _, base = backend.select_kernel(
                M, K, B, policy=DispatchPolicy(backend="h100", kernel=kern))
            if base is None:
                continue        # the kernel does not apply at this shape
            plans = {d: p for d in range(1, MAX_STAGES + 1)
                     if (p := with_pipeline_depth(base, d, batch=B))
                     is not None}
            row = {"shape": name, "kernel": kern, "M": M, "K": K, "B": B,
                   "backend": "h100", "default_depth": base.stages,
                   "depths": sorted(plans)}
            for d, p in plans.items():
                row[f"model_us/depth{d}"] = backend.estimate_cost_us(
                    kern, M, K, B, plan=p)
            if measure and small:
                row["device"] = dev.type
                want = backend.execute(kern, x, pw, base)
                diff = 0.0
                for d, p in plans.items():
                    copies = weight_copies(pw, dev)
                    row[f"measured_us/depth{d}"] = time_gemv_us(
                        lambda i, p=p: backend.execute(kern, x, copies[i],
                                                       p),
                        copies=len(copies), device=dev)
                    got = backend.execute(kern, x, pw, p)
                    diff = max(diff, (got.float() - want.float()).abs()
                               .max().item())
                    if diff != 0:
                        raise AssertionError(
                            f"{name} {kern} depth {d}: differs from the "
                            f"default depth {base.stages} (max abs diff "
                            f"{diff:.3e})")
                row["max_abs_diff"] = diff
            rows.append(row)
    return rows


def print_kernel_rows(rows) -> None:
    for name, us, derived in rows:
        print(f"{name},{us:.3f},{derived:.6f}")


def print_dispatch_table(rows: list[dict]) -> None:
    for r in rows:
        fixed = fixed_kernels(r["backend"])
        fixed_s = " ".join(f"{k}={r[f'model_us/{k}']:.1f}us" for k in fixed)
        line = (f"dispatch/{r['shape']} [{r['M']}x{r['K']} B={r['B']}] "
                f"backend={r['backend']} picked={r['picked']} "
                f"model={r['model_us/picked']:.1f}us | fixed: {fixed_s}")
        if "measured_us/auto" in r:
            meas = " ".join(f"{k}={r[f'measured_us/{k}']:.1f}us"
                            for k in ("auto",) + fixed)
            err = max(r[f"max_abs_err/{k}"] for k in ("auto",) + fixed)
            line += (f" | measured ({r['device']}): {meas} max_abs_err="
                     f"{err:.2e} | pred/meas(auto)="
                     f"{r['pred_over_measured/auto']:.2f} "
                     f"[{r['cost_model_source']}]")
        print(line)


def print_program_table(rows: list[dict]) -> None:
    for r in rows:
        ms = "+".join(str(m) for m in r["Ms"])
        print(f"program/{r['shape']} [{r['kind']} {ms}x{r['K']} B={r['B']} "
              f"e={r['group']}] backend={r['backend']} mode={r['mode']} "
              f"launches={r['launches_program']} "
              f"(vs {r['launches_independent']} independent) "
              f"model={r['model_us/program']:.1f}us "
              f"(vs {r['model_us/independent']:.1f}us)")


def print_moe_table(rows: list[dict]) -> None:
    for r in rows:
        print(f"moe/{r['arch']} [{r['M']}x{r['K']} E={r['experts']} "
              f"k={r['top_k']} B={r['B']} cap={r['capacity']}] "
              f"backend={r['backend']} mode={r['mode']} "
              f"einsum={r['model_us/einsum']:.1f}us "
              f"grouped={r['model_us/grouped']:.1f}us "
              f"ragged={r['model_us/ragged']:.1f}us "
              f"(padded_slots={r['padded_slots']})")


def print_pipeline_table(rows: list[dict]) -> None:
    for r in rows:
        model = " ".join(f"d{d}={r[f'model_us/depth{d}']:.1f}us"
                         for d in r["depths"])
        line = (f"pipeline/{r['shape']} [{r['M']}x{r['K']} B={r['B']}] "
                f"{r['kernel']} (default d{r['default_depth']}) model "
                f"{model}")
        if "max_abs_diff" in r:
            meas = " ".join(f"d{d}={r[f'measured_us/depth{d}']:.1f}us"
                            for d in r["depths"])
            line += (f" | measured ({r['device']}) {meas} "
                     f"max_abs_diff={r['max_abs_diff']:.1g}")
        print(line)


def run_calibrate(args) -> int:
    """The --calibrate mode: sweep -> fit -> artifact -> activate.  One
    command, exit 0 on success."""
    doc = calibrate_backend(
        args.backend, smoke=args.smoke, trials=args.trials,
        out_dir=args.out_dir, table_path=args.table, device=args.device,
    )
    print(f"calibrate/{doc['backend']}: {doc['n_records']} records, "
          f"mape={doc['mape']:.3f} (seed {doc['seed_mape']:.3f})"
          + (" [degenerate]" if doc["degenerate"] else ""))
    for kern, err in sorted(doc["per_kernel_mape"].items()):
        print(f"calibrate/{doc['backend']}/{kern}: mape={err:.3f}")
    for term, val in sorted(doc["fitted"].items()):
        print(f"calibrate/{doc['backend']}/fit {term}={val:.6g}")
    print(f"wrote calibration artifact -> {doc['path']}")
    if args.table:
        print(f"merged calibration section -> {args.table}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dispatch", action="store_true",
                    help="only the dispatcher-vs-fixed comparison (and the "
                         "model-only program and MoE tables)")
    ap.add_argument("--backend", default="h100", choices=BACKENDS,
                    help="GemvBackend whose cost model and kernels to "
                         "compare (or, with --calibrate, to fit)")
    ap.add_argument("--no-measure", action="store_true",
                    help="skip measured times (model only)")
    ap.add_argument("--pipeline-depth", action="store_true",
                    help="also print the ring-depth sweep of the h100 "
                         "kernels; the rows are always in the --json "
                         "document")
    ap.add_argument("--json", metavar="OUT", default=None,
                    help="write the schema-5 document")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card; cpu "
                         "runs the plain versions)")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure + fit this backend's CostModel constants "
                         "and write <out-dir>/<backend>.json")
    ap.add_argument("--smoke", action="store_true",
                    help="with --calibrate: the small sweep tier")
    ap.add_argument("--trials", type=int, default=0,
                    help="with --calibrate: timed trials per record (0 = "
                         "tier default)")
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                    help=f"with --calibrate: artifact directory (default "
                         f"{DEFAULT_OUT_DIR})")
    ap.add_argument("--table", default=None,
                    help="with --calibrate: also merge the fitted constants "
                         "into this v3 autotune table")
    args = ap.parse_args(argv)
    if args.calibrate:
        return run_calibrate(args)
    measure = not args.no_measure
    if measure or not args.dispatch:
        bench_device(args.device)           # raise before any table
    if not args.dispatch:
        print_kernel_rows(kernel_rows(args.device, args.backend))
    rows = dispatch_rows(measure, args.backend, args.device)
    print_dispatch_table(rows)
    prog_rows = program_rows(args.backend)
    print_program_table(prog_rows)
    m_rows = moe_rows(args.backend)
    print_moe_table(m_rows)
    p_rows = []
    if args.pipeline_depth or args.json:
        p_rows = pipeline_rows(args.backend, measure, args.device)
    if args.pipeline_depth:
        print_pipeline_table(p_rows)
    if args.json:
        doc = {"schema": SCHEMA_VERSION, "rows": rows,
               "program_rows": prog_rows, "moe_rows": m_rows,
               "pipeline_rows": p_rows}
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        print(f"wrote {len(rows)} + {len(prog_rows)} + {len(m_rows)} "
              f"+ {len(p_rows)} records -> {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
