#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  -- the card's name, count, and ``nvidia-smi`` name / power limit;
2. build   -- every CUDA source of the port, one ``nvcc`` each, in parallel;
3. kernels -- each hand-written kernel at olmo-1b's decode GEMV shapes and
   batch 1, 4, 8 in bf16: held against its plain PyTorch version, then
   timed (CUDA graph of many launches, weight copies rotated past the
   50 MB L2) beside its bound, the plain version and ``torch.matmul``;
4. engine  -- olmo-1b at full width, bf16, seeded random weights, through
   ``Engine(batch_slots=8, max_len=1024)``: 8 requests with prompts of 32
   to 512 tokens, 64 greedy tokens each; fails unless every kernel
   launched during the run;
5. logits  -- one decode step of the same engine state through the
   dispatcher and through ``torch.matmul`` (policy pinned to ``ref``);
6. the ``{"kernels": [...]}`` line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

A fuller report goes to ``chiprun_out/chip_smoke.json``.  Nothing here
imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build, dispatch  # noqa: E402
from repro_torch.kernels.backends import DispatchPolicy  # noqa: E402
from repro_torch.kernels.gemv_plan import (  # noqa: E402
    plan_gemv,
    plan_splitk,
    valid_splitk_degree,
)
from repro_torch.kernels.pim_gemv import pim_gemv, pim_gemv_plain  # noqa
from repro_torch.kernels.splitk_gemv import (  # noqa: E402
    splitk_gemv,
    splitk_gemv_plain,
)
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # H100 SXM data sheet, dense bf16
L2_BYTES = 50 * 2**20
# A kernel and its plain version both sum f32 products, in other orders,
# and round once to bf16: they may differ by one bf16 ulp of the result
# (relative 2**-7 at worst) plus f32 order noise near zero.
KERNEL_RTOL, KERNEL_ATOL = 2.0**-7, 1e-3
BATCHES = (1, 4, 8)
SEED = 0

# olmo-1b's decode GEMVs (K, M) and how many run per decode step
SHAPES = {
    "qkv": (2048, 6144, 16),
    "gate_up": (2048, 16384, 16),
    "down": (8192, 2048, 16),
    "head": (2048, 50304, 1),
}

KERNELS = {
    "pim_gemv": dict(
        fn=pim_gemv, plain=pim_gemv_plain,
        source="src/repro_torch/csrc/pim_gemv.cu",
        replaces="src/repro/kernels/pim_gemv.py:81"),
    "splitk_gemv": dict(
        fn=splitk_gemv, plain=splitk_gemv_plain,
        source="src/repro_torch/csrc/splitk_gemv.cu",
        replaces="src/repro/kernels/splitk_gemv.py:72"),
}


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def reset_launches() -> None:
    for k in KERNELS.values():
        k["fn"].launches = 0


def launches() -> dict[str, int]:
    return {name: k["fn"].launches for name, k in KERNELS.items()}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions, and their times
# ---------------------------------------------------------------------------


def graph_ms(fn, calls: int) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph,
    replayed after a warm replay, timed with CUDA events."""
    fn(0)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(calls):
            fn(i)
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def plan_for(name: str, K: int, M: int, B: int):
    if name == "pim_gemv":
        return plan_gemv(M, K, B, elem_bytes=2), None
    deg = valid_splitk_degree(K)
    if deg is None:
        return None, f"no split-K degree divides K={K}"
    return plan_splitk(M, K, B, degree=deg, elem_bytes=2), None


def check_kernels(dev) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for shape, (K, M, per_step) in SHAPES.items():
        w_bytes = K * M * 2
        n_copies = max(2, math.ceil(2 * L2_BYTES / w_bytes) + 1)
        ws = [(torch.randn((K, M), generator=gen, device=dev)
               / math.sqrt(K)).to(torch.bfloat16) for _ in range(n_copies)]
        for B in BATCHES:
            x = torch.randn((B, K), generator=gen, device=dev).to(
                torch.bfloat16)
            for name, k in KERNELS.items():
                plan, why = plan_for(name, K, M, B)
                if plan is None:
                    log(f"  skip {name} {shape} B={B}: {why}")
                    continue
                out = k["fn"](x, ws[0], plan=plan)
                torch.cuda.synchronize()
                args = (ws[0], plan.split_k) if name == "splitk_gemv" \
                    else (ws[0],)
                ref = k["plain"](x, *args)
                err = (out.float() - ref.float()).abs()
                bad = err > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()
                if not torch.isfinite(out.float()).all() or bad.any():
                    raise AssertionError(
                        f"{name} {shape} B={B}: {int(bad.sum())} elements "
                        f"off its plain version (max abs err "
                        f"{err.max().item():.3e})")
                calls = 100 if w_bytes < 100e6 else 40

                def run(i, fn=k["fn"], plan=plan):
                    fn(x, ws[i % n_copies], plan=plan)

                def run_plain(i, plain=k["plain"], deg=plan.split_k,
                              name=name):
                    w = ws[i % n_copies]
                    if name == "splitk_gemv":
                        plain(x, w, deg)
                    else:
                        plain(x, w)

                def run_lib(i):
                    torch.matmul(x, ws[i % n_copies])

                io_bytes = (K * M + B * K + B * M) * 2
                row = dict(
                    kernel=name, shape=shape, K=K, M=M, B=B,
                    per_step=per_step, plan=dict(
                        m_blk=plan.m_blk, k_blk=plan.k_blk,
                        split_k=plan.split_k, ctas=plan.n_m * plan.split_k),
                    max_abs_err=err.max().item(),
                    ms=graph_ms(run, calls),
                    plain_ms=graph_ms(run_plain, max(calls // 4, 10)),
                    library_ms=graph_ms(run_lib, calls),
                    bytes_ms=io_bytes / HBM_BYTES_PER_S * 1e3,
                    ops_ms=2 * B * K * M / BF16_FLOPS * 1e3)
                row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
                row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                                   else "operations")
                row["hbm_share"] = row["bound_ms"] / row["ms"]
                rows.append(row)
                log(f"  {name:12s} {shape:8s} B={B} err={row['max_abs_err']:.2e}"
                    f" ms={row['ms']:.4f} bound={row['bound_ms']:.4f}"
                    f" ({row['hbm_share']:.0%}) plain={row['plain_ms']:.4f}"
                    f" matmul={row['library_ms']:.4f}")
        del ws
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4 / 5: the engine
# ---------------------------------------------------------------------------


def prompts(vocab: int, lengths, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def serve(cfg, params, dev, lengths, new_tokens, seed) -> tuple:
    eng = Engine(cfg, params, batch_slots=8, max_len=1024, device=dev)
    for i, p in enumerate(prompts(cfg.vocab, lengths, seed)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens))
    return eng


def profile_decode(eng, step_ms: float, steps: int = 3) -> dict | None:
    """Device time of a few decode steps by kernel name (torch.profiler);
    None when the profiler reports no device time here.  The idle share
    is taken against ``step_ms``, the unprofiled per-token p50 (the
    profiler's own overhead inflates the host time of the traced steps)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    on_card = [e for e in avgs if str(e.device_type).endswith("CUDA")]
    by_name = sorted(((e.key, e.self_device_time_total / 1e3) for e in on_card
                      if e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in by_name)
    if busy_ms <= 0:
        return None
    per_step = busy_ms / steps
    # host side: the ATen ops the Python loop issues, by self CPU time
    # (inflated by the profiler itself; read for the ranking and counts)
    aten = sorted((e for e in avgs if e.key.startswith("aten::")),
                  key=lambda e: -e.self_cpu_time_total)
    return {"steps": steps, "device_busy_ms_per_step": per_step,
            "step_ms": step_ms,
            "device_idle_share": max(0.0, 1 - per_step / step_ms),
            "kernels_per_step": sum(e.count for e in on_card) / steps,
            "aten_ops_per_step": sum(e.count for e in aten) / steps,
            "top": [{"name": n[:120], "ms_per_step": ms / steps}
                    for n, ms in by_name[:20]],
            "top_host": [{"name": e.key, "calls_per_step": e.count / steps,
                          "self_cpu_ms_per_step":
                              e.self_cpu_time_total / 1e3 / steps}
                         for e in aten[:12]]}


def run_engine(cfg, params, dev) -> dict:
    # warm-up: first calls of every op and both decode buckets
    warm = serve(cfg, params, dev, [16, 40, 24, 8, 64, 32, 12, 20], 3, 1)
    warm.run_until_drained()
    del warm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    lengths = [32, 512, 96, 384, 128, 256, 48, 200]
    eng = serve(cfg, params, dev, lengths, 64, SEED)
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launches()
    if len(done) != len(lengths) or any(len(r.generated) != 64
                                        for r in done):
        raise AssertionError(
            f"expected {len(lengths)} requests x 64 tokens, got "
            f"{[(r.rid, len(r.generated)) for r in done]}")
    if not all(counts.values()):
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{counts}")
    doc = eng.metrics.to_dict(include_steps=False)
    steps = doc["counters"]["decode_steps"]
    res = {
        "requests": len(done),
        "tokens": doc["counters"]["tokens_out"],
        "prompt_lengths": lengths,
        "wall_s": wall_s,
        "decode_steps": steps,
        "decode_tokens_per_s": doc["decode_tokens_per_s"],
        "per_token_ms": doc["per_token_ms"],
        "ttft_ms": doc["ttft_ms"],
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "launches": counts,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "dispatch": dispatch.dispatch_stats(),
    }
    # device-time breakdown over three decode steps at batch 8
    prof_eng = serve(cfg, params, dev, lengths, 8, SEED + 1)
    prof_eng.step()                      # prefill + first decode step
    res["profile"] = profile_decode(prof_eng, doc["per_token_ms"]["p50"])
    return res


def logits_check(cfg, params, dev) -> dict:
    """One decode step of one engine state, twice: through the dispatcher
    (the GEMV kernels) and with every GEMV pinned to ``ref``."""
    eng = serve(cfg, params, dev, [300, 40, 130, 7, 512, 64, 250, 90], 4,
                SEED + 2)
    eng.step()                           # prefill + one decode step
    b = eng.decode_bucket()
    last = torch.from_numpy(eng.last_tok[:b]).to(dev)
    out = {}
    for tag, policy in (("kernels", eng.gemv_policy),
                        ("ref", DispatchPolicy(kernel="ref"))):
        cache = {k: v.clone() for k, v in eng.kv.slice_prefix(b).items()}
        reset_launches()
        logits, _, _ = lm.forward(eng.params, cfg, last, cache=cache,
                                  gemv_policy=policy)
        torch.cuda.synchronize()
        out[tag] = (logits[:, -1].float(), launches())
    (lk, nk), (lr, nr) = out["kernels"], out["ref"]
    if not all(nk.values()) or any(nr.values()):
        raise AssertionError(f"launches: dispatcher {nk}, ref {nr}")
    if not (torch.isfinite(lk).all() and torch.isfinite(lr).all()):
        raise AssertionError("non-finite logits")
    diff = (lk - lr).abs().max().item()
    absmax = lr.abs().max().item()
    # Both runs compute the same bf16 network; only the GEMVs' f32 sums run
    # in other orders, so each GEMV output may round one bf16 ulp apart and
    # that propagates through 16 layers.  Tolerance: one bf16 ulp at the
    # largest logit (bf16 keeps 8 significant bits).
    tol = 2.0 ** (math.floor(math.log2(absmax)) - 7)
    res = {"batch": b, "max_abs_diff": diff, "tolerance": tol,
           "logit_absmax": absmax,
           "argmax_agree": int((lk.argmax(-1) == lr.argmax(-1)).sum()),
           "launches": nk}
    if diff > tol:
        raise AssertionError(f"logits differ by {diff} > {tol}")
    return res


# ---------------------------------------------------------------------------


def kernels_line(rows: list[dict], engine: dict) -> dict:
    """One entry per kernel.  Its top-level times are one olmo-1b decode
    step at batch 8: the sum over the main-path GEMVs at that batch (each
    shape weighted by its calls per step) that the TPU backend's picks --
    and this port's h100 backend -- send to the kernel."""
    picks = {"pim_gemv": ("gate_up", "head"), "splitk_gemv": ("qkv", "down")}
    out = []
    for name, k in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        step = [r for r in mine if r["B"] == 8 and r["shape"] in picks[name]]

        def total(key):
            return sum(r[key] * r["per_step"] for r in step)

        bytes_ms, ops_ms = total("bytes_ms"), total("ops_ms")
        out.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": engine["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": total("library_ms"),
            "basis": "one olmo-1b decode step at batch 8: "
                     + ", ".join(f"{s} x{SHAPES[s][2]}" for s in picks[name]),
            "shapes": [{key: r[key] for key in (
                "shape", "K", "M", "B", "ms", "plain_ms", "library_ms",
                "bound_ms", "max_abs_err")} for r in mine],
        })
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = nvidia_smi_line()
    log(f"[device] {name} x{count}; {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    report = _build.build(force=True)
    build_s = time.perf_counter() - t0
    log(f"[build] {len(report)} sources in {build_s:.1f} s")
    for src, r in report.items():
        regs = [ln.strip() for ln in r["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  {src}: " + " | ".join(regs))

    log("[kernels] each against its plain version (rtol 2^-7, atol 1e-3), "
        "then timed")
    rows = check_kernels(dev)

    cfg = get_config("olmo-1b")
    log(f"[engine] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"bf16, seed {SEED}")
    params = lm.init_lm(cfg, seed=SEED, device=dev)
    engine = run_engine(cfg, params, dev)
    pt, ttft = engine["per_token_ms"], engine["ttft_ms"]
    log(f"  requests {engine['requests']}, tokens {engine['tokens']}, "
        f"decode {engine['decode_tokens_per_s']:.1f} tok/s, per-token "
        f"p50 {pt['p50']:.2f} ms p90 {pt['p90']:.2f} ms, TTFT p50 "
        f"{ttft['p50']:.1f} ms, peak {engine['peak_mem_gb']:.2f} GB")
    log(f"  launches {engine['launches']} "
        f"(per decode step {engine['launches_per_step']})")
    log(f"  dispatch_stats {json.dumps(engine['dispatch'])}")
    if engine["profile"] is not None:
        p = engine["profile"]
        log(f"  profile: device busy {p['device_busy_ms_per_step']:.3f} ms "
            f"per decode step against a {p['step_ms']:.3f} ms step: idle "
            f"share {p['device_idle_share']:.3f}; "
            f"{p['kernels_per_step']:.0f} kernels and "
            f"{p['aten_ops_per_step']:.0f} ATen ops per step")
        for t in p["top"][:10]:
            log(f"    {t['ms_per_step']:8.3f} ms/step  {t['name']}")
    else:
        log("  profile: the profiler reported no device time")

    logits = logits_check(cfg, params, dev)
    log(f"[logits] batch {logits['batch']}: max |kernels - ref| "
        f"{logits['max_abs_diff']:.4f} (tolerance {logits['tolerance']}; "
        f"|logit| max "
        f"{logits['logit_absmax']:.2f}; argmax agree "
        f"{logits['argmax_agree']}/{logits['batch']})")

    line = kernels_line(rows, engine)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        device=dict(name=name, count=count, nvidia_smi=card),
        build_s=build_s, kernel_rows=rows, engine=engine, logits=logits,
        kernels=line["kernels"],
        total_s=time.perf_counter() - t_start), indent=1))
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
