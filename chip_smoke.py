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
   The quant kernels run at the same shapes and batches on int8 / packed
   int4 codes (block 32) from ``quantize_weight`` of seeded bf16 weights;
   they are timed beside the bf16 weight's ``torch.matmul``, a reference
   point that is not the same function;
4. engine  -- olmo-1b at full width, bf16, seeded random weights, through
   ``Engine(batch_slots=8, max_len=1024)``: 8 requests with prompts of 32
   to 512 tokens, 64 greedy tokens each; fails unless every kernel of the
   path (``pim_gemv``, ``splitk_gemv``) launched during the run;
5. logits  -- one decode step of the same engine state through the
   dispatcher and through ``torch.matmul`` (policy pinned to ``ref``);
6. quant   -- every decode GEMV of olmo-1b at full width and depth, batch
   8, through the dispatcher (``dispatch_prepacked`` for the fused QKV and
   gate+up, ``dispatch_gemv`` for down and the head) on int8 and then int4
   weights: fails unless every GEMV took the quant kernel, each program
   shape agrees with its plain version, and the launch counts equal the
   GEMV counts; timed beside the bf16 pass of the same GEMVs;
7. kv      -- the engine's 8 requests again with ``kv_store="int8"`` and
   ``"int4"``: every request completes, every logit is finite; reports
   latency, KV bytes per slot and the share of greedy tokens that agree
   with the fp run;
8. moe kernels -- olmo-1b's params are freed; ``ragged_gemv`` and
   ``grouped_gemv`` at deepseek-moe-16b's expert shapes (gate/up K=2048
   M=1408, down K=1408 M=2048, E=64) in bf16, each against its plain
   version, then timed: ragged on four routings (8 tokens top-6, T=48; 1
   token, T=6; 8 rows on one expert; counts short of T, tail rows), grouped
   at C=8; the bound counts only the experts that have rows;
9. moe engine -- deepseek-moe-16b at full width and depth (28 layers), bf16,
   seed 0, ``Engine(batch_slots=8, max_len=1024)``, the same 8 requests:
   fails unless ``ragged_gemv`` launched three times per layer on every
   decode step and every ragged program took the native mode;
10. moe logits -- one decode step of that engine state through the kernels
   and through the portable plain path (``kernel="ref"``,
   ``use_pallas=False``): the max |diff| of the logits and the argmax
   agreement are reported; each layer's MoE block is held to its tolerance
   on the inputs the kernel step gave it;
11. moe grouped -- ``Engine(batch_slots=1, gemv_expert_shape="grouped")``
   serves 2 of the requests, 16 tokens each: fails unless
   ``grouped_gemv`` launched; greedy tokens are compared with the ragged
   engine's;
12. the ``{"kernels": [...]}`` line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

A fuller report goes to ``chiprun_out/chip_smoke.json``.  Nothing here
imports JAX or the JAX package.
"""

from __future__ import annotations

import collections
import gc
import json
import math
import re
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build, dispatch  # noqa: E402
from repro_torch.kernels.backends import DispatchPolicy  # noqa: E402
from repro_torch.kernels.grouped_gemv import (  # noqa: E402
    counts_to_offsets,
    grouped_gemv,
    grouped_gemv_plain,
    plan_expert_gemv,
    ragged_gemv,
    ragged_gemv_plain,
)
from repro_torch.kernels.gemv_plan import (  # noqa: E402
    plan_gemv,
    plan_quant,
    plan_splitk,
    valid_splitk_degree,
)
from repro_torch.kernels.kv_quant import tree_bytes  # noqa: E402
from repro_torch.kernels.ops import PackedWeights, quantize_weight  # noqa
from repro_torch.kernels.pim_gemv import pim_gemv, pim_gemv_plain  # noqa
from repro_torch.kernels.quant_gemv import (  # noqa: E402
    quant4_gemv,
    quant4_gemv_plain,
    quant_gemv,
    quant_gemv_plain,
)
from repro_torch.kernels.splitk_gemv import (  # noqa: E402
    splitk_gemv,
    splitk_gemv_plain,
)
from repro_torch.models import layers as L  # noqa: E402
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
QUANT_BATCH = 8     # batch of the quantized dispatch pass
QUANT_ROUNDS = 5    # timed passes of each weight form

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
    "quant_gemv": dict(
        fn=quant_gemv, plain=quant_gemv_plain, bits=8,
        source="src/repro_torch/csrc/quant_gemv.cu",
        replaces="src/repro/kernels/quant_gemv.py:98"),
    "quant4_gemv": dict(
        fn=quant4_gemv, plain=quant4_gemv_plain, bits=4,
        source="src/repro_torch/csrc/quant_gemv.cu",
        replaces="src/repro/kernels/quant_gemv.py:137"),
    "grouped_gemv": dict(
        fn=grouped_gemv, plain=grouped_gemv_plain,
        source="src/repro_torch/csrc/grouped_gemv.cu",
        replaces="src/repro/kernels/grouped_gemv.py:137"),
    "ragged_gemv": dict(
        fn=ragged_gemv, plain=ragged_gemv_plain,
        source="src/repro_torch/csrc/grouped_gemv.cu",
        replaces="src/repro/kernels/grouped_gemv.py:215"),
}
FLOAT_KERNELS = ("pim_gemv", "splitk_gemv")     # the bf16 engine's path
QUANT_KERNELS = ("quant_gemv", "quant4_gemv")
BLOCK = 32                                      # quant scale block
MOE_KERNELS = ("grouped_gemv", "ragged_gemv")

MOE_ARCH = "deepseek-moe-16b"
MOE_E, MOE_TOPK = 64, 6
# deepseek-moe-16b's expert GEMVs (K, M) and how many run per decode step
# (gate and up in each of 28 layers, down in each)
MOE_SHAPES = {"gate_up": (2048, 1408, 56), "down": (1408, 2048, 28)}
MOE_C = 8          # grouped rows per expert at one decode slot (_capacity)
MOE_GROUPED_TOKENS = 16


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


def check_close(name: str, what: str, out, ref) -> float:
    """Max abs error of ``out`` against its plain version; raises past
    the kernel tolerance or on a non-finite value."""
    err = (out.float() - ref.float()).abs()
    bad = err > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()
    if not torch.isfinite(out.float()).all() or bad.any():
        raise AssertionError(
            f"{name} {what}: {int(bad.sum())} elements off its plain "
            f"version (max abs err {err.max().item():.3e})")
    return err.max().item()


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
            for name in FLOAT_KERNELS:
                k = KERNELS[name]
                plan, why = plan_for(name, K, M, B)
                if plan is None:
                    log(f"  skip {name} {shape} B={B}: {why}")
                    continue
                out = k["fn"](x, ws[0], plan=plan)
                torch.cuda.synchronize()
                args = (ws[0], plan.split_k) if name == "splitk_gemv" \
                    else (ws[0],)
                max_err = check_close(name, f"{shape} B={B}", out,
                                      k["plain"](x, *args))
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
                    max_abs_err=max_err,
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


def check_quant_kernels(dev, sms: int) -> list[dict]:
    """quant_gemv / quant4_gemv at olmo-1b's decode GEMV shapes and batch
    1, 4, 8, bf16 x, block 32: each against its plain version, then timed
    like the float kernels.  ``bf16_matmul_ms`` is ``torch.matmul`` on the
    bf16 weight the codes came from: a reference point, not the same
    function (no single PyTorch call computes a block-scaled int8/int4
    GEMV)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    rows = []
    for shape, (K, M, per_step) in SHAPES.items():
        # enough copies that even the int4 stream rotates past the L2
        int4_bytes = K * M // 2 + (K // BLOCK) * M * 4
        n_copies = max(2, math.ceil(2 * L2_BYTES / int4_bytes) + 1)
        ws = [(torch.randn((M, K), generator=gen, device=dev)
               / math.sqrt(K)).to(torch.bfloat16) for _ in range(n_copies)]
        packs = {bits: [quantize_weight(w, bits=bits, block=BLOCK)
                        for w in ws] for bits in (8, 4)}
        for bits, pws in packs.items():   # the card's codes are the host's
            host = quantize_weight(ws[0].cpu(), bits=bits, block=BLOCK)
            if not (torch.equal(pws[0].w_t.cpu(), host.w_t)
                    and torch.equal(pws[0].scales.cpu(), host.scales)):
                raise AssertionError(f"int{bits} {shape}: quantize_weight "
                                     f"on the card differs from the CPU's")
        ws_t = [w.t().contiguous() for w in ws]
        del ws
        for B in BATCHES:
            x = torch.randn((B, K), generator=gen, device=dev).to(
                torch.bfloat16)
            for name in QUANT_KERNELS:
                k = KERNELS[name]
                bits = k["bits"]
                pws = packs[bits]
                plan = plan_quant(M, K, B, bits=bits, block=BLOCK,
                                  min_blocks=sms)
                out = k["fn"](x, pws[0].w_t, pws[0].scales, block=BLOCK,
                              plan=plan)
                torch.cuda.synchronize()
                max_err = check_close(
                    name, f"{shape} B={B}", out,
                    k["plain"](x, pws[0].w_t, pws[0].scales, BLOCK))
                code_bytes = pws[0].w_t.numel() + pws[0].scales.numel() * 4
                calls = 100 if code_bytes < 50e6 else 40

                def run(i, fn=k["fn"], pws=pws, plan=plan):
                    pw = pws[i % n_copies]
                    fn(x, pw.w_t, pw.scales, block=BLOCK, plan=plan)

                def run_plain(i, plain=k["plain"], pws=pws):
                    pw = pws[i % n_copies]
                    plain(x, pw.w_t, pw.scales, BLOCK)

                def run_matmul(i):
                    torch.matmul(x, ws_t[i % n_copies])

                io_bytes = code_bytes + (B * K + B * M) * 2
                row = dict(
                    kernel=name, shape=shape, K=K, M=M, B=B, bits=bits,
                    per_step=per_step, plan=dict(
                        m_blk=plan.m_blk, k_blk=plan.k_blk, ctas=plan.n_m),
                    max_abs_err=max_err,
                    ms=graph_ms(run, calls),
                    plain_ms=graph_ms(run_plain, max(calls // 4, 10)),
                    library_ms=None,
                    bf16_matmul_ms=graph_ms(run_matmul, calls),
                    bytes_ms=io_bytes / HBM_BYTES_PER_S * 1e3,
                    # the codes fit bf16 exactly and the scale factors out
                    # of each block, so bf16 tensor cores could do the
                    # same products: their rate is the operations bound
                    ops_ms=2 * B * K * M / BF16_FLOPS * 1e3)
                row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
                row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                                   else "operations")
                row["hbm_share"] = row["bound_ms"] / row["ms"]
                rows.append(row)
                log(f"  {name:12s} {shape:8s} B={B} err={max_err:.2e}"
                    f" ms={row['ms']:.4f} bound={row['bound_ms']:.4f}"
                    f" ({row['hbm_share']:.0%}) ctas={plan.n_m}"
                    f" plain={row['plain_ms']:.4f}"
                    f" bf16 matmul={row['bf16_matmul_ms']:.4f}")
        del packs, ws_t
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4 / 5: the engine
# ---------------------------------------------------------------------------


def prompts(vocab: int, lengths, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


ENGINE_LENGTHS = [32, 512, 96, 384, 128, 256, 48, 200]


def serve(cfg, params, dev, lengths, new_tokens, seed,
          kv_store: str = "fp", **engine_kw) -> Engine:
    kw = dict(batch_slots=8, max_len=1024)
    kw.update(engine_kw)
    eng = Engine(cfg, params, device=dev, kv_store=kv_store, **kw)
    for i, p in enumerate(prompts(cfg.vocab, lengths, seed)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens))
    return eng


def check_finite_logits(eng: Engine) -> dict:
    """Make ``eng`` refuse every non-finite logits row it samples from;
    returns the counter of rows it checked."""
    sample, seen = eng._sample, {"rows": 0}

    def checked(r, row):
        if not np.isfinite(row).all():
            raise AssertionError(f"request {r.rid}: non-finite logits")
        seen["rows"] += 1
        return sample(r, row)

    eng._sample = checked
    return seen


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
    by_name = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in on_card if e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms, _ in by_name)
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
            "top": [{"name": n[:120], "ms_per_step": ms / steps,
                     "calls_per_step": calls / steps}
                    for n, ms, calls in by_name[:20]],
            "top_host": [{"name": e.key, "calls_per_step": e.count / steps,
                          "self_cpu_ms_per_step":
                              e.self_cpu_time_total / 1e3 / steps}
                         for e in aten[:12]]}


def log_profile(p: dict | None) -> None:
    if p is None:
        log("  profile: the profiler reported no device time")
        return
    log(f"  profile: device busy {p['device_busy_ms_per_step']:.3f} ms "
        f"per decode step against a {p['step_ms']:.3f} ms step: idle "
        f"share {p['device_idle_share']:.3f}; "
        f"{p['kernels_per_step']:.0f} kernels and "
        f"{p['aten_ops_per_step']:.0f} ATen ops per step")
    for t in p["top"][:10]:
        log(f"    {t['ms_per_step']:8.3f} ms/step  {t['name']}")


def run_engine(cfg, params, dev, kv_store: str = "fp") -> dict:
    # warm-up: first calls of every op and both decode buckets
    warm = serve(cfg, params, dev, [16, 40, 24, 8, 64, 32, 12, 20], 3, 1,
                 kv_store)
    warm.run_until_drained()
    del warm
    # an engine whose sampler check_finite_logits wrapped sits in a
    # reference cycle: collect it, or its state counts in the next peak
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    lengths = ENGINE_LENGTHS
    eng = serve(cfg, params, dev, lengths, 64, SEED, kv_store)
    seen = check_finite_logits(eng)
    dispatch.clear_plan_cache()
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launches()
    stats = dispatch.dispatch_stats()
    if len(done) != len(lengths) or any(len(r.generated) != 64
                                        for r in done):
        raise AssertionError(
            f"expected {len(lengths)} requests x 64 tokens, got "
            f"{[(r.rid, len(r.generated)) for r in done]}")
    need = ("ragged_gemv",) if cfg.moe is not None else FLOAT_KERNELS
    if not all(counts[n] for n in need):
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{counts}")
    doc = eng.metrics.to_dict(include_steps=False)
    steps = doc["counters"]["decode_steps"]
    if cfg.moe is not None:
        # every routed projection of every decode step: gate, up and down
        # in each layer, each one ragged_gemv launch in the native mode
        modes = stats["program_modes"]
        if (counts["ragged_gemv"] != 3 * cfg.n_layers * steps
                or "h100:ragged" in modes
                or not modes.get("h100:ragged_cuda")):
            raise AssertionError(
                f"{steps} decode steps launched ragged_gemv "
                f"{counts['ragged_gemv']} times (expected "
                f"{3 * cfg.n_layers * steps}); program modes {modes}")
    kv_leaves = {n: t for n, t in eng.kv.cache.items() if n != "pos"}
    res = {
        "kv_store": kv_store,
        "kv_bytes_per_slot": tree_bytes(kv_leaves) / eng.slots,
        "logit_rows_checked": seen["rows"],
        "generated": {r.rid: list(r.generated) for r in done},
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
        "dispatch": stats,
    }
    # device-time breakdown over three decode steps at batch 8
    prof_eng = serve(cfg, params, dev, lengths, 8, SEED + 1, kv_store)
    prof_eng.step()                          # prefill + first decode step
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
    if not all(nk[n] for n in FLOAT_KERNELS) or any(nr.values()):
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
# phase 6: every decode GEMV of olmo-1b through the dispatcher, quantized
# ---------------------------------------------------------------------------


def decode_weights(pp: dict, bits: int) -> tuple[list[dict], PackedWeights]:
    """olmo-1b's decode GEMV weights as the dispatcher takes them: per
    layer the prepacked fused QKV and gate+up and the down projection,
    then the head; quantized (``quantize_weight`` of the bf16 weight, one
    copy at deployment) unless ``bits`` is 16."""
    def pack(w_t):
        if bits == 16:
            return PackedWeights(w_t=w_t)
        return quantize_weight(w_t.t(), bits=bits, block=BLOCK)

    layers = [{"qkv": pack(p["attn"]["wqkv"]),
               "gate_up": pack(p["mlp"]["w_gateup"]),
               "down": pack(p["mlp"]["w_down"])} for p in pp["layers"]]
    return layers, pack(pp["head_t"])


def gemv_pass(layers, head, xs, splits) -> list[torch.Tensor]:
    """One decode step's GEMVs: fused programs through
    ``dispatch_prepacked``, down and the head through ``dispatch_gemv``."""
    outs = []
    for w in layers:
        for name in ("qkv", "gate_up"):
            outs.append(torch.cat(dispatch.dispatch_prepacked(
                xs[name], w[name], splits[name]), dim=-1))
        outs.append(dispatch.dispatch_gemv(xs["down"], w["down"]))
    outs.append(dispatch.dispatch_gemv(xs["head"], head))
    return outs


def run_quant_dispatch(cfg, params, dev) -> dict:
    pp = lm.prepack_decode_params(params, cfg)
    hd, f = cfg.hd, cfg.d_ff
    splits = {"qkv": (cfg.n_heads * hd, cfg.n_kv_heads * hd,
                      cfg.n_kv_heads * hd), "gate_up": (f, f)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    xs = {name: torch.randn((QUANT_BATCH, K), generator=gen, device=dev).to(
        torch.bfloat16) for name, (K, _, _) in SHAPES.items()}
    n_gemv = sum(n for _, _, n in SHAPES.values())
    weights = {bits: decode_weights(pp, bits) for bits in (16, 8, 4)}
    del pp
    torch.cuda.empty_cache()
    res = {"batch": QUANT_BATCH, "gemvs": n_gemv, "passes": {}}
    for bits, kname in ((16, None), (8, "quant_gemv"), (4, "quant4_gemv")):
        layers, head = weights[bits]
        dispatch.clear_plan_cache()
        reset_launches()
        outs = gemv_pass(layers, head, xs, splits)
        torch.cuda.synchronize()
        counts = launches()
        stats = dispatch.dispatch_stats()
        moved = sum(pw.w_t.numel() * pw.w_t.element_size()
                    + (0 if pw.scales is None else pw.scales.numel() * 4)
                    for pw in [head] + [w[n] for w in layers for n in w])
        moved += sum(QUANT_BATCH * (K + M) * 2 * n
                     for K, M, n in SHAPES.values())
        entry = {"launches": counts, "kernel_picks": stats["kernel_picks"],
                 "program_kernels": stats["program_kernels"],
                 "bytes": moved,
                 "floor_ms": moved / HBM_BYTES_PER_S * 1e3}
        if kname is not None:
            want = "quant" if bits == 8 else "quant4"
            picks = {f"h100:{want}": 2}
            if (stats["kernel_picks"] != picks
                    or stats["program_kernels"] != picks):
                raise AssertionError(f"int{bits} GEMVs did not all pick "
                                     f"{want}: {stats}")
            expect = {n: (n_gemv if n == kname else 0) for n in KERNELS}
            if counts != expect:
                raise AssertionError(f"int{bits} pass launched {counts}, "
                                     f"expected {expect}")
            # layer 0's three program shapes and the head against the plain
            # version of the same codes
            plain = KERNELS[kname]["plain"]
            errs = {}
            for name, out in zip(("qkv", "gate_up", "down"), outs[:3]):
                pw = layers[0][name]
                errs[name] = check_close(
                    kname, f"dispatched {name}", out,
                    plain(xs[name], pw.w_t, pw.scales, BLOCK))
            errs["head"] = check_close(
                kname, "dispatched head", outs[-1],
                plain(xs["head"], head.w_t, head.scales, BLOCK))
            entry["max_abs_err"] = errs
        if not all(torch.isfinite(o.float()).all() for o in outs):
            raise AssertionError(f"int{bits} pass: non-finite outputs")
        res["passes"][f"w{bits}"] = entry
        log(f"  w{bits}: launches {counts}; floor "
            f"{entry['floor_ms']:.4f} ms for {moved / 1e9:.3f} GB"
            + (f"; max abs err {entry['max_abs_err']}"
               if "max_abs_err" in entry else ""))
        del outs
    # wall time of one pass, the three weight forms in turns
    walls = {f"w{bits}": [] for bits in weights}
    for _ in range(QUANT_ROUNDS):
        for bits, (layers, head) in weights.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gemv_pass(layers, head, xs, splits)
            torch.cuda.synchronize()
            walls[f"w{bits}"].append((time.perf_counter() - t0) * 1e3)
    for tag, ms in walls.items():
        res["passes"][tag]["wall_ms"] = sorted(ms)
        res["passes"][tag]["wall_ms_p50"] = float(np.median(ms))
    log("  pass wall p50: " + ", ".join(
        f"{tag} {res['passes'][tag]['wall_ms_p50']:.3f} ms"
        for tag in walls))
    del weights
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 7: the engine on quantized KV pages
# ---------------------------------------------------------------------------


def token_agreement(fp: dict, other: dict) -> dict:
    """Share of greedy tokens equal at the same position, and share before
    each request's first disagreement, against the fp run."""
    same = prefix = total = 0
    for rid, toks in fp.items():
        mine = other[rid]
        total += len(toks)
        eq = [a == b for a, b in zip(toks, mine)]
        same += sum(eq)
        prefix += next((i for i, e in enumerate(eq) if not e), len(eq))
    return {"same_position": same / total, "before_first_flip": prefix / total}


# ---------------------------------------------------------------------------
# phases 8-11: deepseek-moe-16b, the expert kernels and the MoE engine
# ---------------------------------------------------------------------------


def event_ms(fn, calls: int) -> float:
    """Device time of one call of a function that cannot be captured in a
    CUDA graph (it reads on the host): ``calls`` back-to-back calls between
    CUDA events, after a warm call."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def moe_routings() -> dict[str, tuple[int, np.ndarray]]:
    """Row count T and per-expert counts [E] of the four ragged cases:
    a seeded top-6 routing of 8 tokens (T=48) and of 1 token (T=6), one
    where every token picks expert 0 (8 rows on it), and one whose counts
    (6 tokens) sum to 36 < T=48, leaving 12 tail rows."""
    rng = np.random.default_rng(SEED + 30)

    def route(n_tok, force=None):
        top = np.stack([rng.permutation(MOE_E)[:MOE_TOPK]
                        for _ in range(n_tok)])
        if force is not None:
            for row in top:
                if force not in row:
                    row[-1] = force
        return np.bincount(top.reshape(-1), minlength=MOE_E)

    return {"top6_b8": (8 * MOE_TOPK, route(8)),
            "top6_b1": (MOE_TOPK, route(1)),
            "skewed": (8 * MOE_TOPK, route(8, force=0)),
            "tail": (8 * MOE_TOPK, route(6))}


def moe_bounds(K, M, active, rows, T, x_rows) -> dict:
    """Bytes (weights of the experts with rows, x and out) and operations
    (2 * routed rows * K * M) over the card's peaks."""
    io = active * K * M * 2 + (x_rows * K + T * M) * 2
    bytes_ms = io / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * rows * K * M / BF16_FLOPS * 1e3
    return dict(bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def check_moe_kernels(dev) -> list[dict]:
    """ragged_gemv on the four routings and grouped_gemv at C=8, at
    deepseek-moe-16b's expert shapes in bf16: each against its plain
    version, then timed with the stack rotated past the L2 (copies enough
    that even the 6 experts of one token exceed it twice over)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    routings = moe_routings()
    rows = []
    for shape, (K, M, per_step) in MOE_SHAPES.items():
        plan = plan_expert_gemv(M, K)
        n_copies = max(2, math.ceil(2 * L2_BYTES / (MOE_TOPK * K * M * 2))
                       + 1)
        ws = [(torch.randn((MOE_E, K, M), generator=gen, device=dev)
               / math.sqrt(K)).to(torch.bfloat16) for _ in range(n_copies)]
        for name, (T, counts) in routings.items():
            x = torch.randn((T, K), generator=gen, device=dev).to(
                torch.bfloat16)
            offsets = counts_to_offsets(torch.tensor(
                counts, dtype=torch.int32, device=dev))
            out = ragged_gemv(x, offsets, ws[0], plan=plan)
            torch.cuda.synchronize()
            ref = ragged_gemv_plain(x, offsets, ws[0])
            err = check_close("ragged_gemv", f"{shape} {name}", out, ref)
            if out[int(counts.sum()):].any():
                raise AssertionError(f"ragged_gemv {shape} {name}: tail "
                                     f"rows are not zero")
            active = np.flatnonzero(counts)
            # reference point: torch.bmm over the experts with rows, x
            # padded to the largest count (the gathered stacks are built
            # outside the timing)
            xp = torch.zeros((len(active), int(counts.max()), K),
                             dtype=torch.bfloat16, device=dev)
            idx = torch.from_numpy(active).to(dev)
            wa = [w[idx] for w in ws]

            def run(i, x=x, offsets=offsets):
                ragged_gemv(x, offsets, ws[i % n_copies], plan=plan)

            def run_plain(i, x=x, offsets=offsets):
                ragged_gemv_plain(x, offsets, ws[i % n_copies])

            def run_bmm(i, xp=xp, wa=wa):
                torch.bmm(xp, wa[i % n_copies])

            row = dict(kernel="ragged_gemv", shape=shape, routing=name, T=T,
                       K=K, M=M, per_step=per_step,
                       experts_with_rows=len(active),
                       rows=int(counts.sum()),
                       plan=dict(m_blk=plan.m_blk, k_blk=plan.k_blk),
                       max_abs_err=err, ms=graph_ms(run, 40),
                       plain_ms=event_ms(run_plain, 5), library_ms=None,
                       bmm_ref_ms=graph_ms(run_bmm, 40),
                       **moe_bounds(K, M, len(active), int(counts.sum()), T,
                                    T))
            row["hbm_share"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            del wa, xp
            log(f"  ragged_gemv  {shape:8s} {name:8s} T={T:2d} experts "
                f"{len(active):2d} err={err:.2e} ms={row['ms']:.4f} "
                f"bound={row['bound_ms']:.4f} ({row['hbm_share']:.0%}) "
                f"plain={row['plain_ms']:.4f} "
                f"bmm ref={row['bmm_ref_ms']:.4f}")
        xs = torch.randn((MOE_E, MOE_C, K), generator=gen, device=dev).to(
            torch.bfloat16)
        out = grouped_gemv(xs, ws[0], plan=plan)
        torch.cuda.synchronize()
        err = check_close("grouped_gemv", f"{shape} C={MOE_C}", out,
                          grouped_gemv_plain(xs, ws[0]))

        def run_g(i):
            grouped_gemv(xs, ws[i % n_copies], plan=plan)

        def run_g_plain(i):
            grouped_gemv_plain(xs, ws[i % n_copies])

        def run_g_lib(i):
            torch.bmm(xs, ws[i % n_copies])

        rows_g = MOE_E * MOE_C
        row = dict(kernel="grouped_gemv", shape=shape, routing=f"C={MOE_C}",
                   T=rows_g, K=K, M=M, per_step=per_step,
                   experts_with_rows=MOE_E, rows=rows_g,
                   plan=dict(m_blk=plan.m_blk, k_blk=plan.k_blk),
                   max_abs_err=err, ms=graph_ms(run_g, 20),
                   plain_ms=graph_ms(run_g_plain, 5),
                   library_ms=graph_ms(run_g_lib, 20),
                   **moe_bounds(K, M, MOE_E, rows_g, rows_g, rows_g))
        row["hbm_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"  grouped_gemv {shape:8s} C={MOE_C} err={err:.2e} "
            f"ms={row['ms']:.4f} bound={row['bound_ms']:.4f} "
            f"({row['hbm_share']:.0%}) plain={row['plain_ms']:.4f} "
            f"bmm={row['library_ms']:.4f}")
        del ws, xs
        torch.cuda.empty_cache()
    return rows


def bf16_ulp(absmax: float) -> float:
    """One bf16 ulp at ``absmax`` (bf16 keeps 8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(absmax)) - 7)


def moe_logits_check(cfg, params, dev) -> dict:
    """One decode step of one engine state through the kernels and through
    the portable plain path.  A 1-ulp difference in a GEMV can swap a
    router's 6th and 7th expert where their probabilities nearly tie, and
    the swapped token's logits then differ by far more than rounding, so
    the whole-model difference is reported beside one bf16 ulp at the
    largest logit but not held to it.  What is held: every layer's MoE
    block on the input the kernel step gave it, where both paths route
    alike, within 8 bf16 ulps at its largest output (gate, up and down
    each round once in another f32 order, and six rounded terms are
    combined)."""
    eng = serve(cfg, params, dev, [300, 40, 130, 7, 512, 64, 250, 90], 4,
                SEED + 2)
    eng.step()                           # prefill + one decode step
    b = eng.decode_bucket()
    last = torch.from_numpy(eng.last_tok[:b]).to(dev)
    ref_pol = DispatchPolicy(kernel="ref", use_pallas=False)
    inputs, real = [], L.apply_moe

    def spy(p, x, cfg, gemv=None):
        inputs.append(x)
        return real(p, x, cfg, gemv=gemv)

    out = {}
    syncs: collections.Counter = collections.Counter()

    def record_sync(message, category, filename, lineno, file=None,
                    line=None):
        """Count a synchronizing CUDA call by the innermost line of this
        repository's code that led to it."""
        if "synchroniz" not in str(message).lower():
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if "repro_torch" in f.filename]
        where = f"{Path(filename).name}:{lineno}"
        if ours:
            f = ours[-1]
            where = (f"{Path(f.filename).parent.name}/"
                     f"{Path(f.filename).name}:{f.lineno} "
                     f"({(f.line or '').strip()}) -> {where}")
        syncs[where] += 1

    for tag, policy in (("kernels", eng.gemv_policy), ("ref", ref_pol)):
        cache = {k: v.clone() for k, v in eng.kv.slice_prefix(b).items()}
        torch.cuda.synchronize()
        reset_launches()
        L.apply_moe = spy if tag == "kernels" else real
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record_sync
            if tag == "kernels":
                torch.cuda.set_sync_debug_mode("warn")
            try:
                logits, _, _ = lm.forward(eng.params, cfg, last,
                                          cache=cache, gemv_policy=policy)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                L.apply_moe = real
        torch.cuda.synchronize()
        out[tag] = (logits[:, -1].float(), launches())
    (lk, nk), (lr, nr) = out["kernels"], out["ref"]
    if nk["ragged_gemv"] != 3 * cfg.n_layers or any(nr.values()):
        raise AssertionError(f"launches: kernels {nk}, ref {nr}")
    if not (torch.isfinite(lk).all() and torch.isfinite(lr).all()):
        raise AssertionError("non-finite logits")
    layers = []
    for i, (p, x) in enumerate(zip(eng.params["layers"], inputs)):
        yk, _ = L.apply_moe(p["moe"], x, cfg, gemv=eng.gemv_policy)
        yr, _ = L.apply_moe(p["moe"], x, cfg, gemv=ref_pol)
        diff = (yk.float() - yr.float()).abs().max().item()
        tol = 8 * bf16_ulp(yr.float().abs().max().item())
        layers.append({"layer": i, "max_abs_diff": diff, "tolerance": tol})
        if diff > tol:
            raise AssertionError(f"MoE layer {i}: kernels and ref differ "
                                 f"by {diff} > {tol}")
    # the step's bytes floor: every decode weight it reads once (the
    # prepacked QKV and shared gate+up, wo, shared down, the f32 router,
    # the head) and the expert stacks its routers picked
    active = sum(int(torch.unique(L._router(p["moe"], x, cfg)[2]).numel())
                 for p, x in zip(eng.params["layers"], inputs))
    dense = sum(t.numel() * t.element_size()
                for p in eng.params["layers"]
                for t in (p["attn"]["wqkv"], p["attn"]["wo"],
                          p["moe"]["router"], p["moe"]["shared"]["w_gateup"],
                          p["moe"]["shared"]["w_down"]))
    dense += eng.params["head_t"].numel() * eng.params["head_t"].element_size()
    per_expert = 3 * cfg.d_model * cfg.moe.d_expert * 2
    floor_bytes = dense + active * per_expert
    absmax = lr.abs().max().item()
    diff = (lk - lr).abs().max().item()
    return {"batch": b, "max_abs_diff": diff,
            "experts_with_rows": active,
            "step_floor_gb": floor_bytes / 1e9,
            "step_floor_ms": floor_bytes / HBM_BYTES_PER_S * 1e3,
            "all_experts_floor_ms": (dense + cfg.n_layers * cfg.moe.n_experts
                                     * per_expert) / HBM_BYTES_PER_S * 1e3,
            "one_ulp_at_absmax": bf16_ulp(absmax),
            "within_one_ulp": diff <= bf16_ulp(absmax),
            "logit_absmax": absmax,
            "rows_within_one_ulp": int(((lk - lr).abs().amax(-1)
                                        <= bf16_ulp(absmax)).sum()),
            "argmax_agree": int((lk.argmax(-1) == lr.argmax(-1)).sum()),
            "layers": layers,
            "layer_worst_share": max(r["max_abs_diff"] / r["tolerance"]
                                     for r in layers),
            "host_syncs_in_decode_forward": dict(syncs),
            "launches": nk}


def run_moe_grouped(cfg, params, dev, ragged_generated: dict) -> dict:
    """Two of the engine's requests through one slot with grouped expert
    programs (C=8 rows per expert, within the batch gate)."""
    lengths = ENGINE_LENGTHS[:2]
    eng = serve(cfg, params, dev, lengths, MOE_GROUPED_TOKENS, SEED,
                batch_slots=1, gemv_expert_shape="grouped")
    seen = check_finite_logits(eng)
    dispatch.clear_plan_cache()
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launches()
    stats = dispatch.dispatch_stats()
    if len(done) != 2 or any(len(r.generated) != MOE_GROUPED_TOKENS
                             for r in done):
        raise AssertionError(f"grouped engine finished "
                             f"{[(r.rid, len(r.generated)) for r in done]}")
    if not counts["grouped_gemv"]:
        raise AssertionError(f"grouped_gemv never launched: {counts}")
    doc = eng.metrics.to_dict(include_steps=False)
    steps = doc["counters"]["decode_steps"]
    gen = {r.rid: list(r.generated) for r in done}
    agree = token_agreement(
        gen, {rid: ragged_generated[rid][:MOE_GROUPED_TOKENS]
              for rid in gen})
    return {"requests": len(done), "wall_s": wall_s, "decode_steps": steps,
            "logit_rows_checked": seen["rows"],
            "per_token_ms": doc["per_token_ms"],
            "launches": counts,
            "launches_per_step": {k: v / steps for k, v in counts.items()},
            "program_modes": stats["program_modes"],
            "expert_load": stats["expert_load"],
            "agreement_with_ragged": agree}


# ---------------------------------------------------------------------------


def kernels_line(rows: list[dict], launch_counts: dict) -> dict:
    """One entry per kernel.  Its top-level times are one decode step: for
    the olmo-1b kernels at batch 8, the sum over the GEMVs at that batch
    (each shape weighted by its calls per step) that the h100 backend --
    as the TPU backend -- sends to the kernel (for the float kernels the
    bf16 engine's picks, for the quant kernels every GEMV of the quantized
    pass); for ``ragged_gemv`` one deepseek-moe-16b step at batch 8 (the
    top-6 routing of 8 tokens), for ``grouped_gemv`` one at batch 1 (C=8).
    ``launches`` is the count from the run of the kernel's own path."""
    picks = {"pim_gemv": ("gate_up", "head"), "splitk_gemv": ("qkv", "down"),
             "quant_gemv": tuple(SHAPES), "quant4_gemv": tuple(SHAPES)}

    def in_step(name, r):
        if name == "ragged_gemv":
            return r["routing"] == "top6_b8"
        if name == "grouped_gemv":
            return True
        return r["B"] == 8 and r["shape"] in picks[name]

    out = []
    for name, k in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        step = [r for r in mine if in_step(name, r)]

        def total(key):
            return sum(r[key] * r["per_step"] for r in step)

        bytes_ms, ops_ms = total("bytes_ms"), total("ops_ms")
        quant, moe = name in QUANT_KERNELS, name in MOE_KERNELS
        if moe:
            basis = (f"one {MOE_ARCH} decode step at batch "
                     f"{8 if name == 'ragged_gemv' else 1}: "
                     + ", ".join(f"{s} x{n}" for s, (_, _, n)
                                 in MOE_SHAPES.items()))
            keys = ("shape", "routing", "T", "K", "M", "experts_with_rows",
                    "ms", "plain_ms", "library_ms", "bound_ms",
                    "max_abs_err") + (("bmm_ref_ms",)
                                      if name == "ragged_gemv" else ())
        else:
            basis = ("one olmo-1b decode step at batch 8: "
                     + ", ".join(f"{s} x{SHAPES[s][2]}"
                                 for s in picks[name]))
            keys = ("shape", "K", "M", "B", "ms", "plain_ms", "library_ms",
                    "bound_ms", "max_abs_err") + (
                        ("bf16_matmul_ms", "plan") if quant else ())
        entry = {
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": launch_counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # no single PyTorch call computes a block-scaled int8/int4 GEMV
            # or a ragged expert GEMV
            "library_ms": (None if quant or name == "ragged_gemv"
                           else total("library_ms")),
            "basis": basis,
            "shapes": [{key: r[key] for key in keys} for r in mine],
        }
        if quant:
            entry["bf16_matmul_ms"] = total("bf16_matmul_ms")
            entry["bf16_matmul_note"] = (
                "torch.matmul on the bf16 weight the codes came from: a "
                "reference point, not the same function")
        if name == "ragged_gemv":
            entry["bmm_ref_ms"] = total("bmm_ref_ms")
            entry["bmm_ref_note"] = (
                "torch.bmm over the experts with rows, x padded to the "
                "largest count: a reference point, not the same function")
        out.append(entry)
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
    spills = []
    for src, r in report.items():
        regs = [ln.strip() for ln in r["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  {src}: " + " | ".join(regs))
        spills += [f"{src}: {ln}" for ln in regs
                   if re.search(r"[1-9]\d* bytes spill", ln)]
    if spills:
        raise AssertionError("register spills:\n" + "\n".join(spills))

    log("[kernels] each against its plain version (rtol 2^-7, atol 1e-3), "
        "then timed")
    rows = check_kernels(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows += check_quant_kernels(dev, sms)

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
    log_profile(engine["profile"])

    logits = logits_check(cfg, params, dev)
    log(f"[logits] batch {logits['batch']}: max |kernels - ref| "
        f"{logits['max_abs_diff']:.4f} (tolerance {logits['tolerance']}; "
        f"|logit| max "
        f"{logits['logit_absmax']:.2f}; argmax agree "
        f"{logits['argmax_agree']}/{logits['batch']})")

    n_gemv = sum(n for _, _, n in SHAPES.values())
    log(f"[quant] every olmo-1b decode GEMV (x{n_gemv}) at batch "
        f"{QUANT_BATCH} through the dispatcher, bf16 / int8 / int4 weights")
    quant = run_quant_dispatch(cfg, params, dev)

    kv = {}
    for store in ("int8", "int4"):
        kv[store] = run_engine(cfg, params, dev, kv_store=store)
        kv[store]["agreement_with_fp"] = token_agreement(
            engine["generated"], kv[store]["generated"])
        e = kv[store]
        log(f"[kv {store}] requests {e['requests']}, tokens {e['tokens']}, "
            f"logit rows checked {e['logit_rows_checked']}, per-token p50 "
            f"{e['per_token_ms']['p50']:.2f} ms p90 "
            f"{e['per_token_ms']['p90']:.2f} ms, peak "
            f"{e['peak_mem_gb']:.2f} GB, KV bytes/slot "
            f"{e['kv_bytes_per_slot'] / 1e6:.2f} MB (fp "
            f"{engine['kv_bytes_per_slot'] / 1e6:.2f} MB), greedy tokens "
            f"agreeing with fp {e['agreement_with_fp']}")
        log_profile(e["profile"])

    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("[moe kernels] ragged_gemv and grouped_gemv at deepseek-moe-16b's "
        "expert shapes, each against its plain version (rtol 2^-7, atol "
        "1e-3), then timed")
    rows += check_moe_kernels(dev)

    mcfg = get_config(MOE_ARCH)
    log(f"[moe engine] {mcfg.name}: {mcfg.n_layers} layers, d={mcfg.d_model}"
        f", {mcfg.moe.n_experts} experts top-{mcfg.moe.top_k} + "
        f"{mcfg.moe.n_shared} shared, bf16, seed {SEED}")
    t0 = time.perf_counter()
    mparams = lm.init_lm(mcfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"  init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")
    moe = run_engine(mcfg, mparams, dev)
    pt, ttft = moe["per_token_ms"], moe["ttft_ms"]
    log(f"  requests {moe['requests']}, tokens {moe['tokens']}, "
        f"decode {moe['decode_tokens_per_s']:.1f} tok/s, per-token "
        f"p50 {pt['p50']:.2f} ms p90 {pt['p90']:.2f} ms, TTFT p50 "
        f"{ttft['p50']:.1f} ms, peak {moe['peak_mem_gb']:.2f} GB")
    log(f"  launches {moe['launches']} "
        f"(per decode step {moe['launches_per_step']})")
    log(f"  program_modes {json.dumps(moe['dispatch']['program_modes'])}; "
        f"expert_load {json.dumps(moe['dispatch']['expert_load'])}")
    log_profile(moe["profile"])

    moe_logits = moe_logits_check(mcfg, mparams, dev)
    log(f"[moe logits] batch {moe_logits['batch']}: max |kernels - ref| "
        f"{moe_logits['max_abs_diff']:.4f} (one bf16 ulp at |logit| max "
        f"{moe_logits['logit_absmax']:.2f}: "
        f"{moe_logits['one_ulp_at_absmax']}; rows within it "
        f"{moe_logits['rows_within_one_ulp']}/{moe_logits['batch']}); "
        f"argmax agree {moe_logits['argmax_agree']}/{moe_logits['batch']}; "
        f"every MoE layer within 8 ulps (worst at "
        f"{moe_logits['layer_worst_share']:.2f} of its tolerance); "
        f"synchronizing calls in the decode forward "
        f"{moe_logits['host_syncs_in_decode_forward']}; the step's "
        f"routers picked {moe_logits['experts_with_rows']} expert stacks: "
        f"bytes floor {moe_logits['step_floor_gb']:.3f} GB, "
        f"{moe_logits['step_floor_ms']:.3f} ms (all experts: "
        f"{moe_logits['all_experts_floor_ms']:.3f} ms)")

    grouped = run_moe_grouped(mcfg, mparams, dev, moe["generated"])
    log(f"[moe grouped] 1 slot, {grouped['requests']} requests x "
        f"{MOE_GROUPED_TOKENS} tokens: per-token p50 "
        f"{grouped['per_token_ms']['p50']:.2f} ms; launches per decode "
        f"step {grouped['launches_per_step']}; program_modes "
        f"{json.dumps(grouped['program_modes'])}; greedy tokens agreeing "
        f"with the ragged engine {grouped['agreement_with_ragged']}")

    launch_counts = {**{n: engine["launches"][n] for n in FLOAT_KERNELS},
                     "quant_gemv":
                         quant["passes"]["w8"]["launches"]["quant_gemv"],
                     "quant4_gemv":
                         quant["passes"]["w4"]["launches"]["quant4_gemv"],
                     "ragged_gemv": moe["launches"]["ragged_gemv"],
                     "grouped_gemv": grouped["launches"]["grouped_gemv"]}
    line = kernels_line(rows, launch_counts)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        device=dict(name=name, count=count, nvidia_smi=card),
        build_s=build_s, kernel_rows=rows, engine=engine, logits=logits,
        quant_dispatch=quant, kv=kv, moe_engine=moe, moe_logits=moe_logits,
        moe_grouped=grouped, kernels=line["kernels"],
        total_s=time.perf_counter() - t_start), indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
