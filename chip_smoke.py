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
8. the ``{"kernels": [...]}`` line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

A fuller report goes to ``chiprun_out/chip_smoke.json``.  Nothing here
imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import math
import re
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
}
FLOAT_KERNELS = ("pim_gemv", "splitk_gemv")     # the bf16 engine's path
QUANT_KERNELS = ("quant_gemv", "quant4_gemv")
BLOCK = 32                                      # quant scale block


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


def serve(cfg, params, dev, lengths, new_tokens, seed,
          kv_store: str = "fp") -> Engine:
    eng = Engine(cfg, params, batch_slots=8, max_len=1024, device=dev,
                 kv_store=kv_store)
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
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    lengths = [32, 512, 96, 384, 128, 256, 48, 200]
    eng = serve(cfg, params, dev, lengths, 64, SEED, kv_store)
    seen = check_finite_logits(eng)
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
    if not all(counts[n] for n in FLOAT_KERNELS):
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{counts}")
    doc = eng.metrics.to_dict(include_steps=False)
    steps = doc["counters"]["decode_steps"]
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
        "dispatch": dispatch.dispatch_stats(),
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


def kernels_line(rows: list[dict], launch_counts: dict) -> dict:
    """One entry per kernel.  Its top-level times are one olmo-1b decode
    step at batch 8: the sum over the GEMVs at that batch (each shape
    weighted by its calls per step) that the h100 backend -- as the TPU
    backend -- sends to the kernel: for the float kernels the bf16 engine's
    picks, for the quant kernels every GEMV of the quantized pass.
    ``launches`` is the count from the run of the kernel's own path."""
    picks = {"pim_gemv": ("gate_up", "head"), "splitk_gemv": ("qkv", "down"),
             "quant_gemv": tuple(SHAPES), "quant4_gemv": tuple(SHAPES)}
    out = []
    for name, k in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        step = [r for r in mine if r["B"] == 8 and r["shape"] in picks[name]]

        def total(key):
            return sum(r[key] * r["per_step"] for r in step)

        bytes_ms, ops_ms = total("bytes_ms"), total("ops_ms")
        quant = name in QUANT_KERNELS
        entry = {
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": launch_counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # no single PyTorch call computes a block-scaled int8/int4 GEMV
            "library_ms": None if quant else total("library_ms"),
            "basis": "one olmo-1b decode step at batch 8: "
                     + ", ".join(f"{s} x{SHAPES[s][2]}" for s in picks[name]),
            "shapes": [{key: r[key] for key in (
                "shape", "K", "M", "B", "ms", "plain_ms", "library_ms",
                "bound_ms", "max_abs_err") + (
                    ("bf16_matmul_ms", "plan") if quant else ())}
                for r in mine],
        }
        if quant:
            entry["bf16_matmul_ms"] = total("bf16_matmul_ms")
            entry["bf16_matmul_note"] = (
                "torch.matmul on the bf16 weight the codes came from: a "
                "reference point, not the same function")
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

    launch_counts = {**{n: engine["launches"][n] for n in FLOAT_KERNELS},
                     "quant_gemv":
                         quant["passes"]["w8"]["launches"]["quant_gemv"],
                     "quant4_gemv":
                         quant["passes"]["w4"]["launches"]["quant4_gemv"]}
    line = kernels_line(rows, launch_counts)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        device=dict(name=name, count=count, nvidia_smi=card),
        build_s=build_s, kernel_rows=rows, engine=engine, logits=logits,
        quant_dispatch=quant, kv=kv, kernels=line["kernels"],
        total_s=time.perf_counter() - t_start), indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
