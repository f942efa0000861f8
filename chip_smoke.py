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
   ``[stages]``: ``pim_gemv`` and ``splitk_gemv`` at batch 8 at every
   ring depth the card holds, each bit-identical to the default depth,
   and timed (the build step prints each instantiation's registers);
   ``[quant kernels]``: the quant kernels at the same shapes and batch 1,
   4, 8, 11 on int8 / packed int4 codes (block 32) from
   ``quantize_weight`` of seeded bf16 weights, at the plan for the card's
   SMs (CTAs, split degree), f32 x checked at batch 8; timed beside the
   bf16 weight's ``torch.matmul`` at the same shape, a reference point
   that is not the same function; ``[quant stages]``: both at batch 8 at
   every ring depth, bit-identical and timed; then ``[gpu kernels]``:
   ``triton_gemv`` at olmo-1b's four shapes and deepseek-moe-16b's head,
   batch 1, 3, 8, 11 in bf16, against its plain version and timed beside
   ``pim_gemv`` and ``torch.matmul``; f32 and a column view at batch 8;
   ``[gpu stages]``: at batch 8 at every ring depth the card holds,
   bit-identical to the default depth, and timed;
   ``[attention]``: ``decode_attention`` at the engines' shape (8 slots
   of a 1024-position cache, 16 kv heads of 128) on the lengths of a
   decode step midway through the engine's requests, against its plain
   version (and with idle slots past the end, and an all-masked slot),
   then timed beside its bound, the plain version and
   ``scaled_dot_product_attention`` (and with one position a split: the
   kernel's fixed cost); then on int8 and int4 pages of the
   same caches, read in place: bit-identical to the fp kernel on
   ``dequantize_page``'s tensor at every split count, in both cases, and
   timed beside the bound of the codes and scales;
4. engine  -- olmo-1b at full width, bf16, seeded random weights, through
   ``Engine(batch_slots=8, max_len=1024)``: 8 requests with prompts of 32
   to 512 tokens, 64 greedy tokens each.  Every engine phase runs twice:
   with the decode step as one replayed CUDA graph a bucket (the main
   path) and under ``disable_graphs()`` (eager); fails unless the greedy
   tokens are equal both ways.  The wrappers' counters tick when Python
   runs the step: every eager step, and with graphs each bucket's eager
   first step and its capture, never a replay.  Fails unless each counted
   step launched ``pim_gemv`` 17 and ``splitk_gemv`` 32 times, as the
   h100 backend's picks for its GEMVs predict, and ``decode_attention``
   once a layer (16); unless the profiler finds no cast or copy of a
   cache-shaped tensor in the eager decode steps (ATen ops with shapes);
   and unless a profiled window of replayed steps runs every port kernel
   as often as the eager window and no copy kernel more often (kernel
   names; each window is padded with spin kernels on which the
   profiler's lost records fall, and the eager window's records of the
   port's kernels must equal its wrappers' counts).  Per route:
   per-token p50/p90, device busy and idle share, ATen ops and kernels a
   step, peak memory; the capture's seconds by bucket.  TTFT p50 with
   prefill attention's scores from K cast to f32 and from the bf16
   operands, in turns, greedy tokens equal (as in every ``h100`` engine
   phase);
5. logits  -- one decode step of the same engine state through the
   dispatcher and through ``torch.matmul`` (policy pinned to ``ref``);
6. quant   -- every decode GEMV of olmo-1b at full width and depth, batch
   8, through the dispatcher (``dispatch_prepacked`` for the fused QKV and
   gate+up, ``dispatch_gemv`` for down and the head) on int8 and then int4
   weights: fails unless every GEMV took the quant kernel, each program
   shape agrees with its plain version, and the launch counts equal the
   GEMV counts; timed beside the bf16 pass of the same GEMVs;
7. kv      -- the engine's 8 requests again with ``kv_store="int8"`` and
   ``"int4"``: every request completes, every logit is finite, every
   decode step launches ``decode_attention`` once a layer on the codes in
   place and casts or copies no cache-shaped tensor (pages, codes or
   scales); reports latency, device busy, KV bytes per slot and the share
   of greedy tokens that agree with the fp run;
   then ``[gpu engine]``: the same 8 requests on ``Engine(gemv_backend=
   "gpu")``: fails unless each decode step launches ``triton_gemv`` as
   often as the gpu backend's picks for the step's GEMVs predict (the
   head, at least once); greedy tokens are compared with the h100 run;
   then ``[serving]``: olmo-1b with ``kv_store="fp"`` and ``"int8"``
   through ``Engine(prefill_chunk=128, prefix_cache=...)`` on a
   ``gemv_aware`` scheduler at threshold 8 with a preemption margin: 24
   requests of 4 tenants (a shared 384-token prefix and a private tail of
   16 to 128 tokens, 24 tokens each; 8 at step 0, then 2 a step) and two
   urgent requests that each force a preemption on their step, both
   routes; fails unless the greedy tokens are equal both ways, each run
   evicted, ran 24 chunks or more and hit the prefix cache, every hit's
   spliced positions equal its gathered segment byte for byte, no decode
   step with a row mid-prefill in its bucket casts or copies a
   cache-shaped tensor (counted by a dispatch mode around those steps),
   and the replayed steps of a profiled window from the first preemption
   run the eager steps' port kernels; reports TTFT p50 of hits and
   misses, per-token p50/p90, capture seconds, peak memory and the
   segment store's bytes; the plain engine (no chunking, no prefix cache,
   no deadlines) on the same prompts gives the token agreement and the
   first divergent token, printed, not required;
8. moe kernels -- olmo-1b's params are freed; ``ragged_gemv`` and
   ``grouped_gemv`` at deepseek-moe-16b's expert shapes (gate/up K=2048
   M=1408, down K=1408 M=2048, E=64) in bf16, each against its plain
   version, then timed: ragged on four routings (8 tokens top-6, T=48; 1
   token, T=6; 8 rows on one expert; counts short of T, tail rows) at the
   plan for the card's SMs (live CTAs and split degree printed; equal from
   run to run), beside padded ``torch.bmm``; on both top-6 routings at
   every ring depth (bit-identical) and every split degree (within
   tolerance), timed; grouped at C=8 (and C=16, 64 checked); the bound
   counts only the experts that have rows; grouped at C=8 at every ring
   depth, bit-identical, timed;
9. moe engine -- deepseek-moe-16b at full width and depth (28 layers), bf16,
   seed 0, ``Engine(batch_slots=8, max_len=1024)``, the same 8 requests:
   fails unless ``ragged_gemv`` launched three times per layer on every
   decode step, every ragged program took the native mode, and
   ``decode_attention`` launched once a layer (28) with no cast or copy
   of a cache-shaped tensor in the decode steps;
10. moe logits -- one decode step of that engine state through the kernels
   and through the portable plain path (``kernel="ref"``,
   ``use_pallas=False``): the max |diff| of the logits and the argmax
   agreement are reported; each layer's MoE block is held to its tolerance
   on the inputs the kernel step gave it;
11. moe grouped -- ``Engine(batch_slots=1, gemv_expert_shape="grouped")``
   serves 2 of the requests, 16 tokens each, both ways: fails unless
   ``grouped_gemv`` launched three times a layer on each counted step;
   greedy tokens are compared with the ragged
   engine's; then ``[moe gpu]``: the 8 requests, 16 tokens each, on
   ``Engine(gemv_backend="gpu")``: fails unless every decode step
   launches ``ragged_gemv`` three times a layer under mode
   ``gpu:ragged_triton`` and ``triton_gemv`` as the picks predict; then
   ``[serving]`` on deepseek-moe-16b (ragged, fp KV, 8 requests of 2
   tenants, 16 tokens each, the same rules otherwise);
12. families -- deepseek-moe-16b's params are freed; ``[families
   kernels]``: ``pim_gemv`` and ``splitk_gemv`` at every decode GEMV shape
   of minitron-8b, gemma3-1b and gemma3-27b (QKV, gate+up or up, down,
   the head; K 1152, 5376, 6912 among them) at batch 1 and 8 in bf16, at
   the plan for the card's SMs, against their plain versions and timed
   beside their bound and ``torch.matmul``; ``decode_attention`` at each
   family's shape (8 slots of a 2048-position cache; 8 kv heads of 128 at
   G 4, 1 of 256 at G 4, 16 of 128 at G 2) with a window of 1024 and
   none, on rows shorter than, at and longer than the window and idle
   slots past the end (one past C + window - 1), at every split count,
   and on int8 / int4 pages bit-identical to the fp kernel; the two
   windows must differ on a row longer than 1024; timed per window.
   ``[families engine]``: each family at full width (minitron-8b and
   gemma3-1b at full depth, gemma3-27b at 12 of 62 layers), bf16, seed
   0, ``Engine(batch_slots=8, max_len=2048)``, 8 requests of 64 to 1536
   tokens (three longer than the window), 32 greedy tokens each, both
   routes; the engine phase's rules (tokens equal, ``decode_attention``
   once a layer, ``pim_gemv`` / ``splitk_gemv`` as the picks predict --
   an ungated FFN's up is its own site and gemma3-1b's QKV stays on
   ``ref`` -- no cache-shaped cast or copy, the replayed window's port
   kernels); ``[families logits]``: one decode step through the kernels
   and through ``kernel="ref"``, max |diff| and argmax agreement
   reported; each family's weights are freed before the next's;
13. multimodal -- ``[multimodal kernels]``: ``decode_attention`` at
   whisper-small's self shape (12 kv heads of 64, G 1, a 1024-position
   cache) and cross shape (over 1500 encoder frames) and
   llama-3.2-vision-11b's cross shape (8 kv heads of 128, G 4, over 1601
   patch embeddings): the routing rule must take each; against the plain
   version at every split count (a cross call, the causal query at Sk - 1
   over all Sk keys, against the plain non-causal query), then timed
   beside its bound (the valid K and V bytes), the plain version and
   ``scaled_dot_product_attention``; ``pim_gemv`` and ``splitk_gemv`` at
   llama-3.2-vision-11b's four decode GEMV shapes at batch 1 and 8, as in
   ``[families kernels]``.  ``[multimodal engine]``: each model at full
   width and depth, bf16, seed 0, every ``cross_gate`` set to 1.0 (the
   init's zeros switch llama-vision's cross-attention off),
   ``Engine(batch_slots=8, max_len=1024)``, the 8 requests of 32 to 512
   tokens, 32 greedy tokens each, both routes, the engine phase's rules
   (tokens equal, ``decode_attention`` once a layer and once a
   cross-attending layer -- 24 a step for whisper-small, 48 for
   llama-vision -- ``pim_gemv`` / ``splitk_gemv`` as the picks predict:
   41 / 80 a step for llama-vision, none for whisper-small, whose GEMVs
   all stay on ``ref``; no cache-shaped cast or copy; the replayed
   window's port kernels); the device ms a step spends recomputing the
   encoder and the cross K / V from the features, as the reference does
   every step; ``[multimodal logits]``: one decode step through the
   kernels and through ``kernel="ref"``; each model's weights are freed
   before the next's;
14. state -- ``[state kernels]``: ``pim_gemv`` and ``splitk_gemv`` at
   rwkv6-3b's tied head (K 2560, M 65536) at batch 1 and 8, as in
   ``[families kernels]``.  ``[state engine]``: rwkv6-3b at full width
   and depth (32 layers, no attention: time-mix over a recurrent f32
   state of 40 heads of 64, channel-mix), bf16, seed 0, with the
   parameters the init hides drawn afresh and the time-mix projections
   scaled by 4 (as the CPU tests do) so that the state matters;
   ``Engine(batch_slots=8, max_len=1024)``, the 8 requests of 32 to 512
   tokens (each prefilled alone at its exact length), 32 greedy tokens
   each, both routes, the engine phase's rules: tokens equal, one
   ``pim_gemv`` launch a decode step (the head) and no other port
   kernel, the replayed window's port kernels; ``[state logits]``: one
   decode step through the kernel and through ``kernel="ref"``; ``[state
   drift]``: one 448-token prompt prefilled whole and in chunks of 128,
   16 greedy tokens each way, in bf16 (as perturbed, and with the
   projections unscaled) and in f32: how far the two batchings drift
   apart; then ``[state serving]``, with the weights cast to f32 (the
   bf16 model's drift is O(1)): the ``[serving]`` rules on a mix of 12
   requests of 2 tenants (384-token prefixes, 16-64-token tails, 16
   tokens each) and the two urgent requests, chunk 128, the prefix cache
   holding state snapshots at chunk boundaries: tokens equal on both
   routes AND equal to the plain engine's (a stream may part from it
   only where the top-2 logit margin is below ``NEAR_TIE``), prefix
   hits, preemption, and every decode step with a row mid-prefill leaves
   that row's state bit-equal, its whole state rows copied only by the
   engine's save and restore;
15. hybrid -- ``[hybrid kernels]``: ``pim_gemv`` and ``splitk_gemv`` at
   every decode GEMV shape of hymba-1.5b (QKV 1600 -> 2240, gate+up 1600
   -> 11008, down 5504 -> 1600, the tied head of 32001, which no kernel
   takes) at batch 1 and 8, and ``decode_attention`` at its shape (5 kv
   heads of 64, G 5, 8 slots of a 2048-position cache) with a window of
   1024 and none, as in ``[families kernels]``.  ``[hybrid engine]``:
   hymba-1.5b at full width and depth (32 layers: attention, 30 of them
   in a 1024-position window, beside Mamba heads of inner width 3200 over
   an f32 state of 16 a channel), bf16, seed 0, with the betas, ``D``,
   ``dt_bias`` and ``A_log`` drawn afresh as the CPU tests draw them;
   ``Engine(batch_slots=8, max_len=2048)``, the families' 8 prompts of 64
   to 1536 tokens (each prefilled alone at its exact length), 32 greedy
   tokens each, both routes, the engine phase's rules (tokens equal,
   ``decode_attention`` 32 a step, ``pim_gemv`` / ``splitk_gemv`` as the
   picks predict: 32 + 32, QKV and the head stay on ``ref``; no
   cache-shaped cast or copy; the replayed window's port kernels);
   ``[hybrid logits]``; then ``[hybrid serving]`` with the weights cast
   to f32: the ``[serving]`` rules on 10 requests of 2 tenants (384-token
   prefixes, 16-64-token tails, 16 tokens each) and the two urgent
   requests, chunk 128, the prefix cache holding K/V spans and state
   snapshots at chunk boundaries: tokens equal on both routes AND equal
   to the plain engine's (but at a near tie), prefix hits, preemption,
   and the rows mid-prefill bit-equal across each decode step; to run
   the phase alone: ``python3 -c "import torch, chip_smoke as cs; from
   repro_torch.kernels import _build; _build.build(force=True);
   cs.warm_profiler(); cs.run_hybrid(torch.device('cuda', 0))"``;
16. autotune -- olmo-1b's decode GEMVs at batch 8, a fused QKV program and
   a ragged expert program, tuned on the h100 and gpu backends into
   ``build/autotune_smoke.json`` (``pim``/``splitk`` at every ring depth,
   labelled ``pim/s4`` etc.; each candidate timed as the best of 3
   replays of a captured graph over weight copies read cold, and printed
   beside its host-wall time, with the winner the host clock would pick
   and whether it moved); table and plan cache cleared, the file
   reloaded, and every untuned pick must be the table's winner; then a
   table written before the streaming kernels (one-stage plans with
   1024-row K chunks, and grouped and ragged expert programs on the first
   expert kernels' tiles) replays: each GEMV keeps its kernel on a
   re-planned plan and matches its plain version;
17. pim -- the paper's LPDDR5X-PIM model (modeled numbers, not this card):
   the roofline boost, opt-6.7b FC1's PIMnast speedup and every OPT
   model's per-token speedup; then olmo-1b's full-width gate+up weight
   (16384 x 2048, seeded, bf16) placed by PIMnast and materialized on the
   card: fails unless the stream is bit-equal to the same call on a CPU
   copy, untiling it recovers the weight bit for bit and every matrix row
   lies in one bank; prints the tiles and rows per bank, min and max;
18. calibrate -- ``run_sweep`` (the full sweep: the reference's shapes,
   bf16, every record a replayed graph over weight copies read cold) on
   the h100 and gpu backends, ``fit_cost_model``, the artifacts under
   ``build/calibration/``: fails unless each fitted MAPE is at most the
   seed's, the sweeps launched ``pim_gemv``, ``splitk_gemv``,
   ``quant_gemv``, ``grouped_gemv``, ``ragged_gemv`` and ``triton_gemv``
   (counts set to 0 before, read after) and recorded each backend's
   kernels and native program modes; prints the MAPE per kernel and
   program mode (seed and fitted), the fitted constants, and olmo-1b's
   decode GEMVs at batch 8 picked by the seed and by the fitted model,
   each timed on the card; then both backends go back to their seeds;
19. the ``{"kernels": [...]}`` line (``decode_attention_g5``: the G 5
   instance over one hymba-1.5b step), the card line, and the last line
   ``{"ok": true, "device": {...}}``.

A fuller report goes to ``chiprun_out/chip_smoke.json``.  Nothing here
imports JAX or the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
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
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build, dispatch  # noqa: E402
from repro_torch.kernels.backends import (  # noqa: E402
    DispatchPolicy,
    GemvKey,
    GemvProgram,
    get_backend,
)
from repro_torch.kernels.backends.base import (  # noqa: E402
    ProgramPlan,
    _synthesize_program,
    entry_to_plan,
    expert_batch_bound,
    plan_to_entry,
    program_plan_to_entry,
    synthesize_gemv,
    time_gemv_us,
    wall_trials_us,
    weight_copies,
)
from repro_torch.calibration import (  # noqa: E402
    fit_cost_model,
    mape,
    run_sweep,
    write_artifact,
)
from repro_torch.calibration.fit import _swapped_cost_model  # noqa: E402
from repro_torch.core.opt_models import OPT_SUITE  # noqa: E402
from repro_torch.core.pim_arch import (  # noqa: E402
    BF16 as PIM_BF16,
    INT8 as PIM_INT8,
    RYZEN_LPDDR5X,
)
from repro_torch.core.placement import (  # noqa: E402
    GEMV,
    cr_order,
    cr_order_with_degree,
    materialize,
    plan_placement,
    untile_matrix_roworder,
)
from repro_torch.pim.e2e import e2e_latency  # noqa: E402
from repro_torch.pim.timing import pim_speedup  # noqa: E402
from repro_torch.kernels.backends.gpu import plan_triton_gemv  # noqa: E402
from repro_torch.kernels.attention import (  # noqa: E402
    decode_attention,
    decode_attention_plain,
    kernel_applies,
    plan_splits,
    smem_bytes,
)
from repro_torch.kernels.grouped_gemv import (  # noqa: E402
    counts_to_offsets,
    grouped_gemv,
    grouped_gemv_plain,
    ragged_gemv,
    ragged_gemv_plain,
)
from repro_torch.kernels.gemv_plan import (  # noqa: E402
    MAX_STAGES,
    SMEM_PER_CTA,
    GemvPlan,
    ctas_per_sm,
    grouped_plan_fits,
    plan_fits,
    plan_gemv,
    RAGGED_DEGREES,
    plan_grouped_stream,
    plan_quant,
    plan_ragged_stream,
    plan_splitk,
    quant_candidates,
    ragged_box_rows,
    ragged_plan_fits,
    stream_rows,
    stream_smem,
    sub_rows,
    valid_splitk_degree,
    with_pipeline_depth,
)
from repro_torch.kernels.kv_quant import (  # noqa: E402
    dequantize_page,
    quantize_page,
    tree_bytes,
)
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
from repro_torch.kernels.triton_gemv import (  # noqa: E402
    body_ctas,
    triton_gemv,
    triton_gemv_plain,
)
from repro_torch.kernels.triton_gemv import (  # noqa: E402
    plan_fits as triton_plan_fits,
)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.layers import GATED  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import disable_graphs  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Engine,
    Request,
    make_features,
)
from repro_torch.serving.prefix_cache import PrefixCacheConfig  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # H100 SXM data sheet, dense bf16
L2_BYTES = 50 * 2**20
# A kernel and its plain version both sum f32 products, in other orders,
# and round once to bf16: they may differ by one bf16 ulp of the result
# (relative 2**-7 at worst) plus f32 order noise near zero.
KERNEL_RTOL, KERNEL_ATOL = 2.0**-7, 1e-3
BATCHES = (1, 4, 8)
QUANT_BATCHES = (1, 4, 8, 11)
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
    "triton_gemv": dict(
        fn=triton_gemv, plain=triton_gemv_plain,
        source="src/repro_torch/csrc/triton_gemv.cu",
        replaces="src/repro/kernels/triton_gemv.py:78"),
    # no Pallas kernel: the reference's attention_core is XLA einsums
    "decode_attention": dict(
        fn=decode_attention, plain=decode_attention_plain,
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/models/layers.py:102"),
}
GEMV_KERNELS = tuple(k for k in KERNELS if k != "decode_attention")
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
MOE_GPU_TOKENS = 16

# triton_gemv: olmo-1b's four decode GEMV shapes and deepseek-moe-16b's
# head (K, M, calls per decode step on its path; the gpu backend sends
# only the heads to the kernel), checked at these batches in bf16 and
# timed at all of them; f32 and a column view are checked at batch 8
TRITON_SHAPES = {**SHAPES, "moe_head": (2048, 102400, 1)}
TRITON_BATCHES = (1, 3, 8, 11)
MOE_CHECK_C = (16, 64)      # grouped rows an expert checked beside C=8

# decode attention at the engines' shape: both models have 16 kv heads of
# 128 (G = 1) over an 8-slot, 1024-position cache; the valid lengths of a
# decode step midway through the engine's requests (prompt + 32 tokens)
ATTN_SLOTS, ATTN_C, ATTN_HKV, ATTN_D = 8, 1024, 16, 128
ATTN_VALID = [n + 32 for n in (32, 512, 96, 384, 128, 256, 48, 200)]
# bf16 output of sums in other orders: one bf16 ulp (2**-7 relative) of
# the output, plus one bf16 ulp of a probability at a rounding boundary
# (2**-8 relative) times max|v|
ATTN_RTOL = 2.0**-7
AUTOTUNE_TABLE = ROOT / "build" / "autotune_smoke.json"


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


def plan_dict(plan) -> dict:
    return dict(m_blk=plan.m_blk, k_blk=plan.k_blk, split_k=plan.split_k,
                stages=plan.stages, smem_bytes=plan.smem_bytes,
                ctas=plan.n_m * plan.split_k,
                ctas_per_sm=ctas_per_sm(plan.smem_bytes))


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


def check_kernels(dev, shapes=SHAPES, batches=BATCHES,
                  arch: str = "olmo-1b") -> list[dict]:
    """``pim_gemv`` and ``splitk_gemv`` at ``shapes`` ({name: (K, M, calls
    a decode step)}) and ``batches``, each against its plain version at
    the plan for the card's SMs, then timed beside its bound, the plain
    version and ``torch.matmul``.  Rows of another arch than olmo-1b name
    their shape ``arch/name``."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for shape, (K, M, per_step) in shapes.items():
        if arch != "olmo-1b":
            shape = f"{arch}/{shape}"
        w_bytes = K * M * 2
        n_copies = max(2, math.ceil(2 * L2_BYTES / w_bytes) + 1)
        ws = [(torch.randn((K, M), generator=gen, device=dev)
               / math.sqrt(K)).to(torch.bfloat16) for _ in range(n_copies)]
        for B in batches:
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
                    kernel=name, arch=arch, shape=shape, K=K, M=M, B=B,
                    per_step=per_step, plan=plan_dict(plan),
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
                    f" matmul={row['library_ms']:.4f} m_blk={plan.m_blk}"
                    f" ctas={row['plan']['ctas']}"
                    f" ({row['plan']['ctas_per_sm']}/SM)"
                    f" stages={plan.stages}")
        del ws
        torch.cuda.empty_cache()
    return rows


def stage_sweep(dev) -> list[dict]:
    """pim_gemv and splitk_gemv at olmo-1b's four decode GEMV shapes, batch
    8, bf16, at every ring depth ``with_pipeline_depth`` admits: each
    output must equal the default depth's bit for bit (the depth changes
    the copies in flight, never the order of the sums); each depth is
    timed as in ``check_kernels`` (weights rotated past the L2)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    rows, B = [], 8
    for shape, (K, M, _) in SHAPES.items():
        w_bytes = K * M * 2
        n_copies = max(2, math.ceil(2 * L2_BYTES / w_bytes) + 1)
        ws = [(torch.randn((K, M), generator=gen, device=dev)
               / math.sqrt(K)).to(torch.bfloat16) for _ in range(n_copies)]
        x = torch.randn((B, K), generator=gen, device=dev).to(torch.bfloat16)
        calls = 100 if w_bytes < 100e6 else 40
        for name in FLOAT_KERNELS:
            fn = KERNELS[name]["fn"]
            base, _ = plan_for(name, K, M, B)
            want = fn(x, ws[0], plan=base)
            times = {}
            for depth in range(1, MAX_STAGES + 1):
                plan = with_pipeline_depth(base, depth, batch=B,
                                           elem_bytes=2)
                if plan is None:
                    continue
                if not torch.equal(fn(x, ws[0], plan=plan), want):
                    raise AssertionError(
                        f"{name} {shape}: stages={depth} differs from the "
                        f"default stages={base.stages}")

                def run(i, fn=fn, plan=plan):
                    fn(x, ws[i % n_copies], plan=plan)

                times[depth] = graph_ms(run, calls)
                rows.append(dict(kernel=name, shape=shape, K=K, M=M, B=B,
                                 default_stages=base.stages,
                                 plan=plan_dict(plan), ms=times[depth]))
            log(f"  {name:12s} {shape:8s} B={B} bit-identical at stages "
                f"{sorted(times)} (default {base.stages}); ms "
                + " ".join(f"s{d}={t:.4f}" for d, t in times.items()))
        del ws
        torch.cuda.empty_cache()
    return rows


def ptxas_table(report: dict) -> list[dict]:
    """Registers, spills and shared memory of each kernel instantiation
    from the ``-Xptxas -v`` text of ``_build.build``."""
    rows = []
    for src, r in report.items():
        fn = None
        for ln in r["ptxas"].splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", ln)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", ln)
            if m and fn:
                rows.append(dict(source=src, function=fn,
                                 registers=int(m.group(1)), line=ln.strip()))
    names = [r["function"] for r in rows]
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0:
            for r, d in zip(rows, out.stdout.splitlines()):
                r["demangled"] = d.replace("(anonymous namespace)::",
                                           "").split("(")[0].replace(
                                               "void ", "")
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def quant_plan_dict(plan) -> dict:
    return dict(m_blk=plan.m_blk, k_blk=plan.k_blk, split_k=plan.split_k,
                stages=plan.stages, smem_bytes=plan.smem_bytes,
                ctas=plan.n_m * plan.split_k)


def quant_packs(gen, dev, K, M, n_copies):
    """``n_copies`` seeded bf16 weights [M, K] as int8 and int4 codes
    (block 32, ``quantize_weight`` on the card, checked byte-equal to the
    CPU's), and the weights K-major for ``torch.matmul``."""
    ws = [(torch.randn((M, K), generator=gen, device=dev)
           / math.sqrt(K)).to(torch.bfloat16) for _ in range(n_copies)]
    packs = {bits: [quantize_weight(w, bits=bits, block=BLOCK) for w in ws]
             for bits in (8, 4)}
    for bits, pws in packs.items():   # the card's codes are the host's
        host = quantize_weight(ws[0].cpu(), bits=bits, block=BLOCK)
        if not (torch.equal(pws[0].w_t.cpu(), host.w_t)
                and torch.equal(pws[0].scales.cpu(), host.scales)):
            raise AssertionError(f"int{bits} ({K}, {M}): quantize_weight "
                                 f"on the card differs from the CPU's")
    return packs, [w.t().contiguous() for w in ws]


def quant_copies(K, M) -> int:
    """Weight copies whose int4 codes rotate past the L2."""
    int4_bytes = K * M // 2 + (K // BLOCK) * M * 4
    return max(2, math.ceil(2 * L2_BYTES / int4_bytes) + 1)


def check_quant_kernels(dev, sms: int) -> list[dict]:
    """quant_gemv / quant4_gemv at olmo-1b's decode GEMV shapes and batch
    1, 4, 8, 11, bf16 x, block 32, at the plan for the card's SMs: each
    against its plain version, then timed like the float kernels.
    ``bf16_matmul_ms`` is ``torch.matmul`` on the bf16 weight the codes
    came from at the same shape: a reference point, not the same function
    (no single PyTorch call computes a block-scaled int8/int4 GEMV).  At
    batch 8 also f32 x, checked."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    rows = []
    for shape, (K, M, per_step) in SHAPES.items():
        n_copies = quant_copies(K, M)
        packs, ws_t = quant_packs(gen, dev, K, M, n_copies)
        for B in QUANT_BATCHES:
            x = torch.randn((B, K), generator=gen, device=dev).to(
                torch.bfloat16)
            for name in QUANT_KERNELS:
                k = KERNELS[name]
                bits = k["bits"]
                pws = packs[bits]
                plan = plan_quant(M, K, B, bits=bits, block=BLOCK, sms=sms)
                out = k["fn"](x, pws[0].w_t, pws[0].scales, block=BLOCK,
                              plan=plan)
                torch.cuda.synchronize()
                max_err = check_close(
                    name, f"{shape} B={B}", out,
                    k["plain"](x, pws[0].w_t, pws[0].scales, BLOCK))
                code_bytes = pws[0].w_t.numel() + pws[0].scales.numel() * 4
                calls = 100 if code_bytes < 50e6 else 40

                def run(i, fn=k["fn"], pws=pws, plan=plan, x=x):
                    pw = pws[i % n_copies]
                    fn(x, pw.w_t, pw.scales, block=BLOCK, plan=plan)

                def run_plain(i, plain=k["plain"], pws=pws, x=x):
                    pw = pws[i % n_copies]
                    plain(x, pw.w_t, pw.scales, BLOCK)

                def run_matmul(i, x=x):
                    torch.matmul(x, ws_t[i % n_copies])

                io_bytes = code_bytes + (B * K + B * M) * 2
                row = dict(
                    kernel=name, shape=shape, K=K, M=M, B=B, bits=bits,
                    per_step=per_step, plan=quant_plan_dict(plan),
                    max_abs_err=max_err,
                    ms=graph_ms(run, calls),
                    plain_ms=graph_ms(run_plain, max(calls // 4, 10)),
                    library_ms=None,
                    bf16_matmul_ms=graph_ms(run_matmul, calls),
                    bytes_ms=io_bytes / HBM_BYTES_PER_S * 1e3,
                    # the codes are exact in bf16 and the scale factors
                    # out of each block: the products run on bf16 tensor
                    # cores, whose rate is the operations bound
                    ops_ms=2 * B * K * M / BF16_FLOPS * 1e3)
                row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
                row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                                   else "operations")
                row["hbm_share"] = row["bound_ms"] / row["ms"]
                if B == 8:
                    x32 = x.float()
                    p32 = plan_quant(M, K, B, bits=bits, block=BLOCK,
                                     elem_bytes=4, sms=sms)
                    row["f32_max_abs_err"] = check_close(
                        name, f"{shape} f32 B={B}",
                        k["fn"](x32, pws[0].w_t, pws[0].scales, block=BLOCK,
                                plan=p32),
                        k["plain"](x32, pws[0].w_t, pws[0].scales, BLOCK))
                rows.append(row)
                log(f"  {name:12s} {shape:8s} B={B:2d} err={max_err:.2e}"
                    f" ms={row['ms']:.4f} bound={row['bound_ms']:.4f}"
                    f" ({row['hbm_share']:.0%}) plain={row['plain_ms']:.4f}"
                    f" bf16 matmul={row['bf16_matmul_ms']:.4f}"
                    f" m_blk={plan.m_blk} split={plan.split_k}"
                    f" ctas={row['plan']['ctas']} k_blk={plan.k_blk}"
                    f" stages={plan.stages}"
                    + (f" f32 err={row['f32_max_abs_err']:.2e}"
                       if B == 8 else ""))
        del packs, ws_t
        torch.cuda.empty_cache()
    return rows


def quant_stage_sweep(dev, sms: int) -> list[dict]:
    """quant_gemv and quant4_gemv at olmo-1b's four decode GEMV shapes,
    batch 8, bf16, at every ring depth ``with_pipeline_depth`` admits:
    each output must equal the default depth's bit for bit; each depth is
    timed as in ``check_quant_kernels``."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 75)
    rows, B = [], 8
    for shape, (K, M, _) in SHAPES.items():
        n_copies = quant_copies(K, M)
        packs, ws_t = quant_packs(gen, dev, K, M, n_copies)
        del ws_t
        x = torch.randn((B, K), generator=gen, device=dev).to(torch.bfloat16)
        for name in QUANT_KERNELS:
            fn, bits = KERNELS[name]["fn"], KERNELS[name]["bits"]
            pws = packs[bits]
            base = plan_quant(M, K, B, bits=bits, block=BLOCK, sms=sms)
            want = fn(x, pws[0].w_t, pws[0].scales, block=BLOCK, plan=base)
            times = {}
            for depth in range(1, MAX_STAGES + 1):
                plan = with_pipeline_depth(base, depth, batch=B,
                                           elem_bytes=2, bits=bits,
                                           block=BLOCK)
                if plan is None:
                    continue
                got = fn(x, pws[0].w_t, pws[0].scales, block=BLOCK,
                         plan=plan)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{name} {shape}: stages={depth} differs from the "
                        f"default stages={base.stages}")

                def run(i, fn=fn, pws=pws, plan=plan):
                    pw = pws[i % n_copies]
                    fn(x, pw.w_t, pw.scales, block=BLOCK, plan=plan)

                times[depth] = graph_ms(run, 40)
                rows.append(dict(kernel=name, shape=shape, K=K, M=M, B=B,
                                 default_stages=base.stages,
                                 plan=quant_plan_dict(plan),
                                 ms=times[depth]))
            log(f"  {name:12s} {shape:8s} B={B} bit-identical at stages "
                f"{sorted(times)} (default {base.stages}); ms "
                + " ".join(f"s{d}={t:.4f}" for d, t in times.items()))
        del packs
        torch.cuda.empty_cache()
    return rows


def quant_plan_sweep(dev, sms: int) -> list[dict]:
    """quant_gemv and quant4_gemv at olmo-1b's four decode GEMV shapes,
    batch 8, bf16, at every plan of ``quant_candidates`` (split degree x
    column block, default depth): each against its plain version, timed as
    in ``check_quant_kernels``; the planner's pick is marked."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 77)
    rows, B = [], 8
    for shape, (K, M, _) in SHAPES.items():
        n_copies = quant_copies(K, M)
        packs, ws_t = quant_packs(gen, dev, K, M, n_copies)
        del ws_t
        x = torch.randn((B, K), generator=gen, device=dev).to(torch.bfloat16)
        for name in QUANT_KERNELS:
            fn, plain = KERNELS[name]["fn"], KERNELS[name]["plain"]
            bits = KERNELS[name]["bits"]
            pws = packs[bits]
            pick = plan_quant(M, K, B, bits=bits, block=BLOCK, sms=sms)
            want = plain(x, pws[0].w_t, pws[0].scales, BLOCK)
            times = {}
            for plan in quant_candidates(M, K, B, bits=bits, block=BLOCK):
                tag = f"{plan.m_blk}x{plan.split_k}"
                check_close(name, f"{shape} plan {tag}",
                            fn(x, pws[0].w_t, pws[0].scales, block=BLOCK,
                               plan=plan), want)

                def run(i, fn=fn, pws=pws, plan=plan):
                    pw = pws[i % n_copies]
                    fn(x, pw.w_t, pw.scales, block=BLOCK, plan=plan)

                times[tag] = graph_ms(run, 40)
                rows.append(dict(kernel=name, shape=shape, K=K, M=M, B=B,
                                 picked=plan == pick,
                                 plan=quant_plan_dict(plan),
                                 ms=times[tag]))
            log(f"  {name:12s} {shape:8s} B={B} m_blk x split: "
                + " ".join(f"{t}={ms:.4f}" for t, ms in times.items())
                + f" (pick {pick.m_blk}x{pick.split_k})")
        del packs
        torch.cuda.empty_cache()
    return rows


def check_triton_kernels(dev) -> list[dict]:
    """triton_gemv at olmo-1b's decode GEMV shapes and deepseek-moe-16b's
    head, batch 1, 3, 8, 11 in bf16: each against its plain version, then
    timed beside its bound, the plain version, ``pim_gemv`` (where it
    takes the batch) and ``torch.matmul``; then at batch 8 in f32 and on a
    column view of a weight twice as wide (checked only)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    rows = []
    for shape, (K, M, per_step) in TRITON_SHAPES.items():
        w_bytes = K * M * 2
        n_copies = max(2, math.ceil(2 * L2_BYTES / w_bytes) + 1)
        ws = [(torch.randn((K, M), generator=gen, device=dev)
               / math.sqrt(K)).to(torch.bfloat16) for _ in range(n_copies)]
        for B in TRITON_BATCHES:
            x = torch.randn((B, K), generator=gen, device=dev).to(
                torch.bfloat16)
            plan = plan_triton_gemv(M, K, B)
            out = triton_gemv(x, ws[0], plan=plan)
            torch.cuda.synchronize()
            max_err = check_close("triton_gemv", f"{shape} B={B}", out,
                                  triton_gemv_plain(x, ws[0], plan.k_blk))
            calls = 100 if w_bytes < 100e6 else 40

            def run(i, plan=plan, x=x):
                triton_gemv(x, ws[i % n_copies], plan=plan)

            def run_plain(i, k_blk=plan.k_blk, x=x):
                triton_gemv_plain(x, ws[i % n_copies], k_blk)

            def run_lib(i, x=x):
                torch.matmul(x, ws[i % n_copies])

            pim_ms = None
            if B <= 8:
                pplan = plan_gemv(M, K, B, elem_bytes=2)

                def run_pim(i, pplan=pplan, x=x):
                    pim_gemv(x, ws[i % n_copies], plan=pplan)

                pim_ms = graph_ms(run_pim, calls)
            io_bytes = (K * M + B * K + B * M) * 2
            row = dict(
                kernel="triton_gemv", shape=shape, K=K, M=M, B=B,
                per_step=per_step, plan=dict(m_blk=plan.m_blk,
                                             k_blk=plan.k_blk,
                                             stages=plan.stages,
                                             ctas=body_ctas(plan)),
                max_abs_err=max_err, ms=graph_ms(run, calls),
                plain_ms=graph_ms(run_plain, max(calls // 4, 10)),
                library_ms=graph_ms(run_lib, calls), pim_ms=pim_ms,
                bytes_ms=io_bytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=2 * B * K * M / BF16_FLOPS * 1e3)
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                               else "operations")
            row["hbm_share"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            log(f"  triton_gemv  {shape:8s} B={B:2d} m_blk={plan.m_blk} "
                f"ctas={body_ctas(plan)} err={max_err:.2e} "
                f"ms={row['ms']:.4f} "
                f"bound={row['bound_ms']:.4f} ({row['hbm_share']:.0%}) "
                f"plain={row['plain_ms']:.4f} pim="
                + (f"{pim_ms:.4f}" if pim_ms is not None else "n/a")
                + f" matmul={row['library_ms']:.4f}")
        # f32 (scalar FMAs) and a column view, at batch 8
        plan = plan_triton_gemv(M, K, 8)
        x32 = torch.randn((8, K), generator=gen, device=dev)
        w32 = ws[0].float()
        err32 = check_close("triton_gemv", f"{shape} f32 B=8",
                            triton_gemv(x32, w32, plan=plan),
                            triton_gemv_plain(x32, w32, plan.k_blk))
        del w32
        wide = torch.cat([ws[1], ws[0]], dim=1)
        x = torch.randn((8, K), generator=gen, device=dev).to(torch.bfloat16)
        out = triton_gemv(x, wide[:, M:], plan=plan)
        if not torch.equal(out, triton_gemv(x, ws[0], plan=plan)):
            raise AssertionError(f"triton_gemv {shape}: the column view "
                                 f"differs from the contiguous weight")
        check_close("triton_gemv", f"{shape} column view B=8", out,
                    triton_gemv_plain(x, ws[0], plan.k_blk))
        log(f"  triton_gemv  {shape:8s} f32 B=8 err={err32:.2e}; column "
            f"view (row stride {2 * M}) equal to the contiguous weight")
        rows[-1]["f32_max_abs_err"] = err32
        del ws, wide
        torch.cuda.empty_cache()
    return rows


def triton_stage_sweep(dev) -> list[dict]:
    """triton_gemv at batch 8 on olmo-1b's and deepseek-moe-16b's heads
    (the gpu backend's picks) at every ring depth the card holds: each
    output must equal the default depth's bit for bit; each depth is
    timed as in ``check_kernels``."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    rows, B = [], 8
    for shape in ("head", "moe_head"):
        K, M, _ = TRITON_SHAPES[shape]
        n_copies = max(2, math.ceil(2 * L2_BYTES / (K * M * 2)) + 1)
        ws = [(torch.randn((K, M), generator=gen, device=dev)
               / math.sqrt(K)).to(torch.bfloat16) for _ in range(n_copies)]
        x = torch.randn((B, K), generator=gen, device=dev).to(torch.bfloat16)
        base = plan_triton_gemv(M, K, B)
        want = triton_gemv(x, ws[0], plan=base)
        times = {}
        for depth in range(1, MAX_STAGES + 1):
            plan = dataclasses.replace(base, stages=depth)
            if not triton_plan_fits(plan, M, K, B, 2):
                continue
            if not torch.equal(triton_gemv(x, ws[0], plan=plan), want):
                raise AssertionError(f"triton_gemv {shape}: stages={depth} "
                                     f"differs from the default "
                                     f"stages={base.stages}")

            def run(i, plan=plan):
                triton_gemv(x, ws[i % n_copies], plan=plan)

            times[depth] = graph_ms(run, 40)
            rows.append(dict(kernel="triton_gemv", shape=shape, K=K, M=M,
                             B=B, default_stages=base.stages,
                             stages=depth, ctas=body_ctas(plan),
                             ms=times[depth]))
        log(f"  triton_gemv  {shape:8s} B={B} bit-identical at stages "
            f"{sorted(times)} (default {base.stages}, {body_ctas(base)} "
            f"CTAs); ms " + " ".join(f"s{d}={t:.4f}"
                                     for d, t in times.items()))
        del ws
        torch.cuda.empty_cache()
    return rows


def attention_bound(valid, B, H, Hkv, D, elem=2, bits=16) -> dict:
    """The valid K and V bytes of each slot (a quantized store: their codes
    and one f32 scale a page), q and out, over HBM bandwidth; the
    operations 2 * 2 * H * n * D (scores and P.V) over bf16 peak."""
    n = sum(valid)
    page = D * elem if bits == 16 else D * bits // 8 + 4
    io = 2 * n * Hkv * page + 2 * B * H * D * elem
    bytes_ms = io / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * H * n * D / BF16_FLOPS * 1e3
    return dict(bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def check_attention(dev, layers: int) -> list[dict]:
    """decode_attention at the engines' shape: against its plain version on
    the lengths of a mid-run decode step, on a bucket with idle slots past
    the end and an all-masked slot, at every split count; then timed (the
    caches rotated past the L2) beside its bound, the plain version and
    ``scaled_dot_product_attention`` on the same inputs (a boolean mask
    of the valid positions).  ``per_step`` is ``layers`` launches."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    B, C, Hkv, D = ATTN_SLOTS, ATTN_C, ATTN_HKV, ATTN_D
    H = Hkv
    bound = attention_bound(ATTN_VALID, B, H, Hkv, D)
    n_copies = max(2, math.ceil(2 * L2_BYTES
                                / (bound["bytes_ms"] * HBM_BYTES_PER_S
                                   / 1e3)) + 1)

    def cache():
        return torch.randn((B, C, Hkv, D), generator=gen, device=dev).to(
            torch.bfloat16)

    ks = [cache() for _ in range(n_copies)]
    vs = [cache() for _ in range(n_copies)]
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(
        torch.bfloat16)
    valid = torch.tensor(ATTN_VALID, dtype=torch.int32, device=dev)
    qpos = (valid - 1).long()[:, None]
    splits = plan_splits(B, Hkv, C, H // Hkv, D,
                         torch.cuda.get_device_properties(dev)
                         .multi_processor_count)
    # idle slots past the end (a bucket of 8 with 5 active) and one slot
    # whose every score is masked (a valid length of 0): the reference's
    # softmax is uniform over all C positions there
    idle_pos = torch.tensor([10, 300, C - 1, C + 3, C + 40, 5, C + 1, 2],
                            dtype=torch.int32, device=dev)
    idle_valid = idle_pos + 1
    idle_valid[5] = 0
    cases = {"mid_run": (qpos, valid), "idle_slots": (idle_pos[:, None],
                                                      idle_valid)}
    errs = {}
    for name, (qp, vl) in cases.items():
        want = decode_attention_plain(q, ks[0], vs[0], q_positions=qp,
                                      kv_valid_len=vl)
        atol = 2.0**-8 * vs[0].float().abs().max().item()
        for n_split in sorted({splits, 1, 2, 4, 8}):
            out = decode_attention(q, ks[0], vs[0], q_positions=qp,
                                   kv_valid_len=vl, splits=n_split)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs()
            bad = err > atol + ATTN_RTOL * want.float().abs()
            if not torch.isfinite(out.float()).all() or bad.any():
                raise AssertionError(
                    f"decode_attention {name} splits={n_split}: "
                    f"{int(bad.sum())} elements off its plain version (max "
                    f"abs err {err.max().item():.3e}, atol {atol:.3e})")
            errs[f"{name}/s{n_split}"] = err.max().item()
    mask = (torch.arange(C, device=dev)[None, :] < valid[:, None])
    mask = mask[:, None, None, :]

    def run(i):
        decode_attention(q, ks[i % n_copies], vs[i % n_copies],
                         q_positions=qpos, kv_valid_len=valid)

    def run_plain(i):
        decode_attention_plain(q, ks[i % n_copies], vs[i % n_copies],
                               q_positions=qpos, kv_valid_len=valid)

    def run_lib(i):
        F.scaled_dot_product_attention(
            q.transpose(1, 2), ks[i % n_copies].transpose(1, 2),
            vs[i % n_copies].transpose(1, 2), attn_mask=mask)

    def run_split(i, n_split):
        decode_attention(q, ks[i % n_copies], vs[i % n_copies],
                         q_positions=qpos, kv_valid_len=valid,
                         splits=n_split)

    by_splits = {n_split: graph_ms(lambda i, n=n_split: run_split(i, n),
                                   100) for n_split in (1, 2, 4, 8)}
    # the kernel's fixed cost: one position a split at the plan's splits
    one = torch.full((B,), splits, dtype=torch.int32, device=dev)
    one_pos = (one - 1).long()[:, None]

    def run_one(i):
        decode_attention(q, ks[i % n_copies], vs[i % n_copies],
                         q_positions=one_pos, kv_valid_len=one)

    row = dict(kernel="decode_attention", shape="engine", store="fp", B=B,
               C=C, Hkv=Hkv, H=H, D=D, valid=ATTN_VALID, splits=splits,
               per_step=layers, max_abs_err=max(errs.values()),
               errs=errs, ms=graph_ms(run, 100), ms_by_splits=by_splits,
               one_position_ms=graph_ms(run_one, 100),
               plain_ms=graph_ms(run_plain, 20),
               library_ms=graph_ms(run_lib, 100), **bound)
    row["hbm_share"] = row["bound_ms"] / row["ms"]
    log(f"  decode_attention B={B} C={C} Hkv={Hkv} D={D} valid "
        f"{sum(ATTN_VALID)} positions, {splits} splits: max err "
        f"{row['max_abs_err']:.2e} ms={row['ms']:.4f} "
        f"bound={row['bound_ms']:.4f} ({row['hbm_share']:.0%}) "
        f"plain={row['plain_ms']:.4f} sdpa={row['library_ms']:.4f}; "
        f"checked at splits {sorted({splits, 1, 2, 4, 8})}, idle slots "
        f"past the end and an all-masked slot; ms by splits "
        + " ".join(f"s{n}={t:.4f}" for n, t in by_splits.items())
        + f"; one position a split {row['one_position_ms']:.4f}")
    rows = [row]
    # quantized pages, read in place: bit-identical to the fp kernel on
    # dequantize_page's tensor, at every split count, in both cases
    for bits in (8, 4):
        pages = [(quantize_page(kk, bits), quantize_page(vv, bits))
                 for kk, vv in zip(ks, vs)]
        (kc, kscale), (vc, vscale) = pages[0]
        kf = dequantize_page(kc, kscale, hd=D, out_dtype=torch.bfloat16)
        vf = dequantize_page(vc, vscale, hd=D, out_dtype=torch.bfloat16)
        for name, (qp, vl) in cases.items():
            for n_split in sorted({splits, 1, 2, 4, 8}):
                got = decode_attention(q, kc, vc, q_positions=qp,
                                       kv_valid_len=vl, splits=n_split,
                                       k_scale=kscale, v_scale=vscale)
                want = decode_attention(q, kf, vf, q_positions=qp,
                                        kv_valid_len=vl, splits=n_split)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"decode_attention int{bits} {name} "
                        f"splits={n_split}: differs from the fp kernel on "
                        f"the dequantized pages")
        del kf, vf
        torch.cuda.synchronize()

        def run_q(i, pages=pages):
            (kc, kscale), (vc, vscale) = pages[i % n_copies]
            decode_attention(q, kc, vc, q_positions=qpos, kv_valid_len=valid,
                             k_scale=kscale, v_scale=vscale)

        def run_q_plain(i, pages=pages):
            (kc, kscale), (vc, vscale) = pages[i % n_copies]
            decode_attention_plain(
                q, dequantize_page(kc, kscale, hd=D,
                                   out_dtype=torch.bfloat16),
                dequantize_page(vc, vscale, hd=D, out_dtype=torch.bfloat16),
                q_positions=qpos, kv_valid_len=valid)

        qrow = dict(kernel="decode_attention", shape=f"engine_int{bits}",
                    store=f"int{bits}", B=B, C=C, Hkv=Hkv, H=H, D=D,
                    valid=ATTN_VALID, splits=splits, per_step=layers,
                    max_abs_err=0.0, bit_identical_to_fp=True,
                    ms=graph_ms(run_q, 100), plain_ms=graph_ms(run_q_plain,
                                                               20),
                    library_ms=None,
                    **attention_bound(ATTN_VALID, B, H, Hkv, D, bits=bits))
        qrow["hbm_share"] = qrow["bound_ms"] / qrow["ms"]
        rows.append(qrow)
        log(f"  decode_attention int{bits} pages in place: ms="
            f"{qrow['ms']:.4f} bound={qrow['bound_ms']:.4f} "
            f"({qrow['hbm_share']:.0%}) plain (dequantize, then the plain "
            f"arithmetic)={qrow['plain_ms']:.4f}; bit-identical to the fp "
            f"kernel on dequantize_page's pages at splits "
            f"{sorted({splits, 1, 2, 4, 8})}, both cases")
        del pages
    del ks, vs
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


# ATen ops that would cast, copy or contract a whole K/V cache page tensor
CACHE_COPY_OPS = {"aten::to", "aten::_to_copy", "aten::copy_", "aten::clone",
                  "aten::contiguous", "aten::einsum", "aten::bmm",
                  "aten::matmul", "aten::mul", "aten::div"}


def kv_tails(eng) -> set[tuple[int, ...]]:
    """The shapes past the batch axis of a layer's K/V pages, int4 codes
    and scales; none for a model whose cache holds no K/V (rwkv6: its
    state is checked by ``guard_serving``)."""
    if "k" not in eng.kv.cache:
        return set()
    C, Hkv, D = eng.max_len, eng.cfg.n_kv_heads, eng.cfg.hd
    return {(C, Hkv, D), (C, Hkv, D // 2), (C, Hkv)}


def cache_copies(prof, tails) -> dict[str, int]:
    """Ops of CACHE_COPY_OPS whose inputs include a tensor of the cache of
    some slots (``[b] + tail`` for a tail of ``tails``: K / V pages or
    codes, and a quantized store's scales), counted by name."""
    hits: collections.Counter = collections.Counter()
    for e in prof.events():
        if e.name in CACHE_COPY_OPS and any(
                len(sh) == len(t) + 1 and tuple(sh[1:]) == t
                for sh in (e.input_shapes or []) for t in tails):
            hits[e.name] += 1
    return dict(hits)


# The profiler loses device records at the edges of a window: a few at
# most windows' edges, more as a run goes on, now and then a run of
# records at the end of a busy eager window (a layer's kernels of a
# deepseek-moe-16b step), and a whole edge group in the first window of a
# process.  Each window is therefore opened and closed by PAD_KERNELS
# tiny kernels of names no step runs (spin kernels to open, lgamma on one
# element to close), each group set off from the steps by a synchronize
# and a pause: the losses fall on them, they are left out of every count,
# and a window that lost a whole group is refused (its losses may have
# reached the steps; an engine phase's window is then measured again on a
# fresh engine, ``profile_fresh``).  That the rest is exact is checked on every
# run: an eager window's records of the port's kernels must equal its
# wrappers' counts (compare_replay).  One padded window runs before the
# first counted one (warm_profiler).
PAD_KERNELS = 128
PAD_OPEN, PAD_CLOSE = "spin_kernel", "lgamma"
PAD_PAUSE_S = 0.05


_PAD_ELEMENT: list[torch.Tensor] = []   # the closing pad's one element


def pad_window(symbol: str) -> None:
    if not _PAD_ELEMENT:
        _PAD_ELEMENT.append(torch.ones(1, device="cuda"))
    for _ in range(PAD_KERNELS):
        if symbol == PAD_OPEN:
            torch.cuda._sleep(100)
        else:
            _PAD_ELEMENT[0].lgamma_()
    torch.cuda.synchronize()


def warm_profiler() -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        pad_window(PAD_OPEN)
        pad_window(PAD_CLOSE)
        time.sleep(0.1)


class LostPadGroup(AssertionError):
    """A profiled window lost a whole group of its pad kernels."""


PROFILE_ATTEMPTS = 3


def profile_fresh(make_eng, step_ms: float) -> dict | None:
    """``profile_decode`` of a fresh engine from ``make_eng()`` after its
    first step (prefill and one decode step), measured again on another
    fresh engine, up to ``PROFILE_ATTEMPTS`` windows in all, when the
    profiler lost a whole pad group of the window (which is refused, never
    read).  The profile's ``windows_refused`` counts those."""
    for attempt in range(PROFILE_ATTEMPTS):
        eng = make_eng()
        eng.step()                           # prefill + first decode step
        try:
            prof = profile_decode(eng, step_ms)
        except LostPadGroup as e:
            if attempt == PROFILE_ATTEMPTS - 1:
                raise
            log(f"  {e}; measured again on a fresh engine")
            continue
        finally:
            del eng
            gc.collect()
        if prof is not None:
            prof["windows_refused"] = attempt
        return prof


def profile_decode(eng, step_ms: float, steps: int = 3,
                   step=None, host: bool = True) -> dict | None:
    """Device time of a few decode steps by kernel name (torch.profiler);
    None when the profiler reports no device time here.  The idle share
    is taken against ``step_ms``, the unprofiled per-token p50 (the
    profiler's own overhead inflates the host time of the traced steps).
    ``cache_copies`` counts the ops that cast, copy or contract a tensor
    of the K/V cache's shape (pages, int4 codes, or the scales of a
    quantized store) in those steps (input shapes recorded; a replayed
    step has no ATen ops inside its graph, so this reads eager steps).
    ``kernels_by_name`` is every device activity's calls a step.
    ``launches_per_step`` is the wrappers' counts over the window (exact
    on the eager route; a replay counts nothing).
    ``step`` runs one engine step (default ``eng.step``); ``host=False``
    records the device alone (no ATen ops, no shapes, no cache copies:
    cheap over steps of many host ops)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = eng.cfg
    torch.cuda.synchronize()
    before = launches()
    with profile(activities=([ProfilerActivity.CPU] if host else [])
                 + [ProfilerActivity.CUDA], record_shapes=host) as prof:
        pad_window(PAD_OPEN)
        time.sleep(PAD_PAUSE_S)
        for _ in range(steps):
            (step or eng.step)()
        torch.cuda.synchronize()
        time.sleep(PAD_PAUSE_S)
        pad_window(PAD_CLOSE)
        time.sleep(0.1)
    window_launches = {n: (c - before[n]) / steps
                       for n, c in launches().items()}
    copies = cache_copies(prof, kv_tails(eng)) if host else None
    avgs = prof.key_averages()
    on_card = [e for e in avgs if str(e.device_type).endswith("CUDA")]
    pads_lost = {sym: PAD_KERNELS - sum(e.count for e in on_card
                                        if sym in e.key)
                 for sym in (PAD_OPEN, PAD_CLOSE)}
    if max(pads_lost.values()) >= PAD_KERNELS:
        raise LostPadGroup(
            f"the profiler lost a whole pad group of the window (lost by "
            f"group {pads_lost}): its counts cannot be trusted")
    on_card = [e for e in on_card
               if PAD_OPEN not in e.key and PAD_CLOSE not in e.key]
    by_name = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in on_card if e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms, _ in by_name)
    if busy_ms <= 0:
        return None
    per_step = busy_ms / steps
    # host side: the ATen ops the Python loop issues, by self CPU time
    # (inflated by the profiler itself; read for the ranking and counts)
    aten = sorted((e for e in avgs if e.key.startswith("aten::")
                   and e.key != "aten::lgamma_"),
                  key=lambda e: -e.self_cpu_time_total)
    kernels = collections.Counter()
    for e in on_card:
        kernels[e.key] += e.count / steps
    return {"steps": steps, "pads_lost": pads_lost,
            "device_busy_ms_per_step": per_step,
            "step_ms": step_ms, "cache_copies": copies,
            "device_idle_share": max(0.0, 1 - per_step / step_ms),
            "kernels_per_step": sum(e.count for e in on_card) / steps,
            "aten_ops_per_step": sum(e.count for e in aten) / steps,
            "kernels_by_name": dict(kernels),
            "launches_per_step": window_launches,
            "top": [{"name": n[:120], "ms_per_step": ms / steps,
                     "calls_per_step": calls / steps}
                    for n, ms, calls in by_name[:20]],
            "top_host": [{"name": e.key, "calls_per_step": e.count / steps,
                          "self_cpu_ms_per_step":
                              e.self_cpu_time_total / 1e3 / steps}
                         for e in aten[:12]]}


# the port's kernels as the profiler names them (CUPTI reports each kernel
# node of a replayed graph under its symbol), each with the wrappers whose
# launches it is: the streaming body's entry, the ragged kernel, decode
# attention
PORT_GROUPS = {
    "gemv_stream::stream_kernel<": ("pim_gemv", "splitk_gemv", "quant_gemv",
                                    "quant4_gemv", "grouped_gemv",
                                    "triton_gemv"),
    "ragged_kernel<": ("ragged_gemv",),
    "decode_attention_kernel<": ("decode_attention",),
}


def compare_replay(graph: dict, eager: dict, cfg) -> dict:
    """A replayed window against an eager one over the same steps, in
    whole records of the window (its pads make them exact): every port
    kernel, by the profiler's symbol, as often in both windows as the
    eager window's wrappers launched it, decode attention once a layer a
    step and the ragged kernel three times a layer a step; and no copy or
    cast kernel more often in the replayed window than in the eager one
    (but the f32 logits' copy into the graph's static output, one a
    step).
    Host transfers (the staged tokens, the logits) are left out.  Raises
    on a difference; returns the port kernels a step and the library
    kernels whose counts differ (graph, eager), for the report."""
    steps = graph["steps"]
    g, e = ({n: round(c * d["steps"])
             for n, c in d["kernels_by_name"].items()}
            for d in (graph, eager))
    names = set(g) | set(e)
    port = {sym: (sum(c for n, c in g.items() if sym in n),
                  sum(c for n, c in e.items() if sym in n),
                  round(steps * sum(eager["launches_per_step"][w]
                                    for w in ws)))
            for sym, ws in PORT_GROUPS.items()}
    bad = {n: v for n, v in port.items() if len(set(v)) > 1}
    copies = {n: (g.get(n, 0), e.get(n, 0)) for n in names
              if "copy" in n.lower()}
    # a device-to-device memcpy shows as "Memcpy DtoD" when issued and as
    # a memcpy32_* kernel node in a graph: held as one group
    dtod = [sum(d.get(n, 0) for n in names
                if n.startswith(("Memcpy DtoD", "memcpy32_")))
            for d in (g, e)]
    copies["device-to-device memcpy"] = tuple(dtod)
    # the graph copies each step's logits into its static output: a cast
    # kernel from bf16 (as the eager step's ``.float()``), but a memcpy
    # when the model computes in f32, where the eager step copies nothing
    allowed = {"device-to-device memcpy":
               steps if cfg.compute_dtype == "float32" else 0}
    bad.update({n: v for n, v in copies.items()
                if v[0] > v[1] + allowed.get(n, 0)})
    want = {"decode_attention_kernel<": attention_layers(cfg) * steps}
    if cfg.moe is not None and port["ragged_kernel<"][0]:
        want["ragged_kernel<"] = 3 * cfg.n_layers * steps
    for sym, n in want.items():
        if port[sym][0] != n:
            bad[sym] = (port[sym][0], n)
    if bad:
        raise AssertionError(f"replayed window vs eager window ({steps} "
                             f"steps; graph, eager[, eager wrappers]): "
                             f"{bad}")
    return {"port_kernels_per_step": sum(v[0] for v in port.values())
            / steps,
            "library_differences": {
                n[:120]: (g.get(n, 0), e.get(n, 0)) for n in names
                if not n.startswith(("Memcpy", "memcpy32_"))
                and not any(sym in n for sym in PORT_GROUPS)
                and g.get(n, 0) != e.get(n, 0)}}


def log_ttft(res: dict) -> None:
    t = res["prefill_scores"]["ttft_p50_ms"]
    log("  prefill attention scores: TTFT p50 with K cast to f32 "
        + ", ".join(f"{v:.2f}" for v in t["f32_cast"])
        + " ms; from the bf16 operands (one bmm, f32 result) "
        + ", ".join(f"{v:.2f}" for v in t["bf16_bmm"])
        + " ms; greedy tokens equal")


def log_profile(p: dict | None, label: str = "profile") -> None:
    if p is None:
        log(f"  {label}: the profiler reported no device time")
        return
    log(f"  {label}: device busy {p['device_busy_ms_per_step']:.3f} ms "
        f"per decode step against a {p['step_ms']:.3f} ms step: idle "
        f"share {p['device_idle_share']:.3f}; "
        f"{p['kernels_per_step']:.0f} kernels and "
        f"{p['aten_ops_per_step']:.0f} ATen ops per step; casts or copies "
        f"of a cache-shaped tensor {p['cache_copies'] or 'none'}; pad "
        f"kernels lost {p['pads_lost']} of {PAD_KERNELS} each; windows "
        f"refused before it {p.get('windows_refused', 0)}")
    for t in p["top"][:10]:
        log(f"    {t['ms_per_step']:8.3f} ms/step  {t['name']}")


def log_routes(tag: str, res: dict) -> None:
    """Both routes of an engine phase: the profiles, one line each, then
    the captures."""
    for route in ROUTES:
        log_profile(res["routes"][route]["profile"], f"profile ({route})")
    for route in ROUTES:
        r = res["routes"][route]
        pt, pr = r["per_token_ms"], r["profile"]
        log(f"  [{tag} {route}] per-token p50 {pt['p50']:.3f} ms p90 "
            f"{pt['p90']:.3f} ms; device busy "
            f"{pr['device_busy_ms_per_step']:.3f} ms/step, idle share "
            f"{pr['device_idle_share']:.3f}; {pr['aten_ops_per_step']:.0f} "
            f"ATen ops, {pr['kernels_per_step']:.0f} kernels per step; peak "
            f"{r['peak_mem_gb']:.3f} GB")
    log(f"  [{tag} capture] seconds by bucket "
        f"{json.dumps(res['routes']['graph']['capture_s'])}; greedy tokens "
        f"equal both ways; replayed step: "
        f"{res['replay']['port_kernels_per_step']:.0f} port kernels as in "
        f"the eager step, library differences "
        f"{res['replay']['library_differences'] or 'none'}")


def decode_sites(cfg) -> dict[str, tuple[int, int, int]]:
    """(M, K, calls per decode step) of every GEMV a decode step sends
    through the dispatcher outside the routed experts: the fused QKV
    program, the fused gate+up program of a gated FFN (an MoE layer's
    shared experts) or an ungated FFN's up, down, the head."""
    d, L = cfg.d_model, cfg.n_layers
    if cfg.attn_free:      # rwkv6: its projections are plain matmuls
        return {"head": (cfg.vocab, d, 1)}
    ff = cfg.d_ff if cfg.moe is None else cfg.moe.n_shared * cfg.moe.d_expert
    ffn = ({"gate_up": (2 * ff, d, L)} if cfg.act in GATED
           else {"up": (ff, d, L)})
    return {"qkv": ((cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd, d, L),
            **ffn, "down": (d, ff, L), "head": (cfg.vocab, d, 1)}


def attention_layers(cfg) -> int:
    """``decode_attention`` launches a decode step: each layer's
    self-attention, and the cross-attention of each cross-attending layer
    (one query a slot over the context's keys, in the kernel's causal
    form); none for an attention-free model."""
    if cfg.attn_free:
        return 0
    return cfg.n_layers + sum(cfg.is_cross_layer(i)
                              for i in range(cfg.n_layers))


def float_kernels_on_path(cfg, policy, batch: int) -> tuple[str, ...]:
    """The float GEMV kernels the ``h100`` picks send a decode step's
    GEMVs to at ``batch`` (whisper-small's: none)."""
    return tuple(n for n, k in zip(FLOAT_KERNELS, ("pim", "splitk"))
                 if launches_per_step(cfg, policy, batch, "h100", k)[0])


def launches_per_step(cfg, policy, batch: int, backend: str,
                      kernel: str) -> tuple[int, dict]:
    """Launches of ``kernel`` one decode step at ``batch`` makes, from the
    backend's picks for the step's GEMVs (a fused program runs the
    kernel its concatenated shape picks)."""
    be = get_backend(backend)
    picks = {name: be.select_kernel(M, K, batch, policy=policy)[0]
             for name, (M, K, _) in decode_sites(cfg).items()}
    n = sum(calls for name, (_, _, calls) in decode_sites(cfg).items()
            if picks[name] == kernel)
    return n, picks



ROUTES = ("graph", "eager")


def route_ctx(route: str):
    """The engine's decode route: captured graphs (the default) or eager
    under ``disable_graphs()``."""
    return disable_graphs() if route == "eager" else contextlib.nullcontext()


def counted_batches(route: str, batches: list[int]) -> list[int]:
    """The decode batches the wrappers' counters saw: every step when
    eager; with graphs each bucket twice (its eager first step and its
    capture), a replay never."""
    return batches if route == "eager" else sorted(set(batches)) * 2


def run_engine(cfg, params, dev, kv_store: str = "fp", *,
               backend: str = "h100", new_tokens: int = 64,
               lengths=ENGINE_LENGTHS, max_len: int = 1024,
               ttft: bool = True) -> dict:
    """The engine phase both ways: with replayed graphs (the main path,
    whose counters the kernels line reports) and under
    ``disable_graphs()``; greedy tokens must be equal, and the replayed
    step must run the eager step's port kernels.  ``lengths`` are the
    prompts of the 8 requests, ``max_len`` the engine's cache;
    ``ttft`` adds the TTFT comparison of the prefill scores."""
    kw = dict(gemv_backend=backend, max_len=max_len)
    # warm-up: first calls of every op and both decode buckets
    warm = serve(cfg, params, dev, [16, 40, 24, 8, 64, 32, 12, 20], 3, 1,
                 kv_store, **kw)
    warm.run_until_drained()
    del warm
    routes = {}
    for route in ROUTES:
        with route_ctx(route):
            routes[route] = run_route(cfg, params, dev, kv_store, backend,
                                      new_tokens, route, lengths, max_len)
    if routes["graph"]["generated"] != routes["eager"]["generated"]:
        raise AssertionError(
            f"greedy tokens differ between the graph and eager routes: "
            f"{token_agreement(routes['eager']['generated'], routes['graph']['generated'])}")
    res = {**routes["graph"], "routes": routes,
           "replay": compare_replay(routes["graph"]["profile"],
                                    routes["eager"]["profile"], cfg)}
    if backend == "h100" and ttft:
        res["prefill_scores"] = ttft_both_ways(cfg, params, dev, kv_store)
    return res


def run_route(cfg, params, dev, kv_store: str, backend: str,
              new_tokens: int, route: str, lengths=ENGINE_LENGTHS,
              max_len: int = 1024) -> dict:
    kw = dict(gemv_backend=backend, max_len=max_len)
    # an engine whose sampler check_finite_logits wrapped sits in a
    # reference cycle: collect it, or its state counts in the next peak
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    eng = serve(cfg, params, dev, lengths, new_tokens, SEED, kv_store, **kw)
    seen = check_finite_logits(eng)
    dispatch.clear_plan_cache()
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launches()
    stats = dispatch.dispatch_stats()
    if len(done) != len(lengths) or any(len(r.generated) != new_tokens
                                        for r in done):
        raise AssertionError(
            f"expected {len(lengths)} requests x {new_tokens} tokens, got "
            f"{[(r.rid, len(r.generated)) for r in done]}")
    doc = eng.metrics.to_dict(include_steps=True)
    decode_batches = [st["decode_batch"] for st in doc["steps"]
                      if st["decode_batch"]]
    need = (("triton_gemv",) if backend == "gpu" else
            float_kernels_on_path(cfg, eng.gemv_policy, max(decode_batches)))
    if cfg.moe is not None:
        need = ("ragged_gemv",) + (need if backend == "gpu" else ())
    if attention_layers(cfg):
        need += ("decode_attention",)
    if not all(counts[n] for n in need):
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{counts}")
    steps = doc["counters"]["decode_steps"]
    batches = counted_batches(route, decode_batches)
    capture_s = ({str(b): s for b, s in eng.graphs.capture_s.items()}
                 if route == "graph" else {})
    if route == "graph" and sorted(eng.graphs.replays) != sorted(
            set(batches)):
        raise AssertionError(f"graphs {sorted(eng.graphs.replays)} for the "
                             f"buckets {sorted(set(batches))}")
    # every layer of every counted step reads its cache through the
    # kernel, and every cross-attending layer its context
    if counts["decode_attention"] != attention_layers(cfg) * len(batches):
        raise AssertionError(
            f"{len(batches)} counted decode steps launched decode_attention"
            f" {counts['decode_attention']} times (expected "
            f"{attention_layers(cfg)} a step)")
    extra = {}
    if cfg.moe is not None:
        # every routed projection of every decode step: gate, up and down
        # in each layer, each one ragged_gemv launch in the native mode
        modes = stats["program_modes"]
        native = f"{backend}:ragged_" + ("triton" if backend == "gpu"
                                         else "cuda")
        if (counts["ragged_gemv"] != 3 * cfg.n_layers * len(batches)
                or f"{backend}:ragged" in modes or not modes.get(native)):
            raise AssertionError(
                f"{len(batches)} counted decode steps launched ragged_gemv "
                f"{counts['ragged_gemv']} times (expected "
                f"{3 * cfg.n_layers * len(batches)}); program modes {modes}")
    if backend == "h100" and cfg.moe is None and kv_store == "fp":
        # every decode step launches pim_gemv and splitk_gemv as often as
        # the h100 picks for its GEMVs predict: olmo-1b, 17 and 32 (a
        # GEMV the backend keeps on torch.matmul, picked "ref", counts
        # for neither)
        per_batch = {b: {n: launches_per_step(cfg, eng.gemv_policy, b,
                                              "h100", k)[0]
                         for n, k in (("pim_gemv", "pim"),
                                      ("splitk_gemv", "splitk"))}
                     for b in sorted(set(batches))}
        for n in FLOAT_KERNELS:
            want = sum(per_batch[b][n] for b in batches)
            if counts[n] != want:
                raise AssertionError(
                    f"{len(batches)} counted decode steps launched {n} "
                    f"{counts[n]} times; the picks predict {want}: "
                    f"{per_batch}")
        if cfg.name == "olmo-1b" and any(
                v != {"pim_gemv": 17, "splitk_gemv": 32}
                for v in per_batch.values()):
            raise AssertionError(f"olmo-1b's picks changed: {per_batch}")
        extra = {"float_launches_by_batch": {str(b): v for b, v
                                             in per_batch.items()}}
    if backend == "gpu":
        # the decode steps' triton_gemv launches equal what the picks of
        # each step's batch predict (prefill rows exceed the batch gate)
        per_batch = {b: launches_per_step(cfg, eng.gemv_policy, b, "gpu",
                                          "triton")
                     for b in sorted(set(batches))}
        want = sum(per_batch[b][0] for b in batches)
        if counts["triton_gemv"] != want or min(
                n for n, _ in per_batch.values()) < 1:
            raise AssertionError(
                f"{len(batches)} counted decode steps launched triton_gemv "
                f"{counts['triton_gemv']} times; the picks predict {want}: "
                f"{per_batch}")
        extra = {"triton_picks_by_batch": {
            str(b): {"per_step": n, "picks": picks}
            for b, (n, picks) in per_batch.items()}}
    doc.pop("steps")
    kv_leaves = {n: t for n, t in eng.kv.cache.items() if n != "pos"}
    res = {
        "route": route,
        "kv_store": kv_store,
        "kv_bytes_per_slot": tree_bytes(kv_leaves) / eng.slots,
        "logit_rows_checked": seen["rows"],
        "generated": {r.rid: list(r.generated) for r in done},
        "requests": len(done),
        "tokens": doc["counters"]["tokens_out"],
        "prompt_lengths": lengths,
        "wall_s": wall_s,
        "decode_steps": steps,
        "counted_steps": len(batches),
        "capture_s": capture_s,
        "decode_tokens_per_s": doc["decode_tokens_per_s"],
        "per_token_ms": doc["per_token_ms"],
        "ttft_ms": doc["ttft_ms"],
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "launches": counts,
        "launches_per_step": {k: v / len(batches) for k, v in counts.items()},
        "dispatch": stats,
        **extra,
    }
    del eng
    gc.collect()
    # device-time breakdown over three decode steps at batch 8 (replays on
    # the graph route: the first step captured the bucket)
    res["profile"] = profile_fresh(
        lambda: serve(cfg, params, dev, lengths, 8, SEED + 1, kv_store,
                      **kw), doc["per_token_ms"]["p50"])
    if res["profile"] is None or res["profile"]["cache_copies"]:
        # every store's decode steps read the cache in place: no cast to
        # f32, no dequantized copy of the codes and no copy
        raise AssertionError(
            "decode steps cast or copied the K/V cache: "
            + str(res["profile"] and res["profile"]["cache_copies"]))
    return res


def f32_scores_plain(q, k, v, **kw):
    """The plain attention path as it stood before its bf16 score product:
    K cast to f32 for the scores (the rest unchanged)."""
    return PLAIN_ATTENTION(q, k.float(), v, **kw)


PLAIN_ATTENTION = L.decode_attention_plain


def ttft_both_ways(cfg, params, dev, kv_store: str) -> dict:
    """TTFT p50 of the 8 requests (2 tokens each) with prefill attention's
    scores from the bf16 operands (the port's path) and from K cast to f32
    (the earlier path), in turns (cast, bf16, bf16, cast); the greedy
    tokens of the two must agree."""
    ttft, tokens = {"f32_cast": [], "bf16_bmm": []}, {}
    for route in ("f32_cast", "bf16_bmm", "bf16_bmm", "f32_cast"):
        L.decode_attention_plain = (f32_scores_plain if route == "f32_cast"
                                    else PLAIN_ATTENTION)
        try:
            eng = serve(cfg, params, dev, ENGINE_LENGTHS, 2, SEED, kv_store)
            done = eng.run_until_drained()
            torch.cuda.synchronize()
        finally:
            L.decode_attention_plain = PLAIN_ATTENTION
        ttft[route].append(eng.metrics.to_dict()["ttft_ms"]["p50"])
        tokens[route] = {r.rid: list(r.generated) for r in done}
        del eng
    if tokens["f32_cast"] != tokens["bf16_bmm"]:
        raise AssertionError(f"prefill scores changed greedy tokens: "
                             f"{tokens}")
    return {"ttft_p50_ms": ttft, "tokens_equal": True}


def logits_check(cfg, params, dev,
                 lengths=(300, 40, 130, 7, 512, 64, 250, 90),
                 max_len: int = 1024, strict: bool = True) -> dict:
    """One decode step of one engine state, twice: through the dispatcher
    (the GEMV kernels) and with every GEMV pinned to ``ref``.  ``strict``
    holds the logits to one bf16 ulp at the largest (olmo-1b's 16 layers);
    otherwise the difference is reported in those ulps."""
    eng = serve(cfg, params, dev, list(lengths), 4, SEED + 2,
                max_len=max_len)
    eng.step()                           # prefill + one decode step
    b = eng.decode_bucket()
    last = torch.from_numpy(eng.last_tok[:b]).to(dev)
    out = {}
    feats = {k: v[:b] for k, v in eng.features.items()}
    for tag, policy in (("kernels", eng.gemv_policy),
                        ("ref", DispatchPolicy(kernel="ref"))):
        cache = {k: v.clone() for k, v in eng.kv.slice_prefix(b).items()}
        reset_launches()
        logits, _, _ = lm.forward(eng.params, cfg, last, cache=cache,
                                  gemv_policy=policy, **feats)
        torch.cuda.synchronize()
        out[tag] = (logits[:, -1].float(), launches())
    (lk, nk), (lr, nr) = out["kernels"], out["ref"]
    # kernel="ref" pins the GEMVs; attention runs its kernel either way
    need = float_kernels_on_path(cfg, eng.gemv_policy, b)
    if (not all(nk[n] for n in need) or any(nr[n] for n in GEMV_KERNELS)
            or {nk["decode_attention"], nr["decode_attention"]}
            != {attention_layers(cfg)}):
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
           "diff_in_ulps": diff / tol, "logit_absmax": absmax,
           "argmax_agree": int((lk.argmax(-1) == lr.argmax(-1)).sum()),
           "launches": nk}
    if strict and diff > tol:
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
# serving: chunked prefill, preemption and the prefix cache at full width
# ---------------------------------------------------------------------------


SERVE_PREFIX = 384            # each tenant's shared prefix, tokens
SERVE_TAIL = (16, 128)        # each request's private tail, inclusive
SERVE_CHUNK = 128             # Engine(prefill_chunk=)
# two urgent requests, each at a step when all 8 slots are busy (the
# first has finished by the second's): a private 256-token prompt (a miss,
# two chunks) with a deadline 60 s out and a margin longer than that, so
# each is imminent at once and forces a preemption on its step whatever
# the host's speed, and no deadline passes in the queue
SERVE_URGENT_STEPS = (5, 15)
SERVE_URGENT_LEN, SERVE_URGENT_TOKENS = 256, 8
SERVE_DEADLINE_S, SERVE_MARGIN_S = 60.0, 120.0
# the segment store: four tenants' prefixes, every tail and the victims'
# streams (olmo-1b fp: 131072 bytes a position); the reference's default
# 64 MiB holds one 384-token olmo-1b prefix
SERVE_PREFIX_BYTES = 2 ** 30
# the profiled window: the first urgent request's arrival (a preemption,
# its first chunk with its row in the decode bucket) and the next 2 steps
SERVE_WINDOW = (SERVE_URGENT_STEPS[0], 3)
SERVE_RUNS = {  # tag: (arch, kv_store, requests, tenants, new tokens)
    "olmo-1b fp": ("olmo-1b", "fp", 24, 4, 24),
    "olmo-1b int8": ("olmo-1b", "int8", 24, 4, 24),
    "deepseek-moe-16b ragged": (MOE_ARCH, "fp", 8, 2, 16),
    "rwkv6-3b f32": ("rwkv6-3b", "fp", 12, 2, 16),
    "hymba-1.5b f32": ("hymba-1.5b", "fp", 10, 2, 16),
}
# a tag's private tails where they are not SERVE_TAIL
SERVE_TAILS = {"rwkv6-3b f32": (16, 64), "hymba-1.5b f32": (16, 64)}
# A recurrent model's mix must give the plain engine's tokens; a stream
# may part from it only at a near tie: where the two runs' top-2 logit
# margin is below NEAR_TIE, about 14x the drift of f32 logits between
# chunked and whole prefill of one prompt on an H100 80GB HBM3 at 700 W
# (7.2e-4; ``state_drift`` prints it on every run).
NEAR_TIE = 1e-2


def serving_plan(vocab: int, n_requests: int, n_tenants: int,
                 new_tokens: int, seed: int,
                 tail_len=SERVE_TAIL) -> list[dict]:
    """8 requests at step 0, then 2 a step; each prompt a tenant's shared
    prefix plus a private tail of ``tail_len`` tokens (inclusive); and the
    two urgent requests."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, SERVE_PREFIX).astype(np.int32)
                for _ in range(n_tenants)]
    plan = []
    for i in range(n_requests):
        tail = rng.integers(0, vocab, int(rng.integers(
            tail_len[0], tail_len[1] + 1))).astype(np.int32)
        plan.append({"step": 0 if i < 8 else (i - 8) // 2 + 1, "rid": i,
                     "prompt": np.concatenate([prefixes[i % n_tenants],
                                               tail]),
                     "new_tokens": new_tokens, "urgent": False})
    for j, step in enumerate(SERVE_URGENT_STEPS):
        plan.append({"step": step, "rid": n_requests + j,
                     "prompt": rng.integers(0, vocab, SERVE_URGENT_LEN)
                     .astype(np.int32),
                     "new_tokens": SERVE_URGENT_TOKENS, "urgent": True})
    return plan


class PlanRunner:
    """Submits each request of a plan at its step, then runs the engine
    step; ``deadlines`` gives the urgent requests theirs."""

    def __init__(self, eng: Engine, plan: list[dict], deadlines: bool):
        self.eng, self.deadlines = eng, deadlines
        self.pending = sorted(plan, key=lambda p: p["step"])
        self.requests: dict[int, Request] = {}
        self.n = 0
        self.preempt_steps: list[int] = []

    def done(self) -> bool:
        e = self.eng
        return not (self.pending or e.active or e._prefilling
                    or e.scheduler.queue)

    def step(self) -> None:
        e = self.eng
        while self.pending and self.pending[0]["step"] <= self.n:
            p = self.pending.pop(0)
            r = Request(rid=p["rid"], prompt=p["prompt"],
                        max_new_tokens=p["new_tokens"],
                        deadline=(e.clock() + SERVE_DEADLINE_S
                                  if p["urgent"] and self.deadlines
                                  else None))
            self.requests[r.rid] = r
            e.submit(r)
        evicted = e.metrics.counters["evicted"]
        e.step()
        if e.metrics.counters["evicted"] > evicted:
            self.preempt_steps.append(self.n)
        self.n += 1
        if self.n > 2000:
            raise AssertionError("the serving plan did not drain")


class CacheOpCounter(TorchDispatchMode):
    """Counts the ATen ops of CACHE_COPY_OPS that take a tensor of the K/V
    cache's shape (``[b] + tail``), by name, as they run."""

    def __init__(self, tails):
        super().__init__()
        self.tails, self.hits = tails, collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name in CACHE_COPY_OPS:
            for t in tree_leaves((args, kwargs or {})):
                if isinstance(t, torch.Tensor) and any(
                        t.dim() == len(tail) + 1
                        and tuple(t.shape[1:]) == tail
                        for tail in self.tails):
                    self.hits[name] += 1
        return func(*args, **(kwargs or {}))


class StateRowCopies(TorchDispatchMode):
    """Counts the copies of whole state rows (a tensor of exactly one of
    ``shapes``: ``[L, ...]``, one slot of a state leaf) as they run."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes, self.n = shapes, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in CACHE_COPY_OPS and any(
                isinstance(t, torch.Tensor) and tuple(t.shape) in self.shapes
                for t in tree_leaves((args, kwargs or {}))):
            self.n += 1
        return func(*args, **(kwargs or {}))


def top2_margins(eng: Engine) -> dict[int, list[float]]:
    """Record, by request, the top-2 margin of every logits row ``eng``
    samples from (the i-th: its i-th token)."""
    sample, margins = eng._sample, {}

    def margined(r, row):
        lo, hi = np.partition(row, -2)[-2:]
        margins.setdefault(r.rid, []).append(float(hi - lo))
        return sample(r, row)

    eng._sample = margined
    return margins


def guard_serving(eng: Engine) -> dict:
    """Wrap ``eng`` so that every prefix hit's splice is held byte for
    byte against its gathered segment, and every decode step with a row
    mid-prefill in its bucket counts its casts and copies of K/V-shaped
    tensors and leaves the state rows of those rows bit-equal (a
    recurrent model's; their copies of whole state rows are counted: the
    engine's save and restore).  Returns the record both fill."""
    rec = {"spliced": 0, "spliced_positions": 0, "chunked_decode_steps": 0,
           "chunked_rows": 0, "cache_ops": {}, "state_rows_held": 0,
           "state_row_copies": 0}
    tails = kv_tails(eng)
    state = eng.kv.state_names
    splice, decode = eng.kv.splice_prefix, eng._decode

    def as_bytes(t):
        return t.contiguous().view(torch.uint8)

    def checked_splice(slot, payload, length):
        splice(slot, payload, length)
        for name, seg in payload["kv"].items():
            if not torch.equal(as_bytes(eng.kv.cache[name][:, slot, :length]),
                               as_bytes(seg)):
                raise AssertionError(f"spliced {name} of slot {slot} "
                                     f"differs from its segment")
        rec["spliced"] += 1
        rec["spliced_positions"] += length

    def counted_decode():
        if not eng._prefilling:
            return decode()
        mid = sorted(eng._prefilling)
        before = {n: eng.kv.cache[n][:, mid].clone() for n in state}
        rows = {tuple(eng.kv.cache[n][:, 0].shape) for n in state}
        with CacheOpCounter(tails) as counter, \
                StateRowCopies(rows) as row_copies:
            out = decode()
        for n in state:
            if not torch.equal(eng.kv.cache[n][:, mid], before[n]):
                raise AssertionError(f"a decode step changed {n} of the "
                                     f"rows mid-prefill {mid}")
        rec["state_rows_held"] += len(mid) * bool(state)
        rec["state_row_copies"] += row_copies.n
        rec["chunked_decode_steps"] += 1
        rec["chunked_rows"] += len(eng._prefilling)
        for k, v in counter.hits.items():
            rec["cache_ops"][k] = rec["cache_ops"].get(k, 0) + v
        return out

    eng.kv.splice_prefix = checked_splice
    eng._decode = counted_decode
    return rec


def serving_engine(cfg, params, dev, kv_store: str, plain: bool) -> Engine:
    """The serving phase's engine: gemv_aware at threshold 8 with the
    preemption margin, chunked prefill and the prefix cache; ``plain``
    turns all three off."""
    sched = SchedulerConfig(
        policy="gemv_aware", gemv_batch_threshold=8,
        preempt_margin=None if plain else SERVE_MARGIN_S,
        moe_experts=cfg.moe.n_experts if cfg.moe else 0,
        moe_top_k=cfg.moe.top_k if cfg.moe else 1)
    return Engine(cfg, params, device=dev, batch_slots=8, max_len=1024,
                  gemv_backend="h100", scheduler=sched,
                  prefill_chunk=None if plain else SERVE_CHUNK,
                  prefix_cache=(None if plain else PrefixCacheConfig(
                      capacity_bytes=SERVE_PREFIX_BYTES)),
                  kv_store=kv_store)


def serve_route(cfg, params, dev, kv_store: str, plan: list[dict],
                route: str, plain: bool = False) -> dict:
    """One run of the plan on one route; the graph route's launch counts
    are this run's alone (set to 0 just before it)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = serving_engine(cfg, params, dev, kv_store, plain)
    seen = check_finite_logits(eng)
    margins = top2_margins(eng)
    rec = guard_serving(eng)
    drv = PlanRunner(eng, plan, deadlines=not plain)
    dispatch.clear_plan_cache()
    reset_launches()
    t0 = time.perf_counter()
    profile = None
    with route_ctx(route):
        while not drv.done():
            if drv.n == SERVE_WINDOW[0] and not plain:
                # the window's steps replay the captured bucket of 8 on
                # the graph route (captured at the first decode, step 3)
                profile = profile_decode(eng, float("nan"), SERVE_WINDOW[1],
                                         step=drv.step, host=False)
                gc.collect()   # the profiler's records, before a capture
            else:
                drv.step()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = launches()
    doc = eng.metrics.to_dict(include_steps=True)
    steps = doc.pop("steps")
    c = doc["counters"]
    reqs = drv.requests
    if any(len(r.generated) != r.max_new_tokens for r in reqs.values()):
        raise AssertionError(
            f"{route}: requests ended short: "
            f"{[(r.rid, len(r.generated)) for r in reqs.values()]}")
    pc = doc.get("prefix_cache") or {}
    res = {
        "route": route, "plain": plain, "kv_store": kv_store,
        "generated": {rid: list(r.generated) for rid, r in reqs.items()},
        "requests": len(reqs), "steps": drv.n, "wall_s": wall_s,
        "preempt_steps": drv.preempt_steps,
        "evictions": {rid: r.evictions for rid, r in reqs.items()
                      if r.evictions},
        "counters": c, "logit_rows_checked": seen["rows"],
        "per_token_ms": doc["per_token_ms"], "ttft_ms": doc["ttft_ms"],
        "ttft_hit_ms": pc.get("ttft_hit_ms"),
        "ttft_miss_ms": pc.get("ttft_miss_ms"),
        "prefix_index": eng.prefix.stats() if eng.prefix else None,
        "capture_s": ({str(b): v for b, v in eng.graphs.capture_s.items()}
                      if route == "graph" else {}),
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "launches": counts, "guard": rec, "profile": profile,
        "state_leaves": len(eng.kv.state_names), "margins": margins,
        "step_ms": [round(st["step_ms"], 3) for st in steps],
        "decode_batch": [st["decode_batch"] for st in steps],
    }
    del eng, drv
    gc.collect()
    return res


def serve_route_measured(*args) -> dict:
    """``serve_route``, run again (up to ``PROFILE_ATTEMPTS`` runs) when
    the profiler lost a whole pad group of its window, which is refused;
    ``windows_refused`` counts those runs."""
    for attempt in range(PROFILE_ATTEMPTS):
        try:
            res = serve_route(*args)
        except LostPadGroup as e:
            if attempt == PROFILE_ATTEMPTS - 1:
                raise
            log(f"  {e}; the route's plan run again")
            gc.collect()
            continue
        res["windows_refused"] = attempt
        return res


def run_serving(cfg, params, dev, tag: str) -> dict:
    """The serving phase for one configuration: both routes (tokens
    equal, the counters and checks of the phase), then the plain engine
    on the graph route, compared, not required."""
    arch, kv_store, n_req, n_ten, new = SERVE_RUNS[tag]
    tail = SERVE_TAILS.get(tag, SERVE_TAIL)
    plan = serving_plan(cfg.vocab, n_req, n_ten, new, SEED, tail)
    # warm-up: the one-slot chunk shapes and the prefix path, so that the
    # route run first pays no first-use cost the other does not
    warm = serving_engine(cfg, params, dev, kv_store, plain=False)
    wdrv = PlanRunner(warm, [{**plan[0], "new_tokens": 2}], False)
    while not wdrv.done():
        wdrv.step()
    del warm, wdrv
    routes = {r: serve_route_measured(cfg, params, dev, kv_store, plan, r)
              for r in ROUTES}
    g, e = routes["graph"], routes["eager"]
    if g["generated"] != e["generated"]:
        raise AssertionError(
            f"[serving {tag}] greedy tokens differ between the routes: "
            f"{token_agreement(e['generated'], g['generated'])}")
    need = (("ragged_gemv",) if cfg.moe is not None else
            float_kernels_on_path(cfg, DispatchPolicy(), 8)) \
        + (("decode_attention",) if attention_layers(cfg) else ())
    for route, r in routes.items():
        c, guard = r["counters"], r["guard"]
        if route == "graph" and not all(r["launches"][n] for n in need):
            raise AssertionError(f"[serving {tag}] a kernel of the path "
                                 f"never launched: {r['launches']}")
        if cfg.moe is None and (c["evicted"] < 1 or c["prefill_chunks"] < 24
                                or c["prefix_hits"] < 1):
            raise AssertionError(f"[serving {tag} {route}] counters {c}")
        if len(r["preempt_steps"]) < 1 or SERVE_URGENT_STEPS[0] not in \
                r["preempt_steps"]:
            raise AssertionError(f"[serving {tag} {route}] preemptions at "
                                 f"steps {r['preempt_steps']}")
        if guard["spliced"] != c["prefix_hits"]:
            raise AssertionError(f"[serving {tag} {route}] {guard['spliced']}"
                                 f" splices held for {c['prefix_hits']} hits")
        if guard["chunked_decode_steps"] < 1 or guard["cache_ops"]:
            raise AssertionError(
                f"[serving {tag} {route}] decode steps with a row mid-"
                f"prefill: {guard['chunked_decode_steps']}, casts or copies "
                f"of a cache-shaped tensor {guard['cache_ops']}")
        # a recurrent model: the rows mid-prefill came out of every such
        # step bit-equal (guard_serving raised otherwise), and their state
        # rows were copied only by the engine's save and restore
        if r["state_leaves"] and (
                guard["state_rows_held"] != guard["chunked_rows"]
                or guard["state_row_copies"]
                != 2 * r["state_leaves"] * guard["chunked_rows"]):
            raise AssertionError(f"[serving {tag} {route}] state guard "
                                 f"{guard}")
    if g["profile"] is None or e["profile"] is None:
        raise AssertionError(f"[serving {tag}] the profiler reported no "
                             f"device time in the window")
    replay = compare_replay(g["profile"], e["profile"], cfg)
    plain = serve_route(cfg, params, dev, kv_store, plan, "graph",
                        plain=True)
    first_div = {}
    for rid, toks in g["generated"].items():
        other = plain["generated"][rid]
        first_div[rid] = next((i for i, (a, b) in enumerate(zip(toks, other))
                               if a != b), None)
    near_ties = {}
    if g["state_leaves"]:
        # a recurrent model's chunks, snapshots and preemption must give
        # the plain engine's tokens (required here, reported for the
        # rest), but at a near tie of the two runs
        for rid, i in first_div.items():
            if i is None:
                continue
            m = min(plain["margins"][rid][i], g["margins"][rid][i])
            if m >= NEAR_TIE:
                raise AssertionError(
                    f"[serving {tag}] request {rid} parts from the plain "
                    f"engine at token {i}, top-2 margin {m:.4g} >= "
                    f"{NEAR_TIE}: first divergent token by request "
                    f"{first_div}")
            near_ties[rid] = (i, m)
    return {"tag": tag, "arch": arch, "kv_store": kv_store,
            "plan": {"requests": len(plan), "tenants": n_ten,
                     "prefix": SERVE_PREFIX, "tail": list(tail),
                     "new_tokens": new, "chunk": SERVE_CHUNK,
                     "urgent_steps": list(SERVE_URGENT_STEPS),
                     "prefix_capacity_bytes": SERVE_PREFIX_BYTES},
            "routes": routes, "replay": replay, "plain": plain,
            "agreement_with_plain": token_agreement(plain["generated"],
                                                    g["generated"]),
            "first_divergent_token_vs_plain": first_div,
            "near_ties": near_ties}


def log_serving(res: dict) -> None:
    tag = res["tag"]
    for route in ROUTES:
        r = res["routes"][route]
        c, gd, pt = r["counters"], r["guard"], r["per_token_ms"]
        hit = (r["ttft_hit_ms"] or {}).get("p50", float("nan"))
        miss = (r["ttft_miss_ms"] or {}).get("p50", float("nan"))
        pi = r["prefix_index"] or {}
        pr = r["profile"]
        log(f"  [serving {tag} {route}] {r['requests']} requests in "
            f"{r['steps']} steps, {r['wall_s']:.2f} s: TTFT p50 hit "
            f"{hit:.2f} ms miss {miss:.2f} ms; per-token p50 "
            f"{pt['p50']:.3f} ms p90 {pt['p90']:.3f} ms; capture s "
            f"{json.dumps(r['capture_s'])}; peak {r['peak_mem_gb']:.3f} GB; "
            f"prefix segments {pi.get('segments')} holding "
            f"{pi.get('bytes', 0) / 1e6:.1f} MB")
        log(f"    evicted {c['evicted']} at steps {r['preempt_steps']} "
            f"{r['evictions']}; prefill chunks {c['prefill_chunks']}; "
            f"prefix hits {c['prefix_hits']} misses {c['prefix_misses']} "
            f"saved {c['prefill_tokens_saved']} tokens; splices held byte "
            f"for byte {gd['spliced']} ({gd['spliced_positions']} "
            f"positions); decode steps with a row mid-prefill "
            f"{gd['chunked_decode_steps']} ({gd['chunked_rows']} rows), "
            f"cache-shaped casts or copies in them "
            f"{gd['cache_ops'] or 'none'}"
            + (f", state rows held bit-equal {gd['state_rows_held']} "
               f"(copies of whole state rows {gd['state_row_copies']}: "
               f"the save and restore)" if r["state_leaves"] else "")
            + f"; launches {r['launches']}")
        if pr is not None:
            log(f"    window of {pr['steps']} steps from step "
                f"{SERVE_WINDOW[0]}: device busy "
                f"{pr['device_busy_ms_per_step']:.3f} ms a step, "
                f"{pr['kernels_per_step']:.0f} kernels a step; pad kernels "
                f"lost {pr['pads_lost']} of {PAD_KERNELS} each")
    p = res["plain"]
    log(f"  [serving {tag} plain] no chunking, no prefix cache, no "
        f"deadlines: per-token p50 {p['per_token_ms']['p50']:.3f} ms, TTFT "
        f"p50 {p['ttft_ms']['p50']:.2f} ms; tokens agreeing with the "
        f"chunked graph run {res['agreement_with_plain']}; first divergent "
        f"token by request {res['first_divergent_token_vs_plain']}"
        + (f"; near ties (token, margin) {res['near_ties']}"
           if p["state_leaves"] else ""))
    log(f"  [serving {tag} replay] graph and eager tokens equal; the window's "
        f"replayed steps ran {res['replay']['port_kernels_per_step']:.0f} "
        f"port kernels a step as the eager steps; library differences "
        f"{res['replay']['library_differences'] or 'none'}")


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


def ragged_plan_at(plan, deg: int, M: int, K: int, T: int):
    """``plan``'s column block at split degree ``deg`` (None where the
    kernel does not take it), at the default depth."""
    if K % deg or (K // deg) % 8:
        return None
    k_blk = sub_rows(plan.m_blk, K // deg, 2)
    n_k = -(-(K // deg) // k_blk)
    stages = min(2, n_k)
    alt = dataclasses.replace(
        plan, split_k=deg, k_blk=k_blk, n_k=n_k, stages=stages,
        smem_bytes=stream_smem(ragged_box_rows(T, 2), plan.m_blk, k_blk,
                               stages, 2, deg))
    return alt if ragged_plan_fits(alt, M, K, T) else None


def ragged_sweeps(shape, name, x, offsets, ws, n_copies, plan, out, ref):
    """ragged_gemv at every ring depth the card holds (bit-identical to
    the plan's depth) and at every split degree of the plan's column
    block (each held to the tolerance against the plain version), timed;
    returns the sweep rows."""
    T, K, M = x.shape[0], x.shape[1], out.shape[1]
    rows, times, split_times = [], {}, {}
    for depth in range(1, MAX_STAGES + 1):
        dplan = with_pipeline_depth(plan, depth,
                                    batch=ragged_box_rows(T, 2),
                                    elem_bytes=2)
        if dplan is None:
            continue
        if not torch.equal(ragged_gemv(x, offsets, ws[0], plan=dplan), out):
            raise AssertionError(
                f"ragged_gemv {shape} {name}: stages={depth} differs from "
                f"the default stages={plan.stages}")

        def run_d(i, dplan=dplan):
            ragged_gemv(x, offsets, ws[i % n_copies], plan=dplan)

        times[depth] = graph_ms(run_d, 40)
        rows.append(dict(kernel="ragged_gemv", shape=shape, routing=name,
                         T=T, m_blk=plan.m_blk, split_k=plan.split_k,
                         default_stages=plan.stages, stages=depth,
                         ms=times[depth]))
    for deg in RAGGED_DEGREES:
        splan = ragged_plan_at(plan, deg, M, K, T)
        if splan is None:
            continue
        check_close("ragged_gemv", f"{shape} {name} split {deg}",
                    ragged_gemv(x, offsets, ws[0], plan=splan), ref)

        def run_s(i, splan=splan):
            ragged_gemv(x, offsets, ws[i % n_copies], plan=splan)

        split_times[deg] = graph_ms(run_s, 40)
        rows.append(dict(kernel="ragged_gemv", shape=shape, routing=name,
                         T=T, m_blk=plan.m_blk, split_k=deg,
                         default_split=plan.split_k, stages=splan.stages,
                         ms=split_times[deg]))
    log(f"  ragged_gemv  {shape:8s} {name:8s} bit-identical at stages "
        f"{sorted(times)} (default {plan.stages}); ms "
        + " ".join(f"s{d}={t:.4f}" for d, t in times.items())
        + f"; within tolerance at split degrees {sorted(split_times)} "
        f"(plan {plan.split_k}); ms "
        + " ".join(f"d{d}={t:.4f}" for d, t in split_times.items()))
    return rows


def check_moe_kernels(dev) -> tuple[list[dict], list[dict]]:
    """ragged_gemv on the four routings and grouped_gemv at C=8, at
    deepseek-moe-16b's expert shapes in bf16: each against its plain
    version, then timed with the stack rotated past the L2 (copies enough
    that even the 6 experts of one token exceed it twice over); ragged on
    the plan for the card's SMs (live CTAs, split degree), equal from run
    to run, and on the top-6 routings at every ring depth (bit-identical)
    and every split degree (within tolerance), timed; grouped also at
    C=16 and 64 (several n-tiles a weight sub-tile: checked), and at C=8
    at every ring depth (bit-identical to the default, timed).  Returns
    the rows and the sweeps."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    routings = moe_routings()
    rows, sweep = [], []
    for shape, (K, M, per_step) in MOE_SHAPES.items():
        gplan = plan_grouped_stream(M, K, MOE_C, E=MOE_E)
        n_copies = max(2, math.ceil(2 * L2_BYTES / (MOE_TOPK * K * M * 2))
                       + 1)
        ws = [(torch.randn((MOE_E, K, M), generator=gen, device=dev)
               / math.sqrt(K)).to(torch.bfloat16) for _ in range(n_copies)]
        for name, (T, counts) in routings.items():
            plan = plan_ragged_stream(M, K, T, E=MOE_E)
            x = torch.randn((T, K), generator=gen, device=dev).to(
                torch.bfloat16)
            offsets = counts_to_offsets(torch.tensor(
                counts, dtype=torch.int32, device=dev))
            out = ragged_gemv(x, offsets, ws[0], plan=plan)
            again = ragged_gemv(x, offsets, ws[0], plan=plan)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"ragged_gemv {shape} {name}: differs "
                                     f"from run to run")
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

            def run(i, x=x, offsets=offsets, plan=plan):
                ragged_gemv(x, offsets, ws[i % n_copies], plan=plan)

            def run_plain(i, x=x, offsets=offsets):
                ragged_gemv_plain(x, offsets, ws[i % n_copies])

            def run_bmm(i, xp=xp, wa=wa):
                torch.bmm(xp, wa[i % n_copies])

            live = len(active) * plan.n_m * plan.split_k
            row = dict(kernel="ragged_gemv", shape=shape, routing=name, T=T,
                       K=K, M=M, per_step=per_step,
                       experts_with_rows=len(active),
                       rows=int(counts.sum()),
                       plan=dict(plan_dict(plan), live_ctas=live,
                                 ctas=min(MOE_E, T) * plan.n_m
                                 * plan.split_k),
                       max_abs_err=err, ms=graph_ms(run, 40),
                       plain_ms=event_ms(run_plain, 5), library_ms=None,
                       bmm_ref_ms=graph_ms(run_bmm, 40),
                       **moe_bounds(K, M, len(active), int(counts.sum()), T,
                                    T))
            row["hbm_share"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            del wa, xp
            log(f"  ragged_gemv  {shape:8s} {name:8s} T={T:2d} experts "
                f"{len(active):2d} live ctas {live:4d} (m_blk "
                f"{plan.m_blk}, split {plan.split_k}) err={err:.2e} "
                f"ms={row['ms']:.4f} bound={row['bound_ms']:.4f} "
                f"({row['hbm_share']:.0%}) plain={row['plain_ms']:.4f} "
                f"bmm ref={row['bmm_ref_ms']:.4f}")
            if name in ("top6_b8", "top6_b1"):
                sweep += ragged_sweeps(shape, name, x, offsets, ws,
                                       n_copies, plan, out, ref)
        xs = torch.randn((MOE_E, MOE_C, K), generator=gen, device=dev).to(
            torch.bfloat16)
        out = grouped_gemv(xs, ws[0], plan=gplan)
        torch.cuda.synchronize()
        err = check_close("grouped_gemv", f"{shape} C={MOE_C}", out,
                          grouped_gemv_plain(xs, ws[0]))
        more_c = {}
        for C in MOE_CHECK_C:
            xc = torch.randn((MOE_E, C, K), generator=gen, device=dev).to(
                torch.bfloat16)
            more_c[C] = check_close(
                "grouped_gemv", f"{shape} C={C}",
                grouped_gemv(xc, ws[0], plan=plan_grouped_stream(
                    M, K, C, E=MOE_E)),
                grouped_gemv_plain(xc, ws[0]))
            del xc

        def run_g(i):
            grouped_gemv(xs, ws[i % n_copies], plan=gplan)

        def run_g_plain(i):
            grouped_gemv_plain(xs, ws[i % n_copies])

        def run_g_lib(i):
            torch.bmm(xs, ws[i % n_copies])

        rows_g = MOE_E * MOE_C
        row = dict(kernel="grouped_gemv", shape=shape, routing=f"C={MOE_C}",
                   T=rows_g, K=K, M=M, per_step=per_step,
                   experts_with_rows=MOE_E, rows=rows_g,
                   plan=dict(m_blk=gplan.m_blk, k_blk=gplan.k_blk,
                             stages=gplan.stages,
                             ctas=MOE_E * gplan.n_m,
                             ctas_per_sm=ctas_per_sm(gplan.smem_bytes)),
                   max_abs_err=max(err, *more_c.values()),
                   max_abs_err_by_c={MOE_C: err, **more_c},
                   ms=graph_ms(run_g, 20),
                   plain_ms=graph_ms(run_g_plain, 5),
                   library_ms=graph_ms(run_g_lib, 20),
                   **moe_bounds(K, M, MOE_E, rows_g, rows_g, rows_g))
        row["hbm_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"  grouped_gemv {shape:8s} C={MOE_C} err={err:.2e} "
            f"ms={row['ms']:.4f} bound={row['bound_ms']:.4f} "
            f"({row['hbm_share']:.0%}) plain={row['plain_ms']:.4f} "
            f"bmm={row['library_ms']:.4f} m_blk={gplan.m_blk} ctas="
            f"{MOE_E * gplan.n_m} stages={gplan.stages}; C="
            + ", ".join(f"{c} err={e:.2e}" for c, e in more_c.items()))
        times = {}
        for depth in range(1, MAX_STAGES + 1):
            dplan = with_pipeline_depth(gplan, depth,
                                        batch=stream_rows(MOE_C, 2),
                                        elem_bytes=2)
            if dplan is None:
                continue
            if not torch.equal(grouped_gemv(xs, ws[0], plan=dplan), out):
                raise AssertionError(
                    f"grouped_gemv {shape}: stages={depth} differs from "
                    f"the default stages={gplan.stages}")

            def run_d(i, dplan=dplan):
                grouped_gemv(xs, ws[i % n_copies], plan=dplan)

            times[depth] = graph_ms(run_d, 20)
            sweep.append(dict(kernel="grouped_gemv", shape=shape, K=K, M=M,
                              C=MOE_C, m_blk=gplan.m_blk,
                              default_stages=gplan.stages, stages=depth,
                              ms=times[depth]))
        log(f"  grouped_gemv {shape:8s} C={MOE_C} bit-identical at stages "
            f"{sorted(times)} (default {gplan.stages}); ms "
            + " ".join(f"s{d}={t:.4f}" for d, t in times.items()))
        # the other column block the planner could have picked, checked
        # against the plain version and timed at the shallow depths
        other = 64 if gplan.m_blk == 128 else 128
        k_blk = sub_rows(other, K, 2)
        alt = GemvPlan(m_blk=other, k_blk=k_blk, n_m=-(-M // other),
                       n_k=-(-K // k_blk), smem_bytes=0)
        alt_times = {}
        for depth in (1, 2, 3, 4):
            aplan = with_pipeline_depth(alt, depth, batch=MOE_C,
                                        elem_bytes=2)
            check_close("grouped_gemv", f"{shape} m_blk={other}",
                        grouped_gemv(xs, ws[0], plan=aplan),
                        grouped_gemv_plain(xs, ws[0]))

            def run_a(i, aplan=aplan):
                grouped_gemv(xs, ws[i % n_copies], plan=aplan)

            alt_times[depth] = graph_ms(run_a, 20)
            sweep.append(dict(kernel="grouped_gemv", shape=shape, K=K, M=M,
                              C=MOE_C, m_blk=other, stages=depth,
                              ms=alt_times[depth]))
        log(f"  grouped_gemv {shape:8s} C={MOE_C} m_blk={other} (not the "
            f"plan's): ms " + " ".join(f"s{d}={t:.4f}"
                                       for d, t in alt_times.items()))
        del ws, xs
        torch.cuda.empty_cache()
    return rows, sweep


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
    if (nk["ragged_gemv"] != 3 * cfg.n_layers
            or any(nr[n] for n in GEMV_KERNELS)):
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
    programs (C=8 rows per expert, within the batch gate), with replayed
    graphs and under ``disable_graphs()``: greedy tokens equal both
    ways."""
    routes = {}
    for route in ROUTES:
        with route_ctx(route):
            routes[route] = run_grouped_route(cfg, params, dev, route)
    if routes["graph"]["generated"] != routes["eager"]["generated"]:
        raise AssertionError("grouped engine: greedy tokens differ between "
                             "the graph and eager routes")
    res = {**routes["graph"], "routes": routes,
           "replay": compare_replay(routes["graph"]["profile"],
                                    routes["eager"]["profile"], cfg)}
    res["agreement_with_ragged"] = token_agreement(
        res["generated"], {rid: ragged_generated[rid][:MOE_GROUPED_TOKENS]
                           for rid in res["generated"]})
    return res


def run_grouped_route(cfg, params, dev, route: str) -> dict:
    kw = dict(batch_slots=1, gemv_expert_shape="grouped")
    lengths = ENGINE_LENGTHS[:2]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = serve(cfg, params, dev, lengths, MOE_GROUPED_TOKENS, SEED, **kw)
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
    doc = eng.metrics.to_dict(include_steps=True)
    steps = doc["counters"]["decode_steps"]
    batches = counted_batches(route, [st["decode_batch"]
                                      for st in doc["steps"]
                                      if st["decode_batch"]])
    # gate, up and down of every layer, one grouped program each
    if counts["grouped_gemv"] != 3 * cfg.n_layers * len(batches):
        raise AssertionError(
            f"{len(batches)} counted decode steps launched grouped_gemv "
            f"{counts['grouped_gemv']} times (expected "
            f"{3 * cfg.n_layers} a step): {counts}")
    res = {"route": route, "requests": len(done), "wall_s": wall_s,
           "decode_steps": steps, "counted_steps": len(batches),
           "capture_s": ({str(b): s for b, s in eng.graphs.capture_s.items()}
                         if route == "graph" else {}),
           "logit_rows_checked": seen["rows"],
           "generated": {r.rid: list(r.generated) for r in done},
           "per_token_ms": doc["per_token_ms"],
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": counts,
           "launches_per_step": {k: v / len(batches)
                                 for k, v in counts.items()},
           "program_modes": stats["program_modes"],
           "expert_load": stats["expert_load"]}
    del eng
    gc.collect()
    res["profile"] = profile_fresh(
        lambda: serve(cfg, params, dev, lengths[:1], 8, SEED + 1, **kw),
        doc["per_token_ms"]["p50"])
    if res["profile"] is None or res["profile"]["cache_copies"]:
        raise AssertionError(
            "grouped decode steps cast or copied the K/V cache: "
            + str(res["profile"] and res["profile"]["cache_copies"]))
    return res


# ---------------------------------------------------------------------------
# autotune: measured selection, persisted and replayed
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the dense families: minitron-8b, gemma3-1b and gemma3-27b
# ---------------------------------------------------------------------------

FAMILIES = ("minitron-8b", "gemma3-1b", "gemma3-27b")
# gemma3-27b's 62 layers of bf16 weights (54 GB) and their prepacked
# copies do not fit the card's 80 GB: full width, its first 12 layers
# (layers 5 and 11 global)
FAMILY_DEPTH = {"gemma3-27b": 12}
FAMILY_BATCHES = (1, 8)
FAMILY_MAX_LEN = 2048
# 8 prompts of 64 to 1536 tokens, three longer than the 1024-position
# window of gemma3's local layers
FAMILY_LENGTHS = [64, 1536, 300, 1100, 700, 1300, 128, 900]
FAMILY_TOKENS = 32
FAMILY_WINDOWS = (1024, 0)      # a local layer's window, a global layer's


def family_config(arch: str):
    cfg = get_config(arch)
    depth = FAMILY_DEPTH.get(arch)
    return dataclasses.replace(cfg, n_layers=depth) if depth else cfg


def layer_windows(cfg) -> dict[int, int]:
    """{window: layers} of the config's layer stack (0: a global layer)."""
    return dict(collections.Counter(lm.layer_window(cfg, i)
                                    for i in range(cfg.n_layers)))


def family_gemv_shapes(cfg) -> dict[str, tuple[int, int, int]]:
    """{site: (K, M, calls a decode step)} of the config's decode GEMVs."""
    return {n: (K, M, calls) for n, (M, K, calls)
            in decode_sites(cfg).items()}


def check_family_attention(dev, cfg) -> list[dict]:
    """decode_attention at the family's decode shape (8 slots of a
    2048-position cache, its kv heads, G and head dim) with a window of
    1024 and with none: rows shorter than, at and longer than the window,
    the whole cache, and idle slots past the end (one inside its last
    window, one past C + window - 1: every score masked), against the
    plain version at every split count; int8 / int4 pages bit-identical to
    the fp kernel on ``dequantize_page``'s tensor; the two windows must
    differ on a row longer than 1024.  Then timed per window on a mid-run
    step's lengths (prompts + 16) beside its bound (the positions inside
    the window), the plain version and ``scaled_dot_product_attention``
    (a boolean mask of the same positions, ``enable_gqa``).  ``per_step``
    is the layers of the engine's config with that window."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 91)
    B, C = ATTN_SLOTS, FAMILY_MAX_LEN
    Hkv, D, H = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    G = H // Hkv
    splits = plan_splits(B, Hkv, C, G, D,
                         torch.cuda.get_device_properties(dev)
                         .multi_processor_count)
    counts = sorted({splits, 1, 2, 4, 8})

    def cache():
        return torch.randn((B, C, Hkv, D), generator=gen, device=dev).to(
            torch.bfloat16)

    k0, v0 = cache(), cache()
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(
        torch.bfloat16)
    qpos = torch.tensor([63, 1023, 1535, C - 1, 299, 1100, C + 500,
                         C + 1100], dtype=torch.int32, device=dev)
    valid = qpos + 1
    atol = 2.0**-8 * v0.float().abs().max().item()
    errs, outs = {}, {}
    for window in FAMILY_WINDOWS:
        args = dict(q_positions=qpos[:, None], kv_valid_len=valid,
                    window=window)
        want = decode_attention_plain(q, k0, v0, **args)
        for n_split in counts:
            out = decode_attention(q, k0, v0, splits=n_split, **args)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs()
            bad = err > atol + ATTN_RTOL * want.float().abs()
            if not torch.isfinite(out.float()).all() or bad.any():
                raise AssertionError(
                    f"decode_attention {cfg.name} window={window} "
                    f"splits={n_split}: {int(bad.sum())} elements off its "
                    f"plain version (max abs err {err.max().item():.3e})")
            errs[f"w{window}/s{n_split}"] = err.max().item()
        outs[window] = out
        for bits in (8, 4):
            (kc, kscale), (vc, vscale) = (quantize_page(k0, bits),
                                          quantize_page(v0, bits))
            kf = dequantize_page(kc, kscale, hd=D, out_dtype=torch.bfloat16)
            vf = dequantize_page(vc, vscale, hd=D, out_dtype=torch.bfloat16)
            for n_split in counts:
                got = decode_attention(q, kc, vc, splits=n_split,
                                       k_scale=kscale, v_scale=vscale,
                                       **args)
                if not torch.equal(got, decode_attention(
                        q, kf, vf, splits=n_split, **args)):
                    raise AssertionError(
                        f"decode_attention {cfg.name} int{bits} window="
                        f"{window} splits={n_split}: differs from the fp "
                        f"kernel on the dequantized pages")
    if torch.equal(outs[1024][2], outs[0][2]):
        raise AssertionError(f"decode_attention {cfg.name}: window 1024 and "
                             f"no window agree on a row of 1536 positions")
    del k0, v0
    log(f"  decode_attention {cfg.name}: B={B} C={C} Hkv={Hkv} G={G} D={D}:"
        f" windows {FAMILY_WINDOWS} against the plain version at splits "
        f"{counts} (max err {max(errs.values()):.2e}), idle slots past "
        f"the end (one past C + window - 1), int8 / int4 pages "
        f"bit-identical to the fp kernel; window 1024 and 0 differ on a "
        f"row of 1536 positions")

    lengths = [n + FAMILY_TOKENS // 2 for n in FAMILY_LENGTHS]
    tvalid = torch.tensor(lengths, dtype=torch.int32, device=dev)
    tpos = (tvalid - 1).long()[:, None]
    kpos = torch.arange(C, device=dev)[None, :]
    per_window = layer_windows(cfg)
    rows = []
    for window in FAMILY_WINDOWS:
        inside = [min(n, window) if window else n for n in lengths]
        bound = attention_bound(inside, B, H, Hkv, D)
        n_copies = max(2, math.ceil(2 * L2_BYTES
                                    / (bound["bytes_ms"] * HBM_BYTES_PER_S
                                       / 1e3)) + 1)
        ks = [cache() for _ in range(n_copies)]
        vs = [cache() for _ in range(n_copies)]
        mask = kpos < tvalid[:, None]
        if window:
            mask &= kpos >= tvalid[:, None] - window
        mask = mask[:, None, None, :]

        def run(i, window=window):
            decode_attention(q, ks[i % n_copies], vs[i % n_copies],
                             q_positions=tpos, kv_valid_len=tvalid,
                             window=window)

        def run_plain(i, window=window):
            decode_attention_plain(q, ks[i % n_copies], vs[i % n_copies],
                                   q_positions=tpos, kv_valid_len=tvalid,
                                   window=window)

        def run_lib(i, mask=mask):
            F.scaled_dot_product_attention(
                q.transpose(1, 2), ks[i % n_copies].transpose(1, 2),
                vs[i % n_copies].transpose(1, 2), attn_mask=mask,
                enable_gqa=G > 1)

        row = dict(kernel="decode_attention", arch=cfg.name,
                   shape=f"{cfg.name}/w{window}", store="fp", B=B, C=C,
                   Hkv=Hkv, H=H, G=G, D=D, window=window, valid=lengths,
                   positions_read=sum(inside), splits=splits,
                   per_step=per_window.get(window, 0),
                   max_abs_err=max(errs.values()), errs=errs,
                   ms=graph_ms(run, 100), plain_ms=graph_ms(run_plain, 20),
                   library_ms=graph_ms(run_lib, 100), **bound)
        row["hbm_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"  decode_attention {cfg.name} window={window}: "
            f"{sum(inside)} positions read, ms={row['ms']:.4f} "
            f"bound={row['bound_ms']:.4f} ({row['hbm_share']:.0%}) "
            f"plain={row['plain_ms']:.4f} sdpa={row['library_ms']:.4f}; "
            f"{row['per_step']} layers a step")
        del ks, vs
    torch.cuda.empty_cache()
    return rows


def run_families(dev) -> dict:
    """Each family at full width (gemma3-27b at 12 layers) through
    ``Engine(batch_slots=8, max_len=2048)``, both routes, then one decode
    step through the kernels and through ``kernel="ref"``; each family's
    weights are freed before the next family's are drawn."""
    out = {}
    for arch in FAMILIES:
        cfg = family_config(arch)
        cut = (f" (cut from {get_config(arch).n_layers})"
               if arch in FAMILY_DEPTH else "")
        log(f"[families engine] {arch}: {cfg.n_layers} layers{cut}, "
            f"d={cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv "
            f"heads of {cfg.hd}, d_ff={cfg.d_ff}, {cfg.act}, "
            f"{cfg.norm_type}, windows {layer_windows(cfg)}, bf16, seed "
            f"{SEED}")
        t0 = time.perf_counter()
        params = lm.init_lm(cfg, seed=SEED, device=dev)
        torch.cuda.synchronize()
        log(f"  init {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")
        res = run_engine(cfg, params, dev, new_tokens=FAMILY_TOKENS,
                         lengths=FAMILY_LENGTHS, max_len=FAMILY_MAX_LEN,
                         ttft=False)
        log_routes(arch, res)
        pt = res["per_token_ms"]
        log(f"  [{arch}] requests {res['requests']}, tokens "
            f"{res['tokens']}, per-token p50 {pt['p50']:.2f} ms p90 "
            f"{pt['p90']:.2f} ms, TTFT p50 {res['ttft_ms']['p50']:.1f} ms, "
            f"peak {res['peak_mem_gb']:.2f} GB; launches per decode step "
            f"(eager) {res['routes']['eager']['launches_per_step']}, as "
            f"the picks predict {res['float_launches_by_batch']}")
        res["logits"] = logits_check(cfg, params, dev, FAMILY_LENGTHS,
                                     FAMILY_MAX_LEN, strict=False)
        lg = res["logits"]
        log(f"[families logits] {arch}: batch {lg['batch']}: max |kernels "
            f"- ref| {lg['max_abs_diff']:.4f} ({lg['diff_in_ulps']:.1f} "
            f"bf16 ulps at |logit| max {lg['logit_absmax']:.2f}); argmax "
            f"agree {lg['argmax_agree']}/{lg['batch']}")
        res["layers"], res["cut_from"] = cfg.n_layers, get_config(
            arch).n_layers
        out[arch] = res
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# multimodal: whisper-small and llama-3.2-vision-11b
# ---------------------------------------------------------------------------

MULTIMODAL = ("whisper-small", "llama-3.2-vision-11b")
# every cross_gate after init_lm: the init's zeros make tanh(gate) 0 and
# switch llama-vision's cross-attention off (whisper applies no gate)
MM_GATE = 1.0
MM_TOKENS = 32
MM_MAX_LEN = 1024


def mm_attention_shapes() -> dict[str, dict]:
    """decode_attention's new shapes on the decode step: whisper-small's
    self-attention (12 kv heads of 64, G 1, over the 1024-position cache)
    and cross-attention (over the encoder's 1500 frames), and
    llama-3.2-vision-11b's cross-attention (8 kv heads of 128, G 4, over
    1601 patch embeddings).  A cross call is the causal query at ``Sk -
    1`` over all ``Sk`` freshly projected keys."""
    w, v = get_config("whisper-small"), get_config("llama-3.2-vision-11b")
    return {
        "whisper-small/self": dict(cfg=w, C=MM_MAX_LEN, cross=False,
                                   per_step=w.n_layers),
        "whisper-small/cross": dict(cfg=w, C=w.encoder.n_frames, cross=True,
                                    per_step=attention_layers(w)
                                    - w.n_layers),
        "llama-3.2-vision-11b/cross": dict(cfg=v, C=v.vision_tokens,
                                           cross=True,
                                           per_step=attention_layers(v)
                                           - v.n_layers),
    }


def check_mm_attention(dev) -> list[dict]:
    """decode_attention at each of :func:`mm_attention_shapes`, 8 slots:
    the routing rule must take it (a plan of splits exists); against its
    plain version at every split count that fits (the self shape on a
    mid-run step's lengths and with idle slots past the end; a cross
    shape in its causal form against the plain NON-causal query), then
    timed (inputs rotated past the L2) beside its bound (the valid K and
    V bytes), the plain version and ``scaled_dot_product_attention``
    (``enable_gqa``; the valid positions as a boolean mask for self)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 92)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B = ATTN_SLOTS
    rows = []
    for shape, spec in mm_attention_shapes().items():
        cfg, C, cross = spec["cfg"], spec["C"], spec["cross"]
        Hkv, D, H = cfg.n_kv_heads, cfg.hd, cfg.n_heads
        G = H // Hkv

        def kv():
            return torch.randn((B, C, Hkv, D), generator=gen,
                               device=dev).to(torch.bfloat16)

        q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(
            torch.bfloat16)
        k0, v0 = kv(), kv()
        splits = plan_splits(B, Hkv, C, G, D, sms)
        if splits is None or not kernel_applies(q, k0, v0, causal=True):
            raise AssertionError(
                f"decode_attention takes no plan at {shape} (B={B} C={C} "
                f"Hkv={Hkv} G={G} D={D}): the decode step would run it on "
                f"the plain path")
        counts = sorted(n for n in {splits, 1, 2, 4, 8}
                        if smem_bytes(G, D, C, n) <= SMEM_PER_CTA)
        if cross:
            lengths = [C] * B
            valid = None
            qpos = torch.full((B, 1), C - 1, dtype=torch.int32, device=dev)
            checks = {"all": (qpos, None)}

            def plain(k, v, **_):
                return decode_attention_plain(q, k, v, q_positions=None,
                                              kv_valid_len=None,
                                              causal=False)
        else:
            lengths = [n + MM_TOKENS // 2 for n in ENGINE_LENGTHS]
            valid = torch.tensor(lengths, dtype=torch.int32, device=dev)
            qpos = (valid - 1)[:, None]
            # idle slots past the end: a row at C - 1 and rows past it
            idle = torch.tensor([5, 40, C - 1, C - 1, C + 3, 900, 77, C + 99],
                                dtype=torch.int32, device=dev)
            checks = {"mid-run": (qpos, valid),
                      "idle": (idle[:, None], idle + 1)}

            def plain(k, v, q_positions, kv_valid_len):
                return decode_attention_plain(
                    q, k, v, q_positions=q_positions,
                    kv_valid_len=kv_valid_len, causal=True)
        atol = 2.0**-8 * v0.float().abs().max().item()
        errs = {}
        for tag, (qp, vl) in checks.items():
            want = plain(k0, v0, q_positions=qp, kv_valid_len=vl)
            for n_split in counts:
                out = decode_attention(q, k0, v0, q_positions=qp,
                                       kv_valid_len=vl, splits=n_split)
                torch.cuda.synchronize()
                err = (out.float() - want.float()).abs()
                bad = err > atol + ATTN_RTOL * want.float().abs()
                if not torch.isfinite(out.float()).all() or bad.any():
                    raise AssertionError(
                        f"decode_attention {shape} {tag} splits={n_split}: "
                        f"{int(bad.sum())} elements off its plain version "
                        f"(max abs err {err.max().item():.3e})")
                errs[f"{tag}/s{n_split}"] = err.max().item()
        del k0, v0
        bound = attention_bound(lengths, B, H, Hkv, D)
        n_copies = max(2, math.ceil(2 * L2_BYTES
                                    / (bound["bytes_ms"] * HBM_BYTES_PER_S
                                       / 1e3)) + 1)
        ks = [kv() for _ in range(n_copies)]
        vs = [kv() for _ in range(n_copies)]
        qp, vl = checks["all" if cross else "mid-run"]
        mask = None
        if not cross:
            kpos = torch.arange(C, device=dev)[None, :]
            mask = (kpos < valid[:, None])[:, None, None, :]

        def run(i, qp=qp, vl=vl):
            decode_attention(q, ks[i % n_copies], vs[i % n_copies],
                             q_positions=qp, kv_valid_len=vl)

        def run_plain(i, qp=qp, vl=vl, plain=plain):
            plain(ks[i % n_copies], vs[i % n_copies], q_positions=qp,
                  kv_valid_len=vl)

        def run_lib(i, mask=mask, G=G):
            F.scaled_dot_product_attention(
                q.transpose(1, 2), ks[i % n_copies].transpose(1, 2),
                vs[i % n_copies].transpose(1, 2), attn_mask=mask,
                enable_gqa=G > 1)

        row = dict(kernel="decode_attention", arch=cfg.name, shape=shape,
                   store="fp", B=B, C=C, Hkv=Hkv, H=H, G=G, D=D,
                   cross=cross, valid=lengths, positions_read=sum(lengths),
                   splits=splits, split_counts_checked=counts,
                   per_step=spec["per_step"], max_abs_err=max(errs.values()),
                   errs=errs, ms=graph_ms(run, 100),
                   plain_ms=graph_ms(run_plain, 20),
                   library_ms=graph_ms(run_lib, 100), **bound)
        row["hbm_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"  decode_attention {shape}: B={B} C={C} Hkv={Hkv} G={G} "
            f"D={D}, {splits} splits planned; against the plain "
            f"{'non-causal query' if cross else 'version'} at splits "
            f"{counts} (max err {row['max_abs_err']:.2e}); "
            f"{sum(lengths)} positions read, ms={row['ms']:.4f} "
            f"bound={row['bound_ms']:.4f} ({row['hbm_share']:.0%}) "
            f"plain={row['plain_ms']:.4f} sdpa={row['library_ms']:.4f}; "
            f"{row['per_step']} calls a step")
        del ks, vs
        torch.cuda.empty_cache()
    return rows


def recompute_ms(cfg, params: dict, dev, busy_ms: float | None) -> dict:
    """Device ms of what a decode step at batch 8 recomputes from the
    modality features, as the JAX package does every step: the cast of
    the features to bf16, whisper's encoder over its frames, and the
    cross K / V projections of every cross-attending layer (each timed
    alone, in a CUDA graph); and their share of the step's device busy
    (the replayed route's profile)."""
    feats = make_features(cfg, ATTN_SLOTS, dev)
    src = feats["frames" if cfg.encoder is not None else "vision"]
    dtype = getattr(torch, cfg.compute_dtype)
    x = src.to(dtype)
    ctx = (lm.run_encoder(params["encoder"], x, cfg)
           if cfg.encoder is not None else x)
    cross = [p["cross"] for p in params["layers"] if "cross" in p]

    def cast(i):
        src.to(dtype)

    def encoder(i):
        lm.run_encoder(params["encoder"], x, cfg)

    def kv(i):
        for p in cross:
            L.project_heads(ctx, p["wk"])
            L.project_heads(ctx, p["wv"])

    out = {"cast_ms": graph_ms(cast, 20),
           "encoder_ms": (graph_ms(encoder, 3)
                          if cfg.encoder is not None else 0.0),
           "cross_kv_ms": graph_ms(kv, 3), "cross_layers": len(cross),
           "context": list(ctx.shape)}
    total = out["cast_ms"] + out["encoder_ms"] + out["cross_kv_ms"]
    out["total_ms"] = total
    out["share_of_busy"] = total / busy_ms if busy_ms else None
    del feats, src, x, ctx
    torch.cuda.empty_cache()
    return out


def run_multimodal(dev) -> dict:
    """Each model at full width and depth through ``Engine(batch_slots=8,
    max_len=1024)`` with every ``cross_gate`` at ``MM_GATE``: 8 requests
    of 32 to 512 tokens, ``MM_TOKENS`` greedy tokens each, both routes and
    the engine phase's rules; what each step recomputes from the
    features; then one decode step through the kernels and through
    ``kernel="ref"``.  Each model's weights are freed before the next's
    are drawn."""
    out = {}
    for arch in MULTIMODAL:
        cfg = get_config(arch)
        ctx = (f"an encoder of {cfg.encoder.n_layers} layers over "
               f"{cfg.encoder.n_frames} frames of {cfg.encoder.d_model}; "
               f"every layer cross-attends, ungated"
               if cfg.encoder is not None else
               f"{cfg.vision_tokens} patch embeddings; every "
               f"{cfg.cross_attn_every}th layer cross-attends, gated")
        log(f"[multimodal engine] {arch}: {cfg.n_layers} layers, "
            f"d={cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv "
            f"heads of {cfg.hd}, d_ff={cfg.d_ff}, {cfg.act}; {ctx}; bf16, "
            f"seed {SEED}, cross_gate set to {MM_GATE}")
        t0 = time.perf_counter()
        params = lm.init_lm(cfg, seed=SEED, device=dev)
        for p in params["layers"]:
            if "cross_gate" in p:
                p["cross_gate"].fill_(MM_GATE)
        torch.cuda.synchronize()
        log(f"  init {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")
        res = run_engine(cfg, params, dev, new_tokens=MM_TOKENS,
                         lengths=ENGINE_LENGTHS, max_len=MM_MAX_LEN,
                         ttft=False)
        log_routes(arch, res)
        pt = res["per_token_ms"]
        log(f"  [{arch}] requests {res['requests']}, tokens "
            f"{res['tokens']}, per-token p50 {pt['p50']:.2f} ms p90 "
            f"{pt['p90']:.2f} ms, TTFT p50 {res['ttft_ms']['p50']:.1f} ms, "
            f"peak {res['peak_mem_gb']:.2f} GB; launches per decode step "
            f"(eager) {res['routes']['eager']['launches_per_step']}, as "
            f"the picks predict {res['float_launches_by_batch']}, "
            f"decode_attention {attention_layers(cfg)} a step")
        res["recompute"] = recompute_ms(
            cfg, params, dev, res["profile"]["device_busy_ms_per_step"])
        rc = res["recompute"]
        log(f"  [{arch}] recomputed every decode step at batch 8: feature "
            f"cast {rc['cast_ms']:.3f} ms, encoder {rc['encoder_ms']:.3f} "
            f"ms, cross K/V of {rc['cross_layers']} layers "
            f"{rc['cross_kv_ms']:.3f} ms: {rc['total_ms']:.3f} ms, "
            f"{rc['share_of_busy']:.0%} of the replayed step's device busy")
        res["logits"] = logits_check(cfg, params, dev, max_len=MM_MAX_LEN,
                                     strict=False)
        lg = res["logits"]
        log(f"[multimodal logits] {arch}: batch {lg['batch']}: max |kernels"
            f" - ref| {lg['max_abs_diff']:.4f} ({lg['diff_in_ulps']:.1f} "
            f"bf16 ulps at |logit| max {lg['logit_absmax']:.2f}); argmax "
            f"agree {lg['argmax_agree']}/{lg['batch']}")
        res["cross_gate"] = MM_GATE
        out[arch] = res
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# state: rwkv6-3b, recurrent state through the engine
# ---------------------------------------------------------------------------

STATE_ARCH = "rwkv6-3b"
STATE_TOKENS = 32
STATE_MAX_LEN = 1024


def perturb_rwkv(params: dict, seed: int) -> None:
    """Draw afresh, in place, what the init hides (its bonus ``u`` of
    zeros, token-shift mixes of 0.5, a constant decay bias, a group-norm
    scale of ones): ``u`` ~ N(0, 1), every ``mu`` ~ U(0, 1), ``w0`` ~
    N(-0.5, 1), ``ln_scale`` ~ U(0.5, 1.5); and scale the five time-mix
    projections by 4, as the CPU tests do, so that the state matters."""
    g = torch.Generator(device=params["embed"].device).manual_seed(seed)
    for p in params["layers"]:
        tm, cm = p["time_mix"], p["channel_mix"]
        tm["u"].normal_(generator=g)
        tm["mu"].uniform_(0, 1, generator=g)
        tm["w0"].normal_(-0.5, 1.0, generator=g)
        tm["ln_scale"].uniform_(0.5, 1.5, generator=g)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            tm[name].mul_(4)
        cm["mu"].uniform_(0, 1, generator=g)


STATE_DRIFT_LEN = 448          # one prompt: a tenant's prefix and a tail


def to_f32(node):
    """A params tree with every tensor cast to f32 (new tensors)."""
    if isinstance(node, dict):
        return {k: to_f32(v) for k, v in node.items()}
    if isinstance(node, list):
        return [to_f32(v) for v in node]
    return node.float()


def state_drift(cfg, params: dict, dev, new_tokens: int = 16) -> dict:
    """How far two batchings of the same work drift apart: one prompt of
    ``STATE_DRIFT_LEN`` tokens through ``lm.forward`` whole and in chunks
    of ``SERVE_CHUNK``, then ``new_tokens`` greedy tokens each way at
    batch 1.  Returns the first logits' max |diff|, their |logit| max and
    top-2 margin (whole prefill), and the first token where the two
    streams part (None: never) -- with the projections as perturbed
    (x4), with the time-mix projections divided back by 4 (exact in any
    float format; restored after), and in f32."""

    def run(p, c, chunk):
        cache = lm.init_cache(c, 1, STATE_MAX_LEN, per_slot_pos=True,
                              device=dev)
        t = torch.from_numpy(prompts(c.vocab, [STATE_DRIFT_LEN],
                                     SEED + 3)[0][None]).long().to(dev)
        for i in range(0, t.shape[1], chunk):
            logits, cache, _ = lm.forward(p, c, t[:, i:i + chunk],
                                          cache=cache)
        first = logits[0, -1].float()
        toks = [int(first.argmax())]
        for _ in range(new_tokens - 1):
            logits, cache, _ = lm.forward(
                p, c, torch.tensor([[toks[-1]]], device=dev), cache=cache)
            toks.append(int(logits[0, -1].argmax()))
        return first, toks

    def drift(p, c):
        (a, ta), (b, tb) = run(p, c, STATE_DRIFT_LEN), run(p, c, SERVE_CHUNK)
        top2 = a.topk(2).values
        return {"max_abs_diff": (a - b).abs().max().item(),
                "logit_absmax": a.abs().max().item(),
                "top2_margin": (top2[0] - top2[1]).item(),
                "first_divergent_token": next(
                    (i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                    None),
                "distinct_tokens": len(set(ta))}

    projections = [p["time_mix"][n] for p in params["layers"]
                   for n in ("wr", "wk", "wv", "wg", "wo")]
    out = {"bf16 x4": drift(params, cfg)}
    for w in projections:
        w.div_(4)
    out["bf16 x1"] = drift(params, cfg)
    for w in projections:
        w.mul_(4)
    p32 = to_f32(params)
    out["f32 x4"] = drift(p32, dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"))
    del p32
    torch.cuda.empty_cache()
    return out


def run_state(dev) -> dict:
    """rwkv6-3b at full width and depth, perturbed, through
    ``Engine(batch_slots=8, max_len=1024)``: the engine phases' 8
    requests, ``STATE_TOKENS`` greedy tokens each, both routes and the
    engine phase's rules (one ``pim_gemv`` launch a decode step, the
    head, and no other port kernel); one decode step through the kernel
    and through ``kernel="ref"``; how far two batchings of the same work
    drift apart (``state_drift``); then, with the weights in f32, the
    traffic mix of ``[serving]`` (2 tenants, 16-64-token tails, chunk
    128, the prefix cache with its state snapshots, the preemptions),
    whose tokens must equal the plain engine's but at a near tie."""
    cfg = get_config(STATE_ARCH)
    t0 = time.perf_counter()
    card = nvidia_smi_line()
    log(f"[state] every number below on {card}")
    log(f"[state kernels] pim_gemv and splitk_gemv at {cfg.name}'s head "
        f"(K {cfg.d_model}, M {cfg.vocab}) at B {FAMILY_BATCHES} (rtol "
        f"2^-7, atol 1e-3), timed")
    rows = check_kernels(dev, family_gemv_shapes(cfg), FAMILY_BATCHES,
                         cfg.name)
    H, hd = cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim
    log(f"[state engine] {cfg.name}: {cfg.n_layers} layers, d="
        f"{cfg.d_model}, time-mix heads {H} of {hd}, no attention, d_ff="
        f"{cfg.d_ff}, tied head of {cfg.vocab}; bf16, seed {SEED}, "
        f"perturbed (u, mu, w0, ln_scale drawn, projections x4)")
    params = lm.init_lm(cfg, seed=SEED, device=dev)
    perturb_rwkv(params, SEED)
    torch.cuda.synchronize()
    log(f"  init {time.perf_counter() - t0:.1f} s (with the kernel checks), "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")
    res = run_engine(cfg, params, dev, new_tokens=STATE_TOKENS,
                     lengths=ENGINE_LENGTHS, max_len=STATE_MAX_LEN,
                     ttft=False)
    want = {n: (1.0 if n == "pim_gemv" else 0.0) for n in KERNELS}
    for route in ROUTES:
        got = res["routes"][route]["launches_per_step"]
        if got != want:
            raise AssertionError(f"[state {route}] launches a counted decode "
                                 f"step {got}, expected {want}")
    log_routes(cfg.name, res)
    pt = res["per_token_ms"]
    log(f"  [{cfg.name}] requests {res['requests']}, tokens "
        f"{res['tokens']}, per-token p50 {pt['p50']:.3f} ms p90 "
        f"{pt['p90']:.3f} ms, TTFT p50 {res['ttft_ms']['p50']:.1f} ms, "
        f"peak {res['peak_mem_gb']:.3f} GB, state "
        f"{res['kv_bytes_per_slot'] / 1e6:.2f} MB a slot; launches a "
        f"counted decode step {res['routes']['eager']['launches_per_step']}"
        f", as the picks predict {res['float_launches_by_batch']}")
    res["logits"] = logits_check(cfg, params, dev, max_len=STATE_MAX_LEN,
                                 strict=False)
    lg = res["logits"]
    log(f"[state logits] {cfg.name}: batch {lg['batch']}: max |kernels - "
        f"ref| {lg['max_abs_diff']:.4f} ({lg['diff_in_ulps']:.1f} bf16 ulps "
        f"at |logit| max {lg['logit_absmax']:.2f}); argmax agree "
        f"{lg['argmax_agree']}/{lg['batch']}")
    # the mix in f32: in bf16 the perturbed model's logits drift by O(1)
    # between chunked and whole prefill of one prompt, so no two engines
    # that batch the work differently could agree; in f32 they drift by
    # less than 1e-3 (measured here)
    res["drift"] = state_drift(cfg, params, dev)
    for tag, d in res["drift"].items():
        log(f"[state drift] {tag}: {STATE_DRIFT_LEN} tokens whole vs chunks "
            f"of {SERVE_CHUNK}: first logits max |diff| "
            f"{d['max_abs_diff']:.4g} at |logit| max "
            f"{d['logit_absmax']:.3g}, top-2 margin {d['top2_margin']:.4g}; "
            f"streams part at token {d['first_divergent_token']} of 16 "
            f"({d['distinct_tokens']} distinct tokens)")
    params = to_f32(params)
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    tag = f"{cfg.name} f32"
    log(f"[state serving] {tag}: the same weights in f32; chunked prefill "
        f"({SERVE_CHUNK}), the prefix cache (state snapshots at chunk "
        f"boundaries) and preemption, both routes, then the plain engine "
        f"(tokens must be equal, or part only at a near tie < {NEAR_TIE})")
    res["serving"] = run_serving(cfg32, params, dev, tag)
    log_serving(res["serving"])
    res["kernel_rows"] = rows
    res["card"] = card
    res["seconds"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# hybrid: hymba-1.5b, Mamba heads beside sliding-window attention (G 5)
# ---------------------------------------------------------------------------

HYBRID_ARCH = "hymba-1.5b"
HYBRID_TOKENS = 32


def perturb_hymba(params: dict, seed: int) -> None:
    """Draw afresh, in place, what the init hides (betas of ones, a skip
    ``D`` of ones, a ``dt_bias`` of zeros, the same ``A_log`` row for
    every channel), as the CPU tests do: each beta ~ U(2, 6), ``D`` ~ N(0,
    1), ``dt_bias`` ~ N(-2, 1), ``A_log`` ~ N(-1, 1), so that the Mamba
    branch and its state matter."""
    g = torch.Generator(device=params["embed"].device).manual_seed(seed)
    for p in params["layers"]:
        p["beta_attn"].uniform_(2, 6, generator=g)
        p["beta_ssm"].uniform_(2, 6, generator=g)
        m = p["mamba"]
        m["D"].normal_(generator=g)
        m["dt_bias"].normal_(-2.0, 1.0, generator=g)
        m["A_log"].normal_(-1.0, 1.0, generator=g)


def run_hybrid(dev) -> dict:
    """hymba-1.5b at full width and depth, perturbed: ``[hybrid
    kernels]``, ``pim_gemv`` / ``splitk_gemv`` at each of its decode GEMV
    shapes and ``decode_attention`` at G 5 (windows 1024 and 0) against
    their plain versions, timed; ``[hybrid engine]``, ``Engine(batch_slots
    =8, max_len=2048)`` on the families' prompts of 64-1536 tokens,
    ``HYBRID_TOKENS`` greedy tokens each, both routes and the engine
    phase's rules (``decode_attention`` once a layer, ``pim_gemv`` /
    ``splitk_gemv`` as the picks predict); ``[hybrid logits]``; then, with
    the weights in f32, ``[hybrid serving]``: the traffic mix of
    ``[serving]`` with the prefix cache's state snapshots, whose tokens
    must equal the plain engine's but at a near tie."""
    cfg = get_config(HYBRID_ARCH)
    t0 = time.perf_counter()
    card = nvidia_smi_line()
    log(f"[hybrid] every number below on {card}")
    log(f"[hybrid kernels] pim_gemv and splitk_gemv at every decode GEMV "
        f"shape of {cfg.name} at B {FAMILY_BATCHES} (rtol 2^-7, atol 1e-3),"
        f" timed; decode_attention at G {cfg.n_heads // cfg.n_kv_heads} with"
        f" windows {FAMILY_WINDOWS}")
    # the tied head's 32001 columns are no whole number of 16-byte bf16
    # vectors: no kernel takes it, and the picks leave it on ref
    shapes = {k: v for k, v in family_gemv_shapes(cfg).items()
              if v[1] * 2 % 16 == 0}
    left = sorted(set(family_gemv_shapes(cfg)) - set(shapes))
    log(f"  no kernel takes {left} (columns not whole 16-byte vectors): "
        f"on ref")
    rows = check_kernels(dev, shapes, FAMILY_BATCHES, cfg.name)
    rows += check_family_attention(dev, cfg)
    di, n, cw = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim, \
        cfg.ssm.conv_dim
    log(f"[hybrid engine] {cfg.name}: {cfg.n_layers} layers, d="
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv heads "
        f"of {cfg.hd}, windows {layer_windows(cfg)}, Mamba heads beside "
        f"(inner {di}, state {n}, conv {cw}), d_ff={cfg.d_ff}, tied head of "
        f"{cfg.vocab}; bf16, seed {SEED}, perturbed (betas, D, dt_bias, "
        f"A_log drawn)")
    params = lm.init_lm(cfg, seed=SEED, device=dev)
    perturb_hymba(params, SEED)
    torch.cuda.synchronize()
    log(f"  init {time.perf_counter() - t0:.1f} s (with the kernel checks), "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")
    res = run_engine(cfg, params, dev, new_tokens=HYBRID_TOKENS,
                     lengths=FAMILY_LENGTHS, max_len=FAMILY_MAX_LEN,
                     ttft=False)
    log_routes(cfg.name, res)
    pt = res["per_token_ms"]
    log(f"  [{cfg.name}] requests {res['requests']}, tokens "
        f"{res['tokens']}, per-token p50 {pt['p50']:.3f} ms p90 "
        f"{pt['p90']:.3f} ms, TTFT p50 {res['ttft_ms']['p50']:.1f} ms, "
        f"peak {res['peak_mem_gb']:.3f} GB, KV and state "
        f"{res['kv_bytes_per_slot'] / 1e6:.2f} MB a slot; launches a "
        f"counted decode step {res['routes']['eager']['launches_per_step']}"
        f", as the picks predict {res['float_launches_by_batch']}")
    res["logits"] = logits_check(cfg, params, dev, max_len=FAMILY_MAX_LEN,
                                 strict=False)
    lg = res["logits"]
    log(f"[hybrid logits] {cfg.name}: batch {lg['batch']}: max |kernels - "
        f"ref| {lg['max_abs_diff']:.4f} ({lg['diff_in_ulps']:.1f} bf16 ulps "
        f"at |logit| max {lg['logit_absmax']:.2f}); argmax agree "
        f"{lg['argmax_agree']}/{lg['batch']}")
    # the mix in f32, as [state]'s: chunked and whole prefill of one
    # prompt are two batchings of the same work, which bf16 rounds apart
    params = to_f32(params)
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    tag = f"{cfg.name} f32"
    log(f"[hybrid serving] {tag}: the same weights in f32; chunked prefill "
        f"({SERVE_CHUNK}), the prefix cache (K/V spans and state snapshots "
        f"at chunk boundaries) and preemption, both routes, then the plain "
        f"engine (tokens must be equal, or part only at a near tie < "
        f"{NEAR_TIE})")
    res["serving"] = run_serving(cfg32, params, dev, tag)
    log_serving(res["serving"])
    res["kernel_rows"] = rows
    res["card"] = card
    res["seconds"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def host_wall_us(be, key, policy, dev) -> dict[str, float]:
    """Every autotune candidate of ``key`` on the tuner's synthetic inputs,
    timed the way the tuner timed them before it timed replayed graphs:
    the best of 3 host wall-clock calls, each between two synchronizes
    (one weight copy, L2-warm below 50 MB)."""
    if isinstance(key, GemvKey):
        x, pw = synthesize_gemv(key, dev)
        return {be.candidate_label(k, p): min(wall_trials_us(
                    lambda i, k=k, p=p: be.execute(k, x, pw, p)))
                for k, p in be.autotune_candidates(key, pw, policy)}
    program = _synthesize_program(key, dev)
    return {c.mode: min(wall_trials_us(
                lambda i, c=c: be.run_program_candidate(program, c, policy)))
            for c in be.program_candidates(key, policy)}


def run_autotune(dev) -> dict:
    """Tune every olmo-1b decode GEMV at batch 8 and two programs (fused
    QKV; deepseek-moe-16b's ragged gate/up experts, top-6 of 8 tokens) on
    the h100 and gpu backends into a table under ``build/``; then clear
    table and plan cache, reload the file, dispatch again untuned, and
    fail unless every pick is the table's winner.  Each winner is reported
    beside the cost model's pick and both times: the tuner's device time
    (the best of 3 replays of a captured graph over weight copies read
    cold), and beside every candidate's device time its host-wall time
    (:func:`host_wall_us`), with the winner the host clock would have
    picked and whether it moved."""
    AUTOTUNE_TABLE.unlink(missing_ok=True)
    dispatch.clear_autotune_table()
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    B = 8
    gemvs = {name: (PackedWeights(w_t=rand(K, M)), rand(B, K))
             for name, (K, M, _) in SHAPES.items()}
    splits = (2048, 2048, 2048)
    qkv = PackedWeights(w_t=rand(2048, sum(splits)))
    xq = rand(B, 2048)
    K, M, _ = MOE_SHAPES["gate_up"]
    T, counts = moe_routings()["top6_b8"]
    stack = PackedWeights(w_t=rand(MOE_E, K, M))
    xr = rand(T, K)
    cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
    bound = expert_batch_bound(8, MOE_TOPK, MOE_E)

    def run(policy):
        """Every case through the dispatcher; yields (case, program key or
        GEMV key, dispatch_stats of that case alone)."""
        for name, (pw, x) in gemvs.items():
            dispatch.clear_plan_cache()
            dispatch.dispatch_gemv(x, pw, policy=policy)
            K, M = pw.shape
            yield name, GemvKey(M=M, K=K, batch=B, bits=16, block=32,
                                dtype=str(x.dtype), backend=policy.backend
                                ), dispatch.dispatch_stats()
        dispatch.clear_plan_cache()
        dispatch.dispatch_prepacked(xq, qkv, splits, policy=policy)
        yield "qkv_program", GemvProgram(
            kind="fused", x=xq, weights=qkv, m_splits=splits,
            requests=()).key(policy.backend), dispatch.dispatch_stats()
        dispatch.clear_plan_cache()
        dispatch.dispatch_ragged(xr, cnt, stack, bound=bound, policy=policy)
        yield "ragged_program", GemvProgram.ragged(
            xr, cnt, stack, bound=bound).key(policy.backend), \
            dispatch.dispatch_stats()

    table = dispatch.autotune_table()
    res = {"table": str(AUTOTUNE_TABLE.relative_to(ROOT)), "cases": []}
    for backend in ("h100", "gpu"):
        tune = DispatchPolicy(backend=backend, autotune=True,
                              table_path=str(AUTOTUNE_TABLE))
        model = DispatchPolicy(backend=backend)
        be = get_backend(backend)
        for case, key, _ in run(tune):
            if isinstance(key, GemvKey):
                entry = table.get(backend, key.table_key())
                # staged candidates: labels carry the ring depth
                pick = be.candidate_label(*be.select_kernel(
                    key.M, key.K, key.batch, policy=model))
                winner = be.candidate_label(*entry_to_plan(entry))
                dispatched = entry["kernel"]
            else:
                entry = table.get_program(backend, key.table_key())
                pick = be.plan_program(key, policy=model).mode
                winner = dispatched = entry["mode"]
            wall = host_wall_us(be, key, model, dev)
            if set(wall) != set(entry["candidates_us"]):
                raise AssertionError(f"{backend} {case}: host-wall "
                                     f"candidates {sorted(wall)} differ from "
                                     f"the tuned {entry['candidates_us']}")
            wall_winner = min(wall, key=wall.get)
            row = {"backend": backend, "case": case,
                   "key": key.table_key(), "winner": winner,
                   "dispatched": dispatched,
                   "winner_us": entry["us"], "model_pick": pick,
                   "model_pick_us": entry["candidates_us"][pick],
                   "candidates_us": entry["candidates_us"],
                   "host_wall_us": wall, "host_wall_winner": wall_winner,
                   "winner_moved": wall_winner != winner, "entry": entry}
            res["cases"].append(row)
            log(f"  {backend:4s} {case:14s} winner {winner:13s} "
                f"{entry['us']:8.1f} us; cost model {pick:13s} "
                f"{row['model_pick_us']:8.1f} us; host-wall winner "
                f"{wall_winner}{' (moved)' if row['winner_moved'] else ''}"
                f"; device / host-wall us: "
                + ", ".join(f"{k} {v:.1f} / {wall[k]:.1f}"
                            for k, v in entry["candidates_us"].items()))
    # replay: a fresh process's view of the file
    dispatch.clear_autotune_table()
    dispatch.clear_plan_cache()
    dispatch.load_autotune_table(str(AUTOTUNE_TABLE))
    want = {(r["backend"], r["case"]): r["dispatched"] for r in res["cases"]}
    got = {}
    for backend in ("h100", "gpu"):
        for case, key, stats in run(DispatchPolicy(backend=backend)):
            section = ("kernel_picks" if isinstance(key, GemvKey)
                       else "program_modes")
            picked = [k.split(":", 1)[1] for k in stats[section]]
            got[(backend, case)] = picked[0] if len(picked) == 1 else picked
    if got != want:
        raise AssertionError(f"replayed picks {got} differ from the "
                             f"table's winners {want}")
    res["replayed_equal"] = True
    log(f"  replayed from {res['table']}: all {len(got)} picks equal the "
        f"table's winners")
    dispatch.clear_autotune_table()
    dispatch.clear_plan_cache()
    del gemvs, qkv, stack
    torch.cuda.empty_cache()
    return res


STALE_TABLE = ROOT / "build" / "autotune_stale.json"


def replay_stale_table(dev) -> dict:
    """A table written before the streaming kernels, replayed: h100
    entries for olmo-1b's four decode GEMVs at batch 8 with the old
    one-stage plans (a 1024-row K chunk where K allows), ``grouped_cuda``
    and ``ragged_cuda`` programs for deepseek-moe-16b's gate/up experts on
    the first expert kernels' tiles (128 columns, a 1024-row x chunk, one
    stage), and a one-stage gpu ``triton`` entry for the head.  Each replays on its entry's kernel (re-planned
    where the kernel no longer takes the plan), launches it, and matches
    its plain version."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 55)

    def rand(*shape):
        return (torch.randn(shape, generator=gen, device=dev)
                / math.sqrt(shape[-2])).to(torch.bfloat16)

    B = 8
    picks = {"qkv": "splitk", "gate_up": "pim", "down": "splitk",
             "head": "pim"}
    table = dispatch.autotune_table()
    dispatch.clear_autotune_table()
    cases, res = {}, {"table": str(STALE_TABLE.relative_to(ROOT)),
                      "cases": []}
    for name, (K, M, _) in SHAPES.items():
        deg = 8 if picks[name] == "splitk" else 1
        k_blk = min(1024, K // deg)
        stale = GemvPlan(m_blk=128, k_blk=k_blk, n_m=M // 128,
                         n_k=K // deg // k_blk, smem_bytes=0, split_k=deg,
                         stages=1)
        key = GemvKey(M=M, K=K, batch=B, bits=16, block=32,
                      dtype=str(torch.bfloat16), backend="h100")
        table.put("h100", key.table_key(),
                  plan_to_entry(picks[name], stale, 1.0))
        cases[name] = (key, stale, PackedWeights(w_t=rand(K, M)),
                       torch.randn((B, K), generator=gen, device=dev).to(
                           torch.bfloat16))
    K, M, _ = MOE_SHAPES["gate_up"]
    stack = PackedWeights(w_t=rand(MOE_E, K, M))
    xs = torch.randn((MOE_E, MOE_C, K), generator=gen, device=dev).to(
        torch.bfloat16)
    pkey = GemvProgram.grouped(xs, stack).key("h100")
    # what the first expert kernels' planner gave at gate/up's shape
    old_tiles = GemvPlan(m_blk=128, k_blk=1024, n_m=11, n_k=2,
                         smem_bytes=40960)
    table.put_program("h100", pkey.table_key(), program_plan_to_entry(
        ProgramPlan(mode="grouped_cuda", n_launches=1, kernel="grouped_gemv",
                    plan=old_tiles), 1.0))
    T_r, counts_r = moe_routings()["top6_b8"]
    xr = torch.randn((T_r, K), generator=gen, device=dev).to(torch.bfloat16)
    counts_r = torch.tensor(counts_r, dtype=torch.int32, device=dev)
    rkey = GemvProgram.ragged(xr, counts_r, stack).key("h100")
    table.put_program("h100", rkey.table_key(), program_plan_to_entry(
        ProgramPlan(mode="ragged_cuda", n_launches=1, kernel="ragged_gemv",
                    plan=old_tiles), 1.0))
    hkey = GemvKey(M=SHAPES["head"][1], K=SHAPES["head"][0], batch=B,
                   bits=16, block=32, dtype=str(torch.bfloat16),
                   backend="gpu")
    one_stage = dataclasses.replace(plan_triton_gemv(hkey.M, hkey.K, B),
                                    stages=1)
    table.put("gpu", hkey.table_key(), plan_to_entry("triton", one_stage,
                                                     1.0))
    STALE_TABLE.unlink(missing_ok=True)
    table.save(str(STALE_TABLE))
    dispatch.clear_autotune_table()
    dispatch.clear_plan_cache()
    dispatch.load_autotune_table(str(STALE_TABLE))
    h100 = get_backend("h100")
    for name, (key, stale, pw, x) in cases.items():
        dispatch.clear_plan_cache()
        reset_launches()
        out = dispatch.dispatch_gemv(x, pw,
                                     policy=DispatchPolicy(backend="h100"))
        torch.cuda.synchronize()
        kernel, plan = h100.replay_plan(picks[name], stale, key,
                                        DispatchPolicy(backend="h100"))
        fn = f"{kernel}_gemv"
        if (kernel != picks[name] or launches()[fn] != 1
                or not plan_fits(plan, key.M, key.K, B, 2)):
            raise AssertionError(f"stale {name} entry replayed as {kernel} "
                                 f"{plan}, launches {launches()}")
        plain = (splitk_gemv_plain(x, pw.w_t, plan.split_k)
                 if kernel == "splitk" else pim_gemv_plain(x, pw.w_t))
        err = check_close(fn, f"stale {name}", out, plain)
        res["cases"].append(dict(case=name, kernel=kernel,
                                 stale=plan_dict(stale),
                                 replayed=plan_dict(plan),
                                 re_planned=plan != stale, max_abs_err=err))
    dispatch.clear_plan_cache()
    reset_launches()
    out = dispatch.dispatch_grouped(xs, stack,
                                    policy=DispatchPolicy(backend="h100"))
    torch.cuda.synchronize()
    modes = dispatch.dispatch_stats()["program_modes"]
    if modes != {"h100:grouped_cuda": 1} or launches()["grouped_gemv"] != 1:
        raise AssertionError(f"stale grouped entry: modes {modes}, "
                             f"launches {launches()}")
    gplan = h100.replay_program(
        ProgramPlan(mode="grouped_cuda", n_launches=1, kernel="grouped_gemv",
                    plan=old_tiles), pkey, DispatchPolicy()).plan
    if not grouped_plan_fits(gplan, M, K, MOE_C, 2):
        raise AssertionError(f"stale grouped entry replayed at {gplan}")
    err = check_close("grouped_gemv", "stale grouped program", out,
                      grouped_gemv_plain(xs, stack.w_t))
    res["cases"].append(dict(case="grouped_gate_up", kernel="grouped_gemv",
                             stale=plan_dict(old_tiles),
                             replayed=plan_dict(gplan), re_planned=True,
                             max_abs_err=err))
    dispatch.clear_plan_cache()
    reset_launches()
    out = dispatch.dispatch_ragged(xr, counts_r, stack,
                                   policy=DispatchPolicy(backend="h100"))
    torch.cuda.synchronize()
    modes = dispatch.dispatch_stats()["program_modes"]
    if modes != {"h100:ragged_cuda": 1} or launches()["ragged_gemv"] != 1:
        raise AssertionError(f"stale ragged entry: modes {modes}, "
                             f"launches {launches()}")
    rplan = h100.replay_program(
        ProgramPlan(mode="ragged_cuda", n_launches=1, kernel="ragged_gemv",
                    plan=old_tiles), rkey, DispatchPolicy()).plan
    if not ragged_plan_fits(rplan, M, K, T_r, 2):
        raise AssertionError(f"stale ragged entry replayed at {rplan}")
    err = check_close("ragged_gemv", "stale ragged program", out,
                      ragged_gemv_plain(xr, counts_to_offsets(counts_r),
                                        stack.w_t))
    res["cases"].append(dict(case="ragged_gate_up", kernel="ragged_gemv",
                             stale=plan_dict(old_tiles),
                             replayed=plan_dict(rplan), re_planned=True,
                             max_abs_err=err))
    key, _, pw, x = cases["head"]
    dispatch.clear_plan_cache()
    reset_launches()
    out = dispatch.dispatch_gemv(x, pw, policy=DispatchPolicy(backend="gpu"))
    torch.cuda.synchronize()
    if launches()["triton_gemv"] != 1:
        raise AssertionError(f"stale triton entry: launches {launches()}")
    err = check_close("triton_gemv", "stale head", out,
                      triton_gemv_plain(x, pw.w_t, one_stage.k_blk))
    res["cases"].append(dict(case="gpu_head", kernel="triton",
                             stale=plan_dict(one_stage),
                             replayed=plan_dict(one_stage),
                             re_planned=False, max_abs_err=err))
    for c in res["cases"]:
        log(f"  stale {c['case']:15s} -> {c['kernel']:13s} m_blk "
            f"{c['replayed']['m_blk']} k_blk {c['replayed']['k_blk']} "
            f"stages {c['replayed']['stages']}"
            f"{' (re-planned)' if c['re_planned'] else ''}; err "
            f"{c['max_abs_err']:.2e}")
    dispatch.clear_autotune_table()
    dispatch.clear_plan_cache()
    del cases, stack, xs, xr
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the PIM model and calibration
# ---------------------------------------------------------------------------


def run_pim(dev) -> dict:
    """The paper's model (LPDDR5X-PIM, not this card): the roofline boost,
    the PIMnast speedup of opt-6.7b's FC1 and every OPT model's per-token
    speedup; then olmo-1b's full-width gate+up weight, seeded, in bf16,
    placed by PIMnast and materialized on the card: bit-equal to the same
    call on a CPU copy, the untiled stream bit-equal to the weight, and
    the tiles and matrix rows each bank holds."""
    t0 = time.perf_counter()
    cfg = RYZEN_LPDDR5X
    fc1 = GEMV(16384, 4096, PIM_INT8, PIM_BF16, name="opt-6.7b/fc1")
    s, placement, bd = pim_speedup(fc1, cfg)
    tokens = {name: e2e_latency(m, cfg).token_speedup
              for name, m in OPT_SUITE.items()}
    res = {"roofline_boost": cfg.roofline_pim_boost,
           "fc1": {"placement": placement.describe(), "speedup": s,
                   "pim_us": bd.total / 1e3},
           "token_speedup": tokens}
    log(f"  model roofline {cfg.roofline_pim_boost:.4f}x; "
        f"{placement.describe()}: {s:.4f}x ({bd.total / 1e3:.2f} us); "
        f"per-token speedup "
        + ", ".join(f"{n} {v:.4f}x" for n, v in tokens.items()))

    ocfg = get_config("olmo-1b")
    M, K = 2 * ocfg.d_ff, ocfg.d_model
    g = GEMV(M, K, PIM_BF16, PIM_BF16, name="olmo-1b/gate_up")
    p = plan_placement(g, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    w = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    stream = materialize(w, p)
    torch.cuda.synchronize()
    host = materialize(w.cpu(), p)
    if not torch.equal(stream.cpu().view(torch.int16),
                       host.view(torch.int16)):
        raise AssertionError("materialize on the card differs from the "
                             "CPU's")
    order = (cr_order_with_degree(p.m_TM, p.k_TM, p.banks_used,
                                  p.cr_degree) if p.cr_degree > 1
             else cr_order(p.m_TM, p.k_TM, p.banks_used)).to(dev)
    tiles = torch.empty_like(stream)
    tiles[order] = stream
    back = untile_matrix_roworder(tiles, M, K, p.tile.m_tile, p.tile.k_tile)
    if not torch.equal(back.view(torch.int16), w.view(torch.int16)):
        raise AssertionError("the untiled stream differs from the weight")
    pos = torch.arange(order.numel(), device=dev)
    bank = pos % p.banks_used
    tiles_per_bank = torch.bincount(bank, minlength=p.banks_used)
    rowblock = order // p.k_TM
    rb_bank = torch.full((p.m_TM,), -1, dtype=torch.int64, device=dev)
    rb_bank[rowblock] = bank
    if not torch.equal(rb_bank[rowblock], bank):
        raise AssertionError("a row-block spans two banks")
    rows_per_bank = torch.bincount(rb_bank,
                                   minlength=p.banks_used) * p.tile.m_tile
    torch.cuda.synchronize()
    res["materialize"] = {
        "gemv": f"{M}x{K} bf16", "placement": p.describe(),
        "tiles": order.numel(), "banks": p.banks_used,
        "tiles_per_bank": [int(tiles_per_bank.min()),
                           int(tiles_per_bank.max())],
        "rows_per_bank": [int(rows_per_bank.min()),
                          int(rows_per_bank.max())],
        "bit_equal_to_cpu": True, "untile_bit_equal": True}
    m = res["materialize"]
    log(f"  olmo-1b gate+up {M}x{K} bf16 on the card: {p.describe()}; "
        f"{m['tiles']} tiles over {m['banks']} banks, tiles per bank "
        f"{m['tiles_per_bank'][0]}-{m['tiles_per_bank'][1]}, matrix rows "
        f"per bank {m['rows_per_bank'][0]}-{m['rows_per_bank'][1]}, every "
        f"row in one bank; bit-equal to the CPU's stream, untile recovers "
        f"the weight bit for bit")
    del w, stream, host, tiles, back
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


CALIBRATION_DIR = ROOT / "build" / "calibration"
# the kernels the reference's sweep reaches (every one but quant4_gemv)
CALIBRATED_KERNELS = ("pim_gemv", "splitk_gemv", "quant_gemv",
                      "grouped_gemv", "ragged_gemv", "triton_gemv")


def decode_picks(be, fitted, dev) -> list[dict]:
    """olmo-1b's decode GEMVs at batch 8: the seed's pick and the fitted
    model's, each timed on the card (best of 5 replays over weight copies
    read cold) and priced by both models."""
    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    for name, (K, M, _) in SHAPES.items():
        B = 8
        seed_pick = be.select_kernel(M, K, B, x_bytes=2)
        with _swapped_cost_model(be, fitted):
            fit_pick = be.select_kernel(M, K, B, x_bytes=2)
        x = torch.randn((B, K), generator=gen, device=dev).to(torch.bfloat16)
        pws = weight_copies(PackedWeights(w_t=(torch.randn(
            (K, M), generator=gen, device=dev) / math.sqrt(K)).to(
                torch.bfloat16)), dev)
        row = {"shape": name, "K": K, "M": M, "B": B,
               "moved": fit_pick != seed_pick}
        for tag, (kernel, plan) in (("seed", seed_pick), ("fitted",
                                                          fit_pick)):
            us = time_gemv_us(lambda i, k=kernel, p=plan:
                              be.execute(k, x, pws[i], p), 5,
                              copies=len(pws), device=dev)
            with _swapped_cost_model(be, fitted):
                fit_us = be.estimate_cost_us(kernel, M, K, B, x_bytes=2,
                                             plan=plan)
            row[tag] = {"kernel": be.candidate_label(kernel, plan),
                        "us": us, "seed_model_us": be.estimate_cost_us(
                            kernel, M, K, B, x_bytes=2, plan=plan),
                        "fitted_model_us": fit_us}
        rows.append(row)
        del pws
    torch.cuda.empty_cache()
    return rows


def run_calibrate(dev) -> dict:
    """The full calibration sweep on the h100 and gpu backends, every
    record a replayed graph timed with CUDA events in bf16, then
    ``fit_cost_model`` and the artifacts under ``build/calibration/``.
    Fails unless the fitted MAPE is at most the seed's on each backend and
    the sweep launched each of the six kernels the reference's sweep
    reaches.  Prints the seed and fitted MAPE per kernel and program mode,
    the fitted constants, and olmo-1b's decode picks at batch 8 under both
    models beside their device times; then puts both backends back on
    their seeds."""
    t0 = time.perf_counter()
    res = {"dir": str(CALIBRATION_DIR.relative_to(ROOT)), "backends": {}}
    dispatch.clear_autotune_table()
    dispatch.clear_plan_cache()
    reset_launches()
    sweeps = {}
    for name in ("h100", "gpu"):
        t1 = time.perf_counter()
        sweeps[name] = (run_sweep(name, device=dev),
                        time.perf_counter() - t1)
    res["launches"] = {k: v for k, v in launches().items()
                       if k in CALIBRATED_KERNELS}
    missing = [k for k in CALIBRATED_KERNELS if res["launches"][k] == 0]
    if missing:
        raise AssertionError(f"the sweeps never launched {missing}")
    ran = {(n, r.kernel) for n, (recs, _) in sweeps.items() for r in recs}
    want = {("h100", k) for k in ("pim", "splitk", "quant", "grouped_cuda",
                                  "ragged_cuda", "fused")} | {
        ("gpu", k) for k in ("triton", "grouped_triton", "ragged_triton",
                             "fused")}
    if not want <= ran:
        raise AssertionError(f"the sweeps' records lack {sorted(want - ran)}")
    for name, (records, sweep_s) in sweeps.items():
        be = get_backend(name)
        fit = fit_cost_model(name, records)
        write_artifact(str(CALIBRATION_DIR / f"{name}.json"), fit, records)
        if not fit.mape <= fit.seed_mape:
            raise AssertionError(f"{name}: fitted MAPE {fit.mape} above the "
                                 f"seed's {fit.seed_mape}")
        seed = be.seed_cost_model
        per = {k: {"seed": mape(be, seed, [r for r in records
                                           if r.kernel == k]),
                   "fitted": v, "records": sum(r.kernel == k
                                               for r in records)}
               for k, v in fit.per_kernel_mape.items()}
        picks = decode_picks(be, fit.cost_model(), dev)
        dtypes = sorted({r.dtype for r in records})
        res["backends"][name] = {
            "records": len(records), "sweep_s": sweep_s, "dtypes": dtypes,
            "mape": fit.mape, "seed_mape": fit.seed_mape,
            "per_kernel_mape": per, "fitted": fit.fitted,
            "constants": fit.constants, "seed": seed.constants(),
            "degenerate": fit.degenerate, "decode_picks": picks,
            "records_json": [r.to_json() for r in records]}
        log(f"  {name}: {len(records)} records ({', '.join(dtypes)}) in "
            f"{sweep_s:.1f} s; MAPE seed {fit.seed_mape:.4f} -> fitted "
            f"{fit.mape:.4f}")
        for k, v in per.items():
            log(f"    {k:15s} x{v['records']:2d}: MAPE seed {v['seed']:.4f} "
                f"-> fitted {v['fitted']:.4f}")
        log("    fitted constants: " + ", ".join(
            f"{t} {seed.constants()[t]:.6g} -> {fit.constants[t]:.6g}"
            for t in fit.fitted))
        for r in picks:
            log(f"    olmo-1b {r['shape']:8s} B=8: seed pick "
                f"{r['seed']['kernel']:9s} {r['seed']['us']:8.2f} us, fitted "
                f"pick {r['fitted']['kernel']:9s} {r['fitted']['us']:8.2f} "
                f"us{' (moved)' if r['moved'] else ''}; modeled seed / "
                f"fitted {r['seed']['seed_model_us']:.2f} / "
                f"{r['seed']['fitted_model_us']:.2f} us")
    log(f"  launches in the sweeps: {json.dumps(res['launches'])}")
    for name in ("h100", "gpu"):
        get_backend(name).reset_calibration()
    dispatch.clear_autotune_table()
    dispatch.clear_plan_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------


def kernels_line(rows: list[dict], launch_counts: dict,
                 per_step: dict, instances=()) -> dict:
    """One entry per kernel.  Its top-level times are one decode step: for
    the olmo-1b kernels at batch 8, the sum over the GEMVs at that batch
    (each shape weighted by its calls per step) that the h100 backend --
    as the TPU backend -- sends to the kernel (for the float kernels the
    bf16 engine's picks, for the quant kernels every GEMV of the quantized
    pass; for ``triton_gemv`` the gpu backend's pick, the head); for
    ``ragged_gemv`` one deepseek-moe-16b step at batch 8 (the
    top-6 routing of 8 tokens), for ``grouped_gemv`` one at batch 1 (C=8),
    for ``decode_attention`` one olmo-1b step at batch 8 (16 layers, on
    the lengths of a mid-run step).  ``launches`` is the count from the
    run of the kernel's own path: with replayed graphs, the wrappers count
    at each bucket's eager first step and at its capture, never at a
    replay; ``launches_per_step`` is the eager pass's count a decode step
    (the quant kernels: their one dispatcher pass), and every replayed
    step runs the eager step's port kernels (``compare_replay``).  Each of
    ``instances`` adds an entry for a later model's template instance
    (``instance_entry``)."""
    picks = {"pim_gemv": ("gate_up", "head"), "splitk_gemv": ("qkv", "down"),
             "quant_gemv": tuple(SHAPES), "quant4_gemv": tuple(SHAPES),
             "triton_gemv": ("head",)}

    def in_step(name, r):
        if name == "ragged_gemv":
            return r["routing"] == "top6_b8"
        if name == "decode_attention":
            return r["store"] == "fp" and r["shape"] == "engine"
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
        if name == "decode_attention":
            basis = ("one olmo-1b decode step at batch 8: 16 layers "
                     "(deepseek-moe-16b: the same call in 28 layers)")
            keys = ("shape", "store", "B", "C", "Hkv", "D", "valid",
                    "splits", "ms", "plain_ms", "library_ms", "bound_ms",
                    "max_abs_err")
        elif moe:
            basis = (f"one {MOE_ARCH} decode step at batch "
                     f"{8 if name == 'ragged_gemv' else 1}: "
                     + ", ".join(f"{s} x{n}" for s, (_, _, n)
                                 in MOE_SHAPES.items()))
            keys = ("shape", "routing", "T", "K", "M", "experts_with_rows",
                    "ms", "plain_ms", "library_ms", "bound_ms",
                    "max_abs_err") + (("bmm_ref_ms", "plan")
                                      if name == "ragged_gemv" else ())
        else:
            basis = ("one olmo-1b decode step at batch 8: "
                     + ", ".join(f"{s} x{SHAPES[s][2]}"
                                 for s in picks[name]))
            keys = ("shape", "K", "M", "B", "ms", "plain_ms", "library_ms",
                    "bound_ms", "max_abs_err") + (
                        ("bf16_matmul_ms", "plan") if quant else ()) + (
                        ("pim_ms", "plan") if name == "triton_gemv" else ())
        entry = {
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": launch_counts[name],
            "launches_per_step": per_step[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # no single PyTorch call computes a block-scaled int8/int4 GEMV
            # or a ragged expert GEMV; decode_attention's is
            # scaled_dot_product_attention on the same inputs
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
    for inst in instances:
        out.append(instance_entry(rows, **inst))
    return {"kernels": out}


def instance_entry(rows: list[dict], name: str, kernel: str, arch: str,
                   launches: int, launches_per_step: float) -> dict:
    """An entry of the kernels line for one template instance of
    ``kernel`` that a later model added (``decode_attention`` at hymba's G
    5): its times are one decode step of ``arch`` at batch 8, each of the
    arch's timed shapes (a window's layers) weighted by its layers a step;
    ``launches`` is the count from that arch's engine phase (graph
    route), ``launches_per_step`` its eager step's."""
    k = KERNELS[kernel]
    mine = [r for r in rows if r["kernel"] == kernel
            and r.get("arch") == arch and r.get("store", "fp") == "fp"]
    if not mine:
        raise AssertionError(f"no timed rows of {kernel} for {arch}")

    def total(key):
        return sum(r[key] * r["per_step"] for r in mine)

    bytes_ms, ops_ms = total("bytes_ms"), total("ops_ms")
    return {
        "name": name, "route": "cuda", "source": k["source"],
        "replaces": k["replaces"], "launches": launches,
        "launches_per_step": launches_per_step,
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": total("library_ms"),
        "basis": (f"one {arch} decode step at batch 8: "
                  + ", ".join(f"{r['shape']} x{r['per_step']}"
                              for r in mine)),
        "shapes": [{key: r[key] for key in (
            "shape", "B", "C", "Hkv", "H", "G", "D", "window", "valid",
            "splits", "per_step", "ms", "plain_ms", "library_ms",
            "bound_ms", "max_abs_err")} for r in mine],
    }


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
    spills = [f"{src}: {ln.strip()}" for src, r in report.items()
              for ln in r["ptxas"].splitlines()
              if re.search(r"[1-9]\d* bytes spill", ln)]
    if spills:
        raise AssertionError("register spills:\n" + "\n".join(spills))
    ptxas = ptxas_table(report)
    for r in ptxas:
        log(f"  {r['source']}: {r.get('demangled', r['function'])}: "
            f"{r['line']}")

    log("[kernels] each against its plain version (rtol 2^-7, atol 1e-3), "
        "then timed")
    rows = check_kernels(dev)
    log(f"[stages] pim_gemv and splitk_gemv at B=8, every ring depth up to "
        f"{MAX_STAGES} the card holds: bit-identical to the default, timed")
    stages = stage_sweep(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log("[quant kernels] quant_gemv and quant4_gemv against their plain "
        "versions (rtol 2^-7, atol 1e-3), then timed beside torch.matmul "
        "on the bf16 weight")
    rows += check_quant_kernels(dev, sms)
    log(f"[quant stages] quant_gemv and quant4_gemv at B=8, every ring "
        f"depth up to {MAX_STAGES} the card holds: bit-identical to the "
        f"default, timed")
    stages += quant_stage_sweep(dev, sms)
    log("[quant plans] both at B=8 at every split degree and column block, "
        "each against its plain version, timed")
    quant_plans = quant_plan_sweep(dev, sms)
    log("[gpu kernels] triton_gemv against its plain version (rtol 2^-7, "
        "atol 1e-3), then timed beside pim_gemv and torch.matmul")
    rows += check_triton_kernels(dev)
    log("[gpu stages] triton_gemv at B=8 on both heads, every ring depth "
        "the card holds: bit-identical to the default, timed")
    stages += triton_stage_sweep(dev)
    log("[attention] decode_attention against its plain version (rtol "
        "2^-7, atol 2^-8 max|v|), then timed beside "
        "scaled_dot_product_attention")
    rows += check_attention(dev, layers=get_config("olmo-1b").n_layers)

    warm_profiler()
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
    log_routes("engine", engine)
    log_ttft(engine)

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
        log_routes(f"kv {store}", e)
        log_ttft(e)

    gpu = run_engine(cfg, params, dev, backend="gpu")
    gpu["agreement_with_h100"] = token_agreement(engine["generated"],
                                                 gpu["generated"])
    pt, ttft = gpu["per_token_ms"], gpu["ttft_ms"]
    log(f"[gpu engine] Engine(gemv_backend='gpu'): requests "
        f"{gpu['requests']}, tokens {gpu['tokens']}, per-token p50 "
        f"{pt['p50']:.2f} ms p90 {pt['p90']:.2f} ms, TTFT p50 "
        f"{ttft['p50']:.1f} ms, peak {gpu['peak_mem_gb']:.2f} GB")
    log(f"  kernel_picks {json.dumps(gpu['dispatch']['kernel_picks'])}; "
        f"program_kernels "
        f"{json.dumps(gpu['dispatch']['program_kernels'])}; triton_gemv "
        f"launches {gpu['launches']['triton_gemv']} in "
        f"{gpu['decode_steps']} decode steps, as the picks predict "
        f"{json.dumps(gpu['triton_picks_by_batch'])}; greedy tokens "
        f"agreeing with the h100 engine {gpu['agreement_with_h100']}")
    log_routes("gpu engine", gpu)

    serving = {}
    for tag in ("olmo-1b fp", "olmo-1b int8"):
        log(f"[serving] {tag}: chunked prefill ({SERVE_CHUNK}), the prefix "
            f"cache and preemption, both routes, then the plain engine")
        serving[tag] = run_serving(cfg, params, dev, tag)
        log_serving(serving[tag])

    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("[moe kernels] ragged_gemv and grouped_gemv at deepseek-moe-16b's "
        "expert shapes, each against its plain version (rtol 2^-7, atol "
        "1e-3), then timed")
    moe_rows, moe_stages = check_moe_kernels(dev)
    rows += moe_rows
    stages += moe_stages

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
    log_routes("moe engine", moe)
    log_ttft(moe)

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
    log_routes("moe grouped", grouped)

    moe_gpu = run_engine(mcfg, mparams, dev, backend="gpu",
                         new_tokens=MOE_GPU_TOKENS)
    moe_gpu["agreement_with_h100"] = token_agreement(
        moe_gpu["generated"],
        {rid: t[:MOE_GPU_TOKENS] for rid, t in moe["generated"].items()})
    log(f"[moe gpu] Engine(gemv_backend='gpu'), 8 slots x "
        f"{MOE_GPU_TOKENS} tokens: per-token p50 "
        f"{moe_gpu['per_token_ms']['p50']:.2f} ms; launches per decode "
        f"step {moe_gpu['launches_per_step']}; program_modes "
        f"{json.dumps(moe_gpu['dispatch']['program_modes'])}; "
        f"kernel_picks {json.dumps(moe_gpu['dispatch']['kernel_picks'])}; "
        f"triton_gemv as predicted "
        f"{json.dumps(moe_gpu['triton_picks_by_batch'])}; greedy tokens "
        f"agreeing with the h100 engine {moe_gpu['agreement_with_h100']}")
    log_routes("moe gpu", moe_gpu)
    tag = "deepseek-moe-16b ragged"
    log(f"[serving] {tag}: chunked prefill ({SERVE_CHUNK}), the prefix "
        f"cache and preemption, both routes, then the plain engine")
    serving[tag] = run_serving(mcfg, mparams, dev, tag)
    log_serving(serving[tag])
    del mparams
    gc.collect()
    torch.cuda.empty_cache()

    t_fam = time.perf_counter()
    log(f"[families kernels] pim_gemv and splitk_gemv at every decode GEMV "
        f"shape of {', '.join(FAMILIES)} at B {FAMILY_BATCHES} (rtol 2^-7, "
        f"atol 1e-3), timed; decode_attention at each family's shape with "
        f"windows {FAMILY_WINDOWS}")
    for arch in FAMILIES:
        fcfg = family_config(arch)
        rows += check_kernels(dev, family_gemv_shapes(fcfg), FAMILY_BATCHES,
                              arch)
        rows += check_family_attention(dev, fcfg)
    families = run_families(dev)
    families_s = time.perf_counter() - t_fam
    log(f"[families] {families_s:.1f} s")

    t_mm = time.perf_counter()
    log(f"[multimodal kernels] decode_attention at whisper-small's self and "
        f"cross shapes and llama-3.2-vision-11b's cross shape; pim_gemv and "
        f"splitk_gemv at every decode GEMV shape of llama-3.2-vision-11b at "
        f"B {FAMILY_BATCHES} (rtol 2^-7, atol 1e-3), timed")
    rows += check_mm_attention(dev)
    vcfg = get_config("llama-3.2-vision-11b")
    rows += check_kernels(dev, family_gemv_shapes(vcfg), FAMILY_BATCHES,
                          vcfg.name)
    multimodal = run_multimodal(dev)
    multimodal_s = time.perf_counter() - t_mm
    log(f"[multimodal] {multimodal_s:.1f} s")

    state = run_state(dev)
    rows += state.pop("kernel_rows")
    log(f"[state] {state['seconds']:.1f} s on {state['card']}")

    hybrid = run_hybrid(dev)
    rows += hybrid.pop("kernel_rows")
    log(f"[hybrid] {hybrid['seconds']:.1f} s on {hybrid['card']}")

    log(f"[autotune] olmo-1b's decode GEMVs at batch 8, a fused QKV and a "
        f"ragged expert program, on h100 and gpu, into {AUTOTUNE_TABLE}")
    autotune = run_autotune(dev)
    log(f"[autotune] a table written before the streaming kernels, "
        f"replayed from {STALE_TABLE}")
    autotune["stale_replay"] = replay_stale_table(dev)

    log("[pim] the paper's LPDDR5X-PIM model (modeled, not this card), then "
        "PIMnast's placement of olmo-1b's gate+up materialized on the card")
    pim = run_pim(dev)
    log(f"[pim] {pim['seconds']:.1f} s")
    log(f"[calibrate] the full sweep on h100 and gpu (replayed graphs, bf16), "
        f"fit, artifacts under {CALIBRATION_DIR}")
    calibrate = run_calibrate(dev)
    log(f"[calibrate] {calibrate['seconds']:.1f} s on {card}")

    launch_counts = {**{n: engine["launches"][n] for n in FLOAT_KERNELS},
                     "quant_gemv":
                         quant["passes"]["w8"]["launches"]["quant_gemv"],
                     "quant4_gemv":
                         quant["passes"]["w4"]["launches"]["quant4_gemv"],
                     "ragged_gemv": moe["launches"]["ragged_gemv"],
                     "grouped_gemv": grouped["launches"]["grouped_gemv"],
                     "triton_gemv": gpu["launches"]["triton_gemv"],
                     "decode_attention":
                         engine["launches"]["decode_attention"]}

    def eager_step(res, n):
        return res["routes"]["eager"]["launches_per_step"][n]

    per_step = {**{n: eager_step(engine, n) for n in FLOAT_KERNELS},
                "quant_gemv": launch_counts["quant_gemv"],
                "quant4_gemv": launch_counts["quant4_gemv"],
                "ragged_gemv": eager_step(moe, "ragged_gemv"),
                "grouped_gemv": eager_step(grouped, "grouped_gemv"),
                "triton_gemv": eager_step(gpu, "triton_gemv"),
                "decode_attention": eager_step(engine, "decode_attention")}
    g5 = dict(name="decode_attention_g5", kernel="decode_attention",
              arch=HYBRID_ARCH,
              launches=hybrid["launches"]["decode_attention"],
              launches_per_step=eager_step(hybrid, "decode_attention"))
    line = kernels_line(rows, launch_counts, per_step, [g5])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        device=dict(name=name, count=count, nvidia_smi=card),
        build_s=build_s, ptxas=ptxas, kernel_rows=rows, stage_sweep=stages,
        quant_plan_sweep=quant_plans,
        engine=engine, logits=logits,
        quant_dispatch=quant, kv=kv, moe_engine=moe, moe_logits=moe_logits,
        moe_grouped=grouped, gpu_engine=gpu, moe_gpu=moe_gpu,
        serving=serving, families=families, families_s=families_s,
        multimodal=multimodal, multimodal_s=multimodal_s, state=state,
        hybrid=hybrid,
        autotune=autotune, pim=pim, calibrate=calibrate,
        kernels=line["kernels"],
        total_s=time.perf_counter() - t_start), indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
