"""Slot-managed continuous-batching engine (counterpart of
``repro/serving/engine.py::Engine`` for the slice the port runs).

``Engine`` composes :class:`~repro_torch.serving.kv_cache.SlotKVCache`
(per-slot positions, alloc/free/defrag, batched prefill splicing), a
:class:`~repro_torch.serving.scheduler.Scheduler` (fcfs / sjf /
gemv_aware admission, backpressure, deadline expiry),
:class:`~repro_torch.serving.metrics.ServingMetrics` and the numpy
sampler.  Each :meth:`Engine.step` expires, admits, prefills the admission
wave in ONE right-padded batched forward, and decodes one token for every
active slot over the smallest power-of-two bucket that covers them.

Decode is where the GEMV kernels run: with the bucket at or under
``gemv_batch_threshold`` the model's projections go through the
dispatcher -- QKV and gate+up as fused programs over weights prepacked at
construction, down and the LM head as single requests.

``kv_store="int8"`` / ``"int4"`` keeps the KV cache as quantized pages
(``repro_torch.kernels.kv_quant``), prefill and decode alike.

On an MoE model the experts of a decode step run as ragged programs
(``gemv_expert_shape="ragged"``, the default) or grouped ones
(``"grouped"``); ``"einsum"`` keeps them out of the dispatcher.  The
scheduler's ``gemv_aware`` admission is expert-aware there and reads the
dispatcher's ``expert_load`` deltas before each admission.

On the card each decode step is one CUDA graph per bucket
(:mod:`repro_torch.serving.step_graph`, the counterpart of the JAX
engine's jitted ``_decode_fn``): the first step at a bucket runs eagerly
and is then captured, every later one replays.  Inside
:func:`~repro_torch.serving.step_graph.disable_graphs`, and always on the
CPU, the step runs eagerly op by op.  Prefill stays eager.

Not ported yet: prefill as captured programs, chunked and async prefill,
the prefix cache, preemption, sharded (mesh) serving and the tracer.
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.backends import DispatchPolicy
from repro_torch.kernels.kv_quant import validate_kv_store
from repro_torch.models import lm
from repro_torch.serving.kv_cache import SlotKVCache
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.sampling import (
    SamplingParams,
    request_rng,
    sample_token,
)
from repro_torch.serving.scheduler import QueueFull, Scheduler, \
    SchedulerConfig
from repro_torch.serving.step_graph import CudaCapture, DecodeGraphs, \
    graphs_enabled

__all__ = ["Engine", "Request", "QueueFull", "SamplingParams", "Scheduler",
           "SchedulerConfig", "ServingMetrics"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int = 16
    eos_id: int = -1                # -1: never (shim; prefer eos_ids)
    eos_ids: set[int] | None = None  # stop set; overrides eos_id when set
    sampling: SamplingParams | None = None   # None: greedy
    deadline: float | None = None   # absolute engine-clock time
    generated: list[int] = field(default_factory=list)
    done: bool = False
    expired: bool = False
    slot: int = -1
    submit_time: float = 0.0
    arrival_seq: int = 0
    first_token_time: float | None = None
    finish_time: float | None = None

    def stop_set(self) -> frozenset[int]:
        if self.eos_ids is not None:
            return frozenset(self.eos_ids)
        return frozenset((self.eos_id,)) if self.eos_id >= 0 else frozenset()


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class Engine:
    """Continuous batching over a slot-managed KV cache.

    Runs on the CUDA card unless ``device`` says otherwise; with no device
    on a host without CUDA, construction raises.  ``params`` must already
    live on that device (``lm.init_lm(cfg, device=...)``).
    """

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 batch_slots: int = 4, max_len: int = 128,
                 use_pim_kernels: bool = True,
                 gemv_batch_threshold: int = 8,
                 gemv_backend: str | None = None,
                 gemv_fuse_programs: bool = True,
                 gemv_expert_shape: str = "ragged",
                 scheduler: Scheduler | SchedulerConfig | str = "fcfs",
                 max_queue: int = 0,
                 metrics: ServingMetrics | None = None,
                 kv_store: str = "fp",
                 device=None,
                 clock=time.monotonic):
        self.kv_store = validate_kv_store(kv_store)
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.slots = batch_slots
        self.max_len = max_len
        self.clock = clock
        # One DispatchPolicy for the engine's lifetime; above the batch
        # threshold the backend itself sends decode GEMVs to ref.
        self.gemv_policy = (
            DispatchPolicy(batch_threshold=gemv_batch_threshold,
                           backend=gemv_backend,
                           fuse_programs=gemv_fuse_programs,
                           expert_shape=gemv_expert_shape)
            if use_pim_kernels else None)
        # one-time prepack: fused weights and the contiguous head the
        # kernels read (no per-step concat or transpose)
        self.params = (lm.prepack_decode_params(params, cfg)
                       if self.gemv_policy is not None else params)
        if isinstance(scheduler, Scheduler):
            self.scheduler = scheduler
        elif isinstance(scheduler, SchedulerConfig):
            self.scheduler = Scheduler(scheduler)
        else:
            # an MoE model makes gemv_aware expert-aware: the scheduler's
            # per-expert gate shares expert_batch_bound with the ragged
            # dispatch, so admitted batches price as they are dispatched
            self.scheduler = Scheduler(SchedulerConfig(
                policy=scheduler, max_queue=max_queue,
                gemv_batch_threshold=gemv_batch_threshold,
                moe_experts=cfg.moe.n_experts if cfg.moe else 0,
                moe_top_k=cfg.moe.top_k if cfg.moe else 1))
        self.metrics = metrics or ServingMetrics(clock=clock)
        self.kv = SlotKVCache(cfg, batch_slots, max_len,
                              kv_store=self.kv_store, device=self.device)
        self.active: dict[int, Request] = {}   # slot -> request
        self.expired: list[Request] = []
        # host copy: one small transfer per decode step instead of one
        # device write per sampled token
        self.last_tok = np.zeros((batch_slots, 1), np.int64)
        self._rngs: dict[int, np.random.Generator] = {}
        # the decode step's captured graphs, one per bucket (on the card);
        # they reach the body through a weak reference, so a dropped engine
        # frees its graphs and cache at once, not at a later collection
        body = weakref.WeakMethod(self._decode_body)
        self.graphs = (
            DecodeGraphs(lambda b, tok: body()(b, tok), self.kv.cache,
                         slots=batch_slots, vocab=cfg.vocab,
                         device=self.device,
                         capture=CudaCapture(self.device))
            if self.device.type == "cuda" else None)

    # -- request lifecycle ---------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue a request; raises ``ValueError`` for a prompt longer than
        ``max_len`` (it could never be admitted) and :class:`QueueFull`
        under backpressure."""
        if len(req.prompt) > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} "
                f"exceeds engine max_len={self.max_len}")
        try:
            self.scheduler.submit(req, self.clock())
        except QueueFull:
            self.metrics.request_rejected()
            raise
        self.metrics.request_submitted()

    def step(self) -> list[Request]:
        """One engine iteration: expire + admit + prefill + one decode step.
        Returns the requests completed this step."""
        t0 = self.clock()
        expired = self.scheduler.expire(t0)
        for r in expired:
            r.expired = True
        self.expired.extend(expired)
        if expired:
            self.metrics.requests_expired(len(expired))
        if self.scheduler.config.moe_experts > 1:
            # refresh the router-skew estimate before deciding how many
            # slots to fill
            self.scheduler.observe_expert_load(
                self.metrics.dispatch_delta().get("expert_load", {}))
        admitted = self.scheduler.select(self.kv.n_free, self.kv.n_active,
                                         t0)
        finished: list[Request] = []
        if admitted:
            finished.extend(self._prefill_wave(admitted))
        # an instant finish at prefill can punch a hole in the active
        # prefix; decode needs it contiguous
        self._compact()
        decode_batch, decode_s = 0, 0.0
        if self.active:
            done, decode_batch, decode_s = self._decode()
            finished.extend(done)
        self._compact()
        t1 = self.clock()
        self.metrics.record_step(
            t1, step_s=t1 - t0, decode_s=decode_s,
            decode_batch=decode_batch, n_active=self.kv.n_active,
            queue_depth=len(self.scheduler))
        return finished

    def run_until_drained(self, max_iters: int = 1000) -> list[Request]:
        done: list[Request] = []
        for _ in range(max_iters):
            done.extend(self.step())
            if not self.active and not self.scheduler.queue:
                break
        return done

    # -- internals -----------------------------------------------------------

    def _prefill_wave(self, wave: list[Request]) -> list[Request]:
        """The whole admission wave in ONE right-padded batched forward;
        per-slot last-valid-token logits are gathered by length."""
        slots = [self.kv.alloc() for _ in wave]
        toks = [np.asarray(r.prompt, np.int64) for r in wave]
        lengths = [len(t) for t in toks]
        Lmax = max(lengths)
        # the pow2 pad never runs past max_len: the KV write starts at 0 and
        # a longer pad would have to clamp (the JAX engine caps it the same
        # way, engine.py:700)
        Lpad = max(min(_next_pow2(Lmax), self.max_len), Lmax)
        nb = min(_next_pow2(len(wave)), self.slots)
        tokens = np.zeros((nb, Lpad), np.int64)
        lens = np.ones((nb,), np.int64)
        for i, t in enumerate(toks):
            tokens[i, :lengths[i]] = t
            lens[i] = lengths[i]
        sub = lm.init_cache(self.cfg, nb, self.max_len, per_slot_pos=True,
                            kv_store=self.kv_store, device=self.device)
        logits, sub, _ = lm.forward(
            self.params, self.cfg,
            torch.from_numpy(tokens).to(self.device), cache=sub)
        idx = torch.from_numpy(lens - 1).to(self.device)
        last = logits[torch.arange(nb, device=self.device), idx]
        self.kv.splice(sub, slots, lengths)
        last_np = last.float().cpu().numpy()
        now = self.clock()
        finished = []
        for i, (r, slot) in enumerate(zip(wave, slots)):
            tok = self._sample(r, last_np[i])
            if self._activate(r, slot, tok, now):
                finished.append(r)
        self.metrics.prefill_wave(len(wave), sum(lengths))
        return finished

    def _activate(self, r: Request, slot: int, tok: int,
                  now: float) -> bool:
        """Record the first sampled token and move the request into the
        decode set; returns True on an instant finish."""
        r.generated.append(tok)
        r.slot = slot
        self.active[slot] = r
        self.last_tok[slot, 0] = tok
        self.metrics.first_token(r, now)
        self.metrics.tokens_generated(1)
        if self._should_finish(r, tok):
            self._finish(r, slot, now)
            return True
        return False

    def decode_bucket(self) -> int:
        """The batch one decode step runs: the smallest power of two that
        covers the active slots, clamped to the GEMV threshold when the
        actives themselves fit under it (a non-pow2 threshold would
        otherwise push every such step off the GEMV kernels)."""
        n = self.kv.n_active  # compact() keeps alloc'd slots a prefix
        b = min(_next_pow2(n), self.slots)
        if self.gemv_policy is not None:
            thresh = self.gemv_policy.batch_threshold
            if n <= thresh < b:
                b = thresh
        return b

    def _decode_body(self, b: int, tok: torch.Tensor) -> torch.Tensor:
        """The decode step of the first ``b`` slots on tokens ``tok [b,
        1]``: the forward (new K/V written into the cache in place), the
        advanced ``pos`` written back; returns the last-token logits."""
        logits, new_cache, _ = lm.forward(self.params, self.cfg, tok,
                                          cache=self.kv.slice_prefix(b),
                                          gemv_policy=self.gemv_policy)
        self.kv.merge_prefix(new_cache, b)
        return logits[:, -1]

    def _decode(self) -> tuple[list[Request], int, float]:
        t0 = self.clock()
        b = self.decode_bucket()
        if self.graphs is not None and graphs_enabled():
            logits_np = self.graphs.step(b, self.last_tok)
        else:
            last = torch.from_numpy(self.last_tok[:b]).to(self.device)
            logits_np = self._decode_body(b, last).float().cpu().numpy()
        decode_s = self.clock() - t0
        now = self.clock()
        finished = []
        for slot, r in list(self.active.items()):
            tok = self._sample(r, logits_np[slot])
            r.generated.append(tok)
            self.last_tok[slot, 0] = tok
            self.metrics.tokens_generated(1, decode=True)
            if self._should_finish(r, tok):
                self._finish(r, slot, now)
                finished.append(r)
        return finished, b, decode_s

    def _sample(self, r: Request, logits_row: np.ndarray) -> int:
        if r.sampling is None or r.sampling.temperature <= 0:
            return sample_token(logits_row, r.sampling)
        rng = self._rngs.get(r.rid)
        if rng is None:
            rng = self._rngs[r.rid] = request_rng(r.sampling, r.rid)
        return sample_token(logits_row, r.sampling, rng)

    def _should_finish(self, r: Request, tok: int) -> bool:
        return (
            tok in r.stop_set()
            or len(r.generated) >= r.max_new_tokens
            # cache budget: the next decode step would write past max_len
            or len(r.prompt) + len(r.generated) >= self.max_len
        )

    def _finish(self, r: Request, slot: int, now: float) -> None:
        r.done = True
        self.metrics.request_finished(r, now)
        self.kv.free(slot)
        del self.active[slot]
        self._rngs.pop(r.rid, None)

    def _compact(self) -> None:
        """Defrag active slots to a contiguous prefix and re-point the
        request map and last tokens."""
        for src, dst in self.kv.compact().items():
            r = self.active.pop(src)
            r.slot = dst
            self.active[dst] = r
            self.last_tok[dst] = self.last_tok[src]
