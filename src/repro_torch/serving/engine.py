"""Slot-managed continuous-batching engine (counterpart of
``repro/serving/engine.py::Engine`` for the slice the port runs).

``Engine`` composes :class:`~repro_torch.serving.kv_cache.SlotKVCache`
(per-slot positions, alloc/free/defrag, batched prefill splicing), a
:class:`~repro_torch.serving.scheduler.Scheduler` (fcfs / sjf /
gemv_aware admission, backpressure, deadline expiry),
:class:`~repro_torch.serving.metrics.ServingMetrics` and the numpy
sampler.  Each :meth:`Engine.step` expires, preempts (when a queued
deadline is imminent and no slot is free), admits, prefills the admission
wave in ONE right-padded batched forward, advances every chunked prefill by
one chunk, and decodes one token for every active slot over the smallest
power-of-two bucket that covers them.

``prefill_chunk=n`` prefills a prompt longer than ``n`` tokens one chunk a
step, continuing from the slot's own row, so a long prompt no longer
stalls the decode of the active slots.  A slot mid-prefill sits inside
the decode bucket: the step writes one position at its ``pos`` and
advances it; the engine puts ``pos`` back, outside the step, and the next
chunk rewrites that position (no copy of the row).  A recurrent model's
step would also advance the row's state: its state rows (and only those)
are saved before the step and restored after it, outside the captured
graph.

Every prefill forward runs on the engine's prefill sub-cache
(``Engine.sub``, ``batch_slots + 1`` one-slot rows): a wave on its first
``nb`` rows, spliced into the slots after; a chunk on row 0, the slot's
row copied in before and out after.  So a prefill's shapes are its only
variables, and on the card each ``(rows, length)`` is one captured graph
(:class:`~repro_torch.serving.step_graph.PrefillGraphs`).

``async_prefill=True`` (the reference's overlapped serving) sends every
miss through the chunk chain, even a prompt of one chunk: chunks are
issued against the chain's own row of the sub-cache (row ``1 + i``), not
the slot's row, on a side CUDA stream on the card, one chunk a step; the
step after the final chunk harvests it (waits for its event, splices the
row into the slot, samples the first token).  Until then the slot's row
holds junk that the decode steps may write: there is no snapshot and no
restore, and no state checkpoint mid-chain.  Preemption lands an
in-flight chain before it files the victim; defrag moves a chain with
its slot.  On the CPU the chain runs in order, with the same rows,
harvest and counters.

A recurrent model (rwkv6) never runs a pad token through its state, as in
the JAX package: a wave prefills one request at its exact length, a chunk
runs its exact tokens, and a first chunk starts from zeroed state.

``prefix_cache=True`` (or a ``PrefixCacheConfig`` / ``PrefixCache``) keeps
prefilled KV in a radix index (:mod:`repro_torch.serving.prefix_cache`): at
admission the longest cached prefix is spliced into the slot and only the
tail prefills, through the chunked seam.  Preemption files the victim's KV
there first, so a readmitted victim re-prefills only what it generated
since.  A recurrent model's state can only resume from a snapshot taken
at a segment's end: its chunked prefill files one at every chunk
boundary.

With ``preempt_margin`` set on a ``gemv_aware`` scheduler, a queued
request whose deadline would pass within the margin while every slot is
taken evicts the youngest slot: one mid-prefill first, else the youngest
decoding one.  The victim is requeued and re-prefills prompt plus
generated on readmission, so its greedy tokens do not change.

Decode is where the GEMV kernels run: with the bucket at or under
``gemv_batch_threshold`` the model's projections go through the
dispatcher -- QKV and gate+up as fused programs over weights prepacked at
construction, down and the LM head as single requests.

``kv_store="int8"`` / ``"int4"`` keeps the KV cache as quantized pages
(``repro_torch.kernels.kv_quant``), prefill and decode alike.

whisper and llama-3.2-vision read per-slot modality features
(``Engine.features``: stub frame or patch embeddings, ``[batch_slots,
...]`` f32, drawn as the JAX engine's ``_make_extra`` draws them): a wave
prefill reads its slots' rows (batch-pad rows reuse the first slot's), a
chunk its slot's row, a decode step the first ``b`` rows, and defrag
swaps rows in place.  Their KV is not a function of the tokens alone, so
the prefix cache stays off for them.

On an MoE model the experts of a decode step run as ragged programs
(``gemv_expert_shape="ragged"``, the default) or grouped ones
(``"grouped"``); ``"einsum"`` keeps them out of the dispatcher.  The
scheduler's ``gemv_aware`` admission is expert-aware there and reads the
dispatcher's ``expert_load`` deltas before each admission.

On the card each decode step is one CUDA graph per bucket and each
prefill one per shape (:mod:`repro_torch.serving.step_graph`, the
counterparts of the JAX engine's jitted ``_decode_fn`` and
``_prefill_fn``): the first run at a key runs eagerly and is then
captured, every later one replays.  A state family's wave (its exact
length), its short last chunk and a chunk cut short by ``max_len`` run
eagerly by design, counted in ``Engine.prefill_graphs.eager``.  Inside
:func:`~repro_torch.serving.step_graph.disable_graphs`, and always on the
CPU, both run eagerly op by op.

``tracer=`` (a :class:`~repro_torch.observability.Tracer`) flight-records
the run at the reference's sites: each request's phases (queued, prefill,
decode, preempted) on the tracer's host clock, the engine's spans
(``prefix_match``, ``prefill_wave``, ``prefill_chunk``, ``decode_step``),
events (``reject``, ``defrag_move``; the scheduler's ``requeue``, the
prefix cache's ``prefix_evict``) and per-step gauges; installing it
process-wide arms the dispatcher's attribution hook.  A span over device
work closes after the host read that already waits for it (a step's
sampled logits); a non-final prefill chunk has none, so its span is the
host's enqueue.  With no tracer the engine runs the same device work and
host reads.  A replayed decode graph runs no Python: its dispatch
decisions were recorded at the bucket's eager first step.  With
``async_prefill`` each harvest records an ``async_prefill`` span
(``cat="overlap"``) from the final chunk's issue to the harvest, with the
host's wait in ``blocked_us``, and each chunk and harvest ticks
``record_overlap("async_prefill", ...)``.

Sharded mode (the reference's ``Engine(mesh=)``): constructed with a
:class:`~repro_torch.launch.mesh.Mesh` on every rank of it (each rank a
process, ``launch.mesh.spawn`` or ``torchrun``), the engine runs the same
serving loop on this rank's blocks of the model
(``distributed.sharding.shard_params``: the PIMnast mesh planner's
placement, the fused leaves packed per rank), its shard of the slot cache
(``slot_cache_spec``: kv heads on 'model', rwkv6's wkv state on the
rank's heads, hymba's Mamba state on its channels; slots, ``pos`` and
the token-shift carries whole) and of every prefix segment, with
``DispatchPolicy.model_shards`` the 'model' axis size: each GEMV is
selected at the shape its rank runs.  The layers
issue the collectives (``models/layers.py``); ``overlap_collectives=True``
defers each decode layer's FFN all-reduce by one layer (bit-equal
tokens).  Every host decision must be the same on every rank, or one rank
issues a collective the others never match: the step's ``now`` is rank
0's clock, broadcast once a step (deadline expiry and preemption read
it); the dispatcher's autotune table (measured picks, fitted constants)
is rank 0's, broadcast once at construction
(``distributed.tuning.share_autotune_table``) so every rank selects the
same kernels, and only rank 0 writes tables and traces (its tracer; the
others get none); the prefix
cache counts global bytes (each leaf's rank bytes times its blocks,
``SlotKVCache.scales``); sampling reads the all-gathered logits, the
same on every rank.  A 'data' axis above 1 replicates the serving state,
and (a deliberate difference) the parameters too.  Under gloo (ranks
sharing a card) decode and prefill run eagerly: gloo collectives cannot
be captured in a CUDA graph (``Engine.graphs`` is None and
``Engine.graphs_reason`` says why); under NCCL too, until a machine with a
card a rank has checked the captured collectives (a pre-warmed
communicator, and the deferred collectives counted at replay).
Sharded serving runs every family: the dense and MoE decoders, whisper
(its encoder and cross-attention as rank blocks), llama-vision (its
cross-attention layers), rwkv6 (each time-mix on the rank's heads, each
channel-mix on its ``d_ff`` columns) and hymba (its Mamba mixers on the
rank's channels beside attention, cut where its heads divide).  Every
rank draws the same per-slot features (``make_features``) and a
compaction swaps their rows by the same moves on every rank; a recurrent
model's state rows are zeroed, saved, restored, snapshotted and spliced
on every rank alike, each its block.  With ``async_prefill`` every rank
issues, moves and harvests the same chains at the same steps (a harvest
waits for each chain fully issued: no readiness query decides), each on
its row of the rank's prefill sub-cache (the rank's blocks of K/V, their
scales and the state), the chains' collectives on a 'model' group of
their own (``Mesh.side_mesh``): on the side stream they never share a
communicator with the decode step's, which under NCCL could order the
two streams' collectives differently on different ranks.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.axes import activation_mesh
from repro_torch.distributed.tuning import share_autotune_table
from repro_torch.kernels.backends import DispatchPolicy
from repro_torch.kernels.dispatch import record_overlap
from repro_torch.kernels.kv_quant import validate_kv_store
from repro_torch.models import lm
from repro_torch.observability.trace import install_tracer
from repro_torch.serving.kv_cache import POSITIONAL_LEAVES, SlotKVCache
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.prefix_cache import (
    PrefixCache,
    PrefixCacheConfig,
    PrefixMatch,
    prefix_cacheable,
)
from repro_torch.serving.sampling import (
    SamplingParams,
    request_rng,
    sample_token,
)
from repro_torch.serving.scheduler import QueueFull, Scheduler, \
    SchedulerConfig
from repro_torch.serving.step_graph import CudaCapture, DecodeGraphs, \
    PrefillGraphs, graphs_enabled

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
    admit_seq: int = -1             # admission order (preemption victim)
    evictions: int = 0              # times this request lost its slot
    first_token_time: float | None = None
    finish_time: float | None = None
    # prefix-cache outcome of the FIRST admission (None: no prefix cache);
    # keys the TTFT hit/miss split
    prefix_hit: bool | None = None

    def stop_set(self) -> frozenset[int]:
        if self.eos_ids is not None:
            return frozenset(self.eos_ids)
        return frozenset((self.eos_id,)) if self.eos_id >= 0 else frozenset()


def make_features(cfg: ModelConfig, slots: int,
                  device) -> dict[str, torch.Tensor]:
    """The per-slot modality features of the JAX engine's ``_make_extra``:
    from ``np.random.default_rng(0)``, whisper's stub frame embeddings
    ``frames [slots, n_frames, enc_d]`` first, then llama-vision's patch
    embeddings ``vision [slots, vision_tokens, d]``, f32 (the forward
    casts them to the compute dtype).  Empty for the other families."""
    rng = np.random.default_rng(0)
    shapes = {}
    if cfg.encoder is not None:
        shapes["frames"] = (slots, cfg.encoder.n_frames, cfg.encoder.d_model)
    if cfg.cross_attn_every > 0:
        shapes["vision"] = (slots, cfg.vision_tokens, cfg.d_model)
    return {k: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(device) for k, shape in shapes.items()}


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _rows(cache: dict, lo: int, hi: int) -> dict:
    """Rows ``[lo, hi)`` of a cache dict as views."""
    return {name: leaf[lo:hi] if leaf.ndim == 1 else leaf[:, lo:hi]
            for name, leaf in cache.items()}


def _copy_row(dst: dict, i: int, src: dict, j: int, lo: int,
              hi: int) -> None:
    """Row ``j`` of ``src`` into row ``i`` of ``dst``: positions ``[lo,
    hi)`` of the positional leaves and every state leaf whole; ``pos`` is
    the caller's to set."""
    for name, leaf in dst.items():
        if name == "pos":
            continue
        if name in POSITIONAL_LEAVES:
            if hi > lo:
                leaf[:, i, lo:hi].copy_(src[name][:, j, lo:hi])
        else:
            leaf[:, i].copy_(src[name][:, j])


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
                 prepack_weights: bool = True,
                 metrics: ServingMetrics | None = None,
                 prefill_chunk: int | None = None,
                 async_prefill: bool = False,
                 prefix_cache=None,
                 kv_store: str = "fp",
                 device=None,
                 tracer=None,
                 clock=time.monotonic,
                 mesh=None,
                 overlap_collectives: bool = False):
        self.kv_store = validate_kv_store(kv_store)
        self.mesh = mesh
        model_shards = 1
        if mesh is not None:
            from repro_torch.launch.mesh import model_axis_size

            shd.check_mesh_family(cfg)
            model_shards = model_axis_size(mesh)
            device = device if device is not None else mesh.device
            # one writer of traces: rank 0
            tracer = tracer if mesh.rank == 0 else None
            # one table of picks: rank 0's, on every rank
            share_autotune_table(mesh)
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.slots = batch_slots
        self.max_len = max_len
        self.clock = clock
        # the flight recorder; installing it process-wide arms the
        # dispatcher's attribution hook
        self.tracer = tracer
        if tracer is not None:
            install_tracer(tracer)
        self.prefill_chunk = prefill_chunk
        self.async_prefill = bool(async_prefill)
        # recurrent state must never see a pad token: exact prefill shapes
        self.exact_prefill = cfg.family == "ssm" or cfg.parallel_ssm
        # One DispatchPolicy for the engine's lifetime; above the batch
        # threshold the backend itself sends decode GEMVs to ref.
        self.gemv_policy = (
            DispatchPolicy(batch_threshold=gemv_batch_threshold,
                           backend=gemv_backend,
                           fuse_programs=gemv_fuse_programs,
                           expert_shape=gemv_expert_shape,
                           model_shards=model_shards,
                           overlap_collectives=bool(overlap_collectives))
            if use_pim_kernels else None)
        # one-time prepack: fused weights and the contiguous head the
        # kernels read (no per-step concat or transpose); under a mesh,
        # this rank's blocks
        if prepack_weights and self.gemv_policy is not None:
            self.params = lm.prepack_decode_params(params, cfg, mesh=mesh)
        else:
            self.params = (shd.shard_params(params, mesh, cfg)
                           if mesh is not None else params)
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
        if tracer is not None:
            self.scheduler.tracer = tracer
        self.metrics = metrics or ServingMetrics(clock=clock)
        self.kv = SlotKVCache(cfg, batch_slots, max_len,
                              kv_store=self.kv_store, device=self.device,
                              mesh=mesh)
        # shared-prefix KV reuse: True (the default config), a
        # PrefixCacheConfig, or a PrefixCache; families whose KV is not a
        # function of the tokens stay uncached
        self.prefix: PrefixCache | None = None
        if prefix_cache and prefix_cacheable(cfg):
            if isinstance(prefix_cache, PrefixCache):
                self.prefix = prefix_cache
            else:
                self.prefix = PrefixCache(
                    prefix_cache if isinstance(prefix_cache,
                                               PrefixCacheConfig) else None,
                    has_state=bool(self.kv.state_names),
                    byte_scale=self.kv.scales)
            # admission prices a cached prefix as near-zero prefill
            self.scheduler.prefill_cost = self._prefill_cost
        self.active: dict[int, Request] = {}   # slot -> request
        # chunked prefill in flight: slot -> [request, tokens landed so far]
        # (the slot is alloc'd but not decoding)
        self._prefilling: dict[int, list] = {}
        self._admit_seq = 0
        self.expired: list[Request] = []
        # host copy: one small transfer per decode step instead of one
        # device write per sampled token
        self.last_tok = np.zeros((batch_slots, 1), np.int64)
        self._rngs: dict[int, np.random.Generator] = {}
        # per-slot modality features; the decode graphs read them by
        # address, so defrag permutes their rows in place
        self.features = make_features(cfg, batch_slots, self.device)
        # the decode step's captured graphs, one per bucket (on the card);
        # they reach the body through a weak reference, so a dropped engine
        # frees its graphs and cache at once, not at a later collection
        body = weakref.WeakMethod(self._decode_body)
        self.graphs_reason = None
        if self.device.type != "cuda":
            self.graphs_reason = "not a CUDA device"
        elif mesh is not None and mesh.world_size > 1:
            self.graphs_reason = (
                f"{mesh.backend} collectives cannot be captured in a CUDA "
                f"graph" if mesh.backend != "nccl" else
                "NCCL collectives in a CUDA graph are unverified (it needs "
                "a machine with a card a rank)")
        captured = self.graphs_reason is None
        self.graphs = (
            DecodeGraphs(lambda b, tok: body()(b, tok), self.kv.cache,
                         slots=batch_slots, vocab=cfg.vocab,
                         device=self.device,
                         capture=CudaCapture(self.device),
                         inputs=self.features)
            if captured else None)
        # the prefill sub-cache and its feature rows: row 0 stages every
        # chunk, rows [0, nb) a wave, row 1 + i an async chain's; and each
        # chain's first-token logits
        self.sub = lm.init_cache(cfg, batch_slots + 1, max_len,
                                 per_slot_pos=True, kv_store=self.kv_store,
                                 device=self.device, mesh=mesh)
        self.sub_features = {
            k: torch.zeros((batch_slots + 1, *v.shape[1:]), dtype=v.dtype,
                           device=self.device)
            for k, v in self.features.items()}
        # async chains: slot -> {"row", "chunks", "final", "t_final_us",
        # "event"}; the keys are a subset of _prefilling's
        self._inflight: dict[int, dict] = {}
        self._free_rows = list(range(1, batch_slots + 1))
        self.sub_last = (torch.zeros((batch_slots + 1, cfg.vocab),
                                     dtype=torch.float32, device=self.device)
                         if self.async_prefill else None)
        self.side = (torch.cuda.Stream(self.device)
                     if self.async_prefill and self.device.type == "cuda"
                     else None)
        # under a mesh the chains' collectives run on a 'model' group of
        # their own (``Mesh.side_mesh``): on the side stream they never
        # share a communicator with the decode step's.  Every rank issues
        # and harvests the same chains in step: the host decisions are
        # rank 0's (its clock), and a harvest waits for every chain fully
        # issued, never on a readiness query
        self.chain_mesh = (mesh.side_mesh()
                           if mesh is not None and self.async_prefill
                           else None)
        # the prefill forwards' captured graphs, one per (rows, length),
        # sharing one memory pool
        pbody = weakref.WeakMethod(self._prefill_body)
        self.prefill_graphs = (
            PrefillGraphs(lambda tok, last: pbody()(tok, last), self.sub,
                          vocab=cfg.vocab, device=self.device,
                          capture=CudaCapture(self.device, shared_pool=True),
                          inputs=self.sub_features)
            if captured else None)

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
            if self.tracer is not None:
                self.tracer.event("reject", cat="request", rid=req.rid,
                                  reason="queue_full")
            raise
        self.metrics.request_submitted()
        if self.tracer is not None:
            # the request is in its ``queued`` phase until admission
            self.tracer.request_submit(req.rid, prompt_len=len(req.prompt))

    def step(self) -> list[Request]:
        """One engine iteration: expire + (maybe) preempt + admit + prefill
        + one chunk of every chunked prefill + one decode step.  Returns
        the requests completed this step."""
        if self.mesh is None:
            return self._step(self.clock())
        with activation_mesh(self.mesh):
            return self._step(self._mesh_now())

    def _mesh_now(self) -> float:
        """Rank 0's clock, the same on every rank: deadline expiry and
        preemption must take the same decisions everywhere."""
        box = [self.clock()]
        if self.mesh.world_size > 1:
            dist.broadcast_object_list(box, src=0)
        return box[0]

    def _step(self, t0: float) -> list[Request]:
        tr = self.tracer
        expired = self.scheduler.expire(t0)
        for r in expired:
            r.expired = True
            if tr is not None:
                tr.request_finish(r.rid, outcome="expired")
        self.expired.extend(expired)
        if expired:
            self.metrics.requests_expired(len(expired))
        self._maybe_preempt(t0)
        if self.scheduler.config.moe_experts > 1:
            # refresh the router-skew estimate before deciding how many
            # slots to fill
            self.scheduler.observe_expert_load(
                self.metrics.dispatch_delta().get("expert_load", {}))
        admitted = self.scheduler.select(self.kv.n_free, self.kv.n_active,
                                         t0)
        finished: list[Request] = []
        for r in admitted:
            r.admit_seq = self._admit_seq
            self._admit_seq += 1
            if tr is not None:
                # queued (or preempted) -> prefill
                tr.request_phase(r.rid, "prefill", admit_seq=r.admit_seq)
        misses = admitted
        if self.prefix is not None:
            # a hit splices its cached segments and joins the chunked seam
            # with only the tail left to run
            misses = []
            for r in admitted:
                m = self._prefix_match(r)
                if m is not None:
                    self._admit_prefix_hit(r, m)
                else:
                    misses.append(r)
        if self.async_prefill:
            # every miss rides the chunk chain, even a one-chunk prompt
            chunked = list(misses)
        elif self.prefill_chunk:
            chunked = [r for r in misses
                       if len(self._pending_tokens(r)) > self.prefill_chunk]
        else:
            chunked = []
        chunked_ids = {id(r) for r in chunked}
        plain = [r for r in misses if id(r) not in chunked_ids]
        # a recurrent model prefills one request a wave (no pad rows)
        for wave in ([[r] for r in plain] if self.exact_prefill
                     else [plain] if plain else []):
            finished.extend(self._prefill_wave(wave))
        for r in chunked:
            # the admission spent this slot; its first chunk runs below
            slot = self.kv.alloc()
            self._prefilling[slot] = [r, 0]
            if tr is not None:
                tr.request_annotate(r.rid, slot=slot)
        if self._prefilling:
            finished.extend(self._advance_chunked())
        # an instant finish at prefill can punch a hole in the active
        # prefix; decode needs it contiguous
        self._defrag_moves = 0      # this step's compaction moves
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
        if tr is not None:
            tr.counter("queue_depth", len(self.scheduler))
            tr.counter("active_slots", self.kv.n_active)
            tr.counter("decode_batch", decode_batch)
        return finished

    def run_until_drained(self, max_iters: int = 1000) -> list[Request]:
        done: list[Request] = []
        for _ in range(max_iters):
            done.extend(self.step())
            if (not self.active and not self._prefilling
                    and not self.scheduler.queue):
                break
        return done

    # -- prefix cache --------------------------------------------------------

    def _prefill_cost(self, r: Request) -> int:
        """Prefill tokens ``r`` would actually run: pending minus the
        cached prefix (the scheduler's ordering hook; a pure probe)."""
        toks = self._pending_tokens(r)
        return max(1, len(toks) - self.prefix.match_len(toks))

    def _prefix_match(self, r: Request) -> PrefixMatch | None:
        """Admission-time lookup: counts the hit or miss and pins the
        first admission's outcome for the TTFT split."""
        tr = self.tracer
        t0 = tr.now_us() if tr is not None else 0.0
        m = self.prefix.match(self._pending_tokens(r))
        if tr is not None:
            tr.add_span("prefix_match", t0, tr.now_us(), rid=r.rid,
                        hit=m is not None,
                        matched=m.length if m is not None else 0)
        if r.prefix_hit is None:
            r.prefix_hit = m is not None
        self.metrics.prefix_lookup(m is not None,
                                   m.length if m is not None else 0)
        return m

    def _admit_prefix_hit(self, r: Request, m: PrefixMatch) -> None:
        """Pin the matched segments, splice them into a fresh slot, and
        hand the tail to the chunked seam: the matched prefill never
        runs."""
        slot = self.kv.alloc()
        self.prefix.acquire(m)
        # the pin travels with the slot and is dropped in _release_prefix
        self.kv.slot_meta[slot]["prefix_match"] = m
        self.kv.splice_prefix(slot, self.prefix.gather(m), m.length)
        self._prefilling[slot] = [r, m.length]
        if self.tracer is not None:
            self.tracer.request_annotate(r.rid, slot=slot, prefix_hit=True,
                                         prefix_tokens=m.length)

    def _prefix_insert(self, slot: int, tokens: np.ndarray) -> None:
        """File a slot's freshly prefilled KV into the radix index."""
        if self.prefix is None or len(tokens) == 0:
            return
        self.prefix.insert(tokens,
                           self.kv.extract_prefix(slot, len(tokens)))

    def _release_prefix(self, slot: int) -> None:
        """Unpin the segments a slot acquired at admission (before free)."""
        m = self.kv.slot_meta.get(slot, {}).pop("prefix_match", None)
        if m is not None and self.prefix is not None:
            self.prefix.release(m)

    # -- internals -----------------------------------------------------------

    @staticmethod
    def _pending_tokens(r: Request) -> np.ndarray:
        """The tokens a (re-)prefill must run: the prompt, plus what was
        generated before an eviction (so eviction leaves the greedy stream
        as it was)."""
        if r.generated:
            return np.concatenate([np.asarray(r.prompt, np.int32),
                                   np.asarray(r.generated, np.int32)])
        return np.asarray(r.prompt, np.int32)

    def _maybe_preempt(self, now: float) -> None:
        """Evict the youngest slot for a deadline-imminent queued request
        when none is free: one mid-prefill first (no decode work lost),
        else the youngest decoding one.  Its KV goes into the prefix cache
        before the slot is freed, and it is requeued."""
        if self.kv.n_free > 0 or (not self.active and not self._prefilling):
            return
        if not self.scheduler.wants_preemption(now):
            return
        if self._prefilling:
            slot = max(self._prefilling,
                       key=lambda s: self._prefilling[s][0].admit_seq)
            r, valid = self._prefilling.pop(slot)
            # an async chain in flight lands first: the row holds junk
            # until then
            self._await_inflight(slot, valid)
        else:
            slot = max(self.active, key=lambda s: self.active[s].admit_seq)
            r = self.active.pop(slot)
            valid = int(self.kv.kv_valid_len()[slot])
        self._prefix_insert(slot, self._pending_tokens(r)[:valid])
        self._release_prefix(slot)
        self.kv.free(slot)
        r.slot = -1
        r.evictions += 1
        self.scheduler.requeue(r)
        self.metrics.request_evicted()
        if self.tracer is not None:
            # readmission re-enters prefill
            self.tracer.request_phase(r.rid, "preempted", evicted_from=slot,
                                      evictions=r.evictions)

    # -- prefill -------------------------------------------------------------

    def _prefill_body(self, tok: torch.Tensor,
                      last: torch.Tensor) -> torch.Tensor:
        """The prefill forward of the sub-cache's first ``nb = len(tok)``
        rows (K/V and state written in place) on tokens ``tok [nb, L]``
        with their feature rows; returns the ``[nb, vocab]`` logits at
        positions ``last [nb]``."""
        nb = tok.shape[0]
        logits, _, _ = lm.forward(
            self.params, self.cfg, tok, cache=_rows(self.sub, 0, nb),
            last=last, **{k: v[:nb] for k, v in self.sub_features.items()})
        return logits[:, 0]

    def _run_prefill(self, tokens: np.ndarray, last: np.ndarray,
                     eager: str | None = None) -> torch.Tensor:
        """:meth:`_prefill_body` over rows the caller filled, on the
        current stream: a replayed graph on the card (``eager`` names why
        this one runs eagerly instead, counted), else op by op.  Returns
        the f32 ``[nb, vocab]`` logits (the graph's static buffer, valid
        until its next run)."""
        g = self.prefill_graphs
        if g is not None and graphs_enabled():
            if eager is None:
                return g.run(tokens, last)
            g.count_eager(eager)
        nb = tokens.shape[0]
        out = torch.empty((nb, self.cfg.vocab), dtype=torch.float32,
                          device=self.device)
        # the graph's own copy into its static logits, as a graph runs it
        out.copy_(self._prefill_body(
            torch.from_numpy(tokens.astype(np.int64)).to(self.device),
            torch.from_numpy(last.astype(np.int64)).to(self.device)))
        return out

    def _prefill_wave(self, wave: list[Request]) -> list[Request]:
        """The whole admission wave in ONE right-padded batched forward on
        the sub-cache's first ``nb`` rows, spliced into the slots;
        per-slot last-valid-token logits are gathered by length."""
        tr = self.tracer
        wave_t0 = tr.now_us() if tr is not None else 0.0
        slots = [self.kv.alloc() for _ in wave]
        if tr is not None:
            for r, slot in zip(wave, slots):
                tr.request_annotate(r.rid, slot=slot)
        toks = [self._pending_tokens(r).astype(np.int64) for r in wave]
        lengths = [len(t) for t in toks]
        Lmax = max(lengths)
        # the pow2 pad never runs past max_len: the KV write starts at 0 and
        # a longer pad would have to clamp (the JAX engine caps it the same
        # way, engine.py:700); recurrent state takes no pad at all
        Lpad = (Lmax if self.exact_prefill
                else max(min(_next_pow2(Lmax), self.max_len), Lmax))
        nb = min(_next_pow2(len(wave)), self.slots)
        tokens = np.zeros((nb, Lpad), np.int64)
        lens = np.ones((nb,), np.int64)
        for i, t in enumerate(toks):
            tokens[i, :lengths[i]] = t
            lens[i] = lengths[i]
        # a fresh start on the rows (what an earlier prefill left past the
        # wave's positions is masked); batch-pad rows reuse the first
        # slot's features
        sub = _rows(self.sub, 0, nb)
        sub["pos"].zero_()
        for name in self.kv.state_names:
            sub[name].zero_()
        if self.features:
            rows = torch.as_tensor(slots + [slots[0]] * (nb - len(wave)),
                                   device=self.device)
            for k, v in self.features.items():
                self.sub_features[k][:nb] = v[rows]
        # a state family's exact length would be a graph per prompt length
        last = self._run_prefill(tokens, lens - 1,
                                 "exact_wave" if self.exact_prefill
                                 else None)
        self.kv.splice(sub, slots, lengths)
        for slot, t in zip(slots, toks):
            self._prefix_insert(slot, t)
        last_np = last.cpu().numpy()
        now = self.clock()
        finished = []
        for i, (r, slot) in enumerate(zip(wave, slots)):
            tok = self._sample(r, last_np[i])
            if self._activate(r, slot, tok, now):
                finished.append(r)
        self.metrics.prefill_wave(len(wave), sum(lengths))
        if tr is not None:
            tr.add_span("prefill_wave", wave_t0, tr.now_us(),
                        requests=len(wave), tokens=sum(lengths))
        return finished

    def _chunk_shape(self, c: int, consumed: int,
                     chunk_limit: int) -> tuple[int, str | None]:
        """A chunk's padded length and why it runs eagerly (None: it
        replays its graph).  The pad never runs past max_len: the KV write
        starts at ``consumed`` and a longer pad would clamp the start
        backwards over earlier chunks (the JAX engine's rule,
        engine.py:773); such a cut chunk, and a state family's short last
        chunk (its exact length), run eagerly."""
        if self.exact_prefill:
            return c, None if c == chunk_limit else "exact_last_chunk"
        want = min(_next_pow2(c), chunk_limit)
        cpad = max(min(want, self.max_len - consumed), c)
        return cpad, None if cpad == want else "max_len_cut"

    def _run_chunk(self, cache: dict, row: int, features: dict,
                   chunk: np.ndarray, consumed: int,
                   chunk_limit: int) -> torch.Tensor:
        """One chunk continuing row ``row`` of ``cache`` (a slot's, or an
        async chain's row of the sub-cache) with that row's ``features``:
        the row's landed positions ``[0, consumed)`` and its state are
        copied into the sub-cache's row 0, the forward runs there, and the
        chunk's positions and the state are copied back with ``pos`` at
        the tokens landed (what lies past them on either row is masked).
        Returns the f32 ``[1, vocab]`` last-token logits."""
        c = len(chunk)
        cpad, eager = self._chunk_shape(c, consumed, chunk_limit)
        tokens = np.zeros((1, cpad), np.int64)
        tokens[0, :c] = chunk
        _copy_row(self.sub, 0, cache, row, 0, consumed)
        self.sub["pos"][0].fill_(consumed)
        for k, v in features.items():
            self.sub_features[k][0] = v
        out = self._run_prefill(tokens, np.array([c - 1]), eager)
        _copy_row(cache, row, self.sub, 0, consumed, consumed + c)
        cache["pos"][row].fill_(consumed + c)
        return out

    def _advance_chunked(self) -> list[Request]:
        """Advance every chunked prefill by ONE chunk; the final chunk
        samples the first token and moves the request into the decode set.
        Returns the requests that finished at once.

        With ``async_prefill`` the chunks are issued against each chain's
        own row of the sub-cache (on the side stream on the card); the
        chains whose final chunk went out the step before are harvested
        first (:meth:`_harvest_ready`)."""
        finished = []
        # a prefix hit's tail rides this seam even with chunking off: one
        # chunk covers the whole tail
        chunk_limit = self.prefill_chunk or self.max_len
        tr = self.tracer
        if self.async_prefill:
            finished.extend(self._harvest_ready())
        for slot in sorted(self._prefilling):
            inf = self._inflight.get(slot)
            if inf is not None and inf["final"]:
                continue             # fully issued; harvests next step
            chunk_t0 = tr.now_us() if tr is not None else 0.0
            req, consumed = self._prefilling[slot]
            toks = self._pending_tokens(req)
            chunk = toks[consumed:consumed + chunk_limit]
            c = len(chunk)
            if self.async_prefill:
                self._issue_chain_chunk(slot, chunk, consumed, chunk_limit,
                                        final=consumed + c >= len(toks))
                self._prefilling[slot][1] = consumed + c
                self.metrics.prefill_chunk(c)
                if tr is not None:
                    self._chunk_span(tr, chunk_t0, slot, req, c, consumed)
                continue
            # a first chunk starts at 0 (what an earlier occupant left at
            # or past ``pos`` is masked, then overwritten) and from zeroed
            # state (the JAX engine's fresh one-slot cache)
            if consumed == 0:
                self.kv.cache["pos"][slot].fill_(0)
                self.kv.zero_state(slot)
            last = self._run_chunk(
                self.kv.cache, slot,
                {k: v[slot] for k, v in self.features.items()}, chunk,
                consumed, chunk_limit)
            self.metrics.prefill_chunk(c)
            if consumed + c < len(toks):
                self._prefilling[slot][1] = consumed + c
                # state resumes only from a snapshot, and an edge split
                # cannot make one mid-edge: file one at each chunk boundary
                if self.prefix is not None and self.prefix.has_state:
                    self._prefix_insert(slot, toks[:consumed + c])
                if tr is not None:
                    self._chunk_span(tr, chunk_t0, slot, req, c, consumed)
                continue
            del self._prefilling[slot]
            self._prefix_insert(slot, toks)
            last = last[0].cpu().numpy()
            if tr is not None:
                self._chunk_span(tr, chunk_t0, slot, req, c, consumed)
            tok = self._sample(req, last)
            if self._activate(req, slot, tok, self.clock()):
                finished.append(req)
        return finished

    @staticmethod
    def _chunk_span(tr, t0: float, slot: int, req: Request, c: int,
                    consumed: int) -> None:
        tr.add_span("prefill_chunk", t0, tr.now_us(), track=f"slot{slot}",
                    rid=req.rid, slot=slot, tokens=c, consumed=consumed + c)

    # -- async prefill ---------------------------------------------------------

    def _issue_chain_chunk(self, slot: int, chunk: np.ndarray,
                           consumed: int, chunk_limit: int, *,
                           final: bool) -> None:
        """Issue the next chunk of slot ``slot``'s chain.  Its first chunk
        takes a free row of the sub-cache and, on the main stream, sets
        it up there: a miss at position 0 with zeroed state, a prefix
        hit's spliced segments copied from the slot's row; and the
        chain's own copy of the slot's feature rows (defrag swaps the
        slot's rows in place).  The side stream waits for that, then runs
        the chunk and records the chain's event after it."""
        inf = self._inflight.get(slot)
        if inf is None:
            row = self._free_rows.pop(0)
            if consumed == 0:
                self.sub["pos"][row].fill_(0)
                for name in self.kv.state_names:
                    self.sub[name][:, row].zero_()
            else:
                _copy_row(self.sub, row, self.kv.cache, slot, 0, consumed)
                self.sub["pos"][row].fill_(consumed)
            for k, v in self.features.items():
                self.sub_features[k][row] = v[slot]
            inf = self._inflight[slot] = {"row": row, "chunks": 0,
                                          "final": False, "t_final_us": 0.0,
                                          "event": None}
            if self.side is not None:
                self.side.wait_stream(torch.cuda.current_stream(self.device))
        row = inf["row"]
        stream = (torch.cuda.stream(self.side) if self.side is not None
                  else contextlib.nullcontext())
        chain_mesh = (activation_mesh(self.chain_mesh)
                      if self.chain_mesh is not None
                      else contextlib.nullcontext())
        with stream, chain_mesh:
            last = self._run_chunk(
                self.sub, row,
                {k: v[row] for k, v in self.sub_features.items()}, chunk,
                consumed, chunk_limit)
            self.sub_last[row].copy_(last[0])
            if self.side is not None:
                inf["event"] = torch.cuda.Event()
                inf["event"].record(self.side)
        record_overlap("async_prefill", issued=1)
        inf["chunks"] += 1
        inf["final"] = final
        inf["t_final_us"] = (self.tracer.now_us() if self.tracer is not None
                             else 0.0)

    def _land_chain(self, slot: int, inf: dict, valid: int) -> None:
        """Splice a chain's row into its slot with ``pos`` at ``valid``, on
        the main stream after the chain's event, and free the row."""
        if inf["event"] is not None:
            torch.cuda.current_stream(self.device).wait_event(inf["event"])
        row = inf["row"]
        _copy_row(self.kv.cache, slot, self.sub, row, 0, valid)
        self.kv.cache["pos"][slot].fill_(valid)
        self._free_rows.append(row)
        self._free_rows.sort()
        record_overlap("async_prefill", awaited=inf["chunks"])

    def _harvest_ready(self) -> list[Request]:
        """Land every chain whose final chunk was issued: wait for its
        event (the host's one block, ``blocked_us``), splice its row into
        the slot, read the first-token logits, record the overlap span,
        file the prompt's KV in the prefix cache and activate the
        request; it joins this step's decode bucket."""
        tr = self.tracer
        finished = []
        for slot in sorted(self._inflight):
            inf = self._inflight[slot]
            if not inf["final"]:
                continue
            req, consumed = self._prefilling[slot]
            t_h0 = tr.now_us() if tr is not None else 0.0
            if inf["event"] is not None:
                inf["event"].synchronize()
            t_h1 = tr.now_us() if tr is not None else 0.0
            del self._inflight[slot]
            last_np = self.sub_last[inf["row"]].cpu().numpy()
            self._land_chain(slot, inf, consumed)
            if tr is not None:
                # the issue -> harvest window, split into the host's wait
                # and the rest (hidden behind the steps in between)
                tr.add_span("async_prefill", inf["t_final_us"], t_h1,
                            cat="overlap", track=f"slot{slot}",
                            rid=req.rid, slot=slot,
                            blocked_us=max(t_h1 - t_h0, 0.0),
                            chunks=inf["chunks"], tokens=consumed)
            del self._prefilling[slot]
            self._prefix_insert(slot, self._pending_tokens(req))
            tok = self._sample(req, last_np)
            if self._activate(req, slot, tok, self.clock()):
                finished.append(req)
        return finished

    def _await_inflight(self, slot: int, valid: int) -> None:
        """Land slot ``slot``'s chain, if one is in flight, with the
        ``valid`` tokens issued so far (preemption: the victim's KV must
        be real before it is filed and the slot freed)."""
        inf = self._inflight.pop(slot, None)
        if inf is not None:
            self._land_chain(slot, inf, valid)

    def _activate(self, r: Request, slot: int, tok: int,
                  now: float) -> bool:
        """Record the first sampled token and move the request into the
        decode set; returns True on an instant finish."""
        r.generated.append(tok)
        r.slot = slot
        self.active[slot] = r
        self.last_tok[slot, 0] = tok
        if self.tracer is not None:
            # prefill -> decode at the first sampled token
            self.tracer.request_phase(r.rid, "decode", slot=slot)
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
        logits, new_cache, _ = lm.forward(
            self.params, self.cfg, tok, cache=self.kv.slice_prefix(b),
            gemv_policy=self.gemv_policy,
            **{k: v[:b] for k, v in self.features.items()})
        self.kv.merge_prefix(new_cache, b)
        return logits[:, -1]

    def _decode(self) -> tuple[list[Request], int, float]:
        t0 = self.clock()
        tr = self.tracer
        step_t0 = tr.now_us() if tr is not None else 0.0
        n = self.kv.n_active
        b = self.decode_bucket()
        # rows mid-prefill ride the step (their logits go unsampled); their
        # recurrent state must come out of it as it went in.  An async
        # chain's slot holds junk until its harvest: nothing to keep
        mid = ([] if self.async_prefill
               else [s for s in sorted(self._prefilling) if s < b])
        self.kv.save_state(mid)
        if self.graphs is not None and graphs_enabled():
            logits_np = self.graphs.step(b, self.last_tok)
        else:
            last = torch.from_numpy(self.last_tok[:b]).to(self.device)
            logits_np = self._decode_body(b, last).float().cpu().numpy()
        if self._prefilling and not self.async_prefill:
            # the step wrote one position at their ``pos`` and advanced it.
            # Put ``pos`` and the state back; the next chunk rewrites that
            # position.
            slots = sorted(self._prefilling)
            self.kv.cache["pos"][torch.as_tensor(slots, device=self.device)] \
                = torch.as_tensor([self._prefilling[s][1] for s in slots],
                                  dtype=torch.int32, device=self.device)
            self.kv.restore_state(mid)
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
        if tr is not None:
            # closes after the logits' host read, which waited for the step
            tr.add_span("decode_step", step_t0, tr.now_us(), bucket=b,
                        active=n, defrag_moves=self._defrag_moves,
                        finished=len(finished))
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
        self._release_prefix(slot)
        self.kv.free(slot)
        del self.active[slot]
        self._rngs.pop(r.rid, None)
        if self.tracer is not None:
            self.tracer.request_finish(r.rid, outcome="finished",
                                       tokens=len(r.generated),
                                       evictions=r.evictions)

    def _compact(self) -> None:
        """Defrag alloc'd slots to a contiguous prefix and re-point the
        request map, the chunked-prefill map and the last tokens; SWAP
        the modality feature rows of each move, in place (the moved
        request keeps its features, the freed slot inherits the
        destination's old row, so the rows stay a permutation)."""
        moves = self.kv.compact()
        if moves and self.features:
            # every src > every dst: the swaps are disjoint and commute
            srcs = torch.as_tensor(list(moves), device=self.device)
            dsts = torch.as_tensor(list(moves.values()), device=self.device)
            for v in self.features.values():
                src_rows = v[srcs]
                v[srcs] = v[dsts]
                v[dsts] = src_rows
        tr = self.tracer
        for src, dst in moves.items():
            self._defrag_moves += 1
            if src in self.active:
                r = self.active.pop(src)
                r.slot = dst
                self.active[dst] = r
            else:
                self._prefilling[dst] = self._prefilling.pop(src)
                r = self._prefilling[dst][0]
                if src in self._inflight:    # a chain follows its slot
                    self._inflight[dst] = self._inflight.pop(src)
            if tr is not None:
                tr.event("defrag_move", src=src, dst=dst, rid=r.rid)
                tr.request_annotate(r.rid, slot=dst)
            self.last_tok[dst] = self.last_tok[src]
