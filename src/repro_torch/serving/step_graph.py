"""The decode step as one captured CUDA graph per bucket, and prefill as
one per shape (the port's counterparts of the JAX engine's
``jax.jit(self._decode_fn)`` and ``jax.jit(self._prefill_fn)``).

The JAX engine compiles its decode step once per bucket shape and runs the
compiled program on every step; the port captures the step's kernels into
a CUDA graph once per bucket and replays it.  :class:`DecodeGraphs` keeps
one graph for each bucket ``b`` the engine decodes:

* the FIRST step at a bucket runs eagerly (its tokens are real): plans
  resolve, kernel libraries build or load, the autotuner times its
  candidates, each kernel instantiation sets its shared-memory attribute
  and cuBLAS initialises -- none of which may happen inside a capture;
* then the same body is captured.  Capture records and executes nothing,
  so the KV state advances once, at the eager step;
* every later step at that bucket copies the last tokens into a static
  input buffer through a pinned staging buffer and replays the graph.

The captured body is the forward over the first ``b`` slots of the
engine's KV cache, the write of the advanced ``pos`` back into the cache,
and a copy of the last-token logits into a static output.  A graph keeps
the addresses it was captured with (the kernels' tensor maps are encoded
on the host and passed by value), so the cache leaves must never be
reassigned, nor may the other tensors the body reads in place (the
engine's modality features): every graph step checks their
``data_ptr()`` and raises when one moved.  Each bucket's graph has a
memory pool of its own (buckets replay in any order).

Host-side counters -- the dispatcher's decisions, ``record_expert_load``
and the kernel wrappers' ``launches`` -- tick when Python runs the body:
at the eager step and at capture, never at a replay (the counterpart of
the JAX package's counting at trace time).

There is no fallback: a capture that fails (a host sync, a pageable copy,
a kernel's error) raises out of the step.  :func:`disable_graphs` is the
one way to run the eager step on the card (the counterpart of
``jax.disable_jit()``).

:class:`PrefillGraphs` keeps the same rules for the prefill forward, one
graph per ``(rows, length)`` shape: a wave of ``nb`` right-padded prompts
of ``L`` tokens, or one chunk (``nb == 1``).  The forward runs on a static
sub-cache of the engine (its first ``nb`` rows) and static feature rows;
the engine fills them before the run and splices the rows out after it,
outside the graph.  The graph's outputs are the last-token logits at
static positions.  Every tensor a prefill graph allocates is a temporary
of its own run, so an engine's prefill graphs share one memory pool: they
run on one stream, one at a time, and none reads another's memory.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable

import numpy as np
import torch

__all__ = ["CudaCapture", "DecodeGraphs", "PrefillGraphs",
           "disable_graphs", "graphs_enabled"]

_DISABLED = [False]


@contextlib.contextmanager
def disable_graphs():
    """Inside this block every engine decodes eagerly, op by op, even on
    the card (graphs already captured are kept for later)."""
    prev = _DISABLED[0]
    _DISABLED[0] = True
    try:
        yield
    finally:
        _DISABLED[0] = prev


def graphs_enabled() -> bool:
    return not _DISABLED[0]


class CudaCapture:
    """Warm-up and capture on one side stream of the engine's device.

    The eager step runs on the stream the capture will use, so whatever
    the first call on a stream sets up (cuBLAS's workspace) exists before
    the capture starts."""

    def __init__(self, device: torch.device, *, shared_pool: bool = False):
        self.stream = torch.cuda.Stream(device)
        # one memory pool for every graph this capture records, or (the
        # default) a pool of their own for each
        self.pool = (torch.cuda.graph_pool_handle() if shared_pool
                     else None)

    def warm(self, body: Callable[[], None]) -> None:
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            body()
        cur.wait_stream(self.stream)

    def capture(self, body: Callable[[], None]) -> Callable[[], None]:
        """Record ``body`` into a graph with a memory pool of its own;
        returns its replay.

        The garbage collector is run first and held off during the
        capture: a collection inside it could destroy another engine's
        graph, whose release is not permitted while a stream captures and
        would invalidate this capture."""
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                body()
        finally:
            if was_enabled:
                gc.enable()
        return graph.replay


class DecodeGraphs:
    """One captured decode step per bucket over static buffers.

    ``body(b, tok)`` runs the decode step of the first ``b`` slots on the
    ``[b, 1]`` int64 token view ``tok`` -- the forward, the write of
    ``pos`` into the cache -- and returns the ``[b, vocab]`` last-token
    logits.  ``leaves`` is the KV cache dict whose tensors the graphs
    read and write in place, ``inputs`` a dict of other tensors the body
    reads where they lie (the engine's per-slot modality features), whose
    rows may change between steps but whose tensors must stay.
    ``capture`` provides ``warm(body)`` and ``capture(body) -> replay``
    (:class:`CudaCapture` on the card).
    """

    def __init__(self, body: Callable[[int, torch.Tensor], torch.Tensor],
                 leaves: dict[str, torch.Tensor], *, slots: int, vocab: int,
                 device: torch.device, capture,
                 inputs: dict[str, torch.Tensor]):
        self.body = body
        self.leaves = leaves
        self.inputs = inputs
        self.capture = capture
        self.tok = torch.zeros((slots, 1), dtype=torch.int64, device=device)
        self.staging = torch.zeros((slots, 1), dtype=torch.int64,
                                   pin_memory=device.type == "cuda")
        self.logits = torch.zeros((slots, vocab), dtype=torch.float32,
                                  device=device)
        self._ptrs = self._leaf_ptrs()
        self.replays: dict[int, Callable[[], None]] = {}
        self.capture_s: dict[int, float] = {}

    def _leaf_ptrs(self) -> dict[str, int]:
        return {**{name: t.data_ptr() for name, t in self.leaves.items()},
                **{f"inputs.{name}": t.data_ptr()
                   for name, t in self.inputs.items()}}

    def _run(self, b: int) -> None:
        self.logits[:b].copy_(self.body(b, self.tok[:b]))

    def step(self, b: int, last_tok: np.ndarray) -> np.ndarray:
        """One decode step at bucket ``b`` from the host's last tokens
        ``[>= b, 1]``; returns the host copy of the ``[b, vocab]`` f32
        last-token logits."""
        if self._leaf_ptrs() != self._ptrs:
            raise RuntimeError(
                "a KV cache leaf or an input was reassigned after the decode "
                "graphs were set up; the graphs would read the old tensors")
        self.staging[:b].copy_(torch.from_numpy(last_tok[:b]))
        self.tok[:b].copy_(self.staging[:b], non_blocking=True)
        replay = self.replays.get(b)
        if replay is None:
            self.capture.warm(lambda: self._run(b))
            t0 = time.perf_counter()
            self.replays[b] = self.capture.capture(lambda: self._run(b))
            self.capture_s[b] = time.perf_counter() - t0
        else:
            replay()
        return self.logits[:b].to("cpu", copy=True).numpy()


class PrefillGraphs:
    """One captured prefill forward per ``(rows, length)`` shape.

    ``body(tok, last)`` runs the prefill forward of the first ``nb`` rows
    of the engine's static sub-cache on the int64 tokens ``tok [nb, L]``
    and returns the ``[nb, vocab]`` logits at positions ``last [nb]``.
    ``leaves`` and ``inputs`` are the sub-cache and its feature rows,
    whose tensors the graphs read and write in place (checked at every
    run, as :class:`DecodeGraphs` checks its leaves).  Each shape gets
    static token, position and logits buffers.  ``eager`` counts the
    prefills the engine ran outside the graphs by design, by reason.
    """

    def __init__(self, body: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor],
                 leaves: dict[str, torch.Tensor], *, vocab: int,
                 device: torch.device, capture,
                 inputs: dict[str, torch.Tensor]):
        self.body = body
        self.leaves = leaves
        self.inputs = inputs
        self.vocab = vocab
        self.device = device
        self.capture = capture
        self._ptrs = self._leaf_ptrs()
        self.buffers: dict[tuple[int, int], tuple[torch.Tensor, ...]] = {}
        self.replays: dict[tuple[int, int], Callable[[], None]] = {}
        self.capture_s: dict[tuple[int, int], float] = {}
        self.runs: dict[tuple[int, int], int] = {}
        self.eager: dict[str, int] = {}

    def _leaf_ptrs(self) -> dict[str, int]:
        return {**{name: t.data_ptr() for name, t in self.leaves.items()},
                **{f"inputs.{name}": t.data_ptr()
                   for name, t in self.inputs.items()}}

    def count_eager(self, reason: str) -> None:
        self.eager[reason] = self.eager.get(reason, 0) + 1

    def _stage(self, dst: torch.Tensor, src: np.ndarray) -> None:
        """Host array -> static device buffer: through a pinned copy on
        the card (the host allocator keeps it until the copy has run)."""
        host = torch.from_numpy(src)
        if self.device.type == "cuda":
            dst.copy_(host.pin_memory(), non_blocking=True)
        else:
            dst.copy_(host)

    def run(self, tokens: np.ndarray, last: np.ndarray) -> torch.Tensor:
        """The prefill of ``tokens [nb, L]`` with logits at ``last [nb]``
        on the current stream; returns the static ``[nb, vocab]`` f32
        logits buffer of the shape (valid until its next run)."""
        if self._leaf_ptrs() != self._ptrs:
            raise RuntimeError(
                "a prefill sub-cache leaf or an input was reassigned after "
                "the prefill graphs were set up; the graphs would read the "
                "old tensors")
        key = tokens.shape
        bufs = self.buffers.get(key)
        if bufs is None:
            nb, L = key
            bufs = self.buffers[key] = (
                torch.zeros((nb, L), dtype=torch.int64, device=self.device),
                torch.zeros((nb,), dtype=torch.int64, device=self.device),
                torch.zeros((nb, self.vocab), dtype=torch.float32,
                            device=self.device))
        tok, pos, out = bufs
        self._stage(tok, np.ascontiguousarray(tokens, np.int64))
        self._stage(pos, np.ascontiguousarray(last, np.int64))

        def fwd() -> None:
            out.copy_(self.body(tok, pos))

        replay = self.replays.get(key)
        if replay is None:
            self.capture.warm(fwd)
            t0 = time.perf_counter()
            self.replays[key] = self.capture.capture(fwd)
            self.capture_s[key] = time.perf_counter() - t0
        else:
            replay()
        self.runs[key] = self.runs.get(key, 0) + 1
        return out
