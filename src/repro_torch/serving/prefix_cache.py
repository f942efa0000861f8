"""Shared-prefix KV reuse: a radix index over token ids whose nodes own
refcounted KV segments (counterpart of ``repro/serving/prefix_cache.py``).

Multi-tenant traffic shares system prompts and few-shot preambles, and
every prefill GEMV re-streams weight bytes; the cheapest prefill is the one
that never runs.  This module keeps the KV a prefill produced, keyed by the
token ids that produced it, and hands it back to any later request whose
prompt starts with the same tokens.

A radix tree (path-compressed trie) over token ids.  Each non-root node
owns one **segment**: the edge's token span plus

* ``kv`` -- the positional cache leaves for that span
  (``kv_cache.POSITIONAL_LEAVES``: k / v and, under a quantized store,
  their scales), ``[L, span, ...]`` tensors on the engine's device;
  pure-attention families may match partway into an edge;
* ``state`` -- an optional recurrent-state snapshot valid only after
  exactly the tokens up to this node's end, so state-carrying families
  match at node boundaries that hold one (``has_state``).

Lifecycle: ``match`` walks the longest cached prefix, ``acquire`` pins the
path, ``gather`` concatenates its spans along positions into one splice
payload, ``SlotKVCache.splice_prefix`` writes it into the slot, the tail
prefills through the chunked-prefill seam, ``release`` unpins on finish or
eviction.  ``insert`` files freshly prefilled KV (walking existing nodes
dedups shared spans; a partial overlap splits the edge).

Eviction: zero-refcount leaves, LRU first, when ``capacity_bytes`` would
be exceeded; a pinned segment is never dropped and an interior node is
pinned by its children.

A torch slice is a view that keeps its whole parent alive, where the JAX
package's slice is a copy: a segment that owns part of a payload (an
insert past an existing prefix, either side of a split) owns a copy of its
span, so the bytes the store holds are the bytes it accounts.

One deliberate difference from the reference: an insert never evicts the
node it attaches its new segment to (:meth:`PrefixCache._make_room`).

With a tracer installed, every eviction is a ``prefix_evict`` event.

Under a mesh each rank's store holds its shard of every segment: a
segment is cut from the rank's slot cache, so it holds the rank's kv
heads, the block ``distributed.sharding.segment_spec`` gives of the
unsharded segment, and a splice is local to the shard.  Every rank must
take the same decisions: the
index is the same on every rank, and capacity and eviction count global
bytes, a rank's bytes of each leaf times its ``byte_scale`` (the blocks
the leaf is cut into, ``SlotKVCache.scales``: K/V and a recurrent
state's leaves may be cut while another leaf is whole), never the
rank's share.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.observability.trace import current_tracer

__all__ = [
    "PrefixCache", "PrefixCacheConfig", "PrefixMatch", "prefix_cacheable",
]


def prefix_cacheable(cfg) -> bool:
    """Whether a family's KV is a pure function of the token prefix
    (encoder and cross-attention families fold per-request features into
    the decoder pass, so token-keyed reuse would be unsound)."""
    return (getattr(cfg, "encoder", None) is None
            and getattr(cfg, "cross_attn_every", 0) == 0)


@dataclass(frozen=True)
class PrefixCacheConfig:
    # device bytes the segment store may hold; inserts evict LRU zero-ref
    # segments to fit and are skipped (counted) when pinned segments leave
    # no room.  None: unbounded.
    capacity_bytes: int | None = 64 * 2 ** 20
    # shortest prefix worth caching
    min_tokens: int = 2


def _span(leaf: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Positions ``[start, stop)`` of a ``[L, S, ...]`` leaf: the leaf
    itself when that is all of it, else a copy (module docstring)."""
    if start == 0 and stop == leaf.shape[1]:
        return leaf
    return leaf[:, start:stop].clone()


class _Node:
    """One radix-tree edge and the KV segment it owns."""

    __slots__ = ("tokens", "kv", "state", "children", "parent",
                 "refcount", "last_used", "nbytes", "scale")

    def __init__(self, tokens: np.ndarray, kv: dict, state: dict | None,
                 parent: "_Node | None", scale: dict | None = None):
        self.tokens = np.asarray(tokens, np.int32)
        self.kv = kv
        self.state = state
        self.children: dict[int, _Node] = {}
        self.parent = parent
        self.refcount = 0
        self.last_used = 0
        self.scale = scale
        self.nbytes = _payload_bytes(kv, state, scale)

    def recount_bytes(self) -> None:
        self.nbytes = _payload_bytes(self.kv, self.state, self.scale)


def _payload_bytes(kv: dict, state: dict | None,
                   scale: dict | None = None) -> int:
    """A payload's bytes, each leaf's times its scale ({leaf: scale}; 1
    for a leaf it does not name)."""
    scale = scale or {}
    n = sum(scale.get(k, 1) * leaf.nbytes for k, leaf in (kv or {}).items())
    if state:
        n += sum(scale.get(k, 1) * leaf.nbytes for k, leaf in state.items())
    return int(n)


def _common_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n


@dataclass
class PrefixMatch:
    """A longest-prefix match: the node path, the span of each node used
    (only the last may be partial, pure-KV families only), the total."""

    length: int
    nodes: list = field(default_factory=list)
    spans: list = field(default_factory=list)


class PrefixCache:
    """Radix index + refcounted segment store (one per engine)."""

    def __init__(self, config: PrefixCacheConfig | None = None, *,
                 has_state: bool = False, byte_scale: dict | None = None):
        self.config = config or PrefixCacheConfig()
        self.has_state = has_state
        self.byte_scale = byte_scale
        self.root = _Node(np.zeros((0,), np.int32), {}, None, None)
        self._tick = 0
        self._bytes = 0
        self._segments = 0
        self.counters = {
            "hits": 0, "misses": 0, "hit_tokens": 0, "inserted_tokens": 0,
            "inserts": 0, "evictions": 0, "insert_skipped": 0,
        }

    # -- introspection -------------------------------------------------------

    @property
    def bytes_used(self) -> int:
        return self._bytes

    @property
    def n_segments(self) -> int:
        return self._segments

    def stats(self) -> dict:
        c = self.counters
        lookups = c["hits"] + c["misses"]
        return {
            **c,
            "hit_rate": (c["hits"] / lookups) if lookups else 0.0,
            "segments": self._segments,
            "bytes": self._bytes,
            "capacity_bytes": self.config.capacity_bytes,
        }

    def _walk(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self.root:
                yield node

    # -- match ---------------------------------------------------------------

    def _match_path(self, tokens: np.ndarray) -> PrefixMatch:
        # at least one tail token remains: its prefill gives the logits the
        # first sampled token comes from
        cap = len(tokens) - 1
        m = PrefixMatch(0)
        if cap <= 0:
            return m
        node, i = self.root, 0
        while i < cap:
            child = node.children.get(int(tokens[i]))
            if child is None:
                break
            span = _common_len(child.tokens, tokens[i:cap])
            if span == 0:
                break
            if span < len(child.tokens) and self.has_state:
                break           # no snapshot mid-edge
            m.nodes.append(child)
            m.spans.append(span)
            i += span
            node = child
            if span < len(child.tokens):
                break
        if self.has_state:
            # resume needs the last node's snapshot: back off to the
            # deepest node that holds one
            while m.nodes and m.nodes[-1].state is None:
                m.nodes.pop()
                m.spans.pop()
        m.length = int(sum(m.spans))
        return m

    def match_len(self, tokens) -> int:
        """Longest cached-prefix length of ``tokens``: a pure probe (no
        counters, no LRU touch) the scheduler prices admission with."""
        return self._match_path(np.asarray(tokens, np.int32)).length

    def match(self, tokens) -> PrefixMatch | None:
        """Longest cached prefix of ``tokens``; None on a miss or a match
        shorter than ``min_tokens``.  Counts and touches the LRU."""
        m = self._match_path(np.asarray(tokens, np.int32))
        self._tick += 1
        if m.length < self.config.min_tokens:
            self.counters["misses"] += 1
            return None
        self.counters["hits"] += 1
        self.counters["hit_tokens"] += m.length
        for node in m.nodes:
            node.last_used = self._tick
        return m

    # -- refcounts -----------------------------------------------------------

    def acquire(self, m: PrefixMatch) -> None:
        """Pin every segment on the match path while a slot uses it."""
        for node in m.nodes:
            node.refcount += 1
            node.last_used = self._tick

    def release(self, m: PrefixMatch) -> None:
        for node in m.nodes:
            node.refcount -= 1
            if node.refcount < 0:
                raise AssertionError(
                    f"segment refcount went negative at {node.tokens[:8]}")

    # -- splice payload ------------------------------------------------------

    def gather(self, m: PrefixMatch) -> dict:
        """The match path's segments as one splice payload (the format of
        ``SlotKVCache.splice_prefix``), concatenated along positions."""
        kv: dict = {}
        if m.nodes:
            for name in m.nodes[0].kv:
                parts = [node.kv[name][:, :span]
                         for node, span in zip(m.nodes, m.spans)]
                kv[name] = (parts[0] if len(parts) == 1
                            else torch.cat(parts, dim=1))
        state = m.nodes[-1].state if (m.nodes and self.has_state) else {}
        return {"kv": kv, "state": state or {}}

    # -- insert --------------------------------------------------------------

    def insert(self, tokens, payload: dict) -> bool:
        """File a prefilled stream's KV (``SlotKVCache.extract_prefix`` of
        exactly ``len(tokens)`` positions) into the tree.  Returns False
        when pinned segments leave no room (counted, not an error)."""
        tokens = np.asarray(tokens, np.int32)
        T = len(tokens)
        if T < self.config.min_tokens:
            return False
        kv, state = payload["kv"], payload["state"]
        self._tick += 1
        node, i = self.root, 0
        while i < T:
            child = node.children.get(int(tokens[i]))
            if child is None:
                seg_kv = {name: _span(leaf, i, T)
                          for name, leaf in kv.items()}
                seg_state = dict(state) if (self.has_state and state) else None
                new = _Node(tokens[i:T], seg_kv, seg_state, node,
                            self.byte_scale)
                if not self._make_room(new.nbytes, keep=node):
                    self.counters["insert_skipped"] += 1
                    return False
                new.last_used = self._tick
                node.children[int(tokens[i])] = new
                self._bytes += new.nbytes
                self._segments += 1
                self.counters["inserts"] += 1
                self.counters["inserted_tokens"] += T - i
                return True
            span = _common_len(child.tokens, tokens[i:T])
            if span < len(child.tokens):
                self._split(child, span)
                child = node.children[int(tokens[i])]
            child.last_used = self._tick
            node = child
            i += span
        # the stream ends at an existing boundary: attach the state
        # snapshot if that boundary lacks one (a split dropped it)
        if self.has_state and state and node is not self.root \
                and node.state is None:
            extra = _payload_bytes({}, state, self.byte_scale)
            if self._make_room(extra, keep=node):
                node.state = dict(state)
                node.recount_bytes()
                self._bytes += extra
        return True

    def _split(self, child: _Node, at: int) -> None:
        """Split ``child``'s edge at ``at``: a new interior node takes the
        leading span (no snapshot mid-edge), the old node keeps the rest,
        its children, snapshot and refcount."""
        assert 0 < at < len(child.tokens)
        old_bytes = child.nbytes
        top_kv = {n: _span(leaf, 0, at) for n, leaf in child.kv.items()}
        top = _Node(child.tokens[:at], top_kv, None, child.parent,
                    self.byte_scale)
        top.last_used = child.last_used
        child.parent.children[int(child.tokens[0])] = top
        rest = child.tokens[at:]
        child.kv = {n: _span(leaf, at, leaf.shape[1])
                    for n, leaf in child.kv.items()}
        child.tokens = rest
        child.parent = top
        child.recount_bytes()
        top.children[int(rest[0])] = child
        self._bytes += top.nbytes + child.nbytes - old_bytes
        self._segments += 1

    # -- eviction ------------------------------------------------------------

    def _evictable(self) -> list:
        """Zero-ref leaves (an interior node is pinned by its children)."""
        return [n for n in self._walk()
                if not n.children and n.refcount == 0]

    def _evict_one(self) -> bool:
        victims = self._evictable()
        if not victims:
            return False
        victim = min(victims, key=lambda n: (n.last_used, -n.nbytes))
        victim.parent.children.pop(int(victim.tokens[0]))
        self._bytes -= victim.nbytes
        self._segments -= 1
        self.counters["evictions"] += 1
        tr = current_tracer()
        if tr is not None:
            # capacity churn in the trace: when the store started evicting,
            # not just the final count
            tr.event("prefix_evict", cat="prefix_cache",
                     bytes=victim.nbytes, tokens=len(victim.tokens))
        return True

    def _make_room(self, incoming: int, keep: _Node | None = None) -> bool:
        """Evict until ``incoming`` bytes fit.  ``keep`` (the node an
        insert attaches to) is pinned meanwhile: the reference may evict
        it while it is a leaf and attach the new segment to the detached
        node, which then counts in ``bytes_used`` with nothing to evict."""
        cap = self.config.capacity_bytes
        if cap is None:
            return True
        if keep is not None:
            keep.refcount += 1
        try:
            while self._bytes + incoming > cap:
                if not self._evict_one():
                    return False
            return True
        finally:
            if keep is not None:
                keep.refcount -= 1

    def evict_to(self, target_bytes: int) -> int:
        """Shrink the store to ``target_bytes`` (memory-pressure hook);
        returns the segments evicted.  Pinned segments survive."""
        n = 0
        while self._bytes > target_bytes and self._evict_one():
            n += 1
        return n
