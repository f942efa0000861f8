"""Slot-managed KV cache with per-slot position vectors (counterpart of
``repro/serving/kv_cache.py::SlotKVCache``).

The cache dict keeps the JAX layout: ``pos`` is a ``[B]`` int32 vector
(one write offset / valid-kv length per slot) and every other leaf is
``[L, B, ...]`` with batch on axis 1 -- with ``kv_store="int8"`` /
``"int4"`` that includes the ``k_scale`` / ``v_scale`` leaves, which ride
through every mutation below exactly like ``k`` / ``v``.

* **alloc/free** -- slots are handed out lowest-first and returned to a
  sorted free list;
* **defrag** (:meth:`compact`) -- active slots are kept a contiguous prefix
  ``[0, n_active)`` so the engine decodes a power-of-two bucket of them;
* **batched prefill splicing** (:meth:`splice`) -- one right-padded prefill
  over ``n`` requests lands in ``n`` slots with ``pos`` set to the true
  prompt lengths (pad KV beyond a slot's length is masked by
  ``kv_valid_len`` and overwritten as decode advances).

* **the prefix-cache seam** (:meth:`extract_prefix` / :meth:`splice_prefix`)
  -- a slot's leading KV span goes out to a shared segment and back, in
  the cache's own ``kv_store`` format (codes and scales of a quantized
  store), bit for bit.

* **recurrent state** (rwkv6's ``rwkv_*`` leaves: every leaf that is
  neither ``pos`` nor positional) -- :meth:`zero_state` clears a slot's
  state before a fresh prompt runs on its row, and :meth:`save_state` /
  :meth:`restore_state` carry the rows of slots mid-prefill across a
  decode step that covers them, through buffers allocated once (no K/V
  leaf is ever copied for it).

Host-side per-slot metadata (``slot_meta``, one dict per active slot: the
prefix cache keeps its segment pins there) moves with its slot through
:meth:`compact` and is dropped on :meth:`free`.

Under a mesh (``mesh=``) the cache holds this rank's block of each leaf
(``distributed.sharding.slot_cache_spec``): the slot axis and ``pos``
whole on every rank, K/V and their scales on the rank's kv heads when
they divide the 'model' axis (else every kv head), rwkv6's wkv state on
the rank's heads and hymba's Mamba state and conv window on its ``di``
channels (the token-shift carries whole).  Every mutation below is then
local to the shard, as the reference's explicit shardings make it: no
defrag or splice moves data between ranks.  ``scales`` gives each
leaf's count of blocks, by which a segment's bytes are the unsharded
segment's.

Unlike the JAX package, whose arrays are immutable, every mutation here
writes the cache tensors IN PLACE and no leaf is ever reassigned (the
decode step's captured graphs keep their addresses): a full-size copy per
splice or decode step would move the whole KV store (over 1 GB for olmo-1b
at 8 slots x 1024 positions) for every token.  :meth:`slice_prefix` and
:meth:`slot_view` therefore return views, the model's forward writes new
K/V through them, and :meth:`merge_prefix` / :meth:`splice` only copy
what is not already the destination's own memory.  Where the JAX package
relies on a slice being a copy, the port copies explicitly:
:meth:`extract_prefix` returns clones, or the slot's next occupant would
overwrite the segment.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm

# Cache leaves with a per-position axis ``[L, B, S, ...]``: the span a
# shared-prefix segment owns.  Everything else (minus ``pos`` and 1-D
# per-slot vectors) is recurrent state, snapshotted whole.
POSITIONAL_LEAVES = ("k", "v", "k_scale", "v_scale")


def _row(leaf: torch.Tensor, slot: int) -> torch.Tensor:
    """Slot ``slot``'s row of a leaf as a one-slot view (batch axis kept)."""
    return leaf[slot:slot + 1] if leaf.ndim == 1 else leaf[:, slot:slot + 1]


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when ``a`` is exactly the memory ``b`` views (same start,
    shape and strides): copying one into the other would be a no-op on
    overlapping memory."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


class SlotKVCache:
    """Decode state for ``batch_slots`` concurrent requests."""

    def __init__(self, cfg: ModelConfig, batch_slots: int, max_len: int,
                 dtype=None, *, kv_store: str = "fp", device, mesh=None):
        self.cfg = cfg
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.device = torch.device(device)
        self.cache = lm.init_cache(cfg, batch_slots, max_len, dtype,
                                   per_slot_pos=True, kv_store=kv_store,
                                   device=self.device, mesh=mesh)
        # the ranks each leaf is cut into: a rank's bytes of a leaf times
        # its scale are the unsharded leaf's (the prefix cache's count)
        self.scales = {name: 1 for name in self.cache}
        if mesh is not None:
            from repro_torch.distributed.sharding import slot_cache_scales

            whole = lm.init_cache(cfg, batch_slots, max_len, dtype,
                                  per_slot_pos=True, kv_store=kv_store,
                                  device="meta")
            self.scales = slot_cache_scales(
                mesh, cfg, {k: tuple(v.shape) for k, v in whole.items()})
        # the state leaves, and one save buffer each (empty for a pure-KV
        # family): a decode step over a row mid-prefill must leave it as
        # it was
        self.state_names = tuple(
            name for name, leaf in self.cache.items()
            if name != "pos" and name not in POSITIONAL_LEAVES
            and leaf.ndim > 1)
        self._saved = {name: torch.empty_like(self.cache[name])
                       for name in self.state_names}
        self._free: list[int] = list(range(batch_slots))
        self._active: set[int] = set()
        # opaque per-slot metadata: moves with compact(), dropped on free()
        self.slot_meta: dict[int, dict] = {}

    # -- slot lifecycle ------------------------------------------------------

    @property
    def n_active(self) -> int:
        return len(self._active)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def active_slots(self) -> tuple[int, ...]:
        return tuple(sorted(self._active))

    def alloc(self) -> int:
        """Claim the lowest free slot (keeps the active set near-prefix)."""
        if not self._free:
            raise RuntimeError("no free KV-cache slots")
        slot = self._free.pop(0)
        self._active.add(slot)
        self.slot_meta[slot] = {}
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        self._active.remove(slot)
        self.slot_meta.pop(slot, None)
        bisect.insort(self._free, slot)

    def kv_valid_len(self) -> np.ndarray:
        """Host copy of the per-slot valid-kv lengths (the ``pos`` vector)."""
        return self.cache["pos"].cpu().numpy()

    # -- recurrent state -----------------------------------------------------

    def zero_state(self, slot: int) -> None:
        """Clear slot ``slot``'s state leaves in place (a fresh prompt's
        first chunk on a row an earlier occupant, or the decode steps of a
        free row, left state in)."""
        for name in self.state_names:
            self.cache[name][:, slot].zero_()

    def save_state(self, slots) -> None:
        """Copy the state rows of ``slots`` into the save buffers."""
        for name in self.state_names:
            for s in slots:
                self._saved[name][:, s].copy_(self.cache[name][:, s])

    def restore_state(self, slots) -> None:
        """Put back the state rows of ``slots`` that :meth:`save_state`
        copied, bit for bit."""
        for name in self.state_names:
            for s in slots:
                self.cache[name][:, s].copy_(self._saved[name][:, s])

    # -- batched prefill splice ---------------------------------------------

    def splice(self, sub_cache: dict, slots: list[int],
               lengths: list[int]) -> None:
        """Write an ``n``-row prefill cache into ``slots`` and set each
        slot's ``pos`` to its true length; rows of ``sub_cache`` beyond
        ``len(slots)`` are batch padding and are dropped.  A one-slot
        ``sub_cache`` whose leaves are that slot's own rows (a chunk run on
        :meth:`slot_view`, written in place) only has ``pos`` set."""
        n = len(slots)
        if n != len(lengths):
            raise ValueError(f"{n} slots but {len(lengths)} lengths")
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        for name, leaf in self.cache.items():
            if name == "pos":
                leaf[idx] = torch.as_tensor(lengths, dtype=leaf.dtype,
                                            device=self.device)
            elif n == 1 and _same_memory(sub_cache[name],
                                         _row(leaf, slots[0])):
                continue
            elif leaf.ndim == 1:
                leaf[idx] = sub_cache[name][:n].to(leaf.dtype)
            else:
                leaf[:, idx] = sub_cache[name][:, :n].to(leaf.dtype)

    # -- decode-prefix views -------------------------------------------------

    def slice_prefix(self, b: int) -> dict:
        """The first ``b`` slots as a cache dict of VIEWS: a forward over it
        writes its K/V straight into this cache."""
        return {name: (leaf[:b] if leaf.ndim == 1 else leaf[:, :b])
                for name, leaf in self.cache.items()}

    def slot_view(self, slot: int) -> dict:
        """One slot as a one-slot cache dict of VIEWS: a forward over it
        writes the slot in place, and :meth:`splice` of it only sets
        ``pos``.  (The engine's chunks run on its prefill sub-cache.)"""
        return {name: _row(leaf, slot) for name, leaf in self.cache.items()}

    # -- prefix-cache segment seam ---------------------------------------------

    def extract_prefix(self, slot: int, length: int) -> dict:
        """Slot ``slot``'s leading ``length`` positions as a segment
        payload ``{"kv": {leaf: [L, length, ...]}, "state": {leaf: [L,
        ...]}}``, in the cache's own store format.  Every tensor is a COPY
        (a view would change under the slot's next occupant and under the
        decode step's in-place writes)."""
        kv, state = {}, {}
        for name, leaf in self.cache.items():
            if name == "pos" or leaf.ndim == 1:
                continue
            if name in POSITIONAL_LEAVES:
                kv[name] = leaf[:, slot, :length].clone()
            else:
                state[name] = leaf[:, slot].clone()
        return {"kv": kv, "state": state}

    def splice_prefix(self, slot: int, payload: dict, length: int) -> None:
        """Write a segment payload into slot ``slot`` over positions ``[0,
        length)`` and set its ``pos`` to ``length``, in place (the prefix
        hit's fast path; the tail then prefills from the slot's row).
        Positions past ``length`` keep whatever they held: attention masks
        them and the tail's prefill overwrites them."""
        for name, leaf in self.cache.items():
            if name == "pos":
                leaf[slot].fill_(length)
            elif leaf.ndim == 1:
                continue
            elif name in POSITIONAL_LEAVES:
                leaf[:, slot, :length].copy_(payload["kv"][name])
            else:
                leaf[:, slot].copy_(payload["state"][name])

    def merge_prefix(self, new_cache: dict, b: int) -> None:
        """Write a decoded ``b``-slot prefix back: leaves that are views of
        this cache (what :meth:`slice_prefix` handed out) were already
        written in place; anything else is copied."""
        for name, leaf in self.cache.items():
            dst = leaf[:b] if leaf.ndim == 1 else leaf[:, :b]
            src = new_cache[name]
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)

    # -- defrag --------------------------------------------------------------

    def compact(self) -> dict[int, int]:
        """Move active slots down into free holes until the active set is
        the contiguous prefix ``[0, n_active)``; one batched gather/scatter
        per leaf.  Returns ``{src: dst}`` for every moved slot."""
        moves: dict[int, int] = {}
        while self._free and self._active:
            dst = self._free[0]
            src = max(self._active)
            if dst > src:
                break
            self._free.pop(0)
            self._active.remove(src)
            self._active.add(dst)
            bisect.insort(self._free, src)
            moves[src] = dst
        if moves:
            srcs = torch.as_tensor(list(moves), dtype=torch.long,
                                   device=self.device)
            dsts = torch.as_tensor(list(moves.values()), dtype=torch.long,
                                   device=self.device)
            # every src > every dst: the index sets are disjoint
            for leaf in self.cache.values():
                if leaf.ndim == 1:
                    leaf[dsts] = leaf[srcs]
                else:
                    leaf[:, dsts] = leaf[:, srcs]
            for src, dst in moves.items():
                self.slot_meta[dst] = self.slot_meta.pop(src, {})
        return moves
