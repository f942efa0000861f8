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

Unlike the JAX package, whose arrays are immutable, every mutation here
writes the cache tensors IN PLACE: a full-size copy per splice or decode
step would move the whole KV store (over 1 GB for olmo-1b at 8 slots x 1024
positions) for every token.  :meth:`slice_prefix` therefore returns views,
the model's forward writes new K/V through them, and :meth:`merge_prefix`
only has to copy what is not already shared (``pos``).
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


class SlotKVCache:
    """Decode state for ``batch_slots`` concurrent requests."""

    def __init__(self, cfg: ModelConfig, batch_slots: int, max_len: int,
                 dtype=None, *, kv_store: str = "fp", device):
        self.cfg = cfg
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.device = torch.device(device)
        self.cache = lm.init_cache(cfg, batch_slots, max_len, dtype,
                                   per_slot_pos=True, kv_store=kv_store,
                                   device=self.device)
        self._free: list[int] = list(range(batch_slots))
        self._active: set[int] = set()

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
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        self._active.remove(slot)
        bisect.insort(self._free, slot)

    def kv_valid_len(self) -> np.ndarray:
        """Host copy of the per-slot valid-kv lengths (the ``pos`` vector)."""
        return self.cache["pos"].cpu().numpy()

    # -- batched prefill splice ---------------------------------------------

    def splice(self, sub_cache: dict, slots: list[int],
               lengths: list[int]) -> None:
        """Write an ``n``-row prefill cache into ``slots`` and set each
        slot's ``pos`` to its true length; rows of ``sub_cache`` beyond
        ``len(slots)`` are batch padding and are dropped."""
        n = len(slots)
        if n != len(lengths):
            raise ValueError(f"{n} slots but {len(lengths)} lengths")
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        for name, leaf in self.cache.items():
            if name == "pos":
                leaf[idx] = torch.as_tensor(lengths, dtype=leaf.dtype,
                                            device=self.device)
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
        return moves
