"""Collectives of the sharded port (counterpart of
``repro/distributed/collectives.py``).

Two kinds:

* the model's own, which the reference's GSPMD inserted: a partial sum
  all-reduced over the 'model' group (:func:`all_reduce_sum`, or
  :class:`Reduction` issued now and awaited later, the deferred FFN
  combine), and a vocab-sharded tensor all-gathered
  (:func:`all_gather_cat`).  Partials are summed in f32 and cast back
  once, so every rank gets the same bits;
* the data-parallel gradient mean with a compressed payload
  (:func:`compressed_psum_mean`: ``"none"``, ``"bf16"``, ``"int8"`` with
  an error-feedback residual that stays on the rank), for training.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


class Reduction:
    """``t`` summed over ``group`` in f32: issued at construction (with
    ``async_op``, not waited for), the sum in ``t``'s dtype from
    :meth:`wait`.  The sum lands in a copy: ``t`` is left as it was."""

    def __init__(self, t: torch.Tensor, group, *, async_op: bool = False):
        self.dtype = t.dtype
        self.buf = t.to(torch.float32, memory_format=torch.contiguous_format,
                        copy=True)
        self.work = dist.all_reduce(self.buf, group=group,
                                    async_op=async_op)

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            self.work = None
        return self.buf.to(self.dtype)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    return Reduction(t, group).wait()


def all_gather_cat(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated in rank order along
    ``dim``."""
    t = t.contiguous()
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


# --------------------------------------------------------------------------
# Gradient compression
# --------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 (the reference's, bit for bit): scale =
    max|x| / 127 + 1e-12 in f32, codes = clip(round(x / scale))."""
    x = x.float()
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(grads):
    """A zero f32 residual for every leaf of ``grads``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                           device=g.device), grads)


def compressed_psum_mean(grads, group, method: str = "none",
                         error_feedback=None):
    """Mean of ``grads`` (a tree of tensors) over ``group``'s ranks with a
    compressed payload; returns ``(synced, new_error_feedback)``.

    ``"none"``: an f32 all-reduce; ``"bf16"``: a bf16 all-reduce, the
    mean in f32; ``"int8"``: each rank quantizes ``g + residual``, keeps
    the new residual, and all-gathers codes and scales (peers' scales
    differ, so codes cannot be summed): each peer dequantized, summed in
    rank order."""
    n = dist.get_world_size(group)
    if method == "none":
        def one(g):
            buf = g.float().clone()
            dist.all_reduce(buf, group=group)
            return buf / n
        return tree_map(one, grads), error_feedback
    if method == "bf16":
        def one(g):
            buf = g.to(torch.bfloat16).clone()
            dist.all_reduce(buf, group=group)
            return buf.float() / n
        return tree_map(one, grads), error_feedback
    if method == "int8":
        ef = error_feedback or init_error_feedback(grads)

        def one(g, e):
            target = g.float() + e
            q, scale = quantize_int8(target)
            new_e = target - dequantize_int8(q, scale)   # stays here
            qs = [torch.empty_like(q) for _ in range(n)]
            dist.all_gather(qs, q, group=group)
            ss = [torch.empty_like(scale.reshape(1)) for _ in range(n)]
            dist.all_gather(ss, scale.reshape(1), group=group)
            total = qs[0].float() * ss[0]
            for qw, sw in zip(qs[1:], ss[1:]):
                total = total + qw.float() * sw
            return total / n, new_e

        return _split_pairs(tree_map(one, grads, ef))
    raise ValueError(method)


def _split_pairs(tree):
    """A tree (dicts, lists) of ``(out, residual)`` pairs as two trees."""
    if isinstance(tree, dict):
        parts = {k: _split_pairs(v) for k, v in tree.items()}
        return ({k: p[0] for k, p in parts.items()},
                {k: p[1] for k, p in parts.items()})
    if isinstance(tree, list):
        parts = [_split_pairs(v) for v in tree]
        return [p[0] for p in parts], [p[1] for p in parts]
    return tree
