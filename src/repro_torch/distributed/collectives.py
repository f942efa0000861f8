"""Collectives of the sharded port (counterpart of
``repro/distributed/collectives.py``).

Three kinds:

* the model's own, which the reference's GSPMD inserted: a partial sum
  all-reduced over the 'model' group (:func:`all_reduce_sum`, or
  :class:`Reduction` issued now and awaited later, the deferred FFN
  combine), and a vocab-sharded tensor all-gathered
  (:func:`all_gather_cat`).  Partials are summed in f32 and cast back
  once, so every rank gets the same bits;
* their backwards, for training on a 'model' axis (the pattern of
  Megatron-LM's tensor parallelism).  Where autograd records through
  them, :func:`all_reduce_sum` and :func:`all_gather_cat` are autograd
  ops whose backward passes the gradient on (``reduce``: identity) or
  keeps this rank's block of it (``gather``), and :func:`enter` marks
  where a replicated tensor goes into a rank's block: identity forward,
  the gradient summed over the group backward.  With the loss replicated
  over 'model', ``torch.distributed.nn``'s collectives, whose backwards
  all-reduce the gradient, would count it once a rank.  Their forwards
  are the plain collectives' bit for bit;
* the 'data' side of training: the FSDP blocks gathered
  (:func:`all_gather_cat` under no grad) and the gradient mean reduced to
  each rank's block (:func:`reduce_scatter_mean`), and the data-parallel
  gradient mean with a compressed payload (:func:`compressed_psum_mean`:
  ``"none"``, ``"bf16"``, ``"int8"`` with an error-feedback residual that
  stays on the rank).

The counting mode (:func:`counting`, the counterpart of the reference's
``parse_collective_bytes`` over post-SPMD HLO, for ``launch.dryrun``):
a mesh *description* (shape and coordinates, no processes) gets a
:class:`CountedGroup` for each axis and for the data axes' product.  A
collective over such a group communicates nothing and returns a tensor
of the right shape: an all-reduce its input's values, an all-gather
``n`` copies of the input concatenated, :func:`reduce_scatter_mean` the
rank's slice; and it records its kind and its per-participant result
bytes (:class:`CollectiveCount`).  A real process group takes the same
code as without the mode.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


# --------------------------------------------------------------------------
# The counting mode
# --------------------------------------------------------------------------


class CollectiveCount:
    """The collectives a counting run issued: ``calls`` and ``bytes`` by
    kind (``"all-reduce"``, ``"all-gather"``: the reference's HLO names),
    each call's per-participant result bytes, as the reference counts
    them.  The port's :func:`reduce_scatter_mean` is an all-reduce of the
    whole f32 buffer and a slice, and is counted as what it sends."""

    def __init__(self):
        self.bytes: dict[str, int] = {}
        self.calls: dict[str, int] = {}
        self.open = True

    def record(self, kind: str, nbytes: int) -> None:
        if not self.open:
            raise RuntimeError("a counted group used after its counting "
                               "run ended")
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.calls[kind] = self.calls.get(kind, 0) + 1

    @property
    def total(self) -> int:
        return sum(self.bytes.values())


@dataclasses.dataclass(frozen=True, eq=False)
class CountedGroup:
    """A process group as a description, for the counting mode: the mesh
    axes it spans (``axes``), its ``size`` and this rank's index in it
    (pod-major over several axes), and the :class:`CollectiveCount` its
    collectives record into."""

    axes: tuple
    size: int
    rank: int
    count: CollectiveCount


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def group_size(group) -> int:
    """The ranks of ``group`` (a process group or a :class:`CountedGroup`)."""
    if isinstance(group, CountedGroup):
        return group.size
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group``."""
    if isinstance(group, CountedGroup):
        return group.rank
    return dist.get_rank(group)


def _all_reduce(buf: torch.Tensor, group, *, async_op: bool = False):
    """``dist.all_reduce`` of ``buf`` in place; over a counted group
    ``buf`` keeps its values and the call is recorded."""
    if isinstance(group, CountedGroup):
        group.count.record("all-reduce", _nbytes(buf))
        return None
    return dist.all_reduce(buf, group=group, async_op=async_op)


def _all_gather(parts: list, t: torch.Tensor, group) -> None:
    """``dist.all_gather`` of ``t`` into ``parts``; over a counted group
    every part is ``t`` and the call is recorded."""
    if isinstance(group, CountedGroup):
        group.count.record("all-gather", len(parts) * _nbytes(t))
        for p in parts:
            p.copy_(t)
        return
    dist.all_gather(parts, t, group=group)


@contextlib.contextmanager
def counting(mesh):
    """``(mesh', count)``: ``mesh`` (a description: its shape and this
    rank's coordinates; any process groups it holds are set aside) with a
    :class:`CountedGroup` for each axis, and for the data axes' product
    where it has a 'pod' axis, all recording into ``count``.  Run a step
    under ``activation_mesh(mesh')`` inside the block; after it the
    groups refuse every collective."""
    from repro_torch.launch.mesh import data_axes

    count = CollectiveCount()
    keys = list(mesh.axis_names)
    daxes = data_axes(mesh)
    if len(daxes) > 1:
        keys.append(daxes)
    groups = {k: CountedGroup(k if isinstance(k, tuple) else (k,),
                              mesh.size(k), mesh.index(k), count)
              for k in keys}
    try:
        yield dataclasses.replace(mesh, groups=groups), count
    finally:
        count.open = False


class Reduction:
    """``t`` summed over ``group`` in f32: issued at construction (with
    ``async_op``, not waited for), the sum in ``t``'s dtype from
    :meth:`wait`.  The sum lands in a copy: ``t`` is left as it was."""

    def __init__(self, t: torch.Tensor, group, *, async_op: bool = False):
        self.dtype = t.dtype
        self.buf = t.to(torch.float32, memory_format=torch.contiguous_format,
                        copy=True)
        self.work = _all_reduce(self.buf, group, async_op=async_op)

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            self.work = None
        return self.buf.to(self.dtype)


def records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records through an op on ``tensors``: grad mode
    is on and one of them requires grad (a training forward)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _sum_f32(t: torch.Tensor, group) -> torch.Tensor:
    return Reduction(t, group).wait()


def _gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(group_size(group))]
    _all_gather(parts, t, group)
    return torch.cat(parts, dim=dim)


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient summed over ``group`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """The f32 sum over ``group`` forward; identity backward (every rank
    holds the whole sum's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Every rank's block in rank order along ``dim`` forward; this
    rank's block of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        i = group_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (replicated over ``group``) as the input of this rank's
    block: ``x`` itself, and under autograd an op whose backward sums the
    rank blocks' gradients over ``group``."""
    return _Enter.apply(x, group) if records_grad(x) else x


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in f32, cast back once; under autograd
    its backward passes the gradient on unchanged."""
    if records_grad(t):
        return _Reduce.apply(t, group)
    return _sum_f32(t, group)


def all_gather_cat(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated in rank order along
    ``dim``; under autograd its backward keeps this rank's block of the
    gradient."""
    if records_grad(t):
        return _Gather.apply(t, group, dim)
    return _gather(t, group, dim)


def reduce_scatter_mean(t: torch.Tensor, group, dim: int | None
                        ) -> torch.Tensor:
    """The mean of ``t`` over ``group``'s ranks in f32, cast back to
    ``t``'s dtype; with ``dim`` this rank's block of it along ``dim``.
    An all-reduce and a slice: the same sum in the same order on every
    rank, whichever block it keeps (gloo's ``reduce_scatter_tensor`` is
    not relied on for CUDA tensors)."""
    buf = t.float().clone()
    _all_reduce(buf, group)
    buf = (buf / group_size(group)).to(t.dtype)
    if dim is None:
        return buf
    n, i = group_size(group), group_rank(group)
    size = t.shape[dim] // n
    return buf.narrow(dim, i * size, size).clone(
        memory_format=torch.contiguous_format)


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
    n = group_size(group)
    if method == "none":
        def one(g):
            buf = g.float().clone()
            _all_reduce(buf, group)
            return buf / n
        return tree_map(one, grads), error_feedback
    if method == "bf16":
        def one(g):
            buf = g.to(torch.bfloat16).clone()
            _all_reduce(buf, group)
            return buf.float() / n
        return tree_map(one, grads), error_feedback
    if method == "int8":
        ef = error_feedback or init_error_feedback(grads)

        def one(g, e):
            target = g.float() + e
            q, scale = quantize_int8(target)
            new_e = target - dequantize_int8(q, scale)   # stays here
            qs = [torch.empty_like(q) for _ in range(n)]
            _all_gather(qs, q, group)
            ss = [torch.empty_like(scale.reshape(1)) for _ in range(n)]
            _all_gather(ss, scale.reshape(1), group)
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
