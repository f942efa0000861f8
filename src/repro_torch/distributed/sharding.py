"""The PIMnast placement planner lifted to the device mesh (counterpart of
``repro/distributed/sharding.py``).

Per weight tensor, as in the reference (the paper's Algorithm 1 with the
chips along 'model' as its banks and exact divisibility as its
even-distribution test): row placement first (shard an OUTPUT dim: heads,
d_ff, experts, vocab), split-K (the contraction dim) when no output dim
divides, replication when nothing does; the 'data' axes take an FSDP dim.
:func:`plan_params`, :func:`plan_report`, the cache, serving-cache and
segment specs are the reference's functions, spec for spec: a spec is the
port's :class:`P`, a tuple of axis names (or None) per dim that compares
equal to the reference's ``PartitionSpec``.

The reference hands its specs to GSPMD, which partitions each op and
inserts the collectives.  The port holds each rank's block itself:

* :func:`shard_tensor` cuts this rank's block of one tensor by its spec;
  :func:`shard_packed` a quantized weight's (:func:`packed_axis`: M, or
  K on whole scale blocks only, as the planner places the float weight);
* :func:`shard_params` places a model's (prepacked) tree for serving:
  each leaf is ``shard_tensor`` of its :func:`serve_spec`, the planner's
  spec where it is the leaf's row placement (heads, FFN columns and the
  down projection's rows, whole experts, the vocab; an expert stack
  whose E the axis does not divide, on every expert's ``f``), else the
  leaf whole;
  whisper's encoder layers by the encoder's own heads and FFN width and
  a cross-attention layer by its heads (:func:`leaf_config`); a
  recurrent mixer's leaves by their path (:data:`STATE_LEAVES`: rwkv6's
  time-mix by its heads, channel-mix by ``d_ff``, hymba's Mamba mixer by
  its inner width, ``w_in`` as the pair ``[x1_r | z_r]``, a spec with
  ``pairs``);
  the slot cache (``serving.kv_cache``) holds :func:`slot_cache_spec`'s
  block (K/V by :func:`serve_cache_spec`, the recurrent state by name,
  the token-shift carries whole).  Deliberate differences from the
  reference, each named in
  :func:`serve_spec`: the fused leaves (``wqkv``, ``w_gateup``) keep the
  spec's axis and, where KV is sharded, its shard size, but a rank's
  block is ``[q_r | k_r | v_r]`` and ``[gate_r | up_r]`` (its own heads
  and FFN columns: one fused GEMV gives what the rank computes, where
  GSPMD reshards contiguous blocks at the activation anchors); parameters
  are replicated over 'data' (no FSDP shard is stored); the tiny-leaf
  rule does not apply; and a leaf placed on a fallback dim, or read whole
  by its layer (norm scales, the router), stays whole;
* for training, :func:`train_spec` stores each leaf as its 'model' block
  by :func:`serve_spec`, cut again over the data axes on ``_leaf_spec``'s
  FSDP dim (the first other dim their product divides; 'pod' folds into
  data parallelism: :func:`fsdp_entry`);
  :func:`shard_train_tree` / :func:`gather_train_tree` cut a full tree
  (params, optimizer state, or both) to a rank's blocks and put it
  back together (a paired leaf's parts put back side by side: full
  leaves are in the reference's layout), and :class:`TrainLayout` gives
  the optimizer the sums across the ranks that hold a leaf's other
  blocks.  Deliberate
  difference: the reference plans its stacked ``[L, ...]`` leaves as if
  unstacked (``wq`` gets 'model' on ``d``, ``w_up`` / ``w_down`` /
  ``wo`` on the layer dim), which GSPMD computes under; the port's
  explicit rank blocks need the row placement.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import all_gather_cat, all_reduce_sum
from repro_torch.kernels.ops import PackedWeights
from repro_torch.launch.mesh import data_axes
from repro_torch.tree import flatten_with_paths, leaves, unflatten_like


class P(tuple):
    """A partition spec: one entry per dim, an axis name, a tuple of axis
    names or None (the reference's ``PartitionSpec``, which compares equal
    to it element by element).

    ``pairs`` (the port's, for Mamba's ``w_in [d, 2 di]``): the dim cut on
    'model' is ``pairs`` equal parts side by side, and a rank's block is
    its block of each part in turn (``[x1_r | z_r]``), where a contiguous
    block would hold other ranks' channels; equality ignores it."""

    pairs = 1

    def __new__(cls, *parts, pairs: int = 1):
        spec = super().__new__(cls, parts)
        if pairs != 1:
            spec.pairs = pairs
        return spec

    def __repr__(self) -> str:
        tail = f", pairs={self.pairs}" if self.pairs != 1 else ""
        return f"PartitionSpec{tuple.__repr__(self)[:-1]}{tail})"

    __str__ = __repr__


def _divides(dim: int, n: int) -> bool:
    return n > 0 and dim % n == 0


def _data_n(mesh, daxes) -> int:
    return int(np.prod([mesh.shape[a] for a in daxes])) if daxes else 1


def _leaf_spec(path: str, shape: tuple[int, ...], mesh,
               cfg: ModelConfig | None) -> P:
    """Placement for one tensor: model axis first (row placement with
    split-K fallback), then an FSDP dim on the data axes."""
    model_n = mesh.shape.get("model", 1)
    daxes = data_axes(mesh)
    data_n = _data_n(mesh, daxes)

    if len(shape) == 0 or max(shape, default=0) < 128:
        return P()  # scalars / tiny vectors: replicate

    spec: list[Any] = [None] * len(shape)
    prefs = _model_prefs(path.split("/")[-1], shape)
    model_dim = None
    for d in prefs:
        if d < len(shape) and _divides(shape[d], model_n):
            model_dim = d
            break
    if model_dim is not None:
        spec[model_dim] = "model"
    if daxes:
        for d in range(len(shape)):
            if d != model_dim and _divides(shape[d], data_n):
                spec[d] = daxes if len(daxes) > 1 else daxes[0]
                break
    return P(*spec)


def _model_prefs(name: str, shape: tuple[int, ...]) -> list[int]:
    """The dims a leaf named ``name`` prefers on 'model', first choice
    first: an output dim (row placement), then the contraction dim."""
    if name in ("embed", "lm_head"):        # embed [V, d], lm_head [d, V]
        prefs = [0, 1] if name == "embed" else [1, 0]
    elif name in ("wq", "wk", "wv"):        # [d, H, hd] -> heads (output)
        prefs = [1, 2, 0]
    elif name in ("wqkv", "w_gateup"):      # prepacked fused [d, sum(M)]
        prefs = [1, 0]
    elif name == "wo":                      # [H, hd, d] -> heads (input)
        prefs = [0, 1, 2]
    elif name in ("w_gate", "w_up"):        # [(E,) d, f] -> E, then f
        prefs = [0, 2, 1] if len(shape) == 3 else [1, 0]
    elif name == "w_down":                  # [(E,) f, d] -> E, then f
        prefs = [0, 1, 2] if len(shape) == 3 else [0, 1]
    elif name in ("wr", "wg"):              # rwkv square proj
        prefs = [1, 0]
    elif name == "w_in":                    # mamba [d, 2di]
        prefs = [1, 0]
    elif name == "w_out":                   # mamba [di, d]
        prefs = [0, 1]
    else:                                   # largest dim first
        prefs = list(np.argsort([-s for s in shape]))
    return prefs


def _path_str(path) -> str:
    """A tree path (dict keys, list indices) as the reference builds it:
    ``"layers/0/attn/wq"``."""
    return "/".join(str(p) for p in path)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(int(s) for s in np.shape(leaf)) if not hasattr(
        leaf, "shape") else tuple(int(s) for s in leaf.shape)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (None is
    an empty subtree, as in ``jax.tree_util``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def plan_params(params, mesh, cfg: ModelConfig | None = None):
    """Spec tree for a param (or param-shaped state) tree."""
    return tree_map_with_path(
        lambda path, leaf: _leaf_spec(_path_str(path), _shape(leaf), mesh,
                                      cfg), params)


def plan_report(params, mesh) -> list[str]:
    lines: list[str] = []

    def f(path, leaf):
        spec = _leaf_spec(_path_str(path), _shape(leaf), mesh, None)
        lines.append(f"{_path_str(path):60s} {str(_shape(leaf)):24s} -> "
                     f"{spec}")

    tree_map_with_path(f, params)
    return lines


# --------------------------------------------------------------------------
# Activations / batch / cache
# --------------------------------------------------------------------------


def batch_spec(mesh, batch: int) -> P:
    """tokens/labels [B, S]."""
    daxes = data_axes(mesh)
    if daxes and _divides(batch, _data_n(mesh, daxes)):
        return P(daxes if len(daxes) > 1 else daxes[0], None)
    return P(None, None)


def cache_spec(mesh, cfg: ModelConfig, batch: int, shape: tuple[int, ...],
               name: str) -> P:
    """Decode-state placement: KV [L, B, S, Hkv, hd] with batch on data
    when it divides, heads on 'model' when they divide, else sequence on
    'model' (the split-K analogue); recurrent state on a channel dim."""
    daxes = data_axes(mesh)
    data_n = _data_n(mesh, daxes)
    model_n = mesh.shape.get("model", 1)
    d_ax = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)

    if name in ("k", "v"):
        L, B, S, H, hd = shape
        spec: list[Any] = [None] * 5
        b_ok = _divides(B, data_n)
        if b_ok:
            spec[1] = d_ax
        if _divides(H, model_n):
            spec[3] = "model"
        elif _divides(S, model_n):
            if not b_ok and _divides(S, model_n * data_n) and d_ax:
                spec[2] = (tuple(daxes) + ("model",))
            else:
                spec[2] = "model"
        return P(*spec)
    if name in ("rwkv_s", "mamba_h", "mamba_conv", "rwkv_x_tm", "rwkv_x_cm"):
        spec = [None] * len(shape)
        if _divides(shape[1], data_n) and d_ax:
            spec[1] = d_ax
        for d in range(2, len(shape)):
            if _divides(shape[d], model_n):
                spec[d] = "model"
                break
        return P(*spec)
    return P()


def plan_cache(cache, mesh, cfg: ModelConfig, batch: int):
    return tree_map_with_path(
        lambda path, leaf: cache_spec(mesh, cfg, batch, _shape(leaf),
                                      _path_str(path)), cache)


def serve_cache_spec(mesh, cfg: ModelConfig, shape: tuple[int, ...],
                     name: str) -> P:
    """Slot-managed decode-state placement: the slot axis is never
    sharded (it is the defrag axis) and ``pos`` is replicated; K/V and
    their scales shard heads on 'model' when they divide (else nothing),
    recurrent state its first divisible channel dim."""
    model_n = mesh.shape.get("model", 1)
    spec: list[Any] = [None] * len(shape)
    if model_n <= 1:
        return P(*spec)
    if name in ("k", "v", "k_scale", "v_scale"):
        if _divides(shape[3], model_n):
            spec[3] = "model"
        return P(*spec)
    if len(shape) >= 3 and name != "pos":
        for d in range(2, len(shape)):
            if _divides(shape[d], model_n):
                spec[d] = "model"
                break
        return P(*spec)
    return P(*spec)  # pos (and any vector state): replicated


def plan_serve_cache(cache, mesh, cfg: ModelConfig):
    return tree_map_with_path(
        lambda path, leaf: serve_cache_spec(mesh, cfg, _shape(leaf),
                                            _path_str(path)), cache)


def segment_spec(mesh, cfg: ModelConfig, shape: tuple[int, ...], name: str,
                 *, kind: str = "kv") -> P:
    """Prefix-cache segment placement: the slot-cache policy minus the
    batch axis (heads, or state channels, on 'model'; span never)."""
    model_n = mesh.shape.get("model", 1)
    spec: list[Any] = [None] * len(shape)
    if model_n <= 1:
        return P(*spec)
    if kind == "kv":
        if len(shape) >= 3 and _divides(shape[2], model_n):
            spec[2] = "model"
        return P(*spec)
    for d in range(1, len(shape)):
        if _divides(shape[d], model_n):
            spec[d] = "model"
            break
    return P(*spec)


def plan_segment(segment, mesh, cfg: ModelConfig, *, kind: str = "kv"):
    return tree_map_with_path(
        lambda path, leaf: segment_spec(mesh, cfg, _shape(leaf),
                                        _path_str(path), kind=kind),
        segment)


# --------------------------------------------------------------------------
# What GSPMD did implicitly: this rank's blocks
# --------------------------------------------------------------------------


def _block(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Block ``i`` of ``n`` of ``t`` along ``dim``: a contiguous copy that
    owns its memory (a view, even one already contiguous, would keep the
    whole tensor alive)."""
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size).clone(
        memory_format=torch.contiguous_format)


def _count(mesh, axes) -> int:
    """The ranks along ``axes`` (an axis, a tuple of them, or None: 1)."""
    axes = () if axes is None else (
        axes if isinstance(axes, tuple) else (axes,))
    return int(np.prod([mesh.shape.get(a, 1) for a in axes],
                       dtype=np.int64))


def _axis_index(mesh, axes) -> tuple[int, int]:
    """(count, this rank's index) over one or several mesh axes (the
    first named axis is the major one)."""
    axes = axes if isinstance(axes, tuple) else (axes,)
    n, i = 1, 0
    for a in axes:
        n, i = n * mesh.size(a), i * mesh.size(a) + mesh.index(a)
    return n, i


def _pairs(spec, axes) -> int:
    """The parts a dim cut on ``axes`` under ``spec`` is made of (``P``'s
    ``pairs``: only the 'model' dim is paired)."""
    return getattr(spec, "pairs", 1) if axes == "model" else 1


def shard_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (every named axis; a dim
    over several axes splits by their product, the first axis major; a
    paired dim, its block of each part, side by side)."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        n, i = _axis_index(mesh, axes)
        k = _pairs(spec, axes)
        if t.shape[dim] % (n * k):
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"split over {axes} ({n})"
                             + (f" in {k} parts" if k > 1 else ""))
        if n > 1 and k > 1:
            t = torch.cat([_block(part, dim, n, i)
                           for part in t.chunk(k, dim=dim)], dim=dim)
        elif n > 1:
            t = _block(t, dim, n, i)
    return t


def packed_axis(pw: PackedWeights, n: int, prefer: str | None = None,
                m_splits=None) -> str:
    """The axis a rank's block of the :class:`PackedWeights` ``pw`` (a
    matrix or an expert stack) is cut on over ``n`` ranks: ``prefer``
    (the axis the planner placed the float weight on: 'M' its columns,
    'K' its rows) where the weight can be cut there, else 'M' where its
    columns divide (:meth:`ShardedPlan.place`'s order), else 'K', else
    "replicated" (whole on every rank).  A quantized weight's K cut takes
    whole scale blocks only (``K / n`` a multiple of ``block``: an int4
    byte's two rows lie in one block), so a K cut that would split a
    block, or a packed byte pair, is never made.  A fused weight of
    members ``m_splits`` is cut on M only where every member's columns
    divide (:func:`shard_packed` cuts each member)."""
    if n <= 1:
        return "replicated"
    K, M = pw.shape
    if m_splits is not None and any(m % n for m in m_splits):
        M = 1
    # a K block a rank may take: whole scale blocks, of whole int4 bytes
    k_unit = (1 if pw.bits == 16 else
              int(np.lcm(pw.block, 2)) if pw.bits == 4 else pw.block)

    def cuts(axis):
        return (M % n == 0 if axis == "M"
                else K % n == 0 and (K // n) % k_unit == 0)

    order = ((prefer,) if prefer in ("M", "K") else ()) + ("M", "K")
    return next((a for a in order if cuts(a)), "replicated")


def shard_packed(pw: PackedWeights, mesh, prefer: str | None = None,
                 m_splits=None) -> tuple[PackedWeights, str]:
    """This rank's block of the :class:`PackedWeights` ``pw`` along the
    mesh's 'model' axis, on :func:`packed_axis`: an M cut takes its
    columns of the codes and of the scales ``[K // block, M]``; a K cut
    its whole scale blocks (rows of int8 codes, byte rows of packed int4
    codes, two rows a byte) and their scale rows.  A fused weight of
    members ``m_splits`` (``wqkv``, ``w_gateup``) cut on M is each
    member's block side by side (``[q_r | k_r | v_r]``, as the float
    fused leaves of :func:`serve_spec`).  Returns ``(block, axis)``; the
    block is ``pw`` itself when the weight stays whole.  An expert stack
    ``[E, K, M]`` (``[E, K // 2, M]`` int4) whose experts
    :func:`serve_spec` cuts on ``f`` is cut as a matrix, every expert
    alike: gate / up with ``prefer="M"`` (their ``f`` columns), down with
    ``prefer="K"`` (its ``f`` rows, in whole scale blocks)."""
    n, i = mesh.size("model"), mesh.index("model")
    axis = packed_axis(pw, n, prefer, m_splits)
    if axis == "replicated":
        return pw, axis
    if axis == "M" and m_splits is not None and len(m_splits) > 1:
        offs = np.cumsum([0, *m_splits])
        parts = [shard_packed(pw.columns(int(lo), int(hi)), mesh, "M")[0]
                 for lo, hi in zip(offs[:-1], offs[1:])]
        return PackedWeights(
            w_t=torch.cat([q.w_t for q in parts], dim=-1),
            scales=(None if pw.scales is None else
                    torch.cat([q.scales for q in parts], dim=-1)),
            bits=pw.bits, block=pw.block), axis
    dim = -1 if axis == "M" else -2
    return PackedWeights(
        w_t=_block(pw.w_t, dim, n, i),
        scales=None if pw.scales is None else _block(pw.scales, dim, n, i),
        bits=pw.bits, block=pw.block), axis


def block_shape(shape: tuple[int, ...], spec, mesh) -> tuple[int, ...]:
    """The shape of a rank's block of a tensor of ``shape`` under
    ``spec``."""
    return tuple(s // _count(mesh, a) for s, a in zip(shape, spec))


# the leaves a serving layer runs sharded, each on its row placement (the
# planner's first choice): heads, the FFN's columns (the down projection
# its rows), whole experts (else their f: ``is_expert_stack``), the vocab
SERVE_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "embed", "lm_head")
ATTN_LEAVES = ("wq", "wk", "wv", "wo")
# the decode prepack's fused leaves, rebuilt from their members' blocks
FUSED_LEAVES = ("wqkv", "w_gateup", "head_t")


def leaf_config(path: str, cfg: ModelConfig) -> ModelConfig:
    """The config of the layer that holds the leaf at ``path``: under
    ``encoder/`` whisper's encoder's own (``lm.encoder_config``: its
    heads, one kv head a head, its FFN width); else the model's, whose
    heads a cross layer's ``wq [d, H, hd]``, ``wk`` / ``wv [d_kv, Hkv,
    hd]`` and ``wo [H, hd, d]`` have too."""
    if cfg.encoder is not None and path.split("/", 1)[0] == "encoder":
        from repro_torch.models.lm import encoder_config

        return encoder_config(cfg)
    return cfg


def attention_shardable(cfg: ModelConfig, n: int) -> bool:
    """A rank can run ``H / n`` query heads: the heads divide, and either
    the kv heads do too or a rank's query heads share one kv head (which
    every rank computes: the serving cache replicates KV)."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    return (n > 1 and H > 0 and H % n == 0
            and (Hkv % n == 0 or (H // Hkv) % (H // n) == 0))


# the recurrent mixers' leaves, by the parent that holds them: the dim a
# rank's block is cut on (None: whole on every rank).  rwkv6's time-mix by
# its heads (``ssm.rwkv_heads``): the r / k / v / g projections and the
# decay LoRA's ``w_b`` on their output columns, ``w0`` / ``ln_scale`` /
# ``u`` on their head rows, ``wo`` on its input rows (a partial sum);
# channel-mix by ``d_ff`` (``wk``'s columns, ``wv``'s rows; ``wr`` reads
# the whole input and multiplies the reduced ``k @ wv``); Mamba by its
# inner width ``di`` (``w_in`` as the pair ``[x1_r | z_r]``)
STATE_LEAVES = {
    "time_mix": {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "w_b": 1, "w0": 0,
                 "ln_scale": 0, "u": 0, "wo": 0, "mu": None, "w_a": None},
    "channel_mix": {"wk": 1, "wv": 0, "wr": None, "mu": None},
    "mamba": {"w_in": 1, "conv_w": 1, "dt_hi": 1, "dt_bias": 0, "D": 0,
              "dt_lo": 0, "w_B": 0, "w_C": 0, "A_log": 0, "w_out": 0},
}


def state_width(parent: str, cfg: ModelConfig) -> int:
    """The count a recurrent mixer's rank blocks split: rwkv6's heads
    (time-mix), ``d_ff`` (channel-mix), Mamba's ``di``."""
    from repro_torch.models import ssm

    if parent == "time_mix":
        return ssm.rwkv_heads(cfg)[0]
    if parent == "channel_mix":
        return cfg.d_ff
    return ssm.mamba_dims(cfg)[0]


def _state_spec(path: str, shape: tuple[int, ...], n: int,
                cfg: ModelConfig) -> P | None:
    """:data:`STATE_LEAVES`' spec of the leaf at ``path`` on a 'model'
    axis of ``n`` (whole where the mixer's width does not divide), or None
    for a leaf no recurrent mixer holds."""
    parts = path.split("/")
    if len(parts) < 2 or parts[-2] not in STATE_LEAVES:
        return None
    parent, name = parts[-2], parts[-1]
    dim = STATE_LEAVES[parent].get(name)
    spec: list[Any] = [None] * len(shape)
    if dim is not None and _divides(state_width(parent, cfg), n):
        spec[dim] = "model"
    return P(*spec, pairs=2 if name == "w_in" and dim is not None
             and spec[dim] else 1)


def is_expert_stack(path: str, shape: tuple[int, ...]) -> bool:
    """The leaf at ``path`` is an MoE layer's expert stack: ``w_gate`` /
    ``w_up [E, d, f]`` or ``w_down [E, f, d]`` (not its shared experts'
    MLP, nor the reference's stacked ``[L, d, f]`` dense leaves)."""
    parts = path.split("/")
    return (len(shape) == 3 and len(parts) >= 2 and parts[-2] == "moe"
            and parts[-1] in ("w_gate", "w_up", "w_down"))


def serve_spec(path: str, shape: tuple[int, ...], mesh,
               cfg: ModelConfig) -> P:
    """The spec a serving rank cuts the leaf at ``path`` by:
    :func:`_leaf_spec`'s 'model' entry where it is the leaf's row
    placement (its first choice, which the layers run sharded), else the
    leaf whole.  An expert stack (:func:`is_expert_stack`) takes 'model'
    on E where the axis divides E (whole experts), else on its ``f`` where
    the axis divides that (every expert's columns of gate and up, rows of
    down: ``_leaf_spec``'s 3-D order without its third choice, ``d``,
    which would be split-K), else it stays whole.  So it differs from
    ``_leaf_spec`` only where named:
    'data' is dropped (parameters are replicated over it); the tiny-leaf
    rule does not apply (the serving cache shards kv heads at every
    width, and the attention that writes it must hold the same heads); a
    leaf the planner would cut on a fallback dim (``hd``, ``d``) or that
    the layer reads whole (norm scales, the
    router, a cross layer's ``cross_gate``, whisper's ``proj``) stays
    whole; attention (self, cross, the encoder's) stays whole unless
    :func:`attention_shardable` by the heads of the layer that holds it
    (:func:`leaf_config`).  The recurrent mixers' leaves are placed by
    their path (:data:`STATE_LEAVES`), where names collide with
    attention's; deliberate differences: channel-mix's ``wr`` whole
    (``_leaf_spec`` cuts its output ``d``, which multiplies the reduced
    ``k @ wv``) and ``w_in`` cut as the pair ``[x1_r | z_r]``
    (``_leaf_spec`` cuts contiguous columns: x1 on one rank, z on the
    other)."""
    n = mesh.shape.get("model", 1)
    name = path.split("/")[-1]
    spec: list[Any] = [None] * len(shape)
    if n > 1:
        state = _state_spec(path, shape, n, cfg)
        if state is not None:
            return state
    if n <= 1 or name not in SERVE_LEAVES or (
            name in ATTN_LEAVES
            and not attention_shardable(leaf_config(path, cfg), n)):
        return P(*spec)
    prefs = _model_prefs(name, shape)
    choices = prefs[:2] if is_expert_stack(path, shape) else prefs[:1]
    dim = next((d for d in choices if _divides(shape[d], n)), None)
    if dim is not None:
        spec[dim] = "model"
    return P(*spec)


# a recurrent state leaf of the serving cache ``[L, B, ...]``: the
# mixer whose width cuts it and the dim it is cut on (the token-shift
# carries are the layer's whole input, which every rank reads: whole)
STATE_CACHE_DIMS = {"rwkv_s": ("time_mix", 2), "mamba_h": ("mamba", 2),
                    "mamba_conv": ("mamba", 3), "rwkv_x_tm": None,
                    "rwkv_x_cm": None}


def slot_cache_spec(mesh, cfg: ModelConfig, shape: tuple[int, ...],
                    name: str) -> P:
    """The placement the port's slot cache holds (``serving.kv_cache``;
    ``lm.init_cache(mesh=)``): :func:`serve_cache_spec` for K/V, their
    scales and ``pos``; a recurrent state leaf by its name
    (:data:`STATE_CACHE_DIMS`), on the dim of the heads or channels its
    mixer's rank blocks hold.  Deliberate difference from the reference's
    first divisible dim: the token-shift carries ``rwkv_x_tm`` /
    ``rwkv_x_cm [L, B, d]`` stay whole (every rank reads the layer's
    whole input), and ``mamba_conv [L, B, cw - 1, di]`` is cut on ``di``
    whatever ``cw - 1`` divides."""
    n = mesh.shape.get("model", 1)
    if n <= 1 or name not in STATE_CACHE_DIMS:
        return serve_cache_spec(mesh, cfg, shape, name)
    spec: list[Any] = [None] * len(shape)
    cut = STATE_CACHE_DIMS[name]
    if cut is not None and _divides(state_width(cut[0], cfg), n):
        spec[cut[1]] = "model"
    return P(*spec)


def slot_cache_scales(mesh, cfg: ModelConfig, shapes: dict) -> dict:
    """{leaf: the ranks its whole leaf is cut into} for a cache of
    ``shapes`` ({leaf: whole shape}) under :func:`slot_cache_spec`: a
    rank's bytes of the leaf times its scale are the whole leaf's."""
    out = {}
    for name, shape in shapes.items():
        spec = slot_cache_spec(mesh, cfg, tuple(shape), name)
        out[name] = int(np.prod([_count(mesh, a) for a in spec],
                                dtype=np.int64))
    return out


MESH_FAMILIES = ("dense", "moe", "audio", "vlm", "ssm", "hybrid")


def check_mesh_family(cfg: ModelConfig) -> None:
    """Sharded serving runs every family the port runs: the dense and MoE
    decoders, whisper (its encoder and cross-attention as rank blocks),
    llama-vision (its cross-attention layers), rwkv6 and hymba (their
    recurrent mixers and state as rank blocks); raise for any other."""
    if cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"sharded serving of family {cfg.family!r} ({cfg.name}) is not "
            f"ported (the mesh runs {', '.join(MESH_FAMILIES)})")


def _repack(tree: dict, cfg: ModelConfig) -> dict:
    """Rebuild the fused prepack leaves a tree holds from their members'
    blocks: ``wqkv`` as ``[q_r | k_r | v_r]``, ``w_gateup`` as ``[gate_r
    | up_r]`` (a rank's own heads and FFN columns, where the spec's
    contiguous block of the fused dim would hold others'), ``head_t`` as
    the rank's vocab columns."""
    out = {k: (_repack(v, cfg) if isinstance(v, dict)
               else [_repack(x, cfg) for x in v] if isinstance(v, list)
               else v) for k, v in tree.items()}
    if "wqkv" in out:
        d = out["wq"].shape[0]
        out["wqkv"] = torch.cat([out[k].reshape(d, -1)
                                 for k in ("wq", "wk", "wv")], dim=-1)
    if "w_gateup" in out:
        out["w_gateup"] = torch.cat([out["w_gate"], out["w_up"]], dim=-1)
    if "head_t" in out:
        head = out["embed"].t() if cfg.tie_embeddings else out["lm_head"]
        out["head_t"] = head.contiguous()
    return out


def _cut(tree, mesh, cfg: ModelConfig, path: tuple = ()):
    """Every tensor of ``tree`` cut to this rank's block by
    :func:`serve_spec`, the fused leaves rebuilt from their members'."""
    def leaf(p, t):
        if p[-1] in FUSED_LEAVES or not isinstance(t, torch.Tensor):
            return t
        return shard_tensor(t, serve_spec(_path_str(p), _shape(t), mesh,
                                          cfg), mesh)

    return _repack(tree_map_with_path(leaf, tree, path), cfg)


SHARD_KEY = "mesh_shard"   # marks a tree already cut: (model rank, n)


def shard_params(params: dict, mesh, cfg: ModelConfig) -> dict:
    """This rank's serving tree (prepacked or not): every leaf
    ``shard_tensor`` of its :func:`serve_spec`, the fused prepack leaves
    rebuilt from their members' blocks; a leaf kept whole is shared with
    ``params``.  Idempotent: a tree this call returned (it carries
    ``SHARD_KEY``) comes back as it is."""
    n, r = mesh.size("model"), mesh.index("model")
    if params.get(SHARD_KEY) == (r, n) or n <= 1:
        return params
    check_mesh_family(cfg)
    out = _cut({k: v for k, v in params.items() if k != SHARD_KEY}, mesh,
               cfg)
    out[SHARD_KEY] = (r, n)
    return out


def shard_layer(p: dict, mesh, cfg: ModelConfig) -> dict:
    """One layer's leaves cut to this rank's blocks (``lm.init_lm(mesh=)``
    cuts each layer as it is drawn)."""
    return p if mesh.size("model") <= 1 else _cut(p, mesh, cfg, ("layers",))


# --------------------------------------------------------------------------
# Training: each rank's 'model' block, cut again over 'data' for storage
# --------------------------------------------------------------------------

def check_train_mesh(mesh, cfg: ModelConfig) -> None:
    """Raise for a mesh the training step does not take: a 'model' axis
    larger than 1 under a family the mesh does not run.  A 'pod' axis
    folds into data parallelism (:func:`fsdp_entry`), as in the
    reference."""
    if mesh.size("model") > 1:
        check_mesh_family(cfg)


def fsdp_entry(mesh):
    """The spec entry of a training leaf's FSDP dim, the data axes over
    which the step splits its batch and averages its gradients:
    ``("pod", "data")`` (their product, pod-major) on a mesh whose 'pod'
    axis is larger than 1, as the reference's ``_leaf_spec`` puts its
    data axes; else ``"data"``."""
    return ("pod", "data") if mesh.size("pod") > 1 else "data"


def train_spec(path: str, shape: tuple[int, ...], mesh,
               cfg: ModelConfig) -> P:
    """The spec a training rank stores the leaf at ``path`` (one layer's
    leaf, ``"layers/3/attn/wq"``) by: 'model' on :func:`serve_spec`'s dim
    (the row placement the layers compute with: heads, FFN columns and
    the down projection's rows, whole experts or else every expert's
    ``f``, the vocab; else the leaf whole over 'model'), then :func:`fsdp_entry` on :func:`_leaf_spec`'s
    FSDP dim, the first other dim the data axes' product divides.
    Deliberate difference: the reference plans its stacked ``[L, ...]``
    leaves as though they were unstacked, which can put 'model' on ``d``
    or on the layer dim; GSPMD computes under any placement, explicit
    tensor parallelism only under the one its layers hold."""
    served = serve_spec(path, shape, mesh, cfg)
    spec = list(served)
    entry = fsdp_entry(mesh)
    n = mesh.size(entry)
    if n > 1:
        for d in range(len(shape)):
            if spec[d] is None and _divides(shape[d], n):
                spec[d] = entry
                break
    return P(*spec, pairs=served.pairs)


def plan_train(params, mesh, cfg: ModelConfig) -> list[P]:
    """:func:`train_spec` of every leaf of a full param tree, in
    flattening order (``repro_torch.tree``)."""
    return [train_spec(_path_str(p), _shape(t), mesh, cfg)
            for p, t in flatten_with_paths(params)]


# an Adafactor statistic of a param, by the name under which it is held:
# the dims of the param's spec it keeps ("vr" averages the last dim,
# "vc" the one before it)
_STAT_DIMS = {"v": lambda s: s, "vr": lambda s: s[:-1],
              "vc": lambda s: s[:-2] + s[-1:]}


def state_specs(tree, params, param_specs: list) -> list[P]:
    """The spec of every leaf of ``tree`` (a param tree, an optimizer
    state, or a dict of both), in flattening order: a leaf whose path
    ends with a param's path (``("mu", "embed")``, ``("params", "layers",
    0, ...)``) takes that param's spec; an Adafactor statistic (a param's
    path then ``"vr"``, ``"vc"`` or ``"v"``) the param's spec less the
    dim it averages; anything else (a step count) is whole."""
    by_path = {p: s for (p, _), s in zip(flatten_with_paths(params),
                                         param_specs)}
    out = []
    for path, leaf in flatten_with_paths(tree):
        spec = None
        for k in range(len(path)):
            if path[k:] in by_path:
                spec = by_path[path[k:]]
                break
            if path[-1] in _STAT_DIMS and path[k:-1] in by_path:
                of = by_path[path[k:-1]]
                spec = P(*_STAT_DIMS[path[-1]](tuple(of)), pairs=of.pairs)
                break
        out.append(spec if spec is not None
                   else P(*[None] * len(_shape(leaf))))
    return out


def model_specs(cfg: ModelConfig, mesh) -> tuple[dict, list[P]]:
    """``(tree, specs)``: the model's full param tree on the meta device
    (shapes, no values) and :func:`plan_train` of it."""
    from repro_torch.models import lm

    full = lm.init_lm(cfg, device="meta")
    return full, plan_train(full, mesh, cfg)


def train_specs_of(tree, mesh, cfg: ModelConfig) -> list[P]:
    """:func:`state_specs` of ``tree`` (params, optimizer state, or a
    dict of both) under the model's training placement."""
    full, specs = model_specs(cfg, mesh)
    return state_specs(tree, full, specs)


def gather_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from this rank's block under ``spec``: each cut
    dim all-gathered over its axis's group in rank order (a dim over
    several axes over their product's group, pod-major), a paired dim's
    parts put back side by side (collective: every rank of the mesh calls
    it with the same spec)."""
    for dim, axes in enumerate(spec):
        if axes is None or mesh.size(axes) <= 1:
            continue
        with torch.no_grad():
            t = all_gather_cat(t, mesh.group(axes), dim=dim)
        k = _pairs(spec, axes)
        if k > 1:       # [a_0 b_0 | a_1 b_1 | ...] -> [a_0 a_1 ... | b_0 ...]
            n = mesh.size(axes)
            t = t.unflatten(dim, (n, k, -1)).transpose(dim, dim + 1) \
                .flatten(dim, dim + 2).contiguous()
    return t


def gather_tree(tree, mesh, specs: list):
    """The whole tree from this rank's blocks of it, each leaf's spec in
    ``specs`` (flattening order; collective)."""
    return unflatten_like(tree, [gather_tensor(t, s, mesh)
                                 for t, s in zip(leaves(tree), specs)])


def shard_train_tree(tree, mesh, cfg: ModelConfig):
    """A full tree (params, optimizer state, or a dict of both; the
    reference's values through ``repro_torch.bridge``, a restored
    checkpoint) to this rank's stored blocks: each leaf
    ``shard_tensor`` of its :func:`train_spec`."""
    specs = train_specs_of(tree, mesh, cfg)
    return unflatten_like(tree, [shard_tensor(t, s, mesh)
                                 for t, s in zip(leaves(tree), specs)])


def gather_train_tree(tree, mesh, cfg: ModelConfig):
    """The full tree from every rank's stored blocks (the inverse of
    :func:`shard_train_tree`; collective)."""
    return gather_tree(tree, mesh, train_specs_of(tree, mesh, cfg))


def shard_train_layer(p: dict, i: int, mesh, cfg: ModelConfig) -> dict:
    """Layer ``i``'s leaves cut to this rank's stored blocks
    (``lm.init_lm(mesh=, train=True)`` cuts each layer as it is
    drawn)."""
    return tree_map_with_path(
        lambda path, t: shard_tensor(
            t, train_spec(_path_str(path), _shape(t), mesh, cfg), mesh),
        p, ("layers", i))


class TrainLayout:
    """Where each param leaf of a training rank lives: its spec (in the
    param tree's flattening order) on ``mesh``, and the sums across the
    ranks that hold a leaf's other blocks, which the optimizer's means
    and norms need.  An entry over several axes (``("pod", "data")``) is
    one cut over their product, summed over its group."""

    def __init__(self, mesh, specs: list):
        self.mesh = mesh
        self.specs = list(specs)

    def cut_axes(self, j: int) -> tuple:
        """The entries that cut leaf ``j`` (in dim order)."""
        return tuple(a for a in self.specs[j]
                     if a is not None and self.mesh.size(a) > 1)

    def axis_of(self, j: int, dim: int):
        """The entry that cuts dim ``dim`` of leaf ``j``, or None."""
        a = self.specs[j][dim]
        return a if a is not None and self.mesh.size(a) > 1 else None

    def full_shape(self, j: int, shape) -> tuple[int, ...]:
        return tuple(int(n) * (self.mesh.size(a) if a is not None else 1)
                     for n, a in zip(shape, self.specs[j]))

    def sum_over(self, t: torch.Tensor, axes) -> torch.Tensor:
        """``t`` summed over the ranks of each entry in ``axes`` (f32,
        every rank the same bits)."""
        for a in axes:
            if a is not None and self.mesh.size(a) > 1:
                t = all_reduce_sum(t, self.mesh.group(a))
        return t
