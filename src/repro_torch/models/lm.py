"""Decoder LM: init, cache, decode prepack and forward (counterpart of
``repro/models/lm.py`` for the dense, MoE, ssm (rwkv6), hybrid (hymba),
audio and vlm families).

Parameters are a plain dict: ``embed [vocab, d]``, ``ln_f``, and
``layers``, a list with one dict per layer (the JAX package stacks them
``[L, ...]`` for ``lax.scan``; here the layer loop is a Python loop).  A
cross-attending layer (:meth:`ModelConfig.is_cross_layer`) also holds
``ln_cross``, ``cross`` and ``cross_gate``.  llama-3.2-vision's layers
stay one flat list: layer ``gi * g + i`` is the JAX package's group
``gi``, member ``i`` (its ``groups.plain`` / ``groups.cross_layer``
stacks), which is also that package's cache order.  whisper adds
``encoder``: ``layers`` (a list), ``ln_f`` and ``proj`` (None when the
encoder and decoder widths agree).  The cache keeps the JAX layout:
``k``/``v`` are ``[L, B, max_len, Hkv, hd]`` and ``pos`` is a scalar or a
``[B]`` per-slot vector; a quantized KV store adds ``k_scale``/``v_scale``
``[L, B, max_len, Hkv]``.  An rwkv6 layer (``family="ssm"``) holds
``ln1``, ``ln2``, ``time_mix`` and ``channel_mix`` instead, and its cache
has no ``k``/``v``: per layer and slot the wkv state ``rwkv_s [L, B, H,
hd, hd]`` (f32) and the token-shift carries ``rwkv_x_tm`` / ``rwkv_x_cm
[L, B, d]``, whatever ``kv_store`` says (the state is not the capacity
term).  A hymba layer (``parallel_ssm``) also holds ``mamba`` and the
per-channel mixing weights ``beta_attn`` / ``beta_ssm``; beside its K/V
(and scales) its cache has the conv window ``mamba_conv [L, B, cw - 1,
di]`` (model dtype) and the Mamba state ``mamba_h [L, B, di, n]`` (f32),
again in every ``kv_store``.

Under a mesh each rank holds its blocks of the tree
(``distributed.sharding.shard_params``; ``init_lm(mesh=)`` draws the
unsharded model's values and keeps the rank's blocks): a vocab-sharded
embedding is a masked local lookup plus an all-reduce (exact: the other
ranks add zeros), a vocab-sharded head's logits are all-gathered, and the
layers all-reduce their partial sums (``models/layers.py``), whisper's
encoder layers (:func:`run_encoder`) and every cross-attention layer
included.  Under autograd the lookup's all-reduce passes its gradient on
to the rank's rows, and the head's input enters the rank's vocab columns
(``collectives.enter``) whose logits' gather keeps the rank's block of
their gradient, so a training step on a 'model' axis computes the
unsharded gradients, each on the rank that holds its block.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.axes import activation_mesh, current_mesh
from repro_torch.distributed.collectives import (
    Reduction,
    all_gather_cat,
    all_reduce_sum,
    enter,
)
from repro_torch.kernels.kv_quant import stored_head_dim, validate_kv_store
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------


def init_lm(cfg: ModelConfig, *, seed: int = 0, device=None,
            generator: torch.Generator | None = None, mesh=None,
            train: bool = False) -> dict:
    """Seeded random weights with the JAX package's shapes and scale
    (N(0, 1/fan_in) in f32, cast to ``cfg.param_dtype``).

    The draws come from a ``torch.Generator`` on ``device`` (``seed``
    unless one is given); they are NOT the JAX package's draws -- to feed
    both packages the same weights, see :mod:`repro_torch.bridge`.  As in
    the JAX package, every ``cross_gate`` starts at zero.

    With ``mesh`` every value is drawn as without it, and each leaf is
    cut to this rank's block as soon as it is drawn
    (``sharding.shard_params``; with ``train`` the training placement,
    ``sharding.train_spec``): a rank holds its share and at most one
    layer whole.  On the ``"meta"`` device nothing is drawn: the tree
    gives the model's leaves and their shapes.
    """
    check_family(cfg)
    from repro_torch.distributed import sharding as shd
    device = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    g = generator or (None if device.type == "meta" else
                      torch.Generator(device=device).manual_seed(seed))
    params = {
        "embed": L.dense_init(g, cfg.d_model, (cfg.vocab, cfg.d_model),
                              dtype, device),
        "ln_f": L.init_norm(cfg, cfg.d_model, dtype, device),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(g, cfg.d_model,
                                         (cfg.d_model, cfg.vocab), dtype,
                                         device)
    for _ in range(cfg.n_layers):
        layer = {
            "ln1": L.init_norm(cfg, cfg.d_model, dtype, device),
            "ln2": L.init_norm(cfg, cfg.d_model, dtype, device),
        }
        if cfg.family == "ssm":   # rwkv: time-mix + channel-mix
            layer["time_mix"] = S.init_rwkv_time_mix(g, cfg, dtype, device)
            layer["channel_mix"] = S.init_rwkv_channel_mix(g, cfg, dtype,
                                                           device)
        else:
            _init_block(g, cfg, layer, len(params["layers"]), dtype, device)
        if mesh is not None and train:
            layer = shd.shard_train_layer(layer, len(params["layers"]),
                                          mesh, cfg)
        elif mesh is not None:
            layer = shd.shard_layer(layer, mesh, cfg)
        params["layers"].append(layer)
    if cfg.encoder is not None:
        params["encoder"] = _init_encoder(g, cfg, dtype, device)
    if mesh is not None and train:
        layers = params.pop("layers")
        params = shd.shard_train_tree(params, mesh, cfg)
        params["layers"] = layers
    elif mesh is not None:
        # the layers are cut already; this cuts the embedding, the head
        # and whisper's encoder (by the encoder's own heads and widths)
        layers = params.pop("layers")
        params = shd.shard_params({**params, "layers": []}, mesh, cfg)
        params["layers"] = layers
    return params


def _init_block(g, cfg: ModelConfig, layer: dict, i: int, dtype,
                device) -> None:
    """Layer ``i``'s attention (and hymba's Mamba heads and betas), FFN or
    MoE, and cross-attention, drawn into ``layer``."""
    layer["attn"] = L.init_attention(g, cfg, dtype, device)
    if cfg.parallel_ssm:     # hymba: Mamba heads beside attention
        layer["mamba"] = S.init_mamba(g, cfg, dtype, device)
        layer["beta_attn"] = torch.ones(cfg.d_model, dtype=dtype,
                                        device=device)
        layer["beta_ssm"] = torch.ones(cfg.d_model, dtype=dtype,
                                       device=device)
    if cfg.moe is not None:
        layer["moe"] = L.init_moe(g, cfg, dtype, device)
    else:
        layer["mlp"] = L.init_mlp(g, cfg, dtype, device)
    if cfg.is_cross_layer(i):
        layer["ln_cross"] = L.init_norm(cfg, cfg.d_model, dtype, device)
        layer["cross"] = L.init_cross_attention(g, cfg, cfg.d_model, dtype,
                                                device)
        layer["cross_gate"] = torch.zeros(1, dtype=dtype, device=device)


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family the port does not run: an unknown family, an ssm
    config that is not rwkv6, a hybrid one that is not parallel Mamba
    heads (or parallel heads outside the hybrid family), an MoE config
    without experts or experts outside it; or for layers that are not
    whole groups of ``cross_attn_every`` (as the JAX init asserts)."""
    kind = cfg.ssm.kind if cfg.ssm is not None else None
    if cfg.family not in PORTED_FAMILIES or (
            (cfg.family == "moe") != (cfg.moe is not None)) or (
            (cfg.family == "ssm") != (kind == "rwkv6")) or (
            (cfg.family == "hybrid") != (cfg.parallel_ssm
                                         and kind == "mamba")):
        raise ValueError(f"family {cfg.family!r} is not ported yet (the port "
                         f"runs {', '.join(PORTED_FAMILIES)})")
    if cfg.cross_attn_every and cfg.n_layers % cfg.cross_attn_every:
        raise ValueError(f"{cfg.n_layers} layers are not whole groups of "
                         f"{cfg.cross_attn_every}")


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The whisper encoder's layer config, as the JAX package derives it:
    the model's with the encoder's widths, one kv head a head, LayerNorm
    and a gelu FFN."""
    enc = cfg.encoder
    return dataclasses.replace(
        cfg, d_model=enc.d_model, n_heads=enc.n_heads,
        n_kv_heads=enc.n_heads, d_ff=enc.d_ff, head_dim=0, moe=None,
        family="dense", norm_type="layernorm", act="gelu")


def _init_encoder(g, cfg: ModelConfig, dtype, device) -> dict:
    """Bidirectional encoder over stub frame embeddings ``[B, T, enc_d]``:
    its layers, ``ln_f``, and ``proj [enc_d, d]`` to the decoder's width
    when the two differ (else None)."""
    ecfg, d = encoder_config(cfg), cfg.encoder.d_model
    layers = [{"ln1": L.init_norm(ecfg, d, dtype, device),
               "attn": L.init_attention(g, ecfg, dtype, device),
               "ln2": L.init_norm(ecfg, d, dtype, device),
               "mlp": L.init_mlp(g, ecfg, dtype, device)}
              for _ in range(cfg.encoder.n_layers)]
    return {"layers": layers, "ln_f": L.init_norm(ecfg, d, dtype, device),
            "proj": (L.dense_init(g, d, (d, cfg.d_model), dtype, device)
                     if d != cfg.d_model else None)}


# --------------------------------------------------------------------------
# Cache
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               per_slot_pos: bool = False, kv_store: str = "fp",
               device=None, mesh=None) -> dict:
    """Decode state: ``pos`` (a scalar, or ``[batch]`` with
    ``per_slot_pos``) and ``k``/``v`` leaves ``[L, batch, max_len, Hkv,
    hd]``; for rwkv6 no ``k``/``v`` but ``rwkv_s [L, batch, H, hd, hd]``
    (f32, zeros) and ``rwkv_x_tm`` / ``rwkv_x_cm [L, batch, d]``, in every
    ``kv_store``; with ``parallel_ssm`` (hymba) also, after the K/V
    leaves, ``mamba_conv [L, batch, cw - 1, di]`` (``dtype``) and
    ``mamba_h [L, batch, di, n]`` (f32), zeros, in every ``kv_store``.

    ``kv_store`` selects the KV storage (``repro_torch.kernels.kv_quant``):
    ``"fp"`` keeps ``dtype`` leaves; ``"int8"`` / ``"int4"`` store int8
    codes at ``stored_head_dim`` plus f32 ``k_scale``/``v_scale`` leaves
    ``[L, batch, max_len, Hkv]`` (all ones: an all-zero page round-trips
    exactly under scale 1.0).

    With ``mesh`` every leaf is shaped as this rank's block of it under
    ``sharding.slot_cache_spec`` (the rank's kv heads where they divide,
    the rank's rwkv heads and Mamba channels; ``pos`` and the token-shift
    carries whole), zeros (ones for the scales) as unsharded.
    """
    validate_kv_store(kv_store)
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.param_dtype)
    n, hkv = cfg.n_layers, cfg.n_kv_heads
    f32 = torch.float32
    # name: (whole shape, dtype, fill)
    leaves = {"pos": ((batch,) if per_slot_pos else (), torch.int32, 0)}
    if cfg.family == "ssm":
        H, hd = S.rwkv_heads(cfg)
        leaves["rwkv_s"] = ((n, batch, H, hd, hd), f32, 0)
        for name in ("rwkv_x_tm", "rwkv_x_cm"):
            leaves[name] = ((n, batch, cfg.d_model), dtype, 0)
    elif kv_store == "fp":
        for name in ("k", "v"):
            leaves[name] = ((n, batch, max_len, hkv, cfg.hd), dtype, 0)
    else:
        for name in ("k", "v"):
            leaves[name] = ((n, batch, max_len, hkv,
                             stored_head_dim(kv_store, cfg.hd)), torch.int8,
                            0)
        for name in ("k_scale", "v_scale"):
            leaves[name] = ((n, batch, max_len, hkv), f32, 1)
    if cfg.parallel_ssm:
        di, st, cw = S.mamba_dims(cfg)
        leaves["mamba_conv"] = ((n, batch, cw - 1, di), dtype, 0)
        leaves["mamba_h"] = ((n, batch, di, st), f32, 0)
    if mesh is not None:
        from repro_torch.distributed import sharding as shd

        leaves = {name: (shd.block_shape(shape, shd.slot_cache_spec(
            mesh, cfg, shape, name), mesh), dt, fill)
            for name, (shape, dt, fill) in leaves.items()}
    return {name: torch.full(shape, fill, dtype=dt, device=device)
            for name, (shape, dt, fill) in leaves.items()}


# --------------------------------------------------------------------------
# Decode-weight prepack (one-time deployment cost)
# --------------------------------------------------------------------------


def prepack_decode_params(params: dict, cfg: ModelConfig,
                          mesh=None) -> dict:
    """Prepack the decode hot path's weights once, at deployment.

    Per layer, ``wqkv`` is the contiguous ``[d, (H + 2 Hkv) hd]`` concat of
    the flattened Q/K/V projections and ``w_gateup`` the ``[d, 2 f]``
    concat of gate and up (of a gated dense MLP, or of an MoE layer's
    gated shared experts; the expert stacks are read in place; an ungated
    FFN has nothing to concat); ``head_t`` is one
    contiguous K-major ``[d, vocab]`` copy of the tied head (the GEMV
    kernels refuse the strided ``embed.T`` view rather than copy 206 MB
    per token).

    The originals stay, as in the JAX package: prefill and the unfused
    decode path (``fuse_programs=False``) read them.  With ``mesh`` the
    tree is first cut to this rank's blocks (``sharding.shard_params``;
    a tree cut already passes through), so the fused leaves are the
    rank's own ``[q_r | k_r | v_r]`` and ``[gate_r | up_r]``.  An rwkv6
    model's layers pass through unchanged (its projections stay plain
    matmuls, as in the JAX package; under a mesh the rank's heads and
    ``d_ff`` columns); only its head gets ``head_t`` (the rank's vocab
    columns where the vocab divides).  A hymba layer's ``mamba`` weights
    (under a mesh the rank's ``di`` channels, ``w_in`` as ``[x1_r |
    z_r]``) and betas (whole) are carried as they are.  Returns a NEW
    dict; ``params``' own tensors are shared, not copied.
    """
    if mesh is not None:
        from repro_torch.distributed import sharding as shd

        params = shd.shard_params(params, mesh, cfg)
    d = cfg.d_model
    packed = dict(params)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    packed["head_t"] = head.contiguous()
    if cfg.family == "ssm":
        return packed
    packed["layers"] = []
    def gateup(m: dict) -> dict:
        if "w_gate" not in m:        # an ungated FFN (relu2, gelu)
            return m
        return {**m, "w_gateup": torch.cat([m["w_gate"], m["w_up"]], dim=-1)}

    for p in params["layers"]:
        a = dict(p["attn"])
        a["wqkv"] = torch.cat([a["wq"].reshape(d, -1),
                               a["wk"].reshape(d, -1),
                               a["wv"].reshape(d, -1)], dim=-1)
        layer = {**p, "attn": a}
        if "mlp" in p:
            layer["mlp"] = gateup(p["mlp"])
        if "shared" in p.get("moe", {}):
            layer["moe"] = {**p["moe"], "shared": gateup(p["moe"]["shared"])}
        packed["layers"].append(layer)
    return packed


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to the compute dtype, as the JAX package
    scales the embeddings; a Python scalar, so no host tensor is copied to
    the card (and, cached, no tensor is read on the host per forward)."""
    return torch.tensor(math.sqrt(d_model), dtype=torch.float32).to(
        dtype).item()


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: dict | None = None,
            frames: torch.Tensor | None = None,
            vision: torch.Tensor | None = None,
            gemv_policy=None,
            last: torch.Tensor | None = None,
            remat: bool | None = None,
            batch_group=None) -> tuple[torch.Tensor, dict | None,
                                       torch.Tensor]:
    """Returns ``(logits [B, S, vocab], new_cache, aux_loss)``; with
    ``last`` (int64 ``[B]``, a position in each row) the final norm and
    the head run at those positions alone and the logits are ``[B, 1,
    vocab]`` (a prefill's last-token logits without the ``[B, S, vocab]``
    tensor).

    With a cache, the new K/V are written into ``cache``'s ``k``/``v``
    tensors (and, for a quantized store, their codes and ``k_scale`` /
    ``v_scale``), and an rwkv6 or hymba model's state into its ``rwkv_*``
    or ``mamba_*`` tensors, IN PLACE and ``new_cache`` shares them (with
    ``pos`` advanced by S).
    ``gemv_policy`` routes single-token (decode) projections through the
    GEMV dispatcher: QKV and gate+up as fused programs, down
    and the LM head as single requests, MoE experts as ragged or grouped
    programs (``gemv_policy.expert_shape``).  Prefill (S > 1) keeps the
    plain matmul path.  ``aux_loss`` sums the MoE layers' load-balance
    losses (0 for a dense model).

    whisper takes ``frames [B, n_frames, enc_d]`` (stub frame embeddings)
    and runs its encoder over them; llama-3.2-vision takes ``vision [B,
    vision_tokens, d]`` (stub patch embeddings).  Either is cast to the
    compute dtype here, and is the context every cross-attending layer
    projects its K / V from, on every call (decode steps included), as
    in the JAX package.

    A training forward (no cache, and autograd records through the
    embedded tokens) recomputes each layer in the backward with ``remat``
    (default ``cfg.remat``): the layer runs under
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, the
    counterpart of the reference's ``jax.checkpoint`` around its layer
    scan's body; the gradients are the same bits.  Its MoE layers run the
    capacity einsum (``layers.moe_partial``).  ``batch_group`` is the
    data-parallel group whose ranks hold row blocks of one global batch:
    the MoE load-balance loss counts the global batch's routing there.
    Decode and prefill (a cache, or nothing requiring grad) are computed
    as without these.
    """
    B, Sq = tokens.shape
    dtype = torch_dtype(cfg.compute_dtype)
    x = _embed(params["embed"], tokens, cfg).to(dtype)
    x = x * _embed_scale(cfg.d_model, dtype)

    pos0 = cache["pos"] if cache is not None else torch.zeros(
        (), dtype=torch.int32, device=x.device)
    positions = (pos0.reshape(-1, 1)
                 + torch.arange(Sq, device=x.device)[None, :]).expand(B, Sq)

    ctx = None
    if cfg.encoder is not None:
        if frames is None:
            raise ValueError(f"{cfg.name} needs stub frame embeddings "
                             f"(frames=)")
        ctx = run_encoder(params["encoder"], frames.to(dtype), cfg)
    if cfg.cross_attn_every > 0:
        if vision is None:
            raise ValueError(f"{cfg.name} needs stub patch embeddings "
                             f"(vision=)")
        ctx = vision.to(dtype)

    remat = cfg.remat if remat is None else remat
    remat = remat and cache is None and L.records_grad(x)
    x, aux = _forward_flat(params, cfg, x, positions, cache, gemv_policy,
                           ctx, remat=remat, batch_group=batch_group)

    if last is not None:
        x = x[torch.arange(B, device=x.device), last][:, None]
    x = L.apply_norm(params["ln_f"], x, cfg)
    if "head_t" in params:
        head = params["head_t"]
    else:
        head = params["embed"].t() if cfg.tie_embeddings \
            else params["lm_head"]
    sharded_head = head.shape[1] != cfg.vocab
    if sharded_head:    # under autograd, the input of the rank's columns
        x = enter(x, L.model_group())
    if gemv_policy is not None and Sq == 1:
        from repro_torch.kernels.dispatch import dispatch_dense

        logits = dispatch_dense(x, head.to(dtype), policy=gemv_policy,
                                shard="M" if sharded_head else "replicated")
    else:
        logits = torch.einsum("bsd,dv->bsv", x, head.to(dtype))
    if sharded_head:    # each rank's vocab block, in rank order
        logits = all_gather_cat(logits, L.model_group(), dim=-1)
    new_cache = None
    if cache is not None:
        new_cache = {**cache, "pos": pos0 + Sq}
    return logits, new_cache, aux


def _embed(table: torch.Tensor, tokens: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """``table[tokens]``; a vocab-sharded table (a rank's ``V / n`` rows
    from ``rank * V / n``) looks up the tokens it holds, zeros for the
    rest, and the rows are all-reduced (exact)."""
    V_l = table.shape[0]
    if V_l == cfg.vocab:
        return table[tokens]
    idx = tokens - L.model_index() * V_l
    own = (idx >= 0) & (idx < V_l)
    rows = table[idx.clamp(0, V_l - 1)]
    rows = torch.where(own[..., None], rows, rows.new_zeros(()))
    return all_reduce_sum(rows, L.model_group())


def layer_window(cfg: ModelConfig, i: int) -> int:
    """Layer ``i``'s sliding window as a Python int (``lm._window_for`` and
    ``is_global`` of the JAX package): ``cfg.sliding_window`` for a local
    layer of a ``local_global`` model, 0 (no limit) otherwise.  A captured
    decode graph bakes it in per layer."""
    if cfg.attn_pattern != "local_global":
        return 0
    every = max(cfg.global_every, 1)
    return 0 if i % every == every - 1 else cfg.sliding_window


def run_encoder(p: dict, frames: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """whisper's encoder over stub frame embeddings ``[B, T, enc_d]``
    (``lm._run_encoder``): per layer rope over the frame positions,
    non-causal attention and a gelu FFN, each pre-LayerNorm with a
    residual; then ``ln_f`` and, when the widths differ, ``proj``.

    Under a mesh a layer holds a rank's encoder heads and FFN columns
    (``sharding.serve_spec`` by the encoder's own config): the attention
    output's partial sum is all-reduced in f32 and cast once, as
    self-attention's, and the FFN's by ``layers.apply_mlp`` (its full
    width is the encoder's ``d_ff``); the norms and ``proj`` are whole on
    every rank.  Under autograd the normed input enters the rank's
    heads."""
    ecfg = encoder_config(cfg)
    B, T, _ = frames.shape
    positions = torch.arange(T, device=frames.device)[None].expand(B, T)
    x = frames
    for pl in p["layers"]:
        h = L.apply_norm(pl["ln1"], x, ecfg)
        a = pl["attn"]
        sharded = a["wq"].shape[1] != ecfg.n_heads
        if sharded:     # under autograd, the input of the rank's heads
            h = enter(h, L.model_group())
        q = L.rope(L.project_heads(h, a["wq"]), positions, ecfg.rope_theta)
        k = L.rope(L.project_heads(h, a["wk"]), positions, ecfg.rope_theta)
        v = L.project_heads(h, a["wv"])
        o = L.attention_core(q, k, v, q_positions=None, kv_valid_len=None,
                             causal=False)
        o = torch.einsum("bshk,hkd->bsd", o, a["wo"])
        x = x + (all_reduce_sum(o, L.model_group()) if sharded else o)
        h = L.apply_norm(pl["ln2"], x, ecfg)
        x = x + L.apply_mlp(pl["mlp"], h, ecfg)
    x = L.apply_norm(p["ln_f"], x, ecfg)
    if p.get("proj") is not None:
        x = x @ p["proj"]
    return x


def _forward_flat(params, cfg, x, positions, cache, gemv=None, ctx=None, *,
                  remat: bool = False, batch_group=None):
    """The layer stack as a Python loop (``lax.scan`` in the JAX package):
    pre-norm attention (over each layer's :func:`layer_window`) and FFN (or
    MoE) blocks with residuals, then, on a cross-attending layer, the
    cross-attention over ``ctx`` with its own pre-norm and residual:
    gated by ``tanh(cross_gate)`` in llama-vision (``_forward_grouped``),
    ungated in whisper although its layers carry a gate
    (``_forward_flat``).  An rwkv6 layer is :func:`_rwkv_block`.  A hymba
    layer runs its Mamba heads on the same normed input as attention and
    adds ``beta_attn · attention + beta_ssm · mamba`` (model dtype) to the
    residual (``lm._self_block``); with a cache, the Mamba state continues
    from layer ``i``'s ``mamba_*`` leaves and is advanced in place.  With
    ``remat`` each layer (:func:`_layer`) runs under a non-reentrant
    checkpoint, its mesh installed again around the recompute (which
    runs in the backward, on the autograd engine's device thread on the
    card, where the forward's context is not set).

    Under a mesh a sharded FFN's output is a partial sum, all-reduced
    before the residual add.  Deferred collectives (the reference's
    ``overlap_collectives``, ``lm._forward_flat``): on a decode step with
    ``gemv.overlap_collectives``, that all-reduce is issued without
    waiting and awaited at the next layer's entry (the last one before the
    final norm), so it can overlap the next layer's attention; the add is
    the same, so the tokens and logits are bit-equal either way.  Counted
    once a step: ``record_overlap("deferred", deferred_collectives=
    n_layers)``.  Returns ``(x, aux_loss)``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    mesh = current_mesh()
    group = mesh.group("model") if mesh is not None else None
    defer = (group is not None and cache is not None and x.shape[1] == 1
             and gemv is not None and gemv.model_shards > 1
             and gemv.overlap_collectives and ctx is None
             and cfg.family != "ssm")
    if defer:
        from repro_torch.kernels.dispatch import record_overlap

        record_overlap("deferred", deferred_collectives=cfg.n_layers)
    pending = None
    for i, p in enumerate(params["layers"]):
        if pending is not None:     # the previous layer's FFN combine
            x = x + pending.wait()
            pending = None
        layer = functools.partial(
            _layer, cfg=cfg, i=i, positions=positions, cache=cache,
            gemv=gemv, ctx=ctx, group=group, defer=defer,
            batch_group=batch_group)
        if remat:
            x, aux_l, pending = checkpoint(_under_mesh, mesh, layer, p, x,
                                           use_reentrant=False)
        else:
            x, aux_l, pending = layer(p, x)
        if aux_l is not None:
            aux = aux + aux_l
    if pending is not None:
        x = x + pending.wait()
    return x, aux


def _under_mesh(mesh, fn, *args):
    """``fn(*args)`` with ``mesh`` active."""
    with activation_mesh(mesh):
        return fn(*args)


def _layer(p: dict, x: torch.Tensor, *, cfg: ModelConfig, i: int,
           positions, cache, gemv, ctx, group, defer: bool, batch_group):
    """Layer ``i`` of :func:`_forward_flat`: ``(x, aux_loss or None,
    pending)``, ``pending`` being the FFN combine left to await when
    ``defer``."""
    if cfg.family == "ssm":
        return _rwkv_block(p, x, cfg, cache, i), None, None
    h = L.apply_norm(p["ln1"], x, cfg)
    cache_kv = (cache["k"][i], cache["v"][i]) if cache is not None \
        else None
    cache_scales = ((cache["k_scale"][i], cache["v_scale"][i])
                    if cache is not None and "k_scale" in cache
                    else None)
    a = L.apply_attention(
        p["attn"], h, cfg, positions=positions, cache_kv=cache_kv,
        cache_pos=cache["pos"] if cache is not None else None,
        cache_scales=cache_scales, gemv=gemv,
        window=layer_window(cfg, i))
    if "mamba" in p:
        state = ((cache["mamba_conv"][i], cache["mamba_h"][i])
                 if cache is not None else None)
        m, _ = S.apply_mamba(p["mamba"], h, cfg, state=state)
        a = p["beta_attn"] * a + p["beta_ssm"] * m
    x = x + a
    h = L.apply_norm(p["ln2"], x, cfg)
    partial, aux = False, None
    if group is None:       # no mesh: the whole FFN, nothing to reduce
        if "moe" in p:
            ff, aux = L.apply_moe(p["moe"], h, cfg, gemv=gemv,
                                  batch_group=batch_group)
        else:
            ff = L.apply_mlp(p["mlp"], h, cfg, gemv=gemv)
    elif "moe" in p:
        ff, aux, partial = L.moe_partial(p["moe"], h, cfg, gemv=gemv,
                                         batch_group=batch_group)
    else:
        ff, partial = L.mlp_partial(p["mlp"], h, cfg, gemv=gemv)
    if partial and defer:
        return x, aux, Reduction(ff, group, async_op=True)
    if partial:
        ff = all_reduce_sum(ff, group)
    x = x + ff
    if "cross" in p:
        h = L.apply_norm(p["ln_cross"], x, cfg)
        y = L.apply_cross_attention(p["cross"], h, ctx, cfg)
        if cfg.cross_attn_every > 0:
            y = torch.tanh(p["cross_gate"].to(x.dtype)) * y
        x = x + y
    return x, aux, None


def _rwkv_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                cache: dict | None, i: int) -> torch.Tensor:
    """Layer ``i`` of rwkv6 (``lm._rwkv_block``): pre-norm time-mix and
    channel-mix with residuals; with a cache, their state continues from
    layer ``i``'s leaves and is advanced in place."""
    tm_state = cm_prev = None
    if cache is not None:
        tm_state = (cache["rwkv_s"][i], cache["rwkv_x_tm"][i])
        cm_prev = cache["rwkv_x_cm"][i]
    h = L.apply_norm(p["ln1"], x, cfg)
    y, _ = S.apply_rwkv_time_mix(p["time_mix"], h, cfg, state=tm_state)
    x = x + y
    h = L.apply_norm(p["ln2"], x, cfg)
    y, _ = S.apply_rwkv_channel_mix(p["channel_mix"], h, cfg,
                                    prev_x=cm_prev)
    return x + y
