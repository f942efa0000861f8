"""Decoder LM: init, cache, decode prepack and forward (counterpart of
``repro/models/lm.py`` for the dense and MoE families).

Parameters are a plain dict: ``embed [vocab, d]``, ``ln_f``, and
``layers``, a list with one dict per layer (the JAX package stacks them
``[L, ...]`` for ``lax.scan``; here the layer loop is a Python loop).  The
cache keeps the JAX layout: ``k``/``v`` are ``[L, B, max_len, Hkv, hd]``
and ``pos`` is a scalar or a ``[B]`` per-slot vector; a quantized KV store
adds ``k_scale``/``v_scale`` ``[L, B, max_len, Hkv]``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.kv_quant import stored_head_dim, validate_kv_store
from repro_torch.models import layers as L


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------


def init_lm(cfg: ModelConfig, *, seed: int = 0, device=None,
            generator: torch.Generator | None = None) -> dict:
    """Seeded random weights with the JAX package's shapes and scale
    (N(0, 1/fan_in) in f32, cast to ``cfg.param_dtype``).

    The draws come from a ``torch.Generator`` on ``device`` (``seed``
    unless one is given); they are NOT the JAX package's draws -- to feed
    both packages the same weights, see :mod:`repro_torch.bridge`.
    """
    if cfg.family not in ("dense", "moe") or (
            (cfg.family == "moe") != (cfg.moe is not None)):
        raise ValueError(f"family {cfg.family!r} is not ported yet")
    device = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    g = generator or torch.Generator(device=device).manual_seed(seed)
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
            "attn": L.init_attention(g, cfg, dtype, device),
        }
        if cfg.moe is not None:
            layer["moe"] = L.init_moe(g, cfg, dtype, device)
        else:
            layer["mlp"] = L.init_mlp(g, cfg, dtype, device)
        params["layers"].append(layer)
    return params


# --------------------------------------------------------------------------
# Cache
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               per_slot_pos: bool = False, kv_store: str = "fp",
               device=None) -> dict:
    """Decode state: ``pos`` (a scalar, or ``[batch]`` with
    ``per_slot_pos``) and ``k``/``v`` leaves ``[L, batch, max_len, Hkv,
    hd]``.

    ``kv_store`` selects the KV storage (``repro_torch.kernels.kv_quant``):
    ``"fp"`` keeps ``dtype`` leaves; ``"int8"`` / ``"int4"`` store int8
    codes at ``stored_head_dim`` plus f32 ``k_scale``/``v_scale`` leaves
    ``[L, batch, max_len, Hkv]`` (all ones: an all-zero page round-trips
    exactly under scale 1.0).
    """
    validate_kv_store(kv_store)
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.param_dtype)
    n, hkv = cfg.n_layers, cfg.n_kv_heads
    cache = {"pos": torch.zeros((batch,) if per_slot_pos else (),
                                dtype=torch.int32, device=device)}
    if kv_store == "fp":
        kv_shape = (n, batch, max_len, hkv, cfg.hd)
        cache["k"] = torch.zeros(kv_shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(kv_shape, dtype=dtype, device=device)
        return cache
    kv_shape = (n, batch, max_len, hkv, stored_head_dim(kv_store, cfg.hd))
    for name in ("k", "v"):
        cache[name] = torch.zeros(kv_shape, dtype=torch.int8, device=device)
    for name in ("k_scale", "v_scale"):
        cache[name] = torch.ones((n, batch, max_len, hkv),
                                 dtype=torch.float32, device=device)
    return cache


# --------------------------------------------------------------------------
# Decode-weight prepack (one-time deployment cost)
# --------------------------------------------------------------------------


def prepack_decode_params(params: dict, cfg: ModelConfig) -> dict:
    """Prepack the decode hot path's weights once, at deployment.

    Per layer, ``wqkv`` is the contiguous ``[d, (H + 2 Hkv) hd]`` concat of
    the flattened Q/K/V projections and ``w_gateup`` the ``[d, 2 f]``
    concat of gate and up (of the dense MLP, or of an MoE layer's shared
    experts; the expert stacks are read in place); ``head_t`` is one
    contiguous K-major ``[d, vocab]`` copy of the tied head (the GEMV
    kernels refuse the strided ``embed.T`` view rather than copy 206 MB
    per token).

    The originals stay, as in the JAX package: prefill and the unfused
    decode path (``fuse_programs=False``) read them.  Returns a NEW dict;
    ``params``' own tensors are shared, not copied.
    """
    d = cfg.d_model
    packed = dict(params)
    packed["layers"] = []
    def gateup(m: dict) -> dict:
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
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    packed["head_t"] = head.contiguous()
    return packed


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: dict | None = None,
            gemv_policy=None) -> tuple[torch.Tensor, dict | None,
                                       torch.Tensor]:
    """Returns ``(logits [B, S, vocab], new_cache, aux_loss)``.

    With a cache, the new K/V are written into ``cache``'s ``k``/``v``
    tensors (and, for a quantized store, their codes and ``k_scale`` /
    ``v_scale``) IN PLACE and ``new_cache`` shares them (with ``pos``
    advanced by S).  ``gemv_policy`` routes single-token (decode) projections
    through the GEMV dispatcher: QKV and gate+up as fused programs, down
    and the LM head as single requests, MoE experts as ragged or grouped
    programs (``gemv_policy.expert_shape``).  Prefill (S > 1) keeps the
    plain matmul path.  ``aux_loss`` sums the MoE layers' load-balance
    losses (0 for a dense model).
    """
    B, Sq = tokens.shape
    dtype = torch_dtype(cfg.compute_dtype)
    x = params["embed"][tokens].to(dtype)
    # sqrt(d_model) rounded to the compute dtype, as the JAX package does;
    # kept a Python scalar so no host tensor is copied to the card
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
    x = x * scale.to(dtype).item()

    pos0 = cache["pos"] if cache is not None else torch.zeros(
        (), dtype=torch.int32, device=x.device)
    positions = (pos0.reshape(-1, 1)
                 + torch.arange(Sq, device=x.device)[None, :]).expand(B, Sq)

    x, aux = _forward_flat(params, cfg, x, positions, cache, gemv_policy)

    x = L.apply_norm(params["ln_f"], x, cfg)
    if "head_t" in params:
        head = params["head_t"]
    else:
        head = params["embed"].t() if cfg.tie_embeddings \
            else params["lm_head"]
    if gemv_policy is not None and Sq == 1:
        from repro_torch.kernels.dispatch import dispatch_dense

        logits = dispatch_dense(x, head.to(dtype), policy=gemv_policy)
    else:
        logits = torch.einsum("bsd,dv->bsv", x, head.to(dtype))
    new_cache = None
    if cache is not None:
        new_cache = {**cache, "pos": pos0 + Sq}
    return logits, new_cache, aux


def _forward_flat(params, cfg, x, positions, cache, gemv=None):
    """The layer stack as a Python loop (``lax.scan`` in the JAX package):
    pre-norm attention and FFN (or MoE) blocks with residuals; returns
    ``(x, aux_loss)``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(params["layers"]):
        h = L.apply_norm(p["ln1"], x, cfg)
        cache_kv = (cache["k"][i], cache["v"][i]) if cache is not None \
            else None
        cache_scales = ((cache["k_scale"][i], cache["v_scale"][i])
                        if cache is not None and "k_scale" in cache
                        else None)
        x = x + L.apply_attention(
            p["attn"], h, cfg, positions=positions, cache_kv=cache_kv,
            cache_pos=cache["pos"] if cache is not None else None,
            cache_scales=cache_scales, gemv=gemv)
        h = L.apply_norm(p["ln2"], x, cfg)
        if "moe" in p:
            ff, aux_l = L.apply_moe(p["moe"], h, cfg, gemv=gemv)
            aux = aux + aux_l
        else:
            ff = L.apply_mlp(p["mlp"], h, cfg, gemv=gemv)
        x = x + ff
    return x, aux
