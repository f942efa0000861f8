"""Dense building blocks of the decoder (counterpart of
``repro/models/layers.py``).

Conventions follow the JAX package so the two compare like with like:
activations are ``[batch, seq, d_model]``; projections are stored K-major
(``wq [d, H, hd]``, ``w_up [d, f]``); norm and softmax statistics run in
f32 whatever the compute dtype.  Parameters are plain dicts of tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.kv_quant import dequantize_page, quantize_page

BIG_NEG = -2.0e9


def dense_init(generator: torch.Generator, fan_in: int, shape, dtype,
               device) -> torch.Tensor:
    """N(0, 1/fan_in) in f32, cast to ``dtype`` (``layers._dense_init``)."""
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, d: int, dtype, device) -> dict:
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(d, dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}
    return {}  # non-parametric LN (olmo)


def apply_norm(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm, LayerNorm or the non-parametric LN, in f32, eps 1e-6; the
    variance is the population variance (``jnp.var``)."""
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6)
        return (out * p["scale"].float()).to(x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + 1e-6)
    if cfg.norm_type == "layernorm":
        out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embedding
# --------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split rotary embedding in f32.  x: [B, S, H, D]; positions:
    [B, S] (or [S])."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.arange(half, dtype=torch.float32, device=x.device)
    inv = theta ** (-freqs / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * inv            # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA, causal)
# --------------------------------------------------------------------------


def init_attention(generator, cfg: ModelConfig, dtype, device) -> dict:
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": dense_init(generator, d, (d, cfg.n_heads, hd), dtype, device),
        "wk": dense_init(generator, d, (d, cfg.n_kv_heads, hd), dtype,
                         device),
        "wv": dense_init(generator, d, (d, cfg.n_kv_heads, hd), dtype,
                         device),
        "wo": dense_init(generator, cfg.n_heads * hd, (cfg.n_heads, hd, d),
                         dtype, device),
    }


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_positions: torch.Tensor | None,
                   kv_valid_len: torch.Tensor | None,
                   causal: bool) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, Hkv, D] -> [B, Sq, H, D].

    Scores are the f32 product of the (bf16) operands over sqrt(D) -- the
    casts below make the products exact, as ``preferred_element_type=f32``
    does; masked scores are ``BIG_NEG`` (not -inf); the probabilities are
    cast to ``v.dtype`` before the PV product.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(D)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((B, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, None, :] <= q_positions[:, :, None]
    if kv_valid_len is not None:
        vl = kv_valid_len
        vl = vl[:, None, None] if vl.ndim == 1 else vl
        mask &= kpos[None, None, :] < vl
    # a Python scalar, not a host tensor: copying one to the card per layer
    # would wait for the stream and serialize host and device
    scores = torch.where(mask[:, None, None, :, :], scores, BIG_NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, D)


def write_kv(cache: torch.Tensor, new: torch.Tensor,
             pos: torch.Tensor) -> None:
    """Write ``new`` [B, S, ...] into ``cache`` [B, C, ...] (K/V pages, or
    their scales) at each slot's offset ``pos`` [B], IN PLACE (the port
    keeps one KV buffer instead of returning a fresh cache per step).

    The start clamps to ``[0, C - S]`` exactly as the JAX package's
    ``dynamic_update_slice`` does, so a row whose offset ran past the end
    (an idle slot inside the decode bucket) overwrites its own last
    positions instead of faulting.
    """
    B, S = new.shape[:2]
    C = cache.shape[1]
    start = torch.clamp(pos, 0, C - S)
    idx = start[:, None] + torch.arange(S, device=cache.device)[None, :]
    rows = torch.arange(B, device=cache.device)[:, None]
    cache[rows, idx] = new.to(cache.dtype)


def apply_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor,
                    cache_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
                    cache_pos: torch.Tensor | None = None,
                    cache_scales: tuple[torch.Tensor, torch.Tensor]
                    | None = None,
                    gemv=None) -> torch.Tensor:
    """Self-attention with an optional per-slot KV cache.

    ``cache_kv`` is ``([B, C, Hkv, D], [B, C, Hkv, D])``; the new K/V are
    written in place at each slot's ``cache_pos`` and attention runs over
    the cache.  With ``cache_scales`` (``[B, C, Hkv]`` each) the store is
    quantized: the fresh rope'd pages are encoded (``kv_quant``), codes
    and scales are written at the same offsets, and the whole cache is
    dequantized to ``x.dtype`` before ``attention_core``.  With a ``gemv``
    DispatchPolicy and a single-token input the Q/K/V projections run as
    ONE fused GEMV program (the prepacked ``wqkv`` when present).
    """
    B, S, d = x.shape
    hd = cfg.hd
    if gemv is not None and S == 1 and gemv.fuse_programs:
        from repro_torch.kernels.dispatch import (
            dispatch_fused,
            dispatch_prepacked,
        )

        if "wqkv" in p:
            splits = (cfg.n_heads * hd, cfg.n_kv_heads * hd,
                      cfg.n_kv_heads * hd)
            q2, k2, v2 = dispatch_prepacked(x.reshape(B, d), p["wqkv"],
                                            splits, policy=gemv)
        else:
            q2, k2, v2 = dispatch_fused(
                x.reshape(B, d),
                [p["wq"].reshape(d, -1), p["wk"].reshape(d, -1),
                 p["wv"].reshape(d, -1)], policy=gemv)
        q = q2.reshape(B, S, -1, hd)
        k = k2.reshape(B, S, -1, hd)
        v = v2.reshape(B, S, -1, hd)
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache_kv is not None:
        ck, cv = cache_kv
        pos = cache_pos.expand(B) if cache_pos.ndim == 0 else cache_pos
        if cache_scales is not None:
            ks, vs = cache_scales
            bits = 8 if ck.shape[-1] == hd else 4
            for codes, scales, page in ((ck, ks, k), (cv, vs, v)):
                q_new, s_new = quantize_page(page, bits)
                write_kv(codes, q_new, pos)
                write_kv(scales, s_new, pos)
            kf = dequantize_page(ck, ks, hd=hd, out_dtype=x.dtype)
            vf = dequantize_page(cv, vs, hd=hd, out_dtype=x.dtype)
        else:
            write_kv(ck, k, pos)
            write_kv(cv, v, pos)
            kf, vf = ck, cv
        out = attention_core(q, kf, vf, q_positions=positions,
                             kv_valid_len=pos + S, causal=True)
    else:
        out = attention_core(q, k, v, q_positions=positions,
                             kv_valid_len=None, causal=True)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# --------------------------------------------------------------------------
# Dense FFN
# --------------------------------------------------------------------------


def init_mlp(generator, cfg: ModelConfig, dtype, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "w_up": dense_init(generator, d, (d, f), dtype, device),
        "w_down": dense_init(generator, f, (f, d), dtype, device),
    }
    if cfg.act == "silu":
        p["w_gate"] = dense_init(generator, d, (d, f), dtype, device)
    return p


def apply_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig,
              gemv=None) -> torch.Tensor:
    """SwiGLU FFN.  With a ``gemv`` DispatchPolicy and a single-token input
    the projections route through the GEMV dispatcher; gate and up share
    their input, so they run as ONE fused program (the prepacked
    ``w_gateup`` when present)."""
    if cfg.act != "silu":
        raise ValueError(f"activation {cfg.act!r} is not ported yet")
    decode_gemv = gemv is not None and x.shape[1] == 1
    if decode_gemv:
        from repro_torch.kernels.dispatch import (
            dispatch_dense,
            dispatch_fused,
            dispatch_prepacked,
        )

        def mm(a, w):
            return dispatch_dense(a, w, policy=gemv)
    else:
        def mm(a, w):
            return a @ w

    if decode_gemv and gemv.fuse_programs:
        B, S, d = x.shape
        if "w_gateup" in p:
            f = p["w_up"].shape[-1]
            g2, u2 = dispatch_prepacked(x.reshape(B * S, d), p["w_gateup"],
                                        (f, f), policy=gemv)
        else:
            g2, u2 = dispatch_fused(x.reshape(B * S, d),
                                    [p["w_gate"], p["w_up"]], policy=gemv)
        gate = g2.reshape(B, S, -1)
        up = u2.reshape(B, S, -1)
        return mm(F.silu(gate) * up, p["w_down"])

    up = mm(x, p["w_up"])
    return mm(F.silu(mm(x, p["w_gate"])) * up, p["w_down"])
