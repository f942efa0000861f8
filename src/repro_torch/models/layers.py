"""Building blocks of the decoder (counterpart of ``repro/models/layers.py``):
norms, rotary embedding, attention, the dense FFN and the mixture of
experts.

Conventions follow the JAX package so the two compare like with like:
activations are ``[batch, seq, d_model]``; projections are stored K-major
(``wq [d, H, hd]``, ``w_up [d, f]``, expert stacks ``w_up [E, d, f]``);
norm and softmax statistics run in f32 whatever the compute dtype.
Parameters are plain dicts of tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention import (
    decode_attention,
    decode_attention_plain,
    kernel_applies,
)
from repro_torch.kernels.backends.base import expert_batch_bound
from repro_torch.kernels.kv_quant import dequantize_page, quantize_page


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
                   causal: bool, k_scale: torch.Tensor | None = None,
                   v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, Hkv, D] -> [B, Sq, H, D].

    One new token a slot on the card (the decode step) runs the
    ``decode_attention`` kernel, which reads the cache where it lies;
    every other call (prefill, the CPU) runs the plain arithmetic
    (``decode_attention_plain``: f32 scores of the bf16 operands,
    ``BIG_NEG`` masking, f32 softmax, probabilities cast to ``v.dtype``).
    The choice is :func:`~repro_torch.kernels.attention.kernel_applies`,
    a rule on shapes, strides and the device.  With ``k_scale`` /
    ``v_scale`` ([B, Sk, Hkv]) k / v are a quantized store's codes: the
    kernel reads them in place; the plain path dequantizes them to
    ``q.dtype`` first (``dequantize_page``).
    """
    if kernel_applies(q, k, v, causal=causal, k_scale=k_scale,
                      v_scale=v_scale):
        return decode_attention(q, k, v, q_positions=q_positions,
                                kv_valid_len=kv_valid_len, k_scale=k_scale,
                                v_scale=v_scale)
    if k_scale is not None:
        hd = q.shape[-1]
        k = dequantize_page(k, k_scale, hd=hd, out_dtype=q.dtype)
        v = dequantize_page(v, v_scale, hd=hd, out_dtype=q.dtype)
    return decode_attention_plain(q, k, v, q_positions=q_positions,
                                  kv_valid_len=kv_valid_len, causal=causal)


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
    and scales are written at the same offsets, and ``attention_core``
    takes the codes and scales (a decode step on the card reads them in
    place; prefill and the CPU dequantize the cache to ``x.dtype``).
    With a ``gemv``
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
        ks = vs = None
        if cache_scales is not None:
            ks, vs = cache_scales
            bits = 8 if ck.shape[-1] == hd else 4
            for codes, scales, page in ((ck, ks, k), (cv, vs, v)):
                q_new, s_new = quantize_page(page, bits)
                write_kv(codes, q_new, pos)
                write_kv(scales, s_new, pos)
        else:
            write_kv(ck, k, pos)
            write_kv(cv, v, pos)
        out = attention_core(q, ck, cv, q_positions=positions,
                             kv_valid_len=pos + S, causal=True, k_scale=ks,
                             v_scale=vs)
    else:
        out = attention_core(q, k, v, q_positions=positions,
                             kv_valid_len=None, causal=True)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# --------------------------------------------------------------------------
# Dense FFN
# --------------------------------------------------------------------------


def init_mlp(generator, cfg: ModelConfig, dtype, device, *,
             d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
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


# --------------------------------------------------------------------------
# Mixture of experts (sort-based routing; GShard capacity semantics)
# --------------------------------------------------------------------------


def init_moe(generator, cfg: ModelConfig, dtype, device) -> dict:
    """Router ``[d, E]`` in f32, expert stacks ``w_gate``/``w_up [E, d, f]``
    and ``w_down [E, f, d]``, and the shared experts as one MLP of width
    ``n_shared * d_expert``."""
    e = cfg.moe
    d, f, E = cfg.d_model, e.d_expert, e.n_experts
    p = {
        "router": dense_init(generator, d, (d, E), torch.float32, device),
        "w_up": dense_init(generator, d, (E, d, f), dtype, device),
        "w_down": dense_init(generator, f, (E, f, d), dtype, device),
    }
    if cfg.act == "silu":
        p["w_gate"] = dense_init(generator, d, (E, d, f), dtype, device)
    if e.n_shared:
        p["shared"] = init_mlp(generator, cfg, dtype, device,
                               d_ff=e.n_shared * f)
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert per sequence (``layers._capacity``): GShard's
    bound, dropless while ``n_tokens * top_k <= 4096``, a multiple of 8."""
    e = cfg.moe
    c = math.ceil(n_tokens * e.top_k * e.capacity_factor / e.n_experts)
    if n_tokens * e.top_k <= 4096:
        c = max(c, n_tokens * e.top_k)
    return max(8, ((c + 7) // 8) * 8)


def _route_tokens(top_i: torch.Tensor, top_p: torch.Tensor, n_experts: int,
                  top_k: int):
    """Capacity-free routing plan of one flat token chunk (``top_i`` /
    ``top_p`` ``[T, k]``): ``(st, se, sw, counts)``, the source token,
    expert and router weight of every (token, expert) pair in stable
    expert-sorted order, and the int32 per-expert counts ``[E]``.

    Everything stays on the device: the counts come from a search in the
    sorted experts, not from a host-side bincount.
    """
    T = top_i.shape[0]
    dev = top_i.device
    flat_t = torch.arange(T * top_k, device=dev) // top_k
    se, order = torch.sort(top_i.reshape(-1), stable=True)
    st = flat_t[order]
    sw = top_p.reshape(-1)[order]
    edges = torch.arange(n_experts + 1, device=dev)
    counts = torch.diff(torch.searchsorted(se, edges, out_int32=True))
    return st, se, sw, counts


def _combine(out: torch.Tensor, sw: torch.Tensor, st: torch.Tensor,
             n_tokens: int, top_k: int) -> torch.Tensor:
    """``y[t] = sum of out[i] * sw[i] over the pairs i of token t`` in a
    fixed order: ascending sorted position, each add rounded in
    ``out.dtype``, from a zero start -- the order of the JAX package's
    ``.at[st].add``.  A gather and ``top_k`` adds instead of an atomic
    ``index_add_``, so the sum is the same in every run."""
    contrib = out * sw[:, None].to(out.dtype)
    pos = torch.sort(st, stable=True).indices.view(n_tokens, top_k)
    gathered = contrib[pos]                          # [T, k, d]
    y = torch.zeros((n_tokens, out.shape[-1]), dtype=out.dtype,
                    device=out.device)
    for j in range(top_k):
        y = y + gathered[:, j]
    return y


def _router(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """``(probs [B, S, E], top_p, top_i [B, S, k])``: the router product of
    x and the router cast to x's type with f32 accumulation (exact
    products: the casts to f32 lose nothing), softmax, top-k and
    renormalisation."""
    logits = torch.matmul(x.float(), p["router"].to(x.dtype).float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.moe.top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, top_p, top_i


def _aux_loss(probs: torch.Tensor, counts: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balance loss over all tokens, from the per-expert
    pair counts of the whole batch (the one-hot sums of the JAX code)."""
    e = cfg.moe
    n_tok = probs.shape[0] * probs.shape[1]
    me = probs.mean(dim=(0, 1))
    ce = counts.float() / n_tok / e.top_k
    return e.n_experts * (me * ce).sum() * e.router_aux_weight


def _expert_ffn(p: dict, t: torch.Tensor, cfg: ModelConfig, proj):
    """SwiGLU expert FFN over expert-sorted rows; ``proj(t, w)`` runs one
    projection of the stack."""
    if cfg.act != "silu":
        raise ValueError(f"activation {cfg.act!r} is not ported yet")
    h = F.silu(proj(t, p["w_gate"])) * proj(t, p["w_up"])
    return proj(h, p["w_down"])


def _moe_ragged_decode(p, x, cfg, gemv, top_i, top_p):
    """Decode-step expert FFNs through the ragged program shape.

    Tokens flatten to ONE expert-sorted ``[T*k, d]`` buffer (T = B*S): no
    ``[E, C, ...]`` capacity buffer exists, so padding is zero
    (``padded_slots=0``).  The three projections share one routing plan
    and one counts vector, device data from end to end: no host sync.
    """
    from repro_torch.kernels.dispatch import dispatch_ragged, \
        record_expert_load

    e = cfg.moe
    B, S, d = x.shape
    st, se, sw, counts = _route_tokens(
        top_i.reshape(B * S, e.top_k), top_p.reshape(B * S, e.top_k),
        e.n_experts, e.top_k)
    xr = x.reshape(B * S, d)[st]                 # [T*k, d], expert-sorted
    bound = expert_batch_bound(B * S, e.top_k, e.n_experts)
    record_expert_load(routed_tokens=B * S * e.top_k, experts=e.n_experts,
                       max_tokens=bound, padded_slots=0)

    def proj(t, w):
        return dispatch_ragged(t, counts, w, bound=bound, policy=gemv)

    out = _expert_ffn(p, xr, cfg, proj)          # [T*k, d]
    y = _combine(out, sw, st, B * S, e.top_k)
    return y.reshape(B, S, d), counts


def _capacity_plan(top_i: torch.Tensor, top_p: torch.Tensor, C: int,
                   n_experts: int):
    """The per-sequence capacity plan of ``_dispatch_chunk`` for the whole
    batch at once.  Pairs are sorted stably by (expert, sequence), so each
    expert's rows are contiguous and, within a sequence, in the JAX
    package's order; a pair's slot is its rank within its (sequence,
    expert) and it is kept iff the slot is ``< C``.  Returns ``(st, se, sb,
    sw, slot, keep, counts)`` (``st`` indexes the flat ``B * S`` tokens,
    ``counts`` the pairs per expert over the batch)."""
    B, S, k = top_i.shape
    dev = top_i.device
    flat_t = torch.arange(B * S * k, device=dev) // k    # flat token
    flat_b = flat_t // S
    key = top_i.reshape(-1) * B + flat_b
    skey, order = torch.sort(key, stable=True)
    st, sw = flat_t[order], top_p.reshape(-1)[order]
    se, sb = skey // B, skey % B
    starts = torch.searchsorted(
        skey, torch.arange(n_experts * B + 1, device=dev))
    rank = torch.arange(B * S * k, device=dev) - starts[skey]
    keep = rank < C
    slot = torch.where(keep, rank, C - 1)
    counts = torch.diff(starts[::B])
    return st, se, sb, sw, slot, keep, counts


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
              gemv=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> ``(y, aux_loss)``.

    With a ``gemv`` DispatchPolicy, fusing on and a single-token input
    (decode), ``gemv.expert_shape`` picks the execution shape:
    ``"ragged"`` (default; :func:`_moe_ragged_decode`) or ``"grouped"``
    (the capacity-padded ``[E, B*C, d]`` buffers through one grouped
    program per projection).  Everything else -- prefill, ``"einsum"``,
    fusing off -- computes the JAX package's per-sequence capacity
    semantics (GShard slots, drops past ``C``).  At one token a sequence
    (decode) that is the JAX package's capacity einsum: the ``[E, B*C, d]``
    buffers of the grouped shape, one batched ``torch.matmul`` per
    projection, nothing read back to the host (the step is captured).
    Prefill computes it WITHOUT the ``[B, E, C, d]`` buffer: the expert
    FFN is row-wise, so each kept pair's output is the FFN of its token,
    computed per expert over the expert-sorted pairs with
    ``torch.matmul``; a dropped pair contributes zero.  That path reads
    the per-expert offsets on the host once per layer.

    The shared experts' MLP is added last, through the dispatcher like a
    dense MLP.
    """
    e = cfg.moe
    B, S, d = x.shape
    probs, top_p, top_i = _router(p, x, cfg)
    expert_shape = gemv.expert_shape if gemv is not None else "einsum"
    if expert_shape not in ("ragged", "grouped", "einsum"):
        raise ValueError(f"unknown expert_shape {expert_shape!r}")
    use_programs = (gemv is not None and S == 1 and gemv.fuse_programs
                    and expert_shape != "einsum")
    if use_programs and expert_shape == "ragged":
        y, counts = _moe_ragged_decode(p, x, cfg, gemv, top_i, top_p)
    elif use_programs:
        y, counts = _moe_grouped_decode(p, x, cfg, gemv, top_i, top_p)
    else:
        y, counts = _moe_capacity(p, x, cfg, top_i, top_p)
    aux = _aux_loss(probs, counts, cfg)
    if e.n_shared:
        y = y + apply_mlp(p["shared"], x, cfg, gemv=gemv)
    return y, aux


def _moe_grouped_decode(p, x, cfg, gemv, top_i, top_p):
    """Decode through grouped programs: the capacity buffers, one grouped
    program per projection (:func:`_moe_capacity_buffers`)."""
    from repro_torch.kernels.dispatch import dispatch_grouped, \
        record_expert_load

    e = cfg.moe
    B, S, _ = x.shape
    C = _capacity(S, cfg)
    record_expert_load(routed_tokens=B * S * e.top_k, experts=e.n_experts,
                       max_tokens=C,
                       padded_slots=max(B * e.n_experts * C
                                        - B * S * e.top_k, 0))
    return _moe_capacity_buffers(
        p, x, cfg, top_i, top_p,
        lambda t, w: dispatch_grouped(t, w, policy=gemv))


def _moe_capacity_buffers(p, x, cfg, top_i, top_p, proj):
    """The capacity buffers of the JAX package, laid out ``[E, B*C, d]``
    (row ``b*C + slot`` of expert e), ``proj(t, w)`` once per projection
    over the whole stack, then the capacity combine.  Device data from end
    to end: no host sync."""
    e = cfg.moe
    B, S, d = x.shape
    C = _capacity(S, cfg)
    st, se, sb, sw, slot, keep, counts = _capacity_plan(top_i, top_p, C,
                                                        e.n_experts)
    rows = B * C
    # a dropped pair lands in one spare row past the buffer, never read
    dest = torch.where(keep, se * rows + sb * C + slot, e.n_experts * rows)
    buf = torch.zeros((e.n_experts * rows + 1, d), dtype=x.dtype,
                      device=x.device)
    buf[dest] = x.reshape(B * S, d)[st]
    buf = buf[:-1].view(e.n_experts, rows, d)
    out = _expert_ffn(p, buf, cfg, proj).reshape(e.n_experts * rows, d)
    kept_w = sw * keep.to(sw.dtype)
    y = _combine(out[se * rows + sb * C + slot], kept_w, st, B * S, e.top_k)
    return y.reshape(B, S, d), counts


def _moe_capacity(p, x, cfg, top_i, top_p):
    """The capacity semantics off the programs (see :func:`apply_moe`):
    the capacity einsum at decode, the per-expert loop at prefill."""
    e = cfg.moe
    B, S, d = x.shape
    if S == 1:
        return _moe_capacity_buffers(p, x, cfg, top_i, top_p, torch.matmul)
    st, _, _, sw, _, keep, counts = _capacity_plan(
        top_i, top_p, _capacity(S, cfg), e.n_experts)
    xr = x.reshape(B * S, d)[st]
    offs = [0] + torch.cumsum(counts, 0).tolist()
    out = torch.zeros_like(xr)
    for i in range(e.n_experts):
        lo, hi = offs[i], offs[i + 1]
        if hi > lo:
            out[lo:hi] = _expert_ffn(p, xr[lo:hi], cfg,
                                     lambda t, w, i=i: t @ w[i])
    y = _combine(out, sw * keep.to(sw.dtype), st, B * S, e.top_k)
    return y.reshape(B, S, d), counts
