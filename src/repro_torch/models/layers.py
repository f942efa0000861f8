"""Building blocks of the decoder (counterpart of ``repro/models/layers.py``):
norms, rotary embedding, self- and cross-attention, the dense FFN and the
mixture of experts.

Conventions follow the JAX package so the two compare like with like:
activations are ``[batch, seq, d_model]``; projections are stored K-major
(``wq [d, H, hd]``, ``w_up [d, f]``, expert stacks ``w_up [E, d, f]``);
norm and softmax statistics run in f32 whatever the compute dtype.
Parameters are plain dicts of tensors.

Under a mesh (``repro_torch.distributed.axes.activation_mesh``, which
``Engine(mesh=)`` installs) a layer finds its tensors already cut to this
rank's block (``distributed.sharding.shard_params``) and tells what it
holds from their shapes: ``wq`` with fewer heads than the config's is a
rank's heads (its ``wqkv`` block ``[q_r | k_r | v_r]``, ``wo``'s row
block: the attention output is a partial sum, all-reduced over the
'model' group; so for a cross-attention layer, and for whisper's encoder
layers against the encoder's own heads, ``lm.run_encoder``); an FFN
narrower than its full width is a rank's columns (the down projection's
partial is all-reduced); an expert stack with fewer experts than the
config's is a rank's whole experts (each rank runs its experts' rows,
the combine is all-reduced).  Where the
reference's GSPMD pinned a replicated layout, the layers issue the
collective.  Under autograd (a training step on a 'model' axis) the
replicated input of each rank block passes through
``collectives.enter`` (its gradient summed over the group) and the
all-reduce's backward passes the gradient on; a branch every rank
computes whole (norms, the router, shared experts beside sharded ones)
gets no ``enter``, since its gradient is whole on every rank already.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.axes import current_mesh
from repro_torch.distributed.collectives import (
    all_reduce_sum,
    enter,
    group_size,
    records_grad,
)
from repro_torch.kernels.attention import (
    decode_attention,
    decode_attention_plain,
    kernel_applies,
)
from repro_torch.kernels.backends.base import expert_batch_bound
from repro_torch.kernels.kv_quant import dequantize_page, quantize_page


GATED = ("silu", "geglu")   # activations with a gate projection


def model_group():
    """The 'model' axis group of the active mesh, which a layer holding a
    rank's block needs for its collective (raises without one)."""
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("a rank's block of a sharded model runs under "
                           "its mesh (distributed.axes.activation_mesh)")
    return mesh.group("model")


def model_index() -> int:
    """This rank's index along the active mesh's 'model' axis (0)."""
    mesh = current_mesh()
    return 0 if mesh is None else mesh.index("model")


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
# Attention (GQA, causal, optionally over a sliding window)
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
                   v_scale: torch.Tensor | None = None,
                   window: int = 0) -> torch.Tensor:
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
    ``q.dtype`` first (``dequantize_page``).  ``window`` (a Python int, 0
    for no limit) is a local layer's sliding window: a causal query at
    position p attends to ``[p - window + 1, p]``, as the JAX package's
    mask has it.
    """
    if kernel_applies(q, k, v, causal=causal, k_scale=k_scale,
                      v_scale=v_scale):
        return decode_attention(q, k, v, q_positions=q_positions,
                                kv_valid_len=kv_valid_len, k_scale=k_scale,
                                v_scale=v_scale, window=window)
    if k_scale is not None:
        hd = q.shape[-1]
        k = dequantize_page(k, k_scale, hd=hd, out_dtype=q.dtype)
        v = dequantize_page(v, v_scale, hd=hd, out_dtype=q.dtype)
    return decode_attention_plain(q, k, v, q_positions=q_positions,
                                  kv_valid_len=kv_valid_len, causal=causal,
                                  window=window)


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
                    gemv=None, window: int = 0) -> torch.Tensor:
    """Self-attention with an optional per-slot KV cache, over the layer's
    sliding ``window`` (0: no limit).

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
    # a rank's heads under a mesh: H_l query heads, Hkv_l kv heads (all of
    # them when the serving cache replicates KV)
    H_l, Hkv_l = p["wq"].shape[1], p["wk"].shape[1]
    sharded = H_l != cfg.n_heads
    if sharded:     # under autograd, the rank's heads' input (and the
        # whole K / V projections a rank reads one kv head of)
        x = enter(x, model_group())
        if Hkv_l == cfg.n_kv_heads:
            p = {**p, "wk": enter(p["wk"], model_group()),
                 "wv": enter(p["wv"], model_group())}
    if gemv is not None and S == 1 and gemv.fuse_programs:
        from repro_torch.kernels.dispatch import (
            dispatch_fused,
            dispatch_prepacked,
        )

        axis = "M" if sharded else "replicated"
        if "wqkv" in p:
            splits = (H_l * hd, Hkv_l * hd, Hkv_l * hd)
            q2, k2, v2 = dispatch_prepacked(x.reshape(B, d), p["wqkv"],
                                            splits, policy=gemv, shard=axis)
        else:
            q2, k2, v2 = dispatch_fused(
                x.reshape(B, d),
                [p["wq"].reshape(d, -1), p["wk"].reshape(d, -1),
                 p["wv"].reshape(d, -1)], policy=gemv, shard=axis)
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
        if sharded and Hkv_l == cfg.n_kv_heads:
            ck, cv, ks, vs = _own_kv(cfg, H_l, ck, cv, ks, vs)
        out = attention_core(q, ck, cv, q_positions=positions,
                             kv_valid_len=pos + S, causal=True, k_scale=ks,
                             v_scale=vs, window=window)
    else:
        if sharded and Hkv_l == cfg.n_kv_heads:
            k, v, _, _ = _own_kv(cfg, H_l, k, v, None, None)
        out = attention_core(q, k, v, q_positions=positions,
                             kv_valid_len=None, causal=True, window=window)
    o = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    # wo holds the rank's heads' rows: its product is a partial sum
    return all_reduce_sum(o, model_group()) if sharded else o


def _own_kv(cfg: ModelConfig, H_l: int, k, v, ks, vs):
    """With KV replicated (kv heads do not divide the shards) a rank's
    ``H_l`` query heads share one kv head (``attention_shardable``
    admits only that case): its slice of ``k`` / ``v`` ``[B, S, Hkv, ...]`` and of the
    scales ``[B, S, Hkv]``."""
    h = model_index() * H_l // (cfg.n_heads // cfg.n_kv_heads)

    def one(t):
        return None if t is None else t[:, :, h:h + 1]

    return one(k), one(v), one(ks), one(vs)


def init_cross_attention(generator, cfg: ModelConfig, d_kv: int, dtype,
                         device) -> dict:
    """``wq [d, H, hd]``, ``wk``/``wv [d_kv, Hkv, hd]``, ``wo [H, hd, d]``
    (``layers.init_cross_attention``)."""
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": dense_init(generator, d, (d, cfg.n_heads, hd), dtype, device),
        "wk": dense_init(generator, d_kv, (d_kv, cfg.n_kv_heads, hd), dtype,
                         device),
        "wv": dense_init(generator, d_kv, (d_kv, cfg.n_kv_heads, hd), dtype,
                         device),
        "wo": dense_init(generator, cfg.n_heads * hd, (cfg.n_heads, hd, d),
                         dtype, device),
    }


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matmul whose ``[B, S, H, hd]``
    result is contiguous (the attention kernel reads its rows)."""
    B, S, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])


def apply_cross_attention(p: dict, x: torch.Tensor, ctx: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """x ``[B, Sq, d]`` queries over ctx ``[B, Sk, d_kv]``: no mask, no
    rope; K and V are projected from ``ctx`` on every call, as the JAX
    package does.

    At one query a slot (the decode step) the non-causal query over all
    ``Sk`` keys is computed in its causal form, a query at position
    ``Sk - 1`` (the same function: no key lies past it), which is the
    form ``decode_attention`` takes: on the card the kernel runs it over
    the freshly projected K / V.  Every other call is the plain
    non-causal path.

    Under a mesh the leaves hold a rank's heads (``wq`` / ``wk`` / ``wv``
    its query and kv heads, ``wo`` their rows): the output is a partial
    sum, all-reduced as self-attention's.  Where the kv heads do not
    divide, ``wk`` / ``wv`` are whole and the rank projects the one kv
    head its query heads share.  Under autograd ``x`` and ``ctx`` (and
    whole K / V weights) enter the rank's block: their gradients sum
    over the group."""
    B, Sq, _ = x.shape
    H_l, Hkv_l = p["wq"].shape[1], p["wk"].shape[1]
    wk, wv = p["wk"], p["wv"]
    sharded = H_l != cfg.n_heads
    if sharded:
        group = model_group()
        x, ctx = enter(x, group), enter(ctx, group)
        if Hkv_l == cfg.n_kv_heads:
            h = model_index() * H_l // (cfg.n_heads // cfg.n_kv_heads)
            wk = enter(wk, group)[:, h:h + 1]
            wv = enter(wv, group)[:, h:h + 1]
    q = project_heads(x, p["wq"])
    k = project_heads(ctx, wk)
    v = project_heads(ctx, wv)
    if Sq == 1:
        qpos = torch.full((B, 1), ctx.shape[1] - 1, dtype=torch.int32,
                          device=x.device)
        out = attention_core(q, k, v, q_positions=qpos, kv_valid_len=None,
                             causal=True)
    else:
        out = attention_core(q, k, v, q_positions=None, kv_valid_len=None,
                             causal=False)
    o = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return all_reduce_sum(o, group) if sharded else o


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
    if cfg.act in GATED:
        p["w_gate"] = dense_init(generator, d, (d, f), dtype, device)
    return p


def activate(act: str, up: torch.Tensor,
             gate: torch.Tensor | None = None) -> torch.Tensor:
    """The FFN's hidden activation, as the JAX package computes it:
    ``silu(gate) * up`` (swiglu), ``gelu(gate) * up`` (geglu),
    ``gelu(up)`` or ``relu(up) ** 2`` (relu2).  ``jax.nn.gelu`` defaults
    to the tanh approximation, and so does this."""
    if act == "silu":
        return F.silu(gate) * up
    if act == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if act == "gelu":
        return F.gelu(up, approximate="tanh")
    if act == "relu2":
        return torch.square(F.relu(up))
    raise ValueError(f"unknown activation {act!r}")


def apply_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig, gemv=None, *,
              d_ff: int | None = None) -> torch.Tensor:
    """The FFN (:func:`activate`).  With a ``gemv`` DispatchPolicy and a
    single-token input the projections route through the GEMV dispatcher;
    a gated FFN's gate and up share their input, so they run as ONE fused
    program (the prepacked ``w_gateup`` when present); an ungated one
    sends up and down as single requests.  ``d_ff`` is the full width
    (default ``cfg.d_ff``): narrower weights are a rank's columns, and
    the down projection's partial is all-reduced."""
    y, partial = mlp_partial(p, x, cfg, gemv, d_ff=d_ff)
    return all_reduce_sum(y, model_group()) if partial else y


def mlp_partial(p: dict, x: torch.Tensor, cfg: ModelConfig, gemv=None, *,
                d_ff: int | None = None) -> tuple[torch.Tensor, bool]:
    """:func:`apply_mlp` before its collective: ``(y, partial)``, with
    ``partial`` True when ``y`` is this rank's share of a sum over the
    'model' group."""
    partial = (current_mesh() is not None
               and p["w_up"].shape[-1] != (d_ff or cfg.d_ff))
    if partial:     # under autograd, the input of the rank's columns
        x = enter(x, model_group())
    up_axis, down_axis = ("M", "K") if partial else ("replicated",) * 2
    decode_gemv = gemv is not None and x.shape[1] == 1
    if decode_gemv:
        from repro_torch.kernels.dispatch import (
            dispatch_dense,
            dispatch_fused,
            dispatch_prepacked,
        )

        def mm(a, w, axis):
            return dispatch_dense(a, w, policy=gemv, shard=axis)
    else:
        def mm(a, w, axis):
            return a @ w

    if decode_gemv and gemv.fuse_programs and cfg.act in GATED:
        B, S, d = x.shape
        if "w_gateup" in p:
            f = p["w_up"].shape[-1]
            g2, u2 = dispatch_prepacked(x.reshape(B * S, d), p["w_gateup"],
                                        (f, f), policy=gemv, shard=up_axis)
        else:
            g2, u2 = dispatch_fused(x.reshape(B * S, d),
                                    [p["w_gate"], p["w_up"]], policy=gemv,
                                    shard=up_axis)
        gate = g2.reshape(B, S, -1)
        up = u2.reshape(B, S, -1)
        return mm(activate(cfg.act, up, gate), p["w_down"],
                  down_axis), partial

    up = mm(x, p["w_up"], up_axis)
    gate = mm(x, p["w_gate"], up_axis) if cfg.act in GATED else None
    return mm(activate(cfg.act, up, gate), p["w_down"], down_axis), partial


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
    if cfg.act in GATED:
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
              cfg: ModelConfig, batch_group=None) -> torch.Tensor:
    """Switch-style load-balance loss over all tokens, from the per-expert
    pair counts of the whole batch (the one-hot sums of the JAX code).

    With ``batch_group`` (data-parallel training: each rank holds a row
    block of one global batch) the counts are summed over the group
    first, so ``ce`` is the global batch's; with each rank's own ``me``
    the ranks' mean loss and its gradient are the global batch's.  The
    counts are integers and carry no gradient."""
    e = cfg.moe
    n_tok = probs.shape[0] * probs.shape[1]
    if batch_group is not None:
        counts = all_reduce_sum(counts, batch_group)
        n_tok *= group_size(batch_group)
    me = probs.mean(dim=(0, 1))
    ce = counts.float() / n_tok / e.top_k
    return e.n_experts * (me * ce).sum() * e.router_aux_weight


def _expert_ffn(p: dict, t: torch.Tensor, cfg: ModelConfig, proj,
                down=None):
    """The expert FFN over expert-sorted rows; ``proj(t, w)`` runs one
    projection of the stack (``down``, default ``proj``, the down
    projection).  As in the JAX package, an ungated expert applies
    ``gelu`` to up whatever ``cfg.act`` says."""
    if cfg.act in GATED:
        gate = proj(t, p["w_gate"])
        h = activate(cfg.act, proj(t, p["w_up"]), gate)
    else:
        h = activate("gelu", proj(t, p["w_up"]))
    return (down or proj)(h, p["w_down"])


def _moe_ragged_decode(p, x, cfg, gemv, top_i, top_p, n_local=None,
                       axes=("replicated", "replicated")):
    """Decode-step expert FFNs through the ragged program shape.

    Tokens flatten to ONE expert-sorted ``[T*k, d]`` buffer (T = B*S): no
    ``[E, C, ...]`` capacity buffer exists, so padding is zero
    (``padded_slots=0``).  The three projections share one routing plan
    and one counts vector, device data from end to end: no host sync.
    With ``n_local`` (a rank's experts, numbered first in ``top_i``) the
    program runs the stack's ``n_local`` experts over their rows, the
    buffer's first ones; the rows past them come back zero.  ``axes`` are
    the mesh axes gate / up and down are counted under (a rank's f block
    of every expert: "M" and "K").
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

    own = counts if n_local is None else counts[:n_local]

    def proj(axis):
        return lambda t, w: dispatch_ragged(t, own, w, bound=bound,
                                            policy=gemv, shard=axis)

    out = _expert_ffn(p, xr, cfg, *map(proj, axes))     # [T*k, d]
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
              gemv=None, *, batch_group=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> ``(y, aux_loss)``: :func:`moe_partial` with its
    collective."""
    y, aux, partial = moe_partial(p, x, cfg, gemv, batch_group=batch_group)
    return (all_reduce_sum(y, model_group()) if partial else y), aux


def moe_partial(p: dict, x: torch.Tensor, cfg: ModelConfig,
                gemv=None, *, batch_group=None
                ) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """x ``[B, S, d]`` -> ``(y, aux_loss, partial)``.

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
    Prefill computes it WITHOUT the ``[B, E, C, d]`` buffer
    (:func:`_moe_prefill`): the expert FFN is row-wise, so each kept
    pair's output is the FFN of its token, computed over the
    expert-sorted pairs as one grouped product per projection whose
    per-expert offsets stay on the device; a dropped pair contributes
    zero.  Nothing is read back to the host, so a prefill is captured
    too.  :func:`_moe_prefill_loop` is its plain version (the offsets
    read on the host, one product per expert).

    Under autograd (:func:`records_grad`: a training forward) every S
    runs the capacity einsum, the reference's training arithmetic: plain
    ``torch.matmul`` products, which have a backward, where prefill's
    grouped products may reach the ``ragged_gemv`` kernel, which has
    none.  ``batch_group`` is :func:`_aux_loss`'s.

    The shared experts' MLP is added last, through the dispatcher like a
    dense MLP.

    An expert stack with fewer experts than the config's is a rank's
    whole experts (``E_l`` of them from ``rank * E_l``): routing is the
    same on every rank; the expert ids are rotated so the rank's come
    first, each shape above runs the rank's experts over their rows (the
    other pairs weigh zero), and ``y`` is this rank's share of the
    combine (``partial``), summed with the shared experts' share when
    those are sharded too.  Capacity and drops are per expert, so they
    are the unsharded ones.  The router runs whole on every rank; the
    tokens and ``top_p`` go into the rank's experts through ``enter``,
    so the router's gradient sums every rank's experts' share of it.

    A stack of all the experts narrower than ``d_expert`` is a rank's
    block of every expert's ``f`` (``sharding.serve_spec`` where E does
    not divide 'model'), run as the dense FFN's columns are
    (:func:`mlp_partial`): routing, capacity and drops whole and the same
    on every rank, gate and up on the rank's columns (counted "M"), down
    on its rows ("K"), and ``y`` the rank's partial sum, summed in f32
    over 'model' and cast once.
    """
    e = cfg.moe
    B, S, d = x.shape
    probs, top_p, top_i = _router(p, x, cfg)
    n_local = p["w_up"].shape[0]
    cols = p["w_up"].shape[-1] != e.d_expert     # a rank's f of each
    shift = 0
    x_shared = x
    if n_local != e.n_experts:
        shift = model_index() * n_local
        top_i = (top_i - shift) % e.n_experts
        axes = ("E", "E")
    else:
        n_local = None
        axes = ("M", "K") if cols else ("replicated", "replicated")
    partial = n_local is not None or cols
    if partial:
        # under autograd, the tokens and the weights that go into the
        # rank's blocks (the router's gradient through top_p comes only
        # from the rank's own experts or columns here)
        x, top_p = enter(x, model_group()), enter(top_p, model_group())
    expert_shape = gemv.expert_shape if gemv is not None else "einsum"
    if expert_shape not in ("ragged", "grouped", "einsum"):
        raise ValueError(f"unknown expert_shape {expert_shape!r}")
    use_programs = (gemv is not None and S == 1 and gemv.fuse_programs
                    and expert_shape != "einsum")
    if use_programs and expert_shape == "ragged":
        y, counts = _moe_ragged_decode(p, x, cfg, gemv, top_i, top_p,
                                       n_local, axes)
    elif use_programs:
        y, counts = _moe_grouped_decode(p, x, cfg, gemv, top_i, top_p,
                                        n_local, axes)
    elif records_grad(x, p["w_up"]):
        y, counts = _moe_capacity_buffers(p, x, cfg, top_i, top_p,
                                          torch.matmul, n_local)
    else:
        y, counts = _moe_capacity(p, x, cfg, top_i, top_p, n_local)
    if shift:
        counts = torch.roll(counts, shift)      # back to the experts' ids
    aux = _aux_loss(probs, counts, cfg, batch_group)
    if e.n_shared:
        sh, sh_partial = mlp_partial(p["shared"], x_shared, cfg, gemv,
                                     d_ff=e.n_shared * e.d_expert)
        if sh_partial == partial:
            y = y + sh
        elif partial:       # sharded experts beside whole shared ones
            y, partial = all_reduce_sum(y, model_group()) + sh, False
        else:
            y = y + all_reduce_sum(sh, model_group())
    return y, aux, partial


def _moe_grouped_decode(p, x, cfg, gemv, top_i, top_p, n_local=None,
                        axes=("replicated", "replicated")):
    """Decode through grouped programs: the capacity buffers, one grouped
    program per projection (:func:`_moe_capacity_buffers`), gate / up
    and down counted under ``axes``."""
    from repro_torch.kernels.dispatch import dispatch_grouped, \
        record_expert_load

    e = cfg.moe
    B, S, _ = x.shape
    C = _capacity(S, cfg)
    record_expert_load(routed_tokens=B * S * e.top_k, experts=e.n_experts,
                       max_tokens=C,
                       padded_slots=max(B * e.n_experts * C
                                        - B * S * e.top_k, 0))

    def proj(axis):
        return lambda t, w: dispatch_grouped(t, w, policy=gemv, shard=axis)

    return _moe_capacity_buffers(p, x, cfg, top_i, top_p, proj(axes[0]),
                                 n_local, proj(axes[1]))


def _moe_capacity_buffers(p, x, cfg, top_i, top_p, proj, n_local=None,
                          down=None):
    """The capacity buffers of the JAX package, laid out ``[E, B*C, d]``
    (row ``b*C + slot`` of expert e), ``proj(t, w)`` once per projection
    over the whole stack, then the capacity combine.  Device data from end
    to end: no host sync.  With ``n_local`` the buffers hold the first
    ``n_local`` experts only (a rank's); the other pairs weigh zero.
    ``down`` (default ``proj``) runs the down projection."""
    e = cfg.moe
    B, S, d = x.shape
    C = _capacity(S, cfg)
    st, se, sb, sw, slot, keep, counts = _capacity_plan(top_i, top_p, C,
                                                        e.n_experts)
    E = n_local or e.n_experts
    rows = B * C
    kept = keep & (se < E)
    at = torch.where(kept, se * rows + sb * C + slot, 0)
    # a dropped (or another rank's) pair lands in one spare row past the
    # buffer, never read
    dest = torch.where(kept, at, E * rows)
    buf = torch.zeros((E * rows + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = x.reshape(B * S, d)[st]
    buf = buf[:-1].view(E, rows, d)
    out = _expert_ffn(p, buf, cfg, proj, down).reshape(E * rows, d)
    y = _combine(out[at], sw * kept.to(sw.dtype), st, B * S, e.top_k)
    return y.reshape(B, S, d), counts


def _moe_capacity(p, x, cfg, top_i, top_p, n_local=None):
    """The capacity semantics off the programs (see :func:`apply_moe`):
    the capacity einsum at decode, the grouped products at prefill."""
    if x.shape[1] == 1:
        return _moe_capacity_buffers(p, x, cfg, top_i, top_p, torch.matmul,
                                     n_local)
    return _moe_prefill(p, x, cfg, top_i, top_p, n_local)


def expert_products(t: torch.Tensor, ends: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Expert-sorted rows ``t [T, K]`` times their experts' matrices ``w
    [E, K, M]`` -> ``[T, M]``, expert ``e``'s rows ending at ``ends[e]``
    (int32 ``[E]`` on ``t``'s device, ``ends[E - 1] == T``).  The offsets
    are never read on the host.  On the card a bf16 stack is one
    ``torch._grouped_mm`` (CUTLASS's grouped GEMM on Hopper); any other
    dtype there is :func:`ragged_products`, since ``torch._grouped_mm``
    takes no f32 under capture; on the CPU it is ``torch._grouped_mm``.
    Each product accumulates in f32 and rounds once to ``t.dtype``."""
    if t.device.type == "cuda" and t.dtype != torch.bfloat16:
        return ragged_products(t, ends, w)
    return torch._grouped_mm(t.contiguous(), w, offs=ends)


def ragged_products(t: torch.Tensor, ends: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """:func:`expert_products` through the port's ``ragged_gemv`` kernel
    (one launch, the offsets ``[0, *ends]`` read on the device) at its
    streaming plan for ``t``'s rows; on a CPU tensor, the kernel's plain
    version."""
    from repro_torch.kernels.gemv_plan import plan_ragged_stream
    from repro_torch.kernels.grouped_gemv import ragged_gemv

    E, K, M = w.shape
    plan = plan_ragged_stream(M, K, t.shape[0], E=E,
                              elem_bytes=t.element_size())
    return ragged_gemv(t.contiguous(), F.pad(ends, (1, 0)), w, plan=plan)


def _moe_prefill(p, x, cfg, top_i, top_p, n_local=None):
    """Prefill's capacity semantics as grouped products over the
    expert-sorted pairs (see :func:`apply_moe`): device data from end to
    end, no host sync and no ``[E, C, d]`` buffer.  With ``n_local`` the
    products cover the first ``n_local`` experts' rows (a rank's); the
    rows past them are zeroed (a grouped product leaves them undefined)
    and weigh zero."""
    e = cfg.moe
    B, S, d = x.shape
    st, se, _, sw, _, keep, counts = _capacity_plan(
        top_i, top_p, _capacity(S, cfg), e.n_experts)
    xr = x.reshape(B * S, d)[st]
    own = counts if n_local is None else counts[:n_local]
    ends = torch.cumsum(own, 0, dtype=torch.int32)
    out = _expert_ffn(p, xr, cfg,
                      lambda t, w: expert_products(t, ends, w))
    if n_local is not None:
        live = torch.arange(out.shape[0], device=out.device) < ends[-1]
        out = torch.where(live[:, None], out, out.new_zeros(()))
        keep = keep & (se < n_local)
    y = _combine(out, sw * keep.to(sw.dtype), st, B * S, e.top_k)
    return y.reshape(B, S, d), counts


def _moe_prefill_loop(p, x, cfg, top_i, top_p):
    """The plain version of :func:`_moe_prefill`: the per-expert offsets
    read on the host, one product per expert that has rows."""
    e = cfg.moe
    B, S, d = x.shape
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
