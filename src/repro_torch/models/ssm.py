"""Recurrent sequence mixing: RWKV6 (Finch) time-mix and channel-mix, and
the Mamba-style selective SSM heads that hymba runs beside attention
(counterpart of ``repro/models/ssm.py``).

Each recurrence runs in f32 in the JAX package's order (its
``jax.lax.scan`` becomes a Python loop over positions; on the meta
device, where the dry run computes shapes and no values, each op of the
loop runs once over every position).  RWKV6, per head:

    y_t = r_t · (s + u ⊙ k_tᵀ v_t),    then    s ← w_t ⊙ s + k_tᵀ v_t,

with the data-dependent decay ``w = exp(-exp(w0 + tanh(x·w_a)·w_b))``
computed in f32.  Mamba, per channel of the inner width and state row:

    h_t = h_{t-1} · exp(dt_t · A) + dt_t · B_t · x_t,    y_t = h_t · C_t,

after a depthwise causal conv over the window ``[conv_state, x]``.  The
projections are plain matmuls, outside the GEMV dispatcher, as in the JAX
package.

State is written IN PLACE into the tensors it is given, as the K/V writes
of the attention families are: the wkv state ``s`` and the Mamba state
``h`` are advanced with ``mul_`` / ``add_`` on the caller's tensors, and
the token-shift carries and the conv window are ``copy_``'d into the
caller's tensors.  A decode step over the serving cache's views therefore
leaves nothing to copy back, and a captured decode graph keeps reading the
same leaves.  Without a state (a forward with no cache) the recurrence
starts from zeros and the final state is returned as new tensors.

Under a mesh a mixer's leaves are a rank's blocks
(``distributed.sharding.STATE_LEAVES``) and it runs the rank's share: a
time-mix the rank's rwkv heads (their recurrence, group norm and gate;
its state ``[B, H / n, hd, hd]``), a channel-mix the rank's ``d_ff``
columns, a Mamba mixer the rank's ``di`` channels (its state ``[B, di /
n, n_state]`` and window ``[B, cw - 1, di / n]``).  Each product over
the cut dim is a partial sum, all-reduced in f32 and cast once: ``y_r @
wo_r`` of the time-mix, ``k_r @ wv_r`` of the channel-mix (before the
gate ``sigmoid(xr @ wr)``, whose ``wr`` is whole), and Mamba's ``x1_r @
dt_lo_r``, ``x1_r @ w_B_r``, ``x1_r @ w_C_r`` and ``y_r @ w_out_r``.
The token-shift carries are the layer's whole input, the same on every
rank.  Under autograd each replicated tensor that goes into a rank's
block passes ``collectives.enter`` (its gradient summed over the
ranks): the mixes into ``wr`` / ``wk`` / ``wv`` / ``wg``, the decay
LoRA's ``tanh`` output into ``w_b``, the channel-mix's ``xk``, Mamba's
input into ``w_in`` and the reduced ``dt_lo`` / ``B`` / ``C`` products
into the rank's channels (one all-reduce for the three); the whole
leaves (``mu``, ``w_a``, the channel-mix's ``wr``) then get the whole
gradient on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import all_reduce_sum, enter
from repro_torch.models.layers import dense_init, model_group

LORA = 32   # rank of the decay's low-rank projection


def rwkv_heads(cfg: ModelConfig) -> tuple[int, int]:
    hd = cfg.ssm.head_dim
    if cfg.d_model % hd:
        raise ValueError(f"d_model {cfg.d_model} is no whole number of "
                         f"heads of {hd}")
    return cfg.d_model // hd, hd


def init_rwkv_time_mix(g: torch.Generator, cfg: ModelConfig, dtype,
                       device) -> dict:
    """The JAX package's init: token-shift mixes of 0.5 (rows r, k, v, g,
    w), a decay bias of -0.5, an f32 decay LoRA, five ``[d, d]``
    projections, a per-head bonus ``u`` of zeros and a group-norm scale
    of ones."""
    d = cfg.d_model
    H, hd = rwkv_heads(cfg)
    f32 = torch.float32
    return {
        "mu": torch.full((5, d), 0.5, dtype=dtype, device=device),
        "w0": torch.full((d,), -0.5, dtype=f32, device=device),
        "w_a": dense_init(g, d, (d, LORA), f32, device),
        "w_b": dense_init(g, LORA, (LORA, d), f32, device),
        **{name: dense_init(g, d, (d, d), dtype, device)
           for name in ("wr", "wk", "wv", "wg", "wo")},
        "u": torch.zeros((H, hd), dtype=f32, device=device),
        "ln_scale": torch.ones(d, dtype=dtype, device=device),
    }


def init_rwkv_channel_mix(g: torch.Generator, cfg: ModelConfig, dtype,
                          device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"mu": torch.full((2, d), 0.5, dtype=dtype, device=device),
            "wk": dense_init(g, d, (d, f), dtype, device),
            "wv": dense_init(g, f, (f, d), dtype, device),
            "wr": dense_init(g, d, (d, d), dtype, device)}


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """``xx[t] = x[t-1]``; position 0 takes ``prev`` (the carry) or zero."""
    first = (prev[:, None, :].to(x.dtype) if prev is not None
             else torch.zeros_like(x[:, :1]))
    if x.shape[1] == 1:
        return first
    return torch.cat([first, x[:, :-1]], dim=1)


def _carry(new: torch.Tensor, into: torch.Tensor | None) -> torch.Tensor:
    """``new`` written into ``into`` in place (returned), or ``new``."""
    if into is None:
        return new
    into.copy_(new)
    return into


def apply_rwkv_time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                        state: tuple[torch.Tensor, torch.Tensor] | None
                        = None) -> tuple[torch.Tensor,
                                         tuple[torch.Tensor, torch.Tensor]]:
    """``x [B, S, d]`` -> ``(y, (s [B, H, hd, hd] f32, x_last [B, d]))``.

    With ``state = (s, x_prev)`` the recurrence continues from them and
    both are advanced in place (the returned tensors are ``state``'s)."""
    B, S, d = x.shape
    _, hd = rwkv_heads(cfg)
    d_l = p["wr"].shape[1]              # a rank's heads' width under a mesh
    H = d_l // hd
    sharded = d_l != d
    xx = _token_shift(x, state[1] if state is not None else None)

    def mix(i):
        return x + (xx - x) * p["mu"][i].to(x.dtype)

    def block_in(t):    # under autograd, the input of the rank's heads
        return enter(t, model_group()) if sharded else t

    r = (block_in(mix(0)) @ p["wr"]).reshape(B, S, H, hd)
    k = (block_in(mix(1)) @ p["wk"]).reshape(B, S, H, hd)
    v = (block_in(mix(2)) @ p["wv"]).reshape(B, S, H, hd)
    g = block_in(mix(3)) @ p["wg"]
    # the data-dependent decay, in f32
    wx = block_in(torch.tanh(mix(4).float() @ p["w_a"])) @ p["w_b"]
    w = torch.exp(-torch.exp(p["w0"] + wx)).reshape(B, S, H, hd)

    rf, kf, vf = r.float(), k.float(), v.float()
    u = p["u"][None, :, :, None]
    s = (state[0] if state is not None
         else torch.zeros((B, H, hd, hd), dtype=torch.float32,
                          device=x.device))
    # k_tᵀ v_t and u ⊙ k_tᵀ v_t of every position at once; the loop keeps
    # the reference's per-step order: y_t from the old s, then s in place
    kv = kf[..., :, None] * vf[..., None, :]           # [B, S, H, hd, hd]
    ukv = u[:, None] * kv
    if x.device.type == "meta":     # the dry run: shapes, no values
        y = _scan_shapes_rwkv(rf, s, kv, ukv, w)
    else:
        ys = []
        for t in range(S):
            ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t],
                                   s + ukv[:, t]))
            s.mul_(w[:, t, :, :, None]).add_(kv[:, t])
        y = torch.stack(ys, dim=1)                     # [B, S, H, hd]

    # per-head group norm
    var = y.square().mean(dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-6)).reshape(B, S, d_l)
    y = y * p["ln_scale"].float()
    y = y.to(x.dtype) * F.silu(g)
    x_last = _carry(x[:, -1], state[1] if state is not None else None)
    out = y @ p["wo"]
    # wo holds the rank's heads' rows: its product is a partial sum
    return (all_reduce_sum(out, model_group()) if sharded else out,
            (s, x_last))


def _scan_shapes_rwkv(rf, s, kv, ukv, w) -> torch.Tensor:
    """The wkv loop on the meta device (``launch.dryrun``), where no value
    is computed: each of its ops over all S positions at once, the state
    before each step standing in as ``s + kv ⊙ w``, so that the output
    and ``s`` (advanced in place) have the loop's shapes, its products'
    operations (one ``[hd] x [hd, hd]`` product a head and position) and
    its elementwise traffic over ``[B, S, H, hd, hd]``, in one dispatch
    an op instead of S; and under autograd every input gets a
    gradient."""
    sp = s[:, None] + kv * w[..., None]
    y = torch.einsum("bshi,bshij->bshj", rf, sp + ukv)
    s.copy_(sp[:, -1])
    return y


def apply_rwkv_channel_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                           prev_x: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, d]`` -> ``(y, x_last [B, d])``; with ``prev_x`` the
    token shift continues from it and it is advanced in place."""
    xx = _token_shift(x, prev_x)
    xk = x + (xx - x) * p["mu"][0].to(x.dtype)
    xr = x + (xx - x) * p["mu"][1].to(x.dtype)
    sharded = p["wk"].shape[1] != cfg.d_ff     # a rank's d_ff columns
    if sharded:     # under autograd, the input of the rank's columns
        xk = enter(xk, model_group())
    k = torch.square(torch.relu(xk @ p["wk"]))
    kv = k @ p["wv"]
    if sharded:     # wv holds the rank's rows: a partial sum
        kv = all_reduce_sum(kv, model_group())
    out = torch.sigmoid(xr @ p["wr"]) * kv
    return out, _carry(x[:, -1], prev_x)


# --------------------------------------------------------------------------
# Mamba-style selective SSM heads (hymba's parallel heads)
# --------------------------------------------------------------------------


def mamba_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(inner width, state rows, conv width) of a Mamba mixer."""
    return cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim, cfg.ssm.conv_dim


def init_mamba(g: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """The JAX package's init: the input projection ``w_in [d, 2 di]`` (x
    and the gate z), a depthwise conv ``conv_w [cw, di]``, the low-rank dt
    projection ``dt_lo [di, r]`` / ``dt_hi [r, di]`` (r = max(8, d / 16))
    with an f32 ``dt_bias`` of zeros, ``w_B`` / ``w_C [di, n]``, an f32
    ``A_log [di, n]`` of ``log(1 .. n)`` in every row, an f32 skip ``D`` of
    ones and the output projection ``w_out [di, d]``."""
    d = cfg.d_model
    di, n, cw = mamba_dims(cfg)
    r = max(8, d // 16)
    f32 = torch.float32
    return {
        "w_in": dense_init(g, d, (d, 2 * di), dtype, device),
        "conv_w": dense_init(g, cw, (cw, di), dtype, device),
        "dt_lo": dense_init(g, di, (di, r), dtype, device),
        "dt_hi": dense_init(g, r, (r, di), dtype, device),
        "dt_bias": torch.zeros(di, dtype=f32, device=device),
        "w_B": dense_init(g, di, (di, n), dtype, device),
        "w_C": dense_init(g, di, (di, n), dtype, device),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=f32, device=device)
                           ).expand(di, n).contiguous(),
        "D": torch.ones(di, dtype=f32, device=device),
        "w_out": dense_init(g, di, (di, d), dtype, device),
    }


def _causal_dw_conv(x: torch.Tensor, w: torch.Tensor,
                    conv_state: torch.Tensor | None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time, ``x [B, S, di]``, ``w [cw, di]``:
    ``out[t] = sum_i w[i] · xp[t + i]`` over the window ``xp = [conv_state
    (or zeros), x]``, summed in the JAX package's order; returns ``(out,
    window)`` with ``window`` the last ``cw - 1`` rows of ``xp``, a fresh
    tensor (never a view of ``conv_state``)."""
    cw, S = w.shape[0], x.shape[1]
    pad = (conv_state.to(x.dtype) if conv_state is not None
           else x.new_zeros((x.shape[0], cw - 1, x.shape[2])))
    xp = torch.cat([pad, x], dim=1)                    # [B, S + cw - 1, di]
    out = xp[:, :S] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * w[i]
    return out, xp[:, S:]


def apply_mamba(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """``x [B, S, d]`` -> ``(y [B, S, d], (conv [B, cw - 1, di], h [B, di,
    n] f32))``.

    With ``state = (conv, h)`` the conv continues from the window ``conv``
    and the recurrence from ``h``; both are advanced in place (the
    returned tensors are ``state``'s).  The new window is built as a fresh
    tensor and then copied into ``conv``: shifting it in place would be a
    copy between overlapping memory."""
    B, S, _ = x.shape
    _, n, _ = mamba_dims(cfg)
    di = p["w_in"].shape[1] // 2        # a rank's channels under a mesh
    sharded = di != mamba_dims(cfg)[0]

    if sharded:     # under autograd, the input of the rank's channels
        x = enter(x, model_group())
    x1, z = (x @ p["w_in"]).chunk(2, dim=-1)      # [x1_r | z_r] on a rank
    x1, window = _causal_dw_conv(x1, p["conv_w"],
                                 state[0] if state is not None else None)
    x1 = F.silu(x1)
    lo, Bm, Cm = x1 @ p["dt_lo"], x1 @ p["w_B"], x1 @ p["w_C"]
    if sharded:     # three sums over the channels in one all-reduce, each
        # then the input of the rank's channels again
        parts = enter(all_reduce_sum(torch.cat([lo, Bm, Cm], dim=-1),
                                     model_group()), model_group())
        lo, Bm, Cm = parts.split([lo.shape[-1], n, n], dim=-1)
    dt = F.softplus((lo @ p["dt_hi"]).float() + p["dt_bias"])  # [B, S, di]
    Bm, Cm = Bm.float(), Cm.float()                    # [B, S, n]
    A = -torch.exp(p["A_log"])                         # [di, n]
    xf = x1.float()
    h = (state[1] if state is not None
         else torch.zeros((B, di, n), dtype=torch.float32, device=x.device))
    # exp(dt·A) and dt·B·x of every position at once; the loop keeps the
    # reference's per-step order, h·exp(dt·A) then + dt·B·x, and keeps
    # each step's h, so that y = h·C is one product over every position
    da = torch.exp(dt[..., None] * A)                  # [B, S, di, n]
    dbx = dt[..., None] * Bm[:, :, None, :] * xf[..., None]
    if x.device.type == "meta":     # the dry run: shapes, no values
        # each op of the loop over all S positions at once (its shapes
        # and elementwise traffic, one dispatch an op instead of S)
        hs = h[:, None] * da + dbx
        h.copy_(hs[:, -1])
    else:
        hs = torch.empty_like(da)
        for t in range(S):
            h.mul_(da[:, t]).add_(dbx[:, t])
            hs[:, t].copy_(h)
    y = torch.matmul(hs, Cm[..., None])[..., 0] + p["D"] * xf
    y = y.to(x.dtype) * F.silu(z)
    conv = _carry(window, state[0] if state is not None else None)
    out = y @ p["w_out"]
    # w_out holds the rank's channels' rows: its product is a partial sum
    return (all_reduce_sum(out, model_group()) if sharded else out,
            (conv, h))
