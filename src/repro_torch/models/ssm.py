"""Attention-free sequence mixing: RWKV6 (Finch) time-mix and channel-mix
(counterpart of the RWKV6 half of ``repro/models/ssm.py``).

The recurrence runs in f32 in the JAX package's order (its
``jax.lax.scan`` becomes a Python loop over positions): per head,

    y_t = r_t · (s + u ⊙ k_tᵀ v_t),    then    s ← w_t ⊙ s + k_tᵀ v_t,

with the data-dependent decay ``w = exp(-exp(w0 + tanh(x·w_a)·w_b))``
computed in f32.  The projections are plain matmuls, outside the GEMV
dispatcher, as in the JAX package.

State is written IN PLACE into the tensors it is given, as the K/V writes
of the attention families are: the wkv state ``s`` is advanced with
``mul_`` / ``add_`` on the caller's ``[B, H, hd, hd]`` tensor and the
token-shift carries are ``copy_``'d into the caller's ``[B, d]`` tensors.
A decode step over the serving cache's views therefore leaves nothing to
copy back, and a captured decode graph keeps reading the same leaves.
Without a state (a forward with no cache) the recurrence starts from
zeros and the final state is returned as new tensors.

Mamba (the hybrid family's parallel heads) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

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
    H, hd = rwkv_heads(cfg)
    xx = _token_shift(x, state[1] if state is not None else None)

    def mix(i):
        return x + (xx - x) * p["mu"][i].to(x.dtype)

    r = (mix(0) @ p["wr"]).reshape(B, S, H, hd)
    k = (mix(1) @ p["wk"]).reshape(B, S, H, hd)
    v = (mix(2) @ p["wv"]).reshape(B, S, H, hd)
    g = mix(3) @ p["wg"]
    # the data-dependent decay, in f32
    wx = torch.tanh(mix(4).float() @ p["w_a"]) @ p["w_b"]
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
    ys = []
    for t in range(S):
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], s + ukv[:, t]))
        s.mul_(w[:, t, :, :, None]).add_(kv[:, t])
    y = torch.stack(ys, dim=1)                         # [B, S, H, hd]

    # per-head group norm
    var = y.square().mean(dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-6)).reshape(B, S, d)
    y = y * p["ln_scale"].float()
    y = y.to(x.dtype) * F.silu(g)
    x_last = _carry(x[:, -1], state[1] if state is not None else None)
    return y @ p["wo"], (s, x_last)


def apply_rwkv_channel_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                           prev_x: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, d]`` -> ``(y, x_last [B, d])``; with ``prev_x`` the
    token shift continues from it and it is advanced in place."""
    xx = _token_shift(x, prev_x)
    xk = x + (xx - x) * p["mu"][0].to(x.dtype)
    xr = x + (xx - x) * p["mu"][1].to(x.dtype)
    k = torch.square(torch.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    return out, _carry(x[:, -1], prev_x)
