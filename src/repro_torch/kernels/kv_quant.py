"""Quantized KV-cache pages: int8 / packed-int4 storage with per-page scales.

Counterpart of ``repro/kernels/kv_quant.py`` (plain tensor code there as
here: the codec has no kernel).  A page is one head's ``hd`` lane vector at
one position; it is stored as int8 codes (int4: two lanes per byte along
``hd``, the even lane in the low nibble -- the ``quant4_gemv`` packing)
with one f32 absmax scale.

Layout (one attention layer, slot-managed serving cache):

  k / v:              [B, S, Hkv, hd]   int8   (int4: [B, S, Hkv, hd // 2])
  k_scale / v_scale:  [B, S, Hkv]       float32 amax / qmax per page

Writes quantize the fresh rope'd K/V page and store its scale alongside;
the attention read path dequantizes the cache to the compute dtype.  The
codec is deterministic and byte-equal to the JAX one.
"""

from __future__ import annotations

import torch

# Storage modes for the serving KV cache.
KV_STORES = ("fp", "int8", "int4")


def validate_kv_store(store: str) -> str:
    if store not in KV_STORES:
        raise ValueError(
            f"unknown kv_store {store!r}; expected one of {KV_STORES}")
    return store


def kv_store_bits(store: str) -> int | None:
    """Bits per stored KV element (None for the fp store)."""
    validate_kv_store(store)
    return {"fp": None, "int8": 8, "int4": 4}[store]


def stored_head_dim(store: str, hd: int) -> int:
    """Last-dim width of a stored K/V leaf (int4 packs two per byte)."""
    if store == "int4":
        if hd % 2:
            raise ValueError(f"int4 KV store needs an even head_dim, got {hd}")
        return hd // 2
    return hd


def quantize_page(x: torch.Tensor, bits: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """KV pages ``x [..., hd]`` -> (int8 codes, f32 scales ``[...]``).

    Symmetric absmax per page: ``scale = amax / qmax`` (1.0 for an all-zero
    page, so dequant stays exact there), codes rounded half-to-even and
    clipped to ``[-qmax, qmax]``.  ``bits == 4`` packs adjacent lanes (even
    lane in the low nibble) into one int8 along the last dim.
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    qmax = 127.0 if bits == 8 else 7.0
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its rounded reciprocal, which is not the correctly rounded quotient
    scale = torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -qmax, qmax).to(
        torch.int8)
    if bits == 4:
        lo = q[..., 0::2].to(torch.int16) & 0xF
        hi = (q[..., 1::2].to(torch.int16) & 0xF) << 4
        q = (hi | lo).to(torch.uint8).view(torch.int8)
    return q, scale


def dequantize_page(q: torch.Tensor, scale: torch.Tensor, *, hd: int,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_page`: codes + scales -> ``[..., hd]``.

    Packed int4 is detected from the last dim (``hd // 2``); arithmetic
    shifts recover the signed nibbles, even lanes from the low nibble.
    """
    if q.shape[-1] != hd:
        if q.shape[-1] * 2 != hd:
            raise ValueError(f"codes {tuple(q.shape)} do not hold head_dim "
                             f"{hd}")
        lo = (q << 4) >> 4          # int8 shifts: sign-extends the low one
        hi = q >> 4
        q = torch.stack([lo, hi], dim=-1).reshape(*q.shape[:-1], hd)
    return (q.float() * scale[..., None]).to(out_dtype)


def tree_bytes(tree) -> int:
    """Total bytes of a (nested dict / list of) tensors: capacity
    accounting, as the JAX package's ``tree_bytes`` over a pytree."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0
