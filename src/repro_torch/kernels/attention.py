"""Decode attention: ``csrc/decode_attention.cu`` and its plain twin.

Computes what the reference's ``repro/models/layers.py::attention_core``
computes (it has no Pallas kernel: XLA runs it as einsums): for q
``[B, Sq, H, D]`` and a GQA cache k / v ``[B, C, Hkv, D]``, scores are the
f32 sums of bf16 (or f32) products over ``sqrt(D)``; masked scores (past
``q_position``, or past ``kv_valid_len``) are ``BIG_NEG``; the softmax is
f32, its probabilities cast to ``v.dtype`` before the P.V product, which
sums in f32 and rounds once.

:func:`decode_attention_plain` is that arithmetic in plain PyTorch, for
any Sq (it is the model's prefill path too; on the card its scores are
one ``torch.bmm`` of the bf16 operands with an f32 result, as the
reference's ``preferred_element_type``, so the cache is not cast to f32).
:func:`decode_attention` is the kernel for one new token a slot (Sq = 1,
causal): one CTA cluster per (slot, kv head) reads the valid K and V
positions in place through their strides, so no f32 copy of the cache is
made; each CTA starts the copies of its V rows into shared memory at
entry, so they are in flight while it scores K.  On a quantized store (``kv_quant``: int8 or packed int4 codes with
one f32 scale a page) it reads the codes and scales in place and
dequantizes each element where it reads it, exactly as
``dequantize_page`` does: its output equals the kernel's on the
dequantized cache bit for bit.  What bounds it on an H100:
each K / V element feeds ``2 * G`` flops, so the floor is the valid K and
V bytes over HBM bandwidth (3.35 TB/s).  See the source for the design.

:func:`kernel_applies` is the model's routing rule, on shapes, strides and
the device alone: the kernel takes Sq = 1, causal attention on a CUDA
device, bf16 or f32 q / k / v of one type in the layout above (or int8
codes of D or D / 2 lanes with f32 scales ``[B, C, Hkv]``), G = H / Hkv in
{1, 2, 4, 8}, D a whole number of 16-byte vectors on at most 32 lanes,
aligned rows, and a cache whose scores fit shared memory.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``decode_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemv_plan import SMEM_PER_CTA, device_sms
from repro_torch.kernels.kv_quant import dequantize_page
from repro_torch.kernels.pim_gemv import DTYPES

BIG_NEG = -2.0e9             # the reference's masked score (not -inf)
GROUPS = (1, 2, 4, 8)        # query heads per kv head the kernel is built for
SPLITS = (1, 2, 4, 8)        # CTAs a (slot, kv head) splits over: a cluster
MAX_SPLITS = SPLITS[-1]      # csrc/decode_attention.cu kMaxSplits
MIN_SPLIT_POSITIONS = 64     # fewest positions worth a split of their own
CTAS_PER_SM = 4              # CTAs an SM should hold (plan_splits' target)
WARPS = 4                    # csrc/decode_attention.cu kWarps
UNROLL = 4                   # ... kUnroll: vectors in flight a thread
STAGE_BYTES = 24 * 1024      # ... kStageBytes: V rows staged at a time
INDEX_DTYPES = (torch.int32, torch.int64)

_SMS: dict[int, int] = {}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           q_positions: torch.Tensor | None,
                           kv_valid_len: torch.Tensor | None,
                           causal: bool = True) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, Hkv, D] -> [B, Sq, H, D] in plain PyTorch.

    Scores are the f32 product of the (bf16) operands over sqrt(D), as
    ``preferred_element_type=f32`` gives them: on the card one batched
    product of the bf16 operands with an f32 result (``aten::bmm.dtype``,
    which has no CPU kernel); elsewhere the operands are cast to f32,
    which makes the products exact.  Masked scores are ``BIG_NEG`` (not
    -inf); the probabilities are cast to ``v.dtype`` before the PV product.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    if q.is_cuda and q.dtype == k.dtype == torch.bfloat16:
        scores = torch.bmm(
            qg.permute(0, 2, 3, 1, 4).reshape(B * Hkv, G * Sq, D),
            k.permute(0, 2, 3, 1).reshape(B * Hkv, D, Sk),
            out_dtype=torch.float32).reshape(B, Hkv, G, Sq, Sk) / math.sqrt(D)
    else:
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


def _row_bytes(D: int, elem_bytes: int, bits: int) -> int:
    """Staged bytes of one position's V: D elements, or their int8 /
    packed int4 codes and one f32 scale."""
    return D * elem_bytes if bits == 16 else D * bits // 8 + 4


def stage_positions(D: int, C: int, splits: int, elem_bytes: int = 2,
                    bits: int = 16) -> int:
    """V rows a CTA stages at a time: its split's positions rounded up to
    whole steps of the P.V walk (``WARPS * 32 / lanes * UNROLL``
    positions, a lane reading 16 bytes of q's type), at most the whole
    steps whose rows fit ``STAGE_BYTES``, at least one step."""
    lanes = D // (16 // elem_bytes)
    step = WARPS * (32 // lanes if 1 <= lanes <= 32 else 1) * UNROLL
    cap = -(-C // splits)
    most = STAGE_BYTES // _row_bytes(D, elem_bytes, bits) // step * step
    return min(-(-cap // step) * step, max(most, step))


def smem_bytes(G: int, D: int, C: int, splits: int, *, elem_bytes: int = 2,
               bits: int = 16) -> int:
    """Dynamic shared memory of one launch (``decode_attention_smem_bytes``):
    the scores of one split's positions, the ranks' shares of the output,
    the warps' P.V partials, the reduce scratch and every rank's max and
    sum, in f32; then, 16-byte aligned, the staged V rows
    (:func:`stage_positions` of them: D elements of ``elem_bytes``, or
    their int8 / packed int4 codes and an f32 scale each)."""
    cap = -(-C // splits)
    floats = 4 * (G * cap + G * D + MAX_SPLITS + WARPS * G * D + WARPS * G
                  + 2 * MAX_SPLITS * G)
    return (-(-floats // 16) * 16
            + stage_positions(D, C, splits, elem_bytes, bits)
            * _row_bytes(D, elem_bytes, bits))


def plan_splits(B: int, Hkv: int, C: int, G: int, D: int,
                sms: int | None, *, elem_bytes: int = 2,
                bits: int = 16) -> int | None:
    """CTAs (a cluster) each (slot, kv head) splits its positions over: the
    fewest that put ``CTAS_PER_SM`` CTAs on every SM (each CTA's walk is a
    chain of dependent loads, so an SM needs several to keep HBM busy), no
    more than leave each split ``MIN_SPLIT_POSITIONS`` of the cache, and
    enough that one split's scores and staged V rows fit shared memory;
    None when no split count fits."""
    pairs = max(B * Hkv, 1)
    want = next((s for s in SPLITS if pairs * s >= CTAS_PER_SM * (sms or 1)),
                SPLITS[-1])
    want = min(want, max(1, C // MIN_SPLIT_POSITIONS))
    want = max(s for s in SPLITS if s <= want)
    return next((s for s in SPLITS if s >= want
                 and smem_bytes(G, D, C, s, elem_bytes=elem_bytes,
                                bits=bits) <= SMEM_PER_CTA), None)


def _sms(device: torch.device) -> int:
    """The device's SM count, read once per device (the rule runs every
    layer)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = device_sms() or 1
    return _SMS[idx]


def _rows_ok(t: torch.Tensor, align: int) -> bool:
    """Contiguous last dimension, start and strides aligned to ``align``
    bytes."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % align == 0
            and all(s * size % align == 0 for s in t.stride()[:-1]))


def _shape_rule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                k_scale: torch.Tensor | None = None,
                v_scale: torch.Tensor | None = None) -> str:
    """Why the kernel does not take these operands, or '' when it does.
    With scales, k / v are int8 codes of D lanes (int8) or D / 2 (packed
    int4) and the scales f32 ``[B, C, Hkv]``."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        return (f"expected q [B, 1, H, D] and k/v [B, C, Hkv, D], got "
                f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, C, Hkv, Dk = k.shape
    quant = k_scale is not None or v_scale is not None
    if Sq != 1 or Bk != B or Dk not in ((D, D // 2) if quant else (D,)) \
            or H % Hkv or C < 1:
        return (f"q {tuple(q.shape)} is not one token a slot over k/v "
                f"{tuple(k.shape)}")
    if q.dtype not in DTYPES:
        return f"q must be bf16 or f32, got {q.dtype}"
    if quant:
        if k_scale is None or v_scale is None or not (
                k.dtype == v.dtype == torch.int8
                and k_scale.dtype == v_scale.dtype == torch.float32
                and k_scale.shape == v_scale.shape == (B, C, Hkv)):
            return ("quantized pages must be int8 codes with f32 scales "
                    "[B, C, Hkv]")
        if D % 2:
            return f"head dim {D} is odd"
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        return (f"q, k and v must share bf16 or f32, got {q.dtype}, "
                f"{k.dtype}, {v.dtype}")
    scales = (k_scale, v_scale) if quant else ()
    if not all(t.device == q.device for t in (k, v, *scales)):
        return f"q on {q.device}, k on {k.device}, v on {v.device}"
    if H // Hkv not in GROUPS:
        return f"{H // Hkv} query heads a kv head is not one of {GROUPS}"
    vec = 16 // q.element_size()
    lanes = D // vec
    if D % vec or lanes > 32 or lanes & (lanes - 1):
        return f"head dim {D} is not a power-of-two count of 16-byte vectors"
    # a lane reads its `vec` elements: 16 bytes, or their codes; V rows
    # are staged in copies of that many bytes, at least 4
    lane = max(4, vec * k.element_size() * Dk // D)
    if Dk * k.element_size() % lane:
        return f"a page row of {Dk} codes is not whole {lane}-byte copies"
    if not (_rows_ok(q, 16) and _rows_ok(k, lane) and _rows_ok(v, lane)
            and q.stride(2) == D):
        return "q, k and v rows must be contiguous and aligned"
    return ""


def kernel_applies(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, k_scale: torch.Tensor | None = None,
                   v_scale: torch.Tensor | None = None) -> bool:
    """The model's routing rule: whether :func:`decode_attention` launches
    the kernel for these operands (shapes, strides, types and the device;
    never the data); scales mark a quantized store."""
    if (not causal or q.device.type != "cuda"
            or _shape_rule(q, k, v, k_scale, v_scale)):
        return False
    B, _, H, D = q.shape
    Hkv = k.shape[2]
    return plan_splits(B, Hkv, k.shape[1], H // Hkv, D, _sms(q.device),
                       elem_bytes=q.element_size(),
                       bits=_bits(k, D, k_scale)) is not None


def _bits(k: torch.Tensor, D: int, k_scale: torch.Tensor | None) -> int:
    """16 for fp pages, else 8 (int8 codes of D lanes) or 4 (packed)."""
    return 16 if k_scale is None else (8 if k.shape[-1] == D else 4)


def _index(t: torch.Tensor, B: int, name: str) -> tuple[int, int]:
    """(stride, element size) of a per-slot int32/int64 vector of B."""
    if t.dtype not in INDEX_DTYPES or t.shape != (B,):
        raise ValueError(f"{name} must be int32 or int64 [{B}], got "
                         f"{t.dtype} {tuple(t.shape)}")
    return (t.stride(0) if B > 1 else 1), t.element_size()


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_positions: torch.Tensor,
                     kv_valid_len: torch.Tensor | None,
                     splits: int | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, 1, H, D], k/v [B, C, Hkv, D] -> [B, 1, H, D], causal, one
    launch.  ``q_positions`` is [B, 1] (or [B]) and ``kv_valid_len`` [B]
    or None, int32 or int64 on q's device (read on the device, never on
    the host).  ``splits`` overrides :func:`plan_splits`.  With
    ``k_scale`` / ``v_scale`` ([B, C, Hkv] f32) k / v are a quantized
    store's int8 codes (``[B, C, Hkv, D]``) or packed int4 codes
    (``[B, C, Hkv, D // 2]``); the plain version dequantizes them with
    ``dequantize_page`` first."""
    why = _shape_rule(q, k, v, k_scale, v_scale)
    if why:
        raise ValueError(f"decode_attention: {why}")
    B, _, H, D = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    bits = _bits(k, D, k_scale)
    qpos = q_positions.reshape(B, -1)[:, -1] if q_positions.ndim == 2 \
        else q_positions
    if q.device.type == "cpu":
        if bits < 16:
            k = dequantize_page(k, k_scale, hd=D, out_dtype=q.dtype)
            v = dequantize_page(v, v_scale, hd=D, out_dtype=q.dtype)
        return decode_attention_plain(q, k, v, q_positions=qpos[:, None],
                                      kv_valid_len=kv_valid_len, causal=True)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    fit = dict(elem_bytes=q.element_size(), bits=bits)
    if splits is None:
        splits = plan_splits(B, Hkv, C, G, D, _sms(q.device), **fit)
    if splits not in SPLITS or smem_bytes(G, D, C, splits,
                                          **fit) > SMEM_PER_CTA:
        raise ValueError(f"decode_attention: {splits} splits of C={C} do "
                         f"not fit the kernel")
    qs, qb = _index(qpos, B, "q_positions")
    if kv_valid_len is None:
        vlen, vs, vb = qpos, 0, 0
    else:
        vlen = kv_valid_len
        vs, vb = _index(vlen, B, "kv_valid_len")
    if qpos.device != q.device or vlen.device != q.device:
        raise ValueError("q_positions and kv_valid_len must be on q's "
                         "device")
    lib = _build.load("decode_attention")
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    tail = (qpos.data_ptr(), qs, qb, vlen.data_ptr(), vs, vb, B, C, Hkv, G,
            D, q.stride(0), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2))
    if bits == 16:
        fn = getattr(lib, f"decode_attention_{DTYPES[q.dtype]}")
        rc = fn(*head, out.data_ptr(), *tail, splits, math.sqrt(D), stream)
    else:
        fn = getattr(lib, f"decode_attention_quant_{DTYPES[q.dtype]}")
        rc = fn(*head, k_scale.data_ptr(), v_scale.data_ptr(),
                out.data_ptr(), *tail, *k_scale.stride(), *v_scale.stride(),
                bits, splits, math.sqrt(D), stream)
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
