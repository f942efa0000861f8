"""The dry run's input shapes, and their stand-ins as meta-device tensors
(counterpart of ``repro/launch/shapes.py``).

Shapes (the reference's four cases):
  train_4k     seq 4096   global_batch 256   -> train step
  prefill_32k  seq 32768  global_batch 32    -> prefill (a cache of 32k)
  decode_32k   seq 32768  global_batch 128   -> decode (1 token, a cache
                                                of 32k)
  long_500k    seq 524288 global_batch 1     -> decode; sub-quadratic
                                                archs only

Where the reference builds ``jax.ShapeDtypeStruct`` stand-ins, the port
builds tensors on the ``"meta"`` device: the same shapes and dtypes, no
storage, and every operation on them yields its result's shape and dtype
without computing a value (``launch.dryrun`` runs its steps on them).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


@dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeCase) -> tuple[bool, str]:
    """``(ok, reason)``: long_500k needs sub-quadratic attention; the
    reference's reason, word for word, where it is skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            f"{cfg.name} is pure full-attention; long_500k skipped "
            "(DESIGN.md §5)"
        )
    return True, ""


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def modality_specs(cfg: ModelConfig, batch: int) -> dict:
    """The stub frontend embeddings: whisper's ``frames [batch, n_frames,
    enc_d]``, llama-vision's ``vision [batch, vision_tokens, d]``, in the
    compute dtype."""
    dtype = lm.torch_dtype(cfg.compute_dtype)
    extra = {}
    if cfg.encoder is not None:
        enc = cfg.encoder
        extra["frames"] = _meta((batch, enc.n_frames, enc.d_model), dtype)
    if cfg.cross_attn_every > 0:
        extra["vision"] = _meta((batch, cfg.vision_tokens, cfg.d_model),
                                dtype)
    return extra


def input_specs(cfg: ModelConfig, shape: ShapeCase) -> dict:
    """Meta stand-ins for every model input of this cell: the int32
    ``tokens`` (``[B, S]``, or ``[B, 1]`` for decode), the ``cache`` of
    ``S`` positions for prefill and decode, and the modality stubs."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((B, 1 if shape.kind == "decode" else S),
                             torch.int32)}
    if shape.kind != "train":
        specs["cache"] = cache_specs(cfg, B, S)
    specs.update(modality_specs(cfg, B))
    return specs


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """``lm.init_cache`` on the meta device: every leaf's shape and dtype,
    no storage."""
    return lm.init_cache(cfg, batch, max_len, device="meta")
