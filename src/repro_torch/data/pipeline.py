"""Deterministic, shard-aware, resumable synthetic LM data (counterpart of
``repro/data/pipeline.py``, batch for batch).

An order-1 Markov token stream seeded per ``(seed, shard, step)``, so
every data-parallel shard sees its own deterministic data, resuming from
step N reproduces the exact stream, and the stream has structure enough
for the training loss to fall.  The stub modality inputs (whisper's frame
embeddings, llama-vision's patch embeddings) are drawn here too.  Batches
are numpy arrays, bit-equal to the reference's for every ``(seed,
shard_id, step)``; the train step moves them to its device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    n_shards: int = 1
    shard_id: int = 0


class SyntheticLM:
    """Iterator of batches; its state is ``(config, step)``, so it resumes
    from a step alone."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig, step: int = 0):
        if dcfg.global_batch % dcfg.n_shards:
            raise ValueError(f"global batch {dcfg.global_batch} does not "
                             f"split into {dcfg.n_shards} shards")
        self.cfg = cfg
        self.dcfg = dcfg
        self.step = step
        # the transition structure, shared by every shard
        rng = np.random.default_rng(dcfg.seed)
        self._v = min(cfg.vocab, 4096)
        self._means = rng.normal(size=(64,)) * 2.0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        d = self.dcfg
        b_local = d.global_batch // d.n_shards
        rng = np.random.default_rng((d.seed, d.shard_id, step))
        # next token = (31 * token + noise) % v: learnable structure
        toks = np.empty((b_local, d.seq_len), np.int32)
        cur = rng.integers(0, self._v, size=(b_local,))
        for t in range(d.seq_len):
            toks[:, t] = cur
            noise = rng.integers(0, 7, size=(b_local,))
            cur = (31 * cur + noise) % self._v
        batch: dict[str, np.ndarray] = {"tokens": toks}
        if self.cfg.encoder is not None:
            enc = self.cfg.encoder
            batch["frames"] = rng.standard_normal(
                (b_local, enc.n_frames, enc.d_model), dtype=np.float32)
        if self.cfg.cross_attn_every > 0:
            batch["vision"] = rng.standard_normal(
                (b_local, self.cfg.vision_tokens, self.cfg.d_model),
                dtype=np.float32)
        return batch

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def state(self) -> dict[str, Any]:
        return {"step": self.step}

    def restore(self, state: dict[str, Any]) -> None:
        self.step = int(state["step"])
