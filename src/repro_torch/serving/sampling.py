"""Token sampling for the serving engine (a copy of the JAX package's
``serving/sampling.py``, which is numpy only).

Greedy-compatible by construction: ``temperature <= 0`` (the default) is
EXACT argmax.  Temperature scaling, top-k, and top-p (nucleus) filters
compose in the standard order (scale -> top-k -> top-p -> sample).  Each
request draws from its own numpy Generator seeded with ``(params.seed,
rid)``, so its token stream does not depend on batch composition,
admission order, or slot placement.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0   # <= 0: greedy (exact argmax)
    top_k: int = 0             # 0: no top-k filter
    top_p: float = 1.0         # 1.0: no nucleus filter
    seed: int = 0


def request_rng(params: SamplingParams, rid: int) -> np.random.Generator:
    """Per-request generator: token streams are reproducible independent of
    batch composition or slot placement."""
    return np.random.default_rng([params.seed, rid])


def sample_token(logits, params: SamplingParams | None = None,
                 rng: np.random.Generator | None = None) -> int:
    """Draw one token id from 1-D ``logits``; greedy when no temperature."""
    z = np.asarray(logits, np.float32).reshape(-1)
    if params is None or params.temperature <= 0:
        return int(z.argmax())
    z = z / max(params.temperature, 1e-6)
    if params.top_k and params.top_k < z.size:
        kth = np.partition(z, -params.top_k)[-params.top_k]
        z = np.where(z < kth, -np.inf, z)
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    if params.top_p < 1.0:
        order = np.argsort(-p)
        csum = np.cumsum(p[order])
        # smallest prefix whose mass reaches top_p (always >= 1 token)
        cut = int(np.searchsorted(csum, params.top_p) + 1)
        keep = np.zeros_like(p, bool)
        keep[order[:cut]] = True
        p = np.where(keep, p, 0.0)
        p /= p.sum()
    if rng is None:
        rng = request_rng(params, 0)
    return int(rng.choice(p.size, p=p))
