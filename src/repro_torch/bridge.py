"""Weight transfer from the JAX package's parameter tree, through numpy.

The JAX package's ``init_lm`` returns a pytree whose per-layer leaves are
stacked ``[L, ...]``.  :func:`params_from_numpy` takes that tree with every
leaf converted to a numpy array (``jax.tree.map(np.asarray, params)``) and
returns the port's parameter dict (one dict per layer), so a test can feed
both packages exactly the same weights.  :func:`packed_from_numpy` does the
same for one of the JAX package's ``PackedWeights`` (quantized ones
included).  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import PackedWeights


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy -> torch, bf16 included (numpy's ``bfloat16`` extension type
    has no torch counterpart in ``from_numpy``: go through its bits)."""
    a = np.array(a)  # a writable copy: torch shares the buffer
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The JAX package's dense or MoE ``init_lm`` tree (numpy leaves) ->
    the port's params on ``device``.  Every leaf keeps its layout: an MoE
    layer's f32 ``router [d, E]``, its expert stacks ``w_gate``/``w_up
    [E, d, f]`` and ``w_down [E, f, d]``, and its ``shared`` MLP."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"family {cfg.family!r} is not ported yet")

    def conv(node, i=None):
        if isinstance(node, dict):
            return {k: conv(v, i) for k, v in node.items()}
        return tensor_from_numpy(node if i is None else node[i], device)

    params = {"embed": conv(tree["embed"]), "ln_f": conv(tree["ln_f"]),
              "layers": [conv(tree["layers"], i)
                         for i in range(cfg.n_layers)]}
    if "lm_head" in tree:
        params["lm_head"] = conv(tree["lm_head"])
    return params


def packed_from_numpy(w_t, scales=None, bits: int = 16, block: int = 32, *,
                      device) -> PackedWeights:
    """The JAX package's ``PackedWeights`` fields (numpy ``w_t`` and
    ``scales``, ``bits``, ``block``) -> the port's, on ``device``: int8
    codes (packed int4 included) and f32 scales keep their bytes."""
    return PackedWeights(
        w_t=tensor_from_numpy(w_t, device).contiguous(),
        scales=(None if scales is None
                else tensor_from_numpy(scales, device).contiguous()),
        bits=int(bits), block=int(block))
