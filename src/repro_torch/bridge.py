"""Weight transfer from the JAX package's parameter tree, through numpy.

The JAX package's ``init_lm`` returns a pytree whose per-layer leaves are
stacked ``[L, ...]``.  :func:`params_from_numpy` takes that tree with every
leaf converted to a numpy array (``jax.tree.map(np.asarray, params)``) and
returns the port's parameter dict (one dict per layer), so a test can feed
both packages exactly the same weights.  :func:`packed_from_numpy` does the
same for one of the JAX package's ``PackedWeights`` (quantized ones
included).  :func:`params_to_numpy` is the inverse of
:func:`params_from_numpy` (the reference's stacked tree back), and
:func:`opt_state_to_numpy` / :func:`opt_state_from_numpy` carry an
optimizer state (AdamW's ``mu`` / ``nu`` / ``step``, Adafactor's ``f``
with ``vr`` / ``vc`` / ``v`` and ``step``) across the same way.  Nothing
here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import PackedWeights
from repro_torch.models.lm import check_family


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy -> torch, bf16 included (numpy's ``bfloat16`` extension type
    has no torch counterpart in ``from_numpy``: go through its bits)."""
    a = np.array(a)  # a writable copy: torch shares the buffer
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The JAX package's ``init_lm`` tree (numpy leaves) -> the port's
    params on ``device``.  Every leaf keeps its layout: an MoE layer's f32
    ``router [d, E]``, its expert stacks ``w_gate``/``w_up [E, d, f]`` and
    ``w_down [E, f, d]``, and its ``shared`` MLP.  llama-vision's
    ``groups.plain [n_groups, g - 1, ...]`` and ``groups.cross_layer
    [n_groups, ...]`` unroll into the flat layer list, group ``gi``'s
    member ``i`` at ``gi * g + i``; whisper's ``encoder`` keeps ``proj``
    None when the JAX tree has None there; a hymba layer's ``mamba`` keeps
    its f32 ``dt_bias``, ``A_log`` and ``D`` beside the model-dtype
    projections, and its betas come across with it."""
    check_family(cfg)

    def conv(node, i=()):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: conv(v, i) for k, v in node.items()}
        return tensor_from_numpy(node[i], device)

    params = {"embed": conv(tree["embed"]), "ln_f": conv(tree["ln_f"])}
    if "groups" in tree:
        g = cfg.cross_attn_every
        grp = tree["groups"]
        params["layers"] = [
            conv(grp["cross_layer"], (gi,)) if i == g - 1
            else conv(grp["plain"], (gi, i))
            for gi in range(cfg.n_layers // g) for i in range(g)]
    else:
        params["layers"] = [conv(tree["layers"], (i,))
                            for i in range(cfg.n_layers)]
    if "encoder" in tree:
        enc = tree["encoder"]
        params["encoder"] = {
            "layers": [conv(enc["layers"], (i,))
                       for i in range(cfg.encoder.n_layers)],
            "ln_f": conv(enc["ln_f"]), "proj": conv(enc.get("proj"))}
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


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy; a bf16 tensor becomes numpy's ``bfloat16`` extension
    type (``ml_dtypes``, which the reference's numpy leaves use)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _stack(nodes: list):
    """Leaf-wise ``np.stack`` of trees of one structure (dicts of arrays,
    None kept)."""
    if nodes[0] is None:
        return None
    if isinstance(nodes[0], dict):
        return {k: _stack([n[k] for n in nodes]) for k in nodes[0]}
    return np.stack([n if isinstance(n, np.ndarray) else tensor_to_numpy(n)
                     for n in nodes])


def params_to_numpy(params: dict, cfg: ModelConfig) -> dict:
    """The port's params -> the JAX package's ``init_lm`` tree with numpy
    leaves: the layers stacked ``[L, ...]`` again (llama-vision's into
    ``groups.plain [n_groups, g - 1, ...]`` and ``groups.cross_layer
    [n_groups, ...]``), whisper's encoder layers too.  The exact inverse
    of :func:`params_from_numpy`; it takes any tree of that structure
    whose leaves are trees (an optimizer's state)."""
    check_family(cfg)

    def conv(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return tensor_to_numpy(node)

    layers = params["layers"]
    tree = {"embed": conv(params["embed"]), "ln_f": conv(params["ln_f"])}
    if cfg.cross_attn_every > 0:
        g = cfg.cross_attn_every
        n = cfg.n_layers // g
        tree["groups"] = {
            "plain": _stack([_stack([layers[gi * g + i]
                                     for gi in range(n)])
                             for i in range(g - 1)]),
            "cross_layer": _stack([layers[gi * g + g - 1]
                                   for gi in range(n)])}
        # plain was stacked [g - 1, n, ...]: the reference's is [n, g - 1]
        tree["groups"]["plain"] = _swap01(tree["groups"]["plain"])
    else:
        tree["layers"] = _stack(layers)
    if "encoder" in params:
        enc = params["encoder"]
        tree["encoder"] = {"layers": _stack(enc["layers"]),
                           "ln_f": conv(enc["ln_f"]),
                           "proj": conv(enc.get("proj"))}
    if "lm_head" in params:
        tree["lm_head"] = conv(params["lm_head"])
    return tree


def _swap01(node):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _swap01(v) for k, v in node.items()}
    return np.ascontiguousarray(np.swapaxes(node, 0, 1))


def opt_state_to_numpy(state: dict, cfg: ModelConfig) -> dict:
    """An optimizer state of the port (``train.optimizer``) -> the
    reference's: the per-parameter trees stacked as
    :func:`params_to_numpy` stacks the params, ``step`` a numpy int32."""
    out = {"step": tensor_to_numpy(state["step"])}
    for k in ("mu", "nu", "f"):
        if k in state:
            out[k] = params_to_numpy(state[k], cfg)
    return out


def opt_state_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The reference's optimizer state (numpy leaves) -> the port's: the
    per-parameter trees on ``device`` as :func:`params_from_numpy` lays
    out the params, ``step`` a 0-d int32 CPU tensor."""
    out = {"step": torch.tensor(int(np.asarray(tree["step"])),
                                dtype=torch.int32)}
    for k in ("mu", "nu", "f"):
        if k in tree:
            out[k] = params_from_numpy(tree[k], cfg, device)
    return out
