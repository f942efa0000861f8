"""Optimizers: AdamW (f32 moments) and Adafactor (factored second moment,
sublinear state; grok-1-314b's).  Counterpart of
``repro/train/optimizer.py``: trees in, trees out, nothing updated in
place, every state leaf f32.

The reference's per-layer leaves are stacked ``[L, ...]`` and its rules
read the stacked leaf: decoupled weight decay applies when ``ndim >= 2``
(so a stacked norm scale ``[L, d]`` decays), Adafactor factors on the
stacked shape's last two dims, and its update-RMS clip is one mean over
the stacked leaf, every layer at once.  The port keeps one dict a layer;
given the model's config (``make_optimizer(cfg, model)``) it applies the
same rules to each leaf's *reference shape* (:func:`reference_groups`):
the per-layer leaves of one reference leaf form a group, the rules read
the group's stacked shape, and the RMS is a mean over the whole group.
Without a config every leaf is its own group at its own shape (a tree
laid out as the reference's, e.g. its stacked numpy leaves).

On a mesh (``layout``, a ``sharding.TrainLayout``) each rank holds its
stored blocks of the params, gradients and state.  The rules read each
leaf's full shape, and every mean over a dim a cut may split is a sum
over the ranks holding the other blocks, divided by the full count:
Adafactor's ``vr``, ``vc`` and the mean of ``vr``, its update-RMS clip
(one mean over the whole reference leaf) and the global norm (each
element counted once: a leaf held whole on several ranks is summed on
one).  Every rank gets the same bits of each sum.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import (
    flatten_with_paths,
    leaves,
    tree_map,
    unflatten_like,
)


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    factored_min_dim: int = 128


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; every
    operation in f32 (a 0-d CPU tensor), as the reference computes it."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree, layout=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 squares (on the leaves'
    device).  With ``layout`` the leaves are a rank's blocks: the leaves
    cut by the same axes are summed here, each such sum over those axes'
    ranks (an entry over several axes, over their product), and the sums
    added in a fixed order."""
    sq = [torch.sum(torch.square(g.float())) for g in leaves(tree)]
    if layout is None:
        return torch.sqrt(torch.stack(sq).sum())
    by_axes: dict[tuple, list] = {}
    for j, s in enumerate(sq):
        by_axes.setdefault(layout.cut_axes(j), []).append(s)
    total = [layout.sum_over(torch.stack(by_axes[a]).sum(), a)
             for a in sorted(by_axes, key=_entries_key)]
    return torch.sqrt(torch.stack(total).sum())


def _entries_key(entries: tuple) -> tuple[str, ...]:
    """A sort key of a leaf's cut entries: an entry over several axes
    (``("pod", "data")``) as one name, ``"pod+data"``, so that names and
    tuples sort together, in the same order on every rank."""
    return tuple(a if isinstance(a, str) else "+".join(a) for a in entries)


def clip_by_global_norm(tree, max_norm: float, layout=None):
    norm = global_norm(tree, layout)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


# --------------------------------------------------------------------------
# The reference's leaf shapes
# --------------------------------------------------------------------------


def _reference_leaf(path: tuple, model: ModelConfig | None):
    """(key, stack): the reference leaf that the port's leaf at ``path``
    is one layer of, and the dims stacked in front of it there."""
    if model is None:
        return path, ()
    if path[0] == "layers":
        i, rest = path[1], path[2:]
        g = model.cross_attn_every
        if g > 0:               # llama-vision's groups
            n = model.n_layers // g
            if i % g == g - 1:
                return ("groups", "cross_layer") + rest, (n,)
            return ("groups", "plain") + rest, (n, g - 1)
        return ("layers",) + rest, (model.n_layers,)
    if path[:2] == ("encoder", "layers"):
        return ("encoder", "layers") + path[3:], (model.encoder.n_layers,)
    return path, ()


def reference_groups(params, model: ModelConfig | None = None,
                     layout=None
                     ) -> list[tuple[tuple[int, ...], list[int]]]:
    """``[(stacked_shape, [leaf index, ...]), ...]``: each reference leaf's
    shape and the indices (in flattening order) of the port's leaves it
    stacks; without ``model`` every leaf is its own group.  With
    ``layout`` the leaves are a rank's blocks, and the shapes are the
    full leaves'."""
    groups: dict[tuple, tuple[tuple[int, ...], list[int]]] = {}
    for j, (path, leaf) in enumerate(flatten_with_paths(params)):
        key, stack = _reference_leaf(path, model)
        full = (tuple(leaf.shape) if layout is None
                else layout.full_shape(j, leaf.shape))
        shape = tuple(stack) + full
        if key not in groups:
            groups[key] = (shape, [])
        elif groups[key][0] != shape:
            raise ValueError(f"leaf {path} has shape {tuple(leaf.shape)}, "
                             f"not its group's {groups[key][0]}")
        groups[key][1].append(j)
    return list(groups.values())


def _factored(shape: tuple[int, ...], min_dim: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def _check_factorable(shape, leaf_shape, min_dim: int) -> bool:
    """Whether a leaf of reference ``shape`` is factored; raises where the
    reference would factor across the stacked layer dim (a 1-D per-layer
    leaf and 128 layers or more): no config has that many."""
    if not _factored(shape, min_dim):
        return False
    if len(leaf_shape) < 2:
        raise ValueError(f"a per-layer leaf {tuple(leaf_shape)} whose "
                         f"reference shape {shape} is factored across "
                         f"layers: not supported")
    return True


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params,
                 model: ModelConfig | None = None, layout=None):
    step = state["step"] + 1
    lr = float(lr_at(cfg, step))
    t = step.float()
    c1 = float(1 - _f32(cfg.b1) ** t)
    c2 = float(1 - _f32(cfg.b2) ** t)
    b1, b2 = cfg.b1, cfg.b2
    flat_p, flat_g = leaves(params), leaves(grads)
    flat_m, flat_v = leaves(state["mu"]), leaves(state["nu"])
    n = len(flat_p)
    new_p, new_m, new_v = [None] * n, [None] * n, [None] * n
    for shape, idx in reference_groups(params, model, layout):
        for j in idx:
            g, p = flat_g[j].float(), flat_p[j]
            m = b1 * flat_m[j] + (1 - b1) * g
            v = b2 * flat_v[j] + (1 - b2) * torch.square(g)
            delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            if len(shape) >= 2:     # decoupled decay on matrices only
                delta = delta + cfg.weight_decay * p.float()
            new_p[j] = (p.float() - lr * delta).to(p.dtype)
            new_m[j], new_v[j] = m, v
    return unflatten_like(params, new_p), {
        "mu": unflatten_like(params, new_m),
        "nu": unflatten_like(params, new_v), "step": step}


# --------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), factored second moment
# --------------------------------------------------------------------------


def adafactor_init(params, cfg: OptConfig | None = None,
                   model: ModelConfig | None = None, layout=None):
    """Per leaf ``{"vr", "vc"}`` (the row and column statistics of a
    factored leaf, each layer its own) or ``{"v"}``; with ``layout`` a
    rank's blocks of them (a factored leaf's full shape decides)."""
    cfg = cfg or OptConfig(name="adafactor")
    flat = leaves(params)
    stats = [None] * len(flat)
    for shape, idx in reference_groups(params, model, layout):
        for j in idx:
            p = flat[j]

            def z(s, p=p):
                return torch.zeros(s, dtype=torch.float32, device=p.device)

            if _check_factorable(shape, p.shape, cfg.factored_min_dim):
                stats[j] = {"vr": z(p.shape[:-1]),
                            "vc": z(p.shape[:-2] + p.shape[-1:])}
            else:
                stats[j] = {"v": z(p.shape)}
    return {"f": unflatten_like(params, stats),
            "step": torch.zeros((), dtype=torch.int32)}


def _mean(t: torch.Tensor, dim: int, j: int, pdim: int, layout,
          keepdim: bool = False) -> torch.Tensor:
    """The mean of ``t`` over ``dim``, which is dim ``pdim`` of param
    leaf ``j``: where a mesh axis cuts that dim, the sum over the ranks
    holding its blocks divided by the full count."""
    axis = None if layout is None else layout.axis_of(j, pdim)
    if axis is None:
        return torch.mean(t, dim=dim, keepdim=keepdim)
    total = layout.sum_over(torch.sum(t, dim=dim, keepdim=keepdim), (axis,))
    return total / (t.shape[dim] * layout.mesh.size(axis))


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params,
                     model: ModelConfig | None = None, layout=None):
    step = state["step"] + 1
    lr = float(lr_at(cfg, step))
    beta2 = 1.0 - step.float() ** (-cfg.decay_rate)
    b2, c2 = float(beta2), float(1 - beta2)
    flat_p, flat_g = leaves(params), leaves(grads)
    flat_s = []     # each leaf's stats dict, in flattening order
    for path, _ in flatten_with_paths(params):
        node = state["f"]
        for k in path:
            node = node[k]
        flat_s.append(node)
    new_p, new_s = [None] * len(flat_p), [None] * len(flat_p)
    for shape, idx in reference_groups(params, model, layout):
        updates = []
        for j in idx:
            g, s = flat_g[j].float(), flat_s[j]
            g2 = torch.square(g) + 1e-30
            if "vr" in s:
                nd = g.ndim
                vr = b2 * s["vr"] + c2 * _mean(g2, -1, j, nd - 1, layout)
                vc = b2 * s["vc"] + c2 * _mean(g2, -2, j, nd - 2, layout)
                denom = (vr[..., None] * vc[..., None, :]
                         / (_mean(vr, -1, j, nd - 2, layout,
                                  keepdim=True)[..., None] + 1e-30))
                u = g / (torch.sqrt(denom) + 1e-30)
                new_s[j] = {"vr": vr, "vc": vc}
            else:
                v = b2 * s["v"] + c2 * g2
                u = g / (torch.sqrt(v) + 1e-30)
                new_s[j] = {"v": v}
            updates.append(u)
        # update clipping (RMS <= 1), one mean over the reference leaf
        n = math.prod(shape)
        sq = torch.stack([torch.sum(torch.square(u)) for u in updates]).sum()
        if layout is not None:
            sq = layout.sum_over(sq, layout.cut_axes(idx[0]))
        rms = torch.sqrt(sq / n + 1e-30)
        for j, u in zip(idx, updates):
            p = flat_p[j]
            u = u / torch.clamp(rms, min=1.0)
            if len(shape) >= 2:
                u = u + cfg.weight_decay * p.float()
            new_p[j] = (p.float() - lr * u).to(p.dtype)
    return (unflatten_like(params, new_p),
            {"f": unflatten_like(params, new_s), "step": step})


# --------------------------------------------------------------------------


def make_optimizer(cfg: OptConfig, model: ModelConfig | None = None,
                   layout=None):
    """``(init(params), update(cfg, grads, state, params))`` for
    ``cfg.name``; with ``model`` the rules read the reference's shapes,
    with ``layout`` on a rank's blocks (see the module's docstring)."""
    if cfg.name == "adamw":
        return adamw_init, (lambda c, g, s, p:
                            adamw_update(c, g, s, p, model, layout))
    if cfg.name == "adafactor":
        return (lambda p: adafactor_init(p, cfg, model, layout),
                lambda c, g, s, p: adafactor_update(c, g, s, p, model,
                                                    layout))
    raise ValueError(cfg.name)
