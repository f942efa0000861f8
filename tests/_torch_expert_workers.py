"""What each rank runs for ``test_torch_expert_columns.py`` (and what the
test runs unsharded, through the same functions).  Imports no JAX: every
process ``launch.mesh.spawn`` starts imports this module to find its
function.

The cases are reduced MoE models whose expert count a 'model' axis of 2
does not divide, so that each rank holds its block of every expert's
``f`` (``sharding.serve_spec``): grok-1-314b with 3 experts, and
deepseek-moe-16b with 5 beside its shared expert.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import _torch_mesh_workers as W
from repro_torch.configs.registry import get_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import dispatch
from repro_torch.models import lm
from repro_torch.serving.engine import Engine, Request
from repro_torch.tree import leaves

# name: (arch, routed experts)
ODD = {"grok": ("grok-1-314b", 3), "deepseek": ("deepseek-moe-16b", 5)}
EXPERT_SHAPES = ("ragged", "grouped", "einsum")
CKPT_CASE = "grok"
QUANT_ROWS = 7          # routed rows of the int8 stacks' ragged pass


def odd_config(name: str):
    arch, n = ODD[name]
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            n_experts=n))


def serve(name: str, shape: str, mesh=None) -> dict:
    """Case ``name`` on the port's engine through the MoE decode route
    ``shape`` (this rank's share with ``mesh``): the mixed plan of prompt
    lengths, chunk 8.  Tokens, every sampled logits row and counters."""
    cfg = odd_config(name)
    params = lm.init_lm(cfg, seed=0, device="cpu", mesh=mesh)
    clk = W.FakeClock()
    dispatch.clear_plan_cache()
    eng = Engine(cfg, params, max_len=W.MAX_LEN, device="cpu", clock=clk,
                 mesh=mesh, batch_slots=4, prefill_chunk=8,
                 gemv_backend="h100", gemv_expert_shape=shape)
    rows: dict[int, list] = {}
    sample = eng._sample

    def recorded(r, row):
        rows.setdefault(r.rid, []).append(np.array(row))
        return sample(r, row)

    eng._sample = recorded
    reqs = W.drive(eng, Request, W.mix_plan(cfg.vocab), clk)
    return {"tokens": {rid: list(r.generated) for rid, r in reqs.items()},
            "rows": rows, "stats": dispatch.dispatch_stats(),
            "moe0": {k: tuple(v.shape) for k, v in
                     params["layers"][0]["moe"].items()
                     if isinstance(v, torch.Tensor)}}


def quant_stacks(name: str) -> dict:
    """Layer 0's expert stacks of case ``name`` (the seeded init),
    quantized whole to int8 expert by expert: {leaf: PackedWeights}."""
    from repro_torch.kernels.ops import PackedWeights, quantize_weight

    cfg = odd_config(name)
    p = lm.init_lm(cfg, seed=0, device="cpu")["layers"][0]["moe"]
    return {k: PackedWeights.stack([quantize_weight(w.t(), bits=8)
                                    for w in p[k]])
            for k in ("w_gate", "w_up", "w_down") if k in p}


def quant_inputs(name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-sorted rows ``x [QUANT_ROWS, d]`` and their per-expert
    counts (one expert with none)."""
    cfg = odd_config(name)
    E = cfg.moe.n_experts
    counts = [QUANT_ROWS - 4, 0, 4] + [0] * (E - 3)
    rng = np.random.default_rng(E)
    x = rng.standard_normal((QUANT_ROWS, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(x), torch.tensor(counts, dtype=torch.int32)


def quant_ffn(name: str, mesh=None) -> dict:
    """The expert FFN of case ``name`` over :func:`quant_inputs` through
    ``dispatch_ragged`` on its int8 stacks (the ``cpu`` backend): with
    ``mesh`` on the rank's ``shard_packed`` blocks (gate / up cut on M,
    down on K, in whole scale blocks), the partial summed over 'model'.
    Also whether each block equals the rank's float block quantized on
    its own."""
    from repro_torch.kernels.backends import DispatchPolicy
    from repro_torch.kernels.ops import PackedWeights, quantize_weight
    from repro_torch.models import layers as L

    cfg = odd_config(name)
    x, counts = quant_inputs(name)
    stacks = quant_stacks(name)
    n = 1 if mesh is None else mesh.size("model")
    policy = DispatchPolicy(backend="cpu", model_shards=n)
    out = {"axes": {}, "equals_own": {}}
    blocks = {}
    for k, pw in stacks.items():
        if mesh is None:
            blocks[k] = pw
            continue
        blocks[k], out["axes"][k] = shd.shard_packed(
            pw, mesh, "K" if k == "w_down" else "M")
        float_stack = lm.init_lm(cfg, seed=0,
                                 device="cpu")["layers"][0]["moe"][k]
        cut = shd.shard_tensor(float_stack, shd.serve_spec(
            f"layers/0/moe/{k}", tuple(float_stack.shape), mesh, cfg), mesh)
        own = PackedWeights.stack([quantize_weight(w.t(), bits=8)
                                   for w in cut])
        out["equals_own"][k] = (torch.equal(own.w_t, blocks[k].w_t)
                                and torch.equal(own.scales,
                                                blocks[k].scales))
    dispatch.clear_plan_cache()

    def proj(axis):
        return lambda t, w: dispatch.dispatch_ragged(
            t, counts, w, policy=policy, shard=axis)

    axes = ("M", "K") if mesh is not None else ("replicated",) * 2
    y = L._expert_ffn(blocks, x, cfg, *map(proj, axes))
    if mesh is not None:
        y = coll.all_reduce_sum(y, mesh.group("model"))
    out.update(y=y, stats=dispatch.dispatch_stats(),
               block_shapes={k: tuple(b.w_t.shape)
                             for k, b in blocks.items()})
    return out


def train_step(name: str, tree, mesh=None, *, full_step: bool = False
               ) -> dict:
    """Case ``name``'s training step on the full param tree ``tree`` (the
    JAX package's values through the bridge), on this rank's stored blocks
    with ``mesh``: gradients (gathered whole), loss and aux; with
    ``full_step`` the stepped params and optimizer state too, whole and
    as the rank's blocks."""
    from repro_torch.train.train_step import build_train_step

    cfg = odd_config(name)
    tcfg = W.tp_train_config("deepseek", cfg)
    step, opt_init = build_train_step(cfg, tcfg, mesh=mesh)
    params = tree if mesh is None else shd.shard_train_tree(tree, mesh, cfg)
    batch = W.tp_batch(cfg)
    grads, loss, aux = step.grads(params, batch)
    out = {"grads": grads, "loss": float(loss), "aux": float(aux)}
    if full_step:
        new, state, _ = step(params, opt_init(params), batch)
        out["blocks"] = {"params": new, "opt": state}
    if mesh is None:
        return out
    out["shapes"] = [tuple(t.shape) for t in leaves(params)]
    out["grads"] = shd.gather_train_tree(grads, mesh, cfg)
    if full_step:
        out["state"] = shd.gather_train_tree(out["blocks"], mesh, cfg)
    return out


def save(mesh, name: str, blocks: dict, directory: str) -> None:
    """Case ``name``'s stepped state (this rank's blocks) saved into
    ``directory`` from this mesh: full leaves, rank 0 writing."""
    from repro_torch.checkpoint.manager import CheckpointManager

    CheckpointManager(directory, group=torch.distributed.group.WORLD).save(
        1, blocks, shardings=shd.train_specs_of(blocks, mesh,
                                                odd_config(name)),
        mesh=mesh)


def ranks(mesh, bridged: dict, ckpt_dir: str) -> dict:
    """Every case on this rank: each decode route's serving run, the int8
    stacks, and the training step on ``bridged`` ({case: the JAX
    package's tree as numpy}); case ``CKPT_CASE``'s stepped state saved
    into ``ckpt_dir``."""
    from repro_torch.bridge import params_from_numpy

    out = {"coords": dict(mesh.coords)}
    for name in ODD:
        for shape in EXPERT_SHAPES:
            out[name, shape] = serve(name, shape, mesh)
        out[name, "quant"] = quant_ffn(name, mesh)
        tree = params_from_numpy(bridged[name], odd_config(name), "cpu")
        out[name, "train"] = train_step(name, tree, mesh,
                                        full_step=name == CKPT_CASE)
    save(mesh, CKPT_CASE, out[CKPT_CASE, "train"].pop("blocks"), ckpt_dir)
    return out
