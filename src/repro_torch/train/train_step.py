"""The train step: loss, gradients, optimizer update (counterpart of
``repro/train/train_step.py``).

``build_train_step(cfg, tcfg, mesh=)`` returns ``(step, opt_init)`` with
``step(params, opt_state, batch) -> (params, opt_state, metrics)``;
``step.grads(params, batch)`` gives the step's gradients, loss and aux
before the clip and the update (what the tests hold).  The
step is functional, as the reference's jitted one is: it takes gradients
with ``torch.autograd.grad`` on fresh leaves that share the parameters'
storage, and the params and state it returns are new tensors that do not
require grad.  The forward is ``lm.forward`` with no dispatch policy:
plain PyTorch products, which have a backward, never a hand kernel (the
kernels have none, and their wrappers refuse to run under autograd).

* ``accum_steps`` > 1: the batch's leaves are ``[accum, B / accum, ...]``
  and the f32 gradients of the microbatches are summed, then averaged (the
  reference's ``lax.scan``);
* ``grad_compress="bf16"``: each gradient is rounded to bf16 and back
  (``_compress``), then reduced in f32;
* on a ``(D, M)`` or ``(pod, D, M)`` mesh (``launch.mesh``) each rank
  holds its stored blocks of the params and optimizer state
  (``sharding.train_spec``: its 'model' block of each leaf, cut again
  over the data axes), and ``step`` takes and returns those blocks.
  'pod' folds into data parallelism, as in the reference: "the data
  axes" are 'data', or the product ``("pod", "data")`` (pod-major;
  ``sharding.fsdp_entry``) where 'pod' is larger than 1.  The step
  takes the global batch; a rank computes on its row block of it over
  the data axes.  It gathers the rank's blocks over the data axes (FSDP)
  into its 'model' blocks, runs the forward and backward on them under
  the mesh (the layers' rank blocks, their collectives' backwards:
  ``models/layers.py``), accumulates and compresses as above (each
  rank's gradients rounded before the mean, on every mesh), and reduces
  the f32 mean over the data axes to each rank's stored block
  (``collectives.reduce_scatter_mean``: the counterpart of the
  reference's ``_constrain_like_params``).  Then it clips (the global
  norm counts each element once) and applies the optimizer to the
  blocks (``make_optimizer(layout=)``).  The MoE load-balance loss
  counts the global batch's routing over the data axes
  (``layers._aux_loss``); loss and aux are averaged over the data axes
  only, since every 'model' rank holds the same value.  So the step computes
  the unsharded step's loss, gradients and update, each on the rank
  that holds its block (``sharding.gather_train_tree`` puts them
  together).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.axes import activation_mesh
from repro_torch.distributed.collectives import (
    all_gather_cat,
    all_reduce_sum,
    reduce_scatter_mean,
)
from repro_torch.models import lm
from repro_torch.train.optimizer import (
    OptConfig,
    clip_by_global_norm,
    make_optimizer,
)
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import unflatten_like


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    accum_steps: int = 1
    grad_compress: str = "none"      # none | bf16
    z_loss: float = 0.0              # optional logit regularizer


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token cross entropy in f32: logsumexp minus the gold
    logit (logits ``[B, S, V]``, labels ``[B, S]``), plus ``z_loss`` times
    the mean squared logsumexp."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - gold)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def loss_fn(params, cfg: ModelConfig, batch: dict, tcfg: TrainConfig, *,
            batch_group=None):
    """``(loss + aux, (loss, aux))``: the logits at positions ``:-1``
    against the tokens at ``1:``, plus the MoE load-balance loss."""
    logits, _, aux = lm.forward(
        params, cfg, batch["tokens"], frames=batch.get("frames"),
        vision=batch.get("vision"), batch_group=batch_group)
    loss = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                         tcfg.z_loss)
    return loss + aux, (loss, aux)


def _compress(grads: list, how: str) -> list:
    if how == "bf16":
        return [g.to(torch.bfloat16).float() for g in grads]
    if how != "none":
        raise ValueError(f"unknown grad_compress {how!r}")
    return grads


def train_layout(cfg: ModelConfig, mesh):
    """The ``sharding.TrainLayout`` of ``cfg``'s params on ``mesh`` (None
    without a mesh of more than one rank); raises for a mesh the step
    does not take."""
    if mesh is None or mesh.world_size <= 1:
        return None
    shd.check_train_mesh(mesh, cfg)
    return shd.TrainLayout(mesh, shd.model_specs(cfg, mesh)[1])


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, mesh=None):
    """Returns ``(step, opt_init)``; see the module's docstring.  On a
    mesh both take and return this rank's stored blocks, and
    ``step.layout`` is their ``sharding.TrainLayout``."""
    layout = train_layout(cfg, mesh)
    opt_init, opt_update = make_optimizer(tcfg.opt, cfg, layout)
    # the data axes ('pod' folded in): the FSDP entry of the stored
    # blocks, the rows of the batch, the gradient and loss means
    entry = shd.fsdp_entry(mesh) if layout is not None else None
    group = (mesh.group(entry) if entry is not None
             and mesh.size(entry) > 1 else None)
    n_ranks = mesh.size(entry) if group is not None else 1
    rank = mesh.index(entry) if group is not None else 0
    data_dims = ([s.index(entry) if entry in s else None
                  for s in layout.specs] if group is not None
                 else None)
    accum = tcfg.accum_steps

    def rows(batch: dict) -> dict:
        """This rank's row block of the global batch (dim 1 of a
        microbatched batch)."""
        if group is None:
            return batch
        dim = 1 if accum > 1 else 0

        def one(v):
            n = v.shape[dim]
            if n % n_ranks:
                raise ValueError(f"batch of {n} rows does not split over "
                                 f"{n_ranks} ranks")
            return v.narrow(dim, rank * (n // n_ranks), n // n_ranks)

        return {k: one(v) for k, v in batch.items()}

    def model_blocks(ps: list) -> list:
        """The stored blocks gathered over 'data': the rank's 'model'
        block of each leaf (what its layers compute with)."""
        if group is None:
            return ps
        with torch.no_grad():
            return [p if d is None else all_gather_cat(p, group, dim=d)
                    for p, d in zip(ps, data_dims)]

    def grads_of(params, full, batch):
        leaves = [p.detach().requires_grad_(True) for p in full]
        tree = unflatten_like(params, leaves)
        with torch.enable_grad(), activation_mesh(
                mesh if layout is not None else None):
            total, (loss, aux) = loss_fn(tree, cfg, batch, tcfg,
                                         batch_group=group)
            grads = torch.autograd.grad(total, leaves,
                                        materialize_grads=True)
        return list(grads), loss.detach(), aux.detach()

    def synced_grads(params, batch):
        """(gradients in flattening order, loss, aux): accumulated,
        compressed and averaged over 'data' (to each rank's stored block
        on a mesh), not yet clipped."""
        batch = rows(to_device(batch, tree_leaves(params)[0].device))
        full = model_blocks(tree_leaves(params))
        if accum > 1:
            gsum, loss, aux = None, 0.0, 0.0
            for a in range(accum):
                g, l_a, x_a = grads_of(params, full,
                                       {k: v[a] for k, v in batch.items()})
                gsum = ([x.float() for x in g] if gsum is None
                        else [s + x.float() for s, x in zip(gsum, g)])
                loss, aux = loss + l_a, aux + x_a
            grads = [s / accum for s in gsum]
            loss, aux = loss / accum, aux / accum
        else:
            grads, loss, aux = grads_of(params, full, batch)
        del full
        grads = _compress(grads, tcfg.grad_compress)
        if group is not None:
            grads = [reduce_scatter_mean(g, group, d)
                     for g, d in zip(grads, data_dims)]
            la = all_reduce_sum(torch.stack([loss, aux]).float(), group)
            loss, aux = la[0] / n_ranks, la[1] / n_ranks
        return grads, loss, aux

    def grads(params, batch):
        """The step's gradients (a tree like ``params``: on a mesh, this
        rank's stored blocks), loss and aux, before the clip and the
        update."""
        g, loss, aux = synced_grads(params, batch)
        return unflatten_like(params, g), loss, aux

    def step(params, opt_state, batch):
        g, loss, aux = synced_grads(params, batch)
        grads, gnorm = clip_by_global_norm(unflatten_like(params, g),
                                           tcfg.opt.grad_clip, layout)
        del g       # the clipped copy alone stays for the update's peak
        params, opt_state = opt_update(tcfg.opt, grads, opt_state, params)
        metrics = {"loss": loss.float(), "aux_loss": aux.float(),
                   "grad_norm": gnorm.float()}
        return params, opt_state, metrics

    step.grads = grads
    step.layout = layout
    return step, opt_init
