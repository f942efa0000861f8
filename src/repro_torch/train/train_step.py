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
* on a ``(D, 1)`` mesh (``launch.mesh``) the step takes the global batch,
  each rank computes the gradients of its row block (the reference's
  GSPMD split of one batch), the gradients are averaged over 'data' in
  f32 (``compressed_psum_mean(method="none")``), then clipped and
  applied, so every rank holds the same params.  The MoE load-balance
  loss counts the global batch's routing (``layers._aux_loss``), and the
  metrics are the global batch's.  Model parallelism (a 'model' axis
  larger than 1) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import compressed_psum_mean
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


def data_group(mesh):
    """The 'data' group of a data-parallel mesh (None on one rank);
    raises for a mesh with another axis larger than 1."""
    if mesh is None:
        return None
    others = {a: n for a, n in mesh.shape.items() if a != "data" and n > 1}
    if others:
        raise ValueError(
            f"training on mesh {mesh.shape}: only a (D, 1) data-parallel "
            f"mesh is ported; model-parallel training ({others}) is "
            f"ROADMAP queue 1 item 5b")
    return mesh.group("data") if mesh.size("data") > 1 else None


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, mesh=None):
    """Returns ``(step, opt_init)``; see the module's docstring."""
    opt_init, opt_update = make_optimizer(tcfg.opt, cfg)
    group = data_group(mesh)
    n_ranks = mesh.size("data") if group is not None else 1
    rank = mesh.index("data") if group is not None else 0
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

    def grads_of(params, batch):
        ps = tree_leaves(params)
        leaves = [p.detach().requires_grad_(True) for p in ps]
        tree = unflatten_like(params, leaves)
        with torch.enable_grad():
            total, (loss, aux) = loss_fn(tree, cfg, batch, tcfg,
                                         batch_group=group)
            grads = torch.autograd.grad(total, leaves,
                                        materialize_grads=True)
        return list(grads), loss.detach(), aux.detach()

    def synced_grads(params, batch):
        """(gradients in flattening order, loss, aux): accumulated,
        compressed and averaged over the mesh, not yet clipped."""
        batch = rows(to_device(batch, tree_leaves(params)[0].device))
        if accum > 1:
            gsum, loss, aux = None, 0.0, 0.0
            for a in range(accum):
                g, l_a, x_a = grads_of(params,
                                       {k: v[a] for k, v in batch.items()})
                gsum = ([x.float() for x in g] if gsum is None
                        else [s + x.float() for s, x in zip(gsum, g)])
                loss, aux = loss + l_a, aux + x_a
            grads = [s / accum for s in gsum]
            loss, aux = loss / accum, aux / accum
        else:
            grads, loss, aux = grads_of(params, batch)
        grads = _compress(grads, tcfg.grad_compress)
        if group is not None:
            synced, _ = compressed_psum_mean(grads, group, method="none")
            grads = [s.to(g.dtype) for s, g in zip(synced, grads)]
            la = torch.stack([loss, aux]).float()
            dist.all_reduce(la, group=group)
            loss, aux = la[0] / n_ranks, la[1] / n_ranks
        return grads, loss, aux

    def grads(params, batch):
        """The step's gradients (a tree like ``params``), loss and aux,
        before the clip and the update."""
        g, loss, aux = synced_grads(params, batch)
        return unflatten_like(params, g), loss, aux

    def step(params, opt_state, batch):
        g, loss, aux = synced_grads(params, batch)
        grads, gnorm = clip_by_global_norm(unflatten_like(params, g),
                                           tcfg.opt.grad_clip)
        del g       # the clipped copy alone stays for the update's peak
        params, opt_state = opt_update(tcfg.opt, grads, opt_state, params)
        metrics = {"loss": loss.float(), "aux_loss": aux.float(),
                   "grad_norm": gnorm.float()}
        return params, opt_state, metrics

    step.grads = grads
    return step, opt_init
