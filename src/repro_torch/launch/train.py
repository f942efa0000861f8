"""Training launcher (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT --device cpu

Builds the model and the train step and drives them through the
fault-tolerant loop (checkpoint / restart, the straggler monitor, the
step-addressed data).  The reference's flags, plus ``--device``: the
card unless ``--device cpu`` is given (with no card and no ``--device``
it raises).  The model runs in f32, the reference's CPU-test numerics.

``--mesh DxM`` trains over D x M ranks: under ``torchrun
--nproc-per-node D*M`` (``make_mesh`` reads the environment), or from
Python with ``launch.mesh.spawn(run_on_mesh, (D, M), args=(argv,))``.
Each rank draws the same model from the seed and keeps its stored
blocks of it (``lm.init_lm(mesh=, train=True)``: its 'model' block of
each leaf, cut again over 'data'), and steps on its 'data' row block of
every global batch (``train_step``).  Checkpoints hold the full leaves
(gathered, written by rank 0 of the world alone); a restore cuts this
rank's blocks from them, so a run may resume on a mesh of another shape.
Rank 0 alone prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch.distributed as dist


def main(argv: list[str] | None = None, *, mesh=None,
         fail_at: tuple[int, ...] = ()) -> dict:
    """Run the launcher with ``argv``; ``mesh`` is the rank's mesh when a
    caller built it (``spawn``), and ``fail_at`` the steps at which a
    :class:`FaultInjector` raises (on every rank, before the step's
    collective).  Returns ``losses``, ``stats`` (the recovery stats),
    ``step_s`` (each step's seconds), the final ``params`` and ``opt``
    (on a mesh, this rank's blocks) and the model's ``cfg``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--mesh", default="1x1",
                    help="data x model, e.g. 2x2 (D x M ranks)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "bf16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M example model)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh, parse_mesh_arg
    from repro_torch.models import lm
    from repro_torch.train.fault_tolerance import (
        FaultInjector,
        StragglerMonitor,
        run_with_recovery,
    )
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.distributed.sharding import state_specs
    from repro_torch.train.train_step import (
        TrainConfig,
        build_train_step,
        to_device,
    )

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    over = {}
    if args.d_model:
        over["d_model"] = args.d_model
    if args.n_layers:
        over["n_layers"] = args.n_layers
    if args.d_ff:
        over["d_ff"] = args.d_ff
    if args.vocab:
        over["vocab"] = args.vocab
    if over:
        over.setdefault("head_dim", max(args.d_model // max(cfg.n_heads, 1), 8)
                        if args.d_model else cfg.head_dim)
        cfg = dataclasses.replace(cfg, **over)
    # the reference's CPU-test numerics
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32", max_seq_len=args.seq)

    shape = parse_mesh_arg(args.mesh)
    if mesh is None and shape != (1, 1):
        mesh = make_mesh(shape, ("data", "model"), device=args.device)
    elif mesh is not None and tuple(mesh.shape.values()) != shape:
        raise ValueError(f"--mesh {args.mesh} but the rank's mesh is "
                         f"{mesh.shape}")
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0

    tcfg = TrainConfig(
        opt=OptConfig(name=cfg.optimizer, lr=args.lr,
                      warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps),
        accum_steps=args.accum, grad_compress=args.grad_compress)
    step_fn, opt_init = build_train_step(cfg, tcfg, mesh=mesh)
    layout = step_fn.layout
    params = lm.init_lm(cfg, seed=args.seed, device=dev, mesh=mesh,
                        train=True)
    state = {"params": params, "opt": opt_init(params)}
    # the spec of each leaf of the saved state, on the rank's mesh
    shard = ({} if layout is None else dict(
        shardings=state_specs(state, params, layout.specs), mesh=mesh))

    data = SyntheticLM(cfg, DataConfig(global_batch=args.batch,
                                       seq_len=args.seq, seed=args.seed))
    ckpt = CheckpointManager(
        args.ckpt_dir, keep=2,
        group=dist.group.WORLD if layout is not None else None)
    monitor = StragglerMonitor()
    injector = FaultInjector(set(fail_at))
    losses: list[float] = []
    step_s: list[float] = []

    def do_step(step: int) -> dict:
        injector.maybe_fail(step)
        t0 = time.perf_counter()
        batch = to_device(data.batch_at(step), dev)
        if tcfg.accum_steps > 1:
            batch = {k: v.reshape((tcfg.accum_steps,
                                   v.shape[0] // tcfg.accum_steps)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
        state["params"], state["opt"], metrics = step_fn(
            state["params"], state["opt"], batch)
        m = {k: float(v) for k, v in metrics.items()}
        step_s.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        return m

    def save(step: int) -> None:
        ckpt.save(step, state, metadata={"step": step}, blocking=False,
                  **shard)

    def restore() -> int:
        return restore_latest(ckpt, state, **shard)

    def report(s: int, m: dict) -> None:
        if lead:
            print(f"step {s:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f}", flush=True)

    t0 = time.perf_counter()
    stats = run_with_recovery(
        n_steps=args.steps, do_step=do_step, save=save, restore=restore,
        ckpt_every=args.ckpt_every, monitor=monitor, on_metrics=report)
    ckpt.wait()
    dt = time.perf_counter() - t0
    if lead and losses:
        print(f"done: {args.steps} steps in {dt:.1f}s; loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"restarts={stats.restarts} "
              f"stragglers={len(stats.straggler_steps)}", flush=True)
    elif lead:
        # a checkpoint in --ckpt-dir already covers every step
        print(f"done: resumed past step {args.steps} from "
              f"{args.ckpt_dir}; no new steps run", flush=True)
    return {"losses": losses, "stats": stats, "step_s": step_s,
            "params": state["params"], "opt": state["opt"], "cfg": cfg}


def restore_latest(ckpt, state: dict, **shard) -> int:
    """Load the newest checkpoint into ``state`` and return its step (0,
    loading nothing, when there is none).  The writer is waited for
    before the latest step is read, so the step returned is the one
    whose state was loaded even when a non-blocking save was still
    writing (the reference reads the step first: ROADMAP §3).  On a mesh
    every rank meets at the wait, so each sees what rank 0 published;
    ``shard`` (``shardings=``, ``mesh=``) cuts this rank's blocks."""
    ckpt.wait()
    s = ckpt.latest_step()
    if s is None:
        return 0
    restored, _ = ckpt.restore(state, step=s, **shard)
    state.update(restored)
    return s


def run_on_mesh(mesh, argv: list[str], fail_at: tuple[int, ...] = ()
                ) -> dict:
    """:func:`main` on a rank that ``launch.mesh.spawn`` started: its
    losses and stats, and its final params and optimizer state, full
    (gathered from every rank's blocks) and on the CPU."""
    from repro_torch.distributed.sharding import gather_train_tree
    from repro_torch.tree import tree_map

    out = main(argv, mesh=mesh, fail_at=fail_at)
    full = gather_train_tree({"params": out["params"], "opt": out["opt"]},
                             mesh, out["cfg"])
    full = tree_map(lambda t: t.detach().cpu(), full)
    return {**out, **full}


if __name__ == "__main__":
    main()
