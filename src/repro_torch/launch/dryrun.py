"""The dry run over meta tensors (counterpart of ``repro/launch/dryrun.py``).

For every (architecture x input shape x mesh) cell of the reference's,
take the production mesh (``(16, 16)`` single-pod, ``(2, 16, 16)``
multi-pod) as a description -- rank 0's coordinates, no processes -- and
build rank 0's blocks on the ``"meta"`` device: a train cell's params and
optimizer state by ``sharding.train_spec`` / ``state_specs``, a serving
cell's params by ``serve_spec`` and its cache by ``slot_cache_spec``, the
batch's rows by the data axes' product.  Run the cell's step on them
under ``activation_mesh`` and the collectives' counting mode
(``collectives.counting``): a train cell ``build_train_step(mesh=)``'s
step, a prefill or decode cell ``lm.forward`` over the cache, returning
the last position's logits and the new cache (the reference's
``_build_step``).  Nothing is computed: every op yields its result's
shape and dtype.  Record into ``artifacts/dryrun_torch/<arch>__<shape>__
<mesh>.json``, beside the reference's ``artifacts/dryrun/``:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the step
  (products and convolutions, as XLA's cost analysis counts them;
  ``torch._grouped_mm``, prefill's expert products, counted as one
  product a row);
* ``bytes_accessed``: each ATen op's operand and result bytes, summed
  (:class:`ByteCount`; views move nothing and are not counted).  This is
  UNFUSED traffic: every elementwise op reads and writes its tensors,
  where XLA's count is of its fused kernels;
* ``memory.argument_size`` / ``output_size``: the bytes of the rank's
  inputs (its blocks, the batch rows, the cache) and of what the step
  returns;
* ``collective_bytes`` by kind and ``collective_total``: each collective
  the port issues, its per-participant result bytes (the reference's
  ``parse_collective_bytes`` over post-SPMD HLO);
* ``roofline``: on the single-pod mesh, the cell at L1 and L2 layers
  (L1 one attention-pattern period) extrapolated linearly to the full
  depth, as the reference's ``roofline_corrected``.

Deliberate differences, which the record names (``no_counterpart``):
there is no XLA lowering, so no ``lower_s``, ``compile_s`` or
``hlo_lines`` (``trace_s``, the counted run's wall time, stands in their
place) and no ``memory.temp_size`` or ``generated_code_size`` (null, with
a ``note``); ``bytes_accessed`` is unfused; and the port places a train
cell's leaves by ``train_spec`` (and serves with params replicated over
the data axes), where the reference plans by ``plan_params``, so a
rank's bytes differ from the reference's records where those placements
differ, and nowhere else.  A recurrence's loop over positions runs each
of its ops once over every position on meta (``models/ssm.py``), and a
kernel wrapper runs its plain version on a meta tensor
(``--gemv-backend``), so those routes' bytes are their plain versions'.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape train_4k --mesh multi          # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --serve-trace \\
        --device cpu                           # the serving trace

No process is started and no card is touched (``--serve-trace`` excepted,
which runs the engine on ``--device``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.axes import activation_mesh
from repro_torch.distributed.collectives import counting
from repro_torch.launch.mesh import (
    data_axes,
    default_axes,
    describe_mesh,
    make_production_mesh,
    model_axis_size,
)
from repro_torch.launch.shapes import (
    SHAPES,
    ShapeCase,
    applicable,
    input_specs,
    modality_specs,
)
from repro_torch.models import lm

ARTIFACT_DIR = (Path(__file__).resolve().parents[3] / "artifacts"
                / "dryrun_torch")

NO_COUNTERPART = {
    "lower_s": "no XLA lowering: trace_s is the counted run's wall time",
    "compile_s": "no XLA compile",
    "hlo_lines": "no HLO: collectives are counted where the port issues "
                 "them",
}
MEMORY_NOTE = ("argument_size / output_size: the bytes of the rank's "
               "input blocks and of the step's outputs; temp_size and "
               "generated_code_size are XLA's compiled buffers, which "
               "have no counterpart here (null)")


def _tensor_bytes(tree) -> int:
    """The bytes of every tensor in ``tree`` (dicts, lists, tuples)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


class ByteCount(TorchDispatchMode):
    """The operand and result bytes of each ATen op run under it, summed
    in ``bytes`` (a view's are not: it moves nothing).  Unfused: each op
    is counted as though it read its operands and wrote its results to
    memory."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self.bytes += (_tensor_bytes(args) + _tensor_bytes(kwargs)
                           + _tensor_bytes(out))
        return out


def _grouped_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs):
    """``torch._grouped_mm``: each output element one dot product over
    ``a``'s last dim (each row times its group's matrix)."""
    n = 1
    for s in out_shape:
        n *= s
    return 2 * n * a_shape[-1]


def dryrun_config(arch: str, *, reduced: bool = False, n_layers=None):
    """``arch``'s config (its reduced one with ``reduced``) in bf16 params
    and compute, as deployed (the reference's dry-run numerics)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    over = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
    if n_layers is not None:
        over["n_layers"] = n_layers
    return dataclasses.replace(cfg, **over)


def data_rows(mesh, batch: int) -> int:
    """A rank's rows of a global batch: ``batch`` over the data axes'
    product where it divides (the reference's ``batch_spec``), else the
    whole batch on every rank."""
    n = mesh.size(data_axes(mesh))
    return batch // n if n > 1 and batch % n == 0 else batch


def _train_cell(cfg, shape: ShapeCase, mesh):
    """(run, inputs): the train step over the rank's stored blocks of
    params and optimizer state and the global batch (the step takes its
    rows over the data axes itself)."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainConfig, build_train_step

    step, opt_init = build_train_step(
        cfg, TrainConfig(opt=OptConfig(name=cfg.optimizer)), mesh=mesh)
    params = lm.init_lm(cfg, device="meta", mesh=mesh, train=True)
    state = opt_init(params)
    batch = input_specs(cfg, shape)
    rows = {k: v[:data_rows(mesh, shape.global_batch)]
            for k, v in batch.items()}
    return (lambda: step(params, state, batch)), (params, state, rows)


def _serve_cell(cfg, shape: ShapeCase, mesh, gemv_backend, gemv_fused):
    """(run, inputs): ``lm.forward`` of the rank's rows over its cache,
    on its serving blocks, returning the last position's logits and the
    new cache; decode GEMVs through the dispatcher pinned to
    ``gemv_backend`` when one is given."""
    B = data_rows(mesh, shape.global_batch)
    params = {k: v for k, v in lm.init_lm(cfg, device="meta",
                                          mesh=mesh).items()
              if k != shd.SHARD_KEY}
    cache = lm.init_cache(cfg, B, shape.seq_len, device="meta", mesh=mesh)
    S = 1 if shape.kind == "decode" else shape.seq_len
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
    extra = modality_specs(cfg, B)
    policy = None
    if gemv_backend is not None and shape.kind == "decode":
        from repro_torch.kernels.dispatch import DispatchPolicy

        policy = DispatchPolicy(backend=gemv_backend,
                                fuse_programs=gemv_fused,
                                model_shards=model_axis_size(mesh))

    def run():
        with torch.no_grad(), activation_mesh(mesh):
            logits, new_cache, _ = lm.forward(
                params, cfg, tokens, cache=cache, frames=extra.get("frames"),
                vision=extra.get("vision"), gemv_policy=policy)
        return logits[:, -1], new_cache

    return run, (params, tokens, cache, extra)


def cell_metrics(cfg, shape: ShapeCase, mesh, gemv_backend=None,
                 gemv_fused: bool = True) -> dict:
    """Run one cell on ``mesh`` (a description) under the counting mode,
    the flop counter and :class:`ByteCount`: its flops, bytes, collective
    bytes (by kind), argument and output bytes and the counted run's
    seconds."""
    with counting(mesh) as (counted, count):
        if shape.kind == "train":
            run, inputs = _train_cell(cfg, shape, counted)
        else:
            run, inputs = _serve_cell(cfg, shape, counted, gemv_backend,
                                      gemv_fused)
        flops = FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten._grouped_mm: _grouped_mm_flops})
        nbytes = ByteCount()
        t0 = time.perf_counter()
        with flops, nbytes:
            out = run()
        trace_s = time.perf_counter() - t0
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(nbytes.bytes), "coll": float(count.total),
            "coll_by_kind": dict(count.bytes),
            "coll_calls": dict(count.calls),
            "argument_size": _tensor_bytes(inputs),
            "output_size": _tensor_bytes(out), "trace_s": trace_s}


def roofline_corrected(cfg, shape: ShapeCase, mesh,
                       gemv_backend=None, gemv_fused: bool = True) -> dict:
    """The reference's L1 / L2 extrapolation: the cell at L1 and L2
    layers (L1 one attention-pattern period: a vlm's group, else the
    local/global period capped at 6), ``m(L) = base + L * delta`` to the
    full depth; exact for what is linear in depth (a layer's forward,
    backward, update and collectives), the embedding, head and encoder
    in the base term."""
    if cfg.cross_attn_every > 0:
        period = cfg.cross_attn_every
    else:
        period = min(max(cfg.global_every, 1), 6)
    L2 = min(2 * period, cfg.n_layers)
    L1 = max(period if L2 > period else L2 // 2, 1)
    m1 = cell_metrics(dataclasses.replace(cfg, n_layers=L1), shape, mesh,
                      gemv_backend, gemv_fused)
    m2 = cell_metrics(dataclasses.replace(cfg, n_layers=L2), shape, mesh,
                      gemv_backend, gemv_fused)
    out = {"L1": L1, "L2": L2}
    for k in ("flops", "bytes", "coll"):
        delta = (m2[k] - m1[k]) / max(L2 - L1, 1)
        base = m1[k] - L1 * delta
        out[k] = base + cfg.n_layers * delta
        out[f"{k}_per_layer"] = delta
        out[f"{k}_base"] = base
    out["coll_by_kind"] = {}
    for kind in set(m1["coll_by_kind"]) | set(m2["coll_by_kind"]):
        a = m1["coll_by_kind"].get(kind, 0)
        b = m2["coll_by_kind"].get(kind, 0)
        d = (b - a) / max(L2 - L1, 1)
        out["coll_by_kind"][kind] = (a - L1 * d) + cfg.n_layers * d
    return out


def cell_mesh(mesh_kind: str, mesh_shape=None):
    """Rank 0's description of the cell's mesh: the production mesh of
    ``mesh_kind``, or ``mesh_shape`` over its default axes."""
    if mesh_shape is not None:
        shape = tuple(int(n) for n in mesh_shape)
        return describe_mesh(shape, default_axes(shape))
    return make_production_mesh(multi_pod=mesh_kind == "multi",
                                description=True)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             roofline: bool = True, gemv_backend: str | None = None,
             gemv_fused: bool = True, *, reduced: bool = False,
             mesh_shape=None, n_layers=None) -> dict:
    """Trace one (arch, shape, mesh) cell on meta; returns the record.
    ``reduced`` takes the arch's reduced config (the CPU tests' widths),
    ``mesh_shape`` a mesh other than the production one (tagged
    ``mesh_kind`` all the same), ``n_layers`` another depth."""
    cfg = dryrun_config(arch, reduced=reduced, n_layers=n_layers)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "time": time.time(),
        # the backend decode GEMVs route through (pinned, else the card's)
        # and whether this cell engaged the dispatcher (decode cells only)
        "gemv_backend": gemv_backend or "h100",
        "gemv_dispatch": gemv_backend is not None and shape.kind == "decode",
        "gemv_fused": (gemv_fused and gemv_backend is not None
                       and shape.kind == "decode"),
    }
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    mesh = cell_mesh(mesh_kind, mesh_shape)
    m = cell_metrics(cfg, shape, mesh, gemv_backend, gemv_fused)
    rec.update(
        status="ok",
        n_chips=mesh.world_size,
        mesh_shape={k: int(v) for k, v in mesh.shape.items()},
        trace_s=m["trace_s"],
        flops=m["flops"],
        bytes_accessed=m["bytes"],
        memory={"argument_size": m["argument_size"],
                "output_size": m["output_size"], "temp_size": None,
                "generated_code_size": None, "note": MEMORY_NOTE},
        collective_bytes=m["coll_by_kind"],
        collective_calls=m["coll_calls"],
        collective_total=m["coll"],
        no_counterpart=NO_COUNTERPART,
        model_params=cfg.param_count(),
        model_params_active=cfg.active_param_count(),
    )
    if roofline and mesh_kind == "single":
        try:
            rec["roofline"] = roofline_corrected(cfg, shape, mesh,
                                                 gemv_backend, gemv_fused)
        except Exception as e:      # noqa: BLE001 (recorded, as the reference)
            rec["roofline"] = {"error": repr(e)}
    return rec


def save_record(rec: dict, out_dir=None) -> str:
    out_dir = Path(out_dir or ARTIFACT_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return str(path)


def run_serve_traces(args) -> int:
    """``--serve-trace``: the serving subsystem's synthetic multi-tenant
    trace (``serving.bench.run_serve_trace``) on the reduced config of
    each requested arch, on ``--device`` (the port's entry points run on
    the card unless asked for another device), optionally on a ``(data,
    model)`` mesh (``--serve-mesh DxM``: one process a rank); each
    document goes to ``<out>/serving/<arch>__serve_trace[_DxM].json``."""
    from repro_torch.serving.bench import run_serve_trace

    if args.device is None:
        raise SystemExit("--serve-trace runs the engine: pass --device "
                         "(cuda or cpu)")
    serve_dir = Path(args.out or ARTIFACT_DIR) / "serving"
    serve_dir.mkdir(parents=True, exist_ok=True)
    policies = tuple(p for p in args.serve_policies.split(",") if p)
    mesh_shape, tag = None, "serve_trace"
    if args.serve_mesh:
        from repro_torch.launch.mesh import parse_mesh_arg

        mesh_shape = parse_mesh_arg(args.serve_mesh)
        tag = "serve_trace_{}x{}".format(*mesh_shape)
    archs = sorted(ARCHS) if args.all else [args.arch or "olmo-1b"]
    failures = 0
    for arch in archs:
        path = serve_dir / f"{arch}__{tag}.json"
        try:
            doc = run_serve_trace(
                arch, policies=policies, smoke=True,
                gemv_backend=args.gemv_backend, mesh_shape=mesh_shape,
                device=args.device, out=str(path))
        except Exception as e:      # noqa: BLE001 (the reference's CLI)
            failures += 1
            print(f"[FAIL] serve-trace {arch}: {e!r}")
            if not args.continue_on_error:
                raise
            continue
        for run in doc["runs"]:
            d = run["dispatch"]
            print(f"[ok]   serve-trace {arch} x {run['policy']}: "
                  f"{run['completed']} done, gemv {d['gemv_path']} / "
                  f"matmul {d['matmul_fallback']} -> {path.name}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--no-roofline", action="store_true",
                    help="skip the L1 / L2 depth extrapolation")
    ap.add_argument("--gemv-backend", default=None,
                    help="route decode-cell GEMVs through this registered "
                         "backend (cpu|h100|gpu; on meta every kernel "
                         "wrapper runs its plain version); default keeps "
                         "the plain products")
    ap.add_argument("--no-gemv-fused", action="store_true",
                    help="with --gemv-backend: per-matrix dispatch instead "
                         "of fused / grouped GEMV programs")
    ap.add_argument("--serve-trace", action="store_true",
                    help="run the synthetic multi-tenant serving trace "
                         "(repro_torch.serving.bench) on the reduced config "
                         "instead of the dry run, on --device")
    ap.add_argument("--serve-policies", default="fcfs,sjf,gemv_aware",
                    help="comma-separated scheduler policies for "
                         "--serve-trace")
    ap.add_argument("--serve-mesh", default=None, metavar="DxM",
                    help="with --serve-trace: the sharded engine on a "
                         "(data, model) mesh, one process a rank")
    ap.add_argument("--device", default=None,
                    help="with --serve-trace: where the engine runs (cuda "
                         "or cpu); the dry run itself runs on meta")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's reduced config (the CPU tests' "
                         "widths) instead of its full one")
    ap.add_argument("--out", default=None,
                    help=f"the records' directory (default {ARTIFACT_DIR})")
    args = ap.parse_args(argv)

    if args.serve_trace:
        return run_serve_traces(args)

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch} x {shape} x {mesh_kind}"
                try:
                    rec = run_cell(arch, shape, mesh_kind,
                                   roofline=not args.no_roofline,
                                   gemv_backend=args.gemv_backend,
                                   gemv_fused=not args.no_gemv_fused,
                                   reduced=args.reduced)
                except Exception as e:  # noqa: BLE001 (recorded per cell)
                    failures += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[FAIL] {tag}: {e}")
                    if not args.continue_on_error:
                        save_record(rec, args.out)
                        raise
                path = save_record(rec, args.out)
                if rec["status"] == "ok":
                    mb = rec["memory"]["argument_size"] / 2**20
                    print(f"[ok]   {tag}: trace {rec['trace_s']:.1f}s "
                          f"flops {rec['flops']:.3g} "
                          f"bytes {rec['bytes_accessed']:.3g} "
                          f"coll {rec['collective_total'] / 2**20:.1f}MiB "
                          f"args {mb:.0f}MiB -> {os.path.basename(path)}")
                elif rec["status"] == "skipped":
                    print(f"[skip] {tag}: {rec['reason']}")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
