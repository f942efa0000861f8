"""The device mesh over ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

The reference's mesh is one controller's view of many chips: GSPMD
partitions each jitted step and inserts the collectives.  Here every rank
is a process of its own: :class:`Mesh` holds this rank's coordinates and
one process group per axis, each rank holds its own shard of every
tensor, and the model issues each collective itself.

Mesh axes, as in the reference:
  * ``pod``   -- across pods (data-parallel across pods);
  * ``data``  -- the batch axis (serving replicates its state over it);
  * ``model`` -- the tensor / expert axis (the PIM "bank" axis).

:func:`spawn` starts one process a rank on this host and runs a function
on each with its mesh: the tests, the serve bench and ``chip_smoke.py``
share it.  Under ``torchrun --nproc-per-node N``, :func:`make_mesh` reads
``RANK`` and ``WORLD_SIZE`` from the environment instead.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


@dataclass
class Mesh:
    """This rank's view of the mesh.

    ``shape`` maps each axis name to its size, in axis order (the
    reference's ``mesh.shape``); ``coords`` is this rank's index along
    each axis (rank-major: the last axis varies fastest); ``groups`` holds
    one process group per axis: the ranks that share every other
    coordinate (None on a one-process mesh, and on a description: a mesh
    made without process groups).  A mesh with a 'pod' axis holds one
    more, under the key ``("pod", "data")`` (:func:`data_axes`): the
    ranks that share the 'model' coordinate, over which training folds
    'pod' into data parallelism.

    ``size``, ``index`` and ``group`` take an axis name or a tuple of
    them (a spec entry over several axes): the size is the product, the
    index pod-major (``pod · D + data``, GSPMD's order for a tuple axis
    and the one ``sharding.shard_tensor`` cuts by)."""

    shape: dict[str, int]
    rank: int = 0
    coords: dict[str, int] = field(default_factory=dict)
    groups: dict[str, object] = field(default_factory=dict)
    device: torch.device | None = None
    backend: str | None = None
    _side: "Mesh | None" = field(default=None, init=False, repr=False,
                                 compare=False)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def world_size(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axes) -> int:
        if isinstance(axes, tuple):
            return math.prod(self.shape.get(a, 1) for a in axes)
        return self.shape.get(axes, 1)

    def index(self, axes) -> int:
        if not isinstance(axes, tuple):
            return self.coords.get(axes, 0)
        i = 0
        for a in axes:
            i = i * self.shape.get(a, 1) + self.coords.get(a, 0)
        return i

    def group(self, axes):
        return self.groups.get(axes)

    def side_mesh(self) -> "Mesh":
        """This mesh with a second process group of its own on the
        'model' axis, over the same ranks: collectives issued on a side
        stream (``Engine(async_prefill=True)``'s chains) never share a
        communicator with the main stream's, which under NCCL could order
        the two streams' collectives differently on different ranks.
        Made once (collectively, on the first call: every rank must make
        it in the same order) and kept; a mesh without process groups is
        its own side mesh."""
        if self._side is None:
            if self.groups.get("model") is None:
                self._side = self
            else:
                shape = tuple(self.shape.values())
                self._side = dataclasses.replace(
                    self, groups={**self.groups, "model": _axis_group(
                        self.rank, shape, self.axis_names, "model")})
        return self._side


def _coords(rank: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _rank_of(coords: tuple[int, ...], shape: tuple[int, ...]) -> int:
    r = 0
    for c, n in zip(coords, shape):
        r = r * n + c
    return r


def _under_torchrun() -> bool:
    return (not dist.is_initialized() and "RANK" in os.environ
            and "WORLD_SIZE" in os.environ)


def rank_device(rank: int, device=None) -> torch.device:
    """The device rank ``rank`` runs on: ``device`` when given, else
    ``cuda:{rank % device_count}``; with no device on a host without
    CUDA this raises (the port's rule: the CPU only when asked for)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU explicitly")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _init_from_env(device: torch.device) -> None:
    """Join the group ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``) on this rank's ``device``."""
    world = int(os.environ["WORLD_SIZE"])
    backend = choose_backend(world, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    print(f"[mesh] torchrun rank {os.environ['RANK']}/{world}: backend "
          f"{backend}, device {device}", flush=True)
    dist.init_process_group(backend, init_method="env://")


def _axis_group(rank: int, shape: tuple[int, ...], axes: tuple[str, ...],
                axis):
    """``rank``'s process group along ``axis`` (a name, or a tuple of
    names: their product): the ranks that share its every other
    coordinate, in rank order (over a tuple, the first axis major).
    Collective: every rank creates every group of the axis, in the same
    order, and keeps its own."""
    along = {axes.index(a) for a in (axis if isinstance(axis, tuple)
                                     else (axis,))}
    mine = None
    others = [range(m) if j not in along else (None,)
              for j, m in enumerate(shape)]
    for rest in itertools.product(*others):
        ranks = [_rank_of(tuple(c if c is not None else x for c, x in
                                zip(rest, sub)), shape)
                 for sub in itertools.product(*[
                     range(m) if j in along else (None,)
                     for j, m in enumerate(shape)])]
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device=None) -> Mesh:
    """The mesh ``shape`` over ``axes`` for this process, e.g. ``((1, 2),
    ("data", "model"))``.  Raises unless the world (the initialised
    process group, else ``torchrun``'s environment, else this one
    process) is exactly ``prod(shape)`` ranks.  The rank runs on
    :func:`rank_device` (a card unless ``device="cpu"``; raises without
    one), and under ``torchrun`` joins the group with the backend that
    device gives (:func:`choose_backend`).  Every rank must call it, in
    the same order: each axis group is created collectively (the data
    axes' product of a mesh with a 'pod' axis last)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh {shape} does not match axes {axes}")
    torchrun = _under_torchrun()
    rank = (dist.get_rank() if dist.is_initialized()
            else int(os.environ["RANK"]) if torchrun else 0)
    dev = rank_device(rank, device)
    if torchrun:
        _init_from_env(dev)
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"mesh {shape} needs {n} processes, have {world}")
    mine = _coords(rank, shape)
    groups = {axis: None if world == 1 else
              _axis_group(rank, shape, axes, axis) for axis in axes}
    daxes = tuple(a for a in ("pod", "data") if a in axes)
    if len(daxes) > 1:
        groups[daxes] = (None if world == 1 else
                         _axis_group(rank, shape, axes, daxes))
    return Mesh(shape=dict(zip(axes, shape)), rank=rank,
                coords=dict(zip(axes, mine)), groups=groups, device=dev,
                backend=dist.get_backend() if dist.is_initialized()
                else None)


def describe_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
                  rank: int = 0) -> Mesh:
    """The mesh ``shape`` over ``axes`` as a description: rank ``rank``'s
    coordinates and no process groups (every group None; nothing is
    started or joined).  Placement reads it as it reads a real mesh;
    ``collectives.counting`` gives it groups that count instead of
    communicating (the dry run's)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh {shape} does not match axes {axes}")
    return Mesh(shape=dict(zip(axes, shape)), rank=rank,
                coords=dict(zip(axes, _coords(rank, shape))))


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         description: bool = False) -> Mesh:
    """The reference's production shapes: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``;
    raises unless the world is that many ranks.  With ``description``
    rank 0's view of it without processes (:func:`describe_mesh`)."""
    shape, axes = ((MULTI_POD_SHAPE, MULTI_POD_AXES) if multi_pod
                   else (PRODUCTION_SHAPE, PRODUCTION_AXES))
    if description:
        return describe_mesh(shape, axes)
    return make_mesh(shape, axes, device=device)


def single_device_mesh(device=None) -> Mesh:
    """A ``(1, 1)`` mesh over ``("data", "model")`` for this process."""
    return make_mesh((1, 1), ("data", "model"), device=device)


def parse_mesh_arg(arg: str) -> tuple[int, int]:
    """Parse a ``DxM`` CLI mesh spec (data x model), e.g. ``"1x4"``, with
    the reference's usage message on a malformed spec."""
    try:
        d, m = arg.lower().split("x")
        return int(d), int(m)
    except ValueError:
        raise SystemExit(
            f"mesh spec wants DxM (e.g. 1x4, data x model), got {arg!r}"
        ) from None


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that carry the global batch ('pod' folds into data-parallel)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis_size(mesh) -> int:
    return mesh.shape["model"] if "model" in mesh.axis_names else 1


# --------------------------------------------------------------------------
# The launcher
# --------------------------------------------------------------------------


def default_axes(shape: tuple[int, ...]) -> tuple[str, ...]:
    """``("model",)``, ``("data", "model")`` or ``("pod", "data",
    "model")`` by the shape's rank."""
    return MULTI_POD_AXES[3 - len(shape):]


def choose_backend(world: int, device: torch.device | None) -> str:
    """NCCL when every rank has a card of its own, else gloo (two ranks of
    one NCCL communicator cannot share a device)."""
    if (device is not None and device.type == "cuda"
            and world <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def _child(rank: int, shape, axes, backend: str, devices: list[str],
           store: str, tmp: str, timeout_s: float, fn, args,
           kwargs) -> None:
    """One rank: join the group over the file store, build the mesh, run
    ``fn(mesh, *args, **kwargs)`` and leave its result (or its
    traceback) in ``tmp``."""
    try:
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # ranks share the host's cores: one intra-op thread each
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=store, rank=rank,
            world_size=len(devices),
            timeout=datetime.timedelta(seconds=timeout_s))
        mesh = make_mesh(shape, axes, device=dev)
        out = fn(mesh, *args, **kwargs)
        path = os.path.join(tmp, f"result{rank}.pt")
        torch.save(out, path + ".part")
        os.replace(path + ".part", path)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.stderr.write(f"[spawn] rank {rank} failed:\n"
                         f"{traceback.format_exc()}")
        sys.stderr.flush()
        os._exit(1)


def spawn(fn, mesh_shape, *, device=None, timeout_s: float = 120.0,
          args: tuple = (), kwargs: dict | None = None) -> list:
    """Run ``fn(mesh, *args, **kwargs)`` on ``prod(mesh_shape)`` fresh
    processes, one a rank, and return their results in rank order.

    ``fn`` must be importable by name (it is pickled), and so must what it
    returns.  The mesh's axes are :func:`default_axes` of its shape.  The
    group meets over a ``file://`` store in a temporary directory (no TCP
    port: callers run side by side).  Rank ``r`` runs on ``cuda:{r %
    device_count}``, or on the CPU with ``device="cpu"`` (one intra-op
    thread a rank); with no device given on a host without CUDA this
    raises.  The backend is NCCL when every rank has a
    card of its own, else gloo, and is printed.  A rank that fails makes
    the call raise with its traceback; when ``timeout_s`` passes first
    (a deadlocked collective), every rank is killed and the call raises
    ``TimeoutError``."""
    shape = tuple(int(n) for n in mesh_shape)
    axes = default_axes(shape)
    n = math.prod(shape)
    if device is not None and torch.device(device).type == "cpu":
        devices = ["cpu"] * n
    else:
        devices = [str(rank_device(r)) for r in range(n)]
    backend = choose_backend(n, torch.device(devices[0]))
    print(f"[spawn] mesh {dict(zip(axes, shape))}: {n} ranks, backend "
          f"{backend}, devices {devices}"
          + ("" if backend == "nccl" or devices[0] == "cpu" else
             " (ranks share a card: NCCL takes one rank a device)"),
          flush=True)
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(
        r, shape, axes, backend, devices, f"file://{tmp}/store", tmp,
        timeout_s, fn, args, kwargs or {}), daemon=True)
        for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0]} failed:\n"
                                   + _read_error(tmp, failed[0]))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"mesh {shape}: ranks "
                    f"{[r for r, c in enumerate(codes) if c is None]} "
                    f"still running after {timeout_s} s (a collective one "
                    f"rank never reached?); every rank killed")
            time.sleep(0.02)
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def _read_error(tmp: str, rank: int) -> str:
    path = os.path.join(tmp, f"error{rank}.txt")
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    return "(no traceback: the process died)"
