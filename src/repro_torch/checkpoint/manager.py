"""Asynchronous, atomic checkpoints (counterpart of
``repro/checkpoint/manager.py``, the same layout).

``<dir>/step_<N>/`` holds one ``.npy`` per leaf of the saved tree
(flattened as :mod:`repro_torch.tree` does: dict keys sorted, list items
in order) and a ``manifest.json`` with each leaf's path, file, shape and
dtype and the caller's metadata.  A bf16 leaf is saved as its uint16 bits
with dtype ``"bfloat16"`` and viewed back on restore.  Writes go to
``step_<N>.tmp`` and are renamed only when complete, so a preempted
writer never leaves a torn checkpoint; the newest ``keep`` are kept.
:meth:`CheckpointManager.save` copies the tree to the host at once (a
consistent snapshot) and writes it inline or on a background thread.

On a mesh only rank 0 of ``group`` (the world, when ranks hold
different blocks) writes; :meth:`CheckpointManager.wait` ends with a
barrier on ``group``, so a rank that waits before it reads sees every
checkpoint rank 0 published.  A training rank holds its blocks of each
leaf (``sharding.train_spec``): ``save(shardings=, mesh=)`` gathers the
full leaves first, so the layout stays the reference's whatever mesh
wrote it, and ``restore(shardings=, mesh=)`` reads full leaves and cuts
this rank's blocks from them, so a checkpoint from one mesh restores
onto a mesh of another shape (elastic restore, the reference's
``restore(shardings=)``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import gather_tree, shard_tensor
from repro_torch.tree import flatten_with_paths, path_str, unflatten_like


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(array, dtype name) of a leaf; a bf16 tensor as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, *, group=None):
        self.dir = directory
        self.keep = keep
        self.group = group
        self.writes = group is None or dist.get_rank(group) == 0
        if self.writes:
            os.makedirs(directory, exist_ok=True)
        self._writer: threading.Thread | None = None
        self._last_error: Exception | None = None

    # ---------------- write ----------------

    def save(self, step: int, tree: Any, metadata: dict | None = None,
             blocking: bool = True, *, shardings: list | None = None,
             mesh=None) -> None:
        """Device -> host now (a consistent snapshot); the files inline
        (``blocking``) or on the writer thread.  With ``shardings`` (the
        spec of each leaf of ``tree`` in flattening order, on ``mesh``)
        ``tree`` holds this rank's blocks, and every rank gathers the
        full leaves first.  Ranks other than 0 of the group write
        nothing."""
        self.wait()
        if shardings is not None:
            tree = gather_tree(tree, mesh, shardings)
        if not self.writes:
            return
        host = [(path_str(p), *_to_host(leaf))
                for p, leaf in flatten_with_paths(tree)]
        if blocking:
            self._write(step, host, metadata or {})
        else:
            self._writer = threading.Thread(
                target=self._write_safe, args=(step, host, metadata or {}),
                daemon=True)
            self._writer.start()

    def _write_safe(self, step, host, metadata):
        try:
            self._write(step, host, metadata)
        except Exception as e:  # raised by the next wait()
            self._last_error = e

    def _write(self, step: int, host: list, metadata: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "metadata": metadata, "leaves": [],
                    "time": time.time()}
        for i, (path, arr, dtype) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({"path": path, "file": fname,
                                       "shape": list(arr.shape),
                                       "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # the atomic publish
        self._gc()

    def wait(self) -> None:
        """Join the writer thread, then (on a mesh) meet every rank of the
        group; raises the writer's error, if any."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self.group is not None:
            dist.barrier(group=self.group)
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---------------- read ----------------

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.dir):
            return []
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.dir, name,
                                                    "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None, *,
                shardings: list | None = None,
                mesh=None) -> tuple[Any, dict]:
        """The checkpoint at ``step`` (default the latest) in the structure
        of ``template``, each leaf with the template leaf's dtype and
        device; and the saved metadata.  With ``shardings`` (the spec of
        each leaf of ``template`` in flattening order, on ``mesh``) each
        full leaf is cut to this rank's block, which must have the
        template leaf's shape: any mesh's checkpoint restores onto any
        other."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        new = []
        flat = flatten_with_paths(template)
        specs = shardings if shardings is not None else [None] * len(flat)
        if len(specs) != len(flat):
            raise ValueError(f"{len(specs)} shardings for {len(flat)} "
                             f"leaves")
        for (p, tl), spec in zip(flat, specs):
            e = by_path.get(path_str(p))
            if e is None:
                raise KeyError(f"checkpoint missing leaf {path_str(p)}")
            arr = np.load(os.path.join(d, e["file"]))
            if e["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if spec is not None:
                t = shard_tensor(t, spec, mesh)
            if list(t.shape) != list(tl.shape):
                raise ValueError(f"shape mismatch for {path_str(p)}: ckpt "
                                 f"{arr.shape}"
                                 + (f" (this rank's block {tuple(t.shape)})"
                                    if spec is not None else "")
                                 + f" vs template {tuple(tl.shape)}")
            new.append(t.to(device=tl.device, dtype=tl.dtype))
        return unflatten_like(template, new), manifest["metadata"]
