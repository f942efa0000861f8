"""Activation anchors (counterpart of ``repro/distributed/axes.py``).

The reference drops ``constrain(x, names)`` anchors at layer boundaries:
with a mesh active they become ``with_sharding_constraint`` hints that
steer GSPMD's partitioner.  The port has no partitioner to hint: each
rank holds its block and the layers issue each collective themselves
(``repro_torch.distributed.collectives``), at the places where the
reference pins a replicated layout.  So :func:`constrain` and
:func:`constrain_first` return their input; :func:`_resolve` and
:func:`first_candidate` make the reference's choices, for a reader and
for the tests that hold them against it.

:func:`activation_mesh` installs the mesh for the forward it wraps
(``Engine(mesh=)`` wraps every step in it); :func:`current_mesh` is how
the layers find their collectives' groups.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any

import numpy as np

_MESH = contextvars.ContextVar("repro_torch_activation_mesh", default=None)


@contextlib.contextmanager
def activation_mesh(mesh):
    tok = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(tok)


def current_mesh():
    return _MESH.get()


def _resolve(dim_size: int, name: str | None, mesh) -> Any:
    """The mesh axis (or axes) an activation dim named ``name`` lands on:
    "batch" -> the data axes when their product divides (else 'data'
    alone, else none); a mesh axis name -> itself when it divides and is
    larger than 1; anything else -> None."""
    if name is None:
        return None
    if name == "batch":
        axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        if not axes:
            return None
        n = int(np.prod([mesh.shape[a] for a in axes]))
        if n > 1 and dim_size % n == 0:
            return axes if len(axes) > 1 else axes[0]
        if "data" in mesh.axis_names and dim_size % mesh.shape["data"] == 0:
            return "data"
        return None
    if name in mesh.axis_names:
        if dim_size % mesh.shape[name] == 0 and mesh.shape[name] > 1:
            return name
        return None
    return None


def first_candidate(shape, candidates, mesh):
    """The candidate ``constrain_first`` applies: the first whose 'model'
    requests all resolve, else the last."""
    for names in candidates:
        if len(names) != len(shape):
            continue
        wants = [i for i, n in enumerate(names) if n == "model"]
        if wants and all(_resolve(shape[i], "model", mesh) == "model"
                         for i in wants):
            return names
    return candidates[-1]


def constrain(x, names):
    """The reference's anchor: nothing to hint here, ``x`` unchanged."""
    return x


def constrain_first(x, candidates):
    """The reference's first-fitting anchor: ``x`` unchanged."""
    return x
