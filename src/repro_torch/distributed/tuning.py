"""The dispatcher's autotune table on a mesh: one table, rank 0's.

Every rank must select the same kernel for the same shape (measured picks
and fitted constants are made once, not per rank), and the dispatcher
issues no collective of its own: a plan-cache miss on one rank alone
(the rank-0 tracer's timed decisions, a cache cleared on one rank) must
never wait for a peer.  So the table moves at one agreed point:
``Engine(mesh=)`` calls :func:`share_autotune_table` once, at
construction, on every rank; from then on each rank replays the same
entries.  Only rank 0 writes a table file (:func:`save_autotune_table`).
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.kernels import dispatch


def share_autotune_table(mesh) -> None:
    """Broadcast rank 0's table (its measured picks, replayed entries and
    fitted constants) over the whole mesh; every other rank adopts it in
    place of its own (``dispatch.adopt_autotune_table``).  Every rank of
    ``mesh`` must call it."""
    if mesh.world_size <= 1:
        return
    box = [dispatch.autotune_table_document() if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    if mesh.rank != 0:
        dispatch.adopt_autotune_table(box[0])


def save_autotune_table(path: str, mesh) -> bool:
    """``dispatch.save_autotune_table(path)`` on rank 0 only (the table is
    rank 0's on every rank); returns whether this rank wrote."""
    if mesh.rank != 0:
        return False
    dispatch.save_autotune_table(path)
    return True
