"""The paper's X-RDMA pointer chase and Gather as collective programs over a
:class:`~repro_torch.sharding.mesh.Mesh` (the counterpart of
``repro.sharding.compute_to_data``).

``core/pointer_chase.py`` realizes DAPC with code frames that really travel
between PEs.  This module renders the *steady state* of the same algorithm
(all code cached everywhere): the table is sharded over a mesh axis, B
chases advance as a lock-step frontier, and each round every shard resolves
the frontier entries it owns; the ownership exchange is an all-reduce of
index-sized messages, the Chaser's FORWARD as a collective.

Each function runs on every rank of the mesh at once, takes the calling
rank's shard (:func:`~repro_torch.sharding.mesh.shard_rows`) and returns
the replicated result.

* :func:`dapc_shard_map`: compute-to-data.  Each round resolves one hop of
  every chase on its owner with the ``chase_shard`` kernel (depth 1 for
  every chase: one launch a round) and psums the new frontier: 4 B a hop a
  chase on the wire, whatever the table's size.
* :func:`gather_shard_map`: the Gather's serving shape.  Each shard
  resolves the keys it owns with the ``embed_lookup`` kernel (one launch a
  call) and the partial rows psum.
* :func:`gbpc_reference`: move-data-to-compute.  The table is all-gathered
  and the chase runs against it with plain ``index_select`` hops (the JAX
  package's ``jnp.take``, outside any kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.chase import chase_shard
from ..kernels.embed_lookup import embed_lookup
from .mesh import Axes, Mesh


def _lo(mesh: Mesh, axis: Axes, local: int) -> torch.Tensor:
    """The first global row of this rank's shard, as the kernels take it."""
    return torch.tensor([mesh.axis_index(axis) * local], dtype=torch.int32, device=mesh.device)


def dapc_shard_map(
    table: torch.Tensor,  # (N / |axis|,) int32: this rank's shard of the successor table
    starts: torch.Tensor,  # (B,) int32, the same on every rank
    depth: int,
    mesh: Mesh,
    axis: Axes = "model",
) -> torch.Tensor:
    """Lock-step frontier pointer chase, compute-to-data: ``depth`` rounds,
    each one hop of every chase on its owner and a psum of B int32.

    A chase that lies in this shard comes back from the depth-1 kernel call
    with depth 0 and its successor; every other chase comes back untouched
    with depth 1 and contributes 0, so the all-reduce forms the next
    frontier (the JAX package's masked take)."""
    lo = _lo(mesh, axis, table.shape[0])
    one = torch.ones_like(starts)
    frontier = starts
    for _ in range(depth):
        nxt, left = chase_shard(table, frontier, one, lo)
        # FORWARD: ship the index to whichever shard owns it next
        frontier = mesh.psum(nxt.masked_fill_(left != 0, 0), axis)
    return frontier


def gather_shard_map(
    table: torch.Tensor,  # (V / |axis|, D): this rank's rows
    keys: torch.Tensor,  # (B,) int32 global row ids, the same on every rank
    mesh: Mesh,
    axis: Axes = "model",
) -> torch.Tensor:
    """Steady-state X-RDMA Gather as a collective program: each shard
    resolves the keys it owns and contributes zero rows for the rest; the
    psum is the Gatherer's partial RETURNs meeting in the requester's
    completion slot.  One D-row a key on the wire; the table never moves."""
    part = embed_lookup(table, keys, _lo(mesh, axis, table.shape[0]))
    return mesh.psum(part, axis)


def gbpc_reference(
    table: torch.Tensor,
    starts: torch.Tensor,
    depth: int,
    mesh: Mesh | None = None,
    axis: Axes = "model",
) -> torch.Tensor:
    """GET-style baseline: chase against the gathered table.  With a
    ``mesh``, ``table`` is this rank's shard over ``axis`` and is
    all-gathered first (the client pulling entries to itself); without
    one it is the whole table."""
    if mesh is not None:
        table = mesh.all_gather(table, axis)
    frontier = starts
    for _ in range(depth):
        frontier = table.index_select(0, frontier)
    return frontier


def gather_ref(table, keys) -> np.ndarray:
    """Pure numpy oracle: a plain row take."""
    return np.asarray(table)[np.asarray(keys)]


def chase_oracle(table, starts, depth: int) -> np.ndarray:
    """Pure numpy oracle."""
    f = np.asarray(starts).copy()
    t = np.asarray(table)
    for _ in range(depth):
        f = t[f]
    return f
