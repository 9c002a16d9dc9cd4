"""Token embedding and LM head: compute-to-data (c2d) vs. gather baselines
(the counterpart of ``repro.models.embedding``).

The paper's DAPC-vs-GBPC dichotomy at tensor scale.  With a
:class:`~repro_torch.sharding.mesh.Mesh`, the vocabulary table is sharded
over its ``"model"`` axis, and each rank passes its own shard.  To look up
a token you either:

* **c2d** (ship the indices, X-RDMA style): every rank looks up the ids of
  its batch shard that fall in its vocab slice with the ``embed_lookup``
  kernel (zero rows elsewhere), and the partial rows psum over the vocab
  axis.  Wire cost per token: one D-row, whatever the vocab size.
* **gather** (ship the data, GET/GBPC style): all-gather the vocab shards,
  then take locally.  Wire cost: the whole table.
* **auto** and **plain**: a plain take on the table given.  JAX's ``auto``
  leaves the collective to the GSPMD partitioner; the port has none, so
  ``auto`` is the plain take.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from ..kernels.embed_lookup import embed_lookup

if TYPE_CHECKING:
    from ..sharding.mesh import Mesh


def embed_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` (any shape): ``(*ids.shape, D)``."""
    return table.index_select(0, ids.reshape(-1).long()).reshape(*ids.shape, table.shape[1])


def embed_auto(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """JAX's partitioner-decided take; with no partitioner, the plain take."""
    return embed_plain(table, ids)


def embed_gather(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh | None,
                 vocab_axis: str = "model") -> torch.Tensor:
    """GET-style baseline: replicate the table, then take.  With a ``mesh``,
    ``table`` is this rank's vocab shard and is all-gathered first."""
    if mesh is not None:
        table = mesh.all_gather(table, vocab_axis)
    return embed_plain(table, ids)


def embed_c2d(
    table: torch.Tensor,  # (Vp / |vocab_axis|, D): this rank's vocab shard
    ids: torch.Tensor,  # (B_loc, S): this rank's batch shard
    mesh: Mesh,
    vocab_axis: str = "model",
) -> torch.Tensor:
    """Ship-the-indices lookup over a vocab-sharded table: one
    ``embed_lookup`` launch on the flattened ids, then a psum over the
    vocab axis.  Returns this rank's batch shard ``(B_loc, S, D)``; however
    the caller split the batch (JAX's ``batch_axes``), the lookup needs no
    collective over it."""
    lo = torch.tensor([mesh.axis_index(vocab_axis) * table.shape[0]], dtype=torch.int32,
                      device=table.device)
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    part = embed_lookup(table, flat, lo).reshape(*ids.shape, table.shape[1])
    return mesh.psum(part, vocab_axis)


def embed_tokens(
    table: torch.Tensor,
    ids: torch.Tensor,
    mode: str = "plain",
    mesh: Mesh | None = None,
    vocab_axis: str = "model",
) -> torch.Tensor:
    if mode == "c2d" and mesh is not None:
        return embed_c2d(table, ids, mesh, vocab_axis)
    if mode == "gather":
        return embed_gather(table, ids, mesh, vocab_axis)
    if mode == "auto":
        return embed_auto(table, ids)
    return embed_plain(table, ids)


def lm_head(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h: (B, S, D) @ w: (D, Vp) -> logits (B, S, Vp)."""
    return h @ w
