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


class _Take(torch.autograd.Function):
    """Rows of a table at flat ids, ``index_select``'s bits, with a backward
    that sums each row's cotangents in a fixed order: ``index_put_`` with
    ``accumulate`` sorts the ids (stably) and adds each id's rows in turn.
    ``index_select``'s own backward (``index_add_``) adds them with atomics
    on the card, in an order that changes from run to run, so two runs of
    one train step would differ in the table's gradient."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        out = grad.new_zeros((ctx.rows, grad.shape[1]))
        return out.index_put_((ids,), grad.contiguous(), accumulate=True), None


class _LocalLookup(torch.autograd.Function):
    """This rank's partial rows: ``embed_lookup`` of the flat ids over its
    vocab slice starting at ``lo`` (zero rows for the ids outside it), with
    a backward that sums each in-slice id's cotangent rows into the slice in
    a fixed order, as :class:`_Take` does; the other ids' rows go to a spare
    row that is cut off."""

    @staticmethod
    def forward(ctx, table, flat, lo):
        ctx.save_for_backward(flat, lo)
        ctx.rows = table.shape[0]
        return embed_lookup(table, flat, lo)

    @staticmethod
    def backward(ctx, grad):
        flat, lo = ctx.saved_tensors
        v = ctx.rows
        loc = flat.long() - lo.long()
        loc = torch.where((loc >= 0) & (loc < v), loc, v)
        out = grad.new_zeros((v + 1, grad.shape[1]))
        return out.index_put_((loc,), grad.contiguous(), accumulate=True)[:v], None, None


def embed_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` (any shape): ``(*ids.shape, D)``; the
    table's gradient is summed in a fixed order (:class:`_Take`)."""
    flat = ids.reshape(-1).long()
    if torch.is_grad_enabled() and table.requires_grad:
        rows = _Take.apply(table, flat)
    else:
        rows = table.index_select(0, flat)
    return rows.reshape(*ids.shape, table.shape[1])


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
    collective over it.  The lookup is :class:`_LocalLookup` and the psum
    :func:`~repro_torch.sharding.mesh.reduce_from_region`: each rank sums
    the rows' cotangents into its own slice."""
    from ..sharding.mesh import reduce_from_region

    lo = torch.tensor([mesh.axis_index(vocab_axis) * table.shape[0]], dtype=torch.int32,
                      device=table.device)
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    part = _LocalLookup.apply(table, flat, lo).reshape(*ids.shape, table.shape[1])
    return reduce_from_region(part, mesh, vocab_axis)


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


def lm_head(h: torch.Tensor, w: torch.Tensor, mesh: Mesh | None = None,
            vocab_axis: str = "model") -> torch.Tensor:
    """h: (B, S, D) @ w: (D, Vp) -> logits (B, S, Vp).  With a ``mesh``,
    ``w`` is this rank's vocab columns and the logits its block
    ``(B, S, Vp / |vocab_axis|)`` (vocab parallel: ``h``, whole on every
    rank, enters through ``copy_to_region``, so its cotangent sums the
    ranks')."""
    if mesh is not None:
        from ..sharding.mesh import copy_to_region

        h = copy_to_region(h, mesh, vocab_axis)
    return h @ w
