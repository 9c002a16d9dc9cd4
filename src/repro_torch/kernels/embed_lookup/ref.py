"""Plain PyTorch version of the vocab-sharded partial row lookup."""

from __future__ import annotations

import torch


def embed_lookup_ref(
    table_shard: torch.Tensor,  # (V_loc, D)
    ids: torch.Tensor,  # (N,) int32 global ids
    lo: "int | torch.Tensor",  # first vocab id owned by this shard
) -> torch.Tensor:
    """Partial lookup: rows for ids outside [lo, lo+V_loc) are zero (a masked
    take, the semantics of ``repro.kernels.embed_lookup.ref``)."""
    v_loc = table_shard.shape[0]
    loc = ids.to(torch.int64) - lo
    inside = (loc >= 0) & (loc < v_loc)
    out = table_shard.index_select(0, loc.clamp(0, max(v_loc - 1, 0)))
    return torch.where(inside[:, None], out, torch.zeros((), dtype=out.dtype))
