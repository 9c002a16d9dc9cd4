"""Plain PyTorch version of the batched shard-local pointer chase."""

from __future__ import annotations

import torch


def chase_shard_ref(
    table: torch.Tensor,  # (N_loc,) int32 successors (global ids)
    frontier: torch.Tensor,  # (B,) int32 global addresses
    depth: torch.Tensor,  # (B,) int32 hops remaining per chase
    lo: "int | torch.Tensor",  # first global id owned by this shard
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run every chase to exit: advance it while ``lo <= f < lo + N_loc``
    and ``d > 0``; returns ``(frontier', depth')`` as new tensors.

    The lock-step loop of ``repro.kernels.chase.ref.chase_ref`` with
    ``max_hops >= max(depth)``: it stops when no chase is active, not after
    a fixed hop budget, so no chase is ever left unfinished."""
    n_loc = table.shape[0]
    f, d = frontier.clone(), depth.clone()
    if n_loc == 0:
        return f, d
    lo = lo.reshape(()).to(torch.int64) if isinstance(lo, torch.Tensor) else int(lo)
    while True:
        loc = f.to(torch.int64) - lo  # 64-bit: ids far below lo must not wrap
        active = (loc >= 0) & (loc < n_loc) & (d > 0)
        if not bool(active.any()):
            return f, d
        nxt = table.index_select(0, loc.clamp(0, n_loc - 1))
        f = torch.where(active, nxt, f)
        d = torch.where(active, d - 1, d)
