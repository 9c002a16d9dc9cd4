"""Grouped-query attention projections and the KV cache.

The counterpart of ``repro.models.attention`` for the serving path.  The
attention itself is one call of the hand-written ``flash_attention`` kernel
(``repro_torch.kernels.flash_attention``): it computes what ``attend`` and
``attend_chunked`` compute on this path (causal masking over the cache's
valid prefix) and tiles queries itself, so the JAX package's q-chunking
(``attn_chunk``, ``auto_chunk``) has no counterpart.  Sequence-parallel
:func:`attend_sp` runs the same kernel on each rank of a mesh.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from ..kernels.flash_attention import flash_attention

if TYPE_CHECKING:
    from ..sharding.mesh import Axes, Mesh


def qkv_proj(
    x: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    bq: torch.Tensor | None = None,
    bk: torch.Tensor | None = None,
    bv: torch.Tensor | None = None,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    q = x @ wq
    k = x @ wk
    v = x @ wv
    if bq is not None:
        q, k, v = q + bq, k + bk, v + bv
    return (
        q.reshape(b, s, n_heads, head_dim),
        k.reshape(b, s, n_kv, head_dim),
        v.reshape(b, s, n_kv, head_dim),
    )


def update_kv_cache(
    k_cache: torch.Tensor,  # (B, T, K, hd)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # (B, S, K, hd)
    v_new: torch.Tensor,
    offset: int,  # number of tokens already cached
    rows: torch.Tensor | None = None,  # batch rows to write (None: every row)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write the new K/V at positions ``[offset, offset + S)``, in place.

    The JAX version returns a new cache with every row written; its
    scheduler then restores the rows outside the decoding group.  Writing
    in place, the port writes only ``rows`` instead, so a ragged batch never
    overwrites a neighbour's history."""
    s = k_new.shape[1]
    if rows is None:
        k_cache[:, offset : offset + s] = k_new
        v_cache[:, offset : offset + s] = v_new
    else:
        k_cache[rows, offset : offset + s] = k_new[rows].to(k_cache.dtype)
        v_cache[rows, offset : offset + s] = v_new[rows].to(v_cache.dtype)
    return k_cache, v_cache


def _one_range(q_pos, k_pos, s: int) -> None:
    """Raise unless the query and key positions are one shared contiguous
    range of ``s`` positions (every call the JAX models make).  They are
    read on the host, so a layer's call never waits for the card."""
    if any(isinstance(p, torch.Tensor) and p.device.type != "cpu" for p in (q_pos, k_pos)):
        raise ValueError("attend_sp reads q_pos and k_pos on the host: pass them on the CPU")
    qp, kp = torch.as_tensor(q_pos).long(), torch.as_tensor(k_pos).long()
    if qp.dim() != 1 or qp.shape != kp.shape or qp.shape[0] != s:
        raise ValueError(f"attend_sp takes 1-D q_pos and k_pos of the {s} positions, got "
                         f"{tuple(qp.shape)} and {tuple(kp.shape)}")
    if not (torch.equal(qp, kp) and torch.equal(qp, torch.arange(s) + qp[0])):
        raise ValueError("attend_sp needs q_pos and k_pos to be one shared contiguous range")


def attend_sp(
    q: torch.Tensor,  # (B_loc, S / |axis|, H, hd): this rank's query positions
    k: torch.Tensor,  # (B_loc, S / |axis|, K, hd)
    v: torch.Tensor,
    *,
    q_pos,  # (S,) all positions, on the host
    k_pos,  # (S,) on the host
    mesh: Mesh,
    axis: Axes = "model",
    causal: bool = True,
    window: "torch.Tensor | int | None" = None,
    cap: float | None = None,
) -> torch.Tensor:
    """Sequence-parallel attention: each rank keeps its S/|axis| queries,
    all-gathers K and V along S over ``axis`` and runs the
    ``flash_attention`` kernel on them.  Returns this rank's
    ``(B_loc, S/|axis|, H, hd)``.

    The kernel masks causally with the ends of queries and keys aligned, so
    causal rank ``me`` passes the prefix of ``(me + 1) S/|axis|`` keys (a
    view): its queries are then exactly the last positions, for the causal
    mask and the window alike.  A non-causal call passes all keys (and, as
    the kernel, takes no window).  K and V are gathered by
    :func:`~repro_torch.sharding.mesh.gather_from_region`, whose backward
    reduce-scatters their cotangents (each rank's queries see part of the
    keys)."""
    from ..sharding.mesh import gather_from_region

    s_loc = q.shape[1]
    _one_range(q_pos, k_pos, s_loc * mesh.axis_size(axis))
    k_all = gather_from_region(k, mesh, axis, dim=1, partial=True)
    v_all = gather_from_region(v, mesh, axis, dim=1, partial=True)
    if causal:
        t = (mesh.axis_index(axis) + 1) * s_loc
        k_all, v_all = k_all[:, :t], v_all[:, :t]
    return flash_attention(q, k_all, v_all, causal=causal, softcap=cap,
                           window=0 if window is None else int(window))
