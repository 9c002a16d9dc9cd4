"""Grouped-query attention projections and the KV cache.

The counterpart of ``repro.models.attention`` for the serving path.  The
attention itself is one call of the hand-written ``flash_attention`` kernel
(``repro_torch.kernels.flash_attention``): it computes what ``attend`` and
``attend_chunked`` compute on this path (causal masking over the cache's
valid prefix) and tiles queries itself, so the JAX package's q-chunking
(``attn_chunk``, ``auto_chunk``) has no counterpart.  Sequence-parallel
``attend_sp`` comes with the compiled-rendering slice.
"""

from __future__ import annotations

import torch


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
