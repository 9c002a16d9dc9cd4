"""Token embedding and LM head (the single-device path of
``repro.models.embedding``; its ``c2d``, ``gather`` and ``auto`` modes
need a mesh and come with the compiled-rendering slice)."""

from __future__ import annotations

import torch


def embed_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` (any shape): ``(*ids.shape, D)``."""
    return table.index_select(0, ids.reshape(-1).long()).reshape(*ids.shape, table.shape[1])


def lm_head(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h: (B, S, D) @ w: (D, Vp) -> logits (B, S, Vp)."""
    return h @ w
