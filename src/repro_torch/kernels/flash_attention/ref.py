"""Plain PyTorch version of blockwise attention (GQA, causal, softcap).

The torch counterpart of ``repro.kernels.flash_attention.ref.
flash_attention_ref``, in the model's layout: q ``(B, S, H, d)``, k and v
``(B, T, K, d)``, out ``(B, S, H, d)`` (the JAX oracle takes heads before
positions).  Any S and T: causal masking is end-aligned, so query i sees
key j iff ``j <= i + T - S``.
"""

from __future__ import annotations

import math

import torch

NEG = -(2.0**30)


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, H, d)
    k: torch.Tensor,  # (B, T, K, d)
    v: torch.Tensor,  # (B, T, K, d)
    *,
    causal: bool = True,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qg = q.reshape(b, s, kh, g, d).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    if causal:
        mask = torch.ones(s, t, dtype=torch.bool, device=q.device).tril(t - s)
        logits = logits.masked_fill(~mask, NEG)
    att = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", att, v)
    return out.reshape(b, s, h, d)
