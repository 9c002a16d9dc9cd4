"""Plain PyTorch version of blockwise attention (GQA, causal, sliding
window, softcap).

The torch counterpart of ``repro.kernels.flash_attention.ref.
flash_attention_ref``, in the model's layout: q ``(B, S, H, d)``, k and v
``(B, T, K, d)``, out ``(B, S, H, d)`` (the JAX oracle takes heads before
positions).  Any S and T: causal masking is end-aligned, so query i sees
key j iff ``j <= i + T - S``; with a ``window`` > 0 also iff
``i + T - S - j < window`` (the JAX model's ``q_pos - k_pos < window``).
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
    window: int = 0,
) -> torch.Tensor:
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qg = q.reshape(b, s, kh, g, d).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    mask = torch.ones(s, t, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril(t - s)
    if window > 0:
        mask = mask.triu(t - s - window + 1)
    if causal or window > 0:
        logits = logits.masked_fill(~mask, NEG)
    att = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", att, v)
    return out.reshape(b, s, h, d)
