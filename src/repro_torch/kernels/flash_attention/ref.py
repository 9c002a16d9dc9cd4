"""Plain PyTorch version of blockwise attention (GQA, causal, sliding
window, softcap).

The torch counterpart of ``repro.kernels.flash_attention.ref.
flash_attention_ref``, in the model's layout: q ``(B, S, H, d)``, k and v
``(B, T, K, d)``, out ``(B, S, H, d)`` (the JAX oracle takes heads before
positions).  Any S and T: causal masking is end-aligned, so query i sees
key j iff ``j <= i + T - S``; with a ``window`` > 0 also iff
``i + T - S - j < window`` (the JAX model's ``q_pos - k_pos < window``).

:func:`flash_attention_bwd_ref` is the plain version of the backward kernel
(``csrc/flash_attention_bwd.cu``), written as the kernel computes it.
"""

from __future__ import annotations

import math

import torch

NEG = -(2.0**30)


def visible(s: int, t: int, causal: bool, window: int, device) -> torch.Tensor:
    """``(S, T)``: True where query i sees key j."""
    mask = torch.ones(s, t, dtype=torch.bool, device=device)
    if causal:
        mask = mask.tril(t - s)
    if window > 0:
        mask = mask.triu(t - s - window + 1)
    return mask


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
    if causal or window > 0:
        logits = logits.masked_fill(~visible(s, t, causal, window, q.device), NEG)
    att = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", att, v)
    return out.reshape(b, s, h, d)


def flash_attention_bwd_ref(
    q: torch.Tensor,  # (B, S, H, d)
    k: torch.Tensor,  # (B, T, K, d)
    v: torch.Tensor,  # (B, T, K, d)
    out: torch.Tensor,  # (B, S, H, d): the forward's output
    dout: torch.Tensor,  # (B, S, H, d)
    *,
    causal: bool = True,
    softcap: float | None = None,
    scale: float | None = None,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of attention, in f32 from inputs of either type and
    cast to the inputs' type at the end, as the kernel computes them: each
    row's log-sum-exp over its visible keys, recomputed from q and k;
    ``P = exp(c - lse)`` on visible keys and 0 elsewhere (c the capped
    logit); ``delta = rowsum(dO * O)``; ``dV = P^T dO``, ``dP = dO V^T``,
    ``dS = P * (dP - delta)``, through the softcap's ``1 - tanh^2`` of the
    pre-cap logit when one is set; ``dQ = dS K * scale`` and
    ``dK = dS^T Q * scale``, each KV head's dK and dV summed over its G
    query heads.  A row that sees no key (causal with S > T) has P = 0 and
    adds nothing, so its dQ is 0, where the forward's masked softmax
    (``flash_attention_ref``) would spread it evenly over all T keys."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf = q.reshape(b, s, kh, g, d).float()
    kf, vf = k.float(), v.float()
    do = dout.reshape(b, s, kh, g, d).float()
    x = torch.einsum("bskgd,btkd->bkgst", qf, kf) * scale
    if softcap is not None:
        th = torch.tanh(x / softcap)
        c = th * softcap
    else:
        c = x
    mask = visible(s, t, causal, window, q.device)
    lse = torch.logsumexp(c.masked_fill(~mask, -math.inf), dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(c - lse), 0.0)  # a row with no key: lse = -inf, P = 0
    delta = (do * out.reshape(b, s, kh, g, d).float()).sum(-1)  # (B, S, K, G)
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    dp = torch.einsum("bskgd,btkd->bkgst", do, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if softcap is not None:
        ds = ds * (1.0 - th * th)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf) * scale
    return dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
