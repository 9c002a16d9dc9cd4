"""Plain PyTorch version of blockwise attention (GQA, causal, sliding
window, softcap).

The torch counterpart of ``repro.kernels.flash_attention.ref.
flash_attention_ref``, in the model's layout: q ``(B, S, H, d)``, k and v
``(B, T, K, d)``, out ``(B, S, H, d)`` (the JAX oracle takes heads before
positions).  Any S and T: causal masking is end-aligned, so query i sees
key j iff ``j <= i + T - S``; with a ``window`` > 0 also iff
``i + T - S - j < window`` (the JAX model's ``q_pos - k_pos < window``).
A ``diag`` other than ``T - S`` moves the diagonal: query i sees key j iff
``j <= i + diag`` (and ``i + diag - j < window``), as a slice of a KV
cache cut over T sees its queries (``diag = offset - lo``).  A row that
sees no key gives zeros and a log-sum-exp of ``-inf``.

:func:`flash_attention_bwd_ref` is the plain version of the backward kernel
(``csrc/flash_attention_bwd.cu``), written as the kernel computes it, and
:func:`flash_attention_lse_ref` that of the log-sum-exp the forward kernel
writes for it.
"""

from __future__ import annotations

import math

import torch

NEG = -(2.0**30)


def visible(s: int, t: int, causal: bool, window: int, device,
            diag: int | None = None) -> torch.Tensor:
    """``(S, T)``: True where query i sees key j (``j <= i + diag``, the
    diagonal ``T - S`` unless given)."""
    diag = t - s if diag is None else diag
    mask = torch.ones(s, t, dtype=torch.bool, device=device)
    if causal:
        mask = mask.tril(diag)
    if window > 0:
        mask = mask.triu(diag - window + 1)
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
    diag: int | None = None,
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
        mask = visible(s, t, causal, window, q.device, diag)
        logits = logits.masked_fill(~mask, NEG)
    att = torch.softmax(logits, dim=-1)
    d0 = t - s if diag is None else diag
    if causal and (d0 < 0 or (window > 0 and s + d0 - window > t - 1)):
        att = att * mask.any(-1)[:, None]  # a row that sees no key gives zeros
    att = att.to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", att, v)
    return out.reshape(b, s, h, d)


def _logits(q, k, causal, softcap, scale, window, diag=None):
    """The capped f32 logits ``c`` (B, K, G, S, T), ``tanh`` of the scaled
    ones (None without a softcap) and the ``(S, T)`` visibility mask."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    x = torch.einsum("bskgd,btkd->bkgst", q.reshape(b, s, kh, h // kh, d).float(),
                     k.float()) * scale
    th = torch.tanh(x / softcap) if softcap is not None else None
    return (x if th is None else th * softcap), th, visible(s, t, causal, window, q.device,
                                                             diag)


def flash_attention_lse_ref(
    q: torch.Tensor,  # (B, S, H, d)
    k: torch.Tensor,  # (B, T, K, d)
    *,
    causal: bool = True,
    softcap: float | None = None,
    scale: float | None = None,
    window: int = 0,
    diag: int | None = None,
) -> torch.Tensor:
    """Each (query, head) row's log-sum-exp over its visible keys, f32
    ``(B, H, S)``: what the forward kernel writes for the backward.  A row
    that sees no key has ``-inf``."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    c, _, mask = _logits(q, k, causal, softcap, scale, window, diag)
    return torch.logsumexp(c.masked_fill(~mask, -math.inf), dim=-1).reshape(b, h, s)


def _bwd_terms(q, k, v, out, dout, causal, softcap, scale, window, lse):
    """``P`` and ``dS`` (B, K, G, S, T) in f32 before any rounding, and the
    f32 operands q (B, S, K, G, d), k, v (B, T, K, d) and dO (B, S, K, G, d)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    qf = q.reshape(b, s, kh, g, d).float()
    kf, vf = k.float(), v.float()
    do = dout.reshape(b, s, kh, g, d).float()
    c, th, mask = _logits(q, k, causal, softcap, scale, window)
    if lse is None:
        lse = torch.logsumexp(c.masked_fill(~mask, -math.inf), dim=-1, keepdim=True)
    else:
        lse = lse.reshape(b, kh, g, s, 1).float()
    p = torch.where(mask, torch.exp(c - lse), 0.0)  # a row with no key: lse = -inf, P = 0
    delta = (do * out.reshape(b, s, kh, g, d).float()).sum(-1)  # (B, S, K, G)
    dp = torch.einsum("bskgd,btkd->bkgst", do, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if softcap is not None:
        ds = ds * (1.0 - th * th)
    return p, ds, qf, kf, do


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
    lse: torch.Tensor | None = None,  # (B, H, S) f32: the forward's, else recomputed
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of attention, in f32 from inputs of either type and
    cast to the inputs' type at the end, as the kernel computes them: each
    row's log-sum-exp over its visible keys (``lse``, or recomputed from q
    and k as :func:`flash_attention_lse_ref` does); ``P = exp(c - lse)`` on
    visible keys and 0 elsewhere (c the capped logit); ``delta =
    rowsum(dO * O)``; ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P * (dP -
    delta)``, through the softcap's ``1 - tanh^2`` of the pre-cap logit when
    one is set; ``dQ = dS K * scale`` and ``dK = dS^T Q * scale``, each KV
    head's dK and dV summed over its G query heads.  For bf16 inputs P is
    rounded to bf16 before dV and dS before dQ and dK, the kernel's
    rounding points (the ``wgmma`` route's); f32 inputs round nothing.  A
    row that sees no key (causal with S > T) has P = 0 and adds nothing, so
    its dQ is 0, as the forward (``flash_attention_ref``) gives it zeros."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    p, ds, qf, kf, do = _bwd_terms(q, k, v, out, dout, causal, softcap, scale, window, lse)
    if q.dtype == torch.bfloat16:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf) * scale
    return dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_step_ref(
    q: torch.Tensor,  # (B, S, H, d)
    k: torch.Tensor,  # (B, T, K, d)
    v: torch.Tensor,  # (B, T, K, d)
    out: torch.Tensor,  # (B, S, H, d)
    dout: torch.Tensor,  # (B, S, H, d)
    *,
    causal: bool = True,
    softcap: float | None = None,
    scale: float | None = None,
    window: int = 0,
    lse: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For bf16 inputs, one bf16 step (2**-7 of itself) of the largest term
    of each row of dq ``(B, S, H, 1)``, dk and dv ``(B, T, K, 1)`` that
    passes a bf16 rounding point, over that row's own terms: ``|dS_ij|
    |K_jd| scale`` for dq's row i, ``|dS_ij| |Q_id| scale`` for dk's row j
    and ``|P_ij| |dO_id|`` for dv's (i over the G query heads of the KV
    head too); zeros for f32 inputs.  The kernel rounds P and dS where
    :func:`flash_attention_bwd_ref` does, but from f32 values summed in
    another order: where the two straddle a rounding boundary they round to
    neighbouring bf16 values, and a gradient row moves by that term's step.
    A comparison of the two allows this on top of its own bound."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16:
        z = torch.zeros((), device=q.device)
        return (z.expand(b, s, h, 1), z.expand(b, t, kh, 1), z.expand(b, t, kh, 1))
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    p, ds, qf, kf, do = _bwd_terms(q, k, v, out, dout, causal, softcap, scale, window, lse)
    step = 2.0**-7
    # each row's (key's) largest |element| of K, Q and dO, broadcast over (B, K, G, S, T)
    k_top = kf.abs().amax(-1).permute(0, 2, 1)[:, :, None, None, :]
    q_top, do_top = (x.abs().amax(-1).permute(0, 2, 3, 1)[..., None] for x in (qf, do))
    dq = step * scale * (ds.abs() * k_top).amax(-1).permute(0, 3, 1, 2).reshape(b, s, h, 1)
    dk = step * scale * (ds.abs() * q_top).amax((2, 3)).permute(0, 2, 1)[..., None]
    dv = step * (p.abs() * do_top).amax((2, 3)).permute(0, 2, 1)[..., None]
    return dq, dk, dv
