"""Plain PyTorch version of the WKV6 recurrence: one step at a time.

The torch counterpart of ``repro.kernels.wkv6.ref.wkv6_ref`` (the same
math as ``repro.models.rwkv.wkv6_scan``), from an initial state:

    out_t = r_t^T (S_t + diag(u) k_t v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T

Everything runs in f32; the output is cast to r's dtype.  No log-space
factor is formed, so it is exact to the recurrence at every decay in
(0, 1) (the reference's chunked forms clamp the within-chunk cumulative
log-decay at -60, ROADMAP.md section 3).
"""

from __future__ import annotations

import torch


def wkv6_ref(
    r: torch.Tensor,  # (B, T, H, M)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # (B, T, H, M) decay factors in (0, 1)
    u: torch.Tensor,  # (H, M) current-token bonus
    state: torch.Tensor | None = None,  # (B, H, M, M) f32; zeros when None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(out (B, T, H, M) in r's dtype, final state (B, H, M, M) f32)``."""
    b, t, h, m = r.shape
    f32 = torch.float32
    if state is None:
        state = torch.zeros((b, h, m, m), dtype=f32, device=r.device)
    s = state.to(f32)
    rf, kf, vf, wf = (x.to(f32) for x in (r, k, v, w))
    uf = u.to(f32)
    outs = []
    for i in range(t):
        r_t, k_t, v_t, w_t = rf[:, i], kf[:, i], vf[:, i], wf[:, i]  # (B, H, M)
        bonus = torch.sum(r_t * uf[None] * k_t, dim=-1, keepdim=True) * v_t
        outs.append(torch.einsum("bhm,bhmn->bhn", r_t, s) + bonus)
        s = w_t[..., :, None] * s + k_t[..., :, None] * v_t[..., None, :]
    return torch.stack(outs, 1).to(r.dtype), s
