"""Plain PyTorch version of the diagonal selective scan (Mamba): one step
at a time.

The torch counterpart of ``repro.kernels.ssm_scan.ref.ssm_scan_ref`` (the
same math as ``repro.models.ssm.selective_scan``), from an initial state,
per batch row, channel d and state entry n:

    h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t
    y_t = sum_n h_t c_t

Everything runs in f32; ``y`` is cast to x's dtype.  Each step forms its
own decay ``exp(dt_t a)`` and no cumulative log-decay, so it is exact to
the recurrence at every decay (the reference's chunked forms clamp the
within-chunk cumulative log-decay at -60, ROADMAP.md section 3).
"""

from __future__ import annotations

import torch


def ssm_scan_ref(
    x: torch.Tensor,  # (B, T, D)
    dt: torch.Tensor,  # (B, T, D), positive
    a: torch.Tensor,  # (D, N), negative
    b: torch.Tensor,  # (B, T, N)
    c: torch.Tensor,  # (B, T, N)
    h0: torch.Tensor | None = None,  # (B, D, N) f32; zeros when None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (B, T, D) in x's dtype, final state (B, D, N) f32)``."""
    bsz, t, d = x.shape
    f32 = torch.float32
    h = torch.zeros((bsz, d, a.shape[-1]), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    xf, dtf, bf, cf = (v.to(f32) for v in (x, dt, b, c))
    af = a.to(f32)
    ys = []
    for i in range(t):
        dt_t = dtf[:, i]  # (B, D)
        decay = torch.exp(dt_t[..., None] * af[None])  # (B, D, N)
        drive = (dt_t * xf[:, i])[..., None] * bf[:, i, None, :]
        h = decay * h + drive
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, i]))
    return torch.stack(ys, 1).to(x.dtype), h
