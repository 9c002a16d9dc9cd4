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

:func:`ssm_scan_split_ref` is the split route's arithmetic in plain ops,
for the tests: the same function through chunk-local states, forward decay
products and a carry.
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


def ssm_scan_split_ref(
    x: torch.Tensor,  # (B, T, D)
    dt: torch.Tensor,  # (B, T, D), positive
    a: torch.Tensor,  # (D, N), negative
    b: torch.Tensor,  # (B, T, N)
    c: torch.Tensor,  # (B, T, N)
    h0: torch.Tensor | None = None,  # (B, D, N) f32; zeros when None
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssm_scan_ref` as the kernel's split route computes it, with T
    cut into chunks of ``chunk`` steps: (A) each chunk's state from zero and
    its decay product ``prod_t exp(dt_t a)`` (a running product), (B) the
    carry ``h_in[c + 1] = P[c] h_in[c] + h_loc[c]`` from ``h0``, (C) each
    chunk's y from ``h_in[c]``.  The last chunk is padded with steps of
    dt = 0 (a decay of exactly 1, no drive), which leave a state as it is."""
    bsz, t, d = x.shape
    n = a.shape[-1]
    f32 = torch.float32
    nc = -(-t // chunk)
    pad = nc * chunk - t

    def chunks(v):  # (B, T, F) -> (B, NC, L, F), zero-padded
        v = v.to(f32)
        if pad:
            v = torch.cat([v, v.new_zeros((bsz, pad, v.shape[-1]))], 1)
        return v.reshape(bsz, nc, chunk, v.shape[-1])

    xc, dtc, bc, cc = (chunks(v) for v in (x, dt, b, c))
    af = a.to(f32)
    # (A) chunk-local states from zero, and the decay products
    h_loc = torch.zeros((bsz, nc, d, n), dtype=f32, device=x.device)
    p = torch.ones((bsz, nc, d, n), dtype=f32, device=x.device)
    for i in range(chunk):
        decay = torch.exp(dtc[:, :, i, :, None] * af)  # (B, NC, D, N)
        drive = (dtc[:, :, i] * xc[:, :, i])[..., None] * bc[:, :, i, None, :]
        h_loc = decay * h_loc + drive
        p = p * decay
    # (B) the carry over the chunks
    h = torch.zeros((bsz, d, n), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    h_in = []
    for k in range(nc):
        h_in.append(h)
        h = p[:, k] * h + h_loc[:, k]
    hc = torch.stack(h_in, 1)  # (B, NC, D, N)
    # (C) each chunk again from its carried state
    ys = []
    for i in range(chunk):
        decay = torch.exp(dtc[:, :, i, :, None] * af)
        drive = (dtc[:, :, i] * xc[:, :, i])[..., None] * bc[:, :, i, None, :]
        hc = decay * hc + drive
        ys.append(torch.einsum("bkdn,bkn->bkd", hc, cc[:, :, i]))
    y = torch.stack(ys, 2).reshape(bsz, nc * chunk, d)[:, :t]
    return y.to(x.dtype), h
