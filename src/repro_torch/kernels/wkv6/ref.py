"""Plain PyTorch version of the WKV6 recurrence: one step at a time.

The torch counterpart of ``repro.kernels.wkv6.ref.wkv6_ref`` (the same
math as ``repro.models.rwkv.wkv6_scan``), from an initial state:

    out_t = r_t^T (S_t + diag(u) k_t v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T

Everything runs in f32; the output is cast to r's dtype.  No log-space
factor is formed, so it is exact to the recurrence at every decay in
(0, 1) (the reference's chunked forms clamp the within-chunk cumulative
log-decay at -60, ROADMAP.md section 3).

:func:`wkv6_split_ref` is the split route's arithmetic in plain ops, for
the tests: the same function through chunk-local states, forward decay
products and a carry.
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


def wkv6_split_ref(
    r: torch.Tensor,  # (B, T, H, M)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # (B, T, H, M) decay factors in (0, 1)
    u: torch.Tensor,  # (H, M)
    state: torch.Tensor | None = None,  # (B, H, M, M) f32; zeros when None
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`wkv6_ref` as the kernel's split route computes it, with T cut
    into chunks of ``chunk`` steps: (A) each chunk's state from zero and its
    decay product ``prod_t w_t`` (a running product), (B) the carry
    ``S_in[c + 1] = diag(P[c]) S_in[c] + S_loc[c]`` from ``state``, (C) each
    chunk's outputs from ``S_in[c]``.  The last chunk is padded with steps
    of w = 1, k = v = 0, which leave a state as it is."""
    b, t, h, m = r.shape
    f32 = torch.float32
    nc = -(-t // chunk)
    pad = nc * chunk - t

    def chunks(x, fill):  # (B, T, H, M) -> (B, NC, L, H, M), padded
        x = x.to(f32)
        if pad:
            x = torch.cat([x, x.new_full((b, pad, h, m), fill)], 1)
        return x.reshape(b, nc, chunk, h, m)

    rc, kc, vc = (chunks(x, 0.0) for x in (r, k, v))
    wc = chunks(w, 1.0)
    uf = u.to(f32)
    # (A) chunk-local states from zero, and the decay products
    s_loc = torch.zeros((b, nc, h, m, m), dtype=f32, device=r.device)
    p = torch.ones((b, nc, h, m), dtype=f32, device=r.device)
    for i in range(chunk):
        w_t, k_t, v_t = wc[:, :, i], kc[:, :, i], vc[:, :, i]
        s_loc = w_t[..., :, None] * s_loc + k_t[..., :, None] * v_t[..., None, :]
        p = p * w_t
    # (B) the carry over the chunks
    s = torch.zeros((b, h, m, m), dtype=f32, device=r.device) if state is None else state.to(f32)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = p[:, c, ..., :, None] * s + s_loc[:, c]
    st = torch.stack(s_in, 1)  # (B, NC, H, M, M)
    # (C) each chunk again from its carried state
    outs = []
    for i in range(chunk):
        r_t, k_t, v_t, w_t = rc[:, :, i], kc[:, :, i], vc[:, :, i], wc[:, :, i]
        bonus = torch.sum(r_t * uf * k_t, dim=-1, keepdim=True) * v_t
        outs.append(torch.einsum("bchm,bchmn->bchn", r_t, st) + bonus)
        st = w_t[..., :, None] * st + k_t[..., :, None] * v_t[..., None, :]
    out = torch.stack(outs, 2).reshape(b, nc * chunk, h, m)[:, :t]
    return out.to(r.dtype), s
