"""Plain PyTorch version of the WKV6 recurrence: one step at a time.

The torch counterpart of ``repro.kernels.wkv6.ref.wkv6_ref`` (the same
math as ``repro.models.rwkv.wkv6_scan``), from an initial state:

    out_t = r_t^T (S_t + diag(u) k_t v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T

Everything runs in f32; the output is cast to r's dtype.  No log-space
factor is formed, so it is exact to the recurrence at every decay in
(0, 1) (the reference's chunked forms clamp the within-chunk cumulative
log-decay at -60, ROADMAP.md section 3).
The products with a state are elementwise products and sums, not BLAS
calls: a loop of T small BLAS calls slows down by orders of magnitude when
several test processes share the host's cores (each call waits on its
thread pool).

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
        outs.append((r_t[..., :, None] * s).sum(-2) + bonus)
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
        outs.append((r_t[..., :, None] * st).sum(-2) + bonus)
        st = w_t[..., :, None] * st + k_t[..., :, None] * v_t[..., None, :]
    out = torch.stack(outs, 2).reshape(b, nc * chunk, h, m)[:, :t]
    return out.to(r.dtype), s


def wkv6_bwd_ref(
    r: torch.Tensor,  # (B, T, H, M)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # (B, T, H, M) decay factors in (0, 1)
    u: torch.Tensor,  # (H, M)
    state: torch.Tensor | None,  # (B, H, M, M) f32; zeros when None
    dout: torch.Tensor,  # (B, T, H, M): the output's cotangent
    dstate: torch.Tensor | None = None,  # (B, H, M, M): the final state's; zeros when None
) -> tuple[torch.Tensor, ...]:
    """The gradients of :func:`wkv6_ref` at ``(dout, dstate)``: ``(dr, dk,
    dv, dw, du, dstate0)``, each in its operand's dtype (dstate0, the
    initial state's, in f32).  The forward's states are kept, then the
    state's adjoint G_t = dL/dS_t walks back from G_T = dstate:

        dr_t = S_t dout_t + u k_t (v_t . dout_t)
        dk_t = G_{t+1} v_t + u r_t (v_t . dout_t)
        dv_t = G_{t+1}^T k_t + (r_t . u k_t) dout_t
        dw_t = sum_j G_{t+1}[:, j] S_t[:, j]
        du = sum_{b, t} r_t k_t (v_t . dout_t)
        G_t = diag(w_t) G_{t+1} + r_t dout_t^T

    all in f32, each gradient rounded once."""
    b, t, h, m = r.shape
    f32 = torch.float32
    rf, kf, vf, wf, df = (x.to(f32) for x in (r, k, v, w, dout))
    uf = u.to(f32)
    s = torch.zeros((b, h, m, m), dtype=f32, device=r.device) if state is None else state.to(f32)
    states = []
    for i in range(t):
        states.append(s)
        s = wf[:, i, ..., None] * s + kf[:, i, ..., None] * vf[:, i, ..., None, :]
    g = torch.zeros_like(s) if dstate is None else dstate.to(f32)
    dr, dk, dv, dw = (torch.empty((b, t, h, m), dtype=f32, device=r.device) for _ in range(4))
    du = torch.zeros((h, m), dtype=f32, device=r.device)
    for i in reversed(range(t)):
        r_t, k_t, v_t, w_t, d_t = rf[:, i], kf[:, i], vf[:, i], wf[:, i], df[:, i]
        vd = torch.sum(v_t * d_t, dim=-1, keepdim=True)  # (B, H, 1)
        dr[:, i] = (states[i] * d_t[..., None, :]).sum(-1) + uf * k_t * vd
        dk[:, i] = (g * v_t[..., None, :]).sum(-1) + uf * r_t * vd
        dv[:, i] = ((g * k_t[..., :, None]).sum(-2)
                    + torch.sum(r_t * uf * k_t, dim=-1, keepdim=True) * d_t)
        dw[:, i] = torch.sum(g * states[i], dim=-1)
        du += torch.sum(r_t * k_t * vd, dim=0)
        g = w_t[..., :, None] * g + r_t[..., :, None] * d_t[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype), du.to(u.dtype), g)


def wkv6_bwd_split_ref(
    r: torch.Tensor,  # (B, T, H, M)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # (B, T, H, M) decay factors in (0, 1)
    u: torch.Tensor,  # (H, M)
    state: torch.Tensor | None,  # (B, H, M, M) f32; zeros when None
    dout: torch.Tensor,  # (B, T, H, M)
    dstate: torch.Tensor | None = None,  # (B, H, M, M); zeros when None
    chunk: int = 16,
) -> tuple[torch.Tensor, ...]:
    """:func:`wkv6_bwd_ref` as the backward kernel computes it, with T cut
    into chunks of ``chunk`` steps: (A) each chunk's local state from zero
    S_loc[c], its local adjoint from zero at its end G_loc[c] and its decay
    product P[c]; (B) the carries S_in[c + 1] = diag(P[c]) S_in[c] +
    S_loc[c] from ``state`` and G_end[c - 1] = diag(P[c]) G_end[c] +
    G_loc[c] from ``dstate``; (C) each chunk's states again from S_in[c],
    kept, and its adjoint walked back from G_end[c], each step's gradients
    formed from the two.  The last chunk is padded with steps of w = 1 and
    r = k = v = dout = 0, which leave a state and an adjoint as they are."""
    b, t, h, m = r.shape
    f32 = torch.float32
    nc = -(-t // chunk)
    pad = nc * chunk - t

    def chunks(x, fill):  # (B, T, H, M) -> (B, NC, L, H, M), padded
        x = x.to(f32)
        if pad:
            x = torch.cat([x, x.new_full((b, pad, h, m), fill)], 1)
        return x.reshape(b, nc, chunk, h, m)

    rc, kc, vc, dc = (chunks(x, 0.0) for x in (r, k, v, dout))
    wc = chunks(w, 1.0)
    uf = u.to(f32)
    zeros = torch.zeros((b, nc, h, m, m), dtype=f32, device=r.device)
    # (A) the local passes, forward and back, and the decay products
    s_loc, g_loc = zeros, zeros
    p = torch.ones((b, nc, h, m), dtype=f32, device=r.device)
    for i in range(chunk):
        s_loc = wc[:, :, i, ..., None] * s_loc + kc[:, :, i, ..., None] * vc[:, :, i, ..., None, :]
        p = p * wc[:, :, i]
    for i in reversed(range(chunk)):
        g_loc = wc[:, :, i, ..., None] * g_loc + rc[:, :, i, ..., None] * dc[:, :, i, ..., None, :]
    # (B) the carries
    s = torch.zeros((b, h, m, m), dtype=f32, device=r.device) if state is None else state.to(f32)
    g = torch.zeros_like(s) if dstate is None else dstate.to(f32)
    s_in, g_end = [], [None] * nc
    for c in range(nc):
        s_in.append(s)
        s = p[:, c, ..., None] * s + s_loc[:, c]
    for c in reversed(range(nc)):
        g_end[c] = g
        g = p[:, c, ..., None] * g + g_loc[:, c]
    # (C) each chunk's states from S_in[c], then its steps walked back
    st = torch.stack(s_in, 1)  # (B, NC, H, M, M)
    hist = []
    for i in range(chunk):
        hist.append(st)
        st = wc[:, :, i, ..., None] * st + kc[:, :, i, ..., None] * vc[:, :, i, ..., None, :]
    gt = torch.stack(g_end, 1)
    grads = [[None] * chunk for _ in range(4)]
    du = torch.zeros((b, nc, h, m), dtype=f32, device=r.device)
    for i in reversed(range(chunk)):
        r_t, k_t, v_t, w_t, d_t = rc[:, :, i], kc[:, :, i], vc[:, :, i], wc[:, :, i], dc[:, :, i]
        vd = torch.sum(v_t * d_t, dim=-1, keepdim=True)
        grads[0][i] = (hist[i] * d_t[..., None, :]).sum(-1) + uf * k_t * vd
        grads[1][i] = (gt * v_t[..., None, :]).sum(-1) + uf * r_t * vd
        grads[2][i] = ((gt * k_t[..., :, None]).sum(-2)
                       + torch.sum(r_t * uf * k_t, dim=-1, keepdim=True) * d_t)
        grads[3][i] = torch.sum(gt * hist[i], dim=-1)
        du = du + r_t * k_t * vd
        gt = w_t[..., :, None] * gt + r_t[..., :, None] * d_t[..., None, :]
    dr, dk, dv, dw = (torch.stack(x, 2).reshape(b, nc * chunk, h, m)[:, :t] for x in grads)
    du = du.sum((0, 1))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype), du.to(u.dtype), g)
