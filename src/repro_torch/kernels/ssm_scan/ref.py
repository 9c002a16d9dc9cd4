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
The products with a state are elementwise products and sums, not BLAS
calls: a loop of T small BLAS calls slows down by orders of magnitude when
several test processes share the host's cores (each call waits on its
thread pool).

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
        ys.append((h * cf[:, i, None, :]).sum(-1))
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
        ys.append((hc * cc[:, :, i, None, :]).sum(-1))
    y = torch.stack(ys, 2).reshape(bsz, nc * chunk, d)[:, :t]
    return y.to(x.dtype), h


def ssm_scan_bwd_ref(
    x: torch.Tensor,  # (B, T, D)
    dt: torch.Tensor,  # (B, T, D), positive
    a: torch.Tensor,  # (D, N), negative
    b: torch.Tensor,  # (B, T, N)
    c: torch.Tensor,  # (B, T, N)
    h0: torch.Tensor | None,  # (B, D, N) f32; zeros when None
    dy: torch.Tensor,  # (B, T, D): y's cotangent
    dh: torch.Tensor | None = None,  # (B, D, N): the final state's; zeros when None
) -> tuple[torch.Tensor, ...]:
    """The gradients of :func:`ssm_scan_ref` at ``(dy, dh)``: ``(dx, ddt,
    da, db, dc, dh0)``, each in its operand's dtype (da and dh0 in f32).
    The forward's states h_{t-1} are kept, then, with e_t = exp(dt_t a)
    formed again each step, the adjoint walks back from g = dh:

        g_t = g + dy_t c_t              (dL/dh_t)
        dc_t = sum_d dy_t h_t           db_t = sum_d g_t dt_t x_t
        dx_t = dt_t sum_n g_t b_t       ddt_t = sum_n g_t (x_t b_t + a e_t h_{t-1})
        da = sum_{b, t} g_t dt_t e_t h_{t-1}
        g = e_t g_t                     (dL/dh_{t-1}; dh0 after step 0)

    all in f32, each gradient rounded once; no step divides by a decay."""
    bsz, t, d = x.shape
    f32 = torch.float32
    h = torch.zeros((bsz, d, a.shape[-1]), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    xf, dtf, bf, cf, dyf = (v.to(f32) for v in (x, dt, b, c, dy))
    af = a.to(f32)
    hist = []
    for i in range(t):
        hist.append(h)
        decay = torch.exp(dtf[:, i, :, None] * af)
        h = decay * h + (dtf[:, i] * xf[:, i])[..., None] * bf[:, i, None, :]
    g = torch.zeros_like(h) if dh is None else dh.to(f32)
    dx, ddt = (torch.empty((bsz, t, d), dtype=f32, device=x.device) for _ in range(2))
    db, dc = (torch.empty((bsz, t, a.shape[-1]), dtype=f32, device=x.device) for _ in range(2))
    da = torch.zeros_like(af)
    for i in reversed(range(t)):
        dt_t, x_t, b_t, c_t, dy_t = dtf[:, i], xf[:, i], bf[:, i], cf[:, i], dyf[:, i]
        decay = torch.exp(dt_t[..., None] * af)  # (B, D, N)
        hp = hist[i]
        h_t = decay * hp + (dt_t * x_t)[..., None] * b_t[:, None, :]
        g_t = g + dy_t[..., None] * c_t[:, None, :]
        dc[:, i] = (h_t * dy_t[..., None]).sum(1)
        db[:, i] = (g_t * (dt_t * x_t)[..., None]).sum(1)
        gb = (g_t * b_t[:, None, :]).sum(-1)
        dx[:, i] = dt_t * gb
        ddt[:, i] = x_t * gb + torch.sum(g_t * af * decay * hp, dim=-1)
        da += torch.sum(g_t * dt_t[..., None] * decay * hp, dim=0)
        g = decay * g_t
    return (dx.to(x.dtype), ddt.to(dt.dtype), da.to(a.dtype), db.to(b.dtype), dc.to(c.dtype), g)


def ssm_scan_bwd_split_ref(
    x: torch.Tensor,  # (B, T, D)
    dt: torch.Tensor,  # (B, T, D), positive
    a: torch.Tensor,  # (D, N), negative
    b: torch.Tensor,  # (B, T, N)
    c: torch.Tensor,  # (B, T, N)
    h0: torch.Tensor | None,  # (B, D, N) f32; zeros when None
    dy: torch.Tensor,  # (B, T, D)
    dh: torch.Tensor | None = None,  # (B, D, N); zeros when None
    chunk: int = 16,
) -> tuple[torch.Tensor, ...]:
    """:func:`ssm_scan_bwd_ref` as the backward kernel computes it, with T
    cut into chunks of ``chunk`` steps: (A) each chunk's local state from
    zero h_loc[c], its local adjoint from zero at its end G_loc[c] (dL/dh
    just before the chunk) and its decay product P[c]; (B) the carries
    h_in[c + 1] = P[c] h_in[c] + h_loc[c] from ``h0`` and gR[c - 1] = P[c]
    gR[c] + G_loc[c] from ``dh`` (gR[c]: the adjoint reaching chunk c's last
    state from beyond it); (C) each chunk's states again from h_in[c], kept,
    and its adjoint walked back from gR[c].  The last chunk is padded with
    steps of dt = 0 and dy = 0, which leave a state and an adjoint as they
    are."""
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

    xc, dtc, bc, cc, dyc = (chunks(v) for v in (x, dt, b, c, dy))
    af = a.to(f32)
    decays = [torch.exp(dtc[:, :, i, :, None] * af) for i in range(chunk)]  # (B, NC, D, N)
    drives = [(dtc[:, :, i] * xc[:, :, i])[..., None] * bc[:, :, i, None, :] for i in range(chunk)]
    # (A) the local passes, forward and back, and the decay products
    h_loc = torch.zeros((bsz, nc, d, n), dtype=f32, device=x.device)
    g_loc = torch.zeros_like(h_loc)
    p = torch.ones_like(h_loc)
    for i in range(chunk):
        h_loc = decays[i] * h_loc + drives[i]
        p = p * decays[i]
    for i in reversed(range(chunk)):
        g_loc = decays[i] * (g_loc + dyc[:, :, i, :, None] * cc[:, :, i, None, :])
    # (B) the carries
    h = torch.zeros((bsz, d, n), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    g = torch.zeros_like(h) if dh is None else dh.to(f32)
    h_in, g_r = [], [None] * nc
    for k in range(nc):
        h_in.append(h)
        h = p[:, k] * h + h_loc[:, k]
    for k in reversed(range(nc)):
        g_r[k] = g
        g = p[:, k] * g + g_loc[:, k]
    # (C) each chunk's states from h_in[c], then its steps walked back
    hc = torch.stack(h_in, 1)
    hist = []
    for i in range(chunk):
        hist.append(hc)
        hc = decays[i] * hc + drives[i]
    gc = torch.stack(g_r, 1)
    out = [[None] * chunk for _ in range(4)]
    da = torch.zeros((bsz, nc, d, n), dtype=f32, device=x.device)
    for i in reversed(range(chunk)):
        dt_t, x_t, b_t, c_t, dy_t = dtc[:, :, i], xc[:, :, i], bc[:, :, i], cc[:, :, i], dyc[:, :, i]
        h_t = decays[i] * hist[i] + drives[i]
        g_t = gc + dy_t[..., None] * c_t[:, :, None, :]
        out[3][i] = (h_t * dy_t[..., None]).sum(2)  # dc
        out[2][i] = (g_t * (dt_t * x_t)[..., None]).sum(2)  # db
        gb = (g_t * b_t[:, :, None, :]).sum(-1)
        out[0][i] = dt_t * gb  # dx
        out[1][i] = x_t * gb + torch.sum(g_t * af * decays[i] * hist[i], dim=-1)  # ddt
        da = da + g_t * dt_t[..., None] * decays[i] * hist[i]
        gc = decays[i] * g_t
    dx, ddt, db, dc = (torch.stack(v, 2).reshape(bsz, nc * chunk, -1)[:, :t] for v in out)
    return (dx.to(x.dtype), ddt.to(dt.dtype), da.sum((0, 1)).to(a.dtype), db.to(b.dtype),
            dc.to(c.dtype), g)
