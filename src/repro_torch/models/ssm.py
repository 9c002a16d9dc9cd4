"""Selective SSM (Mamba-style) head of the Hymba hybrid blocks.

The counterpart of ``repro.models.ssm``.  Hymba runs attention heads and an
SSM head in parallel inside each block; the SSM is a selective scan with
input-dependent (dt, B, C), a diagonal A and a short causal conv:

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t      (per channel, N states)
    y_t = C_t . h_t + D x_t

Every scan, a prompt of T > 1 tokens or one decode step, is one call of the
``ssm_scan`` wrapper (``repro_torch.kernels.ssm_scan``) from the carried
state: one launch of the hand-written kernel on the card, the plain
recurrence on the CPU.  In training the same call goes through the
wrapper's autograd ``Function``, whose gradient is one launch of the
hand-written ``ssm_scan_bwd`` kernel on the card (the plain backward on
the CPU).  The JAX model's jnp ``selective_scan_chunked`` (its training
form) has no counterpart: it clamps the within-chunk cumulative
log-decay at -60 (ROADMAP.md section 3) and the kernel is exact without it.

bf16 follows the JAX dtype order: every operation on bf16 tensors rounds
to bf16 where JAX's does, and ``jax.nn.silu`` and ``jax.nn.softplus`` are
written as the operations XLA runs for them, each rounded (ROADMAP.md T10):
``g * (1 / (1 + exp(-g)))`` and ``max(x, 0) + log1p(exp(-|x|))``.

On a mesh (:func:`ssm_head_tp`) the scan runs channel parallel, the
rank's D/|model| channels into ``ssm_scan``.  Where the head's leaves are
cut over ``model`` (the heads divide it), every channel-wise leaf is the
rank's; ``w_in``'s flat 2D columns are all-gathered first, since the rule
cuts them across the x and z halves.  Where the leaves are whole (hymba's
25 heads), every rank computes the head's inputs whole and scans its own
channels, as JAX's ``channel_constrain`` lays them out.

On a serving layout (:func:`ssm_head_serve`) the head carries its state:
``w_in``'s product of the embed-cut input is summed over ``data`` to the
rank's rows and its columns gathered over ``model``; the conv state
(whole, the rank's rows) is carried on every channel, the scan and its
``h`` state block on the rank's channels.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.ssm_scan import ssm_scan
from ..sharding.mesh import (
    copy_to_region, gather_from_region, reduce_from_region, scatter_to_region,
)
from .common import ModelConfig, ParamFactory

CONV_K = 4  # short causal conv width


class SSMHead(nn.Module):
    """The ``ssm.*`` leaves of one layer (JAX ``blocks.ssm.w_in`` loads as
    ``blocks.<layer>.ssm.w_in``).  ``dt_bias`` starts at -4.6, so that
    softplus(raw + bias) lands in [1e-3, 1e-1] (Mamba's dt init)."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__()
        D, N = cfg.d_model, cfg.ssm_state
        self.w_in = f.new((D, 2 * D), axes=("embed", "q_dim"))
        self.conv = f.new((CONV_K, D), scale=0.5, axes=(None, "q_dim"))
        self.w_bcdt = f.new((D, 2 * N + 1), axes=("q_dim", None))
        self.dt_bias = f.new((D,), "const", scale=-4.6, axes=("q_dim",))
        self.a_log = f.new((D, N), "zeros", axes=("q_dim", None))
        self.d_skip = f.new((D,), "ones", axes=("q_dim",))
        self.w_out = f.new((D, D), axes=("q_dim", "embed"))


def _silu(g: torch.Tensor) -> torch.Tensor:
    return g * (1.0 / (1.0 + torch.exp(-g)))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def causal_conv(
    x: torch.Tensor, kernel: torch.Tensor, prev: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, T, D), kernel: (K, D), prev: (B, K-1, D)
    (zeros when None).  Returns the output and the new ``(B, K-1, D)`` conv
    state: the last K-1 inputs, the carried ones included."""
    k = kernel.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)  # (B, T+K-1, D)
    t = x.shape[1]
    out = xp[:, :t] * kernel[0]
    for i in range(1, k):  # summed left to right in x's dtype, as JAX's sum()
        out = out + xp[:, i : i + t] * kernel[i]
    return out, xp[:, -(k - 1) :]


def ssm_head(
    x: torch.Tensor,  # (B, T, D) block input (already normed)
    p: SSMHead,
    cfg: ModelConfig,
    state: dict[str, torch.Tensor] | None = None,  # {"conv": (B,K-1,D), "h": (B,D,N) f32}
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Returns ``(out (B, T, D), {"conv", "h"})``, the new state."""
    st = state or {}
    n = cfg.ssm_state
    xin, z = (x @ p.w_in).chunk(2, dim=-1)
    xc, conv_state = causal_conv(xin, p.conv, st.get("conv"))
    xc = _silu(xc)
    bcdt = xc @ p.w_bcdt  # (B, T, 2N+1)
    b_in, c_in, dt_raw = bcdt[..., :n], bcdt[..., n : 2 * n], bcdt[..., -1:]
    # a scalar dt per token plus a learned per-channel bias: (B, T, D) steps
    dt = _softplus(dt_raw + p.dt_bias) + 1e-4
    a = -torch.exp(p.a_log.float())  # (D, N), negative
    y, h = ssm_scan(xc, dt, a, b_in.contiguous(), c_in.contiguous(), st.get("h"))
    y = y + xc * p.d_skip
    y = y * _silu(z)
    return y @ p.w_out, {"conv": conv_state, "h": h}


# ------------------------------------------------------ on a mesh (training)
def ssm_head_tp(x: torch.Tensor, p: SSMHead, cfg: ModelConfig, lay) -> torch.Tensor:
    """:func:`ssm_head` (no state) with the scan on this rank's channels."""
    mesh, m = lay.mesh, lay.model
    n, d = cfg.ssm_state, cfg.d_model
    t = x.shape[1]
    cut = [lay.split(f"ssm.{k}", dim) for k, dim in
           (("w_in", 1), ("conv", 1), ("w_bcdt", 0), ("dt_bias", 0), ("a_log", 0),
            ("d_skip", 0), ("w_out", 0))]
    if any(cut) and not all(cut):
        raise ValueError(f"{cfg.name}: the SSM head's leaves are cut over model in part "
                         f"({cut}); the channel-parallel scan takes all or none")
    if all(cut):
        dl, me = d // m, mesh.axis_index("model")
        both = gather_from_region(copy_to_region(x, mesh) @ p.w_in, mesh, "model", dim=-1,
                                  partial=True)
        xin, z = both[..., me * dl : (me + 1) * dl], both[..., d + me * dl : d + (me + 1) * dl]
        xc = _silu(causal_conv(xin, p.conv, None)[0])
        bcdt = copy_to_region(reduce_from_region(xc @ p.w_bcdt, mesh), mesh)
        b_in, c_in, dt_raw = bcdt[..., :n], bcdt[..., n : 2 * n], bcdt[..., -1:]
        dt = _softplus(dt_raw + p.dt_bias) + 1e-4
        y, _ = ssm_scan(xc, dt, -torch.exp(p.a_log.float()), b_in.contiguous(),
                        c_in.contiguous(), None)
        y = (y + xc * p.d_skip) * _silu(z)
        return reduce_from_region(y @ p.w_out, mesh)
    xin, z = (x @ p.w_in).chunk(2, dim=-1)
    xc = _silu(causal_conv(xin, p.conv, None)[0])
    bcdt = xc @ p.w_bcdt
    b_in, c_in, dt_raw = bcdt[..., :n], bcdt[..., n : 2 * n], bcdt[..., -1:]
    dt = _softplus(dt_raw + p.dt_bias) + 1e-4
    a = -torch.exp(p.a_log.float())
    if m > 1 and d % m == 0 and t > 1:
        y, _ = ssm_scan(scatter_to_region(xc, mesh, "model", dim=-1),
                        scatter_to_region(dt, mesh, "model", dim=-1),
                        scatter_to_region(a, mesh, "model", dim=0),
                        copy_to_region(b_in.contiguous(), mesh),
                        copy_to_region(c_in.contiguous(), mesh), None)
        y = gather_from_region(y, mesh, "model", dim=-1)
    else:
        y, _ = ssm_scan(xc, dt, a, b_in.contiguous(), c_in.contiguous(), None)
    y = (y + xc * p.d_skip) * _silu(z)
    return y @ p.w_out


# ------------------------------------------------------- on a mesh (serving)
def ssm_head_serve(x: torch.Tensor, p: SSMHead, cfg: ModelConfig, lay,
                   state: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict]:
    """:func:`ssm_head` of an embed-cut ``x`` (normed) from the rank's state
    blocks (``conv`` (B_loc, K-1, D), ``h`` (B_loc, D / |model|, N) where
    ``cache_specs`` cuts D): ``(out embed-cut, {"conv", "h"})``."""
    n = x.shape[0]
    nst, d = cfg.ssm_state, cfg.d_model
    cut = [lay.split(f"ssm.{k}", dim) for k, dim in
           (("w_in", 1), ("conv", 1), ("w_bcdt", 0), ("dt_bias", 0), ("a_log", 0),
            ("d_skip", 0), ("w_out", 0))]
    if any(cut) and not all(cut):
        raise ValueError(f"{cfg.name}: the SSM head's leaves are cut over model in part "
                         f"({cut}); the channel-parallel scan takes all or none")
    both = lay.sum_rows(x @ p.w_in)
    if all(cut):  # the rule cuts w_in's columns across the x and z halves
        both = lay.gather_model(both)
    xin, z = both[..., :d], both[..., d:]
    prev = state["conv"]
    if prev.shape[1] != CONV_K - 1 or state["h"].shape[1] != p.a_log.shape[0]:
        raise ValueError(f"{cfg.name}: the conv state {tuple(prev.shape)} and h state "
                         f"{tuple(state['h'].shape)} do not fit the head's channel blocks")
    conv_state = torch.cat([prev.to(xin.dtype), xin], dim=1)[:, -(CONV_K - 1):]
    if all(cut):
        xin, z, prev = (lay.model_block(a) for a in (xin, z, prev))
    xc = _silu(causal_conv(xin, p.conv, prev)[0])
    bcdt = xc @ p.w_bcdt
    if all(cut):
        bcdt = lay.sum_model(bcdt)
    b_in, c_in, dt_raw = bcdt[..., :nst], bcdt[..., nst : 2 * nst], bcdt[..., -1:]
    dt = _softplus(dt_raw + p.dt_bias) + 1e-4
    y, h = ssm_scan(xc, dt, -torch.exp(p.a_log.float()), b_in.contiguous(), c_in.contiguous(),
                    state["h"])
    y = (y + xc * p.d_skip) * _silu(z)
    out = lay.all_rows(y, n) @ p.w_out
    return (lay.sum_model(out) if all(cut) else out), {"conv": conv_state, "h": h}
