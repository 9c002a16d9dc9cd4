"""Selective SSM (Mamba-style) head of the Hymba hybrid blocks.

The counterpart of ``repro.models.ssm``.  Hymba runs attention heads and an
SSM head in parallel inside each block; the SSM is a selective scan with
input-dependent (dt, B, C), a diagonal A and a short causal conv:

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t      (per channel, N states)
    y_t = C_t . h_t + D x_t

Every scan, a prompt of T > 1 tokens or one decode step, is one call of the
``ssm_scan`` wrapper (``repro_torch.kernels.ssm_scan``) from the carried
state: one launch of the hand-written kernel on the card, the plain
recurrence on the CPU.  The JAX model's jnp ``selective_scan_chunked`` (its
training form) has no counterpart: it clamps the within-chunk cumulative
log-decay at -60 (ROADMAP.md section 3) and the kernel is exact without it.

bf16 follows the JAX dtype order: every operation on bf16 tensors rounds
to bf16 where JAX's does, and ``jax.nn.silu`` and ``jax.nn.softplus`` are
written as the operations XLA runs for them, each rounded (ROADMAP.md T10):
``g * (1 / (1 + exp(-g)))`` and ``max(x, 0) + log1p(exp(-|x|))``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.ssm_scan import ssm_scan
from .common import ModelConfig, ParamFactory

CONV_K = 4  # short causal conv width


class SSMHead(nn.Module):
    """The ``ssm.*`` leaves of one layer (JAX ``blocks.ssm.w_in`` loads as
    ``blocks.<layer>.ssm.w_in``).  ``dt_bias`` starts at -4.6, so that
    softplus(raw + bias) lands in [1e-3, 1e-1] (Mamba's dt init)."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__()
        D, N = cfg.d_model, cfg.ssm_state
        self.w_in = f.new((D, 2 * D))
        self.conv = f.new((CONV_K, D), scale=0.5)
        self.w_bcdt = f.new((D, 2 * N + 1))
        self.dt_bias = f.new((D,), "const", scale=-4.6)
        self.a_log = f.new((D, N), "zeros")
        self.d_skip = f.new((D,), "ones")
        self.w_out = f.new((D, D))


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
