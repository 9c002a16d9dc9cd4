"""RWKV6 "Finch": attention-free time mixing with data-dependent decay.

The counterpart of ``repro.models.rwkv``.  Per head (head size M, state
S in R^{M x M}) the time mix runs the recurrence

    out_t = r_t^T (S_t + diag(u) k_t v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T

with the per-channel, per-step decay ``w_t = exp(-exp(w0 + tanh(x_w A) B))``
(a low-rank data-dependent function of the shifted input).  Every WKV call,
a prompt of T > 1 tokens or one decode step, is one call of the ``wkv6``
wrapper (``repro_torch.kernels.wkv6``): one launch of the hand-written
kernel on the card, the plain recurrence on the CPU.  The JAX model's jnp
``wkv6_chunked`` (its CPU and dry-run rendering of the chunked kernel) has
no counterpart: it clamps the within-chunk log-decay (ROADMAP.md section 3)
and the kernel is exact without it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.wkv6 import wkv6
from .common import ModelConfig, ParamFactory, rms_norm

LORA_DIM = 64  # decay LoRA bottleneck


def token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x[:, t-1], with x[:, 0]'s predecessor carried across calls (decode)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


# ----------------------------------------------------------------- params
class TimeMix(nn.Module):
    """The ``tm.*`` leaves of one layer."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__()
        D, m = cfg.d_model, cfg.rwkv_head_dim
        for mu in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            setattr(self, mu, f.new((D,), "zeros"))
        self.w0 = f.new((D,), "zeros")
        self.wA = f.new((D, LORA_DIM))
        self.wB = f.new((LORA_DIM, D))
        self.u = f.new((D // m, m), "zeros")
        for w in ("wr", "wk", "wv", "wg"):
            setattr(self, w, f.new((D, D)))
        self.wo = f.new((D, D))
        self.ln_x = f.new((D,), "zeros")


class ChannelMix(nn.Module):
    """The ``cm.*`` leaves of one layer."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__()
        D, F_ = cfg.d_model, cfg.d_ff
        self.mu_k = f.new((D,), "zeros")
        self.mu_r = f.new((D,), "zeros")
        self.wk = f.new((D, F_))
        self.wv = f.new((F_, D))
        self.wr = f.new((D, D))


class RWKVBlock(nn.Module):
    """One layer's weights: the JAX ``blocks.*`` leaves of
    ``add_rwkv_block_params`` at one layer index (``blocks.tm.mu_r`` is
    ``blocks.<layer>.tm.mu_r`` here)."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__()
        self.ln1 = f.new((cfg.d_model,), "zeros")
        self.ln2 = f.new((cfg.d_model,), "zeros")
        self.tm = TimeMix(cfg, f)
        self.cm = ChannelMix(cfg, f)


# ------------------------------------------------------------- sublayers
def time_mix(
    x: torch.Tensor,  # (B, T, D)
    p: TimeMix,
    cfg: ModelConfig,
    shift_prev: torch.Tensor | None = None,  # (B, 1, D)
    wkv_state: torch.Tensor | None = None,  # (B, H, M, M) f32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(y, the last input row (next shift_prev), the WKV state)``."""
    b, t, d = x.shape
    m = cfg.rwkv_head_dim
    h = d // m
    xx = token_shift(x, shift_prev) - x
    xr = x + xx * p.mu_r
    xk = x + xx * p.mu_k
    xv = x + xx * p.mu_v
    xw = x + xx * p.mu_w
    xg = x + xx * p.mu_g
    # data-dependent decay (the Finch contribution), in f32
    dd = torch.tanh(xw @ p.wA) @ p.wB
    w = torch.exp(-torch.exp((p.w0 + dd).float()))
    r = (xr @ p.wr).reshape(b, t, h, m)
    k = (xk @ p.wk).reshape(b, t, h, m)
    v = (xv @ p.wv).reshape(b, t, h, m)
    g = xg @ p.wg
    g = g * torch.sigmoid(g)  # silu as jax.nn.silu rounds it: the sigmoid in x's dtype
    out, wkv_state = wkv6(r, k, v, w.reshape(b, t, h, m), p.u, wkv_state)
    # per-head groupnorm, in the output's dtype (r's), as the JAX model
    mean = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, unbiased=False)
    out = ((out - mean) * torch.rsqrt(var + 64e-5)).reshape(b, t, d)
    out = out * (1.0 + p.ln_x)
    y = (out.to(x.dtype) * g) @ p.wo
    return y, x[:, -1:], wkv_state


def channel_mix(
    x: torch.Tensor, p: ChannelMix, shift_prev: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y, the last input row)``: a relu**2 MLP behind a sigmoid gate."""
    xx = token_shift(x, shift_prev) - x
    xk = x + xx * p.mu_k
    xr = x + xx * p.mu_r
    kk = torch.square(torch.relu(xk @ p.wk))
    y = torch.sigmoid(xr @ p.wr) * (kk @ p.wv)
    return y, x[:, -1:]


def rwkv_block(
    x: torch.Tensor,
    p: RWKVBlock,
    cfg: ModelConfig,
    state: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One RWKV6 block.  ``state`` (decode): ``{"tm_shift", "cm_shift", "wkv"}``
    of this layer; returns the block's output and its new state (new
    tensors; the caller decides which rows to keep)."""
    st = state or {}
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    att, tm_shift, wkv_state = time_mix(h, p.tm, cfg, st.get("tm_shift"), st.get("wkv"))
    x = x + att
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    ffn, cm_shift = channel_mix(h, p.cm, st.get("cm_shift"))
    x = x + ffn
    return x, {"tm_shift": tm_shift, "cm_shift": cm_shift, "wkv": wkv_state}
