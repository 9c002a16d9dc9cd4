"""RWKV6 "Finch": attention-free time mixing with data-dependent decay.

The counterpart of ``repro.models.rwkv``.  Per head (head size M, state
S in R^{M x M}) the time mix runs the recurrence

    out_t = r_t^T (S_t + diag(u) k_t v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T

with the per-channel, per-step decay ``w_t = exp(-exp(w0 + tanh(x_w A) B))``
(a low-rank data-dependent function of the shifted input).  Every WKV call,
a prompt of T > 1 tokens or one decode step, is one call of the ``wkv6``
wrapper (``repro_torch.kernels.wkv6``): one launch of the hand-written
kernel on the card, the plain recurrence on the CPU.  In training the same
call goes through the wrapper's autograd ``Function``, whose gradient is
one launch of the hand-written ``wkv6_bwd`` kernel on the card (the plain
backward on the CPU).  The JAX model's jnp
``wkv6_chunked`` (its CPU and dry-run rendering of the chunked kernel) has
no counterpart: it clamps the within-chunk log-decay (ROADMAP.md section 3)
and the kernel is exact without it.

On a mesh (:func:`rwkv_block_tp`) the block follows its leaves' specs:
where the heads divide ``model``, the r, k, v and g projections by
columns (the rank's heads), ``wkv6`` on those heads, the per-head group
norm and ``ln_x`` local, ``wo`` by rows and one psum; the token shift and
the decay's LoRA stay whole on every rank, the decay cut to the rank's
channels.  The channel mix cuts ``ffn`` and, with the heads, its gate's
columns.

On a serving layout (:func:`rwkv_block_serve`) the block carries its
state.  Its input is embed-cut (every row's slice of the embed dim), so the
token shift, the mixes with ``mu_*`` and the decay's LoRA run on the rank's
slice with its blocks of those leaves; the carried shifts are the rank's
rows with the whole embed dim and go to and from the embed cut by an
all-to-all over ``data``.  The r, k, v and g products are summed over
``data`` to the rank's rows; ``wkv6`` runs on the rank's heads and its
block of the ``wkv`` state where the heads divide ``model``, else (the
rule cuts the columns mid-head) on every head, the columns gathered.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.wkv6 import wkv6
from ..sharding.mesh import (
    copy_to_region, gather_from_region, reduce_from_region, reduce_scatter_to_region,
    scatter_to_region,
)
from .common import ModelConfig, ParamFactory, rms_norm, rms_norm_serve

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
            setattr(self, mu, f.new((D,), "zeros", axes=("embed",)))
        self.w0 = f.new((D,), "zeros", axes=("embed",))
        self.wA = f.new((D, LORA_DIM), axes=("embed", None))
        self.wB = f.new((LORA_DIM, D), axes=(None, "embed"))
        self.u = f.new((D // m, m), "zeros", axes=("heads", None))
        for w in ("wr", "wk", "wv", "wg"):
            setattr(self, w, f.new((D, D), axes=("embed", "q_dim")))
        self.wo = f.new((D, D), axes=("q_dim", "embed"))
        self.ln_x = f.new((D,), "zeros", axes=("q_dim",))


class ChannelMix(nn.Module):
    """The ``cm.*`` leaves of one layer."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__()
        D, F_ = cfg.d_model, cfg.d_ff
        self.mu_k = f.new((D,), "zeros", axes=("embed",))
        self.mu_r = f.new((D,), "zeros", axes=("embed",))
        self.wk = f.new((D, F_), axes=("embed", "ffn"))
        self.wv = f.new((F_, D), axes=("ffn", "embed"))
        self.wr = f.new((D, D), axes=("embed", "q_dim"))


class RWKVBlock(nn.Module):
    """One layer's weights: the JAX ``blocks.*`` leaves of
    ``add_rwkv_block_params`` at one layer index (``blocks.tm.mu_r`` is
    ``blocks.<layer>.tm.mu_r`` here)."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__()
        self.ln1 = f.new((cfg.d_model,), "zeros", axes=("embed",))
        self.ln2 = f.new((cfg.d_model,), "zeros", axes=("embed",))
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


# ------------------------------------------------------ on a mesh (training)
def _group_norm(out: torch.Tensor, b: int, t: int) -> torch.Tensor:
    mean = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, unbiased=False)
    return ((out - mean) * torch.rsqrt(var + 64e-5)).reshape(b, t, -1)


def time_mix_tp(x: torch.Tensor, p: TimeMix, cfg: ModelConfig, lay) -> torch.Tensor:
    """:func:`time_mix` (no state) on this rank's heads when ``tm.wr``'s
    columns are cut over ``model``, else on every head."""
    if not lay.split("tm.wr", 1):
        return time_mix(x, p, cfg)[0]
    mesh = lay.mesh
    b, t, _ = x.shape
    m = cfg.rwkv_head_dim
    xx = token_shift(x, None) - x
    xr, xk, xv, xw, xg = (x + xx * mu for mu in (p.mu_r, p.mu_k, p.mu_v, p.mu_w, p.mu_g))
    dd = torch.tanh(xw @ p.wA) @ p.wB
    w = scatter_to_region(torch.exp(-torch.exp((p.w0 + dd).float())), mesh, "model", dim=-1)
    r, k, v, g = (copy_to_region(a, mesh) @ wt
                  for a, wt in ((xr, p.wr), (xk, p.wk), (xv, p.wv), (xg, p.wg)))
    hl = r.shape[-1] // m
    g = g * torch.sigmoid(g)
    out, _ = wkv6(*(a.reshape(b, t, hl, m) for a in (r, k, v, w)), p.u, None)
    out = _group_norm(out, b, t) * (1.0 + p.ln_x)
    return reduce_from_region((out.to(x.dtype) * g) @ p.wo, mesh)


def channel_mix_tp(x: torch.Tensor, p: ChannelMix, lay) -> torch.Tensor:
    """:func:`channel_mix` (no state) on this rank's ``ffn`` columns and,
    where its columns are cut, the gate's: the value reduce-scattered to
    the gate's channels, the product gathered back."""
    mesh = lay.mesh
    xx = token_shift(x, None) - x
    xk = x + xx * p.mu_k
    xr = x + xx * p.mu_r
    ffn = lay.split("cm.wk", 1)
    kk = torch.square(torch.relu((copy_to_region(xk, mesh) if ffn else xk) @ p.wk))
    val = kk @ p.wv  # partial over model when ffn is cut
    if not lay.split("cm.wr", 1):
        return torch.sigmoid(xr @ p.wr) * (reduce_from_region(val, mesh) if ffn else val)
    gate = torch.sigmoid(copy_to_region(xr, mesh) @ p.wr)
    val = (reduce_scatter_to_region(val, mesh, "model", dim=-1) if ffn
           else scatter_to_region(val, mesh, "model", dim=-1))
    return gather_from_region(gate * val, mesh, "model", dim=-1)


def rwkv_block_tp(x: torch.Tensor, p: RWKVBlock, cfg: ModelConfig, lay) -> torch.Tensor:
    """:func:`rwkv_block` (no state) on this rank's weights."""
    x = x + time_mix_tp(rms_norm(x, p.ln1, cfg.norm_eps), p.tm, cfg, lay)
    return x + channel_mix_tp(rms_norm(x, p.ln2, cfg.norm_eps), p.cm, lay)


# ------------------------------------------------------- on a mesh (serving)
def _time_mix_serve(x, p: TimeMix, cfg: ModelConfig, lay, shift_prev, wkv_state):
    """:func:`time_mix` of an embed-cut ``x`` from the rank's state blocks:
    ``(y embed-cut, the new shift (its rows), the new WKV state block)``."""
    n, t, _ = x.shape
    m = cfg.rwkv_head_dim
    xx = token_shift(x, lay.rows_to_embed(shift_prev, n)) - x
    xr, xk, xv, xw, xg = (x + xx * mu for mu in (p.mu_r, p.mu_k, p.mu_v, p.mu_w, p.mu_g))
    dd = torch.tanh(lay.sum_data(xw @ p.wA)) @ p.wB
    w = lay.embed_to_rows(torch.exp(-torch.exp((p.w0 + dd).float())), n)  # rows, every channel
    r, k, v, g = lay.sum_rows_parts(xr @ p.wr, xk @ p.wk, xv @ p.wv, xg @ p.wg)
    heads, cols = lay.split("tm.u", 0), lay.split("tm.wr", 1)
    if heads:  # the rank's heads: its channels of the decay
        w = lay.model_block(w)
    elif cols:  # the columns cut mid-head: every head on every rank
        r, k, v = lay.gather_model_parts(r, k, v)
    b, hl = r.shape[0], r.shape[-1] // m
    g = g * torch.sigmoid(g)
    out, wkv_state = wkv6(*(a.reshape(b, t, hl, m).contiguous() for a in (r, k, v, w)), p.u,
                          wkv_state)
    out = _group_norm(out, b, t)
    if cols and not heads:
        out = lay.model_block(out)
    out = out * (1.0 + p.ln_x)
    y = lay.all_rows(out.to(x.dtype) * g, n) @ p.wo
    return (lay.sum_model(y) if lay.split("tm.wo", 0) else y,
            lay.embed_to_rows(x[:, -1:], n), wkv_state)


def _channel_mix_serve(x, p: ChannelMix, lay, shift_prev):
    """:func:`channel_mix` of an embed-cut ``x``: ``(y embed-cut, the new
    shift (its rows))``."""
    n = x.shape[0]
    xx = token_shift(x, lay.rows_to_embed(shift_prev, n)) - x
    xk = x + xx * p.mu_k
    xr = x + xx * p.mu_r
    val = torch.square(torch.relu(lay.sum_data(xk @ p.wk))) @ p.wv
    if lay.split("cm.wk", 1):
        val = lay.sum_model(val)
    gate = torch.sigmoid(lay.sum_data(xr @ p.wr))  # every row, the rank's columns
    if lay.split("cm.wr", 1):
        gate = lay.gather_model(gate)
    return lay.embed_slice(gate) * val, lay.embed_to_rows(x[:, -1:], n)


def rwkv_block_serve(x: torch.Tensor, p: RWKVBlock, cfg: ModelConfig, lay,
                     state: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict]:
    """:func:`rwkv_block` on a serving layout: ``x`` embed-cut, ``state``
    the rank's blocks of the layer's ``tm_shift``, ``cm_shift`` (its rows,
    the whole embed dim) and ``wkv`` (its rows, its heads where
    ``cache_specs`` cuts them); returns the block's output and the new
    state blocks."""
    att, tm_shift, wkv_state = _time_mix_serve(rms_norm_serve(x, p.ln1, cfg.norm_eps, lay),
                                               p.tm, cfg, lay, state["tm_shift"], state["wkv"])
    x = x + att
    ffn, cm_shift = _channel_mix_serve(rms_norm_serve(x, p.ln2, cfg.norm_eps, lay), p.cm, lay,
                                       state["cm_shift"])
    return x + ffn, {"tm_shift": tm_shift, "cm_shift": cm_shift, "wkv": wkv_state}
