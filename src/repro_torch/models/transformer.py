"""The decoder stack: dense blocks (GQA attention + SwiGLU MLP), RWKV6
blocks and hybrid blocks (parallel GQA attention + SSM heads, then the
MLP).

The counterpart of the dense, rwkv and hybrid families of
``repro.models.transformer``.  The JAX package stacks layers on a leading
axis and scans them; the port holds one block module per layer and loops
over them.  The same ``run_blocks`` serves a full sequence (no cache),
prefill (cache written from offset 0) and decode (cache written at the
offset).  Attention is one launch of the ``flash_attention`` kernel on the
card, over the cache's valid prefix, with the layer's sliding window (0 on
global layers); an RWKV block's WKV is one launch of the ``wkv6`` kernel
and a hybrid block's scan one of ``ssm_scan``, each from the layer's
state.  The MoE and encoder-decoder families wait for their slices
(ROADMAP.md section 1).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kernels.flash_attention import flash_attention
from .attention import qkv_proj, update_kv_cache
from .common import ModelConfig, ParamFactory, mlp, rms_norm, rope
from .rwkv import RWKVBlock, rwkv_block
from .ssm import SSMHead, ssm_head


def require_ported(cfg: ModelConfig) -> None:
    """Refuse what the port's stack does not run yet, naming its slice."""
    if cfg.family not in ("dense", "rwkv", "hybrid") or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP.md section 1)"
        )
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: modality frontends are not ported yet (ROADMAP.md)")


# ----------------------------------------------------------------- params
def add_attn_params(m: nn.Module, f: ParamFactory, cfg: ModelConfig) -> None:
    D = cfg.d_model
    m.wq = f.new((D, cfg.qkv_dim))
    m.wk = f.new((D, cfg.kv_dim))
    m.wv = f.new((D, cfg.kv_dim))
    m.wo = f.new((cfg.qkv_dim, D))
    if cfg.qkv_bias:
        m.bq = f.new((cfg.qkv_dim,), "zeros")
        m.bk = f.new((cfg.kv_dim,), "zeros")
        m.bv = f.new((cfg.kv_dim,), "zeros")


def add_mlp_params(m: nn.Module, f: ParamFactory, cfg: ModelConfig) -> None:
    D, F = cfg.d_model, cfg.d_ff
    m.wi = f.new((D, F))
    if cfg.mlp_gated:
        m.wg = f.new((D, F))
    m.wo2 = f.new((F, D))


def add_block_params(m: nn.Module, f: ParamFactory, cfg: ModelConfig) -> None:
    m.ln1 = f.new((cfg.d_model,), "zeros")
    m.ln2 = f.new((cfg.d_model,), "zeros")
    add_attn_params(m, f, cfg)
    add_mlp_params(m, f, cfg)


class DenseBlock(nn.Module):
    """One layer's weights: the JAX ``blocks.*`` leaves at one layer index."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__()
        add_block_params(self, f, cfg)


class HybridBlock(DenseBlock):
    """A dense block's leaves plus the SSM head (``blocks.ssm.*``) and the
    two per-channel mixing gains ``beta_attn`` and ``beta_ssm``."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__(cfg, f)
        self.ssm = SSMHead(cfg, f)
        self.beta_attn = f.new((cfg.d_model,), "ones")
        self.beta_ssm = f.new((cfg.d_model,), "ones")


# ------------------------------------------------------------- sublayers
def attn_sublayer(
    x: torch.Tensor,
    p: DenseBlock,
    cfg: ModelConfig,
    *,
    pos: torch.Tensor,  # (S,) absolute positions of x's tokens
    cache: tuple[torch.Tensor, torch.Tensor] | None,  # (B, T, K, hd) each, written in place
    offset: int,
    rows: torch.Tensor | None = None,  # batch rows whose cache is written
    window: int = 0,  # 0: global attention
) -> torch.Tensor:
    q, k, v = qkv_proj(
        x, p.wq, p.wk, p.wv, getattr(p, "bq", None), getattr(p, "bk", None),
        getattr(p, "bv", None), n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
    )
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    s = x.shape[1]
    if cache is not None:
        k_cache, v_cache = cache
        update_kv_cache(k_cache, v_cache, k, v, offset, rows)
        if offset != 0 or k_cache.dtype != k.dtype:
            # the cache's valid prefix, a strided view: end-aligned causal
            # masking over it is the JAX mask k_pos <= q_pos, k_pos < offset+S
            # (and the window's q_pos - k_pos < window)
            k = k_cache[:, : offset + s].to(q.dtype)
            v = v_cache[:, : offset + s].to(q.dtype)
        # else prefill from offset 0: the fresh K/V are that prefix
    out = flash_attention(q, k, v, causal=True, softcap=cfg.attn_softcap, window=window)
    return out.reshape(*x.shape[:2], -1) @ p.wo


def _write_state(
    cache: dict[str, torch.Tensor], new: dict[str, torch.Tensor], rows: torch.Tensor | None
) -> None:
    """Replace the state leaves of ``cache`` by ``new``, only batch ``rows``
    of them when given."""
    for name, leaf in new.items():
        if rows is None:
            cache[name].copy_(leaf)
        else:
            cache[name][rows] = leaf[rows].to(cache[name].dtype)


def block_apply(
    x: torch.Tensor,
    p: DenseBlock | RWKVBlock | HybridBlock,
    cfg: ModelConfig,
    *,
    pos: torch.Tensor,
    cache: dict[str, torch.Tensor] | None,
    offset: int,
    rows: torch.Tensor | None = None,
    window: int = 0,
) -> torch.Tensor:
    """One decoder block; the cache (if any) is updated in place, only
    batch ``rows`` of it when given.  A dense block's cache is its layer's
    ``k`` and ``v``; an RWKV block's its layer's ``tm_shift``, ``cm_shift``
    and ``wkv`` state, which the block reads and replaces; a hybrid
    block's ``k`` and ``v`` and the SSM head's ``conv`` and ``h`` state."""
    if cfg.family == "rwkv":
        x, new = rwkv_block(x, p, cfg, cache)
        if cache is not None:
            _write_state(cache, new, rows)
        return x
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    kv = None if cache is None else (cache["k"], cache["v"])
    att = attn_sublayer(h, p, cfg, pos=pos, cache=kv, offset=offset, rows=rows, window=window)
    if cfg.family == "hybrid":
        state = None if cache is None else {"conv": cache["conv"], "h": cache["h"]}
        out, new = ssm_head(h, p.ssm, cfg, state)
        att = 0.5 * (att * p.beta_attn + out * p.beta_ssm)
        if cache is not None:
            _write_state(cache, new, rows)
    x = x + att
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + mlp(h, p.wi, getattr(p, "wg", None), p.wo2, cfg.act)


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer window sizes: 0 = global attention."""
    w = np.zeros(cfg.n_layers, np.int32)
    if cfg.window and cfg.global_every > 0:
        for i in range(cfg.n_layers):
            if not cfg.layer_is_global(i):
                w[i] = cfg.window
    elif cfg.window:
        w[:] = cfg.window
    return w


def run_blocks(
    cfg: ModelConfig,
    blocks: nn.ModuleList,
    x: torch.Tensor,
    *,
    pos: torch.Tensor,
    caches: dict[str, torch.Tensor] | None = None,  # (L, B, ...) leaves, init_kv_cache's
    offset: int = 0,
    rows: torch.Tensor | None = None,
) -> torch.Tensor:
    windows = layer_windows(cfg)
    for layer, p in enumerate(blocks):
        cache = None if caches is None else {name: leaf[layer] for name, leaf in caches.items()}
        x = block_apply(x, p, cfg, pos=pos, cache=cache, offset=offset, rows=rows,
                        window=int(windows[layer]))
    return x
