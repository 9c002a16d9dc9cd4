"""The encoder-decoder family: seamless-m4t-medium's backbone.

The counterpart of ``repro.models.encdec``.  The audio frontend (the
conformer feature extractor) is a stub, as in the JAX package: a batch's
``frames`` (B, S_enc, D) are the encoder's input.  The encoder is a stack
of bidirectional self-attention blocks (RoPE on the frame positions) and a
final norm; each decoder block runs causal self-attention, cross-attention
over the encoder's states and a plain MLP, each behind its own norm
(``ln1``, ``lnx``, ``ln2``).  Every attention call is one launch of the
``flash_attention`` kernel on the card: the encoder's non-causal over the
frames, the decoder's causal over its cache's valid prefix, and
cross-attention non-causal over every frame, with no RoPE and no softcap.
The JAX package cuts long queries into chunks (``attend_chunked`` under
``attn_chunk``); the kernel tiles queries itself at any S and T.

Decode: the self-attention cache grows with the tokens; the cross K/V
(``xk``, ``xv`` of ``(L, B, S_enc, K, hd)``) are written, in the cache's
dtype, by a forward that has the encoder's states (a prefill with frames)
and read back by one that has none.  The JAX package holds one stacked
leaf a name and scans it; the port holds one module a layer
(:class:`EncoderBlock` under ``enc.<layer>``, :class:`DecoderBlock` under
``blocks.<layer>``).  A forward that trains (grad on, weights that require
grad, no cache) with ``cfg.remat`` checkpoints each encoder and each
decoder block, as the JAX scan bodies are wrapped in ``jax.checkpoint``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention
from .common import ModelConfig, ParamFactory, mlp, rms_norm
from .transformer import DenseBlock, _write_state, add_attn_params, add_mlp_params, attn_sublayer


class EncoderBlock(DenseBlock):
    """One encoder layer's weights: the JAX ``enc.*`` leaves at one layer
    index (``ln1``, ``ln2``, the attention's and the MLP's: a dense block's)."""


class DecoderBlock(nn.Module):
    """One decoder layer's weights: the JAX ``blocks.*`` leaves at one layer
    index: the norms ``ln1``, ``lnx`` and ``ln2``, the self-attention's
    projections, the cross-attention's ``wq_x``, ``wk_x``, ``wv_x`` and
    ``wo_x`` (no biases, under ``qkv_bias`` too) and the MLP's."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__()
        for name in ("ln1", "lnx", "ln2"):
            setattr(self, name, f.new((cfg.d_model,), "zeros", axes=("embed",)))
        add_attn_params(self, f, cfg)
        D = cfg.d_model
        self.wq_x = f.new((D, cfg.qkv_dim), axes=("embed", "q_dim"))
        self.wk_x = f.new((D, cfg.kv_dim), axes=("embed", "kv_dim"))
        self.wv_x = f.new((D, cfg.kv_dim), axes=("embed", "kv_dim"))
        self.wo_x = f.new((cfg.qkv_dim, D), axes=("q_dim", "embed"))
        add_mlp_params(self, f, cfg)


class Encoder(nn.ModuleList):
    """The encoder's blocks (``enc.<layer>.*``) and its final norm
    (``enc.final_ln``)."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__(EncoderBlock(cfg, f) for _ in range(cfg.enc_layers))
        self.final_ln = f.new((cfg.d_model,), "zeros", axes=("embed",))


def _trains(cfg: ModelConfig, x: torch.Tensor, stack: nn.Module) -> bool:
    """Does a forward over ``stack`` record a graph that ``cfg.remat``
    checkpoints block by block?"""
    return cfg.remat and torch.is_grad_enabled() and (
        x.requires_grad or any(w.requires_grad for w in stack.parameters()))


# ------------------------------------------------------------------ encoder
def encoder_block(x: torch.Tensor, p: EncoderBlock, cfg: ModelConfig,
                  pos: torch.Tensor) -> torch.Tensor:
    a = rms_norm(x, p.ln1, cfg.norm_eps)
    x = x + attn_sublayer(a, p, cfg, pos=pos, cache=None, offset=0, causal=False)
    a = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + mlp(a, p.wi, getattr(p, "wg", None), p.wo2, cfg.act)


def encode(cfg: ModelConfig, enc: Encoder, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S_enc, D) frame embeddings -> (B, S_enc, D) encoder states."""
    pos = torch.arange(x.shape[1], device=x.device)
    remat = _trains(cfg, x, enc)
    for p in enc:
        x = (checkpoint(encoder_block, x, p, cfg, pos, use_reentrant=False) if remat
             else encoder_block(x, p, cfg, pos))
    return rms_norm(x, enc.final_ln, cfg.norm_eps)


# ----------------------------------------------------------- cross-attention
def cross_kv(cfg: ModelConfig, p: DecoderBlock,
             enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A layer's cross K/V, each (B, S_enc, K, hd), from the encoder's states."""
    b, t, _ = enc_out.shape
    return ((enc_out @ p.wk_x).reshape(b, t, cfg.n_kv_heads, cfg.head_dim),
            (enc_out @ p.wv_x).reshape(b, t, cfg.n_kv_heads, cfg.head_dim))


def cross_attend(h: torch.Tensor, p: DecoderBlock, cfg: ModelConfig, xk: torch.Tensor,
                 xv: torch.Tensor) -> torch.Tensor:
    """Cross-attention of ``h`` over the frames' K/V: position-free (no
    RoPE), never causal, no softcap; one ``flash_attention`` launch."""
    b, s, _ = h.shape
    q = (h @ p.wq_x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    out = flash_attention(q, xk.to(q.dtype), xv.to(q.dtype), causal=False)
    return out.reshape(b, s, -1) @ p.wo_x


# ------------------------------------------------------------------ decoder
def decoder_block(h: torch.Tensor, p: DecoderBlock, cfg: ModelConfig, *, pos: torch.Tensor,
                  xk: torch.Tensor, xv: torch.Tensor, cache: dict[str, torch.Tensor] | None,
                  offset: int, rows: torch.Tensor | None = None) -> torch.Tensor:
    """One decoder layer over the cross K/V ``xk``, ``xv``; the layer's
    ``k`` and ``v`` cache (if any) written in place (only batch ``rows``
    of it, when given)."""
    a = rms_norm(h, p.ln1, cfg.norm_eps)
    kv = None if cache is None else (cache["k"], cache["v"])
    h = h + attn_sublayer(a, p, cfg, pos=pos, cache=kv, offset=offset, rows=rows)
    a = rms_norm(h, p.lnx, cfg.norm_eps)
    h = h + cross_attend(a, p, cfg, xk, xv)
    a = rms_norm(h, p.ln2, cfg.norm_eps)
    return h + mlp(a, p.wi, getattr(p, "wg", None), p.wo2, cfg.act)


def decoder_layer(h: torch.Tensor, p: DecoderBlock, cfg: ModelConfig,
                  enc_out: torch.Tensor | None, pos: torch.Tensor,
                  cache: dict[str, torch.Tensor] | None = None, offset: int = 0,
                  rows: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX scan body: the layer's cross K/V from ``enc_out`` (and into
    the cache's ``xk``/``xv``, cast to its dtype, when there is a cache),
    or, without ``enc_out``, read back from the cache; then the block."""
    if enc_out is not None:
        xk, xv = cross_kv(cfg, p, enc_out)
        if cache is not None:
            _write_state(cache, {"xk": xk, "xv": xv}, rows)
    elif cache is None:
        raise ValueError("a decoder forward without the encoder's states needs the cache's "
                         "xk/xv")
    else:
        xk, xv = cache["xk"], cache["xv"]
    return decoder_block(h, p, cfg, pos=pos, xk=xk, xv=xv, cache=cache, offset=offset,
                         rows=rows)


def run_decoder(cfg: ModelConfig, blocks: nn.ModuleList, x: torch.Tensor, *,
                enc_out: torch.Tensor | None, pos: torch.Tensor,
                caches: dict[str, torch.Tensor] | None = None, offset: int = 0,
                rows: torch.Tensor | None = None) -> torch.Tensor:
    """The decoder stack over token embeddings ``x`` (B, S, D): ``enc_out``
    the encoder's states (B, S_enc, D), or None to read the cross K/V from
    ``caches`` (``init_kv_cache``'s ``(L, B, ...)`` leaves ``k``, ``v``,
    ``xk``, ``xv``, updated in place)."""
    remat = caches is None and _trains(cfg, x, blocks)
    for layer, p in enumerate(blocks):
        if remat:
            x = checkpoint(decoder_layer, x, p, cfg, enc_out, pos, use_reentrant=False)
        else:
            cache = (None if caches is None
                     else {name: leaf[layer] for name, leaf in caches.items()})
            x = decoder_layer(x, p, cfg, enc_out, pos, cache, offset, rows)
    return x
