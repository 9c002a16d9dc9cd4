"""Shared model substrate: config, parameter factory, norms, MLP, RoPE.

The counterpart of ``repro.models.common``.  The JAX package keeps the
weights in a flat dict with a stacked leading layer axis; the port keeps
them in ``nn.Module``s, one per block (``repro_torch.models.zoo.LM``), and
fills each leaf from its own generator stream.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

VOCAB_PAD_MULTIPLE = 2048  # the JAX package's pad (16-way vocab shards)


def pad_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


@dataclass(frozen=True)
class ModelConfig:
    """One architecture; the fields of ``repro.models.common.ModelConfig``,
    with ``dtype`` a ``torch.dtype``.  The port runs the dense, moe, rwkv
    and hybrid families (``repro_torch.models.zoo.LM`` refuses what it does not
    run yet)."""

    name: str = "tiny"
    family: str = "dense"  # dense | moe | rwkv | hybrid | encdec
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 256
    vocab: int = 512
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    window: int | None = None  # sliding-window size for local layers
    global_every: int = 0  # k>0: every k-th layer is global, rest local
    norm_eps: float = 1e-6
    act: str = "silu"  # silu | gelu
    mlp_gated: bool = True  # SwiGLU/GeGLU (3 mats) vs plain act-MLP (2 mats)
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    topk: int = 0
    # recurrent state
    ssm_state: int = 0
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 0
    ssm_chunk: int = 0
    # encoder-decoder
    enc_layers: int = 0
    # stub modality frontend
    frontend: str | None = None  # None | "patch" | "audio"
    # numerics / training
    dtype: Any = torch.bfloat16
    embed_mult: float = 1.0  # gemma multiplies embeddings by sqrt(d_model)
    # remat and microbatch shape the train step (run_blocks, make_train_step).
    # c2d_embedding picks, as the JAX model does, the embedding (with a mesh
    # that has a model axis: the vocab-sharded c2d lookup; else the plain
    # take) and an MoE block's dispatch (on: the capacity buffer, or the
    # all_to_all with a mesh; off: every expert over every token).  Kept so the configs equal the JAX
    # package's field for field, and read nowhere in the port: attn_chunk
    # (the JAX einsum attention's q-chunk; the flash kernel tiles queries
    # itself).
    remat: bool = True
    c2d_embedding: bool = True
    attn_chunk: int = 0
    microbatch: int = 1

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def layer_is_global(self, i: int) -> bool:
        if self.global_every <= 0:
            return True
        return (i % self.global_every) == (self.global_every - 1)


# ------------------------------------------------------------------ factory
class ParamFactory:
    """Makes the parameters leaf by leaf: truncated normal in [-2, 2] times
    ``1/sqrt(fan_in)`` (or ``scale``), zeros, ones, or the constant
    ``scale`` (``const``), as the JAX factory does.  Each normal leaf draws
    from its own generator on ``device``, seeded from a host stream keyed by
    ``seed``, so a leaf never exists in f32 on the host when the weights
    live on the card.  With
    ``fill=False`` the leaves are left uninitialised (weights copied in)."""

    def __init__(self, seed: int, dtype: torch.dtype, device: torch.device, fill: bool = True):
        self.dtype = dtype
        self.device = torch.device(device)
        self.fill = fill
        self._keys = torch.Generator().manual_seed(seed)

    def _next(self) -> torch.Generator:
        sub = int(torch.randint(0, 2**62, (1,), generator=self._keys))
        return torch.Generator(self.device).manual_seed(sub)

    def new(
        self, shape: tuple[int, ...], init: str = "normal", scale: float | None = None,
        axes: tuple[str | None, ...] | None = None,
    ) -> nn.Parameter:
        """A leaf of ``shape``; ``axes``, its logical axes one a dim (the JAX
        factory's, without the stacked ``layers`` axis), are kept on the
        parameter as ``logical_axes`` for the partition rules."""
        if axes is not None and len(axes) != len(shape):
            raise ValueError(f"ParamFactory: a leaf of shape {shape} takes one logical axis "
                             f"a dim, got {axes!r}")
        if init not in ("normal", "zeros", "ones", "const"):
            raise ValueError(f"ParamFactory has no init {init!r}")
        if init == "const" and scale is None:
            raise ValueError("ParamFactory: init 'const' fills with scale, which is None")
        arr = torch.empty(shape, dtype=self.dtype, device=self.device)
        if not self.fill:
            pass
        elif init == "zeros":
            arr.zero_()
        elif init == "ones":
            arr.fill_(1.0)
        elif init == "const":
            arr.fill_(scale)
        else:  # truncated-normal fan-in scaling, drawn in f32
            if scale is None:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            draw = arr if self.dtype == torch.float32 else torch.empty(
                shape, dtype=torch.float32, device=self.device
            )
            nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=self._next())
            draw.mul_(scale)
            if draw is not arr:
                arr.copy_(draw)
        leaf = nn.Parameter(arr, requires_grad=False)
        leaf.logical_axes = None if axes is None else tuple(axes)
        return leaf


# ------------------------------------------------------------------- layers
def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + gain.float())).to(dt)


def rms_norm_serve(x: torch.Tensor, gain: torch.Tensor, eps: float, lay) -> torch.Tensor:
    """:func:`rms_norm` of an embed-cut ``x`` (every row's slice of the
    embed dim, a serving :class:`~repro_torch.sharding.partition.Layout`'s
    residual stream) with the gain's matching block: the rows' sums of
    squares summed over the data axes, the gain never moved."""
    dt = x.dtype
    x = x.float()
    ss = lay.sum_data(torch.sum(x * x, dim=-1, keepdim=True))
    x = x * torch.rsqrt(ss / (x.shape[-1] * lay.dn) + eps)
    return (x * (1.0 + gain.float())).to(dt)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def activation(h: torch.Tensor, act: str) -> torch.Tensor:
    """The MLP's activation: silu, or gelu in its tanh form (``jax.nn.gelu``'s
    default)."""
    return F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")


def mlp(
    x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor | None, wo: torch.Tensor, act: str
) -> torch.Tensor:
    """SwiGLU when wg is present, plain act-MLP otherwise."""
    a = activation(x @ wi, act)
    if wg is not None:
        a = a * (x @ wg)
    return a @ wo


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings on INTERLEAVED pairs ``(x[..., 0::2], x[..., 1::2])``,
    as the JAX package rotates them (not the half-split ``rotate_half``).
    x: [..., seq, heads, head_dim], positions: [..., seq]."""
    hd = x.shape[-1]
    freqs = 1.0 / (
        theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    )
    ang = positions[..., :, None].float() * freqs  # [..., seq, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------- loss
def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, vocab: int, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean NLL over valid positions (f32); padded-vocab slots are masked to
    -1e9 (the LM head produces garbage logits there)."""
    v = logits.shape[-1]
    if v > vocab:
        pad = torch.arange(v, device=logits.device) >= vocab
        logits = logits.masked_fill(pad, -1e9)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
