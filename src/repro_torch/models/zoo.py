"""Model zoo: build the weights, forward, and the prefill/serve steps.

The counterpart of ``repro.models.zoo`` for the dense, rwkv and hybrid
families:

* ``build_params(cfg, seed, device=...)``   -> ``LM`` (weights on the device)
* ``from_jax_params(cfg, flat, device=...)`` -> ``LM`` holding the JAX
  package's flat weights (``"blocks.wq"`` stacked ``(L, D, q_dim)`` and so on)
* ``make_batch(cfg, shape, seed)``          -> random token batch (numpy seed)
* ``init_kv_cache(cfg, batch, t_max)``      -> dense ``{"k", "v"}``, ``(L, B, T, K, hd)``;
  rwkv ``{"tm_shift", "cm_shift", "wkv"}``; hybrid ``{"k", "v", "conv", "h"}``
* ``make_prefill_step(cfg)``                -> (model, batch) -> (logits, cache)
* ``make_serve_step(cfg)``                  -> (model, cache, tok, pos) -> (logits, cache)

PyTorch runs eagerly, so the steps are plain functions (the JAX package
jits them).  Caches are written in place and returned for symmetry.
Every entry point that makes tensors takes ``device``: ``None`` means the
card, and raises without one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from ..core.bitcode import resolve_device
from .common import ModelConfig, ParamFactory, rms_norm, softcap
from .embedding import embed_plain, lm_head
from .rwkv import RWKVBlock
from .ssm import CONV_K
from .transformer import DenseBlock, HybridBlock, require_ported, run_blocks


# ------------------------------------------------------------------- shapes
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode



# ------------------------------------------------------------------- params
class LM(nn.Module):
    """A decoder LM's weights; parameter names follow the JAX flat dict
    (``embed.tok``, ``blocks.<layer>.wq``, ``blocks.<layer>.tm.wr`` or
    ``blocks.<layer>.ssm.w_in``, ``final_ln``, ``head.w``)."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__()
        require_ported(cfg)
        self.embed = nn.Module()
        self.embed.tok = f.new((cfg.vocab_padded, cfg.d_model), scale=0.02)
        block = {"rwkv": RWKVBlock, "hybrid": HybridBlock}.get(cfg.family, DenseBlock)
        self.blocks = nn.ModuleList(block(cfg, f) for _ in range(cfg.n_layers))
        self.final_ln = f.new((cfg.d_model,), "zeros")
        if not cfg.tie_embeddings:
            self.head = nn.Module()
            self.head.w = f.new((cfg.d_model, cfg.vocab_padded))

    @property
    def device(self) -> torch.device:
        return self.final_ln.device


def build_params(
    cfg: ModelConfig, seed: int = 0, device: "torch.device | str | None" = None
) -> LM:
    """Random weights from ``seed``, drawn on ``device`` in ``cfg.dtype``."""
    return LM(cfg, ParamFactory(seed, cfg.dtype, resolve_device(device)))


def from_jax_params(
    cfg: ModelConfig, flat: dict[str, np.ndarray], device: "torch.device | str | None" = None
) -> LM:
    """An ``LM`` in ``cfg.dtype`` holding the JAX package's weights: ``flat``
    is its flat dict as numpy arrays (f32 or a dtype torch reads); stacked
    ``blocks.*`` leaves are sliced along their leading layer axis."""
    dev = resolve_device(device)
    model = LM(cfg, ParamFactory(0, cfg.dtype, dev, fill=False))
    want = dict(model.named_parameters())
    seen = set()
    for key, arr in flat.items():
        arr = torch.tensor(np.asarray(arr))
        if key.startswith("blocks."):
            leaf = key[len("blocks."):]
            names = [f"blocks.{layer}.{leaf}" for layer in range(cfg.n_layers)]
            parts = list(arr)
        else:
            names, parts = [key], [arr]
        for name, part in zip(names, parts):
            if name not in want:
                raise KeyError(f"from_jax_params: {key!r} has no counterpart in the port")
            if tuple(part.shape) != tuple(want[name].shape):
                raise ValueError(
                    f"from_jax_params: {name} is {tuple(part.shape)}, want "
                    f"{tuple(want[name].shape)}"
                )
            want[name].copy_(part)
            seen.add(name)
    missing = sorted(set(want) - seen)
    if missing:
        raise KeyError(f"from_jax_params: no JAX leaf for {missing}")
    return model


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# ------------------------------------------------------------------ forward
def _head(cfg: ModelConfig, model: LM, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, model.final_ln, cfg.norm_eps)
    w = model.embed.tok.T if cfg.tie_embeddings else model.head.w
    return softcap(lm_head(h, w), cfg.final_softcap)


def forward(
    cfg: ModelConfig,
    model: LM,
    batch: dict[str, torch.Tensor],
    *,
    caches: dict[str, torch.Tensor] | None = None,
    offset: int | None = None,
    rows: torch.Tensor | None = None,
    return_hidden: bool = False,
):
    """Returns (logits, caches, aux_loss); ``caches`` is updated in place
    (only batch ``rows`` of it, when given).  ``batch["token_rows"]``, when
    present, holds embedding rows gathered elsewhere (the serving tier's
    remote embedding) and bypasses the table lookup."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    if "token_rows" in batch:
        x = batch["token_rows"].to(cfg.dtype)
    else:
        x = embed_plain(model.embed.tok, tokens)
    if cfg.embed_mult != 1.0:
        x = (x.float() * cfg.embed_mult).to(x.dtype)
    off = 0 if offset is None else int(offset)
    pos = off + torch.arange(s, device=x.device)
    h = run_blocks(cfg, model.blocks, x, pos=pos, caches=caches, offset=off, rows=rows)
    if return_hidden:
        return h, caches, 0.0
    return _head(cfg, model, h), caches, 0.0


# ----------------------------------------------------------------- KV cache
def init_kv_cache(
    cfg: ModelConfig, batch: int, t_max: int, dtype: torch.dtype = torch.bfloat16,
    device: "torch.device | str | None" = None,
) -> dict[str, torch.Tensor]:
    """The dense family's cache: ``k`` and ``v`` of ``(L, B, T, K, hd)``.
    The rwkv family's state, whatever ``t_max``: ``tm_shift`` and
    ``cm_shift`` of ``(L, B, 1, D)`` in ``dtype`` and ``wkv`` of
    ``(L, B, H, M, M)`` in f32.  The hybrid family's: ``k`` and ``v``, the
    SSM head's ``conv`` of ``(L, B, K-1, D)`` in ``dtype`` and ``h`` of
    ``(L, B, D, N)`` in f32."""
    require_ported(cfg)
    dev = resolve_device(device)
    if cfg.family == "rwkv":
        L, D, m = cfg.n_layers, cfg.d_model, cfg.rwkv_head_dim
        return {
            "tm_shift": torch.zeros((L, batch, 1, D), dtype=dtype, device=dev),
            "cm_shift": torch.zeros((L, batch, 1, D), dtype=dtype, device=dev),
            "wkv": torch.zeros((L, batch, D // m, m, m), dtype=torch.float32, device=dev),
        }
    shape = (cfg.n_layers, batch, t_max, cfg.n_kv_heads, cfg.head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
    }
    if cfg.family == "hybrid":
        L, D = cfg.n_layers, cfg.d_model
        cache["conv"] = torch.zeros((L, batch, CONV_K - 1, D), dtype=dtype, device=dev)
        cache["h"] = torch.zeros((L, batch, D, cfg.ssm_state), dtype=torch.float32, device=dev)
    return cache


def make_batch(
    cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
    device: "torch.device | str | None" = None,
) -> dict[str, torch.Tensor]:
    """Random prompt tokens of a prefill shape, from the numpy seed the JAX
    package uses (so both packages see the same tokens)."""
    if shape.kind != "prefill":
        raise NotImplementedError(f"make_batch: {shape.kind} batches are not ported yet")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (shape.global_batch, shape.seq_len)).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens).to(resolve_device(device))}


# -------------------------------------------------------------------- steps
def make_prefill_step(cfg: ModelConfig) -> Callable:
    """Fill a prompt-length cache (the recurrent state) from the prompt;
    logits for the last token."""

    def prefill_step(model: LM, batch: dict):
        b, s = batch["tokens"].shape
        cache = init_kv_cache(cfg, b, s, dtype=cfg.dtype, device=model.device)
        h, cache, _ = forward(cfg, model, batch, caches=cache, offset=0, return_hidden=True)
        # head over the LAST position only
        logits = _head(cfg, model, h[:, -1:, :])
        return logits[:, -1, :], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One decode step: next-token logits, the cache written at ``pos`` (the
    rwkv state replaced).

    The one step covers both of the JAX package's variants: given
    ``token_rows`` (``(B, S, D)``, the tokens' embedding rows gathered by
    :class:`repro_torch.runtime.tenancy.RemoteEmbedClient`), it takes them
    instead of looking the tokens up (the serving-tier mode).  ``rows``
    (keyword) limits the cache write to those batch rows (every state leaf
    of an rwkv or hybrid cache too), for a scheduler that decodes one
    position group at a time."""

    def serve_step(
        model: LM, cache: Any, tokens: torch.Tensor, pos: int,
        token_rows: torch.Tensor | None = None, *, rows: torch.Tensor | None = None,
    ):
        batch = {"tokens": tokens}
        if token_rows is not None:
            batch["token_rows"] = token_rows
        logits, cache, _ = forward(cfg, model, batch, caches=cache, offset=pos, rows=rows)
        return logits[:, -1, :], cache

    return serve_step
