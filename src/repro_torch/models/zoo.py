"""Model zoo: build the weights, forward, and the prefill/serve steps.

The counterpart of ``repro.models.zoo`` for the dense, moe, rwkv, hybrid
and encdec families:

* ``build_params(cfg, seed, device=...)``   -> ``LM`` (weights on the device)
* ``from_jax_params(cfg, flat, device=...)`` -> ``LM`` holding the JAX
  package's flat weights (``"blocks.wq"`` stacked ``(L, D, q_dim)``, an
  encoder's ``"enc.wq"`` over its ``enc_layers``, and so on)
* ``to_jax_params(cfg, named)``             -> the JAX flat dict of an ``LM`` (or of a
  dict keyed by its parameter names, such as AdamW's moments): the inverse of
  ``from_jax_params``
* ``make_batch(cfg, shape, seed)``          -> random token batch (numpy seed); a
  ``train`` shape adds ``labels`` and ``mask``, a ``patch`` frontend
  ``patch_embeds`` (``frontend_len(cfg, seq_len)`` of them, which overwrite
  the first positions in ``forward`` and carry no loss), an ``audio`` one
  ``frames`` (as many, the encoder's input; the train mask is 0 on as many
  first positions, as JAX's is)
* ``init_kv_cache(cfg, batch, t_max, mesh=None, enc_len=0)`` -> dense and moe
  ``{"k", "v"}``, ``(L, B, T, K, hd)``; rwkv ``{"tm_shift", "cm_shift", "wkv"}``;
  hybrid ``{"k", "v", "conv", "h"}``; encdec ``{"k", "v", "xk", "xv"}`` (the
  cross K/V ``(L, B, enc_len, K, hd)``); with a ``mesh``, this rank's blocks
  (:class:`CacheBlocks`, under ``cache_specs``)
* ``make_prefill_step(cfg, mesh=None, t_max=None)`` -> (model, batch) -> (logits, cache);
  an encoder-decoder's batch must carry ``frames``, as JAX's step requires
* ``make_serve_step(cfg, mesh=None)``       -> (model, cache, tok, pos) -> (logits, cache)
* ``loss_fn(cfg, model, batch)``            -> (loss, {"nll", "aux"}), the head and
  softmax cross-entropy in ``LOSS_CHUNK``-position chunks
* ``make_train_step(cfg, opt, mesh=None, zero1=True, fsdp=False)`` -> (state, batch) ->
  (state, metrics);
  ``state = {"params": LM, "opt": OptState, "step": int}``, updated in place
* ``make_eval_step(cfg, mesh=None)``, ``make_steps(cfg, opt, mesh=None)``
* ``logical_axes(cfg)``                     -> each leaf's logical axes under its JAX
  name (``build_params(cfg)[1]`` of the JAX package)
* ``layout(cfg, mesh, zero1=True, fsdp=False)`` -> the train rules' specs on a
  mesh (``repro_torch.sharding.partition.Layout``; ``fsdp``: the params cut
  over ``data`` too); ``serve_layout(cfg, mesh)``
  -> ``SERVE_RULES``' specs (the embed dim cut over ``data`` too)
* ``shard_params(cfg, model, mesh, lay=None)`` -> the ``LM`` cut, in place, to
  this rank's blocks (the ZeRO-1 train layout's unless ``lay``, such as an
  FSDP one); ``gather_params(cfg, model, mesh, lay=None)`` -> its whole leaves

With a ``mesh`` (``repro_torch.sharding.mesh.Mesh``), ``forward``,
``loss_fn`` and the train and eval steps take the GLOBAL batch and use this
rank's rows of it (``batch_shardings``'s: the data ranks' blocks of the
leading dim, so batch k of a sharded run is batch k of an unsharded one),
on an ``LM`` that :func:`shard_params` cut.  Without a cache, ``forward``
runs on the train layout and returns this rank's block (its rows; the
logits its vocab columns); ``loss_fn`` the global loss, whose gradient on
each rank is its own part (the optimizer sums the parts over the data
axes, :class:`~repro_torch.optim.AdamW`'s ZeRO-1 update).  With a cache
(``init_kv_cache(..., mesh=)``'s blocks) it serves on the serving layout:
the weights cut by :func:`serve_layout`, stationary, the activations
moving (``repro_torch.sharding.partition``), and returns this rank's rows
of the logits with every vocab column; so do the prefill and serve steps
with a mesh.

PyTorch runs eagerly, so the steps are plain functions (the JAX package
jits them).  Caches, weights and moments are written in place and returned
for symmetry.  The weights are made with ``requires_grad=False``: the train
step turns grad on for the weights it trains, and the serving steps never
record a graph.
Every entry point that makes tensors takes ``device``: ``None`` means the
card, and raises without one.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.bitcode import resolve_device
from ..sharding.partition import (
    DEPTH_FIELD, SERVE_RULES, Layout, block_shape, cache_specs, full_leaf, leaf_key, local_block,
    rules_for_train, split_layer,
)
from .common import ModelConfig, ParamFactory, cross_entropy, rms_norm, rms_norm_serve, softcap
from .embedding import embed_c2d, embed_plain, lm_head
from .encdec import DecoderBlock, Encoder, encode, run_decoder
from .rwkv import RWKVBlock
from .ssm import CONV_K
from .transformer import (
    DenseBlock, HybridBlock, MoEBlock, as_leaves, require_ported, run_blocks,
)


# ------------------------------------------------------------------- shapes
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


def frontend_len(cfg: ModelConfig, seq_len: int) -> int:
    """Stub modality frontends: how many positions the frontend occupies
    (the JAX package's ``frontend_len``)."""
    if cfg.frontend == "patch":  # ViT patch embeds (internvl2)
        return min(256, seq_len // 4)
    if cfg.frontend == "audio":  # downsampled audio frames (seamless)
        return max(seq_len // 4, 16)
    return 0


def first_layers(cfg: ModelConfig, n: int) -> ModelConfig:
    """``cfg`` cut to its first ``n`` layers; an encoder-decoder's to the
    first ``n`` of each of its stacks."""
    return cfg.replace(n_layers=n, enc_layers=min(n, cfg.enc_layers))


def _no_frontend(cfg: ModelConfig, what: str) -> None:
    """A sharded forward takes no frontend and no encoder yet: refuse rather
    than drop the patches or the frames."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {what} forward takes no {cfg.frontend} frontend yet "
            "(ROADMAP.md section 1)")
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the {what} forward has no encoder-decoder path yet "
            "(ROADMAP.md section 1)")


# ------------------------------------------------------------------- params
class LM(nn.Module):
    """An LM's weights; parameter names follow the JAX flat dict
    (``embed.tok``, ``blocks.<layer>.wq``, ``blocks.<layer>.we_i``,
    ``blocks.<layer>.tm.wr`` or ``blocks.<layer>.ssm.w_in``, an
    encoder-decoder's ``enc.<layer>.wq``, ``enc.final_ln`` and
    ``blocks.<layer>.wq_x``, ``final_ln``, ``head.w``)."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__()
        require_ported(cfg)
        self.embed = nn.Module()
        self.embed.tok = f.new((cfg.vocab_padded, cfg.d_model), scale=0.02,
                               axes=("vocab", "embed"))
        if cfg.is_encdec:
            self.enc = Encoder(cfg, f)
        block = {"moe": MoEBlock, "rwkv": RWKVBlock, "hybrid": HybridBlock,
                 "encdec": DecoderBlock}.get(cfg.family, DenseBlock)
        self.blocks = nn.ModuleList(block(cfg, f) for _ in range(cfg.n_layers))
        self.final_ln = f.new((cfg.d_model,), "zeros", axes=("embed",))
        if not cfg.tie_embeddings:
            self.head = nn.Module()
            self.head.w = f.new((cfg.d_model, cfg.vocab_padded), axes=("embed", "vocab"))

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
    leaves (``blocks.*``, ``enc.*``) are sliced along their leading layer
    axis."""
    model = LM(cfg, ParamFactory(0, cfg.dtype, resolve_device(device), fill=False))
    load_named(model_params(model), from_jax_names(
        cfg, {k: torch.tensor(np.asarray(v)) for k, v in flat.items()}), "from_jax_params")
    return model


def model_params(model: LM) -> dict[str, torch.Tensor]:
    """The model's parameters by name (``blocks.<layer>.<leaf>``)."""
    return dict(model.named_parameters())


def from_jax_names(cfg: ModelConfig, flat: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A JAX flat dict under the port's names: each stacked leaf
    ``<stack>.<leaf>`` ``(L, ...)`` (``blocks.wq``, ``enc.wq``) becomes
    ``<stack>.<layer>.<leaf>`` views, one a layer."""
    depths = _depths(cfg)
    out = {}
    for key, arr in flat.items():
        if key in depths:
            stack, leaf = key.split(".", 1)
            if arr.shape[0] != depths[key]:
                raise ValueError(f"{key} stacks {arr.shape[0]} layers, want {depths[key]}")
            out.update({f"{stack}.{layer}.{leaf}": arr[layer] for layer in range(depths[key])})
        else:
            out[key] = arr
    return out


def to_jax_params(
    cfg: ModelConfig, named: "LM | dict[str, torch.Tensor]"
) -> dict[str, torch.Tensor]:
    """The JAX package's flat dict of ``named`` (an ``LM``, or a dict under
    its parameter names such as AdamW's moments): ``<stack>.<layer>.<leaf>``
    stacked along a leading layer axis as ``<stack>.<leaf>`` (a new tensor),
    every other leaf as it is.  The inverse of :func:`from_jax_params`."""
    if isinstance(named, nn.Module):
        named = model_params(named)
    out, stacks = {}, {}
    for name, t in named.items():
        owner = split_layer(name)
        if owner is None:
            out[name] = t
        else:
            stack, layer, leaf = owner
            stacks.setdefault(f"{stack}.{leaf}", {})[layer] = t
    depths = _depths(cfg)
    for key, parts in stacks.items():
        out[key] = torch.stack([parts[layer] for layer in range(depths[key])]).detach()
    return out


@torch.no_grad()
def load_named(
    dst: dict[str, torch.Tensor], src: dict[str, torch.Tensor], what: str = "load_named"
) -> None:
    """Copy every tensor of ``src`` into the one of ``dst`` under its name;
    the names and shapes must match one to one."""
    extra, missing = sorted(set(src) - set(dst)), sorted(set(dst) - set(src))
    if extra:
        raise KeyError(f"{what}: {extra} have no counterpart in the port")
    if missing:
        raise KeyError(f"{what}: no leaf for {missing}")
    for name, t in src.items():
        if tuple(t.shape) != tuple(dst[name].shape):
            raise ValueError(f"{what}: {name} is {tuple(t.shape)}, want {tuple(dst[name].shape)}")
        dst[name].copy_(t)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# ------------------------------------------------------------- on a mesh
@functools.lru_cache(maxsize=32)
def _meta(cfg: ModelConfig) -> tuple[dict[str, tuple], dict[str, tuple], dict[str, int]]:
    """``(shapes, logical axes, depths)`` of one layer's leaves, under
    ``<stack>.<leaf>``, and of the others, from a model on the meta device;
    ``depths`` holds the layers each stacked leaf's key stacks."""
    one = cfg.replace(n_layers=1, enc_layers=min(cfg.enc_layers, 1))
    meta = LM(one, ParamFactory(0, cfg.dtype, torch.device("meta"), fill=False))
    shapes, axes, depths = {}, {}, {}
    for name, leaf in meta.named_parameters():
        if leaf.logical_axes is None:
            raise ValueError(f"{cfg.name}: leaf {name} has no logical axes")
        key = leaf_key(name)
        shapes[key], axes[key] = tuple(leaf.shape), leaf.logical_axes
        owner = split_layer(name)
        if owner is not None:
            depths[key] = getattr(cfg, DEPTH_FIELD[owner[0]])
    return shapes, axes, depths


def _leaves(cfg: ModelConfig) -> tuple[dict[str, tuple], dict[str, tuple]]:
    """``(shapes, logical axes)`` of one layer's leaves and of the others
    (:func:`_meta`)."""
    return _meta(cfg)[:2]


def _depths(cfg: ModelConfig) -> dict[str, int]:
    """The layers each stacked JAX leaf holds, by key (``blocks.wq``:
    ``n_layers``; ``enc.wq``: ``enc_layers``)."""
    return _meta(cfg)[2]


def logical_axes(cfg: ModelConfig) -> tuple[dict[str, tuple], dict[str, tuple]]:
    """``(shapes, axes)`` of every leaf under its JAX name: a stacked leaf
    (``blocks.*``, ``enc.*`` but ``enc.final_ln``) over its stack's layers,
    its axes led by ``"layers"`` (the JAX package's ``build_params(cfg,
    abstract=True)``, shapes and axes)."""
    shapes, axes, depths = _meta(cfg)
    return ({k: (depths[k], *s) if k in depths else s for k, s in shapes.items()},
            {k: ("layers", *a) if k in depths else a for k, a in axes.items()})


def layout(cfg: ModelConfig, mesh, zero1: bool = True, fsdp: bool = False) -> Layout:
    """The train rules' specs (``rules_for_train``) of every leaf on
    ``mesh``, a layer's leaves under ``blocks.<leaf>`` without the layer
    axis; ``fsdp``: the params at the moments' specs (``fsdp_specs``), which
    needs ``zero1``."""
    return Layout(mesh, *_leaves(cfg), rules_for_train(cfg, mesh), zero1=zero1, fsdp=fsdp)


def serve_layout(cfg: ModelConfig, mesh, caches: "CacheBlocks | None" = None) -> Layout:
    """:data:`SERVE_RULES`' specs of every leaf on ``mesh`` (the embed dim
    cut over ``data`` as well), with ``caches``' specs when given.  Every
    ``embed`` dim must split over the data axes: the serving forward keeps
    the residual stream embed-cut."""
    lay = Layout(mesh, *_leaves(cfg), SERVE_RULES, zero1=False,
                 cache_specs=None if caches is None else caches.specs)
    _, axes = _leaves(cfg)
    for key, spec in lay.params.items():
        for dim, name in enumerate(axes[key]):
            if name == "embed" and lay.data and (dim >= len(spec) or spec[dim] is None):
                raise NotImplementedError(
                    f"{cfg.name}: {key}'s embed dim does not split over the data axes "
                    f"{lay.data}; the serving layout needs d_model {cfg.d_model} to")
    return lay


@torch.no_grad()
def shard_params(cfg: ModelConfig, model: LM, mesh, lay: Layout | None = None) -> LM:
    """Cut ``model`` (whole on every rank, built from one seed) to this
    rank's blocks, in place; returns it."""
    lay = lay or layout(cfg, mesh)
    for name, leaf in model.named_parameters():
        leaf.data = local_block(leaf.data, lay.params[leaf_key(name)], mesh).clone()
    return model


def gather_params(cfg: ModelConfig, model: "LM | dict[str, torch.Tensor]", mesh,
                  lay: Layout | None = None, moments: bool = False) -> dict[str, torch.Tensor]:
    """The whole leaves of a sharded ``model`` (or of a dict of its blocks
    by name; ``moments``: blocks under the ZeRO-1 moment specs), by name;
    every rank of the mesh calls it."""
    lay = lay or layout(cfg, mesh)
    specs = lay.moments if moments else lay.params
    named = model_params(model) if isinstance(model, nn.Module) else model
    return {k: full_leaf(t.detach(), specs[leaf_key(k)], mesh) for k, t in named.items()}


def _cut(cfg: ModelConfig, model: LM, lay: Layout) -> tuple[torch.Tensor, bool]:
    """The LM head's weight block and whether its vocab is cut over model."""
    if cfg.tie_embeddings:
        return model.embed.tok.T, lay.split("embed.tok", 0)
    return model.head.w, lay.split("head.w", 1)


def _head_tp(cfg: ModelConfig, model: LM, h: torch.Tensor, lay: Layout) -> torch.Tensor:
    """This rank's vocab columns of the logits (all of them where the
    vocab is whole)."""
    w, cut = _cut(cfg, model, lay)
    h = rms_norm(h, model.final_ln, cfg.norm_eps)
    return softcap(lm_head(h, w, lay.mesh if cut else None), cfg.final_softcap)


def _forward_tp(cfg: ModelConfig, model: LM, batch: dict, lay: Layout,
                return_hidden: bool):
    """:func:`forward` on this rank's rows ``batch`` and weight blocks (the
    table gathered to its TP block under FSDP)."""
    _no_frontend(cfg, "sharded train")
    tokens = batch["tokens"]
    if "token_rows" in batch:  # the rank's rows of the rows gathered elsewhere
        x = batch["token_rows"].to(cfg.dtype)
    elif lay.split("embed.tok", 0):
        x = embed_c2d(lay.gather("embed.tok", model.embed.tok), tokens, lay.mesh)
    else:
        x = embed_plain(lay.gather("embed.tok", model.embed.tok), tokens)
    if cfg.embed_mult != 1.0:
        x = (x.float() * cfg.embed_mult).to(x.dtype)
    pos = torch.arange(tokens.shape[1], device=x.device)
    h, aux = run_blocks(cfg, model.blocks, x, pos=pos, lay=lay)
    if return_hidden:
        return h, None, aux
    return _head_tp(cfg, model, h, lay), None, aux


def _head_serve(cfg: ModelConfig, model: LM, h: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The LM head of an embed-cut ``h`` (every row) on a serving layout:
    this rank's rows of the logits, every vocab column (summed over
    ``data``, then all-gathered over ``model`` where the vocab is cut)."""
    w, cut = _cut(cfg, model, lay)
    logits = lay.sum_rows(rms_norm_serve(h, model.final_ln, cfg.norm_eps, lay) @ w)
    return softcap(lay.gather_model(logits) if cut else logits, cfg.final_softcap)


def _forward_serve(cfg: ModelConfig, model: LM, batch: dict, lay: Layout, caches: "CacheBlocks",
                   offset: int, rows: torch.Tensor | None, return_hidden: bool):
    """:func:`forward` with a cache on a serving layout: ``batch`` global,
    ``model`` and ``caches`` this rank's blocks; ``rows`` (global batch
    rows whose cache is written) becomes a mask of the rank's rows.  The
    hidden state is embed-cut (every row); the logits this rank's rows."""
    _no_frontend(cfg, "sharded serving")
    tokens = batch["tokens"]
    n, s = tokens.shape
    if "token_rows" in batch:  # rows gathered elsewhere: every row's embed slice
        x = lay.embed_slice(batch["token_rows"]).to(cfg.dtype)
    elif lay.split("embed.tok", 0):
        x = embed_c2d(model.embed.tok, tokens, lay.mesh)  # the (model, data) block
    else:
        x = embed_plain(model.embed.tok, tokens)
    if cfg.embed_mult != 1.0:
        x = (x.float() * cfg.embed_mult).to(x.dtype)
    if rows is not None:
        mask = torch.zeros(n, dtype=torch.bool, device=x.device)
        mask[rows] = True
        rows = mask[lay.serve_rows(n)]
    pos = offset + torch.arange(s, device=x.device)
    h, aux = run_blocks(cfg, model.blocks, x, pos=pos, caches=caches, offset=offset, rows=rows,
                        lay=lay)
    if return_hidden:
        return h, caches, aux
    return _head_serve(cfg, model, h, lay), caches, aux


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
    mesh=None,
):
    """Returns (logits, caches, aux_loss); ``caches`` is updated in place
    (only batch ``rows`` of it, when given).  With a ``mesh`` and no cache,
    ``batch`` is the global batch, ``model`` this rank's blocks
    (:func:`shard_params`), and the result this rank's block: its rows,
    the logits its vocab columns.  With a ``mesh`` and ``caches`` (this
    rank's :class:`CacheBlocks`), ``model`` is cut by :func:`serve_layout`
    and the result is this rank's rows of the logits, every vocab column
    (the hidden state, with ``return_hidden``, embed-cut: every row, the
    rank's slice of the embed dim).  ``aux_loss`` is the MoE
    router's load-balance loss averaged over the layers (an f32 scalar), 0.0
    for the other families.  ``batch["token_rows"]``, when
    present, holds embedding rows gathered elsewhere (the serving tier's
    remote embedding) and bypasses the table lookup.  With a ``patch``
    frontend, ``batch["patch_embeds"]`` (B, P, D), when present, replaces
    the first P positions after ``embed_mult``.  An encoder-decoder encodes
    ``batch["frames"]`` (B, S_enc, D), when present, and its decoder
    attends over them (written to the cache's ``xk``/``xv`` too); without
    frames it reads the cross K/V back from the cache.  A sharded forward
    refuses a frontend and the encoder-decoder."""
    if mesh is not None and caches is not None:
        if not isinstance(caches, CacheBlocks):
            raise ValueError("a cache on a mesh is a rank's blocks: init_kv_cache(..., mesh=)")
        return _forward_serve(cfg, model, batch, serve_layout(cfg, mesh, caches), caches,
                              0 if offset is None else int(offset), rows, return_hidden)
    if mesh is not None:
        lay = layout(cfg, mesh)
        rows_of = lay.rows(batch["tokens"].shape[0])
        return _forward_tp(cfg, model, {k: v[rows_of] for k, v in batch.items()}, lay,
                           return_hidden)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    if "token_rows" in batch:
        x = batch["token_rows"].to(cfg.dtype)
    else:
        x = embed_plain(model.embed.tok, tokens)
    if cfg.embed_mult != 1.0:
        x = (x.float() * cfg.embed_mult).to(x.dtype)
    if cfg.frontend == "patch" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    off = 0 if offset is None else int(offset)
    pos = off + torch.arange(s, device=x.device)
    if cfg.is_encdec:
        enc_out = (encode(cfg, model.enc, batch["frames"].to(cfg.dtype))
                   if "frames" in batch else None)
        h = run_decoder(cfg, model.blocks, x, enc_out=enc_out, pos=pos, caches=caches,
                        offset=off, rows=rows)
        aux = 0.0
    else:
        h, aux = run_blocks(cfg, model.blocks, x, pos=pos, caches=caches, offset=off, rows=rows)
    if return_hidden:
        return h, caches, aux
    return _head(cfg, model, h), caches, aux


# ----------------------------------------------------------------- KV cache
class CacheBlocks(dict):
    """A rank's blocks of a cache on a mesh, by leaf (``init_kv_cache(...,
    mesh=)``), with each leaf's spec under ``cache_specs`` in ``specs``."""

    def __init__(self, blocks: dict[str, torch.Tensor], specs: dict[str, tuple]) -> None:
        super().__init__(blocks)
        self.specs = specs


def init_kv_cache(
    cfg: ModelConfig, batch: int, t_max: int, dtype: torch.dtype = torch.bfloat16,
    device: "torch.device | str | None" = None, mesh=None, enc_len: int = 0,
) -> dict[str, torch.Tensor]:
    """The dense and moe families' cache: ``k`` and ``v`` of ``(L, B, T, K, hd)``.
    The rwkv family's state, whatever ``t_max``: ``tm_shift`` and
    ``cm_shift`` of ``(L, B, 1, D)`` in ``dtype`` and ``wkv`` of
    ``(L, B, H, M, M)`` in f32.  The hybrid family's: ``k`` and ``v``, the
    SSM head's ``conv`` of ``(L, B, K-1, D)`` in ``dtype`` and ``h`` of
    ``(L, B, D, N)`` in f32.  The encdec family's: ``k`` and ``v``, and the
    cross K/V ``xk`` and ``xv`` of ``(L, B, enc_len, K, hd)`` in ``dtype``
    (``enc_len`` frames).  With a ``mesh``, this rank's blocks of each
    under ``cache_specs`` (a :class:`CacheBlocks`): B over the data axes
    and T (``wkv``'s heads, ``h``'s channels) over ``model`` where they
    divide, every other dim whole."""
    require_ported(cfg)
    if mesh is not None:
        _no_frontend(cfg, "sharded serving")
    dev = resolve_device(device)
    L, D = cfg.n_layers, cfg.d_model
    if cfg.family == "rwkv":  # (shape, held in f32) by leaf
        m = cfg.rwkv_head_dim
        shapes = {"tm_shift": ((L, batch, 1, D), False), "cm_shift": ((L, batch, 1, D), False),
                  "wkv": ((L, batch, D // m, m, m), True)}
    else:
        kv = (L, batch, t_max, cfg.n_kv_heads, cfg.head_dim)
        shapes = {"k": (kv, False), "v": (kv, False)}
    if cfg.family == "hybrid":
        shapes.update(conv=((L, batch, CONV_K - 1, D), False),
                      h=((L, batch, D, cfg.ssm_state), True))
    if cfg.is_encdec:
        cross = (L, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        shapes.update(xk=(cross, False), xv=(cross, False))
    specs = (None if mesh is None
             else cache_specs({k: shape for k, (shape, _) in shapes.items()}, mesh))
    blocks = {k: torch.zeros(shape if mesh is None else block_shape(shape, specs[k], mesh),
                             dtype=torch.float32 if f32 else dtype, device=dev)
              for k, (shape, f32) in shapes.items()}
    return blocks if mesh is None else CacheBlocks(blocks, specs)


def make_batch(
    cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
    device: "torch.device | str | None" = None,
) -> dict[str, torch.Tensor]:
    """Random tokens of a prefill or train shape (a train shape adds random
    ``labels`` and a ``mask`` of ones, 0 on the frontend's positions; a
    ``patch`` frontend adds ``patch_embeds`` and an ``audio`` one
    ``frames``, each f32 normal(0, 0.02) of ``(B, frontend_len, D)``), from
    the numpy draws the JAX package makes, in its order (so both packages
    see the same batch)."""
    if shape.kind not in ("prefill", "train"):
        raise ValueError(f"make_batch makes prefill and train batches, not {shape.kind!r}")
    require_ported(cfg)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    b, s = shape.global_batch, shape.seq_len
    fl = frontend_len(cfg, s)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if shape.kind == "train":
        batch["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        batch["mask"] = np.ones((b, s), np.float32)
        batch["mask"][:, :fl] = 0.0  # frontend positions carry no LM loss
    if cfg.frontend == "patch":
        batch["patch_embeds"] = rng.normal(0, 0.02, (b, fl, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio":
        batch["frames"] = rng.normal(0, 0.02, (b, fl, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


# -------------------------------------------------------------------- steps
def make_prefill_step(cfg: ModelConfig, mesh=None, t_max: int | None = None) -> Callable:
    """Fill a prompt-length cache (the recurrent state) from the prompt;
    logits for the last token.  ``t_max`` sizes the cache for a whole
    session instead (the prompt written from offset 0, as ``launch.serve``
    prefills; the JAX step has no such option).  An encoder-decoder's cache
    holds the cross K/V of ``frontend_len(cfg, S)`` frames, and its batch
    must carry them (``frames``): the step raises ``ValueError`` without,
    as JAX's does.  With a ``mesh``, ``batch`` is global, ``model`` cut by
    :func:`serve_layout`, and the step returns this rank's rows of the
    logits (every vocab column) and its cache blocks."""

    def prefill_step(model: LM, batch: dict):
        b, s = batch["tokens"].shape
        if cfg.is_encdec and "frames" not in batch:
            raise ValueError("enc-dec prefill needs frames")
        cache = init_kv_cache(cfg, b, t_max or s, dtype=cfg.dtype, device=model.device,
                              mesh=mesh, enc_len=frontend_len(cfg, s))
        h, cache, _ = forward(cfg, model, batch, caches=cache, offset=0, return_hidden=True,
                              mesh=mesh)
        # head over the LAST position only
        if mesh is None:
            logits = _head(cfg, model, h[:, -1:, :])
        else:
            logits = _head_serve(cfg, model, h[:, -1:, :], serve_layout(cfg, mesh, cache))
        return logits[:, -1, :], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None) -> Callable:
    """One decode step: next-token logits, the cache written at ``pos`` (the
    rwkv state replaced).  With a ``mesh``, ``tokens`` (and ``token_rows``)
    are global, ``model`` and ``cache`` this rank's blocks, and the logits
    this rank's rows, every vocab column.

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
        logits, cache, _ = forward(cfg, model, batch, caches=cache, offset=pos, rows=rows,
                                   mesh=mesh)
        return logits[:, -1, :], cache

    return serve_step


# ------------------------------------------------------------- train steps
AUX_LOSS_WEIGHT = 0.01  # the JAX package's weight of the MoE router loss
LOSS_CHUNK = 512  # S-chunked softmax-xent: the (B, S, V) f32 logits never exist whole


def _chunk_nll(
    cfg: ModelConfig, model: LM, h: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Summed masked NLL of one chunk of positions."""
    logits = _head(cfg, model, h)
    v = logits.shape[-1]
    if v > cfg.vocab:
        logits = logits.masked_fill(torch.arange(v, device=h.device) >= cfg.vocab, -1e9)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum((lse - gold) * mask)


def _chunked_xent(
    cfg: ModelConfig, model: LM, h: torch.Tensor, labels: torch.Tensor,
    mask: torch.Tensor | None,
) -> torch.Tensor:
    """Head matmul + cross-entropy over chunks of ``LOSS_CHUNK`` positions
    of the final hidden state: each chunk's logits exist only inside a
    checkpointed call (recomputed in the backward), as in the JAX package's
    remat'd scan.  A sequence that ``LOSS_CHUNK`` does not cut into two or
    more chunks takes the whole head at once."""
    b, s, _ = h.shape
    c = LOSS_CHUNK
    if s % c or s <= c:
        return cross_entropy(_head(cfg, model, h), labels, cfg.vocab, mask)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // c):
        part = (h[:, i * c : (i + 1) * c], labels[:, i * c : (i + 1) * c],
                mask[:, i * c : (i + 1) * c])
        if torch.is_grad_enabled():
            nll = nll + checkpoint(_chunk_nll, cfg, model, *part, use_reentrant=False)
        else:
            nll = nll + _chunk_nll(cfg, model, *part)
        cnt = cnt + torch.sum(part[2])
    return nll / torch.clamp(cnt, min=1.0)


def _nll_sum_tp(cfg: ModelConfig, model: LM, h: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, lay: Layout) -> torch.Tensor:
    """Summed masked NLL of one chunk of this rank's rows, the softmax over
    the vocab cut over ``model``: the row max (pmax) and the sum of
    exponentials (psum) over the ranks, the label's logit from the rank
    that holds it (psum), the padded columns of the last block masked."""
    from ..sharding.mesh import reduce_from_region

    logits = _head_tp(cfg, model, h, lay)
    _, cut = _cut(cfg, model, lay)
    v_loc = logits.shape[-1]
    lo = lay.mesh.axis_index("model") * v_loc if cut else 0
    if lo + v_loc > cfg.vocab:
        cols = lo + torch.arange(v_loc, device=h.device)
        logits = logits.masked_fill(cols >= cfg.vocab, -1e9)
    logits = logits.float()
    if not cut:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.sum((lse - gold) * mask)
    mesh = lay.mesh
    mx = mesh.pmax(logits.detach().amax(-1), "model")
    lse = torch.log(reduce_from_region(torch.exp(logits - mx[..., None]).sum(-1), mesh)) + mx
    loc = labels.long() - lo
    mine = (loc >= 0) & (loc < v_loc)
    g = torch.gather(logits, -1, loc.clamp(0, v_loc - 1)[..., None])[..., 0]
    gold = reduce_from_region(torch.where(mine, g, torch.zeros_like(g)), mesh)
    return torch.sum((lse - gold) * mask)


def _head_leaves(cfg: ModelConfig, model: LM, lay: Layout):
    """What the LM head reads of ``model`` (``final_ln`` and the head's
    weight): under FSDP each gathered to its TP block, once for every
    chunk of positions; else ``model``."""
    if not lay.fsdp:
        return model
    names = ("final_ln", "embed.tok" if cfg.tie_embeddings else "head.w")
    params = model_params(model)
    return as_leaves({n: lay.gather(n, params[n]) for n in names})


def _loss_tp(cfg: ModelConfig, model: LM, batch: dict, lay: Layout,
             mark: Callable[[str], None] | None = None):
    """``(part, value, {"nll", "aux"})`` on this rank's rows of ``batch``:
    ``part`` is its share of the loss (its rows' summed NLL over the whole
    batch's count, plus the aux term, whose means over the ranks are in
    the graph), whose gradient summed over the data ranks is the loss's;
    ``value`` the whole loss."""
    mesh = lay.mesh
    rows = lay.rows(batch["tokens"].shape[0])
    local = {k: v[rows] for k, v in batch.items()}
    h, _, aux = _forward_tp(cfg, model, local, lay, return_hidden=True)
    if mark:
        mark("forward")
    model = _head_leaves(cfg, model, lay)
    labels = local["labels"]
    mask = local.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    b, s, _ = h.shape
    c = LOSS_CHUNK
    if s % c or s <= c:
        nll = _nll_sum_tp(cfg, model, h, labels, mask, lay)
    else:
        nll = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(s // c):
            part = (h[:, i * c : (i + 1) * c], labels[:, i * c : (i + 1) * c],
                    mask[:, i * c : (i + 1) * c])
            if torch.is_grad_enabled():
                nll = nll + checkpoint(_nll_sum_tp, cfg, model, *part, lay, use_reentrant=False)
            else:
                nll = nll + _nll_sum_tp(cfg, model, *part, lay)
    cnt = torch.sum(mask.float())
    if lay.data:
        cnt = mesh.psum(cnt, lay.data)
    nll = nll / torch.clamp(cnt, min=1.0)
    whole = mesh.psum(nll.detach(), lay.data) if lay.data else nll.detach()
    aux_t = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
    part = nll + AUX_LOSS_WEIGHT * aux_t
    value = whole + AUX_LOSS_WEIGHT * aux_t.detach()
    if mark:
        mark("loss")
    return part, value, {"nll": whole, "aux": aux_t.detach()}


def loss_fn(
    cfg: ModelConfig, model: LM, batch: dict, mark: Callable[[str], None] | None = None,
    mesh=None,
) -> tuple[torch.Tensor, dict]:
    """``(loss, {"nll", "aux"})``: the masked next-token NLL plus
    ``AUX_LOSS_WEIGHT`` times the MoE router's aux loss (0 for the other
    families).  ``mark``, when given,
    is called with ``"forward"`` and ``"loss"`` as each is queued.  With a
    ``mesh``, the loss of the global ``batch``, whose gradient on each rank
    is its own part (:func:`_loss_tp`)."""
    if mesh is not None:
        part, value, parts = _loss_tp(cfg, model, batch, layout(cfg, mesh), mark)
        return part + (value - part).detach(), parts
    h, _, aux = forward(cfg, model, batch, return_hidden=True)
    if mark:
        mark("forward")
    nll = _chunked_xent(cfg, model, h, batch["labels"], batch.get("mask"))
    loss = nll + AUX_LOSS_WEIGHT * aux
    if mark:
        mark("loss")
    return loss, {"nll": nll, "aux": torch.as_tensor(aux, dtype=torch.float32)}


def _on(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    return {k: (v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))).to(device)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt, mark: Callable[[str], None] | None = None,
                    mesh=None, zero1: bool = True, fsdp: bool = False) -> Callable:
    """``(state, batch) -> (state, metrics)``; ``state = {"params": LM,
    "opt": OptState, "step": int}``, updated in place; ``batch`` holds
    ``tokens``, ``labels`` and ``mask``, and a frontend's inputs
    (``patch_embeds``, ``frames``; numpy or tensors; moved to the model's
    device), all cut into the same microbatches.

    ``cfg.microbatch > 1`` (dividing the batch) splits the batch into that
    many contiguous slices and accumulates their gradients in f32, then
    averages them, as the JAX package's scan does: peak activation memory
    divides by the microbatch count.  Grad is turned on for the weights only
    inside the step.  ``mark``, when given, is called with ``"forward"``,
    ``"loss"`` and ``"backward"`` as each stage of each microbatch is
    queued, and with ``"optimizer"`` after the update (a timer's hook).

    With a ``mesh``, ``state["params"]`` is this rank's blocks
    (:func:`shard_params`) and ``state["opt"]`` its moment blocks
    (``opt.init(params, constrain=layout(cfg, mesh, zero1))``); ``batch``
    is the global batch (a microbatch is its contiguous slice, then this
    rank's rows of that).  Each rank takes the gradient of its part of the
    loss and the update is ZeRO-1 (``zero1``; else the moments as the
    params): gradients reduce-scattered over the data axes, each rank's
    block of the weight updated, then all-gathered.  With ``fsdp`` (JAX's
    ZeRO-3: ``fsdp_shardings``; needs ``zero1``) the params are this rank's
    blocks under ``layout(cfg, mesh, fsdp=True)``, as the moments are: each
    layer's weights are all-gathered to their TP blocks where the layer
    runs, each microbatch's gradients come reduce-scattered by those
    gathers' backwards (accumulated in f32 on the rank's blocks), and each
    rank updates its blocks with no collective after.  Without a mesh
    ``fsdp`` does nothing, as in the JAX step."""
    mark = mark or (lambda stage: None)
    lay = layout(cfg, mesh, zero1, fsdp) if mesh is not None else None

    def grad_once(model: LM, params: dict, batch: dict):
        with torch.enable_grad():
            if lay is None:
                loss, parts = loss_fn(cfg, model, batch, mark)
                part = loss
            else:
                part, loss, parts = _loss_tp(cfg, model, batch, lay, mark)
            grads = torch.autograd.grad(part, list(params.values()), allow_unused=True,
                                        materialize_grads=True)
            mark("backward")
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, dict(zip(params, grads))

    def train_step(state: dict, batch: dict):
        model = state["params"]
        params = model_params(model)
        batch = _on(batch, model.device)
        mb = max(int(cfg.microbatch), 1)
        b = batch["tokens"].shape[0]
        for p in params.values():
            p.requires_grad_(True)
        try:
            if mb > 1 and b % mb == 0:
                n = b // mb
                grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for k, p in params.items()}
                losses, parts = [], []
                for i in range(mb):
                    loss, part, g = grad_once(
                        model, params, {k: v[i * n : (i + 1) * n] for k, v in batch.items()})
                    for k, acc in grads.items():
                        acc.add_(g[k].float())
                    del g
                    losses.append(loss)
                    parts.append(part)
                for acc in grads.values():
                    acc.div_(mb)
                loss = torch.stack(losses).mean()
                parts = {k: torch.stack([p[k] for p in parts]).mean() for k in parts[0]}
            else:
                loss, parts, grads = grad_once(model, params, batch)
        finally:
            for p in params.values():
                p.requires_grad_(False)
        if lay is None:
            _, _, om = opt.update(grads, state["opt"], params)
        else:
            _, _, om = opt.update(grads, state["opt"], params, constrain=lay)
        mark("optimizer")
        del grads
        state["step"] += 1
        return state, {"loss": loss, **parts, **om, "step": state["step"]}

    return train_step


def make_eval_step(cfg: ModelConfig, mesh=None) -> Callable:
    @torch.no_grad()
    def eval_step(model: LM, batch: dict):
        loss, parts = loss_fn(cfg, model, _on(batch, model.device), mesh=mesh)
        return {"loss": loss, **parts}

    return eval_step


def make_steps(cfg: ModelConfig, opt=None, mesh=None) -> dict[str, Callable]:
    """The train, eval, prefill and serve steps, each on ``mesh`` when given
    (the train and eval steps on its train layout, the serving steps on
    its serving layout)."""
    from ..optim import AdamW

    opt = opt or AdamW()
    return {
        "train": make_train_step(cfg, opt, mesh=mesh),
        "eval": make_eval_step(cfg, mesh=mesh),
        "prefill": make_prefill_step(cfg, mesh=mesh),
        "serve": make_serve_step(cfg, mesh=mesh),
    }
