"""The decoder stack: dense blocks (GQA attention + SwiGLU MLP), MoE
blocks (GQA attention + top-k experts), RWKV6 blocks and hybrid blocks
(parallel GQA attention + SSM heads, then the MLP).

The counterpart of the dense, moe, rwkv and hybrid families of
``repro.models.transformer``.  The JAX package stacks layers on a leading
axis and scans them; the port holds one block module per layer and loops
over them.  The same ``run_blocks`` serves a full sequence (no cache),
prefill (cache written from offset 0) and decode (cache written at the
offset).  Attention is one launch of the ``flash_attention`` kernel on the
card, over the cache's valid prefix, with the layer's sliding window (0 on
global layers); an RWKV block's WKV is one launch of the ``wkv6`` kernel
and a hybrid block's scan one of ``ssm_scan``, each from the layer's
state.  An MoE block's experts run through ``models/moe.py`` (the
capacity-buffer dispatch, or every expert over every token when
``c2d_embedding`` is off), and its router's aux loss is averaged over the
layers, as the JAX scan sums it.  The encoder-decoder family's blocks are
``models/encdec.py``'s, on the same attention sublayer.  A forward that
trains (grad on, weights that require grad, no cache) with ``cfg.remat``
checkpoints each block, as the JAX package wraps its scan body in
``jax.checkpoint``: a block keeps only its input and runs again in the
backward.

With a :class:`~repro_torch.sharding.partition.Layout` (``lay``, a mesh and
the train rules' specs), each block runs on this rank's blocks of the
weights, with the collectives a GSPMD partitioner puts there written out
(``repro_torch.sharding.mesh``'s gradient-carrying ones): attention head
parallel over ``model`` (``wq``/``wk``/``wv`` by columns, ``wo`` by rows
and one psum) where the heads divide it, else sequence parallel
(:func:`~repro_torch.models.attention.attend_sp` on the rank's S/|model|
queries, the weights whole) under the JAX ``sp_attn`` condition, the MLP
by ``ffn`` the same way, an MoE block's experts by the ``all_to_all``
dispatch, an RWKV block by heads and a hybrid block's SSM head by
channels.  The residual stream is whole on every rank of a ``model``
group; the batch rows are the rank's.  Under an FSDP layout (``lay.fsdp``)
a rank holds its blocks of the weights cut over ``data`` too: each block's
leaves are all-gathered to their TP blocks inside the function that
``checkpoint`` recomputes (:func:`gather_block` in :func:`block_apply`),
so with ``remat`` the backward gathers a layer's weights again and no
layer's whole weights outlive it; each gather's backward reduce-scatters
the gradient.

With a serving layout (``SERVE_RULES``: the embed dim cut over ``data``
too) and a cache, :func:`block_apply_tp` serves: the weights stay where
their specs put them and the activations move.  The residual stream is
embed-cut (every batch row, the rank's slice of the embed dim); a product
with a weight whose embed dim is cut sums its rows over ``data`` (to the
rank's rows, or to every row), and one whose embed dim is its output takes
every row's input and sums over ``model`` where its rows are cut.  The KV
cache's T is cut over ``model`` (``cache_specs``): decode and a prompt
written into a session cache gather every query head and the new K/V to
each rank of the ``model`` group, each rank writes the positions it owns,
attends over its slice (``flash_attention`` with ``diag = offset - lo``)
and the slices' partial softmax stats come back over ``model`` to be
merged (:func:`merge_slices`).  A prefill that fills the whole cache from offset
0 with the heads tensor parallel attends over the fresh K/V on the rank's
heads, as JAX does, and re-lays K and V from heads to T-slices with one
all-to-all; where the heads are not tensor parallel (hymba's 25 heads,
whose columns the rule cuts mid-head) it takes the sliced path, whose
gathered heads make the sequence-parallel split unnecessary.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention
from ..sharding.mesh import (
    copy_to_region, gather_from_region, reduce_from_region, scatter_to_region,
)
from .attention import attend_sp, qkv_proj, update_kv_cache
from .common import (
    ModelConfig, ParamFactory, activation, mlp, rms_norm, rms_norm_serve, rope,
)
from .moe import moe_block, moe_block_serve
from .rwkv import RWKVBlock, rwkv_block, rwkv_block_serve, rwkv_block_tp
from .ssm import SSMHead, ssm_head, ssm_head_serve, ssm_head_tp


def require_ported(cfg: ModelConfig) -> None:
    """Refuse a config the port's stacks do not run: a family it has no
    blocks for, encoder layers outside the encoder-decoder family (or that
    family without them), and the audio frontend outside it (its frames are
    the encoder's input; the JAX package's decoder-only forward would drop
    them)."""
    if cfg.family not in ("dense", "moe", "rwkv", "hybrid", "encdec"):
        raise NotImplementedError(
            f"{cfg.name}: the port has no {cfg.family} family (ROADMAP.md section 1)")
    if cfg.is_encdec != (cfg.family == "encdec"):
        raise NotImplementedError(
            f"{cfg.name}: the port runs encoder layers in the encdec family only, and that "
            f"family with them (family {cfg.family}, enc_layers {cfg.enc_layers}; ROADMAP.md "
            "section 1)")
    if cfg.frontend not in (None, "patch", "audio") or (
            cfg.frontend == "audio" and not cfg.is_encdec):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the {cfg.frontend} frontend only on the encoder-decoder "
            "family, whose encoder reads the frames (ROADMAP.md section 1)")


# ----------------------------------------------------------------- params
def add_attn_params(m: nn.Module, f: ParamFactory, cfg: ModelConfig) -> None:
    D = cfg.d_model
    m.wq = f.new((D, cfg.qkv_dim), axes=("embed", "q_dim"))
    m.wk = f.new((D, cfg.kv_dim), axes=("embed", "kv_dim"))
    m.wv = f.new((D, cfg.kv_dim), axes=("embed", "kv_dim"))
    m.wo = f.new((cfg.qkv_dim, D), axes=("q_dim", "embed"))
    if cfg.qkv_bias:
        m.bq = f.new((cfg.qkv_dim,), "zeros", axes=("q_dim",))
        m.bk = f.new((cfg.kv_dim,), "zeros", axes=("kv_dim",))
        m.bv = f.new((cfg.kv_dim,), "zeros", axes=("kv_dim",))


def add_mlp_params(m: nn.Module, f: ParamFactory, cfg: ModelConfig) -> None:
    D, F = cfg.d_model, cfg.d_ff
    m.wi = f.new((D, F), axes=("embed", "ffn"))
    if cfg.mlp_gated:
        m.wg = f.new((D, F), axes=("embed", "ffn"))
    m.wo2 = f.new((F, D), axes=("ffn", "embed"))


def add_moe_params(m: nn.Module, f: ParamFactory, cfg: ModelConfig) -> None:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    m.router = f.new((D, E), scale=0.02, axes=("embed", None))
    m.we_i = f.new((E, D, F), axes=("experts", "embed", "ffn"))
    m.we_g = f.new((E, D, F), axes=("experts", "embed", "ffn"))
    m.we_o = f.new((E, F, D), axes=("experts", "ffn", "embed"))


def add_block_params(m: nn.Module, f: ParamFactory, cfg: ModelConfig) -> None:
    m.ln1 = f.new((cfg.d_model,), "zeros", axes=("embed",))
    m.ln2 = f.new((cfg.d_model,), "zeros", axes=("embed",))
    add_attn_params(m, f, cfg)
    add_mlp_params(m, f, cfg)


class DenseBlock(nn.Module):
    """One layer's weights: the JAX ``blocks.*`` leaves at one layer index."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__()
        add_block_params(self, f, cfg)


class MoEBlock(nn.Module):
    """A dense block's norms and attention, with the router ``(D, E)`` and
    the experts ``we_i``, ``we_g`` ``(E, D, F)`` and ``we_o`` ``(E, F, D)``
    in place of the MLP (the leaves of the JAX ``add_moe_params``)."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__()
        self.ln1 = f.new((cfg.d_model,), "zeros", axes=("embed",))
        self.ln2 = f.new((cfg.d_model,), "zeros", axes=("embed",))
        add_attn_params(self, f, cfg)
        add_moe_params(self, f, cfg)


class HybridBlock(DenseBlock):
    """A dense block's leaves plus the SSM head (``blocks.ssm.*``) and the
    two per-channel mixing gains ``beta_attn`` and ``beta_ssm``."""

    def __init__(self, cfg: ModelConfig, f: ParamFactory) -> None:
        super().__init__(cfg, f)
        self.ssm = SSMHead(cfg, f)
        self.beta_attn = f.new((cfg.d_model,), "ones", axes=("embed",))
        self.beta_ssm = f.new((cfg.d_model,), "ones", axes=("embed",))


# ------------------------------------------------------------- sublayers
def attn_sublayer(
    x: torch.Tensor,
    p: DenseBlock | MoEBlock | HybridBlock,
    cfg: ModelConfig,
    *,
    pos: torch.Tensor,  # (S,) absolute positions of x's tokens
    cache: tuple[torch.Tensor, torch.Tensor] | None,  # (B, T, K, hd) each, written in place
    offset: int,
    rows: torch.Tensor | None = None,  # batch rows whose cache is written
    window: int = 0,  # 0: global attention
    causal: bool = True,  # False: every query sees every key (the encoder's)
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
    out = flash_attention(q, k, v, causal=causal, softcap=cfg.attn_softcap, window=window)
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
    p: DenseBlock | MoEBlock | RWKVBlock | HybridBlock,
    cfg: ModelConfig,
    *,
    pos: torch.Tensor,
    cache: dict[str, torch.Tensor] | None,
    offset: int,
    rows: torch.Tensor | None = None,
    window: int = 0,
    lay=None,
    layer: int = 0,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One decoder block: (x, the MoE router's aux loss, None for the other
    families); with a layout ``lay``, :func:`block_apply_tp` (a cache only
    with a serving layout; on an FSDP layout, on ``layer``'s leaves gathered
    by :func:`gather_block`).  The cache (if any) is updated in place, only batch ``rows``
    of it when given.  A dense or MoE block's cache is its layer's ``k`` and
    ``v``; an RWKV block's its layer's ``tm_shift``, ``cm_shift`` and
    ``wkv`` state, which the block reads and replaces; a hybrid block's
    ``k`` and ``v`` and the SSM head's ``conv`` and ``h`` state.  An MoE
    block routes every row of ``x``, ``rows`` or not: the capacity buffer
    is shared, so the rows present decide the drops."""
    if lay is not None:
        if lay.fsdp:
            p = gather_block(p, lay, layer)
        return block_apply_tp(x, p, cfg, lay, pos=pos, window=window, cache=cache,
                              offset=offset, rows=rows)
    if cfg.family == "rwkv":
        x, new = rwkv_block(x, p, cfg, cache)
        if cache is not None:
            _write_state(cache, new, rows)
        return x, None
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
    if cfg.family == "moe":
        y, aux = moe_block(h, p.router, p.we_i, p.we_g, p.we_o, cfg.topk,
                           mode="c2d" if cfg.c2d_embedding else "replicated")
        return x + y, aux
    return x + mlp(h, p.wi, getattr(p, "wg", None), p.wo2, cfg.act), None


# ------------------------------------------------------ on a mesh (training)
def _region_kv(t: torch.Tensor, cfg: ModelConfig, lay, b: int, s: int, hl: int) -> torch.Tensor:
    """This rank's K (or V) heads for its ``hl`` query heads, from its
    columns ``t`` of the K (V) projection.  Where the KV heads divide
    ``model`` the columns are those heads; where ``kv_dim`` divides but the
    heads do not (the flat dim cut mid-head, as JAX's rule cuts it) the
    columns are all-gathered and the rank takes the one head its query
    heads read."""
    m, kh, hd = lay.model, cfg.n_kv_heads, cfg.head_dim
    if kh % m == 0:
        return t.reshape(b, s, kh // m, hd)
    group = cfg.n_heads // kh  # query heads a KV head
    if group % hl:
        raise ValueError(f"{cfg.name}: the {hl} query heads of a rank straddle KV heads "
                         f"({cfg.n_heads} heads over {kh} KV heads on {m} model ranks)")
    full = gather_from_region(t, lay.mesh, "model", dim=-1, partial=True)
    head = lay.mesh.axis_index("model") * hl // group
    return full.reshape(b, s, kh, hd)[:, :, head : head + 1]


def sp_attention(cfg: ModelConfig, lay, s: int) -> bool:
    """JAX's ``sp_attn``: the heads do not divide ``model`` and the
    positions do."""
    return (lay.model > 1 and cfg.n_heads % lay.model != 0 and s % lay.model == 0 and s > 1)


def attn_sublayer_tp(x: torch.Tensor, p, cfg: ModelConfig, lay, *, pos: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """:func:`attn_sublayer` on this rank's weights (no cache)."""
    b, s, _ = x.shape
    mesh = lay.mesh
    bias = [getattr(p, n, None) for n in ("bq", "bk", "bv")]
    if lay.split("wq", 1):  # head parallel
        if not lay.split("wk", 1):
            raise ValueError(f"{cfg.name}: kv_dim {cfg.kv_dim} does not divide over "
                             f"{lay.model} model ranks, the query heads do")
        hl = cfg.n_heads // lay.model
        xin = copy_to_region(x, mesh)
        q, k, v = xin @ p.wq, xin @ p.wk, xin @ p.wv
        if bias[0] is not None:
            q, k, v = q + bias[0], k + bias[1], v + bias[2]
        q = q.reshape(b, s, hl, cfg.head_dim)
        k, v = (_region_kv(t, cfg, lay, b, s, hl) for t in (k, v))
        q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
        out = flash_attention(q, k, v, causal=True, softcap=cfg.attn_softcap, window=window)
        return reduce_from_region(out.reshape(b, s, -1) @ p.wo, mesh)
    if not sp_attention(cfg, lay, s):  # weights whole, every rank the same work
        return attn_sublayer(x, p, cfg, pos=pos, cache=None, offset=0, window=window)
    # sequence parallel: this rank's S/|model| positions, the weights whole
    sl, me = s // lay.model, mesh.axis_index("model")
    xs = scatter_to_region(x, mesh, "model", dim=1)
    w = [copy_to_region(t, mesh) if t is not None else None
         for t in (p.wq, p.wk, p.wv, *bias, p.wo)]
    q, k, v = qkv_proj(xs, *w[:6], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                       head_dim=cfg.head_dim)
    pl = pos[me * sl : (me + 1) * sl]
    q, k = rope(q, pl, cfg.rope_theta), rope(k, pl, cfg.rope_theta)
    hpos = torch.arange(s)  # attend_sp reads the positions on the host
    out = attend_sp(q, k, v, q_pos=hpos, k_pos=hpos, mesh=mesh, causal=True, window=window,
                    cap=cfg.attn_softcap)
    return gather_from_region(out.reshape(b, sl, -1) @ w[6], mesh, "model", dim=1)


def mlp_tp(x: torch.Tensor, p, cfg: ModelConfig, lay) -> torch.Tensor:
    """The MLP on this rank's ``ffn`` columns (``wi``, ``wg``) and rows
    (``wo2``): one psum; the whole MLP where ``ffn`` does not divide."""
    wg = getattr(p, "wg", None)
    if not lay.split("wi", 1):
        return mlp(x, p.wi, wg, p.wo2, cfg.act)
    return reduce_from_region(mlp(copy_to_region(x, lay.mesh), p.wi, wg, p.wo2, cfg.act),
                              lay.mesh)


def moe_tp(x: torch.Tensor, p, cfg: ModelConfig, lay) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE block on this rank's experts: the ``all_to_all`` dispatch,
    its output gathered back over the positions (eplocal's is whole).  A
    model axis of one rank takes it too, as JAX's switch does (one
    capacity a rank, not an expert)."""
    if not (cfg.c2d_embedding and (lay.model == 1 or lay.split("we_i", 0))):
        raise NotImplementedError(
            f"{cfg.name}: a mesh whose model axis does not cut the experts, or the "
            "replicated dispatch, has no sharded train path")
    y, aux = moe_block(x, p.router, p.we_i, p.we_g, p.we_o, cfg.topk, mode="c2d",
                       mesh=lay.mesh)
    if y.shape[1] != x.shape[1]:
        y = gather_from_region(y, lay.mesh, "model", dim=1)
    return y, aux


def block_apply_tp(x: torch.Tensor, p, cfg: ModelConfig, lay, *, pos: torch.Tensor,
                   window: int = 0, cache: dict[str, torch.Tensor] | None = None,
                   offset: int = 0, rows: torch.Tensor | None = None,
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`block_apply` on this rank's weights: (x, aux).  A train
    layout takes no cache; a serving layout takes this rank's blocks of the
    layer's cache, written in place (only the rank's ``rows``, a mask of
    its batch rows, when given), and an embed-cut ``x``."""
    if lay.serving:
        if cache is None:
            raise ValueError("a serving layout runs with a cache (init_kv_cache(mesh=))")
        return block_serve(x, p, cfg, lay, pos=pos, cache=cache, offset=offset, rows=rows,
                           window=window)
    if cache is not None:
        raise ValueError("a train layout takes no cache: serve with zoo.serve_layout's specs")
    if cfg.family == "rwkv":
        return rwkv_block_tp(x, p, cfg, lay), None
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    att = attn_sublayer_tp(h, p, cfg, lay, pos=pos, window=window)
    if cfg.family == "hybrid":
        att = 0.5 * (att * p.beta_attn + ssm_head_tp(h, p.ssm, cfg, lay) * p.beta_ssm)
    x = x + att
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe_tp(h, p, cfg, lay)
        return x + y, aux
    return x + mlp_tp(h, p, cfg, lay), None


def as_leaves(leaves: dict[str, torch.Tensor]) -> SimpleNamespace:
    """Tensors by dotted name (``wq``, ``tm.wr``) as attributes, nested as
    the module holds them: what the block functions read of a block."""
    root = SimpleNamespace()
    for name, t in leaves.items():
        *path, leaf = name.split(".")
        node = root
        for part in path:
            if not hasattr(node, part):
                setattr(node, part, SimpleNamespace())
            node = getattr(node, part)
        setattr(node, leaf, t)
    return root


def gather_block(p: nn.Module, lay, layer: int) -> SimpleNamespace:
    """Layer ``layer``'s leaves on an FSDP layout: each of this rank's
    blocks (cut over ``data``) all-gathered to its TP block, in the block's
    parameter order (:meth:`~repro_torch.sharding.partition.Layout.gather`)."""
    return as_leaves({n: lay.gather(f"blocks.{layer}.{n}", t) for n, t in p.named_parameters()})


# ------------------------------------------------------- on a mesh (serving)
def merge_slices(out: torch.Tensor, lse: torch.Tensor, mesh) -> torch.Tensor:
    """The attention of every key from each ``model`` rank's attention over
    its T-slice: ``out`` (B, S, H, d) and ``lse`` (B, H, S) f32, a row that
    saw none of the slice's keys 0 and -inf.  The partial softmax stats come
    back in one all-gather of ``out`` beside ``lse``, B S H (d + 1) f32 a
    rank, and every rank merges them: weights ``exp(lse_r - max_r lse)``
    (a keyless slice's 0), the weighted outputs summed over the slices and
    divided by the weights' sum.  A pmax of the lse and a psum of the
    weighted outputs give the same sums in two collectives; an all-to-all
    of head groups would move as many bytes and needs the heads to divide
    ``model``, which hymba's do not."""
    both = mesh.all_gather(torch.cat([out.float(), lse.permute(0, 2, 1)[..., None]],
                                     dim=-1)[None], "model", dim=0)  # (m, B, S, H, d + 1)
    w = torch.exp(both[..., -1:] - both[..., -1:].amax(0))
    return ((both[..., :-1] * w).sum(0) / w.sum(0)).to(out.dtype)


def attn_serve(h: torch.Tensor, p, cfg: ModelConfig, lay, *, pos: torch.Tensor,
               cache: dict[str, torch.Tensor], offset: int, rows: torch.Tensor | None,
               window: int) -> torch.Tensor:
    """:func:`attn_sublayer` with a cache on a serving layout: ``h`` the
    embed-cut normed input of every row, ``cache`` the rank's ``k`` and
    ``v`` blocks (its rows; its T-slice where ``cache_specs`` cuts T over
    ``model``).  Returns the sublayer's embed-cut output, summed."""
    mesh, m = lay.mesh, lay.model
    n, s, _ = h.shape
    hd, nh, nk = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q, k, v = lay.sum_rows_parts(h @ p.wq, h @ p.wk, h @ p.wv)  # its rows, its columns
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    b = q.shape[0]
    k_cache, v_cache = cache["k"], cache["v"]
    t_loc = k_cache.shape[1]
    t_cut = lay.cache_specs["k"][2] == "model"
    lo = mesh.axis_index("model") * t_loc if t_cut else 0
    t_max = t_loc * m if t_cut else t_loc
    if lay.split("wq", 1) and nh % m == 0 and offset == 0 and s == t_max:
        # the fresh K/V on the rank's heads, then K and V re-laid from
        # heads to this rank's positions: one all-to-all each (JAX's s == t_max)
        if not lay.split("wk", 1):
            raise ValueError(f"{cfg.name}: kv_dim {cfg.kv_dim} does not divide over {m} model "
                             "ranks, the query heads do")
        hl = nh // m
        qh = rope(q.reshape(b, s, hl, hd), pos, cfg.rope_theta)
        kh, vh = (_region_kv(t, cfg, lay, b, s, hl) for t in (k, v))
        out = flash_attention(qh, rope(kh, pos, cfg.rope_theta), vh, causal=True,
                              softcap=cfg.attn_softcap, window=window).reshape(b, s, -1)
        km, vm = ((mesh.all_to_all(t, "model", split_dim=1, concat_dim=2) if t_cut
                   else lay.gather_model(t)).reshape(b, t_loc, nk, hd) for t in (k, v))
        update_kv_cache(k_cache, v_cache, rope(km, pos[lo : lo + t_loc], cfg.rope_theta), vm,
                        0, rows)
    else:
        # every query head and the new K/V on each model rank; the rank
        # writes the positions it owns and attends over its slice
        if not (lay.split("wq", 1) == lay.split("wk", 1) == lay.split("wv", 1)):
            raise ValueError(f"{cfg.name}: the q, k and v columns are cut over model in part")
        qa, ka, va = lay.gather_model_parts(q, k, v) if lay.split("wq", 1) else (q, k, v)
        qa = rope(qa.reshape(b, s, nh, hd), pos, cfg.rope_theta)
        ka = rope(ka.reshape(b, s, nk, hd), pos, cfg.rope_theta)
        va = va.reshape(b, s, nk, hd)
        a, e = max(offset, lo), min(offset + s, lo + t_loc)
        if a < e:
            update_kv_cache(k_cache, v_cache, ka[:, a - offset : e - offset],
                            va[:, a - offset : e - offset], a - lo, rows)
        kk, vv = (c if c.dtype == qa.dtype else c.to(qa.dtype) for c in (k_cache, v_cache))
        out, lse = flash_attention(qa, kk, vv, causal=True, softcap=cfg.attn_softcap,
                                   window=window, diag=offset - lo, return_lse=True)
        if t_cut and m > 1:
            out = merge_slices(out, lse, mesh)
        out = out.reshape(b, s, nh * hd)
        if lay.split("wo", 0):
            out = lay.model_block(out)
    y = lay.all_rows(out, n) @ p.wo
    return lay.sum_model(y) if lay.split("wo", 0) else y


def mlp_serve(h: torch.Tensor, p, cfg: ModelConfig, lay) -> torch.Tensor:
    """:func:`mlp` of an embed-cut ``h``: ``wi`` and ``wg`` summed over
    ``data`` in one psum (every row), ``wo2`` over ``model``."""
    wg = getattr(p, "wg", None)
    both = h @ p.wi if wg is None else torch.cat([h @ p.wi, h @ wg], dim=-1)
    both = lay.sum_data(both)
    f = p.wi.shape[1]
    a = activation(both[..., :f], cfg.act)
    if wg is not None:
        a = a * both[..., f:]
    y = a @ p.wo2
    return lay.sum_model(y) if lay.split("wo2", 0) else y


def moe_serve(h: torch.Tensor, p, cfg: ModelConfig, lay) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE block of an embed-cut ``h`` on the rank's experts
    (:func:`~repro_torch.models.moe.moe_block_serve`: ``moe_block_a2a``'s
    dispatch and buckets, or its eplocal path in decode, with each
    expert's embed dim cut over ``data``)."""
    if not (cfg.c2d_embedding and (lay.model == 1 or lay.split("we_i", 0))):
        raise NotImplementedError(
            f"{cfg.name}: a mesh whose model axis does not cut the experts, or the "
            "replicated dispatch, has no sharded serving path")
    return moe_block_serve(h, p.router, p.we_i, p.we_g, p.we_o, cfg.topk, lay)


def block_serve(x: torch.Tensor, p, cfg: ModelConfig, lay, *, pos: torch.Tensor,
                cache: dict[str, torch.Tensor], offset: int, rows: torch.Tensor | None,
                window: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`block_apply` on a serving layout: ``x`` the embed-cut
    residual stream of every row, ``cache`` the rank's blocks of the
    layer's cache (written in place)."""
    if cfg.family == "rwkv":
        x, new = rwkv_block_serve(x, p, cfg, lay, cache)
        _write_state(cache, new, rows)
        return x, None
    h = rms_norm_serve(x, p.ln1, cfg.norm_eps, lay)
    att = attn_serve(h, p, cfg, lay, pos=pos, cache=cache, offset=offset, rows=rows,
                     window=window)
    if cfg.family == "hybrid":
        out, new = ssm_head_serve(h, p.ssm, cfg, lay, {"conv": cache["conv"], "h": cache["h"]})
        att = 0.5 * (att * p.beta_attn + out * p.beta_ssm)
        _write_state(cache, new, rows)
    x = x + att
    h = rms_norm_serve(x, p.ln2, cfg.norm_eps, lay)
    if cfg.family == "moe":
        y, aux = moe_serve(h, p, cfg, lay)
        return x + y, aux
    return x + mlp_serve(h, p, cfg, lay), None


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
    lay=None,
) -> tuple[torch.Tensor, torch.Tensor | float]:
    """(x, aux): the stack's output and its layers' aux losses summed in
    layer order over ``n_layers`` (the JAX scan's carry), 0.0 for the
    families without one.  ``lay``: each block on this rank's weights."""
    windows = layer_windows(cfg)
    remat = cfg.remat and caches is None and torch.is_grad_enabled() and (
        x.requires_grad or any(w.requires_grad for w in blocks.parameters()))
    aux = None
    for layer, p in enumerate(blocks):
        if remat:
            x, aux_l = checkpoint(block_apply, x, p, cfg, pos=pos, cache=None, offset=offset,
                                  window=int(windows[layer]), lay=lay, layer=layer,
                                  use_reentrant=False)
        else:
            cache = (None if caches is None
                     else {name: leaf[layer] for name, leaf in caches.items()})
            x, aux_l = block_apply(x, p, cfg, pos=pos, cache=cache, offset=offset, rows=rows,
                                   window=int(windows[layer]), lay=lay, layer=layer)
        if aux_l is not None:
            aux = aux_l if aux is None else aux + aux_l
    return x, (0.0 if aux is None else aux / cfg.n_layers)
