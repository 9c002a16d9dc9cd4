"""Logical-axis -> mesh partition rules (the port's own copy of
``repro.sharding.partition``).

Every parameter leaf carries a tuple of *logical* axis names
(``("layers", "embed", "ffn")`` and so on; ``repro_torch.models.zoo.
logical_axes``).  This module maps logical axes onto mesh axes with
divisibility checking: a rule applies only if the dim divides by the mesh
axis's extent, otherwise the dim stays whole.

Default rules (Megatron-style TP over ``model``):

    vocab   -> model    (c2d embedding + vocab-parallel LM head)
    ffn     -> model    (MLP column/row parallel, one psum per block)
    q_dim   -> model    (attention column parallel on the flat head dim)
    kv_dim  -> model    (GQA K/V projections where kv_dim divides)
    heads   -> model    (per-head state, e.g. RWKV's u bonus)
    experts -> model    (EP: the token all_to_all is the X-RDMA dispatch)
    embed   -> None     (activations stay batch-sharded; no 2D weight TP)
    layers  -> None     (the layer axis)

ZeRO-1: optimizer moments additionally shard their largest free dim over
``data``.  FSDP (ZeRO-3): the parameters themselves too, the moments with
them.

A spec is a plain tuple, one entry a dim (trailing ``None`` dropped, as
``PartitionSpec`` prints): a mesh axis name, a tuple of names (several
axes on one dim, outermost first), or ``None`` (the dim whole).  The
builders take any mesh with ``names`` and ``shape`` (name -> size): a
:class:`~repro_torch.sharding.mesh.Mesh`, or a :class:`MeshShape` that
holds no ranks.  :func:`local_block` cuts a rank's block of a full leaf
and :func:`full_leaf` gathers the blocks back.

A :class:`Layout` holds a model's specs under one set of rules: the train
rules (:func:`rules_for_train`), with the parameters kept at their TP
blocks (ZeRO-1) or cut over ``data`` as well (``fsdp``), or
:data:`SERVE_RULES`, whose ``embed`` dims are cut over ``data`` as well.
Serving keeps the weights where those specs put them and moves
activations instead: the residual stream is held
as every batch row's slice of the embed dim that the rank's data index
owns, a product with a weight whose embed dim is cut sums its partial rows
over ``data``, and the KV cache's blocks follow :func:`cache_specs`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

import torch

DATA_AXES = ("pod", "data")  # batch-like mesh axes, outermost first

DEFAULT_RULES: dict[str, str | None] = {
    "vocab": "model",
    "ffn": "model",
    "q_dim": "model",
    "kv_dim": "model",
    "heads": "model",
    "experts": "model",
    "embed": None,
    "layers": None,
}

# Serving: weights stationary, sharded 2-D (TP over model plus embed over data)
SERVE_RULES: dict[str, str | None] = {**DEFAULT_RULES, "embed": "data"}

Spec = tuple


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no ranks behind them: what the
    spec builders read."""

    sizes: tuple[int, ...]
    names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.names, self.sizes))


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.names)


def rules_for_train(cfg, mesh) -> dict[str, str | None]:
    """Per-arch train rules: where the head count does not divide ``model``
    (hymba's 25 heads), the attention and SSM projections are not tensor
    parallel: their weights stay whole over ``model`` and attention runs
    sequence-parallel (``attend_sp``)."""
    rules = dict(DEFAULT_RULES)
    if "model" in _names(mesh) and cfg.n_heads % mesh.shape["model"] != 0:
        rules["q_dim"] = None
        rules["kv_dim"] = None
        rules["heads"] = None
    return rules


def data_axes(mesh) -> tuple[str, ...]:
    """The mesh's batch-like axes (:data:`DATA_AXES`), outermost first."""
    return tuple(a for a in DATA_AXES if a in _names(mesh))


def axis_size(mesh, axes: str | tuple[str, ...]) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def divisible(dim: int, mesh, axes: str | tuple[str, ...]) -> bool:
    return dim % axis_size(mesh, axes) == 0


def _strip(parts: list) -> Spec:
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_for(
    shape: tuple[int, ...],
    logical: tuple[str | None, ...],
    mesh,
    rules: Mapping[str, str | None] = DEFAULT_RULES,
) -> Spec:
    """The spec of one leaf, honouring divisibility; a mesh axis shards at
    most one dim, the first that asks for it."""
    parts: list[Any] = []
    used: set[str] = set()
    names = _names(mesh)
    for dim, name in zip(shape, logical):
        ax = rules.get(name) if name else None
        if ax is None or ax not in names or ax in used:
            parts.append(None)
        elif divisible(dim, mesh, ax):
            parts.append(ax)
            used.add(ax)
        else:
            parts.append(None)
    return _strip(parts)


def param_specs(
    shapes: Mapping[str, tuple[int, ...]],
    axes: Mapping[str, tuple[str | None, ...]],
    mesh,
    rules: Mapping[str, str | None] = DEFAULT_RULES,
) -> dict[str, Spec]:
    """Each leaf's spec (``param_shardings``)."""
    return {k: spec_for(tuple(s), axes[k], mesh, rules) for k, s in shapes.items()}


def zero1_specs(
    shapes: Mapping[str, tuple[int, ...]],
    axes: Mapping[str, tuple[str | None, ...]],
    mesh,
    rules: Mapping[str, str | None] = DEFAULT_RULES,
    enabled: bool = True,
) -> dict[str, Spec]:
    """Moment specs (``zero1_shardings``): the param spec plus the data
    axes on the largest free dim that divides (the last of equal ones)."""
    d_axes = data_axes(mesh)
    out = {}
    for k, shape in shapes.items():
        shape = tuple(shape)
        base = spec_for(shape, axes[k], mesh, rules)
        parts = list(base) + [None] * (len(shape) - len(base))
        if enabled and d_axes:
            free = [(dim, i) for i, (dim, s) in enumerate(zip(shape, parts))
                    if s is None and divisible(dim, mesh, d_axes)]
            if free:
                _, i = max(free)
                parts[i] = d_axes if len(d_axes) > 1 else d_axes[0]
        out[k] = _strip(parts)
    return out


def fsdp_specs(shapes, axes, mesh, rules: Mapping[str, str | None] = DEFAULT_RULES
               ) -> dict[str, Spec]:
    """ZeRO-3/FSDP parameter specs (``fsdp_shardings``): the TP spec plus
    ``data`` on the largest free dim of every leaf."""
    return zero1_specs(shapes, axes, mesh, rules, enabled=True)


def state_specs(shapes, axes, mesh, rules: Mapping[str, str | None] = DEFAULT_RULES,
                zero1: bool = True, fsdp: bool = False) -> dict[str, Any]:
    """Specs of the train state ``{"params", "opt": OptState(m, v, count),
    "step"}`` (``state_shardings``)."""
    from ..optim.adamw import OptState

    if fsdp:
        p_sp = fsdp_specs(shapes, axes, mesh, rules)
        m_sp = p_sp if zero1 else param_specs(shapes, axes, mesh, rules)
    else:
        p_sp = param_specs(shapes, axes, mesh, rules)
        m_sp = zero1_specs(shapes, axes, mesh, rules, enabled=zero1)
    return {"params": p_sp, "opt": OptState(m=dict(m_sp), v=dict(m_sp), count=()),
            "step": ()}


def batch_specs(shapes: Mapping[str, tuple[int, ...]], mesh) -> dict[str, Spec]:
    """Batch inputs (``batch_shardings``): the leading dim over the data
    axes when it divides."""
    d = data_axes(mesh)
    out = {}
    for k, shape in shapes.items():
        if d and len(shape) and divisible(shape[0], mesh, d):
            out[k] = (d if len(d) > 1 else d[0],)
        else:
            out[k] = ()
    return out


def cache_specs(shapes: Mapping[str, tuple[int, ...]], mesh) -> dict[str, Spec]:
    """Decode caches (``cache_shardings``): batch -> data when it divides,
    time (or heads) -> model when it divides and is longer than 1.  Every
    dim is listed, as the reference builds its ``PartitionSpec``."""
    d = data_axes(mesh)
    d_spec = d if len(d) > 1 else (d[0] if d else None)
    out = {}
    for k, shape in shapes.items():
        parts: list[Any] = [None] * len(shape)
        if len(shape) >= 2 and d and divisible(shape[1], mesh, d):
            parts[1] = d_spec
        if len(shape) >= 3 and shape[2] > 1 and divisible(shape[2], mesh, "model"):
            parts[2] = "model"
        out[k] = tuple(parts)
    return out


# ------------------------------------------------------------------ blocks
def block_shape(shape: tuple[int, ...], spec: Spec, mesh) -> tuple[int, ...]:
    """The shape of a rank's block of a leaf of ``shape`` under ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        axes = _dim_axes(entry)
        if axes:
            out[dim] //= axis_size(mesh, axes)
    return tuple(out)


def _dim_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> tuple[str, ...]:
    """Every mesh axis a spec shards over."""
    return tuple(a for entry in spec for a in _dim_axes(entry))


def local_block(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view; ``mesh`` a
    :class:`~repro_torch.sharding.mesh.Mesh`)."""
    out = full
    for dim, entry in enumerate(spec):
        axes = _dim_axes(entry)
        if axes:
            n = axis_size(mesh, axes)
            if out.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split over {axes}")
            size = out.shape[dim] // n
            out = out.narrow(dim, mesh.axis_index(axes) * size, size)
    return out


@torch.no_grad()
def full_leaf(block: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's ``block``: an all-gather over each
    sharded dim's axes (forward only; every rank of the mesh calls it)."""
    out = block
    for dim, entry in enumerate(spec):
        axes = _dim_axes(entry)
        if axes:
            out = mesh.all_gather(out, axes if len(axes) > 1 else axes[0], dim=dim)
    return out


# ------------------------------------------------------------------ layout
#: the module lists that hold one module a layer, by the prefix of the JAX
#: leaves they stack (the decoder's blocks and an encoder's), and the config
#: field that holds each one's depth
DEPTH_FIELD = {"blocks": "n_layers", "enc": "enc_layers"}
LAYER_STACKS = tuple(DEPTH_FIELD)


def split_layer(name: str) -> tuple[str, int, str] | None:
    """``(stack, layer, leaf)`` of a port parameter name that a layer owns
    (``blocks.3.wq`` -> ``("blocks", 3, "wq")``); None for any other
    (``enc.final_ln``, ``embed.tok``)."""
    parts = name.split(".", 2)
    if len(parts) == 3 and parts[0] in LAYER_STACKS and parts[1].isdigit():
        return parts[0], int(parts[1]), parts[2]
    return None


def leaf_key(name: str) -> str:
    """The key a port parameter's spec is kept under: ``blocks.<layer>.X``
    is ``blocks.X`` and an encoder's ``enc.<layer>.X`` is ``enc.X`` (every
    layer shares its leaves' specs), any other name is itself."""
    owner = split_layer(name)
    return name if owner is None else f"{owner[0]}.{owner[2]}"


class Layout:
    """A model's leaves laid out on a mesh under ``rules``: each leaf's
    param spec and moment spec, by :func:`leaf_key`, and what the forward
    and the optimizer do with them.  ``shapes`` and ``axes`` are one
    layer's leaves (no ``layers`` axis) and the others.  ``tp`` holds each
    leaf's TP spec (the rules' alone), the block a layer computes with.
    Under ZeRO-1 the params are those blocks and the moments cut a free dim
    over the data axes as well (``zero1_specs``).  With ``fsdp`` the params
    are cut like the moments (``fsdp_specs``): a leaf's block is
    all-gathered to its TP block where it is used (:meth:`gather`), whose
    backward reduce-scatters the gradient.  Where JAX's spec of a stacked
    leaf cuts its ``layers`` dim, the port's per-layer leaf cuts its own
    largest free dim that divides, or stays whole.  Under rules that cut
    ``embed`` (:data:`SERVE_RULES`) the layout is a serving one
    (``serving``); ``cache_specs``, the specs of the KV cache's blocks by
    leaf (a layer's, with its ``layers`` dim), is what its forward reads of
    the cache's layout."""

    def __init__(self, mesh, shapes: Mapping[str, tuple[int, ...]],
                 axes: Mapping[str, tuple[str | None, ...]], rules: Mapping[str, str | None],
                 zero1: bool = True, cache_specs: Mapping[str, Spec] | None = None,
                 fsdp: bool = False) -> None:
        if fsdp and not zero1:
            raise ValueError("fsdp=True needs zero1=True: FSDP parameters with moments at "
                             "the TP specs is a layout JAX reaches only through GSPMD "
                             "(constrain=None), and the port does not build it (ROADMAP.md)")
        self.mesh = mesh
        self.rules = dict(rules)
        self.fsdp = fsdp
        self.tp = param_specs(shapes, axes, mesh, rules)
        self.moments = zero1_specs(shapes, axes, mesh, rules, enabled=zero1)
        self.params = self.moments if fsdp else self.tp
        self.data = data_axes(mesh)
        self.model = mesh.shape["model"] if "model" in _names(mesh) else 1
        self.serving = self.rules.get("embed") is not None
        # the ranks the embed dim is cut over: a serving layout's data axes
        self.dn = axis_size(mesh, self.data) if self.serving and self.data else 1
        self.cache_specs = dict(cache_specs or {})

    # -------------------------------------------------------------- forward
    def split(self, name: str, dim: int) -> bool:
        """Is dim ``dim`` of the leaf ``name`` cut over ``model``?  ``name`` is
        a port name, a key, or a block's leaf (``wq``, ``tm.wr``).  Over a
        model axis of one rank nothing is cut: the forward is the
        unsharded one."""
        if self.model == 1:
            return False
        key = leaf_key(name)
        spec = self.tp[key] if key in self.tp else self.tp["blocks." + key]
        return dim < len(spec) and "model" in _dim_axes(spec[dim])

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` rows (``batch_specs``)."""
        if not self.data:
            return slice(0, n)
        d = axis_size(self.mesh, self.data)
        if n % d:
            raise ValueError(f"a batch of {n} rows does not split over the data axes "
                             f"{self.data} of {d} ranks")
        i = self.mesh.axis_index(self.data)
        return slice(i * n // d, (i + 1) * n // d)

    # ------------------------------------------------------- ZeRO-1, FSDP
    def _data_axes(self):
        return self.data if len(self.data) > 1 else self.data[0]

    def zero_dim(self, name: str) -> int | None:
        """The dim of ``name``'s moments (and FSDP params) cut over the data
        axes (None: whole over them)."""
        key = leaf_key(name)
        p, m = self.tp[key], self.moments[key]
        for dim, entry in enumerate(m):
            if entry is not None and (dim >= len(p) or p[dim] is None):
                return dim
        return None

    def _update_dim(self, name: str) -> int | None:
        """The dim of ``name``'s param block that the update cuts to the
        moment block: ZeRO-1's data dim; none under FSDP, whose param block
        is the moment block."""
        return None if self.fsdp else self.zero_dim(name)

    def block_shape(self, name: str, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The moment block's shape of a param block of ``shape``."""
        d = self._update_dim(name)
        if d is None:
            return tuple(shape)
        out = list(shape)
        out[d] //= axis_size(self.mesh, self.data)
        return tuple(out)

    def gather(self, name: str, blk: torch.Tensor) -> torch.Tensor:
        """The TP block of ``name`` from this rank's param block ``blk``: under
        FSDP an all-gather over the data axes whose backward reduce-scatters
        the cotangent (FSDP's gradient reduce-scatter, in the gradient's
        dtype); else ``blk`` itself."""
        d = self.zero_dim(name) if self.fsdp else None
        if d is None:
            return blk
        from .mesh import gather_from_region

        return gather_from_region(blk, self.mesh, self._data_axes(), dim=d, partial=True)

    def reduce_grad(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """This rank's moment block of the sum of ``g`` over the data axes,
        in f32: a reduce-scatter where the moments are cut, else a psum,
        in the gradient's own dtype (a bf16 gradient is summed in bf16, as
        the JAX step's partitioner sums it).  Under FSDP a cut leaf's
        gradient comes reduce-scattered by :meth:`gather`'s backward and is
        only cast."""
        if not self.data:
            return g.float()
        d = self.zero_dim(name)
        if d is None:
            return self.mesh.psum(g, self._data_axes()).float()
        if self.fsdp:
            return g.float()
        return self.mesh.reduce_scatter(g, self._data_axes(), dim=d).float()

    def param_block(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """The block of this rank's param block that its moments cover (a
        view; under FSDP the param block itself)."""
        d = self._update_dim(name)
        if d is None:
            return p
        n = axis_size(self.mesh, self.data)
        size = p.shape[d] // n
        return p.narrow(d, self.mesh.axis_index(self._data_axes()) * size, size)

    def gather_param(self, name: str, blk: torch.Tensor) -> torch.Tensor:
        """The param block from every data rank's updated ``blk`` (under
        FSDP ``blk`` is the param block: no collective)."""
        d = self._update_dim(name)
        return blk if d is None else self.mesh.all_gather(blk, self._data_axes(), dim=d)

    def norm_weight(self, name: str) -> float:
        """One over the number of ranks that hold the same moment block of
        ``name``, so that a sum over every rank counts each element once."""
        held = set(spec_axes(self.moments[leaf_key(name)]))
        return 1.0 / math.prod(n for a, n in self.mesh.shape.items() if a not in held)

    def psum_all(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over every rank of the mesh."""
        return self.mesh.psum(x, tuple(_names(self.mesh)))

    # ------------------------------------------------------------- serving
    # An activation is either "embed-cut": (B, ..., D / dn), every batch row,
    # the embed slice of this rank's data index (the residual stream), or
    # "rows": (B_loc, ..., X), this rank's batch rows (batch_specs') with a
    # dim X that is whole or this rank's model block (attention, the
    # recurrences and the caches).  Over a data axis of one rank, or for a
    # batch the data axes do not split, the rows are every row.
    def row_split(self, n: int) -> bool:
        """Do the data axes cut a batch of ``n`` rows (a serving layout)?"""
        return self.dn > 1 and n % self.dn == 0

    def serve_rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` rows: its block where the
        data axes cut the batch, else every row."""
        if not self.row_split(n):
            return slice(0, n)
        i = self.mesh.axis_index(self.data)
        return slice(i * n // self.dn, (i + 1) * n // self.dn)

    def embed_slice(self, x: torch.Tensor) -> torch.Tensor:
        """The embed slice of this rank's data index of ``x``'s last dim (a view)."""
        if self.dn == 1:
            return x
        size = x.shape[-1] // self.dn
        return x.narrow(-1, self.mesh.axis_index(self.data) * size, size)

    def sum_rows(self, y: torch.Tensor) -> torch.Tensor:
        """Partial products of every row, summed over the data axes, this
        rank's rows of the sum: a reduce-scatter of dim 0 (a psum where
        the rows do not split)."""
        if self.dn == 1:
            return y
        if not self.row_split(y.shape[0]):
            return self.mesh.psum(y, self._data_axes())
        return self.mesh.reduce_scatter(y, self._data_axes(), dim=0)

    def sum_data(self, y: torch.Tensor) -> torch.Tensor:
        """Partial products summed over the data axes, every row."""
        return y if self.dn == 1 else self.mesh.psum(y, self._data_axes())

    def all_rows(self, y: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's rows ``y`` of a batch of ``n`` rows, every row: an
        all-gather of dim 0 over the data axes."""
        if not self.row_split(n):
            return y
        return self.mesh.all_gather(y, self._data_axes(), dim=0)

    def rows_to_embed(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """A "rows" tensor whose last dim is the whole embed dim, embed-cut:
        an all-to-all over the data axes (each rank keeps its slice of
        every row)."""
        if not self.row_split(n):
            return self.embed_slice(t)
        return self.mesh.all_to_all(t, self._data_axes(), split_dim=-1, concat_dim=0)

    def embed_to_rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """An embed-cut tensor of ``n`` rows as this rank's rows with the
        whole embed dim: the inverse all-to-all (an all-gather of the last
        dim where the rows do not split)."""
        if self.dn == 1:
            return t
        if not self.row_split(n):
            return self.mesh.all_gather(t, self._data_axes(), dim=-1)
        return self.mesh.all_to_all(t, self._data_axes(), split_dim=0, concat_dim=-1)

    def sum_model(self, y: torch.Tensor) -> torch.Tensor:
        """Partial products summed over ``model`` (none over one rank)."""
        return y if self.model == 1 else self.mesh.psum(y, "model")

    def gather_model(self, y: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The model ranks' blocks of ``y`` along ``dim``, whole."""
        return y if self.model == 1 else self.mesh.all_gather(y, "model", dim=dim)

    def sum_rows_parts(self, *parts: torch.Tensor) -> list[torch.Tensor]:
        """:meth:`sum_rows` of each of ``parts`` (one last dim each) in one
        collective: their concatenation's."""
        widths = [t.shape[-1] for t in parts]
        return list(self.sum_rows(torch.cat(parts, dim=-1)).split(widths, dim=-1))

    def gather_model_parts(self, *parts: torch.Tensor) -> list[torch.Tensor]:
        """:meth:`gather_model` of the last dim of each of ``parts`` in one
        all-gather: each rank's blocks side by side, then each part's
        blocks in rank order."""
        if self.model == 1:
            return list(parts)
        widths = [t.shape[-1] for t in parts]
        both = self.mesh.all_gather(torch.cat(parts, dim=-1).unsqueeze(-2), "model", dim=-2)
        return [t.flatten(-2) for t in both.split(widths, dim=-1)]

    def model_block(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's model block of ``x`` along ``dim`` (a view)."""
        if self.model == 1:
            return x
        size = x.shape[dim] // self.model
        return x.narrow(dim, self.mesh.axis_index("model") * size, size)
