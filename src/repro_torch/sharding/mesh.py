"""A named device mesh over ``torch.distributed``: the port's counterpart of
``jax.sharding.Mesh`` and of the axis vocabulary ``shard_map`` bodies use
(``axis_index``, ``psum``, ``pmax``, ``all_gather``, ``all_to_all``).

A mesh of shape ``(2, 2)`` named ``("data", "model")`` is four ranks laid
out row-major, as ``jax.make_mesh`` lays out devices: rank ``r`` sits at
``(r // 2, r % 2)``.  Every rank builds one process group for each set of
axes and each slice of the mesh along them, in the same order, so a
collective over ``"model"`` runs among the ranks that share a ``"data"``
coordinate.  A set of axes is a name or a tuple of names in mesh order;
over a tuple, ranks are ordered row-major, as JAX orders a multi-axis
collective.

Each collective adds the bytes of its operand (what this rank puts on the
wire; an all-gather's local shard) to :attr:`Mesh.bytes_by_kind`, the
counterpart of the HLO operand bytes that ``benchmarks/dapc_tensor.py``
reports as ``collective_bytes_per_dev``.  A collective run by a backward
adds its bytes there too, and to :attr:`Mesh.bwd_bytes_by_kind`.

The collectives that carry gradients are ``torch.autograd.Function``
classes (:func:`copy_to_region`, :func:`reduce_from_region`,
:func:`gather_from_region`, :func:`scatter_to_region`,
:func:`reduce_scatter_to_region`, :func:`all_to_all_region`): each is the
collective a GSPMD partitioner puts at that point, and its backward the
collective that carries the cotangent back.  They keep one rule: a tensor
that every rank along the axis holds whole carries, on each rank, the
whole cotangent, the same on every rank; a rank's block carries its
block's.  Over an axis of one rank each runs its collective and counts its
bytes all the same, as :meth:`Mesh.psum` does, so a path counts the same
bytes with and without a gradient.

The mesh does not choose a backend behind the caller's back.
:func:`init_mesh` resolves ``backend=None`` from the device (``nccl`` on
the card, ``gloo`` on the CPU) and raises when ``nccl`` is asked for more
ranks than there are cards; several ranks share one card only under
``gloo``, which stages CUDA tensors through the host.  (The sub-groups of
``torch.distributed.device_mesh.DeviceMesh`` pick their backend from the
device type, which is wrong for gloo over CUDA tensors, hence this small
class.)
"""

from __future__ import annotations

import itertools
import math
from datetime import timedelta

import torch
import torch.distributed as dist

from ..core.bitcode import resolve_device
from .partition import DATA_AXES, data_axes  # noqa: F401  (re-exported)

#: how long a collective waits for a rank before the run fails (a dead rank
#: fails the others instead of hanging them)
DEFAULT_TIMEOUT = timedelta(seconds=300)

Axes = str | tuple[str, ...]
_KINDS = ("psum", "pmax", "all_gather", "all_to_all")


class Mesh:
    """Named axes over the ranks of the default process group (which must
    hold exactly ``prod(shape)`` ranks); build with :func:`init_mesh`."""

    def __init__(self, shape, names, device: torch.device, backend: str,
                 timeout: timedelta = DEFAULT_TIMEOUT) -> None:
        shape, names = tuple(int(n) for n in shape), tuple(names)
        if len(shape) != len(names) or len(set(names)) != len(names) or min(shape) < 1:
            raise ValueError(f"mesh shape {shape} and names {names} must pair up, "
                             "names unique, sizes >= 1")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(names, shape))} needs {math.prod(shape)} ranks, "
                             f"the process group has {world}")
        self.names, self.device, self.backend = names, device, backend
        self.shape = dict(zip(names, shape))  # like jax's Mesh.shape: name -> size
        self.rank = dist.get_rank()
        self.coords = dict(zip(names, _unravel(self.rank, shape)))
        # reduce_scatter joins the kinds the first time one runs
        self.bytes_by_kind = dict.fromkeys(_KINDS, 0)
        self.bwd_bytes_by_kind = dict.fromkeys(_KINDS, 0)
        self._backward = False  # set while a Function's backward runs a collective
        # every rank creates every group, in one order (new_group is collective);
        # a group's ranks, ascending, run row-major over its axes
        every = [_unravel(r, shape) for r in range(world)]
        self._groups: dict[tuple[str, ...], tuple[object, int]] = {}
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(range(len(names)), k):
                rest = [i for i in range(len(names)) if i not in axes]
                for fixed in itertools.product(*(range(shape[i]) for i in rest)):
                    ranks = [r for r, c in enumerate(every)
                             if all(c[i] == f for i, f in zip(rest, fixed))]
                    if len(ranks) == world:
                        group = dist.group.WORLD
                    else:
                        group = dist.new_group(ranks, backend=backend, timeout=timeout)
                    if self.rank in ranks:
                        self._groups[tuple(names[i] for i in axes)] = (group, len(ranks))

    def _key(self, axis: Axes) -> tuple[str, ...]:
        key = (axis,) if isinstance(axis, str) else tuple(axis)
        if not key or key not in self._groups:
            raise ValueError(f"mesh axes {axis!r}: expected names of {self.names} in mesh order")
        return key

    def axis_size(self, axis: Axes) -> int:
        return math.prod(self.shape[a] for a in self._key(axis))

    def axis_index(self, axis: Axes) -> int:
        """This rank's index along ``axis`` (row-major over a tuple)."""
        idx = 0
        for a in self._key(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def reset_counters(self) -> None:
        self.bytes_by_kind = dict.fromkeys(_KINDS, 0)
        self.bwd_bytes_by_kind = dict.fromkeys(_KINDS, 0)

    def _count(self, kind: str, x: torch.Tensor) -> None:
        n = x.numel() * x.element_size()
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + n
        if self._backward:
            self.bwd_bytes_by_kind[kind] = self.bwd_bytes_by_kind.get(kind, 0) + n

    def _reduce(self, x: torch.Tensor, axis: Axes, op, kind: str) -> torch.Tensor:
        group, _ = self._groups[self._key(axis)]
        y = x.clone(memory_format=torch.contiguous_format)
        self._count(kind, y)
        dist.all_reduce(y, op=op, group=group)
        return y

    def psum(self, x: torch.Tensor, axis: Axes) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axis``, as a new tensor."""
        return self._reduce(x, axis, dist.ReduceOp.SUM, "psum")

    def pmax(self, x: torch.Tensor, axis: Axes) -> torch.Tensor:
        """The elementwise max of ``x`` over the ranks along ``axis``."""
        return self._reduce(x, axis, dist.ReduceOp.MAX, "pmax")

    def all_gather(self, x: torch.Tensor, axis: Axes, dim: int = 0) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` concatenated on ``dim`` in axis
        order (``jax.lax.all_gather(..., tiled=True)``)."""
        group, n = self._groups[self._key(axis)]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        self._count("all_gather", x)
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    def reduce_scatter(self, x: torch.Tensor, axis: Axes, dim: int = 0) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axis``, cut into as many
        blocks along ``dim`` as the axis has ranks: this rank's block
        (``jax.lax.psum_scatter(..., tiled=True)``).  Counts the operand's
        bytes under ``reduce_scatter``.  Under gloo a CUDA tensor goes
        through pinned host memory."""
        group, n = self._groups[self._key(axis)]
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not split "
                             f"over {n} ranks")
        send = x.movedim(dim, 0).contiguous()
        self._count("reduce_scatter", send)
        staged = self.backend == "gloo" and send.device.type != "cpu"
        if staged:  # the caching host allocator's pinned memory
            send = torch.empty(send.shape, dtype=send.dtype, pin_memory=True).copy_(send)
        out = torch.empty_like(send[: send.shape[0] // n])
        dist.reduce_scatter(out, list(send.chunk(n)), group=group)
        if staged:
            out = out.to(x.device)
        return out.movedim(0, dim)

    def all_to_all(self, x: torch.Tensor, axis: Axes, split_dim: int = 0,
                   concat_dim: int = 0) -> torch.Tensor:
        """``x`` cut into as many blocks along ``split_dim`` as ``axis`` has
        ranks, block ``i`` sent to rank ``i``; the blocks received
        concatenated on ``concat_dim`` in axis order
        (``jax.lax.all_to_all(..., tiled=True)``; with one block a rank
        along dims 0 and 0, also ``tiled=False``).  Under gloo a CUDA tensor
        goes through the host."""
        group, n = self._groups[self._key(axis)]
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split "
                             f"over {n} ranks")
        send = x.movedim(split_dim, 0).contiguous()
        self._count("all_to_all", send)
        staged = self.backend == "gloo" and send.device.type != "cpu"
        if staged:
            send = send.cpu()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        if staged:
            recv = recv.to(x.device)
        return torch.cat([blk.movedim(0, split_dim) for blk in recv.chunk(n)], concat_dim)

    def barrier(self) -> None:
        """Every rank of the mesh waits here (moves no counted bytes)."""
        if self.backend == "nccl":
            index = self.device.index
            dist.barrier(device_ids=[torch.cuda.current_device() if index is None else index])
        else:
            dist.barrier()

    def close(self) -> None:
        """Tear down the process group (every group of every mesh on it)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def _unravel(rank: int, shape: tuple[int, ...]) -> list[int]:
    coords = []
    for n in reversed(shape):
        coords.append(rank % n)
        rank //= n
    return coords[::-1]


def init_mesh(shape, names, device=None, backend: str | None = None, *,
              rank: int | None = None, init_method: str = "env://",
              timeout: timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """A :class:`Mesh` of ``shape`` named ``names`` on ``device`` (default:
    the card, raising without one).  Starts the default process group
    (``init_method``, this ``rank``, ``prod(shape)`` ranks, ``timeout``)
    unless one is running.  ``backend=None`` is ``nccl`` on a CUDA device
    and ``gloo`` on the CPU; ``nccl`` takes one rank a card."""
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    world = math.prod(int(n) for n in shape)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"nccl carries CUDA tensors only, not {device}; use gloo")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(f"nccl takes one rank a card: {world} ranks on {cards} card(s); "
                             "pass backend='gloo' to share a card")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                timeout=timeout)
    elif dist.get_backend() != backend:
        raise ValueError(f"the running process group is {dist.get_backend()}, not {backend}")
    return Mesh(shape, names, device, backend, timeout)


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: Axes = "model", dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` when ``x`` is split evenly
    over ``axis`` (a view; ``P(axis)`` in JAX's terms)."""
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis) * size, size)


# ------------------------------------------------ collectives with gradients
class _Backward:
    """Marks the mesh's collectives as a backward's while it is entered."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh

    def __enter__(self) -> None:
        self.mesh._backward = True

    def __exit__(self, *exc) -> None:
        self.mesh._backward = False


def _block(x: torch.Tensor, mesh: Mesh, axis: Axes, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis) * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with _Backward(ctx.mesh):
            return ctx.mesh.psum(g, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, partial):
        ctx.mesh, ctx.axis, ctx.dim, ctx.partial = mesh, axis, dim, partial
        return mesh.all_gather(x, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            with _Backward(ctx.mesh):
                g = ctx.mesh.reduce_scatter(g, ctx.axis, dim=ctx.dim)
        else:
            g = _block(g, ctx.mesh, ctx.axis, ctx.dim)
        return g, None, None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _block(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        with _Backward(ctx.mesh):
            return ctx.mesh.all_gather(g, ctx.axis, dim=ctx.dim), None, None, None


class _ReduceScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.reduce_scatter(x, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        with _Backward(ctx.mesh):
            return ctx.mesh.all_gather(g, ctx.axis, dim=ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, (split_dim, concat_dim)
        return mesh.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        with _Backward(ctx.mesh):
            g = ctx.mesh.all_to_all(g, ctx.axis, concat_dim, split_dim)
        return g, None, None, None, None


def copy_to_region(x: torch.Tensor, mesh: Mesh, axis: Axes = "model") -> torch.Tensor:
    """Megatron's *f*: ``x`` as it is, for a region whose ranks each use it
    for their own part; the backward sums the ranks' cotangents (a psum)."""
    return _CopyTo.apply(x, mesh, axis)


def reduce_from_region(x: torch.Tensor, mesh: Mesh, axis: Axes = "model") -> torch.Tensor:
    """Megatron's *g*: the psum of the ranks' partial ``x``; the whole
    cotangent goes back to every rank unchanged."""
    return _ReduceFrom.apply(x, mesh, axis)


def gather_from_region(x: torch.Tensor, mesh: Mesh, axis: Axes = "model", dim: int = 0,
                       partial: bool = False) -> torch.Tensor:
    """The ranks' blocks ``x`` all-gathered along ``dim``.  The backward
    takes this rank's block of the cotangent; with ``partial`` (every
    rank's consumers see only part of the gathered tensor, as ``attend_sp``'s
    queries see the keys) it reduce-scatters the cotangent instead."""
    return _GatherFrom.apply(x, mesh, axis, dim, partial)


def scatter_to_region(x: torch.Tensor, mesh: Mesh, axis: Axes = "model",
                      dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor every rank holds whole;
    the backward all-gathers the blocks' cotangents."""
    return _ScatterTo.apply(x, mesh, axis, dim)


def reduce_scatter_to_region(x: torch.Tensor, mesh: Mesh, axis: Axes = "model",
                             dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the psum of the ranks' partial
    ``x``; the backward all-gathers the blocks' cotangents."""
    return _ReduceScatterTo.apply(x, mesh, axis, dim)


def all_to_all_region(x: torch.Tensor, mesh: Mesh, axis: Axes = "model", split_dim: int = 0,
                      concat_dim: int = 0) -> torch.Tensor:
    """:meth:`Mesh.all_to_all` with a gradient: the backward sends each
    block of the cotangent back to the rank it came from."""
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def pmean_region(x: torch.Tensor, mesh: Mesh, axis: Axes) -> torch.Tensor:
    """The mean of the ranks' ``x`` along ``axis``: :func:`reduce_from_region`
    over the axis's size."""
    return reduce_from_region(x, mesh, axis) / mesh.axis_size(axis)
