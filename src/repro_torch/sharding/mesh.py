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
reports as ``collective_bytes_per_dev``.

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

#: how long a collective waits for a rank before the run fails (a dead rank
#: fails the others instead of hanging them)
DEFAULT_TIMEOUT = timedelta(seconds=300)

Axes = str | tuple[str, ...]
#: batch-like mesh axes, outermost first (``repro.sharding.partition``'s)
DATA_AXES = ("pod", "data")


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
        self.bytes_by_kind = {"psum": 0, "pmax": 0, "all_gather": 0, "all_to_all": 0}
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
        self.bytes_by_kind = dict.fromkeys(self.bytes_by_kind, 0)

    def _reduce(self, x: torch.Tensor, axis: Axes, op, kind: str) -> torch.Tensor:
        group, _ = self._groups[self._key(axis)]
        y = x.clone(memory_format=torch.contiguous_format)
        self.bytes_by_kind[kind] += y.numel() * y.element_size()
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
        self.bytes_by_kind["all_gather"] += x.numel() * x.element_size()
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

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
        self.bytes_by_kind["all_to_all"] += send.numel() * send.element_size()
        staged = self.backend == "gloo" and send.device.type != "cpu"
        if staged:
            send = send.cpu()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        if staged:
            recv = recv.to(x.device)
        return torch.cat([blk.movedim(0, split_dim) for blk in recv.chunk(n)], concat_dim)

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


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The mesh's batch-like axes (:data:`DATA_AXES`), outermost first."""
    return tuple(a for a in DATA_AXES if a in mesh.names)


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: Axes = "model", dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` when ``x`` is split evenly
    over ``axis`` (a view; ``P(axis)`` in JAX's terms)."""
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis) * size, size)
