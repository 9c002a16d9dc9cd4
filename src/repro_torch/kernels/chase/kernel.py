"""The shard-local pointer chase on the card, and its custom op.

Replaces the Pallas TPU kernel ``src/repro/kernels/chase/kernel.py``
(``_chase_kernel`` / ``chase_shard``, the ``pallas_call`` at line 90),
which sweeps VMEM blocks of the shard under a fixed hop budget.  On Hopper
the kernel (``csrc/chase.cu``) runs one thread per chase until the chase
leaves the shard or its depth runs out: the run-to-exit contract of
:func:`.ref.chase_shard_ref`, with no budget that could leave a chase
unfinished.  Two routes (:func:`chase_route`; the source's note has their
designs):

- ``"thread"`` (the first port's layout): 256 threads a block; below
  ``SPREAD_MIN_B`` chases (a message's one chase).
- ``"spread"``: 32 threads a block, so a batched dispatch spreads over SMs.

Both hop by ``__ldg``.

Bound: the launch floor plus the latency of dependent loads.  Each hop
waits for the last, so a launch takes as long as its longest chain; the
bytes it moves (16 B per chase, 4 B per hop) are a far lower bound.  Times
are in ``PERF.md``.

:func:`chase_shard` is the wrapper: a tensor on the CPU takes the plain
version; a CUDA tensor launches one route (counted in
``chase_shard.launches``, by route in ``chase_shard.route_launches``, and
its chases in ``chase_shard.items``) or raises.
``repro_torch::chase_shard`` is the same function as a ``torch.library``
custom op, which the Chaser's shipped slices call for their local loop: a
fake impl lets the host trace them without a card, and the vmap rule turns
a batched dispatch of B Chasers into ONE launch over B chases.
:func:`latency_probe` is a measuring tool on no path (the launch floor and
one load's latency).
"""

from __future__ import annotations

import ctypes

import torch

from ..build import launch_on, load
from .ref import chase_shard_ref

ROUTES = ("thread", "spread")
#: threads a block of each route
ROUTE_THREADS = {"thread": 256, "spread": 32}
#: calls of this many chases take the spread route: on the card it beats
#: the thread route at B = 256 and ties it at B = 1 and 77 (PERF.md)
SPREAD_MIN_B = 128

_launch = None  # the bound C entries, once the library is loaded
_probe = None
_error_string = None


def chase_route(b: int) -> str:
    """The route a CUDA call of ``b`` chases takes."""
    return "spread" if b >= SPREAD_MIN_B else "thread"


def chase_grid(b: int, route: str) -> tuple[int, int]:
    """``(blocks, threads a block)`` of a launch of ``b`` chases on
    ``route``."""
    threads = ROUTE_THREADS[route]
    return -(-b // threads), threads


def _bind():
    global _launch, _probe, _error_string
    lib = load("chase")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.chase_shard_launch.argtypes = [p, p, p, p, p, p, ll, ll, i, ll, p]
    lib.chase_shard_launch.restype = ctypes.c_int
    lib.chase_latency_probe_launch.argtypes = [p, i, ll, i, p, p]
    lib.chase_latency_probe_launch.restype = ctypes.c_int
    lib.chase_shard_error_string.argtypes = [ctypes.c_int]
    lib.chase_shard_error_string.restype = ctypes.c_char_p
    _error_string = lib.chase_shard_error_string
    _probe = lib.chase_latency_probe_launch
    _launch = lib.chase_shard_launch
    return _launch


def _check(table: torch.Tensor, frontier: torch.Tensor, depth: torch.Tensor, lo,
           dev: torch.device) -> None:
    if table.dim() != 1 or frontier.dim() != 1 or frontier.shape != depth.shape:
        raise ValueError(
            f"chase_shard takes an (N_loc,) table and (B,) frontier and depth, got "
            f"{tuple(table.shape)}, {tuple(frontier.shape)} and {tuple(depth.shape)}"
        )
    i32 = torch.int32
    if table.dtype != i32 or frontier.dtype != i32 or depth.dtype != i32:
        raise TypeError(
            f"chase_shard table, frontier and depth must be int32, got {table.dtype}, "
            f"{frontier.dtype} and {depth.dtype}"
        )
    is_t = isinstance(lo, torch.Tensor)
    if is_t and (lo.dtype != i32 or lo.numel() != 1):
        raise TypeError(f"chase_shard lo must be one int32 value, got {lo.dtype} {tuple(lo.shape)}")
    if frontier.device != dev or depth.device != dev or (is_t and lo.device != dev):
        raise ValueError("chase_shard operands must lie on one device")


def chase_shard(
    table: torch.Tensor, frontier: torch.Tensor, depth: torch.Tensor,
    lo: "int | torch.Tensor", *, route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(frontier', depth')``: every chase advanced while it lies in
    ``[lo, lo + N_loc)`` with depth left.  ``lo`` is an int or a
    one-element int32 tensor.  On the card it takes ``route`` (default
    :func:`chase_route`)."""
    dev = table.device
    _check(table, frontier, depth, lo, dev)
    if route is not None and route not in ROUTE_THREADS:
        raise ValueError(f"chase_shard route must be one of {ROUTES}, got {route!r}")
    if dev.type != "cuda":
        if dev.type == "cpu":
            return chase_shard_ref(table, frontier, depth, lo)
        raise ValueError(f"chase_shard has no kernel for device {dev}")
    if not (table.is_contiguous() and frontier.is_contiguous() and depth.is_contiguous()):
        raise ValueError("chase_shard kernel needs contiguous table, frontier and depth")
    # the path's lo is one int32 already (a one-element tensor is contiguous)
    lo_t = lo if isinstance(lo, torch.Tensor) else torch.tensor(
        [int(lo)], dtype=torch.int32, device=dev)
    b = frontier.shape[0]
    f_out = torch.empty(b, dtype=torch.int32, device=dev)
    d_out = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return f_out, d_out
    route = route or chase_route(b)
    blocks, threads = chase_grid(b, route)
    err = launch_on(
        dev, _launch or _bind(), table.data_ptr(), frontier.data_ptr(), depth.data_ptr(),
        lo_t.data_ptr(), f_out.data_ptr(), d_out.data_ptr(), b, table.shape[0], threads,
        blocks,
    )
    chase_shard.launches += 1
    chase_shard.route_launches[route] += 1
    chase_shard.items += b
    if err:
        msg = _error_string(err).decode()
        raise RuntimeError(f"chase_shard {route} launch failed: {msg} ({err})")
    return f_out, d_out


chase_shard.launches = 0
chase_shard.route_launches = dict.fromkeys(ROUTES, 0)
chase_shard.items = 0  # chases run on the card, over all launches


def latency_probe(table: torch.Tensor, start: int, hops: int, cg: bool) -> torch.Tensor:
    """One thread's ``hops`` dependent loads through ``table``, a cycle of
    its own indices on the card, from ``table[start]`` (``cg``: by
    ld.global.cg, else ``__ldg``); returns the last index as a one-element
    tensor.  Not counted: it lies on no path."""
    if table.device.type != "cuda" or table.dtype != torch.int32 or table.dim() != 1:
        raise ValueError("latency_probe takes an int32 cycle table on the card")
    if not 0 <= start < table.shape[0] or hops < 0:
        raise ValueError(f"latency_probe: start {start} outside the table or hops {hops} < 0")
    out = torch.empty(1, dtype=torch.int32, device=table.device)
    if _probe is None:
        _bind()
    err = launch_on(table.device, _probe, table.data_ptr(), start, hops, int(cg), out.data_ptr())
    if err:
        raise RuntimeError(f"latency_probe launch failed: {_error_string(err).decode()} ({err})")
    return out


@torch.library.custom_op("repro_torch::chase_shard", mutates_args=())
def chase_shard_op(
    table: torch.Tensor, frontier: torch.Tensor, depth: torch.Tensor, lo: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    return chase_shard(table, frontier.contiguous(), depth.contiguous(), lo)


@chase_shard_op.register_fake
def _chase_shard_fake(table, frontier, depth, lo):
    return torch.empty_like(frontier), torch.empty_like(depth)


def _chase_shard_vmap(info, in_dims, table, frontier, depth, lo):
    """One launch for a whole batched dispatch: with the table and ``lo``
    shared across the batch (the Chaser's case), the batched frontiers and
    depths flatten into one ``(B * ...,)`` chase."""
    t_dim, f_dim, d_dim, l_dim = in_dims
    if t_dim is not None or l_dim is not None or f_dim is None or d_dim is None:
        raise NotImplementedError("chase_shard batches over frontier and depth only")
    f, d = frontier.movedim(f_dim, 0), depth.movedim(d_dim, 0)
    f_out, d_out = chase_shard_op(table, f.reshape(-1), d.reshape(-1), lo)
    return (f_out.reshape(f.shape), d_out.reshape(d.shape)), (0, 0)


torch.library.register_vmap("repro_torch::chase_shard", _chase_shard_vmap)
