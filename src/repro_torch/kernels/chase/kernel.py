"""The shard-local pointer chase on the card, and its custom op.

Replaces the Pallas TPU kernel ``src/repro/kernels/chase/kernel.py``
(``_chase_kernel`` / ``chase_shard``, the ``pallas_call`` at line 90),
which sweeps VMEM blocks of the shard under a fixed hop budget.  On Hopper
the kernel (``csrc/chase.cu``) runs one thread per chase until the chase
leaves the shard or its depth runs out: the run-to-exit contract of
:func:`.ref.chase_shard_ref`, with no budget that could leave a chase
unfinished.

Bound: the latency of dependent loads.  Each hop waits for the last, so a
launch takes as long as its longest chain; the bytes it moves (16 B per
chase, 4 B per hop) are a far lower bound.

:func:`chase_shard` is the wrapper: a tensor on the CPU takes the plain
version, a CUDA tensor launches the kernel (and counts the launch in
``chase_shard.launches``) or raises.  ``repro_torch::chase_shard`` is the
same function as a ``torch.library`` custom op, which the Chaser's shipped
slices call for their local loop: a fake impl lets the host trace them
without a card, and the vmap rule turns a batched dispatch of B Chasers
into ONE launch over B chases.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import load
from .ref import chase_shard_ref


def _library() -> ctypes.CDLL:
    lib = load("chase")
    fn = lib.chase_shard_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.chase_shard_error_string.argtypes = [ctypes.c_int]
        lib.chase_shard_error_string.restype = ctypes.c_char_p
    return lib


def _check(table: torch.Tensor, frontier: torch.Tensor, depth: torch.Tensor, lo) -> None:
    if table.dim() != 1 or frontier.dim() != 1 or frontier.shape != depth.shape:
        raise ValueError(
            f"chase_shard takes an (N_loc,) table and (B,) frontier and depth, got "
            f"{tuple(table.shape)}, {tuple(frontier.shape)} and {tuple(depth.shape)}"
        )
    for name, t in (("table", table), ("frontier", frontier), ("depth", depth)):
        if t.dtype != torch.int32:
            raise TypeError(f"chase_shard {name} must be int32, got {t.dtype}")
    if isinstance(lo, torch.Tensor) and (lo.dtype != torch.int32 or lo.numel() != 1):
        raise TypeError(f"chase_shard lo must be one int32 value, got {lo.dtype} {tuple(lo.shape)}")
    devices = {table.device, frontier.device, depth.device}
    if isinstance(lo, torch.Tensor):
        devices.add(lo.device)
    if len(devices) != 1:
        raise ValueError("chase_shard operands must lie on one device")


def chase_shard(
    table: torch.Tensor, frontier: torch.Tensor, depth: torch.Tensor,
    lo: "int | torch.Tensor",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(frontier', depth')``: every chase advanced while it lies in
    ``[lo, lo + N_loc)`` with depth left.  ``lo`` is an int or a
    one-element int32 tensor."""
    _check(table, frontier, depth, lo)
    if table.device.type == "cpu":
        return chase_shard_ref(table, frontier, depth, lo)
    if table.device.type != "cuda":
        raise ValueError(f"chase_shard has no kernel for device {table.device}")
    if not (table.is_contiguous() and frontier.is_contiguous() and depth.is_contiguous()):
        raise ValueError("chase_shard kernel needs contiguous table, frontier and depth")
    if isinstance(lo, torch.Tensor):
        lo_t = lo.reshape(1).contiguous()
    else:
        lo_t = torch.tensor([int(lo)], dtype=torch.int32, device=table.device)
    f_out, d_out = torch.empty_like(frontier), torch.empty_like(depth)
    b = frontier.shape[0]
    if b == 0:
        return f_out, d_out
    lib = _library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.chase_shard_launch(
            table.data_ptr(), frontier.data_ptr(), depth.data_ptr(), lo_t.data_ptr(),
            f_out.data_ptr(), d_out.data_ptr(), b, table.shape[0], stream,
        )
    chase_shard.launches += 1
    if err:
        msg = lib.chase_shard_error_string(err).decode()
        raise RuntimeError(f"chase_shard launch failed: {msg} ({err})")
    return f_out, d_out


chase_shard.launches = 0


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
