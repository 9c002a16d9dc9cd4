"""The partial row lookup on the card, and its custom op.

Replaces the Pallas TPU kernel ``src/repro/kernels/embed_lookup/kernel.py``
(``_embed_kernel`` / ``embed_lookup``, the ``pallas_call`` at line 65): a
blocked one-hot MXU matmul, written that way because the TPU has no fast
gather.  On Hopper the kernel (``csrc/embed_lookup.cu``) gathers the rows
directly, one warp per id with 16-byte loads along D.

Bound: bytes moved — 4 bytes per id read, one row read per in-shard id and
one row written per id, no arithmetic.  At the Gather service's batched
shapes (bucket x K ~ 1k ids of 512 B) that is about 1 MB, well under a
microsecond at 3.35 TB/s, so a launch costs more than the copy.

:func:`embed_lookup` is the wrapper: a tensor on the CPU takes the plain
version (:mod:`.ref`), a CUDA tensor launches the kernel (and counts the
launch in ``embed_lookup.launches``) or raises.  ``repro_torch::embed_lookup``
is the same function as a ``torch.library`` custom op, so a traced ifunc
slice can carry it by name: a fake impl lets the host trace the
``cuda-sm90`` slice without a card, and the vmap rule turns a batched
dispatch of B payloads into ONE launch over the flattened ``(B*K,)`` ids.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import load
from .ref import embed_lookup_ref

# f32 and bf16 rows, or f32 rows as their i32 bit patterns (the Gatherer
# resolves bits so its RETURN rows travel bit-cast): the kernel copies bytes
_DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def _library() -> ctypes.CDLL:
    lib = load("embed_lookup")
    fn = lib.embed_lookup_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, ll, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.embed_lookup_error_string.argtypes = [ctypes.c_int]
        lib.embed_lookup_error_string.restype = ctypes.c_char_p
    return lib


def _check(table: torch.Tensor, ids: torch.Tensor, lo) -> None:
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(
            f"embed_lookup takes a (V_loc, D) table and (N,) ids, got "
            f"{tuple(table.shape)} and {tuple(ids.shape)}"
        )
    if table.dtype not in _DTYPES:
        raise TypeError(f"embed_lookup table must be f32, bf16 or i32, got {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"embed_lookup ids must be int32, got {ids.dtype}")
    if ids.device != table.device or (
        isinstance(lo, torch.Tensor) and lo.device != table.device
    ):
        raise ValueError("embed_lookup operands must lie on one device")


def embed_lookup(
    table: torch.Tensor, ids: torch.Tensor, lo: "int | torch.Tensor"
) -> torch.Tensor:
    """Rows ``table[ids[i] - lo]`` for ids in ``[lo, lo + V_loc)``, zero rows
    for every other id (the ``-1`` pad keys included); ``(N, D)`` in the
    table's dtype.  ``lo`` is an int or a one-element int tensor."""
    _check(table, ids, lo)
    if table.device.type == "cpu":
        return embed_lookup_ref(table, ids, lo)
    if table.device.type != "cuda":
        raise ValueError(f"embed_lookup has no kernel for device {table.device}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("embed_lookup kernel needs contiguous table and ids")
    if isinstance(lo, torch.Tensor):
        if lo.numel() != 1:
            raise ValueError("embed_lookup lo must hold one value")
        lo_t = lo.reshape(1).to(torch.int32).contiguous()
    else:
        lo_t = torch.tensor([int(lo)], dtype=torch.int32, device=table.device)
    n, (v_loc, d) = ids.shape[0], table.shape
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n == 0 or d == 0:
        return out
    lib = _library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.embed_lookup_launch(
            table.data_ptr(), ids.data_ptr(), lo_t.data_ptr(), out.data_ptr(),
            n, v_loc, d * table.element_size(), stream,
        )
    embed_lookup.launches += 1
    if err:
        msg = lib.embed_lookup_error_string(err).decode()
        raise RuntimeError(f"embed_lookup launch failed: {msg} ({err})")
    return out


embed_lookup.launches = 0


@torch.library.custom_op("repro_torch::embed_lookup", mutates_args=())
def embed_lookup_op(
    table: torch.Tensor, ids: torch.Tensor, lo: torch.Tensor
) -> torch.Tensor:
    return embed_lookup(table, ids.contiguous(), lo)


@embed_lookup_op.register_fake
def _embed_lookup_fake(table, ids, lo):
    return table.new_empty((ids.shape[0], table.shape[1]))


def _embed_lookup_vmap(info, in_dims, table, ids, lo):
    """One launch for a whole batched dispatch: with the table and ``lo``
    shared across the batch (the Gatherer's case), the ``(B, K)`` ids
    flatten into one ``(B*K,)`` lookup."""
    t_dim, i_dim, l_dim = in_dims
    if t_dim is not None or l_dim is not None:
        raise NotImplementedError("embed_lookup batches over ids only")
    ids = ids.movedim(i_dim, 0)
    out = embed_lookup_op(table, ids.reshape(-1), lo)
    return out.reshape(*ids.shape, table.shape[-1]), 0


torch.library.register_vmap("repro_torch::embed_lookup", _embed_lookup_vmap)
