"""The partial row lookup on the card, and its custom op.

Replaces the Pallas TPU kernel ``src/repro/kernels/embed_lookup/kernel.py``
(``_embed_kernel`` / ``embed_lookup``, the ``pallas_call`` at line 65): a
blocked one-hot MXU matmul, written that way because the TPU has no fast
gather.  On Hopper the kernel (``csrc/embed_lookup.cu``) gathers the rows
directly, on one of two routes (:func:`embed_route`; the source's note has
their designs):

- ``"warp"``: any row (the first port's kernel): one warp per id, the lanes
  copying the row in 16-, 8-, 4- or 2-byte words.  The Gather service's
  512-byte rows.
- ``"bulk"``: rows of ``BULK_MIN_ROW_BYTES`` or more whose size and base
  are multiples of 16 bytes (the LMs' remote-embedding rows): one warp a
  block of up to 32 rows; each in-shard row comes into shared memory by a
  Hopper bulk copy, and the block's rows leave in one bulk store.

Bound: the launch floor and two dependent loads (the id, then its row).
The bytes (4 per id, one row read per in-shard id and one written per id)
take under a microsecond at the path's shapes (8 to 1,024 ids, 512 B to
16 KB rows).  Times are in ``PERF.md``.

:func:`embed_lookup` is the wrapper: a tensor on the CPU takes the plain
version (:mod:`.ref`); a CUDA tensor launches one route (counted in
``embed_lookup.launches``, by route in ``embed_lookup.route_launches``, and
its ids in ``embed_lookup.items``) or raises.  ``repro_torch::embed_lookup``
is the same function as a ``torch.library`` custom op, so a traced ifunc
slice can carry it by name: a fake impl lets the host trace the
``cuda-sm90`` slice without a card, and the vmap rule turns a batched
dispatch of B payloads into ONE launch over the flattened ``(B*K,)`` ids.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import launch_on, load
from .ref import embed_lookup_ref

# f32 and bf16 rows, or f32 rows as their i32 bit patterns (the Gatherer
# resolves bits so its RETURN rows travel bit-cast): the kernel copies bytes
_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
ROUTES = ("bulk", "warp")
_ROUTE_CODE = {"warp": 0, "bulk": 1}
#: the bulk route's rows a block (one a lane) and its shared tile, at most:
#: the 48 KB of dynamic shared memory a launch takes by default, less room
#: for the static mbarrier (the C entry leaves a larger tile to fail at launch)
BULK_ROWS, BULK_TILE_BYTES = 32, 46 * 1024
#: rows from this size take the bulk route: on the card it beats the warp
#: route at 8 KB and 16 KB rows and loses at 6,400 B and 512 B (PERF.md)
BULK_MIN_ROW_BYTES = 8 * 1024
#: the warp route's block: 8 warps, one id each
WARP_THREADS = 256

_launch = None  # the bound C entry, once the library is loaded
_error_string = None


def bulk_takes(row_bytes: int, aligned: bool) -> bool:
    """Whether the bulk route takes rows of ``row_bytes`` bytes from a table
    that starts on a 16-byte boundary (``aligned``)."""
    return aligned and row_bytes % 16 == 0 and 0 < row_bytes <= BULK_TILE_BYTES


def embed_route(n: int, row_bytes: int, aligned: bool) -> str:
    """The route a CUDA call of ``n`` ids of ``row_bytes``-byte rows takes;
    ``aligned``: the table starts on a 16-byte boundary.  Wide rows go by
    bulk copies, the rest one warp an id, whatever ``n``."""
    if row_bytes >= BULK_MIN_ROW_BYTES and bulk_takes(row_bytes, aligned):
        return "bulk"
    return "warp"


def embed_grid(n: int, row_bytes: int, route: str) -> tuple[int, int, int]:
    """``(blocks, threads a block, ids a block)`` of a launch of ``n`` ids
    on ``route``."""
    if route == "bulk":
        rows = min(BULK_ROWS, BULK_TILE_BYTES // row_bytes)
        return -(-n // rows), 32, rows
    per_block = WARP_THREADS // 32
    return min(-(-n // per_block), 1 << 20), WARP_THREADS, per_block


def _bind():
    global _launch, _error_string
    lib = load("embed_lookup")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.embed_lookup_launch.argtypes = [p, p, p, p, ll, ll, ll, i, ll, i, p]
    lib.embed_lookup_launch.restype = ctypes.c_int
    lib.embed_lookup_error_string.argtypes = [ctypes.c_int]
    lib.embed_lookup_error_string.restype = ctypes.c_char_p
    _error_string = lib.embed_lookup_error_string
    _launch = lib.embed_lookup_launch
    return _launch


def _check(table: torch.Tensor, ids: torch.Tensor, lo, dev: torch.device) -> None:
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(
            f"embed_lookup takes a (V_loc, D) table and (N,) ids, got "
            f"{tuple(table.shape)} and {tuple(ids.shape)}"
        )
    if table.dtype not in _DTYPES:
        raise TypeError(f"embed_lookup table must be f32, bf16 or i32, got {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"embed_lookup ids must be int32, got {ids.dtype}")
    if ids.device != dev or (isinstance(lo, torch.Tensor) and lo.device != dev):
        raise ValueError("embed_lookup operands must lie on one device")


def embed_lookup(
    table: torch.Tensor, ids: torch.Tensor, lo: "int | torch.Tensor", *,
    route: str | None = None,
) -> torch.Tensor:
    """Rows ``table[ids[i] - lo]`` for ids in ``[lo, lo + V_loc)``, zero rows
    for every other id (the ``-1`` pad keys included); ``(N, D)`` in the
    table's dtype.  ``lo`` is an int or a one-element int tensor.  On the
    card it takes ``route`` (default :func:`embed_route`)."""
    dev = table.device
    _check(table, ids, lo, dev)
    if route is not None and route not in ROUTES:
        raise ValueError(f"embed_lookup route must be one of {ROUTES}, got {route!r}")
    if dev.type != "cuda":
        if dev.type == "cpu":
            return embed_lookup_ref(table, ids, lo)
        raise ValueError(f"embed_lookup has no kernel for device {dev}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("embed_lookup kernel needs contiguous table and ids")
    if isinstance(lo, torch.Tensor):
        if lo.numel() != 1:
            raise ValueError("embed_lookup lo must hold one value")
        # the path's lo is one int32 already (a one-element tensor is contiguous)
        lo_t = lo if lo.dtype == torch.int32 else lo.reshape(1).to(torch.int32)
    else:
        lo_t = torch.tensor([int(lo)], dtype=torch.int32, device=dev)
    n, (v_loc, d) = ids.shape[0], table.shape
    out = torch.empty((n, d), dtype=table.dtype, device=dev)
    if n == 0 or d == 0:
        return out
    row_bytes = d * table.element_size()
    aligned = table.data_ptr() % 16 == 0
    route = route or embed_route(n, row_bytes, aligned)
    if route == "bulk" and not bulk_takes(row_bytes, aligned):
        raise ValueError(
            f"embed_lookup bulk route needs 16-byte rows and base, at most {BULK_TILE_BYTES} B "
            f"a row, got {row_bytes} B rows{'' if aligned else ' off a 16-byte boundary'}"
        )
    blocks, _, per_block = embed_grid(n, row_bytes, route)
    err = launch_on(
        dev, _launch or _bind(), table.data_ptr(), ids.data_ptr(), lo_t.data_ptr(),
        out.data_ptr(), n, v_loc, row_bytes, _ROUTE_CODE[route], blocks, per_block,
    )
    embed_lookup.launches += 1
    embed_lookup.route_launches[route] += 1
    embed_lookup.items += n
    if err:
        msg = _error_string(err).decode()
        raise RuntimeError(f"embed_lookup {route} launch failed: {msg} ({err})")
    return out


embed_lookup.launches = 0
embed_lookup.route_launches = dict.fromkeys(ROUTES, 0)
embed_lookup.items = 0  # ids looked up on the card, over all launches


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
