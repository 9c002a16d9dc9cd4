"""WKV6 on the card: the wrapper of ``csrc/wkv6.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/wkv6/kernel.py``
(``_wkv6_kernel`` / ``wkv6_chunked``, the ``pallas_call`` at line 110):
the RWKV-6 time-mix recurrence, there cut into chunks of four MXU matmuls
with a clamped cumulative log-decay.  The CUDA kernels run the recurrence
from a given (or zero) state, for any T >= 1, exact at every decay in
(0, 1); decode (T = 1) is the same function.

Two routes (:func:`wkv6_route`; the source's note has their designs):

- ``"step"``: one kernel walks all T steps.  Decode and short T.
- ``"split"``: T cut into chunks of :func:`split_chunk` steps that run in
  parallel: each chunk's state from zero and its decay product, a carry
  of the states over the chunks, then each chunk's outputs from its
  carried state.  Three device kernels (``wkv6_fwd`` twice,
  ``wkv6_fwd_carry``) and ``B H NC M (M + 1)`` f32 of scratch a call.

Bound: the f32 operations (5 B T H M^2) at prefill, the state's bytes at
decode; a step's latency times T is what limits the step route.  Times are
in ``PERF.md``.

:func:`wkv6` is the wrapper: a tensor on the CPU takes the plain version
(:mod:`.ref`); a CUDA tensor launches one route (counted once in
``wkv6.launches`` and, by route, in ``wkv6.route_launches``) or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..build import load
from .ref import wkv6_ref

#: head sizes the kernel is instantiated for (rwkv6's 64, and the JAX
#: sweep's 32 and 128)
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("step", "split")
#: a call of at least this many steps is split over time: on the card the
#: split route is faster from here at B = 1 and B = 4 (PERF.md)
SPLIT_MIN_T = 256
#: the split route's chunk length: about SPLIT_CHUNKS chunks over the whole
#: batch (B T / L), rounded to a power of two in [SPLIT_CHUNK_MIN,
#: SPLIT_CHUNK_MAX] steps (within 7% of the fastest chunk of a B x T grid
#: on the card, PERF.md)
SPLIT_CHUNKS, SPLIT_CHUNK_MIN, SPLIT_CHUNK_MAX = 16, 16, 128


def wkv6_route(t: int) -> str:
    """The route a CUDA call of ``t`` steps takes."""
    return "split" if t >= SPLIT_MIN_T else "step"


def split_chunk(b: int, t: int) -> int:
    """The split route's steps per chunk for a call of ``b`` rows of ``t``
    steps."""
    want = 1 << round(math.log2(max(b * t / SPLIT_CHUNKS, 1.0)))
    return min(max(want, SPLIT_CHUNK_MIN), SPLIT_CHUNK_MAX)


def _library() -> ctypes.CDLL:
    lib = load("wkv6")
    fn = lib.wkv6_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 7 + [p]
        fn.restype = ctypes.c_int
        lib.wkv6_split_launch.argtypes = [p] * 9 + [i] * 8 + [p]
        lib.wkv6_split_launch.restype = ctypes.c_int
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        lib.wkv6_error_string.restype = ctypes.c_char_p
    return lib


def _check(r, k, v, w, u, state) -> None:
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(
            "wkv6 takes r, k, v, w of one shape (B, T, H, M), got "
            f"{[tuple(x.shape) for x in (r, k, v, w)]}"
        )
    b, t, h, m = r.shape
    if b == 0 or t == 0 or h == 0 or m == 0:
        raise ValueError(f"wkv6 needs at least one step of one head, got {tuple(r.shape)}")
    if tuple(u.shape) != (h, m):
        raise ValueError(f"wkv6: u is {tuple(u.shape)}, want {(h, m)}")
    if state is not None and (tuple(state.shape) != (b, h, m, m) or state.dtype != torch.float32):
        raise ValueError(
            f"wkv6: the state is {tuple(state.shape)} {state.dtype}, want {(b, h, m, m)} float32"
        )
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(
            f"wkv6 takes r, k, v in f32 or bf16 of one dtype, got {r.dtype}, {k.dtype}, {v.dtype}"
        )
    if w.dtype not in _DTYPES or u.dtype not in _DTYPES:
        raise TypeError(f"wkv6 takes w and u in f32 or bf16, got {w.dtype} and {u.dtype}")
    devices = {x.device for x in (r, k, v, w, u)} | ({state.device} if state is not None else set())
    if len(devices) != 1:
        raise ValueError("wkv6 operands must lie on one device")


def wkv6(
    r: torch.Tensor,  # (B, T, H, M)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # (B, T, H, M) decay factors in (0, 1)
    u: torch.Tensor,  # (H, M)
    state: torch.Tensor | None = None,  # (B, H, M, M) f32; zeros when None
    *,
    route: str | None = None,
    chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence from ``state``: ``(out (B, T, H, M) in r's dtype,
    final state (B, H, M, M) f32)``, both new tensors.  On the card it takes
    ``route`` (default :func:`wkv6_route`), the split route in chunks of
    ``chunk`` steps (default :func:`split_chunk`)."""
    _check(r, k, v, w, u, state)
    if route is not None and route not in ROUTES:
        raise ValueError(f"wkv6 route must be one of {ROUTES}, got {route!r}")
    if chunk is not None and (isinstance(chunk, bool) or not isinstance(chunk, int) or chunk < 1):
        raise ValueError(f"wkv6 chunk must be an int >= 1, got {chunk!r}")
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 has no kernel for device {r.device}")
    b, t, h, m = r.shape
    if m not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel takes head sizes {HEAD_DIMS}, got {m}")
    operands = (r, k, v, w, u) + ((state,) if state is not None else ())
    if any(not x.is_contiguous() or x.data_ptr() % 16 for x in operands):
        raise ValueError("wkv6 kernel needs contiguous operands starting on 16-byte boundaries")
    route = route or wkv6_route(t)
    out = torch.empty_like(r)
    s_out = torch.empty((b, h, m, m), dtype=torch.float32, device=r.device)
    lib = _library()
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if state is None else state.data_ptr(), out.data_ptr(), s_out.data_ptr())
    types = (_DTYPES[r.dtype], _DTYPES[w.dtype], _DTYPES[u.dtype], b, t, h, m)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        if route == "step":
            err = lib.wkv6_launch(*args, *types, stream)
        else:  # the chunks' states, then their decay products
            chunk = chunk or split_chunk(b, t)
            n_chunks = -(-t // chunk)
            scratch = torch.empty(b * n_chunks * h * m * (m + 1), dtype=torch.float32,
                                  device=r.device)
            err = lib.wkv6_split_launch(*args, scratch.data_ptr(), *types, chunk, stream)
    wkv6.launches += 1
    wkv6.route_launches[route] += 1
    if err:
        msg = lib.wkv6_error_string(err).decode()
        raise RuntimeError(f"wkv6 {route} launch failed: {msg} ({err})")
    return out, s_out


wkv6.launches = 0
wkv6.route_launches = dict.fromkeys(ROUTES, 0)
