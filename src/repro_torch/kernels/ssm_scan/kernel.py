"""The selective scan on the card: the wrapper of ``csrc/ssm_scan.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssm_scan/kernel.py``
(``_ssm_kernel`` / ``ssm_scan_chunked``, the ``pallas_call`` at line 95):
the diagonal selective scan of Mamba, there cut into chunks of 32 steps
with a clamped cumulative log-decay, from a zero state, for T and D that
its chunk and channel tiles divide.  The CUDA kernels run the recurrence
from a given (or zero) state, for any T >= 1 and any D, exact at every
decay; decode (T = 1 from the cache's state) is the same function.

Two routes (:func:`ssm_scan_route`; the source's note has their designs):

- ``"step"``: one kernel walks all T steps.  Decode and short T.
- ``"split"``: T cut into chunks of :func:`split_chunk` steps that run in
  parallel: each chunk's state from zero and its decay product, a carry
  of the states over the chunks, then each chunk's y from its carried
  state; a thread holds a channel's N states, so y needs no shuffle.
  Three device kernels (``ssm_scan_fwd_chunk`` twice,
  ``ssm_scan_fwd_carry``) and ``2 B NC D N`` f32 of scratch a call.

Bound: at prefill the bytes of x, dt and y and the f32 operations (the
per-step exponentials above all) are close; at decode the state's bytes.
A step's latency times T is what limits the step route.  Times are in
``PERF.md``.

:func:`ssm_scan` is the wrapper: a tensor on the CPU takes the plain
version (:mod:`.ref`); a CUDA tensor launches one route (counted once in
``ssm_scan.launches`` and, by route, in ``ssm_scan.route_launches``) or
raises.  With grad on and an operand that requires it, the call goes
through an autograd ``Function`` whose forward is that same call and whose
backward is :func:`ssm_scan_bwd`, the wrapper of ``csrc/ssm_scan_bwd.cu``
(no Pallas counterpart: the JAX package differentiates its jnp scan with
XLA): every input's gradient from T cut into chunks of :data:`BWD_CHUNK`
steps, each chunk's states formed again from a carried state and walked
back from a carried adjoint (five device kernels, no atomics; counted in
``ssm_scan_bwd.launches`` and under its one route ``"split"``).  On the
CPU the same ``Function`` takes the plain backward (``ssm_scan_bwd_ref``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..build import load
from .ref import ssm_scan_bwd_ref, ssm_scan_ref

#: state sizes the kernel is instantiated for (hymba's 16, the smoke
#: config's and the JAX sweep's 8)
STATE_DIMS = (8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("step", "split")
#: a call of at least this many steps is split over time: on the card the
#: split route is faster from here at B = 1 and B = 4 (PERF.md)
SPLIT_MIN_T = 256
#: the split route's chunk length: about SPLIT_CHUNKS chunks over the whole
#: batch (B T / L), rounded to a power of two in [SPLIT_CHUNK_MIN,
#: SPLIT_CHUNK_MAX] steps (within 7% of the fastest chunk of a B x T grid
#: on the card, PERF.md)
SPLIT_CHUNKS, SPLIT_CHUNK_MIN, SPLIT_CHUNK_MAX = 32, 32, 128


def ssm_scan_route(t: int) -> str:
    """The route a CUDA call of ``t`` steps takes."""
    return "split" if t >= SPLIT_MIN_T else "step"


def split_chunk(b: int, t: int) -> int:
    """The split route's steps per chunk for a call of ``b`` rows of ``t``
    steps."""
    want = 1 << round(math.log2(max(b * t / SPLIT_CHUNKS, 1.0)))
    return min(max(want, SPLIT_CHUNK_MIN), SPLIT_CHUNK_MAX)


def _library() -> ctypes.CDLL:
    lib = load("ssm_scan")
    fn = lib.ssm_scan_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 5 + [p]
        fn.restype = ctypes.c_int
        lib.ssm_scan_split_launch.argtypes = [p] * 9 + [i] * 6 + [p]
        lib.ssm_scan_split_launch.restype = ctypes.c_int
        lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dt, a, b, c, h0) -> None:
    if x.dim() != 3 or dt.shape != x.shape or a.dim() != 2 or b.dim() != 3 or c.shape != b.shape:
        raise ValueError(
            "ssm_scan takes x, dt (B, T, D), a (D, N) and b, c (B, T, N), got "
            f"{[tuple(v.shape) for v in (x, dt, a, b, c)]}"
        )
    bsz, t, d = x.shape
    n = a.shape[1]
    if bsz == 0 or t == 0 or d == 0 or n == 0:
        raise ValueError(f"ssm_scan needs at least one step of one channel, got {tuple(x.shape)}")
    if a.shape[0] != d or tuple(b.shape) != (bsz, t, n):
        raise ValueError(
            f"ssm_scan: a {tuple(a.shape)} and b {tuple(b.shape)} do not fit x {tuple(x.shape)}"
        )
    if h0 is not None and (tuple(h0.shape) != (bsz, d, n) or h0.dtype != torch.float32):
        raise ValueError(
            f"ssm_scan: h0 is {tuple(h0.shape)} {h0.dtype}, want {(bsz, d, n)} float32"
        )
    if x.dtype not in _DTYPES or any(v.dtype != x.dtype for v in (dt, b, c)):
        raise TypeError(
            "ssm_scan takes x, dt, b, c in f32 or bf16 of one dtype, got "
            f"{[v.dtype for v in (x, dt, b, c)]}"
        )
    if a.dtype != torch.float32:
        raise TypeError(f"ssm_scan takes a in float32, got {a.dtype}")
    devices = {v.device for v in (x, dt, a, b, c)} | ({h0.device} if h0 is not None else set())
    if len(devices) != 1:
        raise ValueError("ssm_scan operands must lie on one device")


def ssm_scan(
    x: torch.Tensor,  # (B, T, D)
    dt: torch.Tensor,  # (B, T, D), positive step sizes
    a: torch.Tensor,  # (D, N) f32, negative
    b: torch.Tensor,  # (B, T, N)
    c: torch.Tensor,  # (B, T, N)
    h0: torch.Tensor | None = None,  # (B, D, N) f32; zeros when None
    *,
    route: str | None = None,
    chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan from ``h0``: ``(y (B, T, D) in x's dtype, final
    state (B, D, N) f32)``, both new tensors.  On the card it takes
    ``route`` (default :func:`ssm_scan_route`), the split route in chunks of
    ``chunk`` steps (default :func:`split_chunk`).  With grad on and an
    operand that requires it, the call goes through :class:`_SSMScan`,
    whose backward is :func:`ssm_scan_bwd`."""
    _check(x, dt, a, b, c, h0)
    if route is not None and route not in ROUTES:
        raise ValueError(f"ssm_scan route must be one of {ROUTES}, got {route!r}")
    if chunk is not None and (isinstance(chunk, bool) or not isinstance(chunk, int) or chunk < 1):
        raise ValueError(f"ssm_scan chunk must be an int >= 1, got {chunk!r}")
    if torch.is_grad_enabled() and any(
            v is not None and v.requires_grad for v in (x, dt, a, b, c, h0)):
        return _SSMScan.apply(x, dt, a, b, c, h0, route, chunk)
    return _forward(x, dt, a, b, c, h0, route, chunk)


def _forward(x, dt, a, b, c, h0, route, chunk) -> tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return ssm_scan_ref(x, dt, a, b, c, h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan has no kernel for device {x.device}")
    bsz, t, d = x.shape
    n = a.shape[1]
    if n not in STATE_DIMS:
        raise ValueError(f"ssm_scan kernel takes state sizes {STATE_DIMS}, got {n}")
    operands = (x, dt, a, b, c) + ((h0,) if h0 is not None else ())
    if any(not v.is_contiguous() for v in operands):
        raise ValueError("ssm_scan kernel needs contiguous operands")
    route = route or ssm_scan_route(t)
    y = torch.empty_like(x)
    h_out = torch.empty((bsz, d, n), dtype=torch.float32, device=x.device)
    lib = _library()
    args = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), h_out.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "step":
            err = lib.ssm_scan_launch(*args, _DTYPES[x.dtype], bsz, t, d, n, stream)
        else:  # the chunks' states, then their decay products
            chunk = chunk or split_chunk(bsz, t)
            n_chunks = -(-t // chunk)
            scratch = torch.empty(2 * bsz * n_chunks * d * n, dtype=torch.float32,
                                  device=x.device)
            err = lib.ssm_scan_split_launch(*args, scratch.data_ptr(), _DTYPES[x.dtype], bsz, t,
                                            d, n, chunk, stream)
    ssm_scan.launches += 1
    ssm_scan.route_launches[route] += 1
    if err:
        msg = lib.ssm_scan_error_string(err).decode()
        raise RuntimeError(f"ssm_scan {route} launch failed: {msg} ({err})")
    return y, h_out


ssm_scan.launches = 0
ssm_scan.route_launches = dict.fromkeys(ROUTES, 0)


class _SSMScan(torch.autograd.Function):
    """The forward's route, and :func:`ssm_scan_bwd` for the gradient.
    Saves the operands alone, so a checkpointed block that runs the forward
    again saves the same tensors; the backward forms its own chunk states."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, h0, route, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b, c, h0)
        return _forward(x, dt, a, b, c, h0, route, chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, a, b, c, h0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ssm_scan_bwd(x, dt, a, b, c, h0, dy, None if dh is None else dh.contiguous())
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


#: the backward kernel's steps per chunk (a warp keeps a chunk's states of
#: its 32 channels in shared memory) and channels per block of its
#: gradient pass (one warp: db and dc are summed over them by shuffles)
BWD_CHUNK, BWD_CHANNELS = 16, 32


def _bwd_library() -> ctypes.CDLL:
    lib = load("ssm_scan_bwd")
    if not lib.ssm_scan_bwd_launch.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssm_scan_bwd_launch.argtypes = [p] * 15 + [i] * 6 + [p]
        lib.ssm_scan_bwd_launch.restype = ctypes.c_int
        lib.ssm_scan_bwd_error_string.argtypes = [ctypes.c_int]
        lib.ssm_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


def ssm_scan_bwd(
    x: torch.Tensor,  # (B, T, D)
    dt: torch.Tensor,  # (B, T, D)
    a: torch.Tensor,  # (D, N) f32
    b: torch.Tensor,  # (B, T, N)
    c: torch.Tensor,  # (B, T, N)
    h0: torch.Tensor | None,  # (B, D, N) f32; zeros when None
    dy: torch.Tensor,  # (B, T, D) in x's dtype: y's cotangent
    dh: torch.Tensor | None = None,  # (B, D, N) f32: the final state's
) -> tuple[torch.Tensor, ...]:
    """The gradients of :func:`ssm_scan` at ``(dy, dh)``: ``(dx, ddt, da,
    db, dc, dh0)``, each in its operand's dtype (da and dh0 in f32), all new
    tensors: the plain version (``ssm_scan_bwd_ref``) for a CPU tensor, the
    kernel for a CUDA one (counted once in ``ssm_scan_bwd.launches`` and
    under ``"split"`` in ``ssm_scan_bwd.route_launches``) or a raise."""
    _check(x, dt, a, b, c, h0)
    bsz, t, d = x.shape
    n = a.shape[1]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssm_scan_bwd: dy is {dy.dtype} {tuple(dy.shape)} on {dy.device}, "
                         f"want x's {x.dtype} {tuple(x.shape)} on {x.device}")
    if dh is not None and (tuple(dh.shape) != (bsz, d, n) or dh.dtype != torch.float32
                           or dh.device != x.device):
        raise ValueError(f"ssm_scan_bwd: dh is {dh.dtype} {tuple(dh.shape)}, want "
                         f"{(bsz, d, n)} float32 on {x.device}")
    if x.device.type == "cpu":
        return ssm_scan_bwd_ref(x, dt, a, b, c, h0, dy, dh)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan_bwd has no kernel for device {x.device}")
    if n not in STATE_DIMS:
        raise ValueError(f"ssm_scan_bwd kernel takes state sizes {STATE_DIMS}, got {n}")
    operands = [x, dt, a, b, c, dy] + [v for v in (h0, dh) if v is not None]
    if any(not v.is_contiguous() for v in operands):
        raise ValueError("ssm_scan_bwd kernel needs contiguous operands")
    nc = -(-t // BWD_CHUNK)
    if bsz * nc > 65535:
        raise ValueError(f"ssm_scan_bwd kernel takes at most 65,535 chunks of {BWD_CHUNK} "
                         f"steps, got B = {bsz} rows of {t}")
    dx, ddt, da, db, dc = (torch.empty_like(v) for v in (x, dt, a, b, c))
    dh0 = torch.empty((bsz, d, n), dtype=torch.float32, device=x.device)
    # the chunks' states, adjoints and decay products, da's partial sums by
    # chunk, and db's and dc's by warp of channels
    entries = bsz * nc * d * n
    warps = -(-d // BWD_CHANNELS)
    scratch = torch.empty(4 * entries + warps * bsz * t * 2 * n, dtype=torch.float32,
                          device=x.device)
    lib = _bwd_library()
    ptrs = [v.data_ptr() if v is not None else None
            for v in (x, dt, a, b, c, h0, dy, dh, dx, ddt, da, db, dc, dh0, scratch)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssm_scan_bwd_launch(*ptrs, _DTYPES[x.dtype], bsz, t, d, n, BWD_CHUNK, stream)
    ssm_scan_bwd.launches += 1
    ssm_scan_bwd.route_launches["split"] += 1
    if err:
        msg = lib.ssm_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"ssm_scan_bwd launch failed: {msg} ({err})")
    return dx, ddt, da, db, dc, dh0


#: the backward kernel's one route: the forward's split design run back
BWD_ROUTES = ("split",)
ssm_scan_bwd.launches = 0
ssm_scan_bwd.route_launches = dict.fromkeys(BWD_ROUTES, 0)
