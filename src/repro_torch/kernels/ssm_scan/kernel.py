"""The selective scan on the card: the wrapper of ``csrc/ssm_scan.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssm_scan/kernel.py``
(``_ssm_kernel`` / ``ssm_scan_chunked``, the ``pallas_call`` at line 95):
the diagonal selective scan of Mamba, there cut into chunks of 32 steps
with a clamped cumulative log-decay, from a zero state, for T and D that
its chunk and channel tiles divide.  The CUDA kernel runs the recurrence
step by step from a given (or zero) state, for any T >= 1 and any D, so it
is exact at every decay and is also the decode step (T = 1 from the
cache's state).

Bound: at prefill the bytes of x, dt and y and the f32 operations (the
per-step exponentials above all) are close; at decode the state's bytes.
The first version walks the steps on the f32 CUDA cores (see the source's
note); its times are in ``PERF.md``.

:func:`ssm_scan` is the wrapper: a tensor on the CPU takes the plain
version (:mod:`.ref`); a CUDA tensor launches the kernel (and counts the
launch in ``ssm_scan.launches``) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import load
from .ref import ssm_scan_ref

#: state sizes the kernel is instantiated for (hymba's 16, the smoke
#: config's and the JAX sweep's 8)
STATE_DIMS = (8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = load("ssm_scan")
    fn = lib.ssm_scan_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 5 + [p]
        fn.restype = ctypes.c_int
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan from ``h0``: ``(y (B, T, D) in x's dtype, final
    state (B, D, N) f32)``, both new tensors."""
    _check(x, dt, a, b, c, h0)
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
    y = torch.empty_like(x)
    h_out = torch.empty((bsz, d, n), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssm_scan_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
            _DTYPES[x.dtype], bsz, t, d, n, stream,
        )
    ssm_scan.launches += 1
    if err:
        msg = lib.ssm_scan_error_string(err).decode()
        raise RuntimeError(f"ssm_scan launch failed: {msg} ({err})")
    return y, h_out


ssm_scan.launches = 0
