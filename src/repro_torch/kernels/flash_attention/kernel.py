"""Flash attention on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention/
kernel.py`` (``_flash_kernel`` / ``flash_attention``, the ``pallas_call``
at line 116): blockwise online-softmax GQA attention with end-aligned
causal masking and an optional tanh softcap.  It adds a per-call sliding
window (the JAX model computes the window in its jnp ``attend``; the
Pallas kernel has none), so hymba's local layers run it too.  The CUDA
kernel computes the same function for any S and T, in the model's
``(B, S, H, d)`` / ``(B, T, K, d)`` layout read through strides, so the
decode path hands it a view of the KV cache's valid prefix without a copy.

Bound: operations at prefill (4 B H d S T / 2 under the causal mask), the
bytes of the K/V prefix at decode.  The first version runs on the f32 CUDA
cores (see the source's note); its times are in ``PERF.md``.

:func:`flash_attention` is the wrapper: a tensor on the CPU takes the plain
version (:mod:`.ref`); a CUDA tensor launches the kernel (and counts the
launch in ``flash_attention.launches``) or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..build import load
from .ref import flash_attention_ref

#: head dims the kernel is instantiated for (yi's 128, the sweep's 64, the
#: smoke config's 32)
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, *[ll] * 9, f, f, i, i, p]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention takes q (B, S, H, d) and k, v (B, T, K, d), got "
            f"{tuple(q.shape)}, {tuple(k.shape)} and {tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} does not fit q {tuple(q.shape)} "
            "(same B and d, H a multiple of K)"
        )
    if s == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one query and one key")
    if causal and k.shape[1] < s:
        raise ValueError(
            f"causal flash_attention needs T >= S (got S={s}, T={k.shape[1]}): "
            "the first S - T queries would see no key"
        )
    if isinstance(window, bool) or not isinstance(window, int) or window < 0:
        raise ValueError(f"flash_attention window must be an int >= 0 (0: global), got {window!r}")
    if window and not causal:
        raise ValueError("flash_attention takes a window with causal masking only")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes f32 or bf16 of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention operands must lie on one device")


def flash_attention(
    q: torch.Tensor,  # (B, S, H, d)
    k: torch.Tensor,  # (B, T, K, d)
    v: torch.Tensor,  # (B, T, K, d)
    *,
    causal: bool = True,
    softcap: float | None = None,
    scale: float | None = None,
    window: int = 0,
) -> torch.Tensor:
    """Attention of q over k, v; query head h reads KV head ``h // (H/K)``.
    With ``causal``, query i sees key j iff ``j <= i + T - S``; with a
    ``window`` > 0 (causal only) also iff ``i + T - S - j < window``.
    Returns a contiguous ``(B, S, H, d)`` tensor in q's dtype."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, softcap=softcap, scale=scale,
                                   window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention has no kernel for device {q.device}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS}, got {d}")
    for x in (q, k, v):
        vec = 16 // x.element_size()  # the kernel reads rows in 16-byte words
        steps = [st for st, n in zip(x.stride()[:3], x.shape[:3]) if n > 1]
        if x.stride(3) != 1 or x.data_ptr() % 16 or any(st % vec for st in steps):
            raise ValueError(
                "flash_attention kernel needs the head dim contiguous and every row "
                "starting on a 16-byte boundary"
            )
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention softcap must be positive, got {softcap}")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            b, s, t, h, kh, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            scale, float(softcap or 0.0), int(causal), window, stream,
        )
    flash_attention.launches += 1
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    return out


flash_attention.launches = 0
