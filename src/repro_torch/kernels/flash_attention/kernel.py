"""Flash attention on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention/
kernel.py`` (``_flash_kernel`` / ``flash_attention``, the ``pallas_call``
at line 116): blockwise online-softmax GQA attention with end-aligned
causal masking and an optional tanh softcap.  It adds a per-call sliding
window (the JAX model computes the window in its jnp ``attend``; the
Pallas kernel has none), so hymba's local layers run it too.  The CUDA
kernels compute the same function for any S and T, in the model's
``(B, S, H, d)`` / ``(B, T, K, d)`` layout read through strides, so the
decode path hands them a view of the KV cache's valid prefix without a
copy.

Three routes (:func:`flash_route`; the source's note has their designs):

- ``"wgmma"``: bf16 with more than :data:`SPLIT_ROWS` rows (query, head of
  the group) per (batch, KV head), i.e. prefill: both products on the
  tensor cores, K/V by TMA.  Bound by operations.
- ``"split"``: bf16 with at most :data:`SPLIT_ROWS` rows, i.e. decode: the
  visible keys of each (batch, KV head) cut into chunks
  (:func:`split_plan`), one block per chunk, partials merged in the same
  launch.  Bound by the bytes of the visible K/V.
- ``"simt"``: f32, on the f32 CUDA cores, so f32 agrees with the plain
  version to rounding.

:func:`flash_attention` is the wrapper: a tensor on the CPU takes the plain
version (:mod:`.ref`); a CUDA tensor launches one route's kernel (counted
in ``flash_attention.launches`` and, by route, in
``flash_attention.route_launches``) or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..build import load
from .ref import flash_attention_ref

#: head dims the kernels are instantiated for (yi's 128, the sweep's 64,
#: the smoke config's 32)
HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("wgmma", "split", "simt")
#: a bf16 call with at most this many rows per (batch, KV head) is split
#: over keys (the split kernel's row limit)
SPLIT_ROWS = 16
#: the split plan: chunks of at least this many keys, at most this many
#: chunks, and about this many blocks per SM in flight at head dim 64
#: (half as many at 128: a block's bytes and its share of the merge grow
#: with d; on the card, 2 and 4 blocks beat 4 and 8 at d = 128, 4 beat 2
#: and 8 at d = 64, PERF.md)
SPLIT_MIN_KEYS, SPLIT_MAX, SPLIT_BLOCKS_PER_SM = 128, 64, 4
H100_SMS = 132


def flash_route(dtype: torch.dtype, s: int, h: int, kh: int) -> str:
    """The route a CUDA call of this dtype and shape takes."""
    if dtype != torch.bfloat16:
        return "simt"
    return "split" if s * (h // kh) <= SPLIT_ROWS else "wgmma"


@functools.lru_cache(maxsize=1024)
def split_plan(b: int, s: int, t: int, h: int, kh: int, d: int, window: int = 0,
               causal: bool = True, sms: int = H100_SMS) -> tuple[int, int, int]:
    """``(key0, chunk, n)``: split ``j`` of ``n`` covers keys ``[key0 + j
    chunk, min(key0 + (j + 1) chunk, t))``, the same for every (batch, KV
    head).  Together the splits cover exactly the keys some query sees
    (``[t - s - window + 1, t)`` under a window, else ``[0, t)``), each
    split holds at least one of them, and each chunk at least
    :data:`SPLIT_MIN_KEYS` keys where there are that many; there are enough
    for about :data:`SPLIT_BLOCKS_PER_SM` x 64 / ``d`` blocks per SM, at
    most :data:`SPLIT_MAX`.  ``h`` does not move the plan: the G rows of a
    KV head share a block."""
    key0 = max(0, t - s - window + 1) if causal and window > 0 else 0
    keys = t - key0
    want = -(-SPLIT_BLOCKS_PER_SM * 64 * sms // (d * b * kh))
    n = max(1, min(want, SPLIT_MAX, keys // SPLIT_MIN_KEYS))
    chunk = -(-keys // n)
    chunk = -(-chunk // 32) * 32  # whole 32-key tiles
    return key0, chunk, -(-keys // chunk)


_tickets: dict[tuple[torch.device, int], torch.Tensor] = {}


def _ticket_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The split route's per-(batch, KV head) tickets for calls on
    ``stream`` (its CUDA handle): zeroed once here and left zero by every
    launch (the merging block resets its ticket), so calls queued on one
    stream share a buffer, and calls on two streams, which may run at once,
    never do."""
    key = (device, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = _tickets[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library() -> ctypes.CDLL:
    lib = load("flash_attention")
    if not lib.flash_attention_launch.argtypes:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        for fn in (lib.flash_attention_launch, lib.flash_attention_wgmma_launch):
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, *[ll] * 9, f, f, i, i, p]
        lib.flash_attention_split_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, *[ll] * 9,
                                                     f, f, i, i, i, i, i, p, p, p, p]
        for fn in (lib.flash_attention_launch, lib.flash_attention_wgmma_launch,
                   lib.flash_attention_split_launch):
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


def _strides(x: torch.Tensor) -> list[int]:
    """The (batch, row, head) strides in elements; a dim of size 1 gets its
    contiguous stride (any stride of it is never stepped, but the TMA
    descriptors want 16-byte multiples)."""
    _, n, heads, d = x.shape
    packed = (n * heads * d, heads * d, d)
    return [st if size > 1 else pk for st, size, pk in zip(x.stride()[:3], x.shape[:3], packed)]


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
        vec = 16 // x.element_size()  # the kernels read rows in 16-byte words
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
    route = flash_route(q.dtype, s, h, kh)
    lib = _library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    shape = (b, s, t, h, kh, d, *_strides(q), *_strides(k), *_strides(v),
             scale, float(softcap or 0.0), int(causal), window)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "simt":
            err = lib.flash_attention_launch(*args, *shape, stream)
        elif route == "wgmma":
            err = lib.flash_attention_wgmma_launch(*args, *shape, stream)
        else:
            key0, chunk, n = split_plan(b, s, t, h, kh, d, window, causal,
                                        _sm_count(q.device.index))
            part = ml = tickets = None
            if n > 1:  # scratch: each chunk's (acc, then m and l) per row, f32
                acc = b * kh * n * SPLIT_ROWS * d
                scratch = torch.empty(acc + b * kh * n * SPLIT_ROWS * 2, dtype=torch.float32,
                                      device=q.device)
                part, ml = scratch.data_ptr(), scratch[acc:].data_ptr()
                tickets = _ticket_buffer(q.device, stream, b * kh).data_ptr()
            err = lib.flash_attention_split_launch(*args, *shape, key0, chunk, n, part, ml,
                                                   tickets, stream)
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention {route} launch failed: {msg} ({err})")
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
