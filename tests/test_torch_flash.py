"""The port's flash attention (plain version on the CPU) against the JAX
package: the Pallas kernel in interpret mode, its jnp oracle, and the
model's cache-masked ``attend``.  Inputs come from numpy seeds and go to
both packages as the same numbers (bf16 inputs are the f32 draws rounded
to nearest even by both).  The CUDA kernel itself is held against this
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.models.attention import attend as jax_attend
from repro_torch.kernels import WRAPPERS, build
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS, ROUTES, flash_attention, flash_attention_ref, flash_route, split_plan,
)
from repro_torch.kernels.flash_attention.kernel import SPLIT_MAX, SPLIT_MIN_KEYS, SPLIT_ROWS
from repro_torch.kernels.flash_attention.ref import NEG

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the JAX sweep's tolerances (tests/test_kernels.py): f32 agrees to rounding;
# bf16 rounds the probabilities before the P V product in the oracle
TOL = {"f32": 2e-5, "bf16": 2e-2}


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrs, dtype):
    jdt, tdt = DTYPES[dtype]
    return [jnp.asarray(a, jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype], rtol=TOL[dtype]
    )


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(1, 2)


# the five shapes of the JAX kernel sweep (tests/test_kernels.py)
SWEEP = [
    (2, 4, 2, 256, 256, 64, 128, 128, True, None),
    (1, 8, 8, 128, 128, 128, 128, 64, True, 50.0),
    (2, 4, 1, 256, 512, 32, 64, 256, False, None),
    (1, 2, 2, 512, 512, 64, 256, 128, True, None),
    (1, 6, 2, 128, 256, 64, 128, 128, True, 30.0),
]


@pytest.mark.parametrize("b,h,kh,s,t,d,bq,bk,causal,cap", SWEEP)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_interpret(b, h, kh, s, t, d, bq, bk, causal, cap, dtype):
    arrs = _draw(s * t + h, (b, h, s, d), (b, kh, t, d), (b, kh, t, d))
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    want = jax_flash(jq, jk, jv, causal=causal, softcap=cap, bq=bq, bk=bk, interpret=True)
    got = flash_attention(*map(_heads_first, (tq, tk, tv)), causal=causal, softcap=cap)
    assert got.dtype == tq.dtype and got.shape == (b, s, h, d)
    _close(_heads_first(got), want, dtype)


# shapes no Pallas tile divides: decode (S=1) at ragged cache lengths, and
# a prompt of 37; with GQA, MHA, no mask and a softcap
RAGGED = [
    (2, 4, 2, 1, 1, 32, True, None),
    (2, 4, 2, 1, 7, 32, True, None),
    (2, 8, 2, 1, 33, 64, True, None),
    (1, 32, 4, 1, 130, 128, True, None),
    (2, 4, 2, 37, 37, 32, True, None),
    (1, 4, 4, 37, 37, 64, False, None),
    (1, 6, 2, 5, 130, 32, True, 30.0),
]


@pytest.mark.parametrize("b,h,kh,s,t,d,causal,cap", RAGGED)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_jnp_oracle_at_ragged_shapes(b, h, kh, s, t, d, causal, cap, dtype):
    arrs = _draw(7 * t + s, (b, h, s, d), (b, kh, t, d), (b, kh, t, d))
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    want = jax_flash_ref(jq, jk, jv, causal=causal, softcap=cap)
    got = flash_attention(*map(_heads_first, (tq, tk, tv)), causal=causal, softcap=cap)
    _close(_heads_first(got), want, dtype)


@pytest.mark.parametrize("s,offset", [(37, 0), (1, 0), (1, 20), (1, 63), (5, 40)],
                         ids=["prefill37", "decode@0", "decode@20", "decode@63", "chunk5@40"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cache_view_matches_masked_attend(s, offset, dtype):
    """The serving path's attention: the kernel over the cache's valid
    prefix (a strided view, end-aligned causal) equals the JAX model's
    ``attend`` over the whole cache with ``k_valid = k_pos < offset + S``
    (models/transformer.py's cache branch).  Slots past the prefix hold
    garbage that must not leak in."""
    b, h, kh, d, t_max = 2, 4, 2, 32, 64
    q, kc, vc = _draw(s + offset, (b, s, h, d), (b, t_max, kh, d), (b, t_max, kh, d))
    kc[:, offset + s :] = 1e4
    vc[:, offset + s :] = -1e4
    (jq, jk, jv), (tq, tk, tv) = _both([q, kc, vc], dtype)
    k_pos = jnp.arange(t_max)
    k_valid = jnp.broadcast_to((k_pos < offset + s)[None, :], (b, t_max))
    want = jax_attend(jq, jk, jv, q_pos=offset + jnp.arange(s), k_pos=k_pos, k_valid=k_valid)
    n = offset + s
    got = flash_attention(tq, tk[:, :n], tv[:, :n])
    _close(got, want, dtype)


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _draw(0, (1, 3, 4, 32), (1, 5, 2, 32), (1, 5, 2, 32)))
    before = flash_attention.launches, dict(flash_attention.route_launches)
    got = flash_attention(q, k, v, softcap=20.0, scale=0.3)
    assert (flash_attention.launches, flash_attention.route_launches) == before
    assert torch.equal(got, flash_attention_ref(q, k, v, softcap=20.0, scale=0.3))
    assert WRAPPERS["flash_attention"] is flash_attention
    assert build.SOURCES["flash_attention"] == "flash_attention.cu"
    assert (build.CSRC / "flash_attention.cu").exists() and HEAD_DIMS == (32, 64, 128, 256)


@pytest.mark.parametrize("case", ["rank", "batch", "groups", "empty", "causal_t_lt_s",
                                  "dtype", "int", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    q, k, v = torch.zeros(1, 4, 4, 32), torch.zeros(1, 6, 2, 32), torch.zeros(1, 6, 2, 32)
    args = {
        "rank": (q[0], k, v),
        "batch": (q, torch.zeros(2, 6, 2, 32), torch.zeros(2, 6, 2, 32)),
        "groups": (q, torch.zeros(1, 6, 3, 32), torch.zeros(1, 6, 3, 32)),
        "empty": (q[:, :0], k, v),
        "causal_t_lt_s": (torch.zeros(1, 8, 4, 32), k, v),
        "dtype": (q, k.bfloat16(), v),
        "int": (q.int(), k.int(), v.int()),
        "device": (q.to("meta"), k.to("meta"), v.to("meta")),
    }[case]
    err = TypeError if case in ("dtype", "int") else ValueError
    with pytest.raises(err):
        flash_attention(*args)


def _visible(s, t, window, causal=True):
    """(S, T) bool: query i sees key j (the plain version's mask)."""
    mask = torch.ones(s, t, dtype=torch.bool)
    if causal:
        mask = mask.tril(t - s)
    if window:
        mask = mask.triu(t - s - window + 1)
    return mask


@pytest.mark.parametrize("t", [1, 127, 128, 129, 777, 2048, 4096])
@pytest.mark.parametrize("window", [0, 2048])
@pytest.mark.parametrize("g", [1, 5, 8])
def test_split_plan_covers_each_visible_key_once(t, window, g):
    """The decode route's plan: its chunks cover every key some query sees
    exactly once and no other key, no chunk is empty of visible keys, each
    chunk holds at least SPLIT_MIN_KEYS keys where there are that many, and
    a large B K, or a wide head, needs no more chunks than a small one."""
    for b, kh, d in ((8, 4, 128), (8, 5, 64), (1, 1, 32)):
        for s in sorted({1, min(t, SPLIT_ROWS // g)}):
            key0, chunk, n = split_plan(b, s, t, g * kh, kh, d, window)
            seen = _visible(s, t, window).any(0)
            count = torch.zeros(t, dtype=torch.int64)
            for j in range(n):
                lo, hi = key0 + j * chunk, min(key0 + (j + 1) * chunk, t)
                assert lo < hi and seen[lo:hi].any(), (b, kh, s, j)
                count[lo:hi] += 1
            assert torch.equal(count, seen.long())
            assert 1 <= n <= SPLIT_MAX
            assert chunk >= min(SPLIT_MIN_KEYS, int(seen.sum()))
    n_yi, n_64, n_small = (split_plan(b, 1, t, 8 * kh, kh, d, window)[2]
                           for b, kh, d in ((8, 4, 128), (8, 4, 64), (1, 1, 64)))
    assert n_yi <= n_64 <= n_small


@pytest.mark.parametrize("dtype,s,h,kh,want", [
    (torch.bfloat16, 1, 32, 4, "split"),     # yi decode: 8 rows
    (torch.bfloat16, 1, 25, 5, "split"),     # hymba decode: 5 rows
    (torch.bfloat16, 2, 32, 4, "split"),     # 16 rows, the limit
    (torch.bfloat16, 3, 32, 4, "wgmma"),     # 24 rows
    (torch.bfloat16, 16, 4, 4, "split"),     # MHA, 16 queries
    (torch.bfloat16, 17, 4, 4, "wgmma"),
    (torch.bfloat16, 2048, 32, 4, "wgmma"),  # yi prefill
    (torch.float32, 1, 32, 4, "simt"),       # f32 keeps the CUDA-core kernel
    (torch.float32, 2048, 32, 4, "simt"),
])
def test_route_choice(dtype, s, h, kh, want):
    assert flash_route(dtype, s, h, kh) == want
    assert want in ROUTES


def _split_and_merge(q, k, v, chunks, causal=True, window=0):
    """The split route's algorithm in torch ops, f32: per chunk of keys the
    partial (m, l, acc) with masked logits -2**30 (a row with no visible key
    in the chunk gets m = -2**30 and probabilities 1), merged by the
    log-sum-exp rule with weights exp(m_i - max m)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    logits = torch.einsum("bskgd,btkd->bkgst", q.reshape(b, s, kh, g, d), k) / math.sqrt(d)
    logits = logits.masked_fill(~_visible(s, t, window, causal), NEG)
    parts = []
    for lo, hi in chunks:
        x = logits[..., lo:hi]
        m = x.amax(-1, keepdim=True)
        p = torch.exp(x - m)
        acc = torch.einsum("bkgst,btkd->bkgsd", p, v[:, lo:hi])
        parts.append((m, p.sum(-1, keepdim=True), acc))
    mg = torch.stack([m for m, _, _ in parts]).amax(0)
    total = sum(torch.exp(m - mg) * li for m, li, _ in parts)
    acc = sum(torch.exp(m - mg) * a for m, _, a in parts)
    out = acc / total.clamp_min(1e-20)  # (b, kh, g, s, d)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


@pytest.mark.parametrize("b,s,t,h,kh,d,window", [
    (8, 1, 2049, 25, 5, 64, 2048),   # hymba decode, one key past the window
    (8, 1, 4096, 25, 5, 64, 2048),   # hymba decode, far past it
    (8, 1, 2048, 32, 4, 32, 0),      # yi's decode layout at d 32
    (2, 2, 777, 16, 2, 32, 300),     # two queries, ragged T, a narrow window
    (1, 1, 129, 8, 1, 32, 0),        # one chunk
])
def test_split_and_merge_equals_plain(b, s, t, h, kh, d, window):
    """Partials over the plan's chunks merge to the plain version within
    1e-6 in f32, also with an extra chunk wholly outside the window (its
    rows see no key: weight exp(-2**30 - m) = 0)."""
    q, k, v = (torch.from_numpy(a) for a in _draw(t + s, (b, s, h, d), (b, t, kh, d),
                                                    (b, t, kh, d)))
    key0, chunk, n = split_plan(b, s, t, h, kh, d, window)
    chunks = [(key0 + j * chunk, min(key0 + (j + 1) * chunk, t)) for j in range(n)]
    want = flash_attention_ref(q, k, v, window=window)
    torch.testing.assert_close(_split_and_merge(q, k, v, chunks, window=window), want,
                               atol=1e-6, rtol=0)
    if key0 > 0:
        got = _split_and_merge(q, k, v, [(0, key0)] + chunks, window=window)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
