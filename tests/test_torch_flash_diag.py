"""The flash attention's ``diag`` argument (a slice of a KV cache cut over
T: keys at absolute positions ``lo`` on, queries at ``offset`` on, ``diag
= offset - lo``) in its plain version, against the JAX model's ``attend``
with the slice's positions and its filled slots (``q_pos``, ``k_pos``,
``k_valid``); rows that see none of the slice's keys; the slices' partial
softmax stats merged into the whole cache's attention; the decode route's
split plan over a slice; and the wrapper's refusals.  The CUDA kernel's
routes are held against this plain version on the card
(``tests/test_torch_cuda.py``, chip_smoke.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attend as jax_attend
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_lse_ref, flash_attention_ref, split_plan,
)
from repro_torch.kernels.flash_attention.kernel import SPLIT_MAX

TOL = 2e-5  # f32, as the plain version's other JAX comparisons

# (name, B, S, T, H, K, d, offset, lo, window, softcap): S queries at
# positions offset.., T keys at lo.., the slots at offset + S on unfilled
CASES = [
    ("before", 2, 4, 8, 4, 2, 32, 20, 0, 0, None),         # every key seen by every row
    ("across", 2, 8, 16, 4, 2, 32, 12, 8, 0, None),        # the slice's tail unfilled
    ("after", 1, 8, 8, 4, 2, 32, 12, 24, 0, None),         # no row sees a key
    ("prompt", 2, 24, 16, 4, 4, 32, 0, 16, 0, 30.0),       # rows 0-15 keyless
    ("window", 2, 8, 16, 6, 2, 64, 20, 16, 6, None),       # the window cuts the slice
    ("window_keyless", 1, 4, 8, 2, 1, 32, 30, 0, 3, None),  # the window leaves the slice
    ("decode", 3, 1, 32, 8, 1, 128, 40, 32, 0, None),      # one query over its own slice
]


def _draw(case, seed=0):
    _, b, s, t, h, kh, d, *_ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d))]


def _positions(case):
    _, b, s, t, *_rest = case
    offset, lo, window = case[7], case[8], case[9]
    q_pos, k_pos = np.arange(s) + offset, np.arange(t) + lo
    sees = ((k_pos[None, :] <= q_pos[:, None])
            & ((q_pos[:, None] - k_pos[None, :] < window) if window else True)).any(1)
    return q_pos, k_pos, sees


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_diag_matches_jax_attend_on_a_slice(case):
    """Rows that see a key of the slice equal ``attend`` with the slice's
    positions and its filled slots; the others give zeros and lse -inf."""
    _, b, s, t, h, kh, d, offset, lo, window, cap = case
    q, k, v = _draw(case)
    q_pos, k_pos, sees = _positions(case)
    k_valid = np.broadcast_to(k_pos < offset + s, (b, t))
    want = np.asarray(jax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
                                 window=window or None, cap=cap,
                                 k_valid=jnp.asarray(k_valid)))
    kw = dict(diag=offset - lo, window=window, softcap=cap)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got, lse = flash_attention(tq, tk, tv, return_lse=True, **kw)
    assert torch.equal(got, flash_attention_ref(tq, tk, tv, **kw))
    assert torch.equal(lse, flash_attention_lse_ref(tq, tk, **kw))
    np.testing.assert_allclose(got.numpy()[:, sees], want[:, sees], atol=TOL, rtol=TOL)
    assert not got[:, ~sees].any()
    assert bool((lse[..., ~sees] == -math.inf).all())
    # the seen rows' lse: attend's masked logits' log-sum-exp
    logits = np.einsum("bshd,bthd->bhst", q, np.repeat(k, h // kh, axis=2)) / math.sqrt(d)
    if cap:
        logits = np.tanh(logits / cap) * cap
    mask = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] < offset + s)
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    ref = np.asarray(jax.nn.logsumexp(jnp.where(mask, logits, -jnp.inf), axis=-1))
    np.testing.assert_allclose(lse.numpy()[..., sees], ref[..., sees], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("offset,s", [(0, 12), (9, 3), (15, 1)])
def test_slices_merge_to_the_whole_cache(offset, s, window):
    """A cache of T = 16 cut into 4 slices of 4: each slice's (out, lse)
    with diag = offset - lo, merged by the log-sum-exp rule (the weights
    exp(lse - max); a keyless slice weighs 0), equals attention over the
    cache's filled prefix."""
    rng = np.random.default_rng(offset + s)
    q = torch.from_numpy(rng.standard_normal((2, s, 4, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, 32)).astype(np.float32))
            for _ in range(2))
    parts = [flash_attention(q, k[:, lo : lo + 4], v[:, lo : lo + 4], diag=offset - lo,
                             window=window, return_lse=True) for lo in range(0, 16, 4)]
    lse = torch.stack([p[1] for p in parts])  # (slices, B, H, S)
    w = torch.exp(lse - lse.amax(0)).permute(0, 1, 3, 2)[..., None]
    merged = sum(p[0] * wi for p, wi in zip(parts, w)) / w.sum(0)
    want = flash_attention_ref(q, k[:, : offset + s], v[:, : offset + s], window=window)
    torch.testing.assert_close(merged, want, atol=TOL, rtol=TOL)


def test_default_diag_is_the_end_aligned_mask():
    q, k, v = (torch.from_numpy(a) for a in _draw(CASES[1]))
    base = flash_attention(q, k, v, window=5)
    assert torch.equal(flash_attention(q, k, v, window=5, diag=k.shape[1] - q.shape[1]), base)
    out, lse = flash_attention(q, k, v, window=5, return_lse=True)
    assert torch.equal(out, base) and bool(torch.isfinite(lse).all())


@pytest.mark.parametrize("diag", [-40, -20, -3, 0, 7, 500, 2000])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("s,t", [(1, 1040), (4, 777), (16, 128)])
def test_split_plan_over_a_slice(diag, window, s, t):
    """The decode route's plan over a slice: its chunks cover each key some
    row sees exactly once, no chunk lacks one, and the only other keys they
    cover lie past the last seen one, in the last chunk (the kernel masks
    them); where no row sees a key, one split of the first 32 keys (whose
    rows write zeros)."""
    key0, chunk, n = split_plan(4, s, t, 8, 1, 128, window, True, 132, diag)
    i, j = np.arange(s)[:, None], np.arange(t)[None, :]
    seen = ((j <= i + diag) & ((i + diag - j < window) if window else True)).any(0)
    if not seen.any():
        assert (key0, chunk, n) == (0, 32, 1)
        return
    count = np.zeros(t, np.int64)
    for part in range(n):
        lo, hi = key0 + part * chunk, min(key0 + (part + 1) * chunk, t)
        assert lo < hi and seen[lo:hi].any(), (part, lo, hi)
        count[lo:hi] += 1
    last = np.nonzero(seen)[0][-1]
    assert count.max() == 1 and (count[seen] == 1).all() and 1 <= n <= SPLIT_MAX
    assert not count[: last + 1][~seen[: last + 1]].any()
    assert not count[last + 1 :].any() or key0 + (n - 1) * chunk <= last


def test_diag_refusals():
    q, k, v = (torch.from_numpy(a) for a in _draw(CASES[1]))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, causal=False, diag=0)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, diag=True)
    with pytest.raises(ValueError):  # causal S > T needs a diag
        flash_attention(q, k[:, :4], v[:, :4])
    qg = q.clone().requires_grad_(True)
    with pytest.raises(ValueError):  # the backward has only the default diagonal
        flash_attention(qg, k, v, diag=0)
    with pytest.raises(ValueError):
        flash_attention(qg, k, v, return_lse=True)
    out = flash_attention(qg, k, v, diag=k.shape[1] - q.shape[1])
    assert out.requires_grad
