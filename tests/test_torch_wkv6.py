"""The port's WKV6 (plain version on the CPU) against the JAX package: the
kernel oracle ``wkv6_ref``, the Pallas kernel in interpret mode, and the
model's ``wkv6_scan`` with a state carried in.  Inputs come from numpy
seeds and go to both packages as the same numbers (bf16 inputs are the f32
draws rounded to nearest even by both).  The CUDA kernel itself is held
against this plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: against the sequential oracles, f32 agrees to 1e-5 (the same
f32 recurrence, products summed in another order); bf16 outputs may round
to the other bf16 neighbour (rtol 2**-7).  Against the Pallas chunked form,
the JAX sweep's own 5e-3 (f32) and 5e-2 (bf16).  The split route's
arithmetic in plain ops (``wkv6_split_ref``) is held to the same 1e-5 / rtol
2**-7 against the sequential oracles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.kernel import wkv6_chunked as pallas_wkv6
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models.rwkv import wkv6_chunked as jnp_wkv6_chunked
from repro.models.rwkv import wkv6_scan
from repro_torch.kernels import WRAPPERS, build
from repro_torch.kernels.wkv6 import (
    HEAD_DIMS, ROUTES, SPLIT_MIN_T, split_chunk, wkv6, wkv6_ref, wkv6_route, wkv6_split_ref,
)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
EXACT = {"f32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=1e-5, rtol=2.0**-7)}
SWEEP_TOL = {"f32": 5e-3, "bf16": 5e-2}  # tests/test_kernels.py's

# the JAX kernel sweep (tests/test_kernels.py): b, t, h, m, chunk
SWEEP = [(2, 128, 2, 64, 16), (1, 256, 4, 64, 32), (2, 64, 1, 128, 16)]


def _draw(seed, b, t, h, m, lam=None, state=False):
    """r, k, v ~ N(0, 0.25); decays from the sweep's domain (log w = -exp(x),
    x ~ N(-1, 1) clipped to [-6, 1]) or a constant log-decay ``lam`` per
    step; u ~ N(0, 0.09); an N(0, 0.25) state when ``state``."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, m)).astype(np.float32) * 0.5 for _ in range(3))
    if lam is None:
        x = np.clip(rng.standard_normal((b, t, h, m)) - 1.0, -6.0, 1.0)
        w = np.exp(-np.exp(x)).astype(np.float32)
    else:
        w = np.full((b, t, h, m), np.exp(lam), np.float32)
    u = (rng.standard_normal((h, m)) * 0.3).astype(np.float32)
    s = (rng.standard_normal((b, h, m, m)) * 0.5).astype(np.float32) if state else None
    return r, k, v, w, u, s


def _both(arrs, dtype):
    jdt, tdt = DTYPES[dtype]
    return [jnp.asarray(a, jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("b,t,h,m,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_jax_oracle(b, t, h, m, chunk, dtype):
    r, k, v, w, u, _ = _draw(t * m, b, t, h, m)
    (jr, jk, jv), (tr, tk, tv) = _both([r, k, v], dtype)
    want, s_want = jax_wkv6_ref(jr, jk, jv, jnp.asarray(w), jnp.asarray(u))
    got, s_got = wkv6(tr, tk, tv, torch.from_numpy(w), torch.from_numpy(u))
    assert got.dtype == tr.dtype and got.shape == (b, t, h, m)
    assert s_got.dtype == torch.float32 and s_got.shape == (b, h, m, m)
    _close(got, want, EXACT[dtype])
    _close(s_got, s_want, EXACT["f32"])


@pytest.mark.parametrize("b,t,h,m,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_interpret(b, t, h, m, chunk, dtype):
    """The sweep as tests/test_kernels.py runs it: w in the inputs' dtype."""
    r, k, v, w, u, _ = _draw(t * m + 1, b, t, h, m)
    (jr, jk, jv, jw), (tr, tk, tv, tw) = _both([r, k, v, w], dtype)
    want, s_want = pallas_wkv6(jr, jk, jv, jw, jnp.asarray(u), chunk=chunk, interpret=True)
    got, s_got = wkv6(tr, tk, tv, tw, torch.from_numpy(u))
    tol = SWEEP_TOL[dtype]
    _close(got, want, dict(atol=tol, rtol=tol))
    _close(s_got, s_want, dict(atol=tol, rtol=tol))


@pytest.mark.parametrize("t", [1, 7, 37, 100])
def test_plain_matches_model_scan_from_a_state(t):
    """Decode (T = 1) and ragged prompts, from a nonzero state."""
    b, h, m = 2, 2, 32
    r, k, v, w, u, s = _draw(t, b, t, h, m, state=True)
    want, s_want = wkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u, s)))
    got, s_got = wkv6(*(torch.from_numpy(a) for a in (r, k, v, w, u, s)))
    _close(got, want, EXACT["f32"])
    _close(s_got, s_want, EXACT["f32"])


@pytest.mark.parametrize("lam", [-1.0, -1.5])
def test_plain_is_exact_at_strong_decay(lam):
    """The exactness the kernel is held to: at log w = -1 and -1.5 per step
    over 128 steps the plain version equals the sequential scan, while the
    reference's chunk-64 form (its cumulative log-decay clamped at -60) is
    off by whole units."""
    b, t, h, m = 1, 128, 2, 64
    r, k, v, w, u, _ = _draw(int(-10 * lam), b, t, h, m, lam=lam)
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u)]
    want, s_want = wkv6_scan(*jargs)
    got, s_got = wkv6(*(torch.from_numpy(a) for a in (r, k, v, w, u)))
    _close(got, want, EXACT["f32"])
    _close(s_got, s_want, EXACT["f32"])
    clamped, _ = jnp_wkv6_chunked(*jargs, chunk=64)
    assert np.abs(np.asarray(clamped) - np.asarray(want)).max() > 1.0


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    arrs = _draw(0, 1, 5, 2, 32, state=True)
    args = [torch.from_numpy(a) for a in arrs]
    before = wkv6.launches
    got, s_got = wkv6(*args)
    assert wkv6.launches == before
    want, s_want = wkv6_ref(*args)
    assert torch.equal(got, want) and torch.equal(s_got, s_want)
    assert not torch.equal(s_got, args[5])  # a new state; the one given is not written
    zero, _ = wkv6(*args[:5])
    assert torch.equal(zero, wkv6_ref(*args[:5], torch.zeros(1, 2, 32, 32))[0])
    assert WRAPPERS["wkv6"] is wkv6
    assert build.SOURCES["wkv6"] == "wkv6.cu"
    assert (build.CSRC / "wkv6.cu").exists() and HEAD_DIMS == (32, 64, 128)


@pytest.mark.parametrize("case", ["rank", "shape", "empty", "u_shape", "state_shape",
                                  "state_dtype", "int", "mixed", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, u, s = torch.zeros(1, 4, 2, 32), torch.zeros(2, 32), torch.zeros(1, 2, 32, 32)
    args = {
        "rank": (x[0], x[0], x[0], x[0], u),
        "shape": (x, x, x[:, :3], x, u),
        "empty": (x[:, :0],) * 4 + (u,),
        "u_shape": (x, x, x, x, u[:1]),
        "state_shape": (x, x, x, x, u, s[:, :1]),
        "state_dtype": (x, x, x, x, u, s.double()),
        "int": (x.int(), x.int(), x.int(), x, u),
        "mixed": (x, x.bfloat16(), x, x, u),
        "device": tuple(a.to("meta") for a in (x, x, x, x, u)),
    }[case]
    err = TypeError if case in ("int", "mixed") else ValueError
    with pytest.raises(err):
        wkv6(*args)


# The split route's arithmetic against the sequential oracles: T shorter
# than a chunk, a step either side of it, ragged T in chunks of 64 and 16,
# B = 2, a state carried in, bf16, and the log-decays of -1 and -1.5 where
# the reference's chunk-64 form is off by whole units.
# (name, b, t, h, m, chunk, log-decay, state in, dtype)
SPLIT_CASES = [
    ("T_below_L", 1, 40, 2, 32, 64, None, True, "f32"),
    ("T_L-1", 1, 63, 2, 32, 64, None, True, "f32"),
    ("T_L+1", 1, 65, 2, 32, 64, None, True, "f32"),
    ("T777", 1, 777, 2, 32, 64, None, True, "f32"),
    ("T777_chunk16", 1, 777, 2, 32, 16, None, True, "f32"),
    ("B2_zero_state", 2, 200, 2, 32, 64, None, False, "f32"),
    ("B2_bf16", 2, 130, 2, 32, 64, None, True, "bf16"),
    ("decay_-1", 1, 320, 2, 64, 64, -1.0, False, "f32"),
    ("decay_-1.5", 1, 320, 2, 64, 64, -1.5, False, "f32"),
]


@pytest.mark.parametrize("oracle", ["kernel_ref", "model_scan"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: c[0])
def test_split_ref_matches_jax_sequential(case, oracle):
    _, b, t, h, m, chunk, lam, state, dtype = case
    r, k, v, w, u, s = _draw(t + m + chunk, b, t, h, m, lam=lam, state=state)
    (jr, jk, jv), (tr, tk, tv) = _both([r, k, v], dtype)
    rest = [w, u] + ([s] if state else [])
    jfn = jax_wkv6_ref if oracle == "kernel_ref" else wkv6_scan
    want, s_want = jfn(jr, jk, jv, *(jnp.asarray(a) for a in rest))
    got, s_got = wkv6_split_ref(tr, tk, tv, *(torch.from_numpy(a) for a in rest), chunk=chunk)
    assert got.dtype == tr.dtype and s_got.dtype == torch.float32
    _close(got, want, EXACT[dtype])
    _close(s_got, s_want, EXACT["f32"])
    if lam is not None:  # where the reference's chunked form is off by whole units
        clamped, _ = jnp_wkv6_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=64)
        assert np.abs(np.asarray(clamped) - np.asarray(want)).max() > 1.0


def test_route_takes_split_from_the_threshold():
    assert ROUTES == ("step", "split")
    assert [wkv6_route(t) for t in (1, SPLIT_MIN_T - 1, SPLIT_MIN_T, 2048)] == [
        "step", "step", "split", "split"]
    chunks = {(b, t): split_chunk(b, t) for b in (1, 2, 4, 8) for t in (1, 256, 777, 2048, 4096)}
    assert all(c & (c - 1) == 0 and 16 <= c <= 128 for c in chunks.values())
    assert chunks[(1, 2048)] == 128 and chunks[(1, 256)] == 16  # the card's fastest


def test_cpu_wrapper_takes_the_plain_version_on_any_route():
    args = [torch.from_numpy(a) for a in _draw(3, 1, 300, 2, 32, state=True)]
    want = wkv6_ref(*args)
    before = wkv6.launches, dict(wkv6.route_launches)
    for route in (None, "step", "split"):
        got = wkv6(*args, route=route, chunk=16)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (wkv6.launches, wkv6.route_launches) == before
    for bad in (dict(route="scan"), dict(chunk=0), dict(chunk=True)):
        with pytest.raises(ValueError):
            wkv6(*args, **bad)
