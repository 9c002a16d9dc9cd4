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
the JAX sweep's own 5e-3 (f32) and 5e-2 (bf16)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.kernel import wkv6_chunked as pallas_wkv6
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models.rwkv import wkv6_chunked as jnp_wkv6_chunked
from repro.models.rwkv import wkv6_scan
from repro_torch.kernels import WRAPPERS, build
from repro_torch.kernels.wkv6 import HEAD_DIMS, wkv6, wkv6_ref

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
