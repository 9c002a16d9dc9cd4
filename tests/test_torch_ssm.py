"""The port's selective scan and SSM head (plain versions on the CPU)
against the JAX package: the kernel oracle ``ssm_scan_ref``, the model's
``selective_scan``, the Pallas kernel in interpret mode, ``causal_conv`` and
``ssm_head``; and the windowed plain flash attention against the model's
``attend``.  Inputs come from numpy seeds and go to both packages as the
same numbers (bf16 inputs are the f32 draws rounded to nearest even by
both).  The CUDA kernels themselves are held against these plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: against the sequential oracles, f32 agrees to 1e-5 (the same
f32 recurrence, products summed in another order); bf16 outputs may round
to the other bf16 neighbour (rtol 2**-7).  Against the Pallas chunked
form, the JAX sweep's own 1e-4 (f32) and 5e-2 (bf16).  The SSM head in
f32 agrees to 1e-5 of its largest output; in bf16 it is held to the
reference's own bf16 accuracy (ROADMAP T11: rms distance to the f32
result), since two bf16 renderings round the same sums at other points.
The split route's arithmetic in plain ops (``ssm_scan_split_ref``) is held
to 1e-5 / rtol 2**-7 against the sequential oracles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.kernel import ssm_scan_chunked as pallas_ssm
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm_ref
from repro.models import ssm as jssm
from repro.models.attention import attend as jax_attend
from repro.models.common import ModelConfig as JaxModelConfig
from repro_torch.kernels import WRAPPERS, build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssm_scan import (
    ROUTES, SPLIT_MIN_T, STATE_DIMS, split_chunk, ssm_scan, ssm_scan_ref, ssm_scan_route,
    ssm_scan_split_ref,
)
from repro_torch.models import ssm
from repro_torch.models.common import ModelConfig, ParamFactory

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
EXACT = {"f32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=1e-5, rtol=2.0**-7)}
SWEEP_TOL = {"f32": 1e-4, "bf16": 5e-2}  # tests/test_kernels.py's

# the JAX kernel sweep (tests/test_kernels.py): b, t, d, n, chunk, bd
SWEEP = [(2, 128, 64, 16, 32, 32), (1, 64, 128, 8, 16, 128), (2, 96, 32, 16, 32, 32)]


def _draw(seed, b, t, d, n, state=False, dt_range=None):
    """x, b, c ~ N(0, 0.25); dt = softplus(N(0, 1) - 4.6) + 1e-4 (Mamba's
    domain, the JAX sweep's) or uniform in ``dt_range``; a = -exp(N(0,
    0.09)); an N(0, 0.25) state when ``state``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)) * 0.5
    if dt_range is None:
        dt = np.log1p(np.exp(rng.standard_normal((b, t, d)) - 4.6)) + 1e-4
    else:
        dt = rng.uniform(*dt_range, (b, t, d))
    a = -np.exp(rng.standard_normal((d, n)) * 0.3)
    bb, cc = (rng.standard_normal((b, t, n)) * 0.5 for _ in range(2))
    h0 = rng.standard_normal((b, d, n)) * 0.5 if state else None
    f32 = lambda v: None if v is None else np.asarray(v, np.float32)
    return f32(x), f32(dt), f32(a), f32(bb), f32(cc), f32(h0)


def _both(arrs, dtype):
    jdt, tdt = DTYPES[dtype]
    return [jnp.asarray(a, jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _rms(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float32) - np.asarray(b, np.float32)) ** 2)))


# ------------------------------------------------------------ the scan
@pytest.mark.parametrize("b,t,d,n", [(2, 37, 48, 16), (1, 1, 1600, 16), (3, 64, 20, 8),
                                     (2, 5, 7, 8)])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_jax_oracle(b, t, d, n, state, dtype):
    x, dt, a, bb, cc, h0 = _draw(t * d + n, b, t, d, n, state)
    (jx, jdt, jb, jc), (tx, tdt, tb, tc) = _both([x, dt, bb, cc], dtype)
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    want, h_want = jax_ssm_ref(jx, jdt, jnp.asarray(a), jb, jc, jh0)
    got, h_got = ssm_scan(tx, tdt, torch.from_numpy(a), tb, tc, th0)
    assert got.dtype == tx.dtype and got.shape == (b, t, d)
    assert h_got.dtype == torch.float32 and h_got.shape == (b, d, n)
    _close(got, want, EXACT[dtype])
    _close(h_got, h_want, EXACT["f32"])


@pytest.mark.parametrize("t", [1, 7, 65, 130])
def test_plain_matches_model_scan_from_a_state(t):
    """Decode (T = 1) and ragged prompts from a nonzero state, against
    ``repro.models.ssm.selective_scan`` (its sqrt-T remat chunks of 64)."""
    b, d, n = 2, 24, 16
    x, dt, a, bb, cc, h0 = _draw(t + 100, b, t, d, n, state=True)
    want, h_want = jssm.selective_scan(*(jnp.asarray(v) for v in (x, dt, a, bb, cc, h0)))
    got, h_got = ssm_scan(*(torch.from_numpy(v) for v in (x, dt, a, bb, cc, h0)))
    _close(got, want, EXACT["f32"])
    _close(h_got, h_want, EXACT["f32"])


@pytest.mark.parametrize("b,t,d,n,chunk,bd", SWEEP)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_interpret(b, t, d, n, chunk, bd, dtype):
    """The sweep as tests/test_kernels.py runs it: x, dt, b, c in the
    dtype, a in f32, a zero initial state."""
    x, dt, a, bb, cc, _ = _draw(t * d + n + 1, b, t, d, n)
    (jx, jdt, jb, jc), (tx, tdt, tb, tc) = _both([x, dt, bb, cc], dtype)
    want, h_want = pallas_ssm(jx, jdt, jnp.asarray(a), jb, jc, chunk=chunk, bd=bd,
                              interpret=True)
    got, h_got = ssm_scan(tx, tdt, torch.from_numpy(a), tb, tc)
    tol = SWEEP_TOL[dtype]
    _close(got, want, dict(atol=tol, rtol=tol))
    _close(h_got, h_want, dict(atol=tol, rtol=tol))


def test_plain_runs_hymba_width_where_pallas_needs_a_smaller_tile():
    """D = 1,600 is no multiple of the Pallas default tile of 128: it
    asserts there, runs with bd = 64, and the plain scan agrees with it."""
    x, dt, a, bb, cc, _ = _draw(1600, 1, 32, 1600, 16)
    jargs = [jnp.asarray(v) for v in (x, dt, a, bb, cc)]
    with pytest.raises(AssertionError):
        pallas_ssm(*jargs, interpret=True)
    want, h_want = pallas_ssm(*jargs, bd=64, interpret=True)
    got, h_got = ssm_scan(*(torch.from_numpy(v) for v in (x, dt, a, bb, cc)))
    _close(got, want, dict(atol=1e-4, rtol=1e-4))
    _close(h_got, h_want, dict(atol=1e-4, rtol=1e-4))


def test_plain_is_exact_past_the_clamp():
    """The exactness the kernel is held to: with dt of 2-3 per step at
    a ~ -1, a 32-step chunk's cumulative log-decay is about -80, past the
    chunked forms' -60 clamp.  The plain scan equals the sequential oracle
    there, while the reference's chunk-32 forms (the Pallas kernel and the
    model's jnp ``selective_scan_chunked``) are off by whole units."""
    x, dt, a, bb, cc, _ = _draw(60, 1, 128, 16, 16, dt_range=(2.0, 3.0))
    jargs = [jnp.asarray(v) for v in (x, dt, a, bb, cc)]
    want, h_want = jax_ssm_ref(*jargs)
    got, h_got = ssm_scan(*(torch.from_numpy(v) for v in (x, dt, a, bb, cc)))
    _close(got, want, EXACT["f32"])
    _close(h_got, h_want, EXACT["f32"])
    clamped, _ = pallas_ssm(*jargs, chunk=32, bd=16, interpret=True)
    jnp_clamped, _ = jssm.selective_scan_chunked(*jargs, chunk=32)
    for off in (clamped, jnp_clamped):
        assert np.abs(np.asarray(off) - np.asarray(want)).max() > 1.0


# The split route's arithmetic against the sequential oracles: T shorter
# than a chunk, a step either side of it, ragged T in chunks of 64 and 16,
# B = 2, a state carried in, bf16, N = 8, and dt of 2-3 per step, where the
# reference's chunk-32 forms are off by whole units.
# (name, b, t, d, n, chunk, state in, dt range, dtype)
SPLIT_CASES = [
    ("T_below_L", 1, 40, 24, 16, 64, True, None, "f32"),
    ("T_L-1", 1, 63, 24, 16, 64, True, None, "f32"),
    ("T_L+1", 1, 65, 24, 16, 64, True, None, "f32"),
    ("T777", 1, 777, 24, 16, 64, True, None, "f32"),
    ("T777_chunk16_n8", 1, 777, 24, 8, 16, True, None, "f32"),
    ("B2_zero_state", 2, 200, 20, 16, 64, False, None, "f32"),
    ("B2_bf16", 2, 130, 20, 16, 64, True, None, "bf16"),
    ("dt_2-3", 1, 320, 16, 16, 64, False, (2.0, 3.0), "f32"),
    ("dt_2-3_state", 2, 777, 16, 16, 64, True, (2.0, 3.0), "f32"),
]


@pytest.mark.parametrize("oracle", ["kernel_ref", "model_scan"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: c[0])
def test_split_ref_matches_jax_sequential(case, oracle):
    _, b, t, d, n, chunk, state, dt_range, dtype = case
    x, dt, a, bb, cc, h0 = _draw(t + d + chunk, b, t, d, n, state, dt_range)
    (jx, jdt, jb, jc), (tx, tdt, tb, tc) = _both([x, dt, bb, cc], dtype)
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    jfn = jax_ssm_ref if oracle == "kernel_ref" else jssm.selective_scan
    want, h_want = jfn(jx, jdt, jnp.asarray(a), jb, jc, jh0)
    got, h_got = ssm_scan_split_ref(tx, tdt, torch.from_numpy(a), tb, tc, th0, chunk=chunk)
    assert got.dtype == tx.dtype and h_got.dtype == torch.float32
    _close(got, want, EXACT[dtype])
    _close(h_got, h_want, EXACT["f32"])
    if dt_range is not None and h0 is None:  # where the reference's chunked form is off
        jargs = [jnp.asarray(v) for v in (x, dt, a, bb, cc)]
        clamped, _ = jssm.selective_scan_chunked(*jargs, chunk=32)
        assert np.abs(np.asarray(clamped) - np.asarray(want)).max() > 1.0


def test_route_takes_split_from_the_threshold():
    assert ROUTES == ("step", "split")
    assert [ssm_scan_route(t) for t in (1, SPLIT_MIN_T - 1, SPLIT_MIN_T, 2048)] == [
        "step", "step", "split", "split"]
    chunks = {(b, t): split_chunk(b, t) for b in (1, 2, 4, 8) for t in (1, 256, 777, 2048, 4096)}
    assert all(c & (c - 1) == 0 and 32 <= c <= 128 for c in chunks.values())
    assert chunks[(1, 2048)] == 64 and chunks[(4, 2048)] == 128  # the card's fastest


def test_cpu_wrapper_takes_the_plain_version_on_any_route():
    x, dt, a, bb, cc, h0 = (torch.from_numpy(v) for v in _draw(4, 1, 300, 8, 8, state=True))
    want = ssm_scan_ref(x, dt, a, bb, cc, h0)
    before = ssm_scan.launches, dict(ssm_scan.route_launches)
    for route in (None, "step", "split"):
        got = ssm_scan(x, dt, a, bb, cc, h0, route=route, chunk=16)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (ssm_scan.launches, ssm_scan.route_launches) == before
    for bad in (dict(route="scan"), dict(chunk=0), dict(chunk=2.0)):
        with pytest.raises(ValueError):
            ssm_scan(x, dt, a, bb, cc, h0, **bad)


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    x, dt, a, bb, cc, h0 = (torch.from_numpy(v) for v in _draw(0, 2, 5, 8, 8, state=True))
    before = ssm_scan.launches
    got, h_got = ssm_scan(x, dt, a, bb, cc, h0)
    assert ssm_scan.launches == before
    want, h_want = ssm_scan_ref(x, dt, a, bb, cc, h0)
    assert torch.equal(got, want) and torch.equal(h_got, h_want)
    assert not torch.equal(h_got, h0)  # a new state; the one given is not written
    zero, _ = ssm_scan(x, dt, a, bb, cc)
    assert torch.equal(zero, ssm_scan_ref(x, dt, a, bb, cc, torch.zeros(2, 8, 8))[0])
    assert WRAPPERS["ssm_scan"] is ssm_scan
    assert build.SOURCES["ssm_scan"] == "ssm_scan.cu"
    assert (build.CSRC / "ssm_scan.cu").exists() and STATE_DIMS == (8, 16)


@pytest.mark.parametrize("case", ["rank", "dt_shape", "a_shape", "bc_shape", "empty",
                                  "h0_shape", "h0_dtype", "a_dtype", "int", "mixed", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, a, b, h = torch.zeros(1, 4, 8), torch.zeros(8, 16), torch.zeros(1, 4, 16), torch.zeros(1, 8, 16)
    args = {
        "rank": (x[0], x[0], a, b, b),
        "dt_shape": (x, x[:, :3], a, b, b),
        "a_shape": (x, x, a[:4], b, b),
        "bc_shape": (x, x, a, b[:, :3], b[:, :3]),
        "empty": (x[:, :0], x[:, :0], a, b[:, :0], b[:, :0]),
        "h0_shape": (x, x, a, b, b, h[:, :4]),
        "h0_dtype": (x, x, a, b, b, h.double()),
        "a_dtype": (x, x, a.bfloat16(), b, b),
        "int": (x.int(), x.int(), a, b.int(), b.int()),
        "mixed": (x, x.bfloat16(), a, b, b),
        "device": tuple(v.to("meta") for v in (x, x, a, b, b)),
    }[case]
    err = TypeError if case in ("a_dtype", "int", "mixed") else ValueError
    with pytest.raises(err):
        ssm_scan(*args)


# ------------------------------------------------------------ the head
def _head_case(seed, d, n, t, state):
    """One layer's ``ssm.*`` leaves (hymba's init, with a_log, d_skip and
    dt_bias redrawn so every term counts), an input, and a carried state."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    leaves = {
        "ssm.w_in": f(d, 2 * d, sc=d**-0.5), "ssm.conv": f(ssm.CONV_K, d, sc=0.5),
        "ssm.w_bcdt": f(d, 2 * n + 1, sc=d**-0.5), "ssm.dt_bias": -4.6 + f(d, sc=0.5),
        "ssm.a_log": f(d, n, sc=0.3), "ssm.d_skip": 1.0 + f(d, sc=0.3),
        "ssm.w_out": f(d, d, sc=d**-0.5),
    }
    x = f(2, t, d)
    st = {"conv": f(2, ssm.CONV_K - 1, d), "h": f(2, d, n, sc=0.5)} if state else None
    return leaves, x, st


def _port_head(leaves, d, n, dtype):
    cfg = ModelConfig(d_model=d, ssm_state=n)
    head = ssm.SSMHead(cfg, ParamFactory(0, dtype, torch.device("cpu"), fill=False))
    for name, p in head.named_parameters():
        p.copy_(torch.from_numpy(leaves[f"ssm.{name}"]))
    return cfg, head


def _jax_head(leaves, x, st, d, n, dtype, chunk=0):
    jdt = DTYPES[dtype][0]
    jcfg = JaxModelConfig(d_model=d, ssm_state=n, ssm_chunk=chunk)
    jl = {k: jnp.asarray(v, jdt) for k, v in leaves.items()}
    jst = None if st is None else {"conv": jnp.asarray(st["conv"], jdt), "h": jnp.asarray(st["h"])}
    return jssm.ssm_head(jnp.asarray(x, jdt), jl, jcfg, jst)


def _torch_head(leaves, x, st, d, n, dtype):
    tdt = DTYPES[dtype][1]
    cfg, head = _port_head(leaves, d, n, tdt)
    tst = None if st is None else {"conv": torch.from_numpy(st["conv"]).to(tdt),
                                   "h": torch.from_numpy(st["h"])}
    return ssm.ssm_head(torch.from_numpy(x).to(tdt), head, cfg, tst)


@pytest.mark.parametrize("t", [1, 3, 9])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_causal_conv_matches_jax(t, dtype):
    rng = np.random.default_rng(t)
    x, k, prev = (rng.standard_normal(s).astype(np.float32) for s in
                  ((2, t, 64), (ssm.CONV_K, 64), (2, ssm.CONV_K - 1, 64)))
    (jx, jk, jp), (tx, tk, tp) = _both([x, k, prev], dtype)
    for jprev, tprev in ((None, None), (jp, tp)):
        want, w_state = jssm.causal_conv(jx, jk, jprev)
        got, g_state = ssm.causal_conv(tx, tk, tprev)
        assert got.dtype == tx.dtype and g_state.shape == (2, ssm.CONV_K - 1, 64)
        # the same bf16 products summed in the same order: equal bits
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        np.testing.assert_array_equal(g_state.float().numpy(), np.asarray(w_state, np.float32))


@pytest.mark.parametrize("d,n,t", [(64, 8, 21), (1600, 16, 6)], ids=["smoke", "hymba"])
@pytest.mark.parametrize("state", [False, True], ids=["fresh", "carried"])
def test_ssm_head_matches_jax_f32(d, n, t, state):
    """Fresh (JAX's cache-less call, both its chunked form and its exact
    scan) and from a carried conv and SSM state (JAX's decode form)."""
    leaves, x, st = _head_case(d + t, d, n, t, state)
    got, new = _torch_head(leaves, x, st, d, n, "f32")
    scale = 1e-5 * max(1.0, float(np.abs(got.numpy()).max()))
    for chunk in ((32, 0) if st is None else (0,)):
        want, jnew = _jax_head(leaves, x, st, d, n, "f32", chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=scale, rtol=1e-5)
        np.testing.assert_allclose(new["conv"].numpy(), np.asarray(jnew["conv"]), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(new["h"].numpy(), np.asarray(jnew["h"]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d,n,t", [(64, 8, 21), (1600, 16, 6)], ids=["smoke", "hymba"])
@pytest.mark.parametrize("state", [False, True], ids=["fresh", "carried"])
def test_ssm_head_bf16_as_accurate_as_jax(d, n, t, state):
    """bf16, held to the reference's own bf16 accuracy: the port's rms
    distance to the f32 head (on the same bf16-rounded weights and inputs)
    is within 10% of JAX's bf16 rms distance to it, and its rms distance to
    JAX's bf16 head within that same distance."""
    leaves, x, st = _head_case(d + t + 1, d, n, t, state)
    rnd = lambda v: np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
    leaves = {k: rnd(v) for k, v in leaves.items()}
    x = rnd(x)
    if st is not None:
        st = {"conv": rnd(st["conv"]), "h": st["h"]}
    exact, _ = _jax_head(leaves, x, st, d, n, "f32")
    want, _ = _jax_head(leaves, x, st, d, n, "bf16")
    got, new = _torch_head(leaves, x, st, d, n, "bf16")
    assert got.dtype == torch.bfloat16 and new["h"].dtype == torch.float32
    ref_err = _rms(want, exact)
    assert ref_err > 0
    assert _rms(got.float(), exact) <= 1.1 * ref_err
    assert _rms(got.float(), want) <= ref_err


def test_ssm_head_takes_one_scan_per_call():
    """A prompt and a decode step each reach the scan wrapper once."""
    leaves, x, st = _head_case(3, 64, 8, 5, True)
    cfg, head = _port_head(leaves, 64, 8, torch.float32)
    calls = []
    real = ssm.ssm_scan

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    ssm.ssm_scan = counting
    try:
        _, new = ssm.ssm_head(torch.from_numpy(x), head, cfg)
        ssm.ssm_head(torch.from_numpy(x[:, :1]), head, cfg, new)
    finally:
        ssm.ssm_scan = real
    assert calls == [(2, 5, 64), (2, 1, 64)]


# ---------------------------------------------------- windowed attention
@pytest.mark.parametrize("s,offset", [(40, 0), (1, 20), (1, 63), (5, 40), (3, 16)],
                         ids=["prefill40", "decode@20", "decode@63", "chunk5@40", "chunk3@16"])
@pytest.mark.parametrize("h,kh,d", [(5, 1, 64), (10, 2, 32)], ids=["g5d64", "g5d32"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_windowed_flash_matches_masked_attend(s, offset, h, kh, d, dtype):
    """The serving path's windowed attention: the plain flash version over
    the cache's valid prefix with window 16 equals the JAX model's
    ``attend(window=16)`` over the whole cache with ``k_valid = k_pos <
    offset + S``, at prefill and at decode offsets past the window.  Slots
    past the prefix hold garbage that must not leak in."""
    b, t_max, window = 2, 64, 16
    rng = np.random.default_rng(s + offset + d)
    q, kc, vc = (rng.standard_normal(sh).astype(np.float32)
                 for sh in ((b, s, h, d), (b, t_max, kh, d), (b, t_max, kh, d)))
    kc[:, offset + s :] = 1e4
    vc[:, offset + s :] = -1e4
    (jq, jk, jv), (tq, tk, tv) = _both([q, kc, vc], dtype)
    k_pos = jnp.arange(t_max)
    k_valid = jnp.broadcast_to((k_pos < offset + s)[None, :], (b, t_max))
    want = jax_attend(jq, jk, jv, q_pos=offset + jnp.arange(s), k_pos=k_pos, k_valid=k_valid,
                      window=window)
    n = offset + s
    got = flash_attention(tq, tk[:, :n], tv[:, :n], window=window)
    tol = {"f32": 2e-5, "bf16": 2e-2}[dtype]
    _close(got, want, dict(atol=tol, rtol=tol))
    if n > window:  # the window moved the answer
        glob = flash_attention(tq, tk[:, :n], tv[:, :n])
        assert (glob.float() - got.float()).abs().max() > 10 * tol


@pytest.mark.parametrize("window", [-1, 1.5, True])
def test_flash_refuses_a_bad_window(window):
    q = torch.zeros(1, 2, 2, 32)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, window=window)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, q, q, causal=False, window=4)
