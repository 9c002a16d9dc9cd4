"""The port's selective-scan backward on the CPU against the JAX package:
the plain backward (``ssm_scan_bwd_ref``) and the autograd Function the
``ssm_scan`` wrapper routes through under grad, both against ``jax.vjp``
of the model's ``repro.models.ssm.selective_scan``; and the backward
kernel's chunked arithmetic in plain ops (``ssm_scan_bwd_split_ref``)
against the step-by-step version.  Inputs come from numpy seeds and go to
both packages as the same f32 numbers.  The CUDA kernel itself is held
against the plain backward on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerance: atol 1e-5, rtol 1e-4.  Both sides run the same f32 recurrence,
forward and back, with products summed in other orders (db and dc over
the D channels, da over the batch rows and steps), each term formed from
one exponential that the two libraries round within an ulp or two."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models.ssm import selective_scan as jax_selective_scan
from repro_torch.kernels import WRAPPERS
from repro_torch.kernels.ssm_scan import (
    BWD_CHUNK, BWD_ROUTES, ssm_scan, ssm_scan_bwd, ssm_scan_bwd_ref, ssm_scan_bwd_split_ref,
)

TOL = dict(atol=1e-5, rtol=1e-4)
NAMES = ("dx", "ddt", "da", "db", "dc", "dh0")
# dt domains: Mamba's (softplus(N(0, 1) - 4.6) + 1e-4, the model's init),
# and dt in [2, 3] with a whose decays exp(dt a) span [1e-6, 0.999]
DOMAINS = ("mamba", "wide")


def _draw(seed, b, t, d, n, domain="mamba", state=False, dh=False):
    """x, b, c, dy ~ N(0, 0.25); dt and a from ``domain``; an N(0, 0.25)
    initial state and final-state cotangent when asked."""
    rng = np.random.default_rng(seed)
    x, dy = (rng.standard_normal((b, t, d)) * 0.5 for _ in range(2))
    if domain == "mamba":
        dt = np.log1p(np.exp(rng.standard_normal((b, t, d)) - 4.6)) + 1e-4
        a = -np.exp(rng.standard_normal((d, n)) * 0.3)
    else:  # log-decays dt a in [log 1e-6, log 0.999] at dt = 2.5
        dt = rng.uniform(2.0, 3.0, (b, t, d))
        a = rng.uniform(np.log(1e-6), np.log(0.999), (d, n)) / 2.5
    bb, cc = (rng.standard_normal((b, t, n)) * 0.5 for _ in range(2))
    h0 = rng.standard_normal((b, d, n)) * 0.5 if state else None
    dhs = rng.standard_normal((b, d, n)) * 0.5 if dh else None
    f32 = lambda v: None if v is None else np.asarray(v, np.float32)
    return tuple(f32(v) for v in (x, dt, a, bb, cc, h0, dy, dhs))


def _jax_grads(x, dt, a, b, c, h0, dy, dh):
    bsz, _, d = x.shape
    n = a.shape[1]
    h = jnp.asarray(h0) if h0 is not None else jnp.zeros((bsz, d, n), jnp.float32)
    _, vjp = jax.vjp(jax_selective_scan, *(jnp.asarray(v) for v in (x, dt, a, b, c)), h)
    dh = jnp.zeros((bsz, d, n), jnp.float32) if dh is None else jnp.asarray(dh)
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), dh))]


def _torch(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _close(got, want, tol=TOL):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol,
                                   err_msg=name)


CASES = [(1, 1, 16, 8), (2, 7, 24, 16), (1, 64, 40, 8), (1, 300, 16, 16)]


@pytest.mark.parametrize("b,t,d,n", CASES, ids=lambda x: None)
@pytest.mark.parametrize("domain", DOMAINS)
@pytest.mark.parametrize("state,dh", [(False, False), (True, False), (True, True)],
                         ids=["zero", "h0", "h0_dh"])
def test_plain_bwd_matches_jax_vjp(b, t, d, n, domain, state, dh):
    arrs = _draw(t + d, b, t, d, n, domain, state, dh)
    got = ssm_scan_bwd_ref(*_torch(arrs))
    _close(got, _jax_grads(*arrs))
    assert [x.dtype for x in got] == [torch.float32] * 6


@pytest.mark.parametrize("b,t,d,n", CASES, ids=lambda x: None)
@pytest.mark.parametrize("domain", DOMAINS)
@pytest.mark.parametrize("dh", [False, True], ids=["y", "y_and_state"])
def test_function_matches_jax_vjp(b, t, d, n, domain, dh):
    """``ssm_scan`` under grad on the CPU: the Function's forward is the
    plain forward and its backward the plain backward; autograd hands it
    the final state's cotangent only when the loss reads that state."""
    x, dt, a, bb, cc, h0, dy, dhs = _draw(5 * t + d, b, t, d, n, domain, True, dh)
    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, dt, a, bb, cc, h0)]
    y, h = ssm_scan(*leaves)
    loss = (y * torch.from_numpy(dy)).sum()
    if dh:
        loss = loss + (h * torch.from_numpy(dhs)).sum()
    got = torch.autograd.grad(loss, leaves)
    _close(got, _jax_grads(x, dt, a, bb, cc, h0, dy, dhs))


@pytest.mark.parametrize("b,t,d,n,chunk", [(1, 1, 16, 8, 16), (2, 7, 24, 16, 16),
                                           (1, 64, 40, 8, 16), (1, 300, 16, 16, 16),
                                           (2, 100, 8, 8, 5)])
@pytest.mark.parametrize("domain", DOMAINS)
@pytest.mark.parametrize("state", [False, True], ids=["zero", "h0_dh"])
def test_split_bwd_matches_the_step_by_step_backward(b, t, d, n, chunk, domain, state):
    """The kernel's chunk-local passes, two carries and per-chunk walk back
    give the step-by-step backward's gradients, at one chunk, a ragged last
    chunk and T = 300 over 19 chunks."""
    arrs = _torch(_draw(3 * t + chunk, b, t, d, n, domain, state, state))
    got = ssm_scan_bwd_split_ref(*arrs, chunk=chunk)
    want = ssm_scan_bwd_ref(*arrs)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, **TOL, msg=name)


def test_function_returns_none_for_what_needs_no_gradient():
    """Only the operands that require grad get one; nothing is counted on
    the CPU."""
    x, dt, a, bb, cc, h0, dy, _ = _torch(_draw(1, 1, 9, 16, 8, state=True))
    a.requires_grad_()
    before = (ssm_scan_bwd.launches, dict(ssm_scan_bwd.route_launches))
    y, _ = ssm_scan(x, dt, a, bb, cc, h0)
    (ga,) = torch.autograd.grad((y * dy).sum(), (a,))
    torch.testing.assert_close(ga, ssm_scan_bwd_ref(x, dt, a.detach(), bb, cc, h0, dy)[2], **TOL)
    assert x.grad is None and h0.grad is None
    assert (ssm_scan_bwd.launches, ssm_scan_bwd.route_launches) == before
    assert WRAPPERS["ssm_scan_bwd"] is ssm_scan_bwd and BWD_ROUTES == ("split", "regs")
    assert BWD_CHUNK == 16


def test_function_takes_a_loss_on_the_final_state_alone():
    """Autograd hands the Function no cotangent of y when the loss reads
    only the final state: the backward takes zeros for it."""
    x, dt, a, bb, cc, h0, _, dh = _draw(7, 1, 12, 16, 8, "wide", True, True)
    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, dt, a, bb, cc, h0)]
    _, h = ssm_scan(*leaves)
    got = torch.autograd.grad((h * torch.from_numpy(dh)).sum(), leaves)
    _close(got, _jax_grads(x, dt, a, bb, cc, h0, np.zeros_like(x), dh))


def test_function_takes_strided_cotangents():
    x, dt, a, bb, cc, _, dy, _ = _torch(_draw(2, 2, 11, 16, 8))
    x.requires_grad_()
    y, _ = ssm_scan(x, dt, a, bb, cc)
    (got,) = torch.autograd.grad((y.transpose(0, 1) * dy.transpose(0, 1)).sum(), (x,))
    torch.testing.assert_close(got, ssm_scan_bwd_ref(x.detach(), dt, a, bb, cc, None, dy)[0],
                               **TOL)


def test_function_under_checkpoint_gives_the_same_gradients():
    x, dt, a, bb, cc, _, dy, _ = _torch(_draw(4, 1, 33, 16, 8))
    grads = []
    for remat in (False, True):
        leaves = [v.clone().requires_grad_() for v in (x, dt, a, bb, cc)]
        run = lambda *vs: ssm_scan(*vs)[0]
        y = checkpoint(run, *leaves, use_reentrant=False) if remat else run(*leaves)
        grads.append(torch.autograd.grad((y * dy).sum(), leaves))
    for p, q in zip(*grads):
        assert torch.equal(p, q)


def test_bwd_rounds_each_gradient_to_its_operand_dtype():
    """bf16 x, dt, b, c and dy with f32 a, as the bf16 model calls it: each
    gradient in its operand's dtype, the f32 result rounded once."""
    x, dt, a, bb, cc, h0, dy, _ = _torch(_draw(5, 1, 20, 16, 8, state=True))
    bf = [v.to(torch.bfloat16) for v in (x, dt, bb, cc, dy)]
    got = ssm_scan_bwd(bf[0], bf[1], a, bf[2], bf[3], h0, bf[4])
    assert [v.dtype for v in got] == [torch.bfloat16] * 2 + [torch.float32] + \
        [torch.bfloat16] * 2 + [torch.float32]
    want = ssm_scan_bwd_ref(bf[0].float(), bf[1].float(), a, bf[2].float(), bf[3].float(), h0,
                            bf[4].float())
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))


@pytest.mark.parametrize("case", ["dy_shape", "dy_dtype", "dh_shape", "dh_dtype"])
def test_bwd_refuses_cotangents_that_do_not_fit(case):
    x, dt, a, bb, cc, h0, dy, _ = _torch(_draw(6, 1, 4, 16, 8, state=True))
    dh = torch.zeros(1, 16, 8)
    if case == "dy_shape":
        dy = dy[:, :3]
    elif case == "dy_dtype":
        dy = dy.double()
    elif case == "dh_shape":
        dh = dh[:, :4]
    else:
        dh = dh.double()
    with pytest.raises(ValueError, match="ssm_scan_bwd"):
        ssm_scan_bwd(x, dt, a, bb, cc, h0, dy, dh)


@pytest.mark.parametrize("route", ["split", "regs", "shared"])
def test_bwd_takes_its_routes_and_refuses_others(route):
    """Either route on the CPU is the plain backward; an unknown route
    raises before any work."""
    x, dt, a, bb, cc, h0, dy, dh = _torch(_draw(9, 1, 5, 16, 8, state=True, dh=True))
    if route not in BWD_ROUTES:
        with pytest.raises(ValueError, match="ssm_scan_bwd route"):
            ssm_scan_bwd(x, dt, a, bb, cc, h0, dy, dh, route=route)
        return
    got = ssm_scan_bwd(x, dt, a, bb, cc, h0, dy, dh, route=route)
    want = ssm_scan_bwd_ref(x, dt, a, bb, cc, h0, dy, dh)
    assert all(torch.equal(p, q) for p, q in zip(got, want))
