"""The port's WKV6 backward on the CPU against the JAX package: the plain
backward (``wkv6_bwd_ref``) and the autograd Function the ``wkv6`` wrapper
routes through under grad, both against ``jax.vjp`` of the kernel oracle
``repro.kernels.wkv6.ref.wkv6_ref``; and the backward kernel's chunked
arithmetic in plain ops (``wkv6_bwd_split_ref``) against the step-by-step
version.  Inputs come from numpy seeds and go to both packages as the same
f32 numbers.  The CUDA kernel itself is held against the plain backward on
the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: atol 1e-5, rtol 1e-4.  Both sides run the same f32 recurrence,
forward and back, with products summed in other orders; each gradient is a
sum over up to T steps of terms of the inputs' size, so a relative 1e-4
leaves room for T = 300 steps of f32 rounding (6e-8 each) at decays up to
0.999, where a state keeps all of them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro_torch.kernels import WRAPPERS
from repro_torch.kernels.wkv6 import (
    BWD_ROUTES, bwd_chunk, wkv6, wkv6_bwd, wkv6_bwd_ref, wkv6_bwd_split_ref,
)

TOL = dict(atol=1e-5, rtol=1e-4)
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")


def _draw(seed, b, t, h, m, state=False, dstate=False):
    """r, k, v, dout ~ N(0, 0.25); decays log-uniform in [1e-6, 0.999];
    u ~ N(0, 0.09); an N(0, 0.25) state and final-state cotangent when
    asked."""
    rng = np.random.default_rng(seed)
    r, k, v, dout = (rng.standard_normal((b, t, h, m)).astype(np.float32) * 0.5
                     for _ in range(4))
    w = np.exp(rng.uniform(np.log(1e-6), np.log(0.999), (b, t, h, m))).astype(np.float32)
    u = (rng.standard_normal((h, m)) * 0.3).astype(np.float32)
    s = (rng.standard_normal((b, h, m, m)) * 0.5).astype(np.float32) if state else None
    ds = (rng.standard_normal((b, h, m, m)) * 0.5).astype(np.float32) if dstate else None
    return r, k, v, w, u, s, dout, ds


def _jax_grads(r, k, v, w, u, s, dout, ds):
    """jax.vjp of the oracle at (dout, ds); the state's gradient when one
    was given."""
    b, _, h, m = r.shape
    s0 = jnp.asarray(s) if s is not None else jnp.zeros((b, h, m, m), jnp.float32)
    _, vjp = jax.vjp(jax_wkv6_ref, *(jnp.asarray(x) for x in (r, k, v, w, u)), s0)
    ds = jnp.zeros((b, h, m, m), jnp.float32) if ds is None else jnp.asarray(ds)
    return [np.asarray(g) for g in vjp((jnp.asarray(dout), ds))]


def _torch(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _close(got, want, tol=TOL):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol,
                                   err_msg=name)


CASES = [(1, 1, 2, 32), (2, 7, 2, 64), (1, 64, 2, 64), (1, 300, 1, 32)]


@pytest.mark.parametrize("b,t,h,m", CASES, ids=lambda x: None)
@pytest.mark.parametrize("state,dstate", [(False, False), (True, False), (True, True)],
                         ids=["zero", "state", "state_dstate"])
def test_plain_bwd_matches_jax_vjp(b, t, h, m, state, dstate):
    arrs = _draw(t + m, b, t, h, m, state, dstate)
    got = wkv6_bwd_ref(*_torch(arrs))
    _close(got, _jax_grads(*arrs))
    assert [x.dtype for x in got] == [torch.float32] * 6


@pytest.mark.parametrize("b,t,h,m", CASES, ids=lambda x: None)
@pytest.mark.parametrize("dstate", [False, True], ids=["out", "out_and_state"])
def test_function_matches_jax_vjp(b, t, h, m, dstate):
    """``wkv6`` under grad on the CPU: the Function's forward is the plain
    forward and its backward the plain backward; autograd hands it the
    final state's cotangent only when the loss reads that state."""
    r, k, v, w, u, s, dout, ds = _draw(7 * t + m, b, t, h, m, True, dstate)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (r, k, v, w, u, s)]
    out, s_end = wkv6(*leaves)
    loss = (out * torch.from_numpy(dout)).sum()
    if dstate:
        loss = loss + (s_end * torch.from_numpy(ds)).sum()
    got = torch.autograd.grad(loss, leaves)
    _close(got, _jax_grads(r, k, v, w, u, s, dout, ds))


@pytest.mark.parametrize("b,t,h,m,chunk", [(1, 1, 2, 32, 16), (2, 7, 2, 64, 16),
                                           (1, 64, 2, 64, 16), (1, 300, 1, 32, 16),
                                           (2, 37, 2, 128, 8), (1, 100, 1, 32, 5)])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "state_dstate"])
def test_split_bwd_matches_the_step_by_step_backward(b, t, h, m, chunk, state):
    """The kernel's chunk-local passes, two carries and per-chunk walk back
    give the step-by-step backward's gradients: at one chunk, a ragged last
    chunk, T = 300 over 19 chunks and the kernel's chunk at each head size."""
    arrs = _torch(_draw(3 * t + chunk, b, t, h, m, state, state))
    got = wkv6_bwd_split_ref(*arrs, chunk=chunk)
    want = wkv6_bwd_ref(*arrs)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, **TOL, msg=name)


def test_kernel_chunk_by_head_size():
    assert [bwd_chunk(m) for m in (32, 64, 128)] == [16, 16, 8]


def test_function_returns_none_for_what_needs_no_gradient():
    """Only the operands that require grad get one; the plain backward runs
    once for the call, counted nowhere on the CPU."""
    r, k, v, w, u, s, dout, _ = _torch(_draw(1, 1, 9, 2, 32, True))
    k.requires_grad_()
    before = (wkv6_bwd.launches, dict(wkv6_bwd.route_launches))
    out, _ = wkv6(r, k, v, w, u, s)
    (gk,) = torch.autograd.grad((out * dout).sum(), (k,))
    want = wkv6_bwd_ref(r, k.detach(), v, w, u, s, dout)[1]
    torch.testing.assert_close(gk, want, **TOL)
    assert r.grad is None and s.grad is None
    assert (wkv6_bwd.launches, wkv6_bwd.route_launches) == before
    assert WRAPPERS["wkv6_bwd"] is wkv6_bwd and BWD_ROUTES == ("split",)


def test_function_takes_a_loss_on_the_final_state_alone():
    """Autograd hands the Function no output cotangent when the loss reads
    only the final state: the backward takes zeros for it."""
    r, k, v, w, u, s, _, ds = _draw(7, 1, 12, 2, 32, True, True)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (r, k, v, w, u, s)]
    _, s_end = wkv6(*leaves)
    got = torch.autograd.grad((s_end * torch.from_numpy(ds)).sum(), leaves)
    _close(got, _jax_grads(r, k, v, w, u, s, np.zeros_like(r), ds))


def test_function_takes_strided_cotangents():
    """A cotangent that autograd hands back strided (here the output read
    through a transpose) gives the gradients of a contiguous one."""
    r, k, v, w, u, _, dout, _ = _torch(_draw(2, 2, 11, 2, 32))
    r.requires_grad_()
    out, _ = wkv6(r, k, v, w, u)
    (got,) = torch.autograd.grad((out.transpose(0, 1) * dout.transpose(0, 1)).sum(), (r,))
    torch.testing.assert_close(got, wkv6_bwd_ref(r.detach(), k, v, w, u, None, dout)[0], **TOL)


def test_function_under_checkpoint_gives_the_same_gradients():
    """A checkpointed call runs the forward again in the backward and saves
    the same tensors: gradients bit-identical to the plain call's."""
    r, k, v, w, u, _, dout, _ = _torch(_draw(4, 1, 33, 2, 32))
    grads = []
    for remat in (False, True):
        leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
        run = lambda *xs: wkv6(*xs)[0]
        out = checkpoint(run, *leaves, use_reentrant=False) if remat else run(*leaves)
        grads.append(torch.autograd.grad((out * dout).sum(), leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_bwd_rounds_each_gradient_to_its_operand_dtype():
    """bf16 r, k, v, u and dout with f32 w, as the bf16 model calls it:
    each gradient in its operand's dtype, the f32 result rounded once."""
    r, k, v, w, u, s, dout, _ = _torch(_draw(5, 1, 20, 2, 32, True))
    bf = [x.to(torch.bfloat16) for x in (r, k, v, u, dout)]
    got = wkv6_bwd(bf[0], bf[1], bf[2], w, bf[3], s, bf[4])
    assert [x.dtype for x in got] == [torch.bfloat16] * 3 + [torch.float32, torch.bfloat16,
                                                             torch.float32]
    want = wkv6_bwd_ref(*(x.float() for x in bf[:3]), w, bf[3].float(), s, bf[4].float())
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_.to(g.dtype))


@pytest.mark.parametrize("case", ["dout_shape", "dout_dtype", "dstate_shape", "dstate_dtype"])
def test_bwd_refuses_cotangents_that_do_not_fit(case):
    r, k, v, w, u, s, dout, _ = _torch(_draw(6, 1, 4, 2, 32, True))
    ds = torch.zeros(1, 2, 32, 32)
    if case == "dout_shape":
        dout = dout[:, :3]
    elif case == "dout_dtype":
        dout = dout.double()
    elif case == "dstate_shape":
        ds = ds[:, :1]
    else:
        ds = ds.double()
    with pytest.raises(ValueError, match="wkv6_bwd"):
        wkv6_bwd(r, k, v, w, u, s, dout, ds)
