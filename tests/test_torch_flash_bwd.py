"""The flash-attention backward on the CPU: the plain version of the
backward kernel (``flash_attention_bwd_ref``) against ``torch.autograd`` of
the plain forward and against ``jax.vjp`` of the JAX package's training
attention (``repro.models.attention.attend``), and the autograd ``Function``
behind ``flash_attention`` against it.  Inputs come from numpy seeds;
f32 throughout, atol 1e-5 (three products of f32 summed in other orders,
each of magnitude ~1).

A row that sees no key (causal with S > T, which only the backward takes)
gets no gradient in the port: its dQ is 0 and it adds nothing to dK and
dV.  The plain forward's masked softmax spreads such a row evenly over all
T keys, so autograd and JAX give it a dV share; they are compared with the
row's dO set to 0, and the port's gradients are checked not to move when it
is not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attend
from repro_torch import kernels
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref, flash_attention_ref,
)

ATOL = 1e-5

# name: (b, s, t, h, kh, d, kwargs)
CASES = {
    "gqa": (2, 16, 16, 4, 2, 32, {}),
    "mha": (1, 12, 12, 3, 3, 16, {}),
    "causal_s_lt_t": (1, 8, 24, 6, 2, 32, {}),
    "window": (1, 24, 24, 4, 1, 32, {"window": 5}),
    "softcap": (1, 16, 16, 4, 2, 32, {"softcap": 5.0}),
    "window_softcap_s_lt_t": (1, 12, 40, 4, 2, 32, {"window": 7, "softcap": 3.0}),
    "non_causal": (1, 16, 32, 2, 2, 32, {"causal": False}),
    "keyless_rows": (1, 24, 16, 4, 2, 32, {}),  # rows 0-7 see no key
}


def _inputs(case, seed=0):
    b, s, t, h, kh, d, kw = CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))
    dout = rng.standard_normal((b, s, h, d)).astype(np.float32)
    keyless = max(0, s - t) if kw.get("causal", True) else 0
    return q, k, v, dout, keyless, kw


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def _close(got, want, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   atol=ATOL, rtol=ATOL, err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_ref_matches_autograd_of_the_plain_forward(case):
    q, k, v, dout, keyless, kw = _inputs(case)
    dout[:, :keyless] = 0.0  # a keyless row's dO: see the module's note
    tq, tk, tv = _t(q, k, v, grad=True)
    out = flash_attention_ref(tq, tk, tv, **kw)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(dout))
    got = flash_attention_bwd_ref(*_t(q, k, v), out.detach(), torch.tensor(dout), **kw)
    _close([x.numpy() for x in got], [x.numpy() for x in want], case)


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_ref_matches_jax_vjp_of_attend(case):
    q, k, v, dout, keyless, kw = _inputs(case, seed=1)
    dout[:, :keyless] = 0.0
    s, t = q.shape[1], k.shape[1]
    causal = kw.get("causal", True)

    def f(q, k, v):
        return attend(q, k, v, q_pos=jnp.arange(s) + (t - s), k_pos=jnp.arange(t),
                      causal=causal, window=kw.get("window"), cap=kw.get("softcap"))

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    got = flash_attention_bwd_ref(*_t(q, k, v), torch.tensor(np.asarray(out)),
                                  torch.tensor(dout), **kw)
    _close([x.numpy() for x in got], want, case)


def test_keyless_rows_get_no_gradient():
    q, k, v, dout, keyless, kw = _inputs("keyless_rows", seed=2)
    assert keyless == 8
    out = flash_attention_ref(*_t(q, k, v))
    got = flash_attention_bwd_ref(*_t(q, k, v), out, torch.tensor(dout))
    assert all(torch.isfinite(x).all() for x in got)
    assert torch.equal(got[0][:, :keyless], torch.zeros_like(got[0][:, :keyless]))
    quiet = dout.copy()
    quiet[:, :keyless] = 0.0
    same = flash_attention_bwd_ref(*_t(q, k, v), out, torch.tensor(quiet))
    for a, b in zip(got, same):
        torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)


@pytest.mark.parametrize("case", [c for c in CASES if c != "keyless_rows"])
def test_autograd_function_gives_the_bwd_ref(case):
    """On the CPU the Function's forward is the plain forward and its
    backward the plain backward: the gradients are flash_attention_bwd_ref's
    bit for bit, and the output the plain forward's."""
    q, k, v, dout, _, kw = _inputs(case, seed=3)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = flash_attention(tq, tk, tv, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(dout))
    plain = flash_attention_ref(*_t(q, k, v), **kw)
    want = flash_attention_bwd_ref(*_t(q, k, v), plain, torch.tensor(dout), **kw)
    assert torch.equal(out.detach(), plain)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_takes_keyless_rows_only_in_the_backward():
    q, k, v, dout, _, _ = _inputs("keyless_rows")
    with pytest.raises(ValueError, match="T >= S"):
        flash_attention(*_t(q, k, v))
    out = flash_attention_ref(*_t(q, k, v))
    got = flash_attention_bwd(*_t(q, k, v), out, torch.tensor(dout))
    want = flash_attention_bwd_ref(*_t(q, k, v), out, torch.tensor(dout))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="q's shape"):
        flash_attention_bwd(*_t(q, k, v), out[:, :1], torch.tensor(dout))


def test_grad_off_records_nothing():
    """Serving: no input requires grad, or grad mode is off: no graph, no
    saved tensors, the same output."""
    q, k, v, _, _, _ = _inputs("gqa")
    out = flash_attention(*_t(q, k, v))
    assert out.grad_fn is None
    tq, tk, tv = _t(q, k, v, grad=True)
    with torch.no_grad():
        quiet = flash_attention(tq, tk, tv)
    assert quiet.grad_fn is None and torch.equal(quiet, out)


def test_bf16_gradients_keep_the_input_type():
    q, k, v, dout, _, _ = _inputs("gqa", seed=4)
    tq, tk, tv = (x.to(torch.bfloat16).requires_grad_() for x in _t(q, k, v))
    out = flash_attention(tq, tk, tv)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(dout).to(torch.bfloat16))
    assert all(g.dtype == torch.bfloat16 for g in got)
    # bf16 inputs, f32 arithmetic: within bf16's rounding of the f32 gradients
    want = flash_attention_bwd_ref(*(x.detach().float() for x in (tq, tk, tv)),
                                   out.detach().float(), torch.tensor(dout).to(torch.bfloat16).float())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, atol=2e-2, rtol=2**-7)


def test_backward_wrapper_is_counted_with_the_others():
    assert kernels.WRAPPERS["flash_attention_bwd"] is flash_attention_bwd
    flash_attention_bwd.launches = 3
    flash_attention_bwd.route_launches["simt"] = 3
    kernels.reset_launches()
    assert kernels.launch_counts()["flash_attention_bwd"] == 0
    assert flash_attention_bwd.route_launches == {"simt": 0}
