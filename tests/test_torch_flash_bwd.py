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
is not.

The plain log-sum-exp that the forward writes for the backward is held to
``jax.nn.logsumexp`` of ``attend``'s masked f32 logits, and the bf16 plain
backward, with its rounding points (P and dS to bf16), to the reference's
own bf16 accuracy: its rms distance to ``jax.vjp`` on f32 copies at most
twice that of ``jax.vjp`` of ``attend`` in bf16 (as ROADMAP T11 holds
rwkv6's bf16 logits)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import NEG, attend
from repro.models.common import softcap as jax_softcap
from repro_torch import kernels
from repro_torch.kernels.flash_attention import (
    BWD_ROUTES, bwd_route_forced, flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    flash_attention_bwd_step_ref, flash_attention_lse_ref, flash_attention_ref,
)
from repro_torch.kernels.flash_attention.ref import visible

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


def _attend(case):
    """JAX ``attend`` at the case's positions and options."""
    _, s, t, _, _, _, kw = CASES[case]

    def f(q, k, v):
        return attend(q, k, v, q_pos=jnp.arange(s) + (t - s), k_pos=jnp.arange(t),
                      causal=kw.get("causal", True), window=kw.get("window"),
                      cap=kw.get("softcap"))
    return f


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_ref_matches_jax_vjp_of_attend(case):
    q, k, v, dout, keyless, kw = _inputs(case, seed=1)
    dout[:, :keyless] = 0.0
    out, vjp = jax.vjp(_attend(case), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
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


@pytest.mark.parametrize("route", BWD_ROUTES)
def test_forced_route_reaches_the_backward(route, monkeypatch):
    """``bwd_route_forced`` hands its route to the backward of a call made
    in its block, even one whose backward runs after the block; outside it
    the backward takes the default (None), and an unknown route raises."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    asked = []
    real = flash_kernel.flash_attention_bwd

    def spy(*args, route=None, **kw):
        asked.append(route)
        return real(*args, route=route, **kw)

    monkeypatch.setattr(flash_kernel, "flash_attention_bwd", spy)
    q, k, v, dout, _, kw = _inputs("gqa", seed=4)
    tq, tk, tv = _t(q, k, v, grad=True)
    with bwd_route_forced(route):
        inside = flash_attention(tq, tk, tv, **kw)
    outside = flash_attention(tq, tk, tv, **kw)
    torch.autograd.grad(inside, (tq, tk, tv), torch.tensor(dout))
    torch.autograd.grad(outside, (tq, tk, tv), torch.tensor(dout))
    assert asked == [route, None]
    with pytest.raises(ValueError, match="route"):
        with bwd_route_forced("tensor"):
            pass
    assert flash_kernel._forced_bwd_route is None


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
    assert BWD_ROUTES == ("simt", "wgmma")
    flash_attention_bwd.launches = 3
    flash_attention_bwd.route_launches["simt"] = 1
    flash_attention_bwd.route_launches["wgmma"] = 2
    kernels.reset_launches()
    assert kernels.launch_counts()["flash_attention_bwd"] == 0
    assert flash_attention_bwd.route_launches == {"simt": 0, "wgmma": 0}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_lse_matches_jax_logsumexp_of_the_masked_logits(case):
    """flash_attention_lse_ref against jax.nn.logsumexp of attend's masked
    f32 logits (its own einsum, softcap and mask), atol 1e-5.  attend masks
    with -2**30, so a row that sees no key has -2**30 + log T there; the
    plain lse gives it -inf (its P is 0 on every key either way)."""
    q, k, v, _, keyless, kw = _inputs(case, seed=5)
    b, s, t, h, kh, d, _ = CASES[case]
    causal = kw.get("causal", True)
    qp, kp = jnp.arange(s) + (t - s), jnp.arange(t)
    logits = jnp.einsum("bskgd,btkd->bkgst", jnp.asarray(q).reshape(b, s, kh, h // kh, d),
                        jnp.asarray(k), preferred_element_type=jnp.float32)
    logits = jax_softcap(logits * (1.0 / math.sqrt(d)), kw.get("softcap"))
    mask = jnp.ones((s, t), bool)
    if causal:
        mask &= kp[None, :] <= qp[:, None]
    if kw.get("window"):
        mask &= qp[:, None] - kp[None, :] < kw["window"]
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, logits, NEG), axis=-1)).reshape(b, h, s)
    got = flash_attention_lse_ref(*_t(q, k), **kw).numpy()
    assert got.shape == (b, h, s) and got.dtype == np.float32
    np.testing.assert_allclose(got[..., keyless:], want[..., keyless:], atol=1e-5, rtol=1e-5)
    assert np.all(got[..., :keyless] == -np.inf)


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_ref_given_lse_matches_the_recomputed_one(case):
    """The plain backward given the plain lse equals the one that recomputes
    it (f32, atol 1e-5); through the autograd Function on the CPU, which
    saves that lse, it is the bit-identical gradient."""
    q, k, v, dout, _, kw = _inputs(case, seed=6)
    out = flash_attention_ref(*_t(q, k, v), **kw)
    lse = flash_attention_lse_ref(*_t(q, k), **kw)
    got = flash_attention_bwd_ref(*_t(q, k, v), out, torch.tensor(dout), lse=lse, **kw)
    want = flash_attention_bwd_ref(*_t(q, k, v), out, torch.tensor(dout), **kw)
    _close([x.numpy() for x in got], [x.numpy() for x in want], case)
    wrapped = flash_attention_bwd(*_t(q, k, v), out, torch.tensor(dout), lse=lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_bwd_ref_at_the_references_own_bf16_accuracy(case):
    """The bf16 plain backward (P and dS rounded to bf16, the kernel's
    points), after the plain bf16 forward, against jax.vjp of attend in
    bf16: the rms distance of each of dq, dk, dv to jax.vjp on f32 copies is
    at most twice JAX's own.  Elementwise bounds do not hold between two
    bf16 renderings that round at other points (ROADMAP T11)."""
    q, k, v, dout, keyless, kw = _inputs(case, seed=7)
    dout[:, :keyless] = 0.0
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    q, k, v, dout = (bf(x) for x in (q, k, v, dout))  # both sides see the same bf16 values
    f = _attend(case)
    _, vjp32 = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    exact = [np.asarray(x) for x in vjp32(jnp.asarray(dout))]
    _, vjp16 = jax.vjp(f, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    ref = [np.asarray(x.astype(jnp.float32)) for x in vjp16(jnp.asarray(dout, jnp.bfloat16))]
    tq, tk, tv, tdo = (torch.tensor(x).bfloat16() for x in (q, k, v, dout))
    out = flash_attention_ref(tq, tk, tv, **kw)
    got = [x.float().numpy() for x in flash_attention_bwd_ref(tq, tk, tv, out, tdo, **kw)]
    rms = lambda a, b: float(np.sqrt(np.mean((a - b) ** 2)))
    for name, g, r, e in zip(("dq", "dk", "dv"), got, ref, exact):
        assert rms(g, e) <= 2 * rms(r, e), (name, rms(g, e), rms(r, e))


def _resummed_bf16_bwd(q, k, v, out, dout, causal=True, softcap=None, window=0):
    """A bf16 backward with the plain version's rounding points (P to bf16
    before dV, dS before dQ and dK) whose Q K^T and dO V^T are f32 sums taken
    in another order: k-steps of 16 of the head dim added one after another,
    as the kernel's wgmma k-steps are."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    qd = q.reshape(b, s, kh, g, d).float()
    do = dout.reshape(b, s, kh, g, d).float()

    def stepped(a, w):
        return sum(torch.einsum("bskgd,btkd->bkgst", a[..., i:i + 16], w[..., i:i + 16])
                   for i in range(0, d, 16))

    x = stepped(qd, k.float()) * scale
    th = torch.tanh(x / softcap) if softcap else None
    c = th * softcap if softcap else x
    mask = visible(s, t, causal, window, q.device)
    lse = torch.logsumexp(c.masked_fill(~mask, -math.inf), -1, keepdim=True)
    p = torch.where(mask, torch.exp(c - lse), 0.0)
    delta = (do * out.reshape(b, s, kh, g, d).float()).sum(-1).permute(0, 2, 3, 1)[..., None]
    dp = stepped(do, v.float())
    ds = p * (dp - delta) * ((1.0 - th * th) if softcap else 1.0)
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qd) * scale
    return dq.reshape(b, s, h, d).bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("case", [*CASES, "long"])
def test_step_room_covers_a_rendering_summed_in_another_order(case):
    """The bound the card checks hold the ``wgmma`` route to, against the
    plain bf16 version on the same inputs: 1e-3 + 2**-7 of each value, plus
    ``flash_attention_bwd_step_ref``'s one bf16 step of each row's largest
    rounded term.  A rendering that rounds P and dS at the same points from
    f32 sums taken in another order (``_resummed_bf16_bwd``) stays inside
    it, though it rounds some P and dS to the neighbouring bf16 value; at
    yi's heads it needs the room (some element passes the bound without
    it); f32 inputs get no room."""
    if case == "long":  # yi's heads at S = T = 300: some rows pass 2**-7 of their value
        q, k, v, dout = (torch.randn(shape, generator=torch.Generator().manual_seed(11))
                         for shape in ((1, 300, 32, 128), (1, 300, 4, 128), (1, 300, 4, 128),
                                       (1, 300, 32, 128)))
        keyless, kw = 0, {}
    else:
        q, k, v, dout, keyless, kw = (torch.tensor(x) if isinstance(x, np.ndarray) else x
                                      for x in _inputs(case, seed=8))
    dout[:, :keyless] = 0.0
    q, k, v, dout = (x.bfloat16() for x in (q, k, v, dout))
    out = flash_attention_ref(q, k, v, **kw)
    want = flash_attention_bwd_ref(q, k, v, out, dout, **kw)
    got = _resummed_bf16_bwd(q, k, v, out, dout, **kw)
    steps = flash_attention_bwd_step_ref(q, k, v, out, dout, **kw)
    bare = []
    for name, g, w, step in zip(("dq", "dk", "dv"), got, want, steps):
        g, w = g.float(), w.float()
        assert bool(((g - w).abs() <= 1e-3 + 2**-7 * w.abs() + step).all()), name
        bare.append(bool(((g - w).abs() > 1e-3 + 2**-7 * w.abs()).any()))
    if case == "long":
        assert any(bare), "no element needs the step's room"
    zero = flash_attention_bwd_step_ref(*(x.float() for x in (q, k, v, out, dout)), **kw)
    assert all(bool((z == 0).all()) for z in zero)
