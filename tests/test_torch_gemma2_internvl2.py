"""gemma2-2b and internvl2-26b against the JAX package on the CPU, and the
plain flash attention at gemma2's head dim of 256.

gemma2 alternates local layers (a 4,096-token window; 16 in its smoke
config) with global ones, softcaps the attention logits (50) and the final
ones (30), ties its embedding table to the head and scales the embeddings
by sqrt(d_model).  internvl2 is a dense GQA model with a stub patch
frontend: ``make_batch`` draws ``min(256, seq_len // 4)`` patch
embeddings after the tokens (and the labels), which overwrite the first
positions and carry no loss.  Weights come from the JAX package's factory
(seed 0), in f32.

- Configs: ``get_config`` full and smoke equal JAX's field for field;
  seamless-m4t resolves (``tests/test_torch_seamless.py`` holds it to JAX),
  an unknown arch raises ``KeyError``; the sharded forwards refuse a
  frontend rather than drop it.
- Smoke configs in f32: ``make_batch`` (tokens, labels, the loss mask,
  the patches) equal to JAX's; ``forward``'s logits (within 1e-4), a prompt
  prefilled into a session cache then 8 teacher-forced ``make_serve_step``
  steps (each step's logits, then the caches), one ``make_train_step``
  step (the loss within 1e-5 relative, every gradient within 1e-4 of its
  leaf's largest, every weight, m and v after the step within
  ``chip_smoke.train_step_bound``), the tied table's round trip through
  ``to_jax_params``/``from_jax_params`` and the chunked loss over it.
- The plain flash forward and backward at d = 256 (``flash_attention_ref``,
  ``flash_attention_bwd_ref``, the autograd ``Function`` on the CPU)
  against JAX's ``attend`` and its vjp at S = T = 64: causal, windowed and
  softcapped (atol 1e-5).

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_gemma2_internvl2.py``.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import zoo as jzoo
from repro.models.attention import attend
from repro.models.transformer import layer_windows as jax_layer_windows
from repro.optim import AdamW as JaxAdamW
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd_ref, flash_attention_ref,
)
from repro_torch.models import zoo
from repro_torch.models.transformer import layer_windows
from repro_torch.optim import AdamW

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("gemma2-2b", "internvl2-26b")
LR, BATCH_SEED = 1e-3, 7
ATOL, LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-5, 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """Each test's port calls on one intra-op thread: the smoke tensors are
    small, and a pool of threads beside the other test processes of a
    parallel run slows each small op many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch):
    jcfg = jax_get_config(arch, smoke=True).replace(dtype=jnp.float32)
    return jcfg, get_config(arch, smoke=True).replace(dtype=torch.float32)


@functools.cache
def _flat(arch) -> dict[str, np.ndarray]:
    jcfg, _ = _configs(arch)
    jp, _ = jzoo.build_params(jcfg, 0)
    return {k: np.array(v, np.float32) for k, v in jp.items()}


@pytest.fixture(params=ARCHS)
def arch_f32(request):
    """``(arch, jcfg, jax params, cfg, port model)`` in f32 (a fresh port
    model each test: the train step writes its weights in place)."""
    arch = request.param
    jcfg, cfg = _configs(arch)
    flat = _flat(arch)
    return arch, jcfg, {k: jnp.asarray(v) for k, v in flat.items()}, cfg, \
        zoo.from_jax_params(cfg, flat, device="cpu")


def _both(jbatch) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch, smoke):
    mine, theirs = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
    for field in theirs.__dataclass_fields__:
        if field != "dtype":
            assert getattr(mine, field) == getattr(theirs, field), field
    assert mine.dtype == torch.bfloat16 and theirs.dtype == jnp.bfloat16
    assert (mine.vocab_padded, mine.qkv_dim, mine.kv_dim) == (
        theirs.vocab_padded, theirs.qkv_dim, theirs.kv_dim)
    shapes, _ = zoo.logical_axes(mine)
    jshapes, _ = jzoo.build_params(theirs, abstract=True)
    assert shapes == {k: tuple(v.shape) for k, v in jshapes.items()}
    assert np.array_equal(layer_windows(mine), np.asarray(jax_layer_windows(theirs)))
    if not smoke:  # the size the configs are named for, the vocab padded
        n = sum(int(np.prod(s)) for s in shapes.values())
        assert round(n / 1e9, 2) == {"gemma2-2b": 2.61, "internvl2-26b": 19.88}[arch]


def test_gemma2_layers_alternate_and_the_head_is_tied():
    cfg = get_config("gemma2-2b")
    assert layer_windows(cfg).tolist() == [4096, 0] * 13  # even layers local
    assert cfg.tie_embeddings and cfg.embed_mult == 48.0
    assert (cfg.attn_softcap, cfg.final_softcap, cfg.head_dim) == (50.0, 30.0, 256)
    shapes, _ = zoo.logical_axes(cfg)
    assert "head.w" not in shapes and shapes["embed.tok"] == (256_000, 2304)


@pytest.mark.parametrize("arch", ["nope"])
def test_seamless_still_raises(arch):
    """An arch that no registry holds raises ``KeyError``."""
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config(arch)


def test_seamless_resolves():
    """seamless-m4t-medium, the last of the JAX registry's archs, resolves:
    the encoder-decoder family with its audio frontend."""
    cfg = get_config("seamless-m4t-medium")
    assert (cfg.family, cfg.frontend, cfg.n_layers, cfg.enc_layers) == ("encdec", "audio", 12, 12)


def test_sharded_forwards_refuse_a_frontend():
    """A frontend on a mesh raises, naming ROADMAP.md, before any
    collective: the patches are not dropped silently."""
    cfg = get_config("internvl2-26b", smoke=True).replace(dtype=torch.float32)
    batch = zoo.make_batch(cfg, zoo.ShapeSpec("p", 16, 2, "prefill"), 0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        zoo._forward_tp(cfg, None, batch, None, False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        zoo._forward_serve(cfg, None, batch, None, None, 0, None, False)


# -------------------------------------------------------------------- batches
@pytest.mark.parametrize("kind,seq", [("prefill", 24), ("train", 32), ("train", 2048)])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_equals_jax(arch, kind, seq):
    """The same numpy draws in the same order: tokens, labels, the mask (0
    on internvl2's min(256, S / 4) patch positions) and the patches."""
    jcfg, cfg = _configs(arch)
    want = jzoo.make_batch(jcfg, jzoo.ShapeSpec("b", seq, 2, kind), BATCH_SEED)
    got = zoo.make_batch(cfg, zoo.ShapeSpec("b", seq, 2, kind), BATCH_SEED, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(np.array(v)).dtype, k
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    fl = zoo.frontend_len(cfg, seq)
    assert fl == jzoo.frontend_len(jcfg, seq) == (min(256, seq // 4) if arch != "gemma2-2b"
                                                  else 0)
    if kind == "train":
        mask = got["mask"]
        assert float(mask[:, :fl].abs().sum()) == 0 and bool((mask[:, fl:] == 1).all())
    if fl:
        assert got["patch_embeds"].shape == (2, fl, cfg.d_model)


# -------------------------------------------------------- forward and serving
def test_forward_matches_jax(arch_f32):
    """A prefill-kind batch (internvl2's with its patches) through both
    forwards; the patches reach the logits."""
    arch, jcfg, jp, cfg, model = arch_f32
    jbatch = jzoo.make_batch(jcfg, jzoo.ShapeSpec("p", 24, 2, "prefill"), 3)
    want, _, _ = jzoo.forward(jcfg, jp, jbatch)
    got, _, _ = zoo.forward(cfg, model, _both(jbatch))
    assert got.shape == (2, 24, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if "patch_embeds" in jbatch:
        bare, _, _ = zoo.forward(cfg, model, {"tokens": _both(jbatch)["tokens"]})
        assert not torch.allclose(bare[:, :6], got[:, :6], atol=1e-3)


def test_prefill_and_decode_match_jax(arch_f32):
    """A prompt prefilled into a session cache, then 8 teacher-forced
    decode steps (gemma2's local layer's 16-token window bites from step 3
    on): every step's logits, and the caches after."""
    _, jcfg, jp, cfg, model = arch_f32
    b, p, gen, t_max = 2, 13, 8, 24
    jbatch = jzoo.make_batch(jcfg, jzoo.ShapeSpec("p", p, b, "prefill"), 4)
    fed = np.random.default_rng(5).integers(0, cfg.vocab, (b, gen)).astype(np.int32)
    jc = jzoo.init_kv_cache(jcfg, b, t_max, dtype=jnp.float32)
    want, jc, _ = jzoo.forward(jcfg, jp, jbatch, caches=jc, offset=jnp.int32(0))
    tc = zoo.init_kv_cache(cfg, b, t_max, dtype=torch.float32, device="cpu")
    got, tc, _ = zoo.forward(cfg, model, _both(jbatch), caches=tc, offset=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    jstep, tstep = jzoo.make_serve_step(jcfg), zoo.make_serve_step(cfg)
    for i in range(gen):
        tok = fed[:, i : i + 1]
        want, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(p + i))
        got, tc = tstep(model, tc, torch.from_numpy(tok), p + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=f"step {i}")
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-5)


def test_launch_serve_takes_the_patches(monkeypatch):
    """``launch.serve`` on internvl2 smoke at 1 of 2 layers hands its
    prefill make_batch's patches, as JAX's launcher does."""
    from repro_torch.launch import serve

    seen, real = [], serve.make_prefill_step

    def spy(cfg, **kw):
        step = real(cfg, **kw)

        def prefill(model, batch):
            seen.append({k: tuple(v.shape) for k, v in batch.items()})
            return step(model, batch)
        return prefill

    monkeypatch.setattr(serve, "make_prefill_step", spy)
    out, toks = serve.serve(["--arch", "internvl2-26b", "--device", "cpu", "--layers", "1",
                             "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    assert out["layers"] == 1 and toks.shape == (2, 4)
    assert seen == [{"tokens": (2, 16), "patch_embeds": (2, 4, 128)}]


# ---------------------------------------------------------------- training
@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_step_matches_jax(arch_f32):
    """One step (internvl2: two microbatches, with patches and its mask)
    from the same weights and batch: the loss, the gradients and every
    weight, m and v after ``make_train_step`` against the JAX package's."""
    arch, jcfg, jp, cfg, model = arch_f32
    assert cfg.microbatch == jcfg.microbatch == (2 if arch == "internvl2-26b" else 1)
    jbatch = jzoo.make_batch(jcfg, jzoo.ShapeSpec("t", 32, 4, "train"), BATCH_SEED)
    batch = _both(jbatch)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jzoo.loss_fn(jcfg, p, jbatch)[0]))(jp)
    params = zoo.model_params(model)
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = zoo.loss_fn(cfg, model, batch)
    grads = zoo.to_jax_params(cfg, dict(zip(params, torch.autograd.grad(
        loss, list(params.values())))))
    for p in params.values():
        p.requires_grad_(False)
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        want = np.asarray(jgrads[k])
        assert float(np.abs(g.numpy() - want).max()) <= GRAD_RTOL * float(np.abs(want).max()), k
    jopt, opt = JaxAdamW(lr=LR), AdamW(lr=LR)
    jstate = {"params": jp, "opt": jopt.init(jp), "step": jnp.int32(0)}
    jstate, jm = jax.jit(jzoo.make_train_step(jcfg, jopt))(jstate, jbatch)
    state = {"params": model, "opt": opt.init(zoo.model_params(model)), "step": 0}
    state, m = zoo.make_train_step(cfg, opt)(state, batch)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    bound_of = _chip_smoke().train_step_bound
    scale = min(1.0, 1.0 / float(jm["grad_norm"]))
    dscale = abs(min(1.0, 1.0 / float(m["grad_norm"])) - scale)
    got = {"m": zoo.to_jax_params(cfg, state["opt"].m), "v": zoo.to_jax_params(cfg, state["opt"].v),
           "params": zoo.to_jax_params(cfg, model)}
    want = {"m": jstate["opt"].m, "v": jstate["opt"].v, "params": jstate["params"]}
    for k, g in grads.items():
        bounds = bound_of(g, GRAD_RTOL * float(g.abs().max()), scale, dscale, LR)
        for i, kind in enumerate(("m", "v", "params")):
            ref = torch.tensor(np.asarray(want[kind][k])).double()
            lim = bounds[i] + 1e-6 * ref.abs() + (LR * 1e-6 if kind == "params" else 1e-12)
            diff = (got[kind][k].double() - ref).abs()
            assert bool((diff <= lim).all()), (kind, k, float(diff.max()))


def test_tied_table_round_trip():
    """gemma2's tied table: no ``head.w`` either way, the flat dict back bit
    for bit."""
    jcfg, cfg = _configs("gemma2-2b")
    flat = _flat("gemma2-2b")
    assert "head.w" not in flat
    back = zoo.to_jax_params(cfg, zoo.from_jax_params(cfg, flat, device="cpu"))
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert np.array_equal(back[k].numpy(), v), k


def test_chunked_loss_over_the_tied_table_matches_jax():
    """gemma2 smoke's head and cross-entropy over 2 x 1,024 positions in
    LOSS_CHUNK pieces (the final softcap, the padded vocab masked), with a
    mask: the loss and its gradients for the hidden state and the table."""
    jcfg, cfg = _configs("gemma2-2b")
    assert zoo.LOSS_CHUNK == jzoo.LOSS_CHUNK == 512
    flat = _flat("gemma2-2b")
    rng = np.random.default_rng(9)
    h = rng.standard_normal((2, 1024, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, 1024)).astype(np.int32)
    mask = (rng.random((2, 1024)) > 0.2).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in flat.items()}

    def jloss(h, tok):
        return jzoo._chunked_xent(jcfg, {**jp, "embed.tok": tok}, h, jnp.asarray(labels),
                                  jnp.asarray(mask))
    want, (dh_want, dt_want) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jp["embed.tok"])
    model = zoo.from_jax_params(cfg, flat, device="cpu")
    th = torch.tensor(h, requires_grad=True)
    model.embed.tok.requires_grad_(True)
    got = zoo._chunked_xent(cfg, model, th, torch.from_numpy(labels), torch.from_numpy(mask))
    dh, dt = torch.autograd.grad(got, [th, model.embed.tok])
    assert abs(got.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    for g, w in ((dh, dh_want), (dt, dt_want)):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= GRAD_RTOL * float(np.abs(w).max())


# ----------------------------------------------------- flash at head dim 256
FLASH_CASES = {
    # name: (b, h, kh, window, softcap)
    "causal": (2, 8, 4, 0, None),
    "window": (1, 8, 4, 24, None),
    "softcap": (1, 8, 4, 0, 50.0),
    "window_softcap": (2, 4, 2, 16, 30.0),
}
S = T = 64
D = 256


def _flash_inputs(case, seed):
    b, h, kh, window, cap = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal(shape).astype(np.float32) for shape in
                     ((b, S, h, D), (b, T, kh, D), (b, T, kh, D), (b, S, h, D)))
    return q, k, v, dout, dict(window=window, softcap=cap)


def _attend(window, cap):
    def f(q, k, v):
        return attend(q, k, v, q_pos=jnp.arange(S), k_pos=jnp.arange(T), causal=True,
                      window=window or None, cap=cap)
    return f


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_plain_flash_d256_matches_jax_attend_and_its_vjp(case):
    """At gemma2's head dim: the plain forward against ``attend``, the plain
    backward (given the forward's output) against ``jax.vjp`` of it, and the
    autograd ``Function`` (the wrapper with grad on, on the CPU) against
    the plain backward, all in f32 within 1e-5."""
    q, k, v, dout, kw = _flash_inputs(case, seed=21)
    out, vjp = jax.vjp(_attend(kw["window"], kw["softcap"]), *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    got = flash_attention_ref(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    grads = flash_attention_bwd_ref(tq, tk, tv, got, torch.tensor(dout), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)
    aq, ak, av = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    fn_out = flash_attention(aq, ak, av, **kw)
    fn_grads = torch.autograd.grad(fn_out, (aq, ak, av), torch.tensor(dout))
    assert torch.equal(fn_out, got)
    for g, w in zip(fn_grads, grads):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
