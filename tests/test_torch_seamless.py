"""seamless-m4t-medium, the encoder-decoder family, against the JAX package
on the CPU.

The smoke config (2 encoder and 2 decoder layers, d_model 64, 4 heads of
16, f32) with the JAX package's weights (seed 0) carried by
``from_jax_params``; its norm gains, which the JAX factory starts at 0, are
redrawn N(0, 0.3) in both packages so that a mixed-up norm shows.  The
audio frontend is a stub in both: ``make_batch`` draws ``max(S // 4, 16)``
frames, the encoder's input.

- Configs, logical axes, the weights' round trip and ``make_batch``.
- ``encode``, ``forward``, ``make_prefill_step`` and 4 ``make_serve_step``
  steps (logits and every cache leaf) at ``attn_chunk`` 0 and at 16 with S
  = 64, where JAX takes ``attend_chunked`` in the encoder, the decoder and
  cross-attention (atol 1e-5: f32 sums in other orders).
- Two reference behaviours the port keeps (ROADMAP.md section 3): JAX's
  ``ServeScheduler`` runs no encoder, so every request decodes over an
  all-zero cross cache; JAX's ``TrainDriver`` fails at its first step
  (its pipeline makes no frames), and the port's refuses before it.
- ``launch.serve`` prints JAX's keys and JAX's tokens; one train step
  within ``tests/test_torch_train.py``'s ``TOL``; the sharded forwards
  refuse the family; non-causal flash at S > T against ``attend``.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_seamless.py``.
"""

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import encdec as jencdec
from repro.models import zoo as jzoo
from repro.models.attention import attend
from repro.runtime.serving import ServeScheduler as JaxScheduler
from repro_torch.checkpoint import restore_state, save_state
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd_ref, flash_attention_ref,
)
from repro_torch.models import encdec, zoo
from repro_torch.runtime import ServeScheduler, TrainDriver
from test_torch_lm import JAX_SERVE_KEYS
from test_torch_train import train_step_matches_jax

ARCH = "seamless-m4t-medium"
ATOL = 1e-5
NORMS = ("ln1", "ln2", "lnx", "final_ln")


@pytest.fixture(autouse=True)
def one_thread():
    """The port's calls on one intra-op thread: the smoke tensors are small,
    and a pool of threads beside the other test processes of a parallel
    run slows each small op many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(**change):
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype=jnp.float32, **change)
    return jcfg, get_config(ARCH, smoke=True).replace(dtype=torch.float32, **change)


@functools.cache
def _flat() -> dict[str, np.ndarray]:
    """The JAX factory's weights (seed 0), the norm gains redrawn."""
    jcfg, _ = _configs()
    jp, _ = jzoo.build_params(jcfg, 0)
    rng = np.random.default_rng(1)
    flat = {k: np.array(v, np.float32) for k, v in jp.items()}
    for k in sorted(flat):
        if k.rsplit(".", 1)[-1] in NORMS:
            flat[k] = rng.normal(0, 0.3, flat[k].shape).astype(np.float32)
    return flat


def _models(**change):
    """``(jcfg, jax params, cfg, port model)``, a fresh port model each call."""
    jcfg, cfg = _configs(**change)
    flat = _flat()
    return jcfg, {k: jnp.asarray(v) for k, v in flat.items()}, cfg, \
        zoo.from_jax_params(cfg, flat, device="cpu")


def _both(jbatch) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}


CHUNKS = pytest.mark.parametrize("chunk", [0, 16], ids=["whole", "attn_chunk16"])


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_and_axes_equal_jax(smoke):
    """Field for field, and every leaf's shape and logical axes (the
    ``enc.*`` stack over ``enc_layers``, ``enc.final_ln`` unstacked, the
    decoder's ``lnx`` and ``*_x`` leaves) as JAX's ``build_params``."""
    mine, theirs = get_config(ARCH, smoke=smoke), jax_get_config(ARCH, smoke=smoke)
    for field in theirs.__dataclass_fields__:
        if field != "dtype":
            assert getattr(mine, field) == getattr(theirs, field), field
    assert mine.dtype == torch.bfloat16 and theirs.dtype == jnp.bfloat16
    shapes, axes = zoo.logical_axes(mine)
    jshapes, jaxes = jzoo.build_params(theirs, abstract=True)
    assert shapes == {k: tuple(v.shape) for k, v in jshapes.items()}
    assert axes == dict(jaxes)
    assert shapes["enc.wq"][0] == mine.enc_layers and shapes["enc.final_ln"] == (mine.d_model,)
    if not smoke:  # about 0.88 B weights, the padded vocab's table and head included
        assert round(sum(int(np.prod(s)) for s in shapes.values()) / 1e9, 2) == 0.88


def test_weights_round_trip_bit_for_bit():
    """``from_jax_params`` then ``to_jax_params``: every leaf back as it was."""
    _, cfg = _configs()
    flat = _flat()
    back = zoo.to_jax_params(cfg, zoo.from_jax_params(cfg, flat, device="cpu"))
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert np.array_equal(back[k].numpy(), v), k


def test_checkpoint_round_trips_the_new_leaves(tmp_path):
    """The port's checkpoint of the weights holds the ``enc.*`` and ``*_x``
    leaves under their JAX names: it restores bit for bit in the port and,
    with ``repro.checkpoint.restore_state``, into the JAX weights' tree."""
    from repro.checkpoint import restore_state as jax_restore_state

    jcfg, cfg = _configs()
    tree = {"params": zoo.to_jax_params(cfg, zoo.from_jax_params(cfg, _flat(), device="cpu")),
            "step": 3}
    save_state(tmp_path, tree, step=3)
    mine, step = restore_state(tmp_path, tree)
    like = {"params": jax.eval_shape(lambda: jzoo.build_params(jcfg, 0)[0]), "step": 0}
    theirs, jstep = jax_restore_state(tmp_path, like)
    assert step == jstep == 3 and {"enc.wq", "enc.final_ln", "blocks.lnx",
                                   "blocks.wk_x"} <= set(mine["params"])
    assert set(theirs["params"]) == set(tree["params"])
    for k, v in tree["params"].items():
        assert torch.equal(mine["params"][k], v), k
        assert np.array_equal(np.asarray(theirs["params"][k]), v.numpy()), k


@pytest.mark.parametrize("kind,seq", [("prefill", 24), ("train", 32), ("train", 128)])
def test_make_batch_equals_jax(kind, seq):
    """The same numpy draws in the same order: tokens, labels, the mask (0
    on the first max(S / 4, 16) positions) and the frames."""
    jcfg, cfg = _configs()
    want = jzoo.make_batch(jcfg, jzoo.ShapeSpec("b", seq, 2, kind), 7)
    got = zoo.make_batch(cfg, zoo.ShapeSpec("b", seq, 2, kind), 7, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
    fl = zoo.frontend_len(cfg, seq)
    assert fl == jzoo.frontend_len(jcfg, seq) == max(seq // 4, 16)
    assert got["frames"].shape == (2, fl, cfg.d_model)


# -------------------------------------------------------- forward and serving
@CHUNKS
def test_encode_matches_jax(chunk):
    """The encoder's states (the final norm included) against JAX's
    ``encode`` over 64 frames, atol 1e-5."""
    jcfg, jp, cfg, model = _models(attn_chunk=chunk)
    frames = np.random.default_rng(2).normal(0, 0.02, (2, 64, cfg.d_model)).astype(np.float32)
    want = jencdec.encode(jcfg, jp, jnp.asarray(frames))
    got = encdec.encode(cfg, model.enc, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@CHUNKS
def test_forward_matches_jax(chunk):
    """``forward``'s logits of a prefill-kind batch (64 tokens, 16 frames)
    against JAX's, atol 1e-5; the frames reach the logits."""
    jcfg, jp, cfg, model = _models(attn_chunk=chunk)
    jbatch = jzoo.make_batch(jcfg, jzoo.ShapeSpec("p", 64, 2, "prefill"), 3)
    want, _, _ = jzoo.forward(jcfg, jp, jbatch)
    batch = _both(jbatch)
    got, _, _ = zoo.forward(cfg, model, batch)
    assert got.shape == (2, 64, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    other, _, _ = zoo.forward(cfg, model, {**batch, "frames": 2 * batch["frames"]})
    assert not torch.allclose(other, got, atol=1e-3)


@CHUNKS
def test_prefill_and_decode_match_jax(chunk):
    """``make_prefill_step`` against JAX's (the last logits and every cache
    leaf: ``k``, ``v``, ``xk``, ``xv``); then a session cache of 68 (the
    prompt written from offset 0, as both launchers prefill) and 4
    ``make_serve_step`` steps reading the cached cross K/V: each step's
    logits and the caches after, atol 1e-5."""
    jcfg, jp, cfg, model = _models(attn_chunk=chunk)
    b, p, gen = 2, 64, 4
    jbatch = jzoo.make_batch(jcfg, jzoo.ShapeSpec("p", p, b, "prefill"), 4)
    batch = _both(jbatch)
    want, jc = jax.jit(jzoo.make_prefill_step(jcfg))(jp, jbatch)
    got, tc = zoo.make_prefill_step(cfg)(model, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert set(tc) == set(jc) == {"k", "v", "xk", "xv"}
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=ATOL, err_msg=k)
    fl = zoo.frontend_len(cfg, p)
    jc = jzoo.init_kv_cache(jcfg, b, p + gen, enc_len=fl, dtype=jnp.float32)
    want, jc, _ = jzoo.forward(jcfg, jp, jbatch, caches=jc, offset=jnp.int32(0))
    got, tc = zoo.make_prefill_step(cfg, t_max=p + gen)(model, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[:, -1]), atol=ATOL)
    fed = np.random.default_rng(5).integers(0, cfg.vocab, (b, gen)).astype(np.int32)
    jstep, tstep = jax.jit(jzoo.make_serve_step(jcfg)), zoo.make_serve_step(cfg)
    for i in range(gen):
        tok = fed[:, i : i + 1]
        want, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(p + i))
        got, tc = tstep(model, tc, torch.from_numpy(tok), p + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=f"step {i}")
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=ATOL, err_msg=k)
    assert float(tc["xk"].abs().max()) > 0


def test_prefill_without_frames_raises_in_both_packages():
    jcfg, jp, cfg, model = _models()
    jbatch = {"tokens": jzoo.make_batch(jcfg, jzoo.ShapeSpec("p", 16, 1, "prefill"), 0)[
        "tokens"]}
    with pytest.raises(ValueError, match="frames"):
        jzoo.make_prefill_step(jcfg)(jp, jbatch)
    with pytest.raises(ValueError, match="frames"):
        zoo.make_prefill_step(cfg)(model, _both(jbatch))
    with pytest.raises(ValueError, match="xk/xv"):  # no frames and no cache to read them from
        zoo.forward(cfg, model, _both(jbatch))


def test_scheduler_streams_equal_jax_over_a_zero_cross_cache():
    """Behaviour (a): JAX's scheduler prefills tokens only and never runs
    the encoder, so every request decodes over a cross cache of
    ``frontend_len(cfg, t_max)`` zero frames.  3 requests on 2 slots: the
    streams equal, the cross cache all zeros in both."""
    jcfg, jp, cfg, model = _models()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (7, 12, 5)]
    out = []
    for cls, c, params in ((JaxScheduler, jcfg, jp), (ServeScheduler, cfg, model)):
        sched = cls(c, params, slots=2, t_max=64)
        for i, p in enumerate(prompts):
            sched.submit(p, max_new=4 + i)
        out.append(({r.rid: r.out for r in sched.run()}, sched.cache))
    (want, jcache), (got, tcache) = out
    assert got == want and sorted(got) == [0, 1, 2]
    assert tcache["xk"].shape[2] == jcache["xk"].shape[2] == zoo.frontend_len(cfg, 64)
    for k in ("xk", "xv"):
        assert float(np.abs(np.asarray(jcache[k])).max()) == 0.0
        assert float(tcache[k].abs().max()) == 0.0


def test_launch_serve_prints_jax_keys_and_tokens(monkeypatch, capsys):
    """``launch.serve --arch seamless-m4t-medium`` (smoke, f32) in both
    packages from the same weights: the same JSON keys and ``sample_ids``
    (make_batch's frames handed to the prefill, tokens only after)."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve

    jcfg, cfg = _configs()
    argv = ["--arch", ARCH, "--batch", "2", "--prompt-len", "32", "--gen", "6", "--seed", "0"]
    monkeypatch.setattr("repro.configs.get_config", lambda arch, smoke=True: jcfg)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jax_serve.main()
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    seen, real = [], serve.make_prefill_step

    def spy(c, **kw):
        step = real(c, **kw)

        def prefill(model, batch):
            seen.append({k: tuple(v.shape) for k, v in batch.items()})
            return step(model, batch)
        return prefill

    monkeypatch.setattr(serve, "get_config", lambda arch, smoke=True: cfg)
    monkeypatch.setattr(serve, "build_params", lambda c, seed, device: zoo.from_jax_params(
        c, {k: np.asarray(v, np.float32) for k, v in jzoo.build_params(jcfg, seed)[0].items()},
        device))
    monkeypatch.setattr(serve, "make_prefill_step", spy)
    rec, toks = serve.serve([*argv, "--device", "cpu"])
    assert set(rec) == set(theirs) == JAX_SERVE_KEYS
    assert rec["sample_ids"] == theirs["sample_ids"] and toks.shape == (2, 6)
    assert seen == [{"tokens": (2, 32), "frames": (2, 16, cfg.d_model)}]


def test_launch_serve_layers_cut_both_stacks():
    from repro_torch.launch.serve import serve

    rec, toks = serve(["--arch", ARCH, "--device", "cpu", "--layers", "1", "--batch", "1",
                       "--prompt-len", "16", "--gen", "2"])
    assert (rec["layers"], rec["enc_layers"]) == (1, 1) and toks.shape == (1, 2)


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_train_step_matches_jax(remat):
    """One step at 2 microbatches (the frames cut with the rest of the
    batch), S = 2 x LOSS_CHUNK, with the port's remat off and on: the loss,
    every gradient and the AdamW update within ``tests/test_torch_train.py``'s
    ``TOL`` of one JAX step without remat, which both cases share (remat
    recomputes the same JAX forward)."""
    train_step_matches_jax(remat, 2, ARCH, jax_remat=False)


def test_remat_gives_the_same_gradients():
    """Checkpointed encoder and decoder blocks recompute the same forward on
    the CPU: the gradients are bit-identical with remat on and off."""
    _, cfg = _configs()
    batch = zoo.make_batch(cfg, zoo.ShapeSpec("t", 64, 2, "train"), 1, device="cpu")
    out = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        model = zoo.from_jax_params(c, _flat(), device="cpu")
        params = zoo.model_params(model)
        for p in params.values():
            p.requires_grad_(True)
        loss, _ = zoo.loss_fn(c, model, batch)
        out.append(torch.autograd.grad(loss, list(params.values())))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_drivers_cannot_train_it(tmp_path, monkeypatch):
    """Behaviour (b): the token pipeline makes no frames.  JAX's driver
    fails at its first step (its decoder finds no cross K/V); the port's
    driver and ``launch.train`` refuse before any step, saying why."""
    from repro.data import DataConfig as JaxDataConfig
    from repro.runtime.driver import TrainDriver as JaxDriver
    from repro_torch.launch.train import train

    jcfg, cfg = _configs()
    data = dict(seq_len=32, global_batch=2)
    with pytest.raises(AssertionError, match="xk/xv"):
        JaxDriver(jcfg, tmp_path / "jax", data=JaxDataConfig(vocab=jcfg.vocab, **data)).run(1)
    with pytest.raises(NotImplementedError, match="no audio frames"):
        TrainDriver(cfg, tmp_path / "port", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # refused before a mesh
    with pytest.raises(NotImplementedError, match="no audio frames"):
        train(["--arch", ARCH, "--device", "cpu", "--mesh", "host", "--steps", "1",
               "--ckpt-dir", str(tmp_path / "cli")])
    assert not (tmp_path / "port").exists() and not (tmp_path / "cli").exists()


def test_sharded_forwards_refuse_it():
    """A mesh's forward, loss and serving cache refuse the encoder-decoder,
    naming ROADMAP.md, before any collective."""
    _, cfg = _configs()
    batch = zoo.make_batch(cfg, zoo.ShapeSpec("t", 64, 2, "train"), 0, device="cpu")
    calls = [lambda: zoo._forward_tp(cfg, None, batch, None, False),
             lambda: zoo._forward_serve(cfg, None, batch, None, None, 0, None, False),
             lambda: zoo._forward_tp(cfg.replace(frontend=None), None, batch, None, False),
             lambda: zoo.init_kv_cache(cfg, 2, 8, device="cpu", mesh=object())]
    for call in calls:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def test_mismatched_families_are_refused():
    """Encoder layers outside the encdec family, the family without them,
    and the audio frontend on a decoder-only model: the port refuses each."""
    yi = get_config("yi-9b", smoke=True)
    _, cfg = _configs()
    for bad in (yi.replace(enc_layers=2), cfg.replace(enc_layers=0), yi.replace(frontend="audio")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            zoo.build_params(bad, device="cpu")


# ------------------------------------------------------ non-causal flash
@pytest.mark.parametrize("s,t", [(64, 16), (33, 33), (1, 16), (100, 7)],
                         ids=["cross", "encoder", "decode_cross", "ragged_cross"])
def test_non_causal_flash_matches_jax_attend_and_its_vjp(s, t):
    """The plain flash forward at seamless's calls (MHA heads, no mask)
    against JAX's ``attend`` (causal off), its backward against ``jax.vjp``
    of it, and the autograd ``Function`` on the CPU against the plain
    backward; f32 within 1e-5."""
    rng = np.random.default_rng(s * 100 + t)
    b, h, d = 2, 4, 16
    q, dout = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(2))

    def f(q, k, v):
        return attend(q, k, v, q_pos=jnp.arange(s), k_pos=jnp.arange(t), causal=False,
                      window=None, cap=None)
    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    got = flash_attention_ref(tq, tk, tv, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    grads = flash_attention_bwd_ref(tq, tk, tv, got, torch.tensor(dout), causal=False)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)
    aq, ak, av = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    fn_out = flash_attention(aq, ak, av, causal=False)
    fn_grads = torch.autograd.grad(fn_out, (aq, ak, av), torch.tensor(dout))
    assert torch.equal(fn_out, got)
    for g, w in zip(fn_grads, grads):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
