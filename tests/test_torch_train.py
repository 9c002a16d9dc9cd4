"""The port's training path against the JAX package, on the CPU: the loss,
AdamW and its schedule, the token pipeline, checkpoints (both directions),
the health monitors, one train step, the fault-tolerant TrainDriver and the
``launch.train`` CLI.  Weights come from the JAX package's factory and go
to the port through ``from_jax_params``; batches from numpy seeds or the
pipeline.  Tolerances are stated with each test: f32 products summed in
other orders differ by ~1e-7 relative, so losses and gradients are held to
atol 1e-5 / rtol 1e-4 and the optimizer's moments to 1e-7."""

import functools
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_state as jax_restore_state
from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import TokenPipeline as JaxPipeline
from repro.data.pipeline import synthetic_corpus as jax_corpus
from repro.models import zoo as jzoo
from repro.models.common import cross_entropy as jax_cross_entropy
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine
from repro.runtime.driver import TrainDriver as JaxDriver
from repro_torch.checkpoint import CheckpointStore, latest_step, leaves, restore_state, save_state
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline, synthetic_corpus
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models import zoo
from repro_torch.models.common import cross_entropy
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime import HeartbeatMonitor, StepTimer, StragglerPolicy, TrainDriver

REPO = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-5, rtol=1e-4)
JAX_TRAIN_KEYS = {"arch", "steps", "restarts", "restored_steps", "first_loss", "last_loss",
                  "step_time_s", "wall_s", "tokens_per_s"}


#: the ported archs' smoke configs.  The JAX side of rwkv6 and hymba runs its
#: exact recurrences (``rwkv_chunk=0``, ``ssm_chunk=0``): its chunked jnp
#: forms clamp the within-chunk log-decay at -60 (ROADMAP.md section 3),
#: which rwkv6 smoke's init passes within a chunk; the port has no clamp.
ARCHS = ("yi-9b", "rwkv6-1.6b", "hymba-1.5b", "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")


@pytest.fixture(autouse=True)
def one_thread():
    """Each test's port calls on one intra-op thread: the smoke tensors are
    small, and a pool of threads beside the other test processes of a
    parallel run slows each small op many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch="yi-9b", **change):
    jcfg = jax_get_config(arch, smoke=True).replace(dtype=jnp.float32, rwkv_chunk=0,
                                                    ssm_chunk=0, **change)
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32, **change)
    return jcfg, cfg


def _weights(jcfg, cfg):
    jp, _ = jzoo.build_params(jcfg, 0)
    flat = {k: np.array(v, np.float32) for k, v in jp.items()}
    return jp, flat, zoo.from_jax_params(cfg, flat, device="cpu")


def _np(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


# -------------------------------------------------------------------- loss
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    """Padded-vocab slots masked, masked positions left out: f32 1e-6."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 96)).astype(np.float32) * 3
    labels = rng.integers(0, 80, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if masked else None
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 80,
                             None if mask is None else jnp.asarray(mask))
    got = cross_entropy(torch.tensor(logits), torch.tensor(labels), 80,
                        None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-6)


def test_chunked_xent_equivalence():
    """The mirror of test_substrate's: a final softcap and a tied head, S =
    2 x LOSS_CHUNK.  Chunked against the whole head in the port (the JAX
    test's rtol 2e-3, here held to 1e-5), against JAX's chunked loss (1e-5),
    and the chunks' checkpointed gradients against the whole head's."""
    jcfg, cfg = _configs(final_softcap=30.0, tie_embeddings=True)
    jp, _, model = _weights(jcfg, cfg)
    jbatch = jzoo.make_batch(jcfg, jzoo.ShapeSpec("t", 2 * jzoo.LOSS_CHUNK, 2, "train"), 3)
    batch = zoo.make_batch(cfg, zoo.ShapeSpec("t", 2 * zoo.LOSS_CHUNK, 2, "train"), 3,
                           device="cpu")
    h, _, _ = zoo.forward(cfg, model, batch, return_hidden=True)
    h = h.detach().requires_grad_()
    chunked = zoo._chunked_xent(cfg, model, h, batch["labels"], batch["mask"])
    plain = cross_entropy(zoo._head(cfg, model, h), batch["labels"], cfg.vocab, batch["mask"])
    np.testing.assert_allclose(chunked.item(), plain.item(), rtol=1e-5)
    jh, _, _ = jzoo.forward(jcfg, jp, jbatch, return_hidden=True)
    want = jzoo._chunked_xent(jcfg, jp, jh, jbatch["labels"], jbatch["mask"])
    np.testing.assert_allclose(chunked.item(), float(want), rtol=1e-5)
    g1 = torch.autograd.grad(chunked, h)[0]
    g2 = torch.autograd.grad(plain, h)[0]
    torch.testing.assert_close(g1, g2, atol=1e-7, rtol=1e-5)


def test_train_batch_equals_jax():
    jcfg, cfg = _configs()
    spec = ("t", 16, 3, "train")
    want = jzoo.make_batch(jcfg, jzoo.ShapeSpec(*spec), 7)
    got = zoo.make_batch(cfg, zoo.ShapeSpec(*spec), 7, device="cpu")
    assert set(got) == set(want) == {"tokens", "labels", "mask"}
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------------------------- optim
NAMES = {"w": (16, 8), "blocks.ln1": (8,), "blocks.bq": (6,), "final_ln": (8,),
         "embed.tok": (12, 8), "blocks.beta_attn": (8,), "head.w": (8, 5)}


@pytest.mark.parametrize("schedule", [False, True], ids=["const_lr", "cosine"])
@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "noclip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(dtype, clip, schedule):
    """Three updates of every leaf (decayed and wd_skip names).  f32: the
    moments and parameters within 1e-7 (the global norm sums in another
    order; pow and cos may differ in the last bit).  bf16 parameters: the
    f32 update is the same, so they round to the same bf16 or its
    neighbour (rtol 2**-7); moments 1e-7."""
    rng = np.random.default_rng(1)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in NAMES.items()}
    grads = [{k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in NAMES.items()}
             for _ in range(3)]
    lr = (lambda f: f(1e-2, 2, 10)) if schedule else (lambda f: 1e-2)
    jopt = JaxAdamW(lr=lr(jax_cosine), clip_norm=clip)
    opt = AdamW(lr=lr(cosine_schedule), clip_norm=clip)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    tp = {k: torch.tensor(v).to(tdt) for k, v in p0.items()}
    js, ts = jopt.init(jp), opt.init(tp)
    for g in grads:
        jp, js, jm = jopt.update({k: jnp.asarray(v, jdt) for k, v in g.items()}, js, jp)
        _, _, tm = opt.update({k: torch.tensor(v).to(tdt) for k, v in g.items()}, ts, tp)
    assert int(ts.count) == int(js.count) == 3
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    ptol = dict(atol=1e-7, rtol=1e-7) if dtype == "float32" else dict(atol=1e-7, rtol=2**-7)
    for k in NAMES:
        np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                                   **ptol, err_msg=k)
        np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]), atol=1e-7, rtol=1e-7)
        np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]), atol=1e-7, rtol=1e-7)


def test_adamw_converges_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, clip_norm=None)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        opt.update({"w": 2 * params["w"]}, state, params)  # d/dw ||w||^2
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_wd_skip_and_clip():
    opt = AdamW(lr=1e-2, weight_decay=1.0, clip_norm=1.0)
    params = {"w": torch.ones(4), "ln_gain": torch.ones(4)}
    state = opt.init(params)
    opt.update({k: torch.zeros(4) for k in params}, state, params)
    # zero grads: only weight decay moves 'w'; 'ln_gain' is exempt
    assert float((params["ln_gain"] - 1).abs().max()) < 1e-6
    assert float(params["w"][0]) < 1.0
    _, _, m = opt.update({k: torch.full((4,), 1e6) for k in params}, state, params)
    assert float(m["grad_norm"]) > 1e6  # reported unclipped


@pytest.mark.parametrize("args", [(1.0, 10, 100, 0.1), (3e-4, 20, 100, 0.1), (1e-3, 0, 50, 0.0)])
def test_cosine_schedule_matches_jax(args):
    want, got = jax_cosine(*args[:3], floor=args[3]), cosine_schedule(*args[:3], floor=args[3])
    for step in range(0, 121, 3):
        np.testing.assert_allclose(float(got(torch.tensor(step, dtype=torch.int32))),
                                   float(want(jnp.int32(step))), atol=1e-7 * args[0], rtol=0)
    assert float(got(torch.tensor(0))) == 0.0 or args[1] == 0


# -------------------------------------------------------------------- data
def _same_batches(mine, theirs, steps):
    for step in steps:
        a, b = mine.batch_at(step), theirs.batch_at(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (step, k)


@pytest.mark.parametrize("shard", [0, 1])
def test_synthetic_batches_equal_jax(shard):
    kw = dict(seq_len=32, global_batch=4, vocab=100, n_shards=2, shard_id=shard, seed=5)
    _same_batches(TokenPipeline(DataConfig(**kw)), JaxPipeline(JaxDataConfig(**kw)),
                  (0, 3, 17, 1000))


def test_memmap_batches_equal_jax(tmp_path):
    mine = synthetic_corpus(tmp_path / "port.bin", n_tokens=10_000, vocab=97, seed=2)
    theirs = jax_corpus(tmp_path / "jax.bin", n_tokens=10_000, vocab=97, seed=2)
    assert mine.read_bytes() == theirs.read_bytes()
    for shard in (0, 1):
        kw = dict(seq_len=16, global_batch=4, vocab=97, source="memmap", path=str(mine),
                  n_shards=2, shard_id=shard)
        _same_batches(TokenPipeline(DataConfig(**kw)), JaxPipeline(JaxDataConfig(**kw)),
                      (0, 5, 123))


def test_prefetch_thread_equals_jax():
    cfg = dict(seq_len=16, global_batch=2, vocab=50)
    pipe = TokenPipeline(DataConfig(**cfg)).start(step=3)
    got = [next(pipe) for _ in range(3)]
    pipe.stop()
    theirs = JaxPipeline(JaxDataConfig(**cfg))
    for i, batch in enumerate(got):
        assert np.array_equal(batch["tokens"], theirs.batch_at(3 + i)["tokens"])


# -------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_bf16(tmp_path):
    state = {"params": {"w": torch.ones((4, 4), dtype=torch.bfloat16) * 1.5}, "step": 7}
    save_state(tmp_path, state, step=7)
    got, step = restore_state(tmp_path, state)
    assert step == 7 and got["step"] == 7
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"], state["params"]["w"])


def test_checkpoint_torn_write_ignored(tmp_path):
    save_state(tmp_path, {"w": torch.ones(3)}, step=5)
    torn = tmp_path / "step_000000009"  # a directory without _COMMIT
    torn.mkdir()
    (torn / "MANIFEST.json").write_text("{}")
    assert latest_step(tmp_path) == 5


def test_checkpoint_corruption_detected(tmp_path):
    state = {"w": torch.arange(8.0)}
    d = save_state(tmp_path, state, step=1)
    npy = next(p for p in d.iterdir() if p.suffix == ".npy")
    raw = bytearray(npy.read_bytes())
    raw[-4] ^= 0xFF
    npy.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        restore_state(tmp_path, state)


def test_checkpoint_async_and_retention(tmp_path):
    store = CheckpointStore(tmp_path, keep=2)
    for s in (10, 20, 30):
        store.save_async({"w": torch.full((4,), float(s))}, s)
        store.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                   if p.name.startswith("step_"))
    assert steps == [20, 30]
    got, step = restore_state(tmp_path, {"w": torch.zeros(4)})
    assert step == 30 and float(got["w"][0]) == 30.0


def test_async_save_snapshots_before_the_state_moves(tmp_path):
    store = CheckpointStore(tmp_path)
    w = torch.zeros(1000)
    store.save_async({"w": w}, 1)
    w.fill_(5.0)  # the train loop goes on while the writer runs
    store.wait()
    assert float(restore_state(tmp_path, {"w": w})[0]["w"].abs().max()) == 0.0


# ----------------------------------------------------------------- monitor
def test_heartbeat_death_detection():
    mon = HeartbeatMonitor(interval_s=1.0, max_misses=3)
    mon.beat("a", now=0.0)
    mon.beat("b", now=0.0)
    assert mon.check(now=2.0) == set()
    mon.beat("a", now=2.0)
    assert mon.check(now=4.0) == {"b"}
    assert mon.check(now=5.0) == set()  # not newly dead twice
    mon.beat("b", now=6.0)  # resurrection clears
    assert "b" not in mon.dead


def test_straggler_policy():
    t = StepTimer(StragglerPolicy(factor=1.5, patience=3, ewma=1.0))
    for step in range(5):
        for h in ("h0", "h1", "h2"):
            t.record(h, 1.0)
        t.record("slow", 2.0)
        out = t.stragglers()
        if step < 2:
            assert out == set()
    assert "slow" in out


# ------------------------------------------------------------- train step
def _adam_carry(lr, g, scale, eps=1e-8):
    """How far the gradient tolerance moves a parameter through the first
    Adam step: upd = g' / (|g'| + eps) with g' = scale g, so a change dg in
    g moves it by lr scale eps / (|g'| + eps)**2 dg.  Where |g'| is near
    eps (a gradient that is almost exactly zero) this allows the whole step
    of lr; elsewhere it adds nothing measurable."""
    dg = TOL["atol"] + TOL["rtol"] * np.abs(g)
    return lr * scale * eps / (np.abs(scale * g) + eps) ** 2 * dg


@functools.cache
def _jax_step(arch, remat, microbatch):
    """JAX's side of :func:`train_step_matches_jax`, kept for the process (a
    file's cases may share it): the flat weights, the batch, the loss and
    every gradient (``jax.value_and_grad(loss_fn)`` under one ``jax.jit``
    for both microbatches, averaged over them as the JAX scan does), and
    the state and metrics after one ``make_train_step``."""
    jcfg, _ = _configs(arch, remat=remat, microbatch=microbatch)
    jp, _ = jzoo.build_params(jcfg, 0)
    jbatch = jzoo.make_batch(jcfg, jzoo.ShapeSpec("t", 2 * zoo.LOSS_CHUNK, 2, "train"), 3)
    jax_grads = functools.partial(
        jax.jit(jax.value_and_grad(lambda p, b: jzoo.loss_fn(jcfg, p, b)[0])), jp)
    halves = [{k: v[i : i + 1] for k, v in jbatch.items()} for i in range(2)] \
        if microbatch == 2 else [jbatch]
    parts = [jax_grads(b) for b in halves]
    jloss = np.mean([float(p[0]) for p in parts])
    jgrads = {k: np.mean([np.asarray(p[1][k], np.float32) for p in parts], axis=0) for k in jp}
    jopt = JaxAdamW(lr=1e-3)
    jstate = {"params": jp, "opt": jopt.init(jp), "step": jnp.int32(0)}
    jstate, jm = jax.jit(jzoo.make_train_step(jcfg, jopt))(jstate, jbatch)
    return _np(jp), jbatch, jloss, jgrads, jstate, jm


def train_step_matches_jax(remat, microbatch, arch, jax_remat=None):
    """One step of an arch's smoke config in f32 from the same weights, S =
    2 x LOSS_CHUNK (the chunked loss runs; rwkv6's and hymba's recurrences
    through their autograd Functions and plain backwards): the loss, every
    gradient and, after ``AdamW.update``, every parameter, m and v against
    JAX's (:func:`_jax_step`, with ``remat``, or ``jax_remat`` where given),
    within atol 1e-5 / rtol 1e-4; a parameter also within what the
    gradient tolerance carries through the Adam step (``_adam_carry``)."""
    _, cfg = _configs(arch, remat=remat, microbatch=microbatch)
    flat, jbatch, jloss, jgrads, jstate, jm = _jax_step(
        arch, remat if jax_remat is None else jax_remat, microbatch)
    model = zoo.from_jax_params(cfg, flat, device="cpu")
    batch = {k: np.asarray(v) for k, v in jbatch.items()}

    params = zoo.model_params(model)
    tparts = []
    for b in ([{k: v[i : i + 1] for k, v in batch.items()} for i in range(2)]
              if microbatch == 2 else [batch]):
        for p in params.values():
            p.requires_grad_(True)
        loss, _ = zoo.loss_fn(cfg, model, {k: torch.tensor(v) for k, v in b.items()})
        g = torch.autograd.grad(loss, list(params.values()))
        for p in params.values():
            p.requires_grad_(False)
        tparts.append((loss.item(), zoo.to_jax_params(cfg, dict(zip(params, g)))))
    np.testing.assert_allclose(np.mean([p[0] for p in tparts]), jloss, **TOL)
    for k in flat:
        got = np.mean([p[1][k].numpy() for p in tparts], axis=0)
        np.testing.assert_allclose(got, jgrads[k], **TOL, err_msg=f"grad {k}")

    opt = AdamW(lr=1e-3)
    state = {"params": model, "opt": opt.init(zoo.model_params(model)), "step": 0}
    state, m = zoo.make_train_step(cfg, opt)(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    assert state["step"] == int(jstate["step"]) == 1
    scale = min(1.0, 1.0 / float(jm["grad_norm"]))
    got_p = _np(zoo.to_jax_params(cfg, model))
    got_m, got_v = _np(zoo.to_jax_params(cfg, state["opt"].m)), _np(
        zoo.to_jax_params(cfg, state["opt"].v))
    for k in flat:
        want = np.asarray(jstate["params"][k], np.float32)
        bound = TOL["atol"] + TOL["rtol"] * np.abs(want) + _adam_carry(1e-3, jgrads[k], scale)
        assert (np.abs(got_p[k] - want) <= bound).all(), f"param {k}"
        np.testing.assert_allclose(got_m[k], np.asarray(jstate["opt"].m[k]), **TOL)
        np.testing.assert_allclose(got_v[k], np.asarray(jstate["opt"].v[k]), **TOL)


def test_remat_gives_the_same_gradients():
    """Checkpointed blocks recompute the same forward on the CPU: the
    gradients are bit-identical with remat on and off."""
    _, cfg = _configs()
    batch = zoo.make_batch(cfg, zoo.ShapeSpec("t", 32, 2, "train"), 1, device="cpu")
    out = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        model = zoo.build_params(c, 0, device="cpu")
        params = zoo.model_params(model)
        for p in params.values():
            p.requires_grad_(True)
        loss, _ = zoo.loss_fn(c, model, batch)
        out.append(torch.autograd.grad(loss, list(params.values())))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_recurrent_plain_versions_stay_differentiable():
    """On the CPU wkv6 and ssm_scan take their plain versions, forward and
    back, through their autograd Functions (on the card the same Functions
    launch the backward kernels)."""
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(1, 6, 2, 32, generator=g, requires_grad=True) for _ in range(3))
    w = torch.rand(1, 6, 2, 32, generator=g) * 0.5 + 0.4
    u = torch.randn(2, 32, generator=g)
    out, _ = wkv6(r, k, v, w, u)
    grads = torch.autograd.grad(out.sum(), (r, k, v))
    assert all(torch.isfinite(x).all() and x.abs().sum() > 0 for x in grads)
    x = torch.randn(1, 6, 16, generator=g, requires_grad=True)
    dt = torch.rand(1, 6, 16, generator=g) + 0.1
    a = -torch.rand(16, 8, generator=g) - 0.5
    b, c = torch.randn(1, 6, 8, generator=g), torch.randn(1, 6, 8, generator=g)
    y, _ = ssm_scan(x, dt, a, b, c)
    (gx,) = torch.autograd.grad(y.sum(), (x,))
    assert torch.isfinite(gx).all() and gx.abs().sum() > 0


# ----------------------------------------------------------------- driver
DATA = dict(seq_len=64, global_batch=4)


def _port_driver(cfg, path, flat=None, **kw):
    drv = TrainDriver(cfg, path, data=DataConfig(vocab=cfg.vocab, **DATA), device="cpu", **kw)
    if flat is not None:  # the JAX package's weights
        drv.init_state = lambda: drv.state_of(zoo.from_jax_params(cfg, flat, device="cpu"))
    return drv


def _jax_driver(jcfg, path, **kw):
    return JaxDriver(jcfg, path, data=JaxDataConfig(vocab=jcfg.vocab, **DATA), **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_losses_match_jax(tmp_path, arch):
    """Six steps of both drivers from the same weights over the same
    pipeline batches: losses by step within rtol 1e-4."""
    jcfg, cfg = _configs(arch)
    _, flat, _ = _weights(jcfg, cfg)
    want = _jax_driver(jcfg, tmp_path / "jax", ckpt_every=100).run(6)
    got = _port_driver(cfg, tmp_path / "port", flat, ckpt_every=100).run(6)
    assert got.steps_run == want.steps_run == 6
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)


def test_restart_replays_bit_identical(tmp_path):
    """bf16 yi smoke: a host lost at step 8 restores the step-5 checkpoint
    and replays steps 5-7 with the clean run's losses bit for bit; a run
    resumed from the clean run's last checkpoint runs only the missing
    steps, with the losses of a run that never stopped."""
    cfg = get_config("yi-9b", smoke=True)
    clean = _port_driver(cfg, tmp_path / "clean", ckpt_every=5).run(12)
    faulty = _port_driver(cfg, tmp_path / "faulty", ckpt_every=5).run(12, fail_at_step=8)
    assert faulty.restarts == 1 and faulty.restored_steps == [5]
    assert faulty.steps_run == 15
    assert faulty.losses == clean.losses[:8] + clean.losses[5:]
    resumed = _port_driver(cfg, tmp_path / "clean", ckpt_every=5).run(15)
    straight = _port_driver(cfg, tmp_path / "straight", ckpt_every=5).run(15)
    assert resumed.steps_run == 3 and resumed.restored_steps == []
    assert resumed.losses == straight.losses[12:]


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_in_the_port(tmp_path, arch):
    """The JAX driver's checkpoint after 2 steps restores in the port, whose
    third step's loss equals JAX's third within 1e-5."""
    jcfg, cfg = _configs(arch)
    _jax_driver(jcfg, tmp_path / "a", ckpt_every=2).run(2)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    got = _port_driver(cfg, tmp_path / "a", ckpt_every=100).run(3)
    want = _jax_driver(jcfg, tmp_path / "b", ckpt_every=100).run(3)
    assert got.steps_run == want.steps_run == 1
    np.testing.assert_allclose(got.losses, want.losses, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_jax(tmp_path, arch):
    """The port's bf16 checkpoint after 2 steps restores with
    ``repro.checkpoint.restore_state`` into the JAX state's structure, every
    leaf equal to the port's own restore."""
    jcfg = jax_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    drv = _port_driver(cfg, tmp_path, ckpt_every=100)
    drv.run(2)
    like = jax.eval_shape(_jax_driver(jcfg, tmp_path / "unused").init_state)
    theirs, step = jax_restore_state(tmp_path, like)
    mine, step2 = restore_state(tmp_path, drv.tree(drv.init_state()))
    assert step == step2 == 2
    assert int(theirs["step"]) == mine["step"] == 2
    flat, _ = jax.tree_util.tree_flatten_with_path(theirs)
    ours = leaves(mine)
    assert len(flat) == len(ours)
    for path, leaf in flat:
        name = jax.tree_util.keystr(path).strip("[]'\"").replace("']['", ".")
        arr = np.asarray(leaf.astype(jnp.float32) if leaf.dtype == jnp.bfloat16 else leaf)
        want = ours[name]
        want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
        assert arr.shape == want.shape and np.array_equal(arr, want), name


def test_driver_refuses_a_mesh(tmp_path):
    """The driver trains on a ``Mesh`` (tests/test_torch_sharded_train.py
    runs it on four gloo ranks) and refuses anything else it is handed as
    one."""
    _, cfg = _configs()
    with pytest.raises(TypeError, match="Mesh"):
        TrainDriver(cfg, tmp_path, mesh=object(), device="cpu")


def test_driver_raises_on_a_non_finite_loss(tmp_path, monkeypatch):
    _, cfg = _configs()
    drv = _port_driver(cfg, tmp_path)
    drv._compile = lambda: setattr(drv, "_step_fn", lambda s, b: (s, {"loss": float("nan")}))
    with pytest.raises(FloatingPointError, match="step 0"):
        drv.run(2)


# -------------------------------------------------------------------- CLI
def test_launch_train_cli_prints_the_jax_keys(tmp_path, capsys, monkeypatch):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-9b", "--device", "cpu",
         "--smoke", "--steps", "4", "--seq-len", "32", "--global-batch", "2", "--ckpt-dir",
         str(tmp_path / "port")],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    from repro.launch import train as jax_train

    monkeypatch.setattr(sys, "argv", ["train", "--arch", "yi-9b", "--steps", "1", "--seq-len",
                                      "16", "--global-batch", "2", "--ckpt-dir",
                                      str(tmp_path / "jax")])
    jax_train.main()
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == set(theirs) == JAX_TRAIN_KEYS
    assert rec["arch"] == "yi-smoke" and rec["steps"] == 4 and rec["restarts"] == 0
    assert np.isfinite(rec["first_loss"]) and np.isfinite(rec["last_loss"])


def test_launch_train_refuses_a_mesh(tmp_path, monkeypatch):
    """``--mesh host`` runs (tests/test_torch_sharded_train.py, on gloo with
    ``--device cpu``); on the card's default it refuses a host without one."""
    from repro_torch.launch.train import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(["--arch", "yi-9b", "--mesh", "host", "--ckpt-dir", str(tmp_path)])
