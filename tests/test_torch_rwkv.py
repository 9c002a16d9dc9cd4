"""The port's rwkv6 serving path against the JAX package, on the CPU: the
config, the time mix, channel mix and block, ``from_jax_params``,
``forward``, the prefill and serve steps with their three state leaves,
the continuous-batching scheduler, remote embedding and the
``launch.serve`` CLI.  Weights come from the JAX package's factory (its
zero-initialised leaves, mu, w0, u and the norm gains, redrawn from a numpy
seed in both packages, so every term of the block is exercised) and go to
the port through ``from_jax_params``; prompts come from numpy seeds.

The JAX side runs with ``rwkv_chunk=0``: its chunked jnp WKV6 clamps the
within-chunk cumulative log-decay at -60, which the smoke model's decays
(log w about -1 per step) pass within a 64-token chunk, so at T = 64 it
computes another function (tests/test_torch_wkv6.py pins that fault).
With ``rwkv_chunk=0`` it runs the exact recurrence, as the port does.

Tolerances: f32 logits agree to 1e-4 (two layers of f32 products summed in
another order) and f32 states to 1e-5; bf16 logits are held to the
reference's own bf16 accuracy (see the bf16 test); token streams are
compared for equality."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import rwkv as jrwkv
from repro.models import zoo as jzoo
from repro.runtime.serving import ServeScheduler as JaxScheduler
from repro_torch.configs import get_config
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models import rwkv, zoo
from repro_torch.models.common import ParamFactory
from repro_torch.runtime import RemoteEmbedClient, ServeScheduler
from test_torch_lm import JAX_SERVE_KEYS, _scenario

REPO = Path(__file__).resolve().parent.parent
LEAVES = ("tm_shift", "cm_shift", "wkv")
ZERO_INIT = ("ln1", "ln2", "tm.mu_", "tm.w0", "tm.u", "tm.ln_x", "cm.mu_")


def _redraw_zero_leaves(flat: dict, seed: int) -> dict:
    """The leaves the JAX factory starts at zero, drawn N(0, 0.09)."""
    rng = np.random.default_rng(seed)
    out = dict(flat)
    for key in sorted(flat):
        if any(key.startswith(f"blocks.{z}") for z in ZERO_INIT):
            out[key] = (rng.standard_normal(flat[key].shape) * 0.3).astype(np.float32)
    return out


def _pair(dtype, seed=0):
    """JAX config (exact recurrence) and weights, and the port's copy."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jcfg = jax_get_config("rwkv6-1.6b", smoke=True).replace(dtype=jdt, rwkv_chunk=0)
    cfg = get_config("rwkv6-1.6b", smoke=True).replace(dtype=tdt)
    jp, _ = jzoo.build_params(jcfg, seed)
    flat = _redraw_zero_leaves({k: np.asarray(v, np.float32) for k, v in jp.items()}, seed + 1)
    jp = {k: jnp.asarray(v, jdt) for k, v in flat.items()}
    return jcfg, jp, cfg, zoo.from_jax_params(cfg, flat, device="cpu")


@pytest.fixture(scope="module")
def rwkv_f32():
    return _pair("f32")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close_state(cache, jcache, **tol):
    for name in LEAVES:
        assert cache[name].shape == jcache[name].shape, name
        np.testing.assert_allclose(cache[name].float().numpy(),
                                   np.asarray(jcache[name], np.float32), err_msg=name, **tol)


# ------------------------------------------------------------ registry
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_rwkv_config_equals_jax(smoke):
    mine = get_config("rwkv6-1.6b", smoke=smoke)
    theirs = jax_get_config("rwkv6-1.6b", smoke=smoke)
    for field in theirs.__dataclass_fields__:
        if field != "dtype":
            assert getattr(mine, field) == getattr(theirs, field), field
    assert mine.dtype == torch.bfloat16 and theirs.dtype == jnp.bfloat16
    assert mine.family == "rwkv" and mine.rwkv_chunk == 64
    assert mine.vocab_padded == theirs.vocab_padded == (65_536 if not smoke else 2048)


def test_param_factory_matches_jax_layout():
    cfg = get_config("rwkv6-1.6b", smoke=True).replace(dtype=torch.float32)
    jp, _ = jzoo.build_params(jax_get_config("rwkv6-1.6b", smoke=True), 0)
    model = zoo.build_params(cfg, seed=3, device="cpu")
    assert zoo.param_count(model) == jzoo.param_count(jp)
    mine = dict(model.named_parameters())
    for key, arr in jp.items():
        if key.startswith("blocks."):
            for layer in range(cfg.n_layers):
                assert tuple(mine[f"blocks.{layer}.{key[7:]}"].shape) == arr.shape[1:], key
        else:
            assert tuple(mine[key].shape) == arr.shape, key
    blk = model.blocks[1]
    assert isinstance(blk, rwkv.RWKVBlock)
    for zero in (blk.ln1, blk.tm.mu_r, blk.tm.w0, blk.tm.u, blk.tm.ln_x, blk.cm.mu_k):
        assert torch.count_nonzero(zero) == 0
    assert blk.tm.wA.abs().max() <= 2.0 / np.sqrt(cfg.d_model) and blk.tm.wA.std() > 0


# -------------------------------------------------------------- layers
def _layer(flat, layer):
    """One layer's leaves without the ``blocks.`` prefix."""
    return {k[7:]: v[layer] for k, v in flat.items() if k.startswith("blocks.")}


def _port_block(cfg, leaves):
    blk = rwkv.RWKVBlock(cfg, ParamFactory(0, torch.float32, torch.device("cpu"), fill=False))
    for name, p in blk.named_parameters():
        p.copy_(torch.from_numpy(leaves[name]))
    return blk


@pytest.fixture(scope="module")
def layer_case(rwkv_f32):
    """Layer 1's weights, an input of 37 tokens, and a carried state."""
    jcfg, jp, cfg, _ = rwkv_f32
    leaves = _layer({k: np.array(v) for k, v in jp.items()}, 1)
    rng = np.random.default_rng(11)
    d, h, m = cfg.d_model, cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    x = rng.standard_normal((2, 37, d)).astype(np.float32)
    state = {"tm_shift": rng.standard_normal((2, 1, d)).astype(np.float32),
             "cm_shift": rng.standard_normal((2, 1, d)).astype(np.float32),
             "wkv": (rng.standard_normal((2, h, m, m)) * 0.5).astype(np.float32)}
    return jcfg, cfg, leaves, _port_block(cfg, leaves), x, state


def test_time_mix_matches_jax(layer_case):
    jcfg, cfg, leaves, blk, x, st = layer_case
    jl = {k: jnp.asarray(v) for k, v in leaves.items()}
    for t in (37, 1):
        want = jrwkv.time_mix(jnp.asarray(x[:, :t]), jl, jcfg, jnp.asarray(st["tm_shift"]),
                              jnp.asarray(st["wkv"]))
        got = rwkv.time_mix(torch.from_numpy(x[:, :t]), blk.tm, cfg,
                            torch.from_numpy(st["tm_shift"]), torch.from_numpy(st["wkv"]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_channel_mix_matches_jax(layer_case):
    jcfg, cfg, leaves, blk, x, st = layer_case
    jl = {k: jnp.asarray(v) for k, v in leaves.items()}
    for prev in (None, st["cm_shift"]):
        want = jrwkv.channel_mix(jnp.asarray(x), jl, None if prev is None else jnp.asarray(prev))
        got = rwkv.channel_mix(torch.from_numpy(x), blk.cm,
                               None if prev is None else torch.from_numpy(prev))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_token_shift_carries_the_previous_row():
    x = torch.arange(6.0).reshape(1, 3, 2)
    assert torch.equal(rwkv.token_shift(x, None), torch.tensor([[[0.0, 0], [0, 1], [2, 3]]]))
    prev = torch.full((1, 1, 2), 9.0)
    assert torch.equal(rwkv.token_shift(x, prev)[:, 0], prev[:, 0])


def test_block_matches_jax(layer_case):
    jcfg, cfg, leaves, blk, x, st = layer_case
    jl = {k: jnp.asarray(v) for k, v in leaves.items()}
    for state in (None, st):
        jstate = None if state is None else {k: jnp.asarray(v) for k, v in state.items()}
        tstate = None if state is None else {k: torch.from_numpy(v) for k, v in state.items()}
        want, jnew = jrwkv.rwkv_block(jnp.asarray(x), jl, jcfg, jstate)
        got, new = rwkv.rwkv_block(torch.from_numpy(x), blk, cfg, tstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        _close_state(new, jnew, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- weights
def test_from_jax_params_loads_the_smoke_weights():
    jcfg = jax_get_config("rwkv6-1.6b", smoke=True).replace(dtype=jnp.float32)
    cfg = get_config("rwkv6-1.6b", smoke=True).replace(dtype=torch.float32)
    jp, _ = jzoo.build_params(jcfg, 0)
    flat = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    model = zoo.from_jax_params(cfg, flat, "cpu")
    mine = dict(model.named_parameters())
    assert len(mine) == cfg.n_layers * sum(k.startswith("blocks.") for k in flat) + 3
    for key, arr in flat.items():
        if key.startswith("blocks."):
            for layer in range(cfg.n_layers):
                assert np.array_equal(mine[f"blocks.{layer}.{key[7:]}"].numpy(), arr[layer]), key
        else:
            assert np.array_equal(mine[key].numpy(), arr), key
    with pytest.raises(KeyError, match="blocks.1.tm.u"):
        zoo.from_jax_params(cfg, {k: v for k, v in flat.items() if k != "blocks.tm.u"}, "cpu")
    with pytest.raises(ValueError, match="cm.wk"):
        zoo.from_jax_params(cfg, {**flat, "blocks.cm.wk": flat["blocks.cm.wk"][:, :, :8]}, "cpu")
    with pytest.raises(KeyError, match="blocks.wq"):
        zoo.from_jax_params(cfg, {**flat, "blocks.wq": np.zeros((2, 128, 128), np.float32)}, "cpu")


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("t", [7, 64])
def test_forward_matches_jax_f32(rwkv_f32, t):
    jcfg, jp, cfg, model = rwkv_f32
    toks = _tokens(t, (2, t), cfg.vocab)
    want, _, _ = jzoo.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, _, _ = zoo.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, t, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("t", [7, 64])
def test_forward_bf16_as_accurate_as_jax(t):
    """bf16 logits, held to the reference's own bf16 accuracy.  The WKV
    output is rounded to bf16 before a groupnorm over 64 values, which
    divides by their spread, so a one-ulp difference in where the two
    frameworks round is amplified: JAX's bf16 logits are up to ~0.25 from
    its f32 logits of the same (bf16) weights at T = 64, and no elementwise
    bound between two bf16 renderings is tighter than that.  So: the
    port's rms distance to the f32 logits is within 10% of JAX's bf16
    rms distance to them, and its rms distance to JAX's bf16 logits is
    within that same distance."""
    jcfg, jp, cfg, model = _pair("bf16")
    assert model.head.w.dtype == torch.bfloat16
    toks = _tokens(t + 1, (2, t), cfg.vocab)
    batch = {"tokens": jnp.asarray(toks)}
    exact, _, _ = jzoo.forward(jcfg.replace(dtype=jnp.float32),
                               {k: v.astype(jnp.float32) for k, v in jp.items()}, batch)
    want, _, _ = jzoo.forward(jcfg, jp, batch)
    got, _, _ = zoo.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    exact, want, got = np.asarray(exact), np.asarray(want, np.float32), got.float().numpy()
    rms = lambda a, b: float(np.sqrt(np.mean((a - b) ** 2)))
    ref_err = rms(want, exact)
    assert 0 < ref_err < 0.05
    assert rms(got, exact) <= 1.1 * ref_err
    assert rms(got, want) <= ref_err


def test_prefill_and_serve_steps_match_jax_teacher_forced(rwkv_f32):
    """make_prefill_step's logits and state, then fixed next tokens through
    make_serve_step: every step's logits and all three state leaves agree."""
    jcfg, jp, cfg, model = rwkv_f32
    b, p, gen = 2, 13, 6
    toks = _tokens(3, (b, p), cfg.vocab)
    fed = _tokens(4, (b, gen), cfg.vocab)
    want, jc = jzoo.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    got, tc = zoo.make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert tc["tm_shift"].dtype == torch.float32 and tc["wkv"].dtype == torch.float32
    _close_state(tc, jc, atol=1e-5, rtol=1e-5)
    jstep, tstep = jzoo.make_serve_step(jcfg), zoo.make_serve_step(cfg)
    for i in range(gen):
        tok = fed[:, i : i + 1]
        want, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(p + i))
        got, tc = tstep(model, tc, torch.from_numpy(tok), p + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, err_msg=f"step {i}")
    _close_state(tc, jc, atol=1e-5, rtol=1e-5)


def test_init_kv_cache_matches_jax_leaves():
    jcfg, cfg = jax_get_config("rwkv6-1.6b", smoke=True), get_config("rwkv6-1.6b", smoke=True)
    want = jzoo.init_kv_cache(jcfg, 3, 100, dtype=jnp.bfloat16)
    got = zoo.init_kv_cache(cfg, 3, 100, dtype=torch.bfloat16, device="cpu")
    assert set(got) == set(want) == set(LEAVES)
    for name in LEAVES:
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype)[6:] == str(want[name].dtype)
        assert torch.count_nonzero(got[name]) == 0


def test_serve_step_writes_only_the_given_rows(rwkv_f32):
    *_, cfg, model = rwkv_f32
    cache = zoo.init_kv_cache(cfg, 3, 16, dtype=torch.float32, device="cpu")
    zoo.forward(cfg, model, {"tokens": torch.from_numpy(_tokens(6, (3, 8), cfg.vocab))},
                caches=cache, offset=0)
    before = {k: v.clone() for k, v in cache.items()}
    step = zoo.make_serve_step(cfg)
    step(model, cache, torch.from_numpy(_tokens(7, (3, 1), cfg.vocab)), 8, rows=torch.tensor([1]))
    for name in LEAVES:
        assert torch.equal(cache[name][:, [0, 2]], before[name][:, [0, 2]]), name
        assert not torch.equal(cache[name][:, 1], before[name][:, 1]), name


# ----------------------------------------------------------- scheduler
@pytest.mark.parametrize("name", ["more_requests_than_slots", "max_new_one",
                                  "max_new_never_overshot", "late_arrivals"])
def test_scheduler_streams_equal_jax(rwkv_f32, name):
    jcfg, jp, cfg, model = rwkv_f32
    want, _ = _scenario(name, JaxScheduler, jcfg, jp, cfg.vocab)
    before = wkv6.launches
    got, sched = _scenario(name, ServeScheduler, cfg, model, cfg.vocab)
    assert got == want
    assert wkv6.launches == before  # the CPU takes the plain version
    assert sched.prefills == len(got)
    assert (sched.decode_groups > 0) == (name != "max_new_one")


def test_ragged_batch_keeps_each_stream_isolated(rwkv_f32):
    """Slots at different positions decode in separate groups; each stream
    equals the same request decoded alone, so no group advanced another
    group's state."""
    *_, cfg, model = rwkv_f32
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (3, 9, 5)]
    sched = ServeScheduler(cfg, model, slots=3, t_max=32)
    for p in prompts:
        sched.submit(p, 7)
    got = {r.rid: r.out for r in sched.run()}
    assert sched.decode_groups >= 3 * 6
    for rid, p in enumerate(prompts):
        alone = ServeScheduler(cfg, model, slots=1, t_max=32)
        alone.submit(p, 7)
        assert got[rid] == alone.run()[0].out


# -------------------------------------------------------- remote embed
def test_decode_stream_bit_identical_local_vs_remote():
    cfg = get_config("rwkv6-1.6b", smoke=True)
    model = zoo.build_params(cfg, 0, device="cpu")
    prompts = [np.arange(1, 6, dtype=np.int32), np.array([7, 3, 2], np.int32)]
    local = ServeScheduler(cfg, model, slots=2, t_max=32)
    for p in prompts:
        local.submit(p, 5)
    want = {r.rid: r.out for r in local.run()}
    embed = RemoteEmbedClient(model.embed.tok.float().numpy(), device="cpu")
    remote = ServeScheduler(cfg, model, slots=2, t_max=32, embed_client=embed)
    for p in prompts:
        remote.submit(p, 5)
    got = {r.rid: r.out for r in remote.run()}
    assert got == want
    assert embed.gathers > 0


# -------------------------------------------------------------- launcher
def test_launch_serve_cli_prints_its_json():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "rwkv6-1.6b",
         "--device", "cpu", "--batch", "2", "--prompt-len", "16", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(rec) == JAX_SERVE_KEYS
    assert rec["arch"] == "rwkv6-smoke" and rec["generated"] == 4 and len(rec["sample_ids"]) == 4


def test_launch_serve_remote_embed_bit_identical():
    from repro_torch.launch.serve import serve

    argv = ["--arch", "rwkv6-1.6b", "--device", "cpu", "--batch", "2", "--prompt-len", "12",
            "--gen", "5", "--seed", "1"]
    local, toks = serve(argv)
    remote, remote_toks = serve(argv + ["--remote-embed", "--embed-servers", "2"])
    assert np.array_equal(toks, remote_toks) and toks.shape == (2, 5)
    assert remote["embed_gathers"] > 0 and set(remote) - set(local) == {
        "remote_embed", "embed_servers", "embed_gathers"}


def test_entry_points_without_a_card_raise(monkeypatch):
    cfg = get_config("rwkv6-1.6b", smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: zoo.build_params(cfg), lambda: zoo.init_kv_cache(cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
