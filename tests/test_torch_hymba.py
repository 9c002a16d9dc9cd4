"""The port's hymba-1.5b serving path against the JAX package, on the CPU:
the config and its layer windows, the weight factory's ``ones`` and
``const`` leaves, ``from_jax_params``, ``forward`` (JAX's cache-less form
in both its chunked and its exact scan), the prefill and serve steps with
their four cache leaves across the sliding window, the continuous-batching
scheduler with ragged groups, remote embedding and the ``launch.serve``
CLI.  Weights come from the JAX package's factory (its constant leaves,
the norm gains, ``a_log``, ``d_skip``, ``dt_bias`` and the two mixing
gains, redrawn from a numpy seed in both packages, so every term of the
block is exercised) and go to the port through ``from_jax_params``;
prompts come from numpy seeds.

Tolerances: f32 logits agree to 1e-4 (two layers of f32 products summed in
another order) and f32 cache leaves to 1e-5; bf16 logits are held to the
reference's own bf16 accuracy (ROADMAP T11); token streams are compared
for equality."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtransformer
from repro.models import zoo as jzoo
from repro.runtime.serving import ServeScheduler as JaxScheduler
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models import transformer, zoo
from repro_torch.models.common import ParamFactory
from repro_torch.runtime import RemoteEmbedClient, ServeScheduler
from test_torch_lm import JAX_SERVE_KEYS, _scenario

REPO = Path(__file__).resolve().parent.parent
LEAVES = ("k", "v", "conv", "h")
REDRAWN = {"blocks.ln1": 0.0, "blocks.ln2": 0.0, "final_ln": 0.0, "blocks.ssm.a_log": 0.0,
           "blocks.ssm.d_skip": 1.0, "blocks.ssm.dt_bias": -4.6, "blocks.beta_attn": 1.0,
           "blocks.beta_ssm": 1.0}


def _redraw(flat: dict, seed: int) -> dict:
    """The leaves the JAX factory starts at a constant, drawn around it with
    spread 0.3."""
    rng = np.random.default_rng(seed)
    out = dict(flat)
    for key in sorted(REDRAWN):
        out[key] = (REDRAWN[key] + rng.standard_normal(flat[key].shape) * 0.3).astype(np.float32)
    return out


def _pair(dtype, seed=0):
    """JAX config and weights, and the port's copy."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jcfg = jax_get_config("hymba-1.5b", smoke=True).replace(dtype=jdt)
    cfg = get_config("hymba-1.5b", smoke=True).replace(dtype=tdt)
    jp, _ = jzoo.build_params(jcfg, seed)
    flat = _redraw({k: np.asarray(v, np.float32) for k, v in jp.items()}, seed + 1)
    jp = {k: jnp.asarray(v, jdt) for k, v in flat.items()}
    return jcfg, jp, cfg, zoo.from_jax_params(cfg, flat, device="cpu")


@pytest.fixture(scope="module")
def hymba_f32():
    return _pair("f32")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close_cache(cache, jcache, **tol):
    for name in LEAVES:
        assert cache[name].shape == jcache[name].shape, name
        np.testing.assert_allclose(cache[name].float().numpy(),
                                   np.asarray(jcache[name], np.float32), err_msg=name, **tol)


# ------------------------------------------------------------ registry
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_hymba_config_equals_jax(smoke):
    mine = get_config("hymba-1.5b", smoke=smoke)
    theirs = jax_get_config("hymba-1.5b", smoke=smoke)
    for field in theirs.__dataclass_fields__:
        if field != "dtype":
            assert getattr(mine, field) == getattr(theirs, field), field
    assert mine.dtype == torch.bfloat16 and theirs.dtype == jnp.bfloat16
    assert mine.family == "hybrid" and mine.ssm_chunk == 32
    assert mine.vocab_padded == theirs.vocab_padded == (32_768 if not smoke else 2048)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_layer_windows_equal_jax(smoke):
    cfg = get_config("hymba-1.5b", smoke=smoke)
    want = jtransformer.layer_windows(jax_get_config("hymba-1.5b", smoke=smoke))
    got = transformer.layer_windows(cfg)
    assert np.array_equal(got, want)
    if not smoke:  # layers 7, 15, 23 and 31 are global, the rest see 2,048 keys
        assert [i for i, w in enumerate(got) if w == 0] == [7, 15, 23, 31]
        assert set(got[got > 0]) == {2048}
    else:
        assert list(got) == [16, 16]


def test_param_factory_matches_jax_layout():
    cfg = get_config("hymba-1.5b", smoke=True).replace(dtype=torch.float32)
    jp, _ = jzoo.build_params(jax_get_config("hymba-1.5b", smoke=True), 0)
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
    assert isinstance(blk, transformer.HybridBlock)
    for name in ("beta_attn", "beta_ssm"):
        assert torch.equal(getattr(blk, name), torch.ones(cfg.d_model))
    assert torch.equal(blk.ssm.d_skip, torch.ones(cfg.d_model))
    assert torch.equal(blk.ssm.dt_bias, torch.full((cfg.d_model,), -4.6))
    assert torch.count_nonzero(blk.ssm.a_log) == 0
    assert blk.ssm.conv.abs().max() <= 2 * 0.5 and blk.ssm.conv.std() > 0
    # JAX's constants, bit for bit, in bf16 too
    bf = zoo.build_params(get_config("hymba-1.5b", smoke=True), seed=3, device="cpu")
    assert np.array_equal(bf.blocks[0].ssm.dt_bias.float().numpy(),
                          np.asarray(jp["blocks.ssm.dt_bias"][0], np.float32))


def test_param_factory_refuses_an_unknown_or_unscaled_init():
    f = ParamFactory(0, torch.float32, torch.device("cpu"))
    with pytest.raises(ValueError, match="const"):
        f.new((3,), "const")
    with pytest.raises(ValueError, match="no init"):
        f.new((3,), "uniform")
    assert torch.equal(f.new((2,), "const", scale=0.25), torch.full((2,), 0.25))


# ------------------------------------------------------------- weights
def test_from_jax_params_round_trip():
    jcfg = jax_get_config("hymba-1.5b", smoke=True).replace(dtype=jnp.float32)
    cfg = get_config("hymba-1.5b", smoke=True).replace(dtype=torch.float32)
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
    with pytest.raises(KeyError, match="blocks.1.ssm.w_bcdt"):
        zoo.from_jax_params(cfg, {k: v for k, v in flat.items() if k != "blocks.ssm.w_bcdt"},
                            "cpu")
    with pytest.raises(ValueError, match="ssm.a_log"):
        zoo.from_jax_params(cfg, {**flat, "blocks.ssm.a_log": flat["blocks.ssm.a_log"][:, :, :4]},
                            "cpu")
    with pytest.raises(KeyError, match="blocks.tm.u"):
        zoo.from_jax_params(cfg, {**flat, "blocks.tm.u": np.zeros((2, 1, 64), np.float32)}, "cpu")


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("t", [9, 40])
@pytest.mark.parametrize("chunk", [32, 0], ids=["jax_chunked", "jax_exact"])
def test_forward_matches_jax_f32(hymba_f32, t, chunk):
    """The cache-less forward, against JAX's chunked scan (its form without
    a cache, at hymba's init far inside the clamp) and its exact scan; at
    T = 40 the 16-token window bites."""
    jcfg, jp, cfg, model = hymba_f32
    toks = _tokens(t, (2, t), cfg.vocab)
    want, _, _ = jzoo.forward(jcfg.replace(ssm_chunk=chunk), jp, {"tokens": jnp.asarray(toks)})
    got, _, _ = zoo.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, t, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("t", [9, 40])
def test_forward_bf16_as_accurate_as_jax(t):
    """bf16 logits, held to the reference's own bf16 accuracy (T11): the
    port's rms distance to the f32 logits (same weights) is within 10% of
    JAX's bf16 rms distance to them, and its rms distance to JAX's bf16
    logits within that same distance."""
    jcfg, jp, cfg, model = _pair("bf16")
    assert model.blocks[0].ssm.w_in.dtype == torch.bfloat16
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


def test_prefill_and_serve_steps_match_jax_across_the_window(hymba_f32):
    """make_prefill_step's logits and cache, then a 10-token prompt in a
    session-sized cache fed 14 fixed next tokens through make_serve_step,
    decoding past the 16-token window: every step's logits and all four
    cache leaves agree."""
    jcfg, jp, cfg, model = hymba_f32
    b, p, gen, t_max = 2, 10, 14, 24
    toks = _tokens(3, (b, p), cfg.vocab)
    fed = _tokens(4, (b, gen), cfg.vocab)
    want, jc = jzoo.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    got, tc = zoo.make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert tc["conv"].dtype == torch.float32 and tc["h"].dtype == torch.float32
    _close_cache(tc, jc, atol=1e-5, rtol=1e-5)

    jc = jzoo.init_kv_cache(jcfg, b, t_max, dtype=jnp.float32)
    _, jc, _ = jzoo.forward(jcfg, jp, {"tokens": jnp.asarray(toks)}, caches=jc,
                            offset=jnp.int32(0))
    tc = zoo.init_kv_cache(cfg, b, t_max, dtype=torch.float32, device="cpu")
    zoo.forward(cfg, model, {"tokens": torch.from_numpy(toks)}, caches=tc, offset=0)
    jstep, tstep = jzoo.make_serve_step(jcfg), zoo.make_serve_step(cfg)
    for i in range(gen):
        tok = fed[:, i : i + 1]
        want, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(p + i))
        got, tc = tstep(model, tc, torch.from_numpy(tok), p + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, err_msg=f"step {i}")
    _close_cache(tc, jc, atol=1e-5, rtol=1e-5)


def test_init_kv_cache_matches_jax_leaves():
    jcfg, cfg = jax_get_config("hymba-1.5b", smoke=True), get_config("hymba-1.5b", smoke=True)
    want = jzoo.init_kv_cache(jcfg, 3, 100, dtype=jnp.bfloat16)
    got = zoo.init_kv_cache(cfg, 3, 100, dtype=torch.bfloat16, device="cpu")
    assert set(got) == set(want) == set(LEAVES)
    for name in LEAVES:
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype)[6:] == str(want[name].dtype)
        assert torch.count_nonzero(got[name]) == 0


def test_serve_step_writes_only_the_given_rows(hymba_f32):
    *_, cfg, model = hymba_f32
    cache = zoo.init_kv_cache(cfg, 3, 24, dtype=torch.float32, device="cpu")
    zoo.forward(cfg, model, {"tokens": torch.from_numpy(_tokens(6, (3, 8), cfg.vocab))},
                caches=cache, offset=0)
    before = {k: v.clone() for k, v in cache.items()}
    step = zoo.make_serve_step(cfg)
    step(model, cache, torch.from_numpy(_tokens(7, (3, 1), cfg.vocab)), 8, rows=torch.tensor([1]))
    for name in LEAVES:
        assert torch.equal(cache[name][:, [0, 2]], before[name][:, [0, 2]]), name
        assert not torch.equal(cache[name][:, 1], before[name][:, 1]), name
    assert torch.equal(cache["k"][:, 1, :8], before["k"][:, 1, :8])


# ----------------------------------------------------------- scheduler
@pytest.mark.parametrize("name", ["more_requests_than_slots", "max_new_one",
                                  "max_new_never_overshot", "late_arrivals"])
def test_scheduler_streams_equal_jax(hymba_f32, name):
    jcfg, jp, cfg, model = hymba_f32
    want, _ = _scenario(name, JaxScheduler, jcfg, jp, cfg.vocab)
    f0, s0 = flash_attention.launches, ssm_scan.launches
    got, sched = _scenario(name, ServeScheduler, cfg, model, cfg.vocab)
    assert got == want
    assert (flash_attention.launches, ssm_scan.launches) == (f0, s0)  # the CPU: plain versions
    assert sched.prefills == len(got)
    assert (sched.decode_groups > 0) == (name != "max_new_one")


def test_ragged_groups_past_the_window_equal_jax(hymba_f32):
    """Three slots at three positions, decoded in separate groups past the
    16-token window, so every group's step writes only its rows of the
    K/V, conv and SSM leaves: the streams equal the JAX scheduler's."""
    jcfg, jp, cfg, model = hymba_f32
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 19, 11)]
    streams = []
    for cls, c, p in ((JaxScheduler, jcfg, jp), (ServeScheduler, cfg, model)):
        sched = cls(c, p, slots=3, t_max=40)
        for prompt in prompts:
            sched.submit(prompt, 9)
        streams.append({r.rid: r.out for r in sched.run()})
    assert streams[0] == streams[1]
    assert sched.decode_groups >= 3 * 8  # three positions, never merged


# -------------------------------------------------------- remote embed
def test_decode_stream_bit_identical_local_vs_remote():
    cfg = get_config("hymba-1.5b", smoke=True)
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
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "hymba-1.5b", "--smoke",
         "--device", "cpu", "--batch", "2", "--prompt-len", "20", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(rec) == JAX_SERVE_KEYS
    assert rec["arch"] == "hymba-smoke" and rec["generated"] == 4 and len(rec["sample_ids"]) == 4


def test_launch_serve_remote_embed_bit_identical():
    from repro_torch.launch.serve import serve

    argv = ["--arch", "hymba-1.5b", "--device", "cpu", "--batch", "2", "--prompt-len", "14",
            "--gen", "5", "--seed", "1"]
    local, toks = serve(argv)
    remote, remote_toks = serve(argv + ["--remote-embed", "--embed-servers", "2"])
    assert np.array_equal(toks, remote_toks) and toks.shape == (2, 5)
    assert remote["embed_gathers"] > 0 and set(remote) - set(local) == {
        "remote_embed", "embed_servers", "embed_gathers"}


def test_entry_points_without_a_card_raise(monkeypatch):
    cfg = get_config("hymba-1.5b", smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: zoo.build_params(cfg), lambda: zoo.init_kv_cache(cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
