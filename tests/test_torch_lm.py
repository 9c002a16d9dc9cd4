"""The port's LM serving path against the JAX package, on the CPU: the
config registry, the layers, the weight factory, ``forward``, the prefill
and serve steps, the continuous-batching scheduler, the remote-embedding
client and the ``launch.serve`` CLI.  Weights come from the JAX package's
factory and go to the port through ``from_jax_params``; prompts come from
numpy seeds.  Tolerances: f32 logits agree to 1e-4 (two layers of f32
products summed in another order); bf16 logits to 0.0625 + 2% (bf16 keeps
8 bits and the two frameworks round matmul outputs and RoPE products at
different points, a few units in the last place at |logit| ~ 4); token
streams are compared for equality."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import common as jcommon
from repro.models import zoo as jzoo
from repro.runtime.serving import ServeScheduler as JaxScheduler
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import common, zoo
from repro_torch.runtime import RemoteEmbedClient, ServeScheduler

REPO = Path(__file__).resolve().parent.parent
BF16_TOL = dict(atol=0.0625, rtol=0.02)


@pytest.fixture(scope="module")
def yi_f32():
    """yi smoke in f32: the JAX config and weights, and the port's copy."""
    jcfg = jax_get_config("yi-9b", smoke=True).replace(dtype=jnp.float32)
    cfg = get_config("yi-9b", smoke=True).replace(dtype=torch.float32)
    jp, _ = jzoo.build_params(jcfg, 0)
    flat = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    return jcfg, jp, cfg, zoo.from_jax_params(cfg, flat, device="cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ------------------------------------------------------------ registry
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_yi_config_equals_jax(smoke):
    mine, theirs = get_config("yi-9b", smoke=smoke), jax_get_config("yi-9b", smoke=smoke)
    for field in theirs.__dataclass_fields__:
        if field != "dtype":
            assert getattr(mine, field) == getattr(theirs, field), field
    assert mine.dtype == torch.bfloat16 and theirs.dtype == jnp.bfloat16
    assert mine.vocab_padded == theirs.vocab_padded == (65_536 if not smoke else 2048)
    assert (mine.qkv_dim, mine.kv_dim) == (theirs.qkv_dim, theirs.kv_dim)
    assert list_archs() == ("yi-9b", "rwkv6-1.6b", "hymba-1.5b")


@pytest.mark.parametrize("arch", [a for a in JAX_ARCH_IDS
                                  if a not in ("yi-9b", "rwkv6-1.6b", "hymba-1.5b")] + ["nope"])
def test_unported_arch_raises_naming_roadmap(arch):
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config(arch)


@pytest.mark.parametrize("change", [
    dict(family="moe", n_experts=4, topk=2), dict(enc_layers=2), dict(frontend="patch"),
])
def test_unported_families_raise(change):
    cfg = get_config("yi-9b", smoke=True).replace(**change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        zoo.build_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        zoo.init_kv_cache(cfg, 1, 8, device="cpu")


@pytest.mark.parametrize("change", [dict(window=16), dict(window=16, global_every=2)],
                         ids=["all_local", "every_2nd_global"])
def test_windowed_dense_matches_jax(change):
    """A dense stack with sliding-window layers (the flash kernel's window)
    over a 40-token prompt, where the 16-token window bites."""
    jcfg = jax_get_config("yi-9b", smoke=True).replace(dtype=jnp.float32, **change)
    cfg = get_config("yi-9b", smoke=True).replace(dtype=torch.float32, **change)
    jp, _ = jzoo.build_params(jcfg, 2)
    model = zoo.from_jax_params(cfg, {k: np.asarray(v, np.float32) for k, v in jp.items()}, "cpu")
    toks = _tokens(5, (2, 40), cfg.vocab)
    want, _, _ = jzoo.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, _, _ = zoo.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# -------------------------------------------------------------- layers
def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = np.arange(3, 8)
    got = common.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    want = jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    h = rng.standard_normal((2, 5, 64)).astype(np.float32)
    gain = rng.standard_normal(64).astype(np.float32)
    got = common.rms_norm(torch.from_numpy(h), torch.from_numpy(gain), 1e-6)
    want = jcommon.rms_norm(jnp.asarray(h), jnp.asarray(gain), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    wi, wg, wo = (rng.standard_normal(s).astype(np.float32) * 0.1
                  for s in ((64, 96), (64, 96), (96, 64)))
    for act in ("silu", "gelu"):
        for gate in (wg, None):
            got = common.mlp(*(None if a is None else torch.from_numpy(a)
                               for a in (h, wi, gate, wo)), act)
            want = jcommon.mlp(*(None if a is None else jnp.asarray(a)
                                 for a in (h, wi, gate, wo)), act)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert common.pad_vocab(64_000) == jcommon.pad_vocab(64_000) == 65_536


def test_rope_is_interleaved_not_half_split():
    """Position 1 rotates the pair (x0, x1), not (x0, x_{hd/2})."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0
    out = common.rope(x, torch.tensor([1]), 10_000.0)
    assert out[..., 1].item() == pytest.approx(np.sin(1.0), abs=1e-6)
    assert out[..., 4].item() == 0.0


def test_param_factory_matches_jax_layout(yi_f32):
    jcfg, jp, cfg, _ = yi_f32
    model = zoo.build_params(cfg, seed=3, device="cpu")
    assert zoo.param_count(model) == jzoo.param_count(jp) == 819_840
    mine = dict(model.named_parameters())
    for key, arr in jp.items():
        if key.startswith("blocks."):
            for layer in range(cfg.n_layers):
                assert tuple(mine[f"blocks.{layer}.{key[7:]}"].shape) == arr.shape[1:], key
        else:
            assert tuple(mine[key].shape) == arr.shape, key
    assert all(not p.requires_grad for p in model.parameters())
    assert torch.count_nonzero(model.final_ln) == 0 and torch.count_nonzero(model.blocks[1].ln2) == 0
    wq = model.blocks[0].wq
    assert wq.abs().max() <= 2.0 / np.sqrt(cfg.d_model) and wq.std() > 0.5 / np.sqrt(cfg.d_model)
    assert model.embed.tok.abs().max() <= 2 * 0.02
    again = zoo.build_params(cfg, seed=3, device="cpu")
    other = zoo.build_params(cfg, seed=4, device="cpu")
    assert torch.equal(again.head.w, model.head.w) and not torch.equal(other.head.w, model.head.w)
    assert not torch.equal(model.blocks[0].wq, model.blocks[1].wq)  # a stream per leaf
    bf = zoo.build_params(get_config("yi-9b", smoke=True), seed=3, device="cpu")
    assert bf.head.w.dtype == torch.bfloat16


def test_from_jax_params_refuses_a_mismatch(yi_f32):
    jcfg, jp, cfg, _ = yi_f32
    flat = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    with pytest.raises(KeyError, match="final_ln"):
        zoo.from_jax_params(cfg, {k: v for k, v in flat.items() if k != "final_ln"}, "cpu")
    with pytest.raises(ValueError, match="head.w"):
        zoo.from_jax_params(cfg, {**flat, "head.w": flat["head.w"][:, :8]}, "cpu")
    with pytest.raises(KeyError, match="blocks.bq"):
        zoo.from_jax_params(cfg, {**flat, "blocks.bq": np.zeros((2, 128), np.float32)}, "cpu")


# ------------------------------------------------------------- forward
def test_forward_matches_jax_f32(yi_f32):
    jcfg, jp, cfg, model = yi_f32
    toks = _tokens(0, (2, 19), cfg.vocab)
    want, _, _ = jzoo.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, _, _ = zoo.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 19, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_forward_matches_jax_bf16():
    jcfg, cfg = jax_get_config("yi-9b", smoke=True), get_config("yi-9b", smoke=True)
    jp, _ = jzoo.build_params(jcfg, 0)
    model = zoo.from_jax_params(cfg, {k: np.asarray(v, np.float32) for k, v in jp.items()}, "cpu")
    assert model.head.w.dtype == torch.bfloat16
    toks = _tokens(1, (2, 11), cfg.vocab)
    want, _, _ = jzoo.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, _, _ = zoo.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


def test_config_options_match_jax():
    """The dense options the ModelConfig carries (QKV bias, both softcaps,
    tied embeddings, an embedding multiplier, a plain GeLU MLP)."""
    change = dict(qkv_bias=True, attn_softcap=30.0, final_softcap=20.0, tie_embeddings=True,
                  embed_mult=3.0, act="gelu", mlp_gated=False)
    jcfg = jax_get_config("yi-9b", smoke=True).replace(dtype=jnp.float32, **change)
    cfg = get_config("yi-9b", smoke=True).replace(dtype=torch.float32, **change)
    jp, _ = jzoo.build_params(jcfg, 1)
    rng = np.random.default_rng(5)
    flat = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    for b in ("blocks.bq", "blocks.bk", "blocks.bv"):  # nonzero biases, same in both
        flat[b] = rng.standard_normal(flat[b].shape).astype(np.float32) * 0.1
        jp[b] = jnp.asarray(flat[b])
    model = zoo.from_jax_params(cfg, flat, "cpu")
    toks = _tokens(2, (1, 9), cfg.vocab)
    want, _, _ = jzoo.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, _, _ = zoo.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_prefill_and_serve_steps_match_jax_teacher_forced(yi_f32):
    """Prefill logits of make_prefill_step, then a prompt prefilled into a
    session-sized cache and fed fixed next tokens through make_serve_step:
    every step's logits agree."""
    jcfg, jp, cfg, model = yi_f32
    b, p, gen, t_max = 2, 13, 6, 24
    toks = _tokens(3, (b, p), cfg.vocab)
    fed = _tokens(4, (b, gen), cfg.vocab)
    want, jcache = jzoo.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    got, cache = zoo.make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-5)

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
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), atol=1e-5)


def test_serve_step_writes_only_the_given_rows(yi_f32):
    *_, cfg, model = yi_f32
    cache = zoo.init_kv_cache(cfg, 3, 16, dtype=torch.float32, device="cpu")
    zoo.forward(cfg, model, {"tokens": torch.from_numpy(_tokens(6, (3, 8), cfg.vocab))},
                caches=cache, offset=0)
    before = {k: v.clone() for k, v in cache.items()}
    step = zoo.make_serve_step(cfg)
    step(model, cache, torch.from_numpy(_tokens(7, (3, 1), cfg.vocab)), 5, rows=torch.tensor([1]))
    for name in ("k", "v"):
        assert torch.equal(cache[name][:, [0, 2]], before[name][:, [0, 2]])
        assert not torch.equal(cache[name][:, 1, 5], before[name][:, 1, 5])
        assert torch.equal(cache[name][:, 1, :5], before[name][:, 1, :5])


# ----------------------------------------------------------- scheduler
def _scenario(name, sched_cls, cfg, params, vocab):
    """The four scenarios of tests/test_serving.py on either package's
    scheduler; returns {rid: tokens}."""
    if name == "more_requests_than_slots":
        rng = np.random.default_rng(0)
        s = sched_cls(cfg, params, slots=2, t_max=64)
        for _ in range(5):
            s.submit(rng.integers(0, vocab, rng.integers(4, 12)).astype(np.int32), max_new=6)
    elif name == "max_new_one":
        s = sched_cls(cfg, params, slots=2, t_max=64)
        s.submit(np.random.default_rng(2).integers(0, vocab, 6).astype(np.int32), max_new=1)
    elif name == "max_new_never_overshot":
        rng = np.random.default_rng(3)
        s = sched_cls(cfg, params, slots=2, t_max=64)
        for m in (1, 2, 5):
            s.submit(rng.integers(0, vocab, 4).astype(np.int32), max_new=m)
    else:  # late arrivals join a running batch
        rng = np.random.default_rng(1)
        s = sched_cls(cfg, params, slots=2, t_max=64)
        s.submit(rng.integers(0, vocab, 8).astype(np.int32), max_new=8)
        for _ in range(3):
            s.tick()
        s.submit(rng.integers(0, vocab, 5).astype(np.int32), max_new=4)
    return {r.rid: r.out for r in s.run()}, s


@pytest.mark.parametrize("name", ["more_requests_than_slots", "max_new_one",
                                  "max_new_never_overshot", "late_arrivals"])
def test_scheduler_streams_equal_jax(yi_f32, name):
    jcfg, jp, cfg, model = yi_f32
    want, _ = _scenario(name, JaxScheduler, jcfg, jp, cfg.vocab)
    before = flash_attention.launches
    got, sched = _scenario(name, ServeScheduler, cfg, model, cfg.vocab)
    assert got == want
    assert flash_attention.launches == before  # the CPU takes the plain version
    assert sched.prefills == len(got)
    assert (sched.decode_groups > 0) == (name != "max_new_one")


def test_ragged_batch_keeps_each_stream_isolated(yi_f32):
    """Slots at different positions decode in separate groups; each stream
    equals the same request decoded alone."""
    *_, cfg, model = yi_f32
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (3, 9, 5)]
    sched = ServeScheduler(cfg, model, slots=3, t_max=32)
    for p in prompts:
        sched.submit(p, 7)
    got = {r.rid: r.out for r in sched.run()}
    assert sched.decode_groups >= 3 * 6  # three positions, never merged
    for rid, p in enumerate(prompts):
        alone = ServeScheduler(cfg, model, slots=1, t_max=32)
        alone.submit(p, 7)
        assert got[rid] == alone.run()[0].out


# -------------------------------------------------------- remote embed
@pytest.fixture(scope="module")
def yi_bf16():
    cfg = get_config("yi-9b", smoke=True)
    return cfg, zoo.build_params(cfg, 0, device="cpu")


def test_remote_rows_bit_identical_to_table(yi_bf16):
    _, model = yi_bf16
    table = model.embed.tok.float().numpy()
    client = RemoteEmbedClient(table, n_servers=2, n_keys=4, device="cpu")
    ids = np.random.default_rng(3).integers(0, table.shape[0], (2, 7)).astype(np.int32)
    got = client.rows(ids)
    assert got.shape == (2, 7, table.shape[1]) and np.array_equal(got, table[ids])
    assert client.gathers == 4


def test_decode_stream_bit_identical_local_vs_remote(yi_bf16):
    cfg, model = yi_bf16
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
JAX_SERVE_KEYS = {"arch", "batch", "prompt_len", "generated", "prefill_s", "prefill_tok_s",
                  "decode_ms_per_tok", "decode_tok_s", "sample_ids"}


def test_launch_serve_cli_prints_its_json():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-9b", "--device", "cpu",
         "--batch", "2", "--prompt-len", "16", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(rec) == JAX_SERVE_KEYS
    assert rec["arch"] == "yi-smoke" and rec["generated"] == 4 and len(rec["sample_ids"]) == 4


def test_launch_serve_remote_embed_bit_identical():
    from repro_torch.launch.serve import serve

    argv = ["--arch", "yi-9b", "--device", "cpu", "--batch", "2", "--prompt-len", "12",
            "--gen", "5", "--seed", "1"]
    local, toks = serve(argv)
    remote, remote_toks = serve(argv + ["--remote-embed", "--embed-servers", "2"])
    assert np.array_equal(toks, remote_toks) and toks.shape == (2, 5)
    assert remote["embed_gathers"] > 0 and set(remote) - set(local) == {
        "remote_embed", "embed_servers", "embed_gathers"}


# ---------------------------------------------------- the card by default
def test_entry_points_without_a_card_raise(monkeypatch):
    from repro_torch.launch.serve import serve

    cfg = get_config("yi-9b", smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: zoo.build_params(cfg),
        lambda: zoo.init_kv_cache(cfg, 1, 4),
        lambda: zoo.make_batch(cfg, zoo.ShapeSpec("s", 4, 1, "prefill")),
        lambda: zoo.from_jax_params(cfg, {}),
        lambda: RemoteEmbedClient(np.zeros((8, 4), np.float32)),
        lambda: serve(["--arch", "yi-9b"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
