"""The port's MoE family against the JAX package, on the CPU: the router,
the capacity buffer's slots and drops, the scatter, replicated and
dispatching blocks (values and gradients), granite-moe and phi3.5-moe smoke
models (weights, prefill and decode, the loss with its aux), the serving
scheduler and the ``launch.serve`` CLI.  Inputs come from numpy seeds;
weights from the JAX package's factory through ``from_jax_params``.

Tolerances: integers (expert ids, slots, keeps, capacities) equal; f32
gates and aux within 1e-6 and block outputs within 1e-5 (f32 products
summed in other orders); bf16 block outputs within the dense family's bf16
rule, atol 0.0625 + 2% (``tests/test_torch_lm.py``); gradients within
atol 1e-5 / rtol 1e-4 of ``jax.vjp``; f32 logits within 1e-4; token
streams equal.  The expert-parallel ``moe_block_a2a`` runs on 4 gloo ranks
in ``tests/test_torch_spmd.py``.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_moe.py``.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models import zoo as jzoo
from repro.runtime.serving import ServeScheduler as JaxScheduler
from repro_torch.configs import get_config
from repro_torch.models import moe, zoo
from repro_torch.runtime import ServeScheduler

REPO = Path(__file__).resolve().parent.parent
ARCHS = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
BF16_TOL = dict(atol=0.0625, rtol=0.02)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _block_inputs(seed, b=2, s=24, d=16, e=8, f=32):
    """x (B, S, D), router (D, E) and experts at test_multidevice.py's scales."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, s, d)) * 0.5).astype(np.float32),
            (rng.standard_normal((d, e)) * 0.3).astype(np.float32),
            *((rng.standard_normal(shape) * 0.3).astype(np.float32)
              for shape in ((e, d, f), (e, d, f), (e, f, d))))


def _jax(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


# -------------------------------------------------------------- registry
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_config_equals_jax(arch, smoke):
    mine, theirs = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
    for field in theirs.__dataclass_fields__:
        if field != "dtype":
            assert getattr(mine, field) == getattr(theirs, field), field
    assert mine.family == "moe" and mine.vocab_padded == theirs.vocab_padded


# ---------------------------------------------------------------- router
@pytest.mark.parametrize("args", [(128, 32, 8, 1.25), (3072, 32, 8, 1.25), (8192, 16, 2, 1.25),
                                  (7, 8, 4, 1.25), (48, 8, 2, 0.5), (1, 16, 2, 8.0),
                                  (2048, 2, 8, 1.0)])
def test_moe_capacity_equals_jax(args):
    assert moe.moe_capacity(*args) == jmoe.moe_capacity(*args)


@pytest.mark.parametrize("topk", [1, 2, 4])
def test_route_matches_jax(topk):
    """Expert ids equal, in the same order; gates and aux within 1e-6."""
    x, wr, *_ = _block_inputs(0, b=1, s=64)
    gates, idx, aux = jmoe.route(*_jax(x[0], wr), topk)
    tg, ti, ta = moe.route(*_torch(x[0], wr), topk)
    assert np.array_equal(ti.numpy(), np.asarray(idx))
    np.testing.assert_allclose(tg.numpy(), np.asarray(gates), atol=1e-6)
    assert abs(ta.item() - float(aux)) < 1e-6
    assert tg.dtype == torch.float32 and ta.dtype == torch.float32


def test_route_breaks_ties_like_jax_top_k():
    """Equal probabilities go to the lower expert first, as jax.lax.top_k
    orders them: a router with repeated columns and inputs that sit exactly
    on the ties (all-equal logits, pairs of equal logits)."""
    rng = np.random.default_rng(1)
    base = rng.standard_normal((8, 3)).astype(np.float32)
    wr = np.concatenate([base, base, base[:, :2]], axis=1)  # experts 0-2 = 3-5, 6-7 = 0-1
    x = rng.standard_normal((20, 8)).astype(np.float32)
    x[:4] = 0.0  # every logit 0: eight-way ties
    for topk in (2, 3, 5):
        gates, idx, aux = jmoe.route(*_jax(x, wr), topk)
        tg, ti, ta = moe.route(*_torch(x, wr), topk)
        assert np.array_equal(ti.numpy(), np.asarray(idx)), topk
        assert np.array_equal(ti[:4].numpy(), np.tile(np.arange(topk), (4, 1)))
        np.testing.assert_allclose(tg.numpy(), np.asarray(gates), atol=1e-6)
        assert abs(ta.item() - float(aux)) < 1e-6


@pytest.mark.parametrize("capacity", [1, 3, 8, 40])
def test_bucket_positions_equal_jax(capacity):
    """Slots and keeps equal, every kept slot distinct, each drop clamped
    onto its bucket's last slot."""
    dst = np.random.default_rng(2).integers(0, 5, 90).astype(np.int64)
    slot, keep = jmoe._bucket_positions(jnp.asarray(dst, jnp.int32), 5, capacity)
    ts, tk = moe._bucket_positions(torch.from_numpy(dst), 5, capacity)
    assert np.array_equal(ts.numpy(), np.asarray(slot))
    assert np.array_equal(tk.numpy(), np.asarray(keep))
    kept = ts[tk].numpy()
    assert len(set(kept)) == len(kept)
    assert (ts[~tk].numpy() == dst[~tk.numpy()] * capacity + capacity - 1).all()


# ----------------------------------------------------------------- blocks
def _routes(x, wr, topk, cf):
    """Both packages' (idx, keep) for the scatter block's tokens."""
    n, d = x.shape[0] * x.shape[1], x.shape[2]
    e = wr.shape[1]
    cap = jmoe.moe_capacity(n, e, topk, cf)
    _, idx, _ = jmoe.route(*_jax(x.reshape(n, d), wr), topk)
    _, keep = jmoe._bucket_positions(idx.reshape(-1), e, cap)
    _, ti, _ = moe.route(*_torch(x.reshape(n, d), wr), topk)
    _, tk = moe._bucket_positions(ti.reshape(-1), e, cap)
    return (np.asarray(idx), np.asarray(keep)), (ti.numpy(), tk.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cap1.25", "cap0.5"])
@pytest.mark.parametrize("topk", [2, 4])
def test_scatter_block_matches_jax(topk, cf, dtype):
    """The same experts chosen and the same choices dropped (at 0.5 some
    are); y within 1e-5 in f32, within the dense family's bf16 rule in
    bf16; aux within 1e-6."""
    arrays = _block_inputs(3)
    (ji, jk), (ti, tk) = _routes(arrays[0], arrays[1], topk, cf)
    assert np.array_equal(ti, ji) and np.array_equal(tk, jk)
    assert cf > 1 or not jk.all()
    want, jaux = jmoe.moe_block_scatter(*_jax(*arrays, dtype=getattr(jnp, dtype)), topk,
                                        capacity_factor=cf)
    got, aux = moe.moe_block_scatter(*_torch(*arrays, dtype=getattr(torch, dtype)), topk,
                                     capacity_factor=cf)
    assert got.dtype == getattr(torch, dtype)
    tol = dict(atol=1e-5) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    assert abs(aux.item() - float(jaux)) < 1e-6


def test_dropped_choices_add_nothing():
    """At capacity 0.5 a token whose every choice is dropped leaves the
    block with y = 0 (its residual passes through), in both packages."""
    arrays = _block_inputs(4, s=48)
    _, (ti, tk) = _routes(arrays[0], arrays[1], 2, 0.5)
    none_kept = ~tk.reshape(-1, 2).any(-1)
    assert none_kept.any()
    got, _ = moe.moe_block_scatter(*_torch(*arrays), 2, capacity_factor=0.5)
    want, _ = jmoe.moe_block_scatter(*_jax(*arrays), 2, capacity_factor=0.5)
    assert (got.reshape(-1, 16)[torch.from_numpy(none_kept)] == 0).all()
    assert (np.asarray(want).reshape(-1, 16)[none_kept] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replicated_block_matches_jax(dtype):
    arrays = _block_inputs(5)
    want, jaux = jmoe.moe_block_replicated(*_jax(*arrays, dtype=getattr(jnp, dtype)), 2)
    got, aux = moe.moe_block_replicated(*_torch(*arrays, dtype=getattr(torch, dtype)), 2)
    tol = dict(atol=1e-5) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    assert abs(aux.item() - float(jaux)) < 1e-6


@pytest.mark.parametrize("mode", ["c2d", "replicated", "other"])
def test_moe_block_dispatch_matches_jax(mode):
    """With no mesh, ``c2d`` (and any mode but ``replicated``) takes the
    scatter and ``replicated`` the replicated block, in both packages."""
    arrays = _block_inputs(6)
    want, jaux = jmoe.moe_block(*_jax(*arrays), 2, mode=mode)
    got, aux = moe.moe_block(*_torch(*arrays), 2, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert abs(aux.item() - float(jaux)) < 1e-6
    path = moe.moe_block_replicated if mode == "replicated" else moe.moe_block_scatter
    assert torch.equal(got, path(*_torch(*arrays), 2)[0])


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cap1.25", "cap0.5"])
def test_scatter_block_gradients_match_jax_vjp(cf):
    """Every input's gradient of <y, ct> + 3 aux (the router's through the
    gates and the aux) against ``jax.vjp``; dropped choices pass none."""
    arrays = _block_inputs(7)
    ct = np.random.default_rng(8).standard_normal(arrays[0].shape).astype(np.float32)

    def jax_loss(*a):
        y, aux = jmoe.moe_block_scatter(*a, 2, capacity_factor=cf)
        return jnp.sum(y * ct) + 3.0 * aux

    want = jax.grad(jax_loss, argnums=tuple(range(5)))(*_jax(*arrays))
    ins = [t.requires_grad_() for t in _torch(*arrays)]
    y, aux = moe.moe_block_scatter(*ins, 2, capacity_factor=cf)
    got = torch.autograd.grad((y * torch.from_numpy(ct)).sum() + 3.0 * aux, ins)
    for name, g, w in zip(("x", "router", "wi", "wg", "wo"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL, err_msg=name)


def test_scatter_block_gradients_repeat_bit_for_bit():
    """Dispatch and combine are gathers both ways: two backwards give the
    same bits."""
    arrays = _block_inputs(9)
    out = []
    for _ in range(2):
        ins = [t.requires_grad_() for t in _torch(*arrays)]
        y, aux = moe.moe_block_scatter(*ins, 2, capacity_factor=0.5)
        out.append(torch.autograd.grad(y.square().sum() + aux, ins))
    assert all(torch.equal(a, b) for a, b in zip(*out))


# ----------------------------------------------------------------- models
@pytest.fixture(scope="module", params=ARCHS)
def smoke_f32(request):
    """An arch's smoke config in f32: the JAX config and weights, and the
    port's copy."""
    arch = request.param
    jcfg = jax_get_config(arch, smoke=True).replace(dtype=jnp.float32)
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
    jp, _ = jzoo.build_params(jcfg, 0)
    flat = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    return jcfg, jp, cfg, zoo.from_jax_params(cfg, flat, device="cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_from_jax_params_round_trip(smoke_f32):
    """Every JAX leaf, the router and experts included, comes back from
    ``to_jax_params`` with its shape and bits; the port's factory makes the
    same leaves and shapes."""
    jcfg, jp, cfg, model = smoke_f32
    back = zoo.to_jax_params(cfg, model)
    assert set(back) == set(jp)
    for k, v in jp.items():
        assert np.array_equal(back[k].numpy(), np.asarray(v)), k
    for leaf in ("router", "we_i", "we_g", "we_o"):
        assert f"blocks.{leaf}" in jp
    fresh = zoo.to_jax_params(cfg, zoo.build_params(cfg, 0, device="cpu"))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {k: v.shape for k, v in jp.items()}


def test_forward_and_loss_match_jax(smoke_f32):
    """Logits within 1e-4, the aux (the layers' mean) within 1e-6, and the
    loss (NLL + 0.01 aux) within 1e-5, over a 2 x 24 train batch."""
    jcfg, jp, cfg, model = smoke_f32
    spec = ("t", 24, 2, "train")
    jbatch = jzoo.make_batch(jcfg, jzoo.ShapeSpec(*spec), 4)
    batch = zoo.make_batch(cfg, zoo.ShapeSpec(*spec), 4, device="cpu")
    want, _, jaux = jzoo.forward(jcfg, jp, jbatch)
    got, _, aux = zoo.forward(cfg, model, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert abs(aux.item() - float(jaux)) < 1e-6 and aux.item() > 0
    jloss, jparts = jzoo.loss_fn(jcfg, jp, jbatch)
    loss, parts = zoo.loss_fn(cfg, model, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    np.testing.assert_allclose(parts["aux"].item(), float(jparts["aux"]), atol=1e-6)
    assert loss.item() == pytest.approx(parts["nll"].item() + zoo.AUX_LOSS_WEIGHT * aux.item())


def test_prefill_and_serve_steps_match_jax_teacher_forced(smoke_f32):
    """Prefill logits and the cache, then 6 teacher-forced decode steps
    into a session-sized cache (the block routes the batch's two rows each
    step): every step's logits within 1e-4."""
    jcfg, jp, cfg, model = smoke_f32
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
    assert set(tc) == set(jc) == {"k", "v"}
    zoo.forward(cfg, model, {"tokens": torch.from_numpy(toks)}, caches=tc, offset=0)
    jstep, tstep = jzoo.make_serve_step(jcfg), zoo.make_serve_step(cfg)
    for i in range(gen):
        tok = fed[:, i : i + 1]
        want, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(p + i))
        got, tc = tstep(model, tc, torch.from_numpy(tok), p + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, err_msg=f"step {i}")
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), atol=1e-5)


def test_replicated_mode_model_matches_jax():
    """granite smoke with ``c2d_embedding`` off takes the replicated block
    in both packages: logits within 1e-4."""
    arch = "granite-moe-1b-a400m"
    jcfg = jax_get_config(arch, smoke=True).replace(dtype=jnp.float32, c2d_embedding=False)
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32, c2d_embedding=False)
    jp, _ = jzoo.build_params(jcfg, 1)
    model = zoo.from_jax_params(cfg, {k: np.asarray(v, np.float32) for k, v in jp.items()}, "cpu")
    toks = _tokens(5, (2, 17), cfg.vocab)
    want, _, jaux = jzoo.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, _, aux = zoo.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert abs(aux.item() - float(jaux)) < 1e-6


def test_remat_gives_the_same_gradients_and_aux():
    """Checkpointed MoE blocks recompute the same forward: loss, aux and
    every gradient bit-identical with remat on and off."""
    cfg = get_config("granite-moe-1b-a400m", smoke=True).replace(dtype=torch.float32)
    batch = zoo.make_batch(cfg, zoo.ShapeSpec("t", 32, 2, "train"), 1, device="cpu")
    out = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        model = zoo.build_params(c, 0, device="cpu")
        params = zoo.model_params(model)
        for p in params.values():
            p.requires_grad_(True)
        loss, parts = zoo.loss_fn(c, model, batch)
        out.append((loss, parts["aux"], torch.autograd.grad(loss, list(params.values()))))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert all(torch.equal(a, b) for a, b in zip(out[0][2], out[1][2]))


# -------------------------------------------------------------- scheduler
@pytest.mark.parametrize("name", ["more_requests_than_slots", "max_new_one",
                                  "max_new_never_overshot", "late_arrivals"])
def test_scheduler_streams_equal_jax(name):
    """test_serving.py's four scenarios on granite smoke (f32): the streams
    equal the JAX scheduler's."""
    from test_torch_lm import _scenario

    arch = "granite-moe-1b-a400m"
    jcfg = jax_get_config(arch, smoke=True).replace(dtype=jnp.float32)
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
    jp, _ = jzoo.build_params(jcfg, 0)
    model = zoo.from_jax_params(cfg, {k: np.asarray(v, np.float32) for k, v in jp.items()}, "cpu")
    want, _ = _scenario(name, JaxScheduler, jcfg, jp, cfg.vocab)
    got, sched = _scenario(name, ServeScheduler, cfg, model, cfg.vocab)
    assert got == want
    assert sched.prefills == len(got)


def test_scheduler_with_drops_equals_jax(smoke_f32):
    """12 slots, ragged prompts and budgets, so decode groups run beside
    rows at other positions and each step routes 12 rows into a capacity of
    8 an expert: which rows are present decides the drops.  Each group's
    step routes every slot, as the JAX step does, and the other rows attend
    as they do there (over zeros past a reused slot's prompt, as the JAX
    scheduler's stripe write leaves them); the streams equal the JAX
    scheduler's, decode steps drop choices, and the caches end equal (1e-5)."""
    jcfg, jp, cfg, model = smoke_f32
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in rng.integers(3, 14, 16)]
    budgets = rng.integers(2, 9, 16)
    out, caches = [], []
    drops = []
    keep_of = moe._bucket_positions

    def counting(dst, n, cap):
        slot, keep = keep_of(dst, n, cap)
        drops.append((len(dst), int((~keep).sum())))
        return slot, keep

    for sched_cls, params, c in ((JaxScheduler, jp, jcfg), (ServeScheduler, model, cfg)):
        s = sched_cls(c, params, slots=12, t_max=32)
        for p, m in zip(prompts, budgets):
            s.submit(p, int(m))
        if sched_cls is ServeScheduler:
            moe._bucket_positions = counting
        try:
            out.append({r.rid: r.out for r in s.run()})
        finally:
            moe._bucket_positions = keep_of
        caches.append({k: np.asarray(v, np.float32) for k, v in s.cache.items()})
    assert out[1] == out[0]
    for name in ("k", "v"):
        np.testing.assert_allclose(caches[1][name], caches[0][name], atol=1e-5, err_msg=name)
    k = cfg.topk
    assert any(n == 12 * k and dropped for n, dropped in drops)


# --------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_cli_prints_its_json(arch):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--device", "cpu",
         "--batch", "2", "--prompt-len", "16", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["arch"] == get_config(arch, smoke=True).name and rec["generated"] == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_remote_embed_bit_identical(arch):
    from repro_torch.launch.serve import serve

    argv = ["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "12",
            "--gen", "5", "--seed", "1"]
    _, toks = serve(argv)
    remote, remote_toks = serve(argv + ["--remote-embed", "--embed-servers", "2"])
    assert np.array_equal(toks, remote_toks) and toks.shape == (2, 5)
    assert remote["embed_gathers"] > 0


def test_launch_serve_cuts_the_depth():
    """``--layers N`` serves the arch's first N layers (phi3.5-moe's card
    cell runs 8 of its 32)."""
    from repro_torch.launch.serve import serve

    argv = ["--arch", "phi3.5-moe-42b-a6.6b", "--device", "cpu", "--batch", "1",
            "--prompt-len", "8", "--gen", "2"]
    rec, _ = serve(argv + ["--layers", "1"])
    assert rec["layers"] == 1
    with pytest.raises(ValueError, match="layers"):
        serve(argv + ["--layers", "3"])
