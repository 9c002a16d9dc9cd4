"""qwen2.5-14b and starcoder2-15b, the two dense archs the port runs from
their configs alone, against the JAX package on the CPU.

qwen2.5 adds biases to the Q, K and V projections (``qkv_bias``) and a
RoPE base of 1e6; starcoder2 has an ungated tanh-gelu MLP (``act="gelu"``,
``mlp_gated=False``).  Both configs take two microbatches a train step.
The weights come from the JAX package's factory (seed 0), with qwen's
biases, which it draws as zeros, set to nonzero values from numpy seed 5 in
both packages, so that a bias added twice (or not at all) shows.

- Configs: ``get_config`` full and smoke equal JAX's field for field.
- Smoke configs in f32: ``forward``'s logits, a prompt prefilled into a
  session cache then 8 teacher-forced ``make_serve_step`` steps, and one
  ``make_train_step`` step, against the JAX package's (logits within
  1e-4; the loss within 1e-5 relative, every gradient within 1e-4 of its
  leaf's largest, every weight, m and v after the step within
  ``chip_smoke.train_step_bound``).
- Sharded serving: one 4-rank gloo job on the ``(2, 2)`` and ``(1, 4)``
  ``(data, model)`` meshes, weights cut by ``zoo.serve_layout``
  (``SERVE_RULES``), beside one JAX subprocess on 4 host devices
  (``param_shardings(..., rules=SERVE_RULES)``, ``cache_shardings``,
  ``batch_shardings`` on ``AxisType.Auto`` meshes), as
  ``tests/test_torch_sharded_serve.py`` runs the other families: a 4 x 16
  prompt into a session cache of 32 then 4 greedy decode steps, and the
  S == T prefill; each rank's logits (its rows, every vocab column)
  within 1e-4 of a row's largest of the port's unsharded steps and JAX's,
  with equal greedy tokens.  On the serving layout qwen's head dim 24 is
  cut mid-head over ``model`` (``SERVE_RULES`` has no head rule), so each
  rank gathers the Q, K and V columns after adding its own bias block once.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_dense_archs.py``.
"""

import functools
import importlib.util
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import zoo as jzoo
from repro.optim import AdamW as JaxAdamW
from repro_torch.configs import get_config
from repro_torch.models import zoo
from repro_torch.optim import AdamW

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("qwen2.5-14b", "starcoder2-15b")
BIASES = ("blocks.bq", "blocks.bk", "blocks.bv")
RANKS = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
MODES = ("session", "prefill")
B, S, T, STEPS = 4, 16, 32, 4
LR, BIAS_SEED, BATCH_SEED = 1e-3, 5, 7
ATOL, LOSS_RTOL, GRAD_RTOL, RTOL = 1e-4, 1e-5, 1e-4, 1e-4
SERVE_CASES = [(mesh, arch, mode) for mesh in MESHES for arch in ARCHS for mode in MODES]


def _configs(arch):
    jcfg = jax_get_config(arch, smoke=True).replace(dtype=jnp.float32)
    return jcfg, get_config(arch, smoke=True).replace(dtype=torch.float32)


def _flat(arch) -> dict[str, np.ndarray]:
    """The JAX factory's smoke weights (seed 0), qwen's biases nonzero."""
    jcfg, _ = _configs(arch)
    jp, _ = jzoo.build_params(jcfg, 0)
    flat = {k: np.array(v, np.float32) for k, v in jp.items()}
    rng = np.random.default_rng(BIAS_SEED)
    for k in BIASES:
        if k in flat:
            flat[k] = rng.standard_normal(flat[k].shape).astype(np.float32) * 0.1
    return flat


@pytest.fixture(scope="module", params=ARCHS)
def arch_f32(request):
    """``(arch, jcfg, jax params, cfg, port model)`` in f32."""
    arch = request.param
    jcfg, cfg = _configs(arch)
    flat = _flat(arch)
    return arch, jcfg, {k: jnp.asarray(v) for k, v in flat.items()}, cfg, \
        zoo.from_jax_params(cfg, flat, device="cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


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
    if not smoke:  # the size the configs are named for, the vocab padded
        n = sum(int(np.prod(s)) for s in shapes.values())
        assert round(n / 1e9, 2) == {"qwen2.5-14b": 14.79, "starcoder2-15b": 15.96}[arch]


def test_qwen_biases_are_nonzero_and_starcoder_has_none(arch_f32):
    arch, _, jp, _, model = arch_f32
    names = zoo.model_params(model)
    if arch == "qwen2.5-14b":
        assert all(float(jnp.abs(jp[k]).min()) > 0 for k in BIASES)
        assert torch.equal(names["blocks.1.bk"], torch.tensor(np.asarray(jp["blocks.bk"][1])))
    else:
        assert not any(".b" in k.rsplit(".", 1)[-1][:2] for k in names)
        assert "blocks.0.wg" not in names  # the ungated MLP: wi and wo2 only


def test_forward_matches_jax(arch_f32):
    _, jcfg, jp, cfg, model = arch_f32
    toks = _tokens(0, (2, 19), cfg.vocab)
    want, _, _ = jzoo.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, _, _ = zoo.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 19, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_and_decode_match_jax(arch_f32):
    """A prompt prefilled into a session cache, then 8 teacher-forced
    decode steps: every step's logits, and the caches after."""
    _, jcfg, jp, cfg, model = arch_f32
    b, p, gen, t_max = 2, 13, 8, 24
    toks, fed = _tokens(3, (b, p), cfg.vocab), _tokens(4, (b, gen), cfg.vocab)
    jc = jzoo.init_kv_cache(jcfg, b, t_max, dtype=jnp.float32)
    want, jc, _ = jzoo.forward(jcfg, jp, {"tokens": jnp.asarray(toks)}, caches=jc,
                               offset=jnp.int32(0))
    tc = zoo.init_kv_cache(cfg, b, t_max, dtype=torch.float32, device="cpu")
    got, tc, _ = zoo.forward(cfg, model, {"tokens": torch.from_numpy(toks)}, caches=tc, offset=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    jstep, tstep = jzoo.make_serve_step(jcfg), zoo.make_serve_step(cfg)
    for i in range(gen):
        tok = fed[:, i : i + 1]
        want, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(p + i))
        got, tc = tstep(model, tc, torch.from_numpy(tok), p + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=f"step {i}")
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """Each test's port calls and checks on one intra-op thread: the smoke
    tensors are small, and a pool of threads beside the other test
    processes of a parallel run slows each small op many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_step_matches_jax(arch_f32):
    """One step of each config (two microbatches) from the same weights and
    batch: the loss, the gradients of the whole batch's loss, and every
    weight, m and v after ``make_train_step`` against the JAX package's."""
    _, jcfg, jp, cfg, model = arch_f32
    assert cfg.microbatch == jcfg.microbatch == 2
    jbatch = jzoo.make_batch(jcfg, jzoo.ShapeSpec("t", 32, 4, "train"), BATCH_SEED)
    batch = {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}
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


# ----------------------------------------------------------- sharded serving
_JAX = r"""
import os, sys
# LLVM at -O0: a third less compile time for these one-call steps (XLA's
# graph passes run as before; only the machine code is less optimized)
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models.zoo import (ShapeSpec, _head, build_params, forward, init_kv_cache, make_batch,
                              make_prefill_step, make_serve_step)
from repro.sharding.partition import SERVE_RULES, batch_shardings, cache_shardings, param_shardings
w = np.load(sys.argv[1])
cases, meshes = eval(sys.argv[3]), eval(sys.argv[4])
b, s, t_max, steps, seed = (int(a) for a in sys.argv[5:10])
out = {}
for tag, (mesh_name, arch, mode) in cases.items():
    mesh = jax.make_mesh(meshes[mesh_name], ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    cfg = get_config(arch, smoke=True).replace(dtype=jnp.float32)
    _, axes = build_params(cfg, abstract=True)
    params = {k.split("|", 1)[1]: jnp.asarray(w[k]) for k in w.files if k.startswith(arch + "|")}
    p_sh = param_shardings(params, axes, mesh, rules=SERVE_RULES)
    batch = make_batch(cfg, ShapeSpec("p", s, b, "prefill"), seed)
    b_sh = batch_shardings(batch, mesh)
    t = t_max if mode == "session" else s
    c_sh = cache_shardings(init_kv_cache(cfg, b, t, dtype=jnp.float32), mesh)
    if mode == "session":
        def prefill(params, batch, cache):
            h, cache, _ = forward(cfg, params, batch, caches=cache, offset=jnp.int32(0),
                                  mesh=mesh, return_hidden=True)
            return _head(cfg, params, h[:, -1:, :])[:, -1, :], cache
        logits, cache = jax.jit(prefill, in_shardings=(p_sh, b_sh, c_sh),
                                out_shardings=(None, c_sh))(
            params, batch, init_kv_cache(cfg, b, t, dtype=jnp.float32))
    else:
        logits, cache = jax.jit(make_prefill_step(cfg, mesh=mesh), in_shardings=(p_sh, b_sh),
                                out_shardings=(None, c_sh))(params, batch)
    got = [np.asarray(logits)]
    if mode == "session":
        tok_sh = NamedSharding(mesh, P("data"))
        serve = jax.jit(make_serve_step(cfg, mesh=mesh), in_shardings=(p_sh, c_sh, tok_sh, None),
                        out_shardings=(None, c_sh))
        for i in range(steps):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            logits, cache = serve(params, cache, tok, jnp.int32(s + i))
            got.append(np.asarray(logits))
    out[tag] = np.stack(got)
np.savez(sys.argv[2], **out)
"""


def _case(mesh, arch, mode) -> str:
    return f"{mesh}|{arch}|{mode}"


@torch.no_grad()
def _steps(cfg, model, mode: str, mesh=None) -> torch.Tensor:
    """The prompt, then (``session``) greedy decode steps: each step's
    logits (a rank's rows with a mesh)."""
    batch = zoo.make_batch(cfg, zoo.ShapeSpec("p", S, B, "prefill"), BATCH_SEED, device="cpu")
    first, cache = zoo.make_prefill_step(cfg, mesh=mesh, t_max=T if mode == "session" else None)(
        model, batch)
    logits = [first]
    step = zoo.make_serve_step(cfg, mesh=mesh)
    for i in range(STEPS if mode == "session" else 0):
        tok = logits[-1].argmax(-1, keepdim=True).to(torch.int32)
        if mesh is not None:  # every row's token (the rank holds its rows' logits)
            tok = zoo.serve_layout(cfg, mesh).all_rows(tok, B)
        got, cache = step(model, cache, tok, S + i)
        logits.append(got)
    return torch.stack(logits)


def _port_model(arch: str, w: Path):
    flat = np.load(w)
    _, cfg = _configs(arch)
    return cfg, zoo.from_jax_params(cfg, {k.split("|", 1)[1]: flat[k] for k in flat.files
                                          if k.startswith(arch + "|")}, device="cpu")


def _rank(rank: int, store: str, out_dir: str) -> None:
    from repro_torch.sharding import init_mesh

    torch.set_num_threads(1)
    meshes = {name: init_mesh(shape, ("data", "model"), device="cpu", backend="gloo",
                              rank=rank, init_method=f"file://{store}",
                              timeout=timedelta(seconds=180))
              for name, shape in MESHES.items()}
    res = {}
    for mesh_name, arch, mode in SERVE_CASES:
        mesh = meshes[mesh_name]
        cfg, model = _port_model(arch, Path(out_dir) / "w.npz")
        lay = zoo.serve_layout(cfg, mesh)
        zoo.shard_params(cfg, model, mesh, lay)
        res[_case(mesh_name, arch, mode)] = {"logits": _steps(cfg, model, mode, mesh),
                                             "rows": lay.serve_rows(B)}
    meshes["2x2"].close()  # the one process group under every mesh
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``(port, unsharded, jax)``: ``port[r]`` rank ``r``'s logits by case,
    ``unsharded`` the one-process steps by (arch, mode), ``jax`` JAX's
    logits by case."""
    tmp = tmp_path_factory.mktemp("dense_serve")
    np.savez(tmp / "w.npz", **{f"{arch}|{k}": v for arch in ARCHS
                               for k, v in _flat(arch).items()})
    cases = {_case(*c): c for c in SERVE_CASES}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jax_side = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp / "w.npz"), str(tmp / "jax.npz"), repr(cases),
         repr(MESHES), *(str(x) for x in (B, S, T, STEPS, BATCH_SEED))],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    threads = torch.get_num_threads()
    try:
        ranks = torch.multiprocessing.spawn(_rank, args=(str(tmp / "store"), str(tmp)),
                                            nprocs=RANKS, join=False)
        torch.set_num_threads(2)  # the unsharded steps, here while the ranks run
        refs = {(arch, mode): _steps(*_port_model(arch, tmp / "w.npz"), mode)
                for arch in ARCHS for mode in MODES}
        while not ranks.join():
            pass
    finally:
        torch.set_num_threads(threads)
        _, err = jax_side.communicate(timeout=900)
    assert jax_side.returncode == 0, err[-3000:]
    port = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    jx = np.load(tmp / "jax.npz")
    return port, refs, {k: torch.from_numpy(jx[k]) for k in jx.files}


def _hold(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Each row's logits within RTOL of its largest, and equal greedy tokens."""
    err = (got - want).abs().amax(-1)
    lim = RTOL * want.abs().amax(-1)
    assert bool((err <= lim).all()), (what, float((err / lim).max()))
    assert torch.equal(got.argmax(-1), want.argmax(-1)), what


@pytest.mark.parametrize("case", SERVE_CASES, ids=lambda c: _case(*c))
def test_sharded_serving_matches_the_unsharded_steps_and_jax(served, case):
    port, refs, jx = served
    tag = _case(*case)
    whole = refs[case[1], case[2]]
    for r in range(RANKS):
        got, rows = port[r][tag]["logits"], port[r][tag]["rows"]
        _hold(got, whole[:, rows], f"{tag} rank {r} against the unsharded steps")
        _hold(got, jx[tag][:, rows], f"{tag} rank {r} against JAX")
