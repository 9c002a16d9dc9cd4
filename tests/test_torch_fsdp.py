"""The port's FSDP (ZeRO-3) train step on four gloo ranks against the JAX
package's FSDP step, the port's ZeRO-1 step and its unsharded step.

One input set: the smoke configs of yi-9b, rwkv6-1.6b, hymba-1.5b,
granite-moe-1b-a400m, qwen2.5-14b and starcoder2-15b in f32, each with
microbatch 1 and 2, and yi-9b's with ``remat`` on (2, 2) (``REMAT``; every
smoke config runs without), weights from seed 0 (drawn once by the port
and handed to JAX), one ``train``-shape batch from numpy seed 7, AdamW at
lr 1e-3.

- The port: one 4-rank gloo job (``torch.multiprocessing``, a
  ``FileStore`` under the test's temporary directory) on the ``(2, 2)``
  and ``(1, 4)`` ``(data, model)`` meshes, each case's step run twice:
  ``make_train_step(cfg, opt, mesh=, fsdp=True)`` on ``layout(cfg, mesh,
  fsdp=True)``'s blocks and the ZeRO-1 step on ``layout(cfg, mesh)``'s.
  qwen2.5's smoke config has 5 heads: on both meshes its attention runs
  sequence parallel (``attend_sp``), the biases riding in
  ``copy_to_region``.
- JAX: two subprocesses on 4 host devices each, ``make_train_step(cfg, opt,
  mesh=, fsdp=True)`` on a mesh of ``AxisType.Auto`` axes with
  ``state_shardings(..., fsdp=True)`` and ``batch_shardings``,
  ``rwkv_chunk`` and ``ssm_chunk`` 0: every arch on both meshes with one
  microbatch, qwen2.5 and starcoder2 (whose configs take two) with two on
  (2, 2), and both remat cases (``JAX_CASES``).

Bounds (``tests/test_torch_sharded_train.py``'s): the loss within 1e-5
relative; each gradient, as the FSDP update takes it (reduced over the
data ranks) and gathered whole, within 1e-4 of its leaf's largest; every
weight, m and v within ``chip_smoke.train_step_bound`` of that gradient
bound and the two clip factors, plus f32's own rounding.  Against the
ZeRO-1 step, within f32's rounding: the same sums in another order where
microbatches accumulate (the gradient bound 1e-6 of a leaf's largest),
bit for bit with one microbatch.  granite-moe runs the ``small`` batch,
whose rank's tokens times topk fit one pair's capacity, so no pair
overflows and JAX's rule (ROADMAP T17) does not bite; against the
unsharded step it keeps the reference's bounds (loss 0.05, weights 5e-3).

Each rank's param, gradient and moment blocks have the shapes of
``fsdp_specs``' blocks, and a step's collective bytes a rank, by stage
(the train step's ``mark``) and kind, differ from the ZeRO-1 step's by
closed forms in those blocks.  A checkpoint saved from FSDP blocks
restores onto ZeRO-1 blocks and back bit for bit.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_fsdp.py``.
"""

import functools
import importlib.util
import math
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
RANKS = 4
ARCHS = ("yi-9b", "rwkv6-1.6b", "hymba-1.5b", "granite-moe-1b-a400m", "qwen2.5-14b",
         "starcoder2-15b")
MOE = "granite-moe-1b-a400m"
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
MBS = (1, 2)
B, S = 4, 32
# granite: a rank's tokens of a microbatch times topk fit one pair's capacity
SMALL = {"2x2": 2, "1x4": 1}  # rows a microbatch
SMALL_S = 8
LR, SEED, BATCH_SEED = 1e-3, 0, 7
LOSS_RTOL, GRAD_RTOL, ORDER_RTOL = 1e-5, 1e-4, 1e-6
REF_LOSS, REF_WEIGHT = 0.05, 5e-3  # tests/test_multidevice.py's sharded-step bounds
# yi with remat: the backward gathers each layer's blocks again inside
# checkpoint's recompute, and the gradients come from the recomputed graph
REMAT = "yi-9b"
CASES = ([(mesh, arch, mb, False) for mesh in MESHES for arch in ARCHS for mb in MBS]
         + [("2x2", REMAT, mb, True) for mb in MBS])
# JAX's side, one jit a case (~4 s of the fixture's time each): every arch
# on both meshes with one microbatch, the two archs whose configs take two
# microbatches with two on (2, 2), and the remat cases; the port's other
# two-microbatch cases are held to its unsharded and ZeRO-1 steps
JAX_CASES = [c for c in CASES if c[2] == 1 or c[3] or (
    c[0] == "2x2" and c[1] in ("qwen2.5-14b", "starcoder2-15b"))]
STAGES = ("fwd", "bwd", "opt")
KINDS = ("psum", "pmax", "all_gather", "all_to_all", "reduce_scatter")


def _case(mesh, arch, mb, remat=False) -> str:
    return f"{mesh}|{arch}|mb{mb}" + ("|remat" if remat else "")


def _shape(mesh: str, arch: str, mb: int, remat: bool = False) -> tuple[int, int]:
    return (SMALL[mesh] * mb, SMALL_S) if arch == MOE else (B, S)


def _cfg(arch, mb, remat=False):
    from repro_torch.configs import get_config

    return get_config(arch, smoke=True).replace(dtype=torch.float32, microbatch=mb, remat=remat)


def _batch(cfg, shape):
    from repro_torch.models import zoo

    return zoo.make_batch(cfg, zoo.ShapeSpec("t", shape[1], shape[0], "train"), BATCH_SEED,
                          device="cpu")


_JAX = r"""
import os, sys
# LLVM at -O0: a third less compile time for these one-call steps (XLA's
# graph passes run as before; only the machine code is less optimized)
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models.zoo import ShapeSpec, build_params, make_batch, make_train_step
from repro.optim import AdamW
from repro.sharding.partition import batch_shardings, rules_for_train, state_shardings
w = np.load(sys.argv[1])
cases, meshes, lr, seed = eval(sys.argv[3]), eval(sys.argv[4]), float(sys.argv[5]), int(sys.argv[6])
out = {}
for tag, (mesh_name, arch, mb, remat, b, s) in cases.items():
    mesh = jax.make_mesh(meshes[mesh_name], ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    cfg = get_config(arch, smoke=True).replace(dtype=jnp.float32, rwkv_chunk=0, ssm_chunk=0,
                                               microbatch=mb, remat=remat)
    _, axes = build_params(cfg, abstract=True)
    params = {k.split("|", 1)[1]: jnp.asarray(w[k]) for k in w.files if k.startswith(arch + "|")}
    opt = AdamW(lr=lr)
    batch = make_batch(cfg, ShapeSpec("t", s, b, "train"), seed)
    state = {"params": params, "opt": opt.init(params), "step": jnp.int32(0)}
    sh = state_shardings(params, axes, mesh, rules=rules_for_train(cfg, mesh), fsdp=True)
    step = jax.jit(make_train_step(cfg, opt, mesh=mesh, fsdp=True),
                   in_shardings=(sh, batch_shardings(batch, mesh)), out_shardings=(sh, None))
    st, m = step(state, batch)
    out[tag + "|loss"], out[tag + "|grad_norm"] = np.asarray(m["loss"]), np.asarray(m["grad_norm"])
    for k in params:
        for what, tree in (("params", st["params"]), ("m", st["opt"].m), ("v", st["opt"].v)):
            out[f"{tag}|{what}|{k}"] = np.asarray(tree[k])
np.savez(sys.argv[2], **out)
"""


def _unsharded(cfg, batch) -> dict:
    """The port's one-process step: loss, gradients, clip norm, and the
    weights and moments after it, by JAX name."""
    from repro_torch.models import zoo
    from repro_torch.optim import AdamW

    model = zoo.build_params(cfg, SEED, device="cpu")
    params = zoo.model_params(model)
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = zoo.loss_fn(cfg, model, batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for p in params.values():
        p.requires_grad_(False)
    opt = AdamW(lr=LR)
    state = {"params": model, "opt": opt.init(params), "step": 0}
    _, met = zoo.make_train_step(cfg, opt)(state, batch)
    return {"loss": loss.item(), "grad_norm": float(met["grad_norm"]),
            "grads": zoo.to_jax_params(cfg, grads),
            "params": zoo.to_jax_params(cfg, model), "m": zoo.to_jax_params(cfg, state["opt"].m),
            "v": zoo.to_jax_params(cfg, state["opt"].v)}


def _step(cfg, mesh, batch, fsdp: bool, rank: int) -> dict:
    """One step of the port on ``mesh`` from fresh weights and moments: its
    loss and clip norm, each rank's block shapes (params, the gradients
    the update takes, m), the collective bytes by stage and kind, and (rank
    0) the gathered gradients, weights, m and v by JAX name."""
    from repro_torch.models import zoo
    from repro_torch.optim import AdamW
    from repro_torch.sharding.partition import Layout

    lay = zoo.layout(cfg, mesh, fsdp=fsdp)
    model = zoo.shard_params(cfg, zoo.build_params(cfg, SEED, device="cpu"), mesh, lay)
    opt = AdamW(lr=LR)
    state = {"params": model, "opt": opt.init(zoo.model_params(model), constrain=lay),
             "step": 0}
    wire = {s: dict.fromkeys(KINDS, 0) for s in STAGES}
    bwd_wire = {s: dict.fromkeys(KINDS, 0) for s in STAGES}
    last = [dict.fromkeys(KINDS, 0), dict.fromkeys(KINDS, 0)]
    stage_of = {"forward": "fwd", "loss": "fwd", "backward": "bwd", "optimizer": "opt"}

    def mark(stage):  # the bytes each stage moved, by kind (its backward's too)
        now = (dict(mesh.bytes_by_kind), dict(mesh.bwd_bytes_by_kind))
        for tot, cur, prev in ((wire, now[0], last[0]), (bwd_wire, now[1], last[1])):
            for k in KINDS:
                tot[stage_of[stage]][k] += cur.get(k, 0) - prev.get(k, 0)
        last[:] = [dict(now[0]), dict(now[1])]

    reduced, reduce_grad = {}, Layout.reduce_grad
    Layout.reduce_grad = lambda self, name, g: reduced.setdefault(
        name, reduce_grad(self, name, g))
    mesh.reset_counters()
    try:
        _, met = zoo.make_train_step(cfg, opt, mark=mark, mesh=mesh, fsdp=fsdp)(state, batch)
    finally:
        Layout.reduce_grad = reduce_grad
    out = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
           "wire": wire, "bwd_wire": bwd_wire,
           "shapes": {what: {k: tuple(t.shape) for k, t in tree.items()}
                      for what, tree in (("params", zoo.model_params(model)), ("grads", reduced),
                                         ("m", state["opt"].m), ("v", state["opt"].v))}}
    after = {"grads": zoo.gather_params(cfg, reduced, mesh, lay, moments=True),
             "params": zoo.gather_params(cfg, model, mesh, lay),
             "m": zoo.gather_params(cfg, state["opt"].m, mesh, lay, moments=True),
             "v": zoo.gather_params(cfg, state["opt"].v, mesh, lay, moments=True)}
    if rank == 0:
        out.update({k: zoo.to_jax_params(cfg, v) for k, v in after.items()})
    return out


def _ckpt_specs(lay) -> dict:
    """Each checkpoint leaf's spec under ``lay``, by leaf name (a stacked
    ``blocks.*`` leaf's layer dim whole), as ``restore_state(specs=)``
    takes them."""
    stack = lambda key, spec: (None, *spec) if key.startswith("blocks.") else spec  # noqa: E731
    out = {f"params.{k}": stack(k, spec) for k, spec in lay.params.items()}
    for i in (0, 1):  # m and v, under OptState's flat indices
        out |= {f"opt'][<flat index {i}>]['{k}": stack(k, spec) for k, spec in lay.moments.items()}
    return out


def _round_trip(mesh, out_dir: Path) -> dict:
    """yi smoke on (2, 2): an FSDP state after one step, saved whole,
    restored onto ZeRO-1 blocks (a ``TrainDriver`` on the mesh), saved
    again, restored onto FSDP blocks with ``restore_state(specs=)`` and
    ``layout(cfg, mesh, fsdp=True)``'s specs.  Every block of each restore
    against the blocks it should be."""
    from repro_torch.checkpoint import restore_state, save_state
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import zoo
    from repro_torch.optim import OptState
    from repro_torch.runtime.driver import TrainDriver
    from repro_torch.sharding.partition import full_leaf, leaf_key, local_block

    cfg = get_config("yi-9b", smoke=True)
    data = DataConfig(seq_len=16, global_batch=4, vocab=cfg.vocab)
    drv = TrainDriver(cfg, out_dir / "rt_zero1", mesh=mesh, data=data, device="cpu")
    lay = zoo.layout(cfg, mesh, fsdp=True)

    def fsdp_state() -> dict:
        model = zoo.shard_params(cfg, zoo.build_params(cfg, SEED, device="cpu"), mesh, lay)
        return {"params": model, "step": 0,
                "opt": drv.opt.init(zoo.model_params(model), constrain=lay)}

    def whole(named: dict, specs: dict) -> dict:
        return zoo.to_jax_params(cfg, {n: full_leaf(t, specs[leaf_key(n)], mesh)
                                       for n, t in named.items()})

    state = fsdp_state()
    zoo.make_train_step(cfg, drv.opt, mesh=mesh, fsdp=True)(state, TokenPipeline(data).batch_at(0))
    opt = state["opt"]
    save_state(out_dir / "rt", {
        "params": whole(zoo.model_params(state["params"]), lay.params),
        "opt": OptState(m=whole(opt.m, lay.moments), v=whole(opt.v, lay.moments),
                        count=opt.count),
        "step": 1}, 1, mesh=mesh)
    res = {}
    z_state = drv.init_state()
    tree, _ = restore_state(out_dir / "rt", drv.like(z_state), device="cpu", specs=drv.specs(),
                            mesh=mesh)
    drv.load_tree(z_state, tree)
    # the ZeRO-1 blocks are the saved leaves' blocks under the ZeRO-1 specs
    saved, _ = restore_state(out_dir / "rt", drv.like(z_state), device="cpu")
    named = zoo.from_jax_names(cfg, saved["params"])
    res["zero1_params_equal"] = all(
        torch.equal(p, local_block(named[k], drv.lay.params[leaf_key(k)], mesh))
        for k, p in zoo.model_params(z_state["params"]).items())
    save_state(out_dir / "rt", drv.tree(z_state), 2, mesh=mesh)
    back = fsdp_state()
    tree, _ = restore_state(out_dir / "rt", drv.like(back), step=2, device="cpu",
                            specs=_ckpt_specs(lay), mesh=mesh)
    drv.load_tree(back, tree)
    pairs = [(zoo.model_params(state["params"]), zoo.model_params(back["params"])),
             (state["opt"].m, back["opt"].m), (state["opt"].v, back["opt"].v)]
    res["fsdp_equal"] = all(torch.equal(a[k], b[k]) for a, b in pairs for k in a)
    res["step"] = (int(back["step"]), int(back["opt"].count))
    return res


def _rank(rank: int, store: str, out_dir: str) -> None:
    from repro_torch.models import transformer
    from repro_torch.sharding import init_mesh

    torch.set_num_threads(1)
    calls = {"attend_sp": 0}
    attend_sp = transformer.attend_sp

    def counted(*a, **kw):
        calls["attend_sp"] += 1
        return attend_sp(*a, **kw)

    transformer.attend_sp = counted
    meshes = {name: init_mesh(shape, ("data", "model"), device="cpu", backend="gloo", rank=rank,
                              init_method=f"file://{store}", timeout=timedelta(seconds=180))
              for name, shape in MESHES.items()}
    res = {}
    for mesh_name, arch, mb, remat in CASES:
        mesh, cfg = meshes[mesh_name], _cfg(arch, mb, remat)
        batch = _batch(cfg, _shape(mesh_name, arch, mb))
        calls["attend_sp"] = 0
        got = {"fsdp": _step(cfg, mesh, batch, True, rank)}
        got["attend_sp"] = calls["attend_sp"]
        got["zero1"] = _step(cfg, mesh, batch, False, rank)
        res[_case(mesh_name, arch, mb, remat)] = got
    transformer.attend_sp = attend_sp
    res["round_trip"] = _round_trip(meshes["2x2"], Path(out_dir))
    meshes["2x2"].close()  # the one process group under every mesh
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port, jax)``: ``port[r]`` the results of rank ``r`` by case (rank
    0's with the unsharded step's under ``"unsharded"``)."""
    from repro_torch.models import zoo

    tmp = tmp_path_factory.mktemp("fsdp")
    weights = {}
    for arch in ARCHS:
        cfg = _cfg(arch, 1)
        for k, v in zoo.to_jax_params(cfg, zoo.build_params(cfg, SEED, device="cpu")).items():
            weights[f"{arch}|{k}"] = v.numpy()
    np.savez(tmp / "w.npz", **weights)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jax_side = [subprocess.Popen(  # JAX's cases in two processes, beside the ranks
        [sys.executable, "-c", _JAX, str(tmp / "w.npz"), str(tmp / f"jax{i}.npz"),
         repr({_case(*c): (*c, *_shape(*c)) for c in JAX_CASES[i::2]}), repr(MESHES), str(LR),
         str(BATCH_SEED)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    threads = torch.get_num_threads()
    try:
        ranks = torch.multiprocessing.spawn(_rank, args=(str(tmp / "store"), str(tmp)),
                                            nprocs=RANKS, join=False)
        torch.set_num_threads(2)  # the unsharded steps, here while the ranks run
        refs = {}
        for c in CASES:
            cfg = _cfg(*c[1:])
            refs[_case(*c)] = _unsharded(cfg, _batch(cfg, _shape(*c)))
        while not ranks.join():
            pass
    finally:
        torch.set_num_threads(threads)
        errs = [p.communicate(timeout=900)[1] for p in jax_side]
    for p, err in zip(jax_side, errs):
        assert p.returncode == 0, err[-3000:]
    port = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    for tag, ref in refs.items():
        port[0][tag]["unsharded"] = ref
    jx = [np.load(tmp / f"jax{i}.npz") for i in range(2)]
    return port, {k: j[k] for j in jx for k in j.files}


@pytest.fixture(autouse=True)
def one_thread():
    """Each test's checks on one intra-op thread: the leaves are small, and
    a pool of threads beside the other test processes of a parallel run
    slows each small op many times over."""
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


def _hold_step(got: dict, want: dict, grads: dict, got_norm: float, want_norm: float,
               what: str, rtol: float = GRAD_RTOL) -> None:
    """Every weight, m and v of ``got`` within train_step_bound of
    ``want``'s, the gradient bound ``rtol`` of each leaf's largest."""
    bound_of = _chip_smoke().train_step_bound
    scale = min(1.0, 1.0 / want_norm)
    dscale = abs(min(1.0, 1.0 / got_norm) - scale)
    for name, g in grads.items():
        g = torch.as_tensor(np.asarray(g))
        bounds = bound_of(g, rtol * float(g.abs().max()), scale, dscale, LR)
        for i, kind in enumerate(("m", "v", "params")):
            ref = torch.as_tensor(np.asarray(want[kind][name])).double()
            lim = bounds[i] + 1e-6 * ref.abs() + (LR * 1e-6 if kind == "params" else 1e-12)
            diff = (torch.as_tensor(np.asarray(got[kind][name])).double() - ref).abs()
            assert bool((diff <= lim).all()), (what, kind, name, float(diff.max()))


def _jax_tree(jx: dict, tag: str) -> dict:
    out = {"params": {}, "m": {}, "v": {}}
    for k, v in jx.items():
        what, _, name = k.removeprefix(tag + "|").partition("|")
        if k.startswith(tag + "|") and what in out:
            out[what][name] = v
    return out


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: _case(*c))
def test_fsdp_step_matches_jax(runs, case):
    port, jx = runs
    tag = _case(*case)
    got = port[0][tag]["fsdp"]
    losses = [port[r][tag]["fsdp"]["loss"] for r in range(RANKS)]
    assert len(set(losses)) == 1, losses  # every rank reports the whole loss
    j_loss, j_norm = float(jx[tag + "|loss"]), float(jx[tag + "|grad_norm"])
    assert abs(got["loss"] - j_loss) <= LOSS_RTOL * abs(j_loss), (got["loss"], j_loss)
    _hold_step(got, _jax_tree(jx, tag), got["grads"], got["grad_norm"], j_norm, tag)


@pytest.mark.parametrize("case", CASES, ids=lambda c: _case(*c))
def test_fsdp_step_matches_the_zero1_step(runs, case):
    """The same sums as the ZeRO-1 step: with one microbatch bit for bit;
    with two, each microbatch's gradient reduced before the f32 sum instead
    of after, within f32's rounding of that order."""
    port, _ = runs
    tag = _case(*case)
    got, want = port[0][tag]["fsdp"], port[0][tag]["zero1"]
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    for name, g in want["grads"].items():
        err = float((got["grads"][name] - g).abs().max())
        assert err <= ORDER_RTOL * float(g.abs().max()), (name, err)
    _hold_step(got, want, want["grads"], got["grad_norm"], want["grad_norm"], tag, ORDER_RTOL)
    same = all(torch.equal(got[k][n], want[k][n]) for k in ("params", "m", "v")
               for n in want[k])
    print(f"{tag}: FSDP and ZeRO-1 weights, m and v bit-equal: {same}")
    if case[2] == 1:
        assert same and got["loss"] == want["loss"]


@pytest.mark.parametrize("case", CASES, ids=lambda c: _case(*c))
def test_fsdp_step_matches_the_unsharded_step(runs, case):
    port, _ = runs
    tag = _case(*case)
    got, want = port[0][tag]["fsdp"], port[0][tag]["unsharded"]
    if case[1] == MOE:  # the sharded dispatch buckets by pair, the unsharded by expert
        assert abs(got["loss"] - want["loss"]) < REF_LOSS
        for name, w in want["params"].items():
            assert float((got["params"][name] - w).abs().max()) < REF_WEIGHT, name
        return
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    for name, g in want["grads"].items():
        err = float((got["grads"][name] - g).abs().max())
        assert err <= GRAD_RTOL * float(g.abs().max()), (name, err)
    _hold_step(got, want, want["grads"], got["grad_norm"], want["grad_norm"], tag)


def _specs(arch: str, mesh: str) -> tuple[dict, dict, dict, object]:
    """``(shapes, fsdp, tp, mesh)``: a layer's leaves (and the others) and
    their ``fsdp_specs`` and TP specs on ``mesh`` (a ``MeshShape``)."""
    from repro_torch.models import zoo
    from repro_torch.sharding import partition as pt

    cfg = _cfg(arch, 1)
    m = pt.MeshShape(MESHES[mesh], ("data", "model"))
    shapes, axes = zoo._leaves(cfg)
    rules = pt.rules_for_train(cfg, m)
    return (shapes, pt.fsdp_specs(shapes, axes, m, rules), pt.param_specs(shapes, axes, m, rules),
            m)


@pytest.mark.parametrize("case", CASES, ids=lambda c: _case(*c))
def test_fsdp_blocks_are_the_fsdp_specs_blocks(runs, case):
    """Each rank's params, the gradients its update takes, and its m and v
    are ``fsdp_specs``' blocks; on (2, 2) the data axis cuts them."""
    from repro_torch.sharding.partition import block_shape, leaf_key

    port, _ = runs
    tag = _case(*case)
    shapes, fsdp, tp, m = _specs(case[1], case[0])
    want = {k: block_shape(s, fsdp[k], m) for k, s in shapes.items()}
    for r in range(RANKS):
        got = port[r][tag]["fsdp"]["shapes"]
        for what in ("params", "grads", "m", "v"):
            assert set(got[what]) == set(got["params"])
            for name, shape in got[what].items():
                assert shape == want[leaf_key(name)], (r, what, name, shape)
    cut = [k for k in shapes if fsdp[k] != tp[k]]
    assert len(cut) > len(shapes) // 2, cut
    if MESHES[case[0]][0] > 1:
        assert all(math.prod(want[k]) < math.prod(block_shape(shapes[k], tp[k], m))
                   for k in cut)


def _fsdp_bytes(arch: str, mesh: str) -> dict:
    """What FSDP adds and takes away against ZeRO-1, bytes a rank (f32), by
    the leaves ``fsdp_specs`` cuts over the data axes (a data axis of one
    rank too: the collective runs over its group of one and counts):
    ``gather`` each one's block (a microbatch's forward all-gather, and
    ZeRO-1's all-gather after the update), ``regather`` the layers' part of
    it (what remat's recompute gathers again in a microbatch's backward;
    the table, ``final_ln`` and the head are gathered outside the
    checkpointed blocks), ``scatter`` each one's TP block (a microbatch's
    backward reduce-scatter, and ZeRO-1's in the update)."""
    from repro_torch.sharding.partition import block_shape

    shapes, fsdp, tp, m = _specs(arch, mesh)
    layers = _cfg(arch, 1).n_layers
    cut = [k for k in shapes if fsdp[k] != tp[k]]
    count = {k: layers if k.startswith("blocks.") else 1 for k in cut}
    gather = {k: count[k] * math.prod(block_shape(shapes[k], fsdp[k], m)) * 4 for k in cut}
    return {"gather": sum(gather.values()),
            "regather": sum(b for k, b in gather.items() if k.startswith("blocks.")),
            "scatter": sum(count[k] * math.prod(block_shape(shapes[k], tp[k], m)) * 4
                           for k in cut)}


@pytest.mark.parametrize("case", CASES, ids=lambda c: _case(*c))
def test_fsdp_collective_bytes_equal_closed_forms(runs, case):
    """FSDP less ZeRO-1, a rank's bytes by stage and kind: the forward
    all-gathers ``mb`` x the cut leaves' blocks, the backward
    reduce-scatters ``mb`` x their TP blocks (all of it under
    ``bwd_bytes_by_kind``) and, with remat, all-gathers ``mb`` x the
    layers' blocks again in checkpoint's recompute (a forward's gather,
    not a backward ``Function``'s: none of it under ``bwd_bytes_by_kind``),
    and the update moves neither (ZeRO-1's reduce-scatter and all-gather
    there are gone); every other collective the same."""
    port, _ = runs
    tag = _case(*case)
    mb = case[2]
    want = _fsdp_bytes(case[1], case[0])
    for r in range(RANKS):
        f, z = port[r][tag]["fsdp"], port[r][tag]["zero1"]
        delta = {s: {k: f["wire"][s][k] - z["wire"][s][k] for k in KINDS} for s in STAGES}
        expect = {s: dict.fromkeys(KINDS, 0) for s in STAGES}
        expect["fwd"]["all_gather"] = mb * want["gather"]
        expect["bwd"]["reduce_scatter"] = mb * want["scatter"]
        expect["bwd"]["all_gather"] = mb * want["regather"] if case[3] else 0
        expect["opt"]["all_gather"] = -want["gather"]
        expect["opt"]["reduce_scatter"] = -want["scatter"]
        assert delta == expect, (r, delta, expect)
        assert f["wire"]["opt"]["all_gather"] == f["wire"]["opt"]["reduce_scatter"] == 0
        bwd = {s: {k: f["bwd_wire"][s][k] - z["bwd_wire"][s][k] for k in KINDS} for s in STAGES}
        assert bwd["bwd"]["reduce_scatter"] == mb * want["scatter"], (r, bwd)
        assert bwd["bwd"]["all_gather"] == 0, (r, bwd)


@pytest.mark.parametrize("mesh", MESHES)
def test_qwen_attention_is_sequence_parallel(runs, mesh):
    """qwen2.5 smoke's 5 heads divide neither mesh's model axis: each of
    its 2 layers runs attend_sp once a microbatch (no remat)."""
    port, _ = runs
    for mb in MBS:
        for r in range(RANKS):
            assert port[r][_case(mesh, "qwen2.5-14b", mb)]["attend_sp"] == 2 * mb


def test_fsdp_checkpoint_round_trip_is_bit_for_bit(runs):
    port, _ = runs
    for r in range(RANKS):
        rt = port[r]["round_trip"]
        assert rt["zero1_params_equal"] and rt["fsdp_equal"], (r, rt)
        assert rt["step"] == (1, 1)


def test_fsdp_without_zero1_raises():
    """FSDP params with moments at the TP specs is a layout JAX reaches only
    through GSPMD; the port refuses it."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.optim import AdamW
    from repro_torch.sharding import partition as pt

    cfg = get_config("yi-9b", smoke=True)
    mesh = pt.MeshShape((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="zero1"):
        zoo.layout(cfg, mesh, zero1=False, fsdp=True)
    with pytest.raises(ValueError, match="zero1"):
        zoo.make_train_step(cfg, AdamW(), mesh=mesh, zero1=False, fsdp=True)
    assert zoo.layout(cfg, mesh, fsdp=True).params == zoo.layout(cfg, mesh).moments
