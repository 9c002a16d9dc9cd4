"""The port's partition rules against the JAX package's, its collectives
that carry gradients against autograd of the unsharded functions, and the
checkpoint's reshard.

- Specs: every leaf of every config the port registers, full and smoke,
  on the ``(2, 2)``, ``(1, 4)``, ``(4, 1)`` and ``(2, 4)`` meshes, laid
  out on JAX ``AbstractMesh``\\es (no devices) and the port's
  :class:`~repro_torch.sharding.partition.MeshShape`: the logical axes
  and shapes (``logical_axes`` against ``build_params(abstract=True)``),
  ``spec_for`` under the default, serve and train rules,
  ``zero1_shardings``, ``fsdp_shardings`` and ``cache_shardings`` equal
  entry for entry, and the train layout's per-layer specs, ZeRO-1's and
  FSDP's, against JAX's stacked ones.
- Collectives: one 4-rank gloo job on a ``(2, 2)`` mesh; each
  differentiable collective inside a small function whose unsharded form
  runs in the same rank, gradients against autograd of that form within
  1e-6 of the leaf's largest (f32: the same products summed in other
  orders).
- Checkpoint: yi smoke cut on ``(2, 2)``, gathered and saved at step 3 by
  rank 0, restored onto ``(4, 1)``, ``(2, 2)`` and one rank: every block
  bit for bit, as the reference's elastic test holds it.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_partition.py``.
"""

from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import zoo
from repro_torch.sharding import partition as pt

ROOT = Path(__file__).resolve().parent.parent
RANKS = 4
MESHES = [(2, 2), (1, 4), (4, 1), (2, 4)]
NAMES = ("data", "model")
CACHE_B, CACHE_T = 8, 64


def _jax_side(arch, smoke, shape):
    import jax.numpy as jnp  # noqa: F401  (JAX_PLATFORMS is set by the suite)
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget
    from repro.models.zoo import build_params, init_kv_cache
    from repro.sharding import partition as jp

    cfg = jget(arch, smoke=smoke)
    mesh = AbstractMesh(shape, NAMES)
    p, axes = build_params(cfg, abstract=True)
    rules = {"default": jp.DEFAULT_RULES, "serve": jp.SERVE_RULES,
             "train": jp.rules_for_train(cfg, mesh)}
    out = {"shapes": {k: tuple(v.shape) for k, v in p.items()}, "axes": dict(axes)}
    for name, r in rules.items():
        out[name] = {k: tuple(jp.spec_for(tuple(v.shape), axes[k], mesh, r)) for k, v in p.items()}
    out["zero1"] = {k: tuple(s.spec) for k, s in
                    jp.zero1_shardings(p, axes, mesh, rules["train"]).items()}
    out["fsdp"] = {k: tuple(s.spec) for k, s in
                   jp.fsdp_shardings(p, axes, mesh, rules["train"]).items()}
    cache = init_kv_cache(cfg, CACHE_B, CACHE_T, as_specs=True)
    out["cache_shapes"] = {k: tuple(v.shape) for k, v in cache.items()}
    out["cache"] = {k: tuple(s.spec) for k, s in jp.cache_shardings(cache, mesh).items()}
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_jax(arch, smoke, shape):
    want = _jax_side(arch, smoke, shape)
    cfg = get_config(arch, smoke=smoke)
    mesh = pt.MeshShape(shape, NAMES)
    shapes, axes = zoo.logical_axes(cfg)
    assert shapes == want["shapes"] and axes == want["axes"]
    rules = {"default": pt.DEFAULT_RULES, "serve": pt.SERVE_RULES,
             "train": pt.rules_for_train(cfg, mesh)}
    for name, r in rules.items():
        assert pt.param_specs(shapes, axes, mesh, r) == want[name], name
    assert pt.zero1_specs(shapes, axes, mesh, rules["train"]) == want["zero1"]
    assert pt.fsdp_specs(shapes, axes, mesh, rules["train"]) == want["fsdp"]
    cache = zoo.init_kv_cache(cfg, CACHE_B, CACHE_T, dtype=torch.bfloat16, device="cpu") \
        if smoke else None
    cache_shapes = ({k: tuple(v.shape) for k, v in cache.items()} if cache is not None
                    else want["cache_shapes"])
    assert cache_shapes == want["cache_shapes"]
    assert pt.cache_specs(cache_shapes, mesh) == want["cache"]
    # the train layout a rank uses: a layer's leaves under JAX's spec less
    # its layers entry; the moments too, where JAX's do not cut the layers.
    # Where they do (no other free dim as large divides), the port's
    # per-layer leaf cuts its own largest free dim that divides, if any
    lay = zoo.layout(cfg, mesh)
    # the per-layer leaves: those JAX stacks along a leading "layers" axis
    stacked = {k for k, a in want["axes"].items() if a and a[0] == "layers"}
    for key, spec in lay.params.items():
        full = want["train"][key]
        assert spec == (full[1:] if key in stacked else full), key
    fsdp = zoo.layout(cfg, mesh, fsdp=True)
    assert fsdp.params == fsdp.moments == lay.moments and fsdp.tp == lay.params
    for kind, specs in (("zero1", lay.moments), ("fsdp", fsdp.params)):
        for key, spec in specs.items():
            full = want[kind][key]
            if key not in stacked:
                assert spec == full, (kind, key)
            elif not full or full[0] is None:
                assert spec == full[1:], (kind, key)
            else:
                own = pt.zero1_specs({key: shapes[key][1:]}, {key: axes[key][1:]}, mesh,
                                     rules["train"])
                assert spec == own[key], (kind, key)


def test_state_and_batch_specs():
    cfg = get_config("yi-9b", smoke=True)
    mesh = pt.MeshShape((2, 2), NAMES)
    shapes, axes = zoo.logical_axes(cfg)
    st = pt.state_specs(shapes, axes, mesh, pt.rules_for_train(cfg, mesh))
    assert st["params"] == pt.param_specs(shapes, axes, mesh, pt.rules_for_train(cfg, mesh))
    assert st["opt"].m == st["opt"].v == pt.zero1_specs(shapes, axes, mesh,
                                                       pt.rules_for_train(cfg, mesh))
    assert st["opt"].count == st["step"] == ()
    no = pt.state_specs(shapes, axes, mesh, zero1=False)
    assert no["opt"].m == no["params"]
    fs = pt.state_specs(shapes, axes, mesh, fsdp=True)
    assert fs["params"] == fs["opt"].m == pt.fsdp_specs(shapes, axes, mesh)
    assert pt.batch_specs({"tokens": (4, 8), "labels": (3, 8), "s": ()}, mesh) == {
        "tokens": ("data",), "labels": (), "s": ()}
    pod = pt.MeshShape((2, 2, 2), ("pod", "data", "model"))
    assert pt.batch_specs({"t": (8, 2)}, pod) == {"t": (("pod", "data"),)}
    assert pt.zero1_specs({"w": (8, 6)}, {"w": (None, None)}, pod) == {"w": (("pod", "data"),)}


def test_local_block():
    class Fake(pt.MeshShape):
        coords = {"data": 1, "model": 0}

        def axis_index(self, axes):
            axes = (axes,) if isinstance(axes, str) else axes
            i = 0
            for a in axes:
                i = i * self.shape[a] + self.coords[a]
            return i

    mesh = Fake((2, 2), NAMES)  # the rank at data 1, model 0
    x = torch.arange(4 * 8).reshape(4, 8)
    assert torch.equal(pt.local_block(x, ("data", "model"), mesh), x[2:4, 0:4])
    assert torch.equal(pt.local_block(x, (None, ("data", "model")), mesh), x[:, 4:6])
    assert pt.local_block(x, (), mesh) is x
    with pytest.raises(ValueError, match="does not split"):
        pt.local_block(torch.zeros(3, 2), ("data",), mesh)


def test_launch_mesh_shapes():
    from repro_torch.launch import mesh as lm

    assert lm.production_mesh_shape() == ((16, 16), ("data", "model"))
    assert lm.production_mesh_shape(multi_pod=True) == ((2, 16, 16), ("pod", "data", "model"))
    shape = pt.MeshShape(*lm.production_mesh_shape(multi_pod=True))
    assert lm.mesh_name(shape) == "2x16x16" and lm.n_devices(shape) == 512


# ----------------------------------------------------------- on 4 ranks
GRAD_D, GRAD_F, GRAD_S, GRAD_B = 8, 12, 8, 4


def inputs() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(28)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    return {"x": f(GRAD_B, GRAD_S, GRAD_D), "w1": f(GRAD_D, GRAD_F), "w2": f(GRAD_F, GRAD_D),
            "c": f(GRAD_B, GRAD_S, GRAD_D), "q": f(GRAD_B, GRAD_S, GRAD_D),
            "a2a": f(2, 2, 3, GRAD_D), "ca2a": f(2, 2, 3, GRAD_D)}


def _grads(fn, *leaves):
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves)


def _collective_cases(mesh, d: dict) -> dict:
    """Each case: (got, want) pairs of this rank's gradients."""
    from repro_torch.sharding import mesh as mm

    me, m = mesh.axis_index("model"), mesh.axis_size("model")
    f = GRAD_F // m
    res = {}
    # f / g: the MLP column then row parallel; the loss is whole on every rank
    full = lambda x, w1, w2: torch.sum(torch.relu(x @ w1) @ w2 * d["c"])  # noqa: E731
    _, want = _grads(full, d["x"], d["w1"], d["w2"])
    tp = lambda x, w1, w2: torch.sum(mm.reduce_from_region(  # noqa: E731
        torch.relu(mm.copy_to_region(x, mesh) @ w1) @ w2, mesh) * d["c"])
    _, got = _grads(tp, d["x"], d["w1"][:, me * f:(me + 1) * f], d["w2"][me * f:(me + 1) * f])
    res["copy_reduce"] = list(zip(got, (want[0], want[1][:, me * f:(me + 1) * f],
                                        want[2][me * f:(me + 1) * f])))
    # gather (the block's cotangent) and scatter (all-gathered back)
    s = GRAD_S // m
    blk = slice(me * s, (me + 1) * s)
    _, want = _grads(lambda x: torch.sum(torch.tanh(x) * d["c"]), d["x"])
    _, got = _grads(lambda x: torch.sum(torch.tanh(mm.gather_from_region(x, mesh, dim=1))
                                        * d["c"]), d["x"][:, blk])
    res["gather"] = [(got[0], want[0][:, blk])]
    _, got = _grads(lambda x: mm.reduce_from_region(torch.sum(
        torch.tanh(mm.scatter_to_region(x, mesh, dim=1)) * d["c"][:, blk]), mesh), d["x"])
    res["scatter"] = [(got[0], want[0])]
    # gather whose consumers see part of it (attend_sp's keys): the loss is
    # the sum over the ranks of each rank's queries' part
    def qk(q, k, c):  # the keys are the values too
        return torch.sum(torch.softmax(q @ k.transpose(1, 2), -1) @ k * c)

    _, want = _grads(lambda q, k: qk(q, k, d["c"]), d["q"], d["x"])
    _, got = _grads(lambda q, k: mm.reduce_from_region(
        qk(q, mm.gather_from_region(k, mesh, dim=1, partial=True), d["c"][:, blk]), mesh),
        d["q"][:, blk], d["x"][:, blk])
    res["gather_partial"] = list(zip(got, (want[0][:, blk], want[1][:, blk])))
    # reduce-scatter: rows of a row-parallel product cut over the model axis
    d_ = GRAD_D // m
    h = torch.relu(d["x"] @ d["w1"])
    _, want = _grads(lambda h, w2: torch.sum(torch.sin(h @ w2) * d["c"]), h, d["w2"])
    _, got = _grads(lambda h, w2: mm.reduce_from_region(torch.sum(torch.sin(
        mm.reduce_scatter_to_region(h @ w2, mesh, dim=-1))
        * d["c"][..., me * d_:(me + 1) * d_]), mesh), h[..., me * f:(me + 1) * f],
        d["w2"][me * f:(me + 1) * f])
    res["reduce_scatter"] = list(zip(got, (want[0][..., me * f:(me + 1) * f],
                                           want[1][me * f:(me + 1) * f])))
    # all_to_all: block j of rank i goes to rank j; the loss sums every rank's
    # received blocks times its weights; the unsharded form permutes them
    x_all, c_all = d["a2a"], d["ca2a"]  # (ranks, blocks, 3, D)
    want_x = torch.zeros_like(x_all)
    for i in range(m):
        for j in range(m):  # rank i's block j lands at rank j's slot i
            want_x[i, j] = -torch.sin(x_all[i, j]) * c_all[j, i]
    _, got = _grads(lambda x: mm.reduce_from_region(torch.sum(torch.cos(
        mm.all_to_all_region(x, mesh)) * c_all[me]), mesh), x_all[me])
    res["all_to_all"] = [(got[0], want_x[me])]
    return res


def _rank(rank: int, store: str, out_dir: str) -> None:
    from repro_torch.checkpoint import restore_state, save_state
    from repro_torch.sharding import init_mesh

    torch.set_num_threads(1)

    def mesh(shape):
        return init_mesh(shape, NAMES, device="cpu", backend="gloo", rank=rank,
                         init_method=f"file://{store}", timeout=timedelta(seconds=120))

    m22, m41 = mesh((2, 2)), mesh((4, 1))
    d = {k: torch.from_numpy(v) for k, v in inputs().items()}
    res = {"collectives": _collective_cases(m22, d)}
    m22.reset_counters()
    _collective_cases(m22, d)
    res["bwd_bytes"] = dict(m22.bwd_bytes_by_kind)
    # the reshard: cut on (2, 2), saved whole, restored onto (4, 1), (2, 2), one rank
    cfg = get_config("yi-9b", smoke=True)
    whole = zoo.model_params(zoo.build_params(cfg, 0, device="cpu"))
    model = zoo.shard_params(cfg, zoo.build_params(cfg, 0, device="cpu"), m22)
    tree = {"params": zoo.to_jax_params(cfg, zoo.gather_params(cfg, model, m22))}
    ck = Path(out_dir) / "ckpt"
    save_state(ck, tree, step=3, mesh=m22)
    shapes, axes = zoo.logical_axes(cfg)
    full = zoo.to_jax_params(cfg, whole)
    for name, m in (("4x1", m41), ("2x2", m22)):
        specs = pt.param_specs(shapes, axes, m, pt.rules_for_train(cfg, m))
        got, step = restore_state(ck, tree, specs={f"params.{k}": s for k, s in specs.items()},
                                  mesh=m)
        res[f"restore_{name}"] = (step, all(
            torch.equal(got["params"][k], pt.local_block(full[k], specs[k], m)) for k in full))
    got, step = restore_state(ck, tree)
    res["restore_one"] = (step, all(torch.equal(got["params"][k], full[k]) for k in full))
    m22.close()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partition")
    torch.multiprocessing.spawn(_rank, args=(str(tmp / "store"), str(tmp)), nprocs=RANKS,
                                join=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]


@pytest.mark.parametrize("case", ["copy_reduce", "gather", "scatter", "gather_partial",
                                  "reduce_scatter", "all_to_all"])
def test_collective_gradients_match_autograd(ranks, case):
    for r in range(RANKS):
        for i, (got, want) in enumerate(ranks[r]["collectives"][case]):
            bound = 1e-6 * float(want.abs().max())
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=bound,
                                       err_msg=f"rank {r} leaf {i}")


def test_backward_collectives_are_counted(ranks):
    """The backward's collectives, by kind, in ``bwd_bytes_by_kind`` (the
    psums of f's backward, the all-gathers of scatter's and of the
    reduce-scatter's, the reduce-scatter of the partial gather's, the
    all_to_all back)."""
    got = ranks[0]["bwd_bytes"]
    assert got["psum"] > 0 and got["all_gather"] > 0 and got["all_to_all"] > 0
    assert got["reduce_scatter"] > 0 and got["pmax"] == 0


@pytest.mark.parametrize("where", ["restore_4x1", "restore_2x2", "restore_one"])
def test_checkpoint_reshards_bit_for_bit(ranks, where):
    for r in range(RANKS):
        step, same = ranks[r][where]
        assert step == 3 and same, (r, where)
