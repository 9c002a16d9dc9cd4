"""The compiled SPMD rendering of the port against the JAX package's, on
four ranks on the CPU.

One input set, drawn with numpy from fixed seeds, goes through both sides:

- the port: one 4-rank gloo job (``torch.multiprocessing``, a ``FileStore``
  under the test's temporary directory, so parallel test workers never
  share a port), each rank passing its own shards;
- JAX: one subprocess on 4 host devices
  (``--xla_force_host_platform_device_count=4``).  ``compressed_psum_with_
  feedback`` runs there on a mesh of ``AxisType.Auto`` axes.  On
  ``jax.make_mesh``'s default Explicit axes it gives the same bits, but
  indexing its sharded result outside jit raises, which is what fails the
  reference's own test (ROADMAP §3).

Sizes are the reference's multidevice ones.  Tolerances: the int32
chases, the gathers and the embeddings exactly; the compressed psum's
``q``, error and result bit for bit (both sides run the same f32
operations in the same order, ``round`` is half-to-even in both, and the
error's ``g - q * scale`` is rounded once, as XLA fuses it under jit);
``hierarchical_psum`` within 1e-6 (f32 sums of 4 values in another order);
``moe_block_a2a`` within 1e-5 (the experts' products in other orders);
``attend_sp`` within 1e-5 of JAX's in f32 (the reference's own bound for
``attend_sp`` against ``attend``: softmax and products summed in another
order).

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_spmd.py``.
"""

import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.sharding import init_mesh

ROOT = Path(__file__).resolve().parent.parent
RANKS = 4
CHAIN_N, CHASES, DEPTH = 4096, 32, 17
GATHER_V, GATHER_D, GATHER_KEYS = 512, 16, 64
EMBED_V, EMBED_D, EMBED_IDS = 64, 16, (4, 8)
ATTN = (2, 16, 5, 8)  # B, S, H (= K), hd
# attend_sp cases: causal with window 7 and global, non-causal global (the
# kernel takes a window with causal masking only)
ATTN_CASES = {"causal_w7": (True, 7), "causal": (True, None), "full": (False, None)}
GRAD_W = 128
# moe_block_a2a on the (2, 2) mesh: tokens, capacity factor.  S = 8 splits
# over the 2 EP ranks (the a2a path; at 1.25 every pair's capacity holds all
# its choices, at 8.0 too, where the scatter keeps every choice as well);
# S = 1 cannot (the eplocal path); S = 64 at 0.25 overflows the pairs
MOE_D, MOE_E, MOE_F, MOE_K = 16, 8, 32, 2
MOE_CASES = {"moe_a2a": ("moe_x", 1.25), "moe_a2a_cap8": ("moe_x", 8.0),
             "moe_eplocal": ("moe_xd", 1.25), "moe_a2a_drops": ("moe_x64", 0.25)}


def inputs() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(22)
    perm = rng.permutation(CHAIN_N)
    chain = np.empty(CHAIN_N, np.int32)
    chain[perm] = np.roll(perm, -1)
    b, s, h, d = ATTN
    return {
        "chain": chain,
        "starts": rng.integers(0, CHAIN_N, CHASES).astype(np.int32),
        "etab": rng.normal(0, 1, (GATHER_V, GATHER_D)).astype(np.float32),
        "gkeys": rng.integers(0, GATHER_V, GATHER_KEYS).astype(np.int32),
        "vocab": rng.normal(0, 1, (EMBED_V, EMBED_D)).astype(np.float32),
        "ids": rng.integers(0, EMBED_V, EMBED_IDS).astype(np.int32),
        "q": rng.normal(0, 1, (b, s, h, d)).astype(np.float32),
        "k": rng.normal(0, 1, (b, s, h, d)).astype(np.float32),
        "v": rng.normal(0, 1, (b, s, h, d)).astype(np.float32),
        "hx": rng.normal(0, 1, (RANKS, GRAD_W)).astype(np.float32),
        "g1": rng.normal(0, 1, (RANKS, GRAD_W)).astype(np.float32),
        "g2": rng.normal(0, 3, (RANKS, GRAD_W)).astype(np.float32),
        "qx": rng.normal(0, 2, (RANKS, GRAD_W)).astype(np.float32),
        # the MoE dispatch: test_multidevice.py's widths and scales
        "moe_x": (rng.normal(0, 1, (2, 8, MOE_D)) * 0.5).astype(np.float32),
        "moe_wr": (rng.normal(0, 1, (MOE_D, MOE_E)) * 0.3).astype(np.float32),
        "moe_wi": (rng.normal(0, 1, (MOE_E, MOE_D, MOE_F)) * 0.3).astype(np.float32),
        "moe_wg": (rng.normal(0, 1, (MOE_E, MOE_D, MOE_F)) * 0.3).astype(np.float32),
        "moe_wo": (rng.normal(0, 1, (MOE_E, MOE_F, MOE_D)) * 0.3).astype(np.float32),
        "moe_xd": (rng.normal(0, 1, (8, 1, MOE_D)) * 0.5).astype(np.float32),
        "moe_x64": (rng.normal(0, 1, (2, 64, MOE_D)) * 0.5).astype(np.float32),
    }


_JAX = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.compat import shard_map
from repro.models.attention import attend, attend_sp
from repro.models.embedding import embed_c2d, embed_gather, embed_plain
from repro.sharding.collectives import (
    compressed_psum_with_feedback, dequantize_int8, hierarchical_psum, init_error_feedback,
    quantize_int8)
from repro.sharding.compute_to_data import dapc_shard_map, gather_shard_map, gbpc_reference

d = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
depth, cases = int(sys.argv[3]), eval(sys.argv[4])
out = {}
m14 = jax.make_mesh((1, 4), ("data", "model"))
out["dapc"] = dapc_shard_map(d["chain"], d["starts"], depth, m14)
out["gbpc"] = jax.jit(lambda t, s: gbpc_reference(t, s, depth, m14))(d["chain"], d["starts"])
out["gather"] = gather_shard_map(d["etab"], d["gkeys"], m14)
m22 = jax.make_mesh((2, 2), ("data", "model"))
out["embed_c2d"] = jax.jit(lambda t, i: embed_c2d(t, i, m22, batch_axes=("data",)))(
    d["vocab"], d["ids"])
out["embed_gather"] = jax.jit(lambda t, i: embed_gather(t, i, m22))(d["vocab"], d["ids"])
out["embed_plain"] = embed_plain(d["vocab"], d["ids"])
pos = jnp.arange(d["q"].shape[1])
for name, (causal, window) in cases.items():
    out["attend_sp_" + name] = jax.jit(lambda q, k, v: attend_sp(
        q, k, v, q_pos=pos, k_pos=pos, mesh=m22, batch_axes=("data",), causal=causal,
        window=window))(d["q"], d["k"], d["v"])
    out["attend_" + name] = attend(d["q"], d["k"], d["v"], q_pos=pos, k_pos=pos,
                                   causal=causal, window=window)
mpd = jax.make_mesh((2, 2), ("pod", "data"))
out["hier"] = shard_map(lambda x: hierarchical_psum(x, ("pod", "data")), mesh=mpd,
                        in_specs=P(("pod", "data")), out_specs=P(("pod", "data")))(d["hx"])
mp = jax.make_mesh((4,), ("pod",), axis_types=(AxisType.Auto,))

def body(g, e):
    o, ne = compressed_psum_with_feedback(g[0], e[0], "pod")
    return o[None], ne[None]

step = jax.jit(shard_map(body, mesh=mp, in_specs=(P("pod"), P("pod")),
                         out_specs=(P("pod"), P("pod"))))
out["cp_out1"], out["cp_err1"] = step(d["g1"], jnp.zeros_like(d["g1"]))
out["cp_out2"], out["cp_err2"] = step(d["g2"], out["cp_err1"])
# the reference test's mesh, jax.make_mesh's default (Explicit) axes: the
# function runs and matches; the test's own out[0] outside jit raises
o, _ = jax.jit(shard_map(body, mesh=jax.make_mesh((4,), ("pod",)), in_specs=(P("pod"), P("pod")),
                         out_specs=(P("pod"), P("pod"))))(d["g1"], jnp.zeros_like(d["g1"]))
out["explicit_out"] = o
try:
    o[0]
    out["explicit_index"] = np.array("ran")
except Exception as e:
    out["explicit_index"] = np.array(type(e).__name__)
q, scale = quantize_int8(d["qx"])
out["q8"], out["q8_scale"], out["dq8"] = q, scale, dequantize_int8(q, scale)
fb = init_error_feedback({"w": jnp.ones((3, 5), jnp.bfloat16)})["w"]
out["feedback"] = fb
from repro.models.moe import moe_block_a2a, moe_block_scatter
ma = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
w = [d[n] for n in ("moe_wr", "moe_wi", "moe_wg", "moe_wo")]
for name, (xk, cf) in eval(sys.argv[5]).items():
    out[name], out[name + "_aux"] = jax.jit(lambda x, *w: moe_block_a2a(
        x, *w, topk=int(sys.argv[6]), mesh=ma, capacity_factor=cf))(d[xk], *w)
out["moe_scatter"], out["moe_scatter_aux"] = moe_block_scatter(
    d["moe_x"], *w, int(sys.argv[6]), capacity_factor=8.0)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _rank(rank: int, store: str, out_dir: str) -> None:
    """One rank of the port's side: every case on its own shards."""
    from repro_torch.models import attend_sp, embed_c2d, embed_gather
    from repro_torch.models import attention
    from repro_torch.sharding import (
        compressed_psum_with_feedback, dapc_shard_map, gather_shard_map, gbpc_reference,
        hierarchical_psum, shard_rows,
    )

    torch.set_num_threads(1)
    d = {k: torch.from_numpy(v) for k, v in inputs().items()}
    res: dict = {}

    def mesh(shape, names):
        return init_mesh(shape, names, device="cpu", backend="gloo", rank=rank,
                         init_method=f"file://{store}", timeout=timedelta(seconds=120))

    def bytes_of(m, name, fn):
        m.reset_counters()
        res[name] = fn().numpy()
        res[name + "_bytes"] = dict(m.bytes_by_kind)

    m14 = mesh((1, 4), ("data", "model"))
    chain = shard_rows(d["chain"], m14)
    bytes_of(m14, "dapc", lambda: dapc_shard_map(chain, d["starts"], DEPTH, m14))
    bytes_of(m14, "gbpc", lambda: gbpc_reference(chain, d["starts"], DEPTH, m14))
    etab = shard_rows(d["etab"], m14)
    bytes_of(m14, "gather", lambda: gather_shard_map(etab, d["gkeys"], m14))

    m22 = mesh((2, 2), ("data", "model"))
    vocab, ids = shard_rows(d["vocab"], m22, "model"), shard_rows(d["ids"], m22, "data")
    bytes_of(m22, "embed_c2d", lambda: embed_c2d(vocab, ids, m22))
    bytes_of(m22, "embed_gather", lambda: embed_gather(vocab, ids, m22))
    qkv = [shard_rows(shard_rows(d[n], m22, "data"), m22, "model", dim=1) for n in "qkv"]
    pos = torch.arange(ATTN[1])
    seen = []
    flash = attention.flash_attention

    def record(q, k, v, **kw):  # the keys each rank hands the kernel
        seen.append((k.shape[1], k._is_view()))
        return flash(q, k, v, **kw)

    attention.flash_attention = record
    for name, (causal, window) in ATTN_CASES.items():
        bytes_of(m22, "attend_sp_" + name, lambda: attend_sp(
            *qkv, q_pos=pos, k_pos=pos, mesh=m22, causal=causal, window=window))
        res["attend_sp_keys_" + name] = seen.pop()
    attention.flash_attention = flash
    refused = {}
    for name, (qp, kp) in {"2d": (pos[None], pos[None]), "differ": (pos, pos + 1),
                           "strided": (2 * pos, 2 * pos), "short": (pos[:8], pos[:8]),
                           "off_host": (pos.to("meta"), pos.to("meta"))}.items():
        try:
            attend_sp(*qkv, q_pos=qp, k_pos=kp, mesh=m22)
        except ValueError:
            refused[name] = True
        else:
            refused[name] = False
    res["attend_sp_refused"] = refused

    from repro_torch.models import moe

    moe_w = [d["moe_wr"]] + [shard_rows(d[n], m22, "model") for n in ("moe_wi", "moe_wg",
                                                                          "moe_wo")]
    buckets = []  # each call's destinations and capacity
    bucket_positions = moe._bucket_positions
    moe._bucket_positions = lambda dst, n, cap: (buckets.append((dst.numpy(), cap)),
                                                 bucket_positions(dst, n, cap))[1]
    for name, (xk, cf) in MOE_CASES.items():
        x = shard_rows(d[xk], m22, "data")
        m22.reset_counters()
        y, aux = moe.moe_block_a2a(x, *moe_w, MOE_K, m22, capacity_factor=cf)
        res[name], res[name + "_aux"] = y.numpy(), aux.item()
        res[name + "_bytes"] = dict(m22.bytes_by_kind)
        res[name + "_buckets"] = buckets.pop() if buckets else None
    moe._bucket_positions = bucket_positions
    x = shard_rows(d["moe_x"], m22, "data")  # moe_block's c2d switch with a mesh: the a2a
    res["moe_block_mesh"] = moe.moe_block(x, *moe_w, MOE_K, mode="c2d", mesh=m22)[0].numpy()
    # a general all_to_all: blocks of dim 1 out, received blocks joined on dim 2
    res["a2a_dims"] = m22.all_to_all(_a2a_input(rank), "model", split_dim=1,
                                     concat_dim=2).numpy()

    mpd = mesh((2, 2), ("pod", "data"))
    bytes_of(mpd, "hier", lambda: hierarchical_psum({"x": [d["hx"][rank]]}, ("pod", "data"),
                                                    mpd)["x"][0])
    mp = mesh((4,), ("pod",))
    sent = []
    psum = mp.psum
    mp.psum = lambda x, axis: (sent.append(x.clone()), psum(x, axis))[1]
    err = torch.zeros(GRAD_W)
    for i, g in ((1, d["g1"][rank]), (2, d["g2"][rank])):
        mp.reset_counters()
        out, err = compressed_psum_with_feedback(g, err, "pod", mp)
        res[f"cp_out{i}"], res[f"cp_err{i}"] = out.numpy(), err.numpy()
        res[f"cp_q{i}"] = sent.pop().numpy()  # the int32 payload: this rank's q
        res[f"cp{i}_bytes"] = dict(mp.bytes_by_kind)
    mp.close()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides on the same inputs: ``(port, jax)``, ``port[r]`` the
    results of rank ``r``."""
    tmp = tmp_path_factory.mktemp("spmd")
    np.savez(tmp / "in.npz", **inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cases = repr(ATTN_CASES)
    jax_side = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp / "in.npz"), str(tmp / "jax.npz"), str(DEPTH),
         cases, repr(MOE_CASES), str(MOE_K)], env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        torch.multiprocessing.spawn(_rank, args=(str(tmp / "store"), str(tmp)), nprocs=RANKS,
                                    join=True)
    finally:
        _, err = jax_side.communicate(timeout=600)
    assert jax_side.returncode == 0, err[-3000:]
    port = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    return port, dict(np.load(tmp / "jax.npz"))


def _oracle_chase(table, starts, depth):
    f = starts.copy()
    for _ in range(depth):
        f = table[f]
    return f


@pytest.mark.parametrize("name", ["dapc", "gbpc"])
def test_chase_matches_jax_and_oracle(runs, name):
    port, jx = runs
    d = inputs()
    want = _oracle_chase(d["chain"], d["starts"], DEPTH)
    assert np.array_equal(jx[name], want)
    for r in range(RANKS):
        assert port[r][name].dtype == np.int32
        assert np.array_equal(port[r][name], want), r


def test_port_oracles_equal_numpy():
    from repro_torch.sharding import chase_oracle, gather_ref

    d = inputs()
    assert np.array_equal(chase_oracle(d["chain"], d["starts"], DEPTH),
                          _oracle_chase(d["chain"], d["starts"], DEPTH))
    assert np.array_equal(gather_ref(d["etab"], d["gkeys"]), d["etab"][d["gkeys"]])


def test_gather_shard_map_matches_jax_and_oracle(runs):
    port, jx = runs
    d = inputs()
    want = d["etab"][d["gkeys"]]
    assert np.array_equal(jx["gather"], want)
    for r in range(RANKS):
        assert np.array_equal(port[r]["gather"], want), r


@pytest.mark.parametrize("mode", ["embed_c2d", "embed_gather"])
def test_embedding_modes_match_jax_and_plain(runs, mode):
    """Rank (data i, model j) returns batch half i; both vocab ranks of a
    data group return the same rows."""
    port, jx = runs
    assert np.array_equal(jx[mode], jx["embed_plain"])
    half = EMBED_IDS[0] // 2
    for r in range(RANKS):
        i = r // 2
        assert np.array_equal(port[r][mode], jx[mode][i * half : (i + 1) * half]), r


def test_embed_tokens_dispatches_like_jax():
    from repro_torch.models import embed_tokens

    d = inputs()
    table, ids = torch.from_numpy(d["vocab"]), torch.from_numpy(d["ids"])
    want = d["vocab"][d["ids"]]
    for mode in ("plain", "auto", "gather", "c2d"):  # no mesh: every mode takes the table
        assert np.array_equal(embed_tokens(table, ids, mode).numpy(), want), mode


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attend_sp_matches_jax(runs, case):
    port, jx = runs
    got_jax, want = jx["attend_sp_" + case], jx["attend_" + case]
    assert np.max(np.abs(got_jax - want)) < 1e-5
    b_loc, s_loc = ATTN[0] // 2, ATTN[1] // 2
    for r in range(RANKS):
        i, j = divmod(r, 2)
        ref = got_jax[i * b_loc : (i + 1) * b_loc, j * s_loc : (j + 1) * s_loc]
        assert np.max(np.abs(port[r]["attend_sp_" + case] - ref)) < 1e-5, r


@pytest.mark.parametrize("rank", range(RANKS))
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attend_sp_hands_the_kernel_its_key_prefix(runs, case, rank):
    """Causal: model rank j passes the first (j + 1) S/2 keys, a view of the
    gathered K; non-causal: all S keys."""
    port, _ = runs
    keys, is_view = port[rank]["attend_sp_keys_" + case]
    causal, _ = ATTN_CASES[case]
    s_loc = ATTN[1] // 2
    if causal:
        assert (keys, is_view) == ((rank % 2 + 1) * s_loc, True)
    else:
        assert keys == ATTN[1]


@pytest.mark.parametrize("rank", range(RANKS))
def test_attend_sp_refuses_positions_it_cannot_mask(runs, rank):
    """Positions that are not one shared contiguous range, and positions
    that are not on the host (read there, so no call waits for the card)."""
    port, _ = runs
    assert port[rank]["attend_sp_refused"] == dict.fromkeys(
        ("2d", "differ", "strided", "short", "off_host"), True)


def _a2a_input(rank):
    return torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3) + 100 * rank


def test_all_to_all_splits_and_joins_any_dims(runs):
    """``Mesh.all_to_all(x, "model", split_dim=1, concat_dim=2)``: rank (i,
    j) receives block j of dim 1 from each rank of its model group, joined
    on dim 2 in the group's order (``jax.lax.all_to_all(..., tiled=True)``)."""
    port, _ = runs
    for r in range(RANKS):
        i, j = divmod(r, 2)
        want = np.concatenate([_a2a_input(2 * i + src).numpy()[:, 2 * j : 2 * j + 2]
                               for src in range(2)], axis=2)
        assert np.array_equal(port[r]["a2a_dims"], want), r


def test_moe_block_with_a_mesh_takes_the_a2a(runs):
    """``moe_block(..., mode="c2d", mesh=)`` with a ``model`` axis that
    divides the experts dispatches by all_to_all, as the JAX switch does."""
    port, _ = runs
    for r in range(RANKS):
        assert np.array_equal(port[r]["moe_block_mesh"], port[r]["moe_a2a"]), r


def _moe_block(name, r, y):
    """Rank r's block of the global y: batch rows of its data index, and on
    the a2a path (S splits over the 2 EP ranks) its half of the positions."""
    i, j = divmod(r, 2)
    b, s = y.shape[:2]
    rows = y[i * b // 2 : (i + 1) * b // 2]
    return rows if s < 2 else rows[:, j * s // 2 : (j + 1) * s // 2]


def _last_slot_of_a_full_pair(dst, cap):
    """The tokens (this rank's, flat) with a choice kept in the last slot of
    a (source, destination) pair that also dropped choices."""
    onehot = dst[:, None] == np.arange(dst.max() + 1)
    pos = np.take_along_axis(np.cumsum(onehot, 0) - 1, dst[:, None], 1)[:, 0]
    full = np.bincount(dst) > cap
    return sorted({c // MOE_K for c in np.flatnonzero((pos == cap - 1) & full[dst])})


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_a2a_matches_jax(runs, name):
    """The port's moe_block_a2a on 4 gloo ranks against JAX's on an Auto
    (2, 2) mesh: each rank's block within 1e-5 (f32; the experts' products
    in other orders), the aux (each rank's own, meaned over the EP axis and,
    on the a2a path, the data axis) within 1e-6 of JAX's.  On the eplocal
    path JAX means the aux over the EP axis only and returns data row 0's.

    Where a pair overflows (``moe_a2a_drops``), the reference's expert-id
    scatter (``meta.at[slot].set``) writes the dropped choices' invalid id
    onto the slot they are clamped to, the pair's last, which a kept choice
    holds; XLA:CPU applies the duplicate writes in order, so that kept
    choice runs no expert (ROADMAP.md section 3).  The port keeps it: the
    two differ exactly on the tokens that hold such a slot."""
    port, jx = runs
    for r in range(RANKS):
        want = _moe_block(name, r, jx[name])
        got = port[r][name]
        assert got.shape == want.shape, r
        lost = []
        if port[r][name + "_buckets"] is not None:
            lost = _last_slot_of_a_full_pair(*port[r][name + "_buckets"])
        assert bool(lost) == (name == "moe_a2a_drops"), (r, lost)
        flat_got, flat_want = got.reshape(-1, MOE_D), want.reshape(-1, MOE_D)
        off = np.flatnonzero(np.abs(flat_got - flat_want).max(-1) > 1e-5)
        assert off.tolist() == lost, (r, off, lost)
        np.testing.assert_allclose(np.delete(flat_got, lost, 0), np.delete(flat_want, lost, 0),
                                   atol=1e-5, err_msg=f"rank {r}")
    aux = [port[r][name + "_aux"] for r in range(RANKS)]
    assert abs(aux[0] - float(jx[name + "_aux"])) < 1e-6
    assert aux[0] == aux[1] and aux[2] == aux[3]
    if name != "moe_eplocal":
        assert aux[0] == aux[2]


def test_moe_a2a_matches_the_scatter_at_capacity_8(runs):
    """With room for every choice in both, the a2a dispatch and the port's
    one-process scatter take the same experts: within 1e-5 (the JAX test's
    own is 1e-4), the aux not (per-rank estimates meaned, against one over
    all tokens; the reference allows 0.2)."""
    from repro_torch.models.moe import moe_block_scatter

    port, jx = runs
    d = inputs()
    y, aux = moe_block_scatter(*(torch.from_numpy(d[n]) for n in (
        "moe_x", "moe_wr", "moe_wi", "moe_wg", "moe_wo")), MOE_K, capacity_factor=8.0)
    np.testing.assert_allclose(y.numpy(), jx["moe_scatter"], atol=1e-5)
    assert abs(aux.item() - float(jx["moe_scatter_aux"])) < 1e-6
    for r in range(RANKS):
        np.testing.assert_allclose(port[r]["moe_a2a_cap8"], _moe_block("moe_x", r, y.numpy()),
                                   atol=1e-5, err_msg=f"rank {r}")
    assert abs(port[0]["moe_a2a_cap8_aux"] - aux.item()) < 0.2


def test_hierarchical_psum_matches_jax(runs):
    port, jx = runs
    want = inputs()["hx"].sum(0)
    for r in range(RANKS):
        assert np.max(np.abs(jx["hier"][r] - want)) < 1e-5
        assert np.max(np.abs(port[r]["hier"] - jx["hier"][r])) < 1e-6, r


def _compressed_numpy(g, err):
    """The same f32 arithmetic in numpy: (q per rank, out, new err); the
    residual rounded once, as XLA's fused multiply-add rounds it under jit
    (exact in f64 first)."""
    g = g + err
    scale = np.maximum(np.abs(g).max(), np.float32(1e-12)) / np.float32(127.0)
    q = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
    new_err = (g.astype(np.float64) - q.astype(np.float64) * np.float64(scale)).astype(np.float32)
    out = q.astype(np.int32).sum(0).astype(np.float32) * scale
    return q, out, new_err


@pytest.mark.parametrize("step", [1, 2])
def test_compressed_psum_bit_identical_to_jax(runs, step):
    port, jx = runs
    d = inputs()
    err0 = np.zeros_like(d["g1"]) if step == 1 else jx["cp_err1"]
    q, out, new_err = _compressed_numpy(d[f"g{step}"], err0)
    assert np.array_equal(jx[f"cp_err{step}"], new_err)
    assert np.array_equal(jx[f"cp_out{step}"], np.broadcast_to(out, new_err.shape))
    for r in range(RANKS):
        assert np.array_equal(port[r][f"cp_q{step}"], q[r].astype(np.int32)), r
        assert np.array_equal(port[r][f"cp_err{step}"], jx[f"cp_err{step}"][r]), r
        assert np.array_equal(port[r][f"cp_out{step}"], jx[f"cp_out{step}"][r]), r
    exact = d[f"g{step}"].sum(0)
    assert np.abs(out - exact).max() / np.abs(exact).max() < 0.05


def test_jax_explicit_axes_fail_the_reference_test_not_the_function(runs):
    """The cause of the reference failure ``test_collectives.py::
    test_compressed_psum_shard_map``: on jax.make_mesh's default Explicit
    axes the function runs and gives the Auto axes' bits, but the test's
    ``out[0]`` on the pod-sharded result, outside jit, raises."""
    _, jx = runs
    assert np.array_equal(jx["explicit_out"], jx["cp_out1"])
    assert str(jx["explicit_index"]) == "ShardingTypeError"


def test_quantize_int8_bit_identical_to_jax(runs):
    from repro_torch.sharding import dequantize_int8, init_error_feedback, quantize_int8

    _, jx = runs
    q, scale = quantize_int8(torch.from_numpy(inputs()["qx"]))
    assert np.array_equal(q.numpy(), jx["q8"]) and q.dtype == torch.int8
    assert scale.item() == jx["q8_scale"].item()
    assert np.array_equal(dequantize_int8(q, scale).numpy(), jx["dq8"])
    fb = init_error_feedback({"w": torch.ones(3, 5, dtype=torch.bfloat16)})["w"]
    assert fb.dtype == torch.float32 and np.array_equal(fb.numpy(), jx["feedback"])


# the bytes each rank puts on the wire, in closed form
_B, _S, _H, _HD = ATTN


def _wire(psum=0, pmax=0, all_gather=0, all_to_all=0):
    return {"psum": psum, "pmax": pmax, "all_gather": all_gather, "all_to_all": all_to_all}


def _moe_wire(xk, cf):
    """moe_block_a2a's bytes a rank: the buckets there and back and their
    int32 expert ids, and the aux's two f32 means (EP, then data); on the
    eplocal path the (N, D) f32 partials' psum and the aux's EP mean."""
    b, s, _ = inputs()[xk].shape
    b_loc, m = b // 2, 2
    if s % m or s < m:
        return _wire(psum=b_loc * s * MOE_D * 4 + 4)
    c_pair = max(8, -(-int(b_loc * s // m * MOE_K * cf / m) // 8) * 8)
    return _wire(psum=2 * 4, all_to_all=m * c_pair * (2 * MOE_D * 4 + 4))


CLOSED_FORM = {
    "dapc": _wire(psum=DEPTH * CHASES * 4),
    "gbpc": _wire(all_gather=CHAIN_N // RANKS * 4),
    "gather": _wire(psum=GATHER_KEYS * GATHER_D * 4),
    "embed_c2d": _wire(psum=EMBED_IDS[0] // 2 * EMBED_IDS[1] * EMBED_D * 4),
    "embed_gather": _wire(all_gather=EMBED_V // 2 * EMBED_D * 4),
    **{"attend_sp_" + c: _wire(all_gather=2 * (_B // 2) * (_S // 2) * _H * _HD * 4)
       for c in ATTN_CASES},
    "hier": _wire(psum=2 * GRAD_W * 4),
    "cp1": _wire(psum=GRAD_W * 4, pmax=4),
    "cp2": _wire(psum=GRAD_W * 4, pmax=4),
    **{name: _moe_wire(xk, cf) for name, (xk, cf) in MOE_CASES.items()},
}


@pytest.mark.parametrize("name", list(CLOSED_FORM))
def test_collective_bytes_closed_form(runs, name):
    port, _ = runs
    for r in range(RANKS):
        assert port[r][name + "_bytes"] == CLOSED_FORM[name], r


def test_init_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_mesh((1,), ("model",))


@pytest.mark.parametrize("shape,cards", [((2,), 1), ((2, 2), 2), ((4,), 0)])
def test_init_mesh_nccl_refuses_more_ranks_than_cards(monkeypatch, shape, cards):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(ValueError, match="gloo"):
        init_mesh(shape, ("data", "model")[: len(shape)], device="cuda:0", backend="nccl")
    with pytest.raises(ValueError, match="gloo"):  # the card's default backend is nccl
        init_mesh(shape, ("data", "model")[: len(shape)], device="cuda:0")


def test_init_mesh_nccl_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA tensors only"):
        init_mesh((1,), ("model",), device="cpu", backend="nccl")
