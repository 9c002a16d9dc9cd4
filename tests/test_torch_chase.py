"""The DAPC slice: the port's chase kernel, Chaser and PointerChaseApp
against the JAX package's.

Everything here is int32 — table entries, addresses, depths, action rows,
result words — so every comparison is exact: no tolerance anywhere.

* The plain ``chase_shard_ref`` (what the wrapper and the custom op run for
  a CPU tensor) equals the JAX ``chase_ref`` with ``max_hops = max(depth)``
  and the Pallas ``chase_shard`` (interpret mode) at settings where its
  block-sweep budget suffices, so a run-to-exit result is comparable.
* The shipped Chaser / ReturnResult / TSI / Spawner slices emit what the
  JAX slices emit on the same payloads.
* ``PointerChaseApp`` on both packages, tables made from one seed: results
  equal the numpy oracle, and every wire/dispatch counter equals the
  reference's — all but the code bytes, since a ``torch.export`` slice is
  larger than a StableHLO one.  The port's servers take the ``cuda-sm90``
  slice, so the kernel's custom op runs here through its plain version.
"""

import io
import operator
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Cluster as JaxCluster
from repro.core import DataPlaneConfig as JaxDataPlaneConfig
from repro.core import PointerChaseApp as JaxApp
from repro.core import PropagationConfig as JaxPropagationConfig
from repro.core import ReliabilityConfig as JaxReliabilityConfig
from repro.core import make_chaser as jax_make_chaser
from repro.core import make_return_result as jax_make_return_result
from repro.core import make_spawner as jax_make_spawner
from repro.core import make_tsi as jax_make_tsi
from repro.core.bitcode import deserialize_and_jit as jax_deserialize
from repro.kernels.chase.kernel import chase_shard as pallas_chase_shard
from repro.kernels.chase.ref import chase_ref as jax_chase_ref
from repro_torch.core import (
    PE,
    Cluster,
    DataPlaneConfig,
    Fabric,
    FrameKind,
    ISAMismatch,
    PointerChaseApp,
    PropagationConfig,
    ReliabilityConfig,
    Toolchain,
    chase_ref,
    make_chain,
    make_chaser,
    make_return_result,
    make_spawner,
    make_tsi,
)
from repro_torch.core.bitcode import deserialize_and_jit, load_program
from repro_torch.kernels import launch_counts
from repro_torch.kernels.chase import chase_shard, chase_shard_op, chase_shard_ref
from repro_torch.kernels.chase import kernel as chase_kernel

I32 = np.int32
N_SERVERS, N_ENTRIES, MAX_SLOTS, DEPTH = 4, 1024, 16, 64
# a RETURN is 8 bytes: zero-copy and rendezvous take it only at thresholds
# of 0 (the zero-copy cell of benchmarks/dapc.py)
ARMS = {
    "framed": None,
    "zerocopy": dict(zerocopy=True, eager_max=0),
    "rendezvous": dict(eager_max=0, rndv_min=0),
}
COUNTERS = (
    "puts", "gets", "get_bytes", "invokes", "coalesced_frames",
    "coalesced_payloads", "region_puts", "region_put_bytes", "hop_frames", "rounds",
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_counters(got, want):
    for name in COUNTERS:
        assert getattr(got, name) == getattr(want, name), name
    kinds = (set(got.wire_bytes_by_kind) | set(want.wire_bytes_by_kind)) - {"code"}
    for kind in kinds:
        assert got.wire_bytes_by_kind.get(kind, 0) == want.wire_bytes_by_kind.get(kind, 0), kind


# ------------------------------------------------------------------ kernel
@pytest.mark.parametrize("n_loc,b,lo", [(4096, 64, 8192), (2048, 128, 0), (1024, 32, 1024)])
def test_plain_matches_jax_chase_ref(n_loc, b, lo):
    """Random tables whose successors mostly leave the shard, as the JAX
    kernel sweep draws them; the JAX oracle runs ``max(depth)`` hops."""
    rng = np.random.default_rng(n_loc + b)
    table = rng.integers(0, 4 * n_loc, n_loc).astype(I32)
    frontier = rng.integers(0, 4 * n_loc, b).astype(I32)
    depth = rng.integers(0, 32, b).astype(I32)
    f, d = chase_shard_ref(_t(table), _t(frontier), _t(depth), lo)
    f_j, d_j = jax_chase_ref(
        jnp.asarray(table), jnp.asarray(frontier), jnp.asarray(depth), lo,
        max_hops=int(depth.max()),
    )
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_j))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("n_loc,b,lo,cycle", [
    (1024, 16, 0, True),  # one cycle inside the shard: every chase runs its depth
    (512, 64, 512, False),  # random successors in and out of the shard
])
def test_plain_matches_pallas_interpret(n_loc, b, lo, cycle):
    """The Pallas kernel at a budget that lets every chase finish (one
    block, one round, ``hops_per_visit >= max(depth)``)."""
    rng = np.random.default_rng(n_loc + b + lo)
    if cycle:
        table = make_chain(n_loc, seed=3)
        frontier = rng.integers(0, n_loc, b).astype(I32)
    else:
        table = rng.integers(0, 3 * n_loc, n_loc).astype(I32)
        frontier = rng.integers(0, 3 * n_loc, b).astype(I32)
    depth = rng.integers(0, 48, b).astype(I32)
    f, d = chase_shard(_t(table), _t(frontier), _t(depth), torch.tensor(lo, dtype=torch.int32))
    f_p, d_p = pallas_chase_shard(
        jnp.asarray(table), jnp.asarray(frontier), jnp.asarray(depth), lo,
        block=n_loc, hops_per_visit=int(depth.max()), rounds=1, interpret=True,
    )
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_p))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_p))
    if cycle:
        assert (d.numpy() == 0).all()


def test_plain_edges():
    """Frontiers below ``lo``, above the shard, depth 0, an empty batch,
    and ids far below ``lo`` (64-bit offsets, no wrap)."""
    table = np.arange(1, 9, dtype=I32) + 100  # ids 100..107 -> 101..108
    frontier = np.array([99, 108, 100, 104, -(2 ** 31), 2 ** 31 - 1, 103], I32)
    depth = np.array([5, 5, 0, 2, 3, 3, 100], I32)
    f, d = chase_shard_ref(_t(table), _t(frontier), _t(depth), 100)
    np.testing.assert_array_equal(f.numpy(), [99, 108, 100, 106, -(2 ** 31), 2 ** 31 - 1, 108])
    np.testing.assert_array_equal(d.numpy(), [5, 5, 0, 0, 3, 3, 95])
    f, d = chase_shard(_t(table), _t(frontier[:0]), _t(depth[:0]), 100)
    assert f.shape == d.shape == (0,)


def test_custom_op_cpu_dispatch_is_plain_and_fresh():
    rng = np.random.default_rng(7)
    table = _t(rng.integers(0, 128, 64).astype(I32))
    frontier = _t(rng.integers(0, 128, 40).astype(I32))
    depth = _t(rng.integers(0, 9, 40).astype(I32))
    lo = torch.tensor([32], dtype=torch.int32)
    f, d = chase_shard_op(table, frontier, depth, lo)
    f_w, d_w = chase_shard_ref(table, frontier, depth, lo)
    assert torch.equal(f, f_w) and torch.equal(d, d_w)
    # the op's outputs never alias its inputs, even where no chase moves
    assert f.data_ptr() != frontier.data_ptr() and d.data_ptr() != depth.data_ptr()


def test_vmap_rule_flattens_batch_into_one_call(monkeypatch):
    """A batched dispatch of (B, 1) frontiers and depths is ONE call of the
    op over B chases (one launch on the card), equal to B separate calls."""
    rng = np.random.default_rng(9)
    table = _t(rng.integers(0, 96, 32).astype(I32))
    frontier = _t(rng.integers(0, 96, (5, 1)).astype(I32))
    depth = _t(rng.integers(0, 9, (5, 1)).astype(I32))
    lo = torch.tensor([32], dtype=torch.int32)
    calls = []
    plain = chase_kernel.chase_shard_ref
    monkeypatch.setattr(
        chase_kernel, "chase_shard_ref", lambda *a: calls.append(a[1].shape) or plain(*a)
    )
    f, d = torch.vmap(chase_shard_op, in_dims=(None, 0, 0, None))(table, frontier, depth, lo)
    assert calls == [(5,)]
    for i in range(5):
        f_i, d_i = plain(table, frontier[i], depth[i], lo)
        assert torch.equal(f[i], f_i) and torch.equal(d[i], d_i)


@pytest.mark.parametrize("bad", ["int64_frontier", "2d_table", "ragged", "int64_lo"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    table = torch.zeros(8, dtype=torch.int32)
    frontier = torch.zeros(3, dtype=torch.int32)
    depth = torch.zeros(3, dtype=torch.int32)
    lo = torch.tensor([0], dtype=torch.int32)
    if bad == "int64_frontier":
        frontier = frontier.long()
    elif bad == "2d_table":
        table = table.reshape(2, 4)
    elif bad == "ragged":
        depth = depth[:2]
    else:
        lo = lo.long()
    with pytest.raises((TypeError, ValueError)):
        chase_shard(table, frontier, depth, lo)


# ------------------------------------------------------------------ slices
def _chaser_payloads(rng, n_servers, shard_size):
    n = n_servers * shard_size
    rows = [
        [rng.integers(0, n), rng.integers(1, 3 * shard_size), n_servers, s]
        for s in range(8)
    ]
    rows += [
        [shard_size + 1, 0, n_servers, 8],  # depth 0: RETURN at once
        [0, 5, n_servers, 9],  # below the shard: FORWARD unchanged
        [n - 1, 5, n_servers, 10],  # above the shard
    ]
    return np.array(rows, I32)


@pytest.mark.parametrize("triple", ["cpu-host", "cuda-sm90"])
def test_chaser_slice_matches_jax_entry(triple):
    """One hop of the shipped Chaser: the port's slice (loaded on the CPU)
    and the JAX slice emit the same action vector, per payload and under
    the batched rendering."""
    S, shard_size = 4, 64
    table = make_chain(S * shard_size, seed=2)
    shard, meta = table[shard_size : 2 * shard_size], np.array([1, shard_size, S], I32)
    pays = _chaser_payloads(np.random.default_rng(4), S, shard_size)
    j_fn, _ = jax_deserialize(
        jax_make_chaser(shard_size, targets=("cpu-host",)).fat.slices["cpu-host"]
    )
    t_fn, _ = deserialize_and_jit(make_chaser(shard_size).fat.slices[triple], "cpu")
    want = np.stack([np.asarray(j_fn(p, shard, meta)) for p in pays])
    got = np.stack([t_fn(_t(p), _t(shard), _t(meta)).numpy() for p in pays])
    np.testing.assert_array_equal(got, want)
    batched = torch.vmap(t_fn, in_dims=(0, None, None))(_t(pays), _t(shard), _t(meta))
    np.testing.assert_array_equal(batched.numpy(), want)


def test_return_result_slice_matches_jax_entry():
    slots = 6
    j_fn, _ = jax_deserialize(
        jax_make_return_result(slots, targets=("cpu-host",)).fat.slices["cpu-host"]
    )
    t_fn, _ = deserialize_and_jit(make_return_result(slots).fat.slices["cpu-host"], "cpu")
    region = np.full(slots + 1, -1, I32)
    region[-1] = 0
    for slot, value in [(3, 77), (0, -5), (3, 12), (5, 2 ** 31 - 1)]:
        pay = np.array([slot, value], I32)
        want = np.asarray(j_fn(pay, region))
        got = t_fn(_t(pay), _t(region)).numpy()
        np.testing.assert_array_equal(got, want)
        region = want.copy()


def test_tsi_and_spawner_slices_match_jax_entry():
    j_tsi, _ = jax_deserialize(jax_make_tsi(targets=("cpu-host",)).fat.slices["cpu-host"])
    t_tsi, _ = deserialize_and_jit(make_tsi().fat.slices["cpu-host"], "cpu")
    pay, counter = np.array([7], I32), np.array([35], I32)
    np.testing.assert_array_equal(
        t_tsi(_t(pay), _t(counter)).numpy(), np.asarray(j_tsi(pay, counter))
    )
    j_sp, _ = jax_deserialize(jax_make_spawner(targets=("cpu-host",)).fat.slices["cpu-host"])
    t_sp, _ = deserialize_and_jit(make_spawner().fat.slices["cuda-sm90"], "cpu")
    pay = np.array([1, 9], I32)
    np.testing.assert_array_equal(t_sp(_t(pay)).numpy(), np.asarray(j_sp(pay)))


def test_dapc_slices_are_device_neutral_and_small():
    """The Chaser's slices carry the graph only — no example shard, so the
    archive does not grow with ``shard_size`` — hold no host sync (``item``)
    and no device baked into their ops, and every slice, ``cpu-*`` included,
    resolves its local loop through the ``repro_torch::chase_shard`` op."""
    small = make_chaser(16)
    big = make_chaser(1 << 20)  # a 4 MiB shard
    assert 0 <= big.fat.nbytes - small.fat.nbytes <= 64 * len(big.fat.slices)
    binary = make_chaser(64, targets=("cuda-sm90",), kind=FrameKind.BINARY, name="chaser_bin")
    for ifn in (big, binary, make_return_result(256)):
        for triple, blob in ifn.fat.slices.items():
            with zipfile.ZipFile(io.BytesIO(blob)) as z:
                data = {i.filename: i.file_size for i in z.infolist() if "/data/" in i.filename}
            assert not data or max(data.values()) <= 64, (triple, data)
            targets = set()
            for node in load_program(blob, "cpu").graph.nodes:
                # operator.getitem unpacks the op's (frontier, depth) pair;
                # any other "item" target is a host sync
                if node.target is not operator.getitem:
                    assert "item" not in str(node.target), (triple, node)
                assert "device" not in node.kwargs, (triple, node)
                targets.add(str(node.target))
            if ifn.name.startswith("chaser"):
                assert "repro_torch.chase_shard.default" in targets, triple


def test_chaser_archive_size_against_jax():
    """The Chaser's archive at the card's shard size, beside the JAX
    package's for the same four triples: a ``torch.export`` slice is larger
    than a StableHLO one, but it carries no example shard and no loop
    graph (the loop is one custom op), so it stays within 6x."""
    shard = 1 << 24
    port, ref = make_chaser(shard).fat.nbytes, jax_make_chaser(shard).fat.nbytes
    assert port < 6 * ref, (port, ref)


# ---------------------------------------------------------------- PE level
@pytest.fixture()
def pe_pair():
    fabric, tc = Fabric("ideal"), Toolchain()
    names = ["server0", "client"]
    server = PE("server0", fabric, triple="cpu-bf2", toolchain=tc, peers=names, device="cpu")
    client = PE("client", fabric, triple="cpu-host", toolchain=tc, peers=names, device="cpu")
    return client, server


def test_binary_chaser_on_another_triple_is_isa_mismatch(pe_pair):
    client, server = pe_pair
    server.register_region("table_shard", np.arange(1, 9, dtype=I32))
    server.register_cap("shard_meta", np.array([0, 8, 1], I32))
    client.register_source(
        make_chaser(8, targets=("cuda-sm90",), kind=FrameKind.BINARY, name="chaser_bin")
    )
    client.send_ifunc("server0", "chaser_bin", np.array([0, 3, 1, 0], I32))
    with pytest.raises(ISAMismatch):
        server.poll()


def test_injected_code_generates_new_code(pe_pair):
    """SPAWN: the Spawner on server0 emits a TSI whose code travels to the
    client and runs there — the same counts as the JAX package's run."""
    client, server = pe_pair
    client.register_region("counter", np.zeros(1, I32))
    server.toolchain.publish(make_tsi())
    client.register_source(make_spawner())
    client.send_ifunc("server0", "spawner", np.array([1, 9], I32))
    server.poll()
    client.poll()
    assert server.stats.spawns == 1
    assert client.region("counter")[0] == 9
    assert client.target_cache.stats.jit_compiles == 1


# ------------------------------------------------------------ the DAPC app
@pytest.fixture(scope="module")
def apps():
    ref = JaxApp(JaxCluster(N_SERVERS, wire="thor_xeon"), N_ENTRIES, max_slots=MAX_SLOTS)
    cl = Cluster(N_SERVERS, wire="thor_xeon", server_triple="cuda-sm90", device="cpu")
    port = PointerChaseApp(cl, N_ENTRIES, max_slots=MAX_SLOTS)
    np.testing.assert_array_equal(port.table, ref.table)  # one seed, one table
    starts = np.random.default_rng(1).integers(0, N_ENTRIES, MAX_SLOTS).astype(I32)
    starts[0] = N_ENTRIES - 1
    oracle = np.array([chase_ref(port.table, s, DEPTH) for s in starts], I32)
    return ref, port, starts, oracle


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("batching", [False, True], ids=["permsg", "batched"])
@pytest.mark.parametrize("mode", ["bitcode", "binary", "am"])
def test_dapc_matches_reference(apps, mode, batching, arm):
    ref, port, starts, oracle = apps
    cfg = ARMS[arm]
    got = port.dapc(starts, DEPTH, mode=mode, batching=batching,
                    dataplane=cfg and DataPlaneConfig(**cfg))
    want = ref.dapc(starts, DEPTH, mode=mode, batching=batching,
                    dataplane=cfg and JaxDataPlaneConfig(**cfg))
    np.testing.assert_array_equal(got.results, oracle)
    np.testing.assert_array_equal(want.results, oracle)
    _same_counters(got, want)
    assert (got.invokes > 0) == (mode != "am")
    if arm == "zerocopy" and mode != "am":
        assert got.region_puts > 0


def test_gbpc_matches_reference(apps):
    ref, port, starts, oracle = apps
    got, want = port.gbpc(starts, DEPTH), ref.gbpc(starts, DEPTH)
    np.testing.assert_array_equal(got.results, oracle)
    _same_counters(got, want)
    assert got.gets == len(starts) * DEPTH


@pytest.mark.parametrize("batching", [False, True], ids=["permsg", "batched"])
def test_one_chase_call_per_server_dispatch(apps, monkeypatch, batching):
    """Every server dispatch in DAPC is a Chaser, and each runs the chase op
    exactly once — a batched group too, through the op's vmap rule — so on
    the card launches equal server dispatches.  Every server installed its
    cuda-sm90 slice, whose graph calls the op; the plain path here launches
    no kernel."""
    _, port, starts, oracle = apps
    calls = []
    plain = chase_kernel.chase_shard_ref
    monkeypatch.setattr(
        chase_kernel, "chase_shard_ref", lambda *a: calls.append(a[1].shape[0]) or plain(*a)
    )
    servers = port.cluster.servers
    inv0, launches0 = sum(pe.stats.invokes for pe in servers), launch_counts()["chase_shard"]
    rep = port.dapc(starts, DEPTH, mode="bitcode", batching=batching)
    np.testing.assert_array_equal(rep.results, oracle)
    dispatches = sum(pe.stats.invokes for pe in servers) - inv0
    assert len(calls) == dispatches > 0
    assert (max(calls) > 1) == batching
    assert launch_counts()["chase_shard"] == launches0
    for pe in servers:
        exe = pe.target_cache.lookup("chaser")
        assert exe is not None and exe.extras["triple"] == "cuda-sm90"
        ops = {str(n.target) for n in exe.extras["exported"].graph.nodes}
        assert "repro_torch.chase_shard.default" in ops


@pytest.mark.parametrize("mode", ["bitcode", "binary"])
def test_dapc_propagation_matches_reference(mode):
    """Tree code distribution on cold caches: results equal the oracle and
    every counter — hop frames included — equals the reference's."""
    ref = JaxApp(JaxCluster(N_SERVERS, wire="thor_xeon"), N_ENTRIES, max_slots=MAX_SLOTS)
    port = PointerChaseApp(
        Cluster(N_SERVERS, wire="thor_xeon", server_triple="cuda-sm90", device="cpu"),
        N_ENTRIES, max_slots=MAX_SLOTS,
    )
    starts = np.random.default_rng(5).integers(0, N_ENTRIES, 8).astype(I32)
    oracle = np.array([chase_ref(port.table, s, 16) for s in starts], I32)
    got = port.dapc(starts, 16, mode=mode, batching=True, propagation=PropagationConfig())
    want = ref.dapc(starts, 16, mode=mode, batching=True, propagation=JaxPropagationConfig())
    np.testing.assert_array_equal(got.results, oracle)
    _same_counters(got, want)
    assert got.hop_frames > 0
    assert port.cluster.client.stats.code_sends == ref.cluster.client.stats.code_sends


# --------------------------------------------------------------- loss axis
LOSS_RATE, LOSS_SEED, LOSS_DEPTH = 0.05, 0, 16


def _lossy(pkg_app, pkg_cluster, reliability, loss, **kw):
    cluster = pkg_cluster(4, wire="ideal", **kw)
    app = pkg_app(cluster, n_entries=512, max_slots=16, seed=LOSS_SEED)
    cluster.set_reliability(reliability.on())
    cluster.fabric.set_loss(loss, seed=LOSS_SEED + 1)
    return app


@pytest.fixture(scope="module")
def lossless_port():
    return _lossy(PointerChaseApp, Cluster, ReliabilityConfig, 0.0,
                  server_triple="cuda-sm90", device="cpu")


@pytest.mark.parametrize("batching", [False, True], ids=["permsg", "batched"])
@pytest.mark.parametrize("mode", ["bitcode", "binary", "am"])
def test_dapc_under_loss_matches_lossless_and_reference(lossless_port, mode, batching):
    """5% frame loss with reliability on: results bit-identical to the
    oracle, per-message invokes equal the lossless run's (exactly-once),
    and every counter equals the JAX package's lossy run."""
    port = _lossy(PointerChaseApp, Cluster, ReliabilityConfig, LOSS_RATE,
                  server_triple="cuda-sm90", device="cpu")
    ref = _lossy(JaxApp, JaxCluster, JaxReliabilityConfig, LOSS_RATE)
    starts = np.random.default_rng(LOSS_SEED + 100).integers(0, 512, 8).astype(I32)
    oracle = np.array([chase_ref(port.table, s, LOSS_DEPTH) for s in starts], I32)
    got = port.dapc(starts, LOSS_DEPTH, mode=mode, batching=batching)
    want = ref.dapc(starts, LOSS_DEPTH, mode=mode, batching=batching)
    np.testing.assert_array_equal(got.results, oracle)
    assert port.cluster.fabric.stats.frames_lost > 0
    _same_counters(got, want)
    if not batching:
        clean = lossless_port.dapc(starts, LOSS_DEPTH, mode=mode, batching=False)
        np.testing.assert_array_equal(clean.results, oracle)
        assert got.invokes == clean.invokes
