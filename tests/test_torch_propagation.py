"""The port's recursive code propagation and X-RDMA tree collectives: the
bcast, drop/duplicate chaos, reduce and self-propagation cases of
``tests/test_propagation.py`` on the port, and the same multicasts,
reductions and gossip run in both packages with equal counters per byte
kind, code excepted (a ``torch.export`` slice is larger than a StableHLO
one).  Reduce results equal the numpy sum.  Tolerance: exact everywhere."""

import json
import pathlib

import numpy as np
import pytest

from repro.core import Cluster as JaxCluster
from repro.core import PropagationConfig as JaxPropagationConfig
from repro.core import make_gossiper as jax_make_gossiper
from repro.core import make_tsi as jax_make_tsi
from repro.sharding.collectives import xrdma_bcast as jax_xrdma_bcast
from repro.sharding.collectives import xrdma_flat_push as jax_xrdma_flat_push
from repro.sharding.collectives import xrdma_reduce as jax_xrdma_reduce
from repro_torch.core import Cluster, PropagationConfig, make_gossiper, make_tsi
from repro_torch.core.bitcode import deserialize_and_jit
from repro_torch.sharding import xrdma_bcast, xrdma_flat_push, xrdma_reduce
from repro_torch.sharding.collectives import _reducer_for_width

I32 = np.int32
BINOMIAL = PropagationConfig()
KARY2 = PropagationConfig(topology="kary", k=2)
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tsi():
    return make_tsi()


@pytest.fixture(scope="module")
def gossiper():
    return make_gossiper()


def counter_cluster(tsi, n_servers=8, wire="ideal"):
    cl = Cluster(n_servers=n_servers, wire=wire, device="cpu")
    for pe in cl.servers:
        pe.register_region("counter", np.zeros(1, I32))
    cl.toolchain.publish(tsi)
    return cl


def counters(cl):
    return [int(pe.region("counter")[0]) for pe in cl.servers]


# ==================================================================== bcast
class TestBcast:
    @pytest.mark.parametrize("cfg", [BINOMIAL, KARY2], ids=["binomial", "kary2"])
    def test_bcast_covers_every_server_once(self, tsi, cfg):
        cl = counter_cluster(tsi)
        rep = xrdma_bcast(cl, "tsi", np.array([7], I32), config=cfg)
        assert counters(cl) == [7] * 8
        assert rep.covered == rep.n_targets == 8
        assert rep.publishes == 8

    def test_root_sends_log_not_n(self, tsi):
        cl = counter_cluster(tsi, n_servers=16)
        rep = xrdma_bcast(cl, "tsi", np.array([1], I32))
        assert rep.client_sends == 5  # ceil(log2 17), not 16
        assert rep.client_code_sends == 5

    def test_flat_push_baseline_is_n(self, tsi):
        cl = counter_cluster(tsi, n_servers=16)
        rep = xrdma_flat_push(cl, "tsi", np.array([1], I32))
        assert rep.client_sends == rep.client_code_sends == 16
        assert counters(cl) == [1] * 16

    def test_code_travels_once_per_server(self, tsi):
        cl = counter_cluster(tsi)
        xrdma_bcast(cl, "tsi", np.array([2], I32))
        installs = sum(pe.stats.ifunc_installs for pe in cl.servers)
        assert installs == 8
        assert cl.fabric.stats.by_kind["code"] == 8 * len(tsi.code_bytes) + 8 * len(
            "\n".join(tsi.deps).encode()
        ) + 8 * 8  # code + deps + trailing MAGIC per cold frame

    def test_warm_tree_ships_no_code(self, tsi):
        cl = counter_cluster(tsi)
        xrdma_bcast(cl, "tsi", np.array([2], I32))
        rep = xrdma_bcast(cl, "tsi", np.array([3], I32))
        assert counters(cl) == [5] * 8
        assert rep.wire_bytes_by_kind["code"] == 0
        assert rep.hop_frames == 8

    def test_code_only_publish_installs_without_invoking(self, tsi):
        cl = counter_cluster(tsi)
        rep = xrdma_bcast(cl, "tsi", b"")
        assert rep.covered == 8
        assert counters(cl) == [0] * 8
        assert sum(pe.stats.invokes for pe in cl.servers) == 0

    def test_batched_runtime_bcast(self, tsi):
        cl = counter_cluster(tsi)
        cl.set_batching(True)
        rep = xrdma_bcast(cl, "tsi", np.array([4], I32))
        assert counters(cl) == [4] * 8
        assert rep.covered == 8


# ==================================================================== chaos
class TestDropChaos:
    def test_dropped_hop_loses_only_its_subtree(self, tsi):
        cl = counter_cluster(tsi)
        cl.client.publish_ifunc("tsi", np.array([5], I32))
        # root's children are servers 0,1,3,7; server3's subtree is {4,5,6}
        assert len(cl.servers[3].endpoint.inbox) == 1
        cl.servers[3].endpoint.inbox.clear()
        cl.drain()
        assert counters(cl) == [5, 5, 5, 0, 0, 0, 0, 5]

    def test_manual_reparent_after_drop(self, tsi):
        cl = counter_cluster(tsi)
        cl.client.publish_ifunc("tsi", np.array([5], I32))
        cl.servers[3].endpoint.inbox.clear()
        cl.drain()
        for idx in (3, 4, 5, 6):
            cl.client.publish_to(f"server{idx}", "tsi", np.array([5], I32))
        cl.drain()
        assert counters(cl) == [5] * 8

    @pytest.mark.parametrize("batching", [False, True], ids=["permsg", "batched"])
    def test_killed_midtree_pe_reparents_survivors(self, tsi, batching):
        cl = counter_cluster(tsi)
        cl.set_batching(batching)
        cl.kill_server(3)
        rep = xrdma_bcast(cl, "tsi", np.array([9], I32))
        assert rep.covered == rep.n_targets == 7
        assert rep.reparented == 3
        assert rep.publish_send_failures == 1
        got = counters(cl)
        assert got[3] == 0 and [got[i] for i in (0, 1, 2, 4, 5, 6, 7)] == [9] * 7

    def test_killed_leaf_loses_only_itself(self, tsi):
        cl = counter_cluster(tsi)
        cl.kill_server(0)
        rep = xrdma_bcast(cl, "tsi", np.array([9], I32))
        assert rep.covered == rep.n_targets == 7
        assert rep.reparented == 0
        assert counters(cl)[1:] == [9] * 7


class TestDuplicateChaos:
    def test_duplicated_hop_is_exactly_once(self, tsi):
        cl = counter_cluster(tsi)
        cl.client.publish_ifunc("tsi", np.array([5], I32))
        rounds = 0
        while any(pe.endpoint.inbox for pe in cl.pes()):
            for pe in cl.pes():
                inbox = pe.endpoint.inbox
                for buf in list(inbox):
                    inbox.append(bytearray(buf))
                pe.poll()
            rounds += 1
            assert rounds < 50
        assert counters(cl) == [5] * 8
        assert sum(pe.stats.publish_dupes for pe in cl.servers) >= 8
        assert sum(pe.stats.publishes for pe in cl.pes()) == 8

    def test_same_root_new_pub_id_does_reinvoke(self, tsi):
        cl = counter_cluster(tsi)
        xrdma_bcast(cl, "tsi", np.array([2], I32))
        xrdma_bcast(cl, "tsi", np.array([3], I32))
        assert counters(cl) == [5] * 8


# =================================================================== reduce
class TestReduce:
    @pytest.mark.parametrize("cfg", [BINOMIAL, KARY2], ids=["binomial", "kary2"])
    def test_reduce_matches_numpy_sum(self, cfg):
        cl = Cluster(n_servers=8, wire="ideal", device="cpu")
        vals = np.random.default_rng(0).integers(-100, 100, (9, 4)).astype(I32)
        rep = xrdma_reduce(cl, vals, config=cfg)
        np.testing.assert_array_equal(rep.result, vals.sum(axis=0))
        assert rep.forwards == 8

    def test_reduce_is_multi_hop(self):
        cl = Cluster(n_servers=8, wire="ideal", device="cpu")
        xrdma_reduce(cl, np.ones((9, 2), I32))
        assert cl.client.stats.msgs <= 6

    def test_reduce_batched_runtime(self):
        cl = Cluster(n_servers=8, wire="ideal", device="cpu")
        cl.set_batching(True)
        vals = np.arange(18, dtype=I32).reshape(9, 2)
        rep = xrdma_reduce(cl, vals)
        np.testing.assert_array_equal(rep.result, vals.sum(axis=0))
        assert rep.forwards == 8
        assert sum(pe.stats.batched_invokes for pe in cl.pes()) > 0  # the fold ran

    def test_reduce_with_dead_leaf_detected_not_hung(self):
        cl = Cluster(n_servers=4, wire="ideal", device="cpu")
        cl.kill_server(2)
        with pytest.raises(TimeoutError):
            xrdma_reduce(cl, np.ones((5, 2), I32))

    def test_reduce_rejects_wrong_row_count(self):
        cl = Cluster(n_servers=2, wire="ideal", device="cpu")
        with pytest.raises(ValueError, match="one row per peer"):
            xrdma_reduce(cl, np.ones((2, 2), I32))


# ========================================================== A_PUBLISH / ABI
class TestSelfPropagation:
    def test_gossiper_ring_propagates_itself(self, gossiper):
        cl = Cluster(n_servers=3, wire="ideal", device="cpu")
        for i, pe in enumerate(cl.pes()):
            pe.register_region("gossip_log", np.zeros(2, I32))
            pe.register_cap("gossip_meta", np.array([i, 4], I32))
        cl.toolchain.publish(gossiper)
        sends0 = cl.client.stats.sends
        cl.client.send_ifunc("server0", "gossiper", np.array([2, 5], I32))
        cl.drain()
        logs = [pe.region("gossip_log").tolist() for pe in cl.pes()]
        assert logs == [[1, 5], [1, 5], [1, 5], [0, 0]]
        assert cl.client.stats.sends - sends0 == 1
        assert cl.servers[0].stats.publishes == 1
        assert cl.servers[1].stats.publishes == 1

    def test_gossiper_hop_budget_exhausts(self, gossiper):
        cl = Cluster(n_servers=3, wire="ideal", device="cpu")
        for i, pe in enumerate(cl.pes()):
            pe.register_region("gossip_log", np.zeros(2, I32))
            pe.register_cap("gossip_meta", np.array([i, 4], I32))
        cl.toolchain.publish(gossiper)
        cl.client.send_ifunc("server0", "gossiper", np.array([0, 5], I32))
        cl.drain()
        logs = [pe.region("gossip_log").tolist() for pe in cl.pes()]
        assert logs == [[1, 5], [0, 0], [0, 0], [0, 0]]

    def test_propagate_abi_batched_fold_matches_sequential(self):
        """N partials retired in one dispatch produce the same accumulator
        and the same single completing action as N per-message invokes."""
        reducer = _reducer_for_width(2)
        results = {}
        for batching in (False, True):
            cl = Cluster(n_servers=1, wire="ideal", device="cpu")
            pe = cl.servers[0]
            pe.batching = batching
            pe.register_region("reduce_acc", np.zeros(3, I32))
            pe.register_region("reduce_src", np.array([10, 20], I32))
            pe.register_cap("reduce_meta", np.array([4, 1, 0], I32))
            cl.toolchain.publish(reducer)
            cl.client.register_region("reduce_acc", np.zeros(3, I32))
            cl.client.register_region("reduce_src", np.zeros(2, I32))
            cl.client.register_cap("reduce_meta", np.array([99, 1, 1], I32))
            for pay in ([0, 0, 0], [1, 5, 6], [1, 7, 8], [1, 100, 200]):
                cl.client.send_ifunc("server0", "reducer", np.array(pay, I32))
            pe.poll()
            if batching:
                pe.flush()
            results[batching] = (
                pe.region("reduce_acc").copy(), pe.stats.forwards, pe.stats.invokes,
            )
        np.testing.assert_array_equal(results[False][0], results[True][0])
        np.testing.assert_array_equal(results[False][0], [4, 122, 234])
        assert results[False][1] == results[True][1] == 1
        assert results[True][2] < results[False][2]

    def test_propagate_abi_padding_rows_are_nops(self):
        """3 payloads pad to a bucket of 4: the padded row contributes
        neither to the fold nor an action."""
        reducer = _reducer_for_width(2)
        cl = Cluster(n_servers=1, wire="ideal", device="cpu")
        pe = cl.servers[0]
        pe.batching = True
        pe.register_region("reduce_acc", np.zeros(3, I32))
        pe.register_region("reduce_src", np.array([1, 1], I32))
        pe.register_cap("reduce_meta", np.array([100, 1, 0], I32))
        cl.toolchain.publish(reducer)
        for pay in ([1, 2, 3], [1, 4, 5], [1, 6, 7]):
            cl.client.send_ifunc("server0", "reducer", np.array(pay, I32))
        pe.poll()
        np.testing.assert_array_equal(pe.region("reduce_acc"), [3, 12, 15])
        assert pe.stats.forwards == 0


def test_batched_fold_returns_nop_rows_for_padding():
    """The code cache's propagate fold itself: rows in payload order, the
    padding's rows NOPs, the region folded over the valid rows only."""
    import torch

    from repro_torch.core import A_NOP
    from repro_torch.core.pe import CodeCacheLayer
    from repro_torch.core.cache import TargetCodeCache
    from repro_torch.core.frame import Frame

    reducer = _reducer_for_width(2)
    layer = CodeCacheLayer("server0", "cpu-host", TargetCodeCache(), _Stats(), device="cpu")
    exe = layer.install(Frame(kind=reducer.kind, name="reducer", payload=b"",
                              code=reducer.code_bytes, deps=reducer.deps,
                              digest=reducer.digest))
    fold = layer.batched_executable(exe, 4)
    pays = torch.tensor([[1, 2, 3], [1, 4, 5], [1, 4, 5], [1, 4, 5]], dtype=torch.int32)
    valid = np.array([True, True, False, False])
    acc = torch.zeros(3, dtype=torch.int32)
    src = torch.tensor([1, 1], dtype=torch.int32)
    meta = torch.tensor([3, 1, 0], dtype=torch.int32)
    region, rows = fold(pays, valid, acc, src, meta)
    assert region.tolist() == [2, 6, 8]
    assert rows.shape == (4, 3 + 3)
    assert rows[0, 0] == rows[1, 0] == A_NOP  # two of three: not yet done
    assert (rows[2:, 0] == A_NOP).all() and not rows[2:, 1:].any()
    fn, _ = deserialize_and_jit(reducer.fat.slices["cpu-host"], "cpu")
    seq, r0 = acc, None
    for p in pays[:2]:
        seq, r0 = fn(p, seq, src, meta)
    assert torch.equal(seq, region) and torch.equal(r0, rows[1])


class _Stats:
    ifunc_installs = 0
    jit_ms_total = 0.0


# ============================================ the same runs in both packages
def _kinds(rep):
    return {k: rep.wire_bytes_by_kind.get(k, 0) for k in ("header", "payload", "region")}


def _counts(rep):
    return dict(
        covered=rep.covered, n_targets=rep.n_targets, rounds=rep.rounds,
        client_sends=rep.client_sends, client_code_sends=rep.client_code_sends,
        publishes=rep.publishes, publish_dupes=rep.publish_dupes,
        reparented=rep.reparented, puts=rep.puts, gets=rep.gets, hop_frames=rep.hop_frames,
        coalesced_frames=rep.coalesced_frames, **_kinds(rep),
    )


def _tsi_clusters(n_servers, profile):
    port = Cluster(n_servers=n_servers, wire=profile, device="cpu")
    ref = JaxCluster(n_servers=n_servers, wire=profile)
    for cl, tsi in ((port, make_tsi()), (ref, jax_make_tsi())):
        for pe in cl.servers:
            pe.register_region("counter", np.zeros(1, I32))
        cl.toolchain.publish(tsi)
    return port, ref


@pytest.fixture(scope="module")
def bench_config():
    return json.loads((REPO / "BENCH_propagate.json").read_text())


@pytest.mark.parametrize("kill", [None, 3], ids=["healthy", "midtree_dead"])
def test_bcast_counters_match_reference(bench_config, kill):
    """BENCH_propagate.json's multicast (16 servers, thor_bf2, binomial,
    k = 2, ttl 16): flat, cold tree and warm tree in both packages, every
    count and the header/payload bytes equal, and equal to the committed
    record; a dead mid-tree server re-parented alike."""
    c = bench_config["config"]
    kw = dict(topology=c["topology"], k=c["k"], ttl=c["ttl"])
    pay = np.array([7], I32)
    got, want = {}, {}
    port, ref = _tsi_clusters(c["n_servers"], c["profile"])
    port_flat, ref_flat = _tsi_clusters(c["n_servers"], c["profile"])
    if kill is not None:
        for cl in (port, ref, port_flat, ref_flat):
            cl.kill_server(kill)
    got["flat"] = _counts(xrdma_flat_push(port_flat, "tsi", pay))
    want["flat"] = _counts(jax_xrdma_flat_push(ref_flat, "tsi", pay))
    for arm in ("tree", "warm"):
        got[arm] = _counts(xrdma_bcast(port, "tsi", pay, config=PropagationConfig(**kw)))
        want[arm] = _counts(jax_xrdma_bcast(ref, "tsi", pay, config=JaxPropagationConfig(**kw)))
    assert got == want
    assert counters(port) == [int(pe.region("counter")[0]) for pe in ref.servers]
    if kill is None:
        for arm in ("flat", "tree", "warm"):
            rec = bench_config[arm]
            for key in ("client_sends", "client_code_sends", "publishes", "hop_frames",
                        "covered", "n_targets"):
                assert got[arm][key] == rec[key], (arm, key)
            for kind in ("header", "payload"):
                assert got[arm][kind] == rec["wire_bytes_by_kind"][kind], (arm, kind)


@pytest.mark.parametrize("batching", [False, True], ids=["permsg", "batched"])
@pytest.mark.parametrize("topology", ["binomial", "kary"])
def test_reduce_counters_match_reference(batching, topology):
    """One tree reduction in both packages: the same numpy sum, FORWARDs,
    rounds, PUTs and header/payload bytes."""
    vals = np.random.default_rng(1).integers(-(2**20), 2**20, (17, 64), dtype=np.int32)
    reps = []
    for make, Cfg, reduce in ((lambda: Cluster(16, wire="thor_bf2", device="cpu"),
                               PropagationConfig, xrdma_reduce),
                              (lambda: JaxCluster(16, wire="thor_bf2"),
                               JaxPropagationConfig, jax_xrdma_reduce)):
        cl = make()
        cl.set_batching(batching)
        reps.append(reduce(cl, vals, config=Cfg(topology=topology, k=2)))
    port, ref = reps
    np.testing.assert_array_equal(port.result, vals.sum(axis=0, dtype=np.int32))
    np.testing.assert_array_equal(port.result, ref.result)
    for key in ("forwards", "rounds", "puts", "gets", "coalesced_frames", "hop_frames"):
        assert getattr(port, key) == getattr(ref, key), key
    assert _kinds(port) == _kinds(ref)


def test_gossip_counters_match_reference():
    """A gossiper around a 17-PE ring for 40 hops (twice round): the same
    logs, self-publishes and wire counts as the JAX run, and the numpy
    visit counts and sums."""
    hops, value, n = 40, 3, 17
    out = []
    for cl, ifn in ((Cluster(16, wire="thor_bf2", device="cpu"), make_gossiper()),
                    (JaxCluster(16, wire="thor_bf2"), jax_make_gossiper())):
        for i, pe in enumerate(cl.pes()):
            pe.register_region("gossip_log", np.zeros(2, I32))
            pe.register_cap("gossip_meta", np.array([i, n], I32))
        cl.toolchain.publish(ifn)
        cl.fabric.stats.reset()
        cl.client.send_ifunc("server0", "gossiper", np.array([hops, value], I32))
        cl.drain()
        st = cl.fabric.stats
        out.append((
            [pe.region("gossip_log").tolist() for pe in cl.pes()],
            [pe.stats.publishes for pe in cl.pes()],
            (st.puts, st.by_kind["header"], st.by_kind["payload"]),
        ))
    assert out[0] == out[1]
    want = np.zeros((n, 2), np.int64)
    for h in range(hops + 1):
        want[h % n] += (1, value)
    assert out[0][0] == want.tolist()
