"""Flow control and fault containment on the port, against the JAX package.

Ports ``tests/test_progress_engine.py`` (priority lanes, poll budgets,
per-peer credit windows, CQ-backpressure admission, and the two property
interleavings, driven through ``tests/_hypothesis_compat.py``) and
``tests/test_fault_injection.py`` (dropped, duplicated, reordered and
corrupt frames at the endpoint inbox).  Each case runs the same schedule
on both packages: the port passes the reference's assertions, and both
end in equal state — results bit for bit, every code-free ``TrafficStats``
/ ``PEStats`` counter equal (credit stalls and drops, publishes handled,
refusals), and the same error surfaced where the schedule must raise.
"""

from types import SimpleNamespace

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st  # hypothesis, or local fallback

import repro.core as jcore
import repro.core.frame as jframe
import repro.core.ifunc as jifunc
import repro.core.pointer_chase as jchase
import repro.core.transport as jtransport
import repro.runtime.embed_service as jsvc
import repro_torch.core as tcore
import repro_torch.core.frame as tframe
import repro_torch.core.ifunc as tifunc
import repro_torch.core.pointer_chase as tchase
import repro_torch.core.transport as ttransport
import repro_torch.runtime.embed_service as tsvc

I32 = np.int32
JAX = SimpleNamespace(core=jcore, frame=jframe, ifunc=jifunc, chase=jchase,
                      transport=jtransport, svc=jsvc, kw={})
TORCH = SimpleNamespace(core=tcore, frame=tframe, ifunc=tifunc, chase=tchase,
                        transport=ttransport, svc=tsvc, kw={"device": "cpu"})
CODE_FIELDS = {"put_bytes", "modeled_us", "modeled_tput_us", "hop_bytes", "lost_bytes",
               "tenant_put_bytes"}


def snap(fabric, pes) -> dict:
    """Every code-free counter of one fabric and its PEs."""
    st_ = fabric.stats
    fab = {k: v for k, v in vars(st_).items() if k not in CODE_FIELDS | {"by_kind"}}
    fab["by_kind"] = {k: v for k, v in st_.by_kind.items() if k != "code"}
    out = {"fabric": fab}
    for pe in pes:
        out[pe.name] = {k: v for k, v in pe.stats.as_dict().items()
                        if not k.endswith("_ms_total")}
    return out


def both(scenario, *args):
    want = scenario(JAX, *args)
    got = scenario(TORCH, *args)
    assert got == want


def cl_snap(cl, **extra) -> dict:
    return snap(cl.fabric, cl.pes()) | extra


def counter_cluster(P, n_servers=1):
    cl = P.core.Cluster(n_servers=n_servers, wire="ideal", **P.kw)
    for pe in cl.servers:
        pe.register_region("counter", np.zeros(1, I32))
    cl.toolchain.publish(P.core.make_tsi())
    return cl


def counter(cl, i=0) -> int:
    return int(cl.servers[i].region("counter")[0])


def rows_by_rid(svc) -> dict:
    return {r.rid: r.rows.view(I32).tolist() for r in svc.finished}


# ================================================================ lanes
class TestPriorityLanes:
    @staticmethod
    def _loaded_server(P, n_data=20):
        cl = counter_cluster(P)
        srv = cl.servers[0]
        cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
        cl.drain()
        for _ in range(n_data):
            cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
        cl.client.publish_ifunc("tsi", np.array([100], I32))
        srv.batching = True
        srv.poll_budget = 4
        return cl, srv

    def test_control_jumps_the_data_backlog(self):
        def run(P):
            cl, srv = self._loaded_server(P)
            srv.lanes = True
            srv.poll()
            assert srv.stats.publish_handled == 1
            pending = srv.progress.pending()
            assert pending > 0
            cl.drain()
            assert counter(cl) == 21 + 100
            return cl_snap(cl, pending=pending)

        both(run)

    def test_fifo_without_lanes(self):
        def run(P):
            cl, srv = self._loaded_server(P)
            srv.lanes = False
            srv.poll()
            assert srv.stats.publish_handled == 0
            cl.drain()
            assert counter(cl) == 21 + 100
            return cl_snap(cl)

        both(run)

    def test_cold_digest_only_hop_stays_in_fifo_order(self):
        def run(P):
            cl = counter_cluster(P)
            srv = cl.servers[0]
            cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            cl.client.publish_ifunc("tsi", np.array([100], I32))
            srv.batching = True
            srv.lanes = True
            srv.poll_budget = 1
            srv.poll()
            assert counter(cl) == 1
            assert srv.stats.publish_handled == 0
            cl.drain()
            assert counter(cl) == 101
            assert srv.stats.publish_handled == 1
            assert srv.stats.publish_refused_digest == 0
            return cl_snap(cl)

        both(run)


# =============================================================== budget
class TestPollBudget:
    def test_budget_bounds_per_poll_work(self):
        def run(P):
            cl = counter_cluster(P)
            srv = cl.servers[0]
            for _ in range(12):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            srv.batching = True
            srv.poll_budget = 4
            seen = []
            for _ in range(3):
                srv.poll()
                seen.append(counter(cl))
            assert seen == [4, 8, 12]
            return cl_snap(cl)

        both(run)

    def test_partial_consumption_of_one_coalesced_frame(self):
        def run(P):
            cl = counter_cluster(P)
            srv = cl.servers[0]
            cl.client.batching = True
            for _ in range(12):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            cl.client.flush()
            assert len(srv.endpoint.inbox) == 1
            srv.batching = True
            srv.poll_budget = 5
            seen = []
            for _ in range(3):
                srv.poll()
                seen.append(counter(cl))
            assert seen == [5, 10, 12]
            return cl_snap(cl)

        both(run)

    def test_mode_switch_mid_partial_frame_is_exactly_once(self):
        def run(P):
            cl = counter_cluster(P)
            srv = cl.servers[0]
            cl.client.batching = True
            for _ in range(4):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            cl.client.flush()
            srv.batching = True
            srv.poll_budget = 2
            srv.poll()
            assert counter(cl) == 2
            srv.batching = False
            srv.poll()
            assert counter(cl) == 4
            return cl_snap(cl)

        both(run)

    def test_budget_none_is_drain_all(self):
        def run(P):
            cl = counter_cluster(P)
            for _ in range(7):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            cl.servers[0].poll()
            assert counter(cl) == 7
            return cl_snap(cl)

        both(run)


# ============================================================== credits
class TestCreditWindow:
    def test_window_exactly_full_no_stall(self):
        def run(P):
            cl = counter_cluster(P)
            cl.client.credit_window = 4
            for _ in range(4):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            assert cl.fabric.stats.credit_stalls == 0
            assert cl.client.wire.queued_credit_frames() == 0
            assert len(cl.servers[0].endpoint.inbox) == 4
            return cl_snap(cl)

        both(run)

    def test_one_beyond_window_stalls_then_recovers(self):
        def run(P):
            cl = counter_cluster(P)
            cl.client.credit_window = 4
            for _ in range(5):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            assert cl.fabric.stats.credit_stalls == 1
            assert cl.client.stats.credit_stalls == 1
            assert cl.client.wire.queued_credit_frames("server0") == 1
            assert len(cl.servers[0].endpoint.inbox) == 4
            cl.servers[0].poll()
            assert counter(cl) == 4
            pumped = cl.client.poll()
            assert pumped > 0
            assert cl.client.wire.queued_credit_frames() == 0
            cl.servers[0].poll()
            assert counter(cl) == 5
            return cl_snap(cl, pumped=pumped)

        both(run)

    def test_later_frames_queue_behind_stalled_ones(self):
        def run(P):
            cl = counter_cluster(P)
            cl.client.credit_window = 2
            for _ in range(4):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            assert cl.client.wire.queued_credit_frames("server0") == 2
            cl.drain()
            assert counter(cl) == 4
            return cl_snap(cl)

        both(run)

    def test_control_frames_bypass_the_window(self):
        def run(P):
            cl = counter_cluster(P)
            cl.client.credit_window = 1
            cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            stalls0 = cl.fabric.stats.credit_stalls
            sent = cl.client.publish_ifunc("tsi", np.array([10], I32))
            assert sent == ["server0"]
            assert cl.fabric.stats.credit_stalls == stalls0
            cl.drain()
            assert counter(cl) == 11
            return cl_snap(cl)

        both(run)

    def test_stalled_frames_dropped_when_peer_dies(self):
        def run(P):
            cl = counter_cluster(P)
            cl.client.credit_window = 2
            for _ in range(4):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            assert cl.client.wire.queued_credit_frames("server0") == 2
            cl.kill_server(0)
            cl.client.poll()
            assert cl.client.wire.queued_credit_frames("server0") == 0
            assert cl.client.stats.credit_dropped == 2
            return cl_snap(cl)

        both(run)

    def test_kill_returns_credits_for_unprocessed_frames(self):
        def run(P):
            cl = counter_cluster(P)
            cl.client.credit_window = 2
            for _ in range(2):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            assert cl.fabric.credit_outstanding("client", "server0") == 2
            cl.kill_server(0)
            assert cl.fabric.credit_outstanding("client", "server0") == 0
            cl.restart_server(0)
            cl.servers[0].register_region("counter", np.zeros(1, I32))
            for _ in range(2):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            assert cl.fabric.stats.credit_stalls == 0
            cl.drain()
            assert counter(cl) == 2
            return cl_snap(cl)

        both(run)


# ============================================== CQ-backpressure admission
def admission_service(P, max_slots=4, n_servers=2):
    cl = P.core.Cluster(n_servers=n_servers, wire="ideal", **P.kw)
    return P.svc.EmbedShardService(cl, vocab=64, dim=4, n_keys=4, max_slots=max_slots, seed=1)


class TestAdmissionControl:
    def test_full_cq_never_kills_inflight_requests(self):
        def run(P):
            svc = admission_service(P, max_slots=4)
            cl = svc.cluster
            batches = jsvc.ragged_batches(svc.vocab, 12, svc.n_keys, seed=2)
            for b in batches:
                svc.submit(b)
            saturated = False
            rounds = 0
            while svc.queue or svc.active:
                svc._admit()
                saturated = saturated or (svc.cq.free_slots == 0 and len(svc.queue) > 0)
                for pe in cl.alive_pes():
                    pe.poll()
                svc._retire()
                rounds += 1
                assert rounds < 10_000
            assert saturated
            assert svc.cq.free_slots == 4
            got = {r.rid: r.rows for r in svc.finished}
            for rid, want in enumerate(svc.oracle(batches)):
                np.testing.assert_array_equal(got[rid], want)
            return cl_snap(cl, rows=rows_by_rid(svc), rounds=rounds)

        both(run)

    def test_cancel_under_exhaustion_releases_exactly_one_slot(self):
        def run(P):
            svc = admission_service(P, max_slots=3)
            cl = svc.cluster

            def submit(k):
                return cl.client.submit("server0", "gatherer", svc._pad(np.array([k], I32)),
                                        svc.cq, expected=1)

            futs = [submit(k) for k in (1, 2, 3)]
            assert svc.cq.free_slots == 0
            assert submit(4) is None
            futs[1].cancel()
            assert svc.cq.free_slots == 1
            futs[1].cancel()
            assert svc.cq.free_slots == 1
            fut = submit(4)
            assert fut is not None
            assert svc.cq.free_slots == 0
            cl.run_until(fut.done)
            np.testing.assert_array_equal(fut.result()[0], svc.table[4])
            cl.run_until(lambda: futs[0].done() and futs[2].done())
            np.testing.assert_array_equal(futs[0].result()[0], svc.table[1])
            np.testing.assert_array_equal(futs[2].result()[0], svc.table[3])
            return cl_snap(cl)

        both(run)


# ================================================== property: invariants
def _interleaving(P, lanes, budget, window, publish_tick, seed):
    cl = P.core.Cluster(n_servers=4, wire="ideal", **P.kw)
    svc = P.svc.EmbedShardService(cl, vocab=64, dim=4, n_keys=4, max_slots=4, seed=3)
    for pe in cl.servers:
        pe.register_region("counter", np.zeros(1, I32))
    cl.toolchain.publish(P.core.make_tsi())
    batches = jsvc.ragged_batches(svc.vocab, 10, svc.n_keys, seed=seed)
    want = svc.oracle(batches)
    cl.set_batching(True)
    svc.batching = True
    cl.set_flow(lanes=lanes, credit_window=window, poll_budget=budget)
    for b in batches:
        svc.submit(b)
    tick = 0
    published = False
    while svc.queue or svc.active or not published or any(
        int(pe.region("counter")[0]) != 9 for pe in cl.servers
    ):
        tick += 1
        if tick == publish_tick:
            cl.client.publish_ifunc("tsi", np.array([9], I32))
            published = True
        svc.tick()
        assert tick < 10_000
    counters = [int(pe.region("counter")[0]) for pe in cl.servers]
    assert counters == [9] * 4
    got = {r.rid: r.rows for r in svc.finished}
    for rid, w in enumerate(want):
        np.testing.assert_array_equal(got[rid], w)
    return cl_snap(cl, rows=rows_by_rid(svc), ticks=tick)


@settings(max_examples=4, deadline=None)
@given(
    lanes=st.sampled_from([False, True]),
    budget=st.sampled_from([2, 5, None]),
    window=st.sampled_from([0, 3, 16]),
    publish_tick=st.integers(min_value=1, max_value=4),
    seed=st.integers(min_value=0, max_value=2**20),
)
def test_any_interleaving_preserves_gather_and_publish_invariants(
    lanes, budget, window, publish_tick, seed
):
    """Any lanes/budget/credits setting and publish timing: rows equal the
    take oracle, the concurrent tree publish invokes once per server, and
    the port's schedule is the reference's tick for tick."""
    both(_interleaving, lanes, budget, window, publish_tick, seed)


def _dapc_flow(P, budget, window, seed):
    rng = np.random.default_rng(seed)
    cl = P.core.Cluster(n_servers=4, wire="ideal", **P.kw)
    app = P.chase.PointerChaseApp(cl, n_entries=64, max_slots=16, seed=7)
    cl.set_flow(lanes=True, credit_window=window, poll_budget=budget)
    starts = rng.integers(0, 64, size=8).astype(I32)
    depth = 12
    rep = app.dapc(starts, depth, batching=True)
    want = [P.chase.chase_ref(app.table, s, depth) for s in starts]
    assert rep.results.tolist() == want
    return cl_snap(cl, results=rep.results.tolist(), rounds=rep.rounds)


@settings(max_examples=3, deadline=None)
@given(
    budget=st.sampled_from([3, None]),
    window=st.sampled_from([0, 4]),
    seed=st.integers(min_value=0, max_value=2**20),
)
def test_dapc_oracle_identical_under_flow_knobs(budget, window, seed):
    both(_dapc_flow, budget, window, seed)


# ======================================================= fault injection
def tsi_pair(P):
    fabric = P.transport.Fabric("ideal")
    tc = P.ifunc.Toolchain()
    names = ["server0", "client"]
    server = P.ifunc.PE("server0", fabric, triple="cpu-bf2", toolchain=tc, peers=names, **P.kw)
    client = P.ifunc.PE("client", fabric, triple="cpu-host", toolchain=tc, peers=names, **P.kw)
    server.register_region("counter", np.zeros(1, I32))
    client.register_source(P.core.make_tsi())
    return fabric, client, server


def pair_snap(fabric, client, server, **extra):
    return snap(fabric, [server, client]) | {"counter": int(server.region("counter")[0])} | extra


class TestDrop:
    def test_dropped_frame_loses_only_itself(self):
        def run(P):
            fabric, client, server = tsi_pair(P)
            for v in (10, 20, 30):
                client.send_ifunc("server0", "tsi", np.array([v], I32))
            inbox = server.endpoint.inbox
            assert len(inbox) == 3
            del inbox[1]
            assert server.poll() == 2
            assert server.region("counter")[0] == 40
            return pair_snap(fabric, client, server)

        both(run)

    def test_dropped_gather_frame_detected_not_hung(self):
        def run(P):
            cl = P.core.Cluster(n_servers=2, wire="ideal", **P.kw)
            svc = P.svc.EmbedShardService(cl, vocab=64, dim=4, n_keys=4, max_slots=8)
            svc.gather([np.array([1], I32)])
            rids = [svc.submit(np.array([k], I32)) for k in (3, 40, 7)]
            svc._admit()
            assert len(cl.servers[1].endpoint.inbox) == 1
            cl.servers[1].endpoint.inbox.clear()
            with pytest.raises(TimeoutError):
                svc.run()
            done = {r.rid for r in svc.finished}
            assert rids[0] in done and rids[2] in done and rids[1] not in done
            return cl_snap(cl, rows=rows_by_rid(svc))

        both(run)


class TestDuplicate:
    def test_duplicated_frame_is_at_least_once(self):
        def run(P):
            fabric, client, server = tsi_pair(P)
            client.send_ifunc("server0", "tsi", np.array([5], I32))
            inbox = server.endpoint.inbox
            inbox.append(bytearray(inbox[0]))
            assert server.poll() == 2
            assert server.region("counter")[0] == 10
            return pair_snap(fabric, client, server)

        both(run)

    def test_duplicated_gather_return_is_idempotent_on_rows(self):
        def run(P):
            cl = P.core.Cluster(n_servers=2, wire="ideal", **P.kw)
            svc = P.svc.EmbedShardService(cl, vocab=64, dim=4, n_keys=4, max_slots=8)
            keys = np.array([3, 40], I32)
            svc.gather([keys])
            fut = cl.client.submit("server0", "gatherer", svc._pad(keys), svc.cq,
                                   expected=len(keys))
            for _ in range(4):
                for pe in cl.pes():
                    pe.poll()
                inbox = cl.client.endpoint.inbox
                for buf in list(inbox):
                    inbox.append(bytearray(buf))
            cl.run_until(fut.done)
            got = fut.result()[: len(keys)]
            np.testing.assert_array_equal(got, svc.table[keys])
            return cl_snap(cl, rows=got.view(I32).tolist())

        both(run)


class TestReorder:
    def test_reordered_frames_commute(self):
        def run(P):
            fabric, client, server = tsi_pair(P)
            client.send_ifunc("server0", "tsi", np.array([100], I32))
            server.poll()
            for v in (1, 2, 3, 4):
                client.send_ifunc("server0", "tsi", np.array([v], I32))
            server.endpoint.inbox.rotate(2)
            server.poll()
            assert server.region("counter")[0] == 110
            return pair_snap(fabric, client, server)

        both(run)

    def test_code_frame_reordered_behind_its_payloads_is_loud(self):
        def run(P):
            fabric, client, server = tsi_pair(P)
            server.batching = True
            for v in (1, 2, 3):
                client.send_ifunc("server0", "tsi", np.array([v], I32))
            server.endpoint.inbox.rotate(1)
            with pytest.raises(P.core.ProtocolError, match="stale sender cache"):
                server.poll()
            assert server.region("counter")[0] == 3
            return pair_snap(fabric, client, server)

        both(run)

    def test_reordered_gather_returns_match_oracle(self):
        def run(P):
            cl = P.core.Cluster(n_servers=4, wire="ideal", **P.kw)
            svc = P.svc.EmbedShardService(cl, vocab=64, dim=4, n_keys=4, max_slots=8)
            rng = np.random.default_rng(0)
            batches = [rng.integers(0, 64, 4).astype(I32) for _ in range(6)]
            svc.gather(batches)
            futs = []
            for keys in batches:
                f = cl.client.submit(f"server{svc.owner(keys[0])}", "gatherer",
                                     svc._pad(keys), svc.cq, expected=len(keys))
                f.meta = keys
                futs.append(f)
            rounds = 0
            while not all(f.done() for f in futs):
                for pe in cl.pes():
                    pe.endpoint.inbox.rotate(1)
                    pe.poll()
                rounds += 1
                assert rounds < 100
            for f in futs:
                np.testing.assert_array_equal(f.result()[: len(f.meta)], svc.table[f.meta])
            return cl_snap(cl, rounds=rounds)

        both(run)


class TestCorruption:
    def test_corrupt_frame_mid_batch_contained(self):
        def run(P):
            fabric, client, server = tsi_pair(P)
            server.batching = True
            for v in (7, 2, 4):
                client.send_ifunc("server0", "tsi", np.array([v], I32))
            mid = server.endpoint.inbox[1]
            mid[mid.index(P.frame.MAGIC)] ^= 0xFF
            with pytest.raises(P.core.ProtocolError):
                server.poll()
            assert server.region("counter")[0] == 11
            return pair_snap(fabric, client, server)

        both(run)

    def test_corrupt_batch_subheader_contained(self):
        def run(P):
            fabric, client, server = tsi_pair(P)
            client.batching = server.batching = True
            for v in (1, 2, 3):
                client.send_ifunc("server0", "tsi", np.array([v], I32))
            client.flush()
            client.send_ifunc("server0", "tsi", np.array([10], I32))
            client.flush()
            inbox = server.endpoint.inbox
            assert len(inbox) == 2
            hdr_end = inbox[0].index(b"tsi") + 3
            inbox[0][hdr_end] = 200
            with pytest.raises(P.core.ProtocolError):
                server.poll()
            assert server.region("counter")[0] == 10
            return pair_snap(fabric, client, server)

        both(run)

    def test_garbage_delivery_then_healthy_traffic(self):
        def run(P):
            fabric, client, server = tsi_pair(P)
            fabric.put("client", "server0", b"\xde\xad\xbe\xef" * 16)
            client.send_ifunc("server0", "tsi", np.array([9], I32))
            with pytest.raises(P.core.CorruptFrame):
                server.poll()
            assert server.poll() == 1
            assert server.region("counter")[0] == 9
            return pair_snap(fabric, client, server)

        both(run)

    def test_garbage_in_batched_poll_contained(self):
        def run(P):
            fabric, client, server = tsi_pair(P)
            server.batching = True
            client.send_ifunc("server0", "tsi", np.array([3], I32))
            fabric.put("client", "server0", b"\x00" * 80)
            client.send_ifunc("server0", "tsi", np.array([6], I32))
            with pytest.raises(P.core.ProtocolError):
                server.poll()
            assert server.region("counter")[0] == 9
            return pair_snap(fabric, client, server)

        both(run)
