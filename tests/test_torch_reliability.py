"""The reliability layer on the port, case for case against the JAX package.

Each case of ``tests/test_reliability.py`` runs here twice: once on the
JAX package and once on the port, on the same schedule (the same frames
eaten, duplicated or reordered, the same seeded Bernoulli loss).  The
port must pass the reference's own assertions, and both runs must end in
equal state: results bit for bit, and every ``TrafficStats`` / ``PEStats``
counter equal — puts, frames, retransmits, ACKs, duplicates dropped,
suspects and deaths.  Code bytes are left out (a ``torch.export`` slice is
larger than a StableHLO one), and so are the modeled times they feed.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as jcore
import repro.core.ifunc as jifunc
import repro.core.transport as jtransport
import repro.runtime.embed_service as jsvc
import repro_torch.core as tcore
import repro_torch.core.ifunc as tifunc
import repro_torch.core.transport as ttransport
import repro_torch.runtime.embed_service as tsvc

I32 = np.int32

JAX = SimpleNamespace(core=jcore, ifunc=jifunc, transport=jtransport, svc=jsvc, kw={})
TORCH = SimpleNamespace(
    core=tcore, ifunc=tifunc, transport=ttransport, svc=tsvc, kw={"device": "cpu"},
)
# code bytes and what they feed: the only fields the two packages may differ in
CODE_FIELDS = {"put_bytes", "modeled_us", "modeled_tput_us", "hop_bytes", "lost_bytes",
               "tenant_put_bytes"}


def snap(fabric, pes) -> dict:
    """Every code-free counter of one fabric and its PEs."""
    st = fabric.stats
    fab = {k: v for k, v in vars(st).items() if k not in CODE_FIELDS | {"by_kind"}}
    fab["by_kind"] = {k: v for k, v in st.by_kind.items() if k != "code"}
    out = {"fabric": fab}
    for pe in pes:
        d = pe.stats.as_dict()
        out[pe.name] = {k: v for k, v in d.items() if not k.endswith("_ms_total")}
    return out


def both(scenario, *args):
    """Run one schedule on both packages: the port passes the reference's
    assertions and ends in the reference's state."""
    want = scenario(JAX, *args)
    got = scenario(TORCH, *args)
    assert got == want


def untimed(msg: str) -> str:
    """An error message without its wall-clock ages."""
    return re.sub(r"\(\d+\.\d+s\)", "(s)", msg)


def cluster(P, n, **kw):
    return P.core.Cluster(n, **P.kw, **kw)


def service(P, cl, **kw):
    return P.svc.EmbedShardService(cl, **kw)


def rel_pair(P, **kwargs):
    """Two PEs on one fabric with reliability installed."""
    fabric = P.transport.Fabric("ideal")
    tc = P.ifunc.Toolchain()
    names = ["server0", "client"]
    server = P.ifunc.PE("server0", fabric, triple="cpu-bf2", toolchain=tc, peers=names, **P.kw)
    client = P.ifunc.PE("client", fabric, triple="cpu-host", toolchain=tc, peers=names, **P.kw)
    cfg = P.core.ReliabilityConfig.on(**kwargs)
    server.reliability = cfg
    client.reliability = cfg
    server.register_region("counter", np.zeros(1, I32))
    client.register_source(P.core.make_tsi())
    return fabric, client, server


def drive(client, server, rounds):
    n = 0
    for _ in range(rounds):
        n += client.poll() + server.poll()
    return n


def pair_snap(fabric, client, server):
    return snap(fabric, [server, client]) | {"counter": int(server.region("counter")[0])}


class TestConfig:
    @pytest.mark.parametrize("P", [JAX, TORCH], ids=["jax", "torch"])
    def test_default_is_disabled(self, P):
        assert not P.core.ReliabilityConfig().enabled

    def test_on_enables(self):
        for P in (JAX, TORCH):
            assert P.core.ReliabilityConfig.on().enabled
            assert P.core.ReliabilityConfig.on(rto_ticks=7).rto_ticks == 7

    def test_backoff_schedule(self):
        for P in (JAX, TORCH):
            cfg = P.core.ReliabilityConfig.on(rto_ticks=4, backoff=2.0)
            assert [cfg.rto_after(i) for i in range(4)] == [4, 8, 16, 32]

    def test_recovery_horizon_covers_full_budget(self):
        j, t = jcore.ReliabilityConfig.on(), tcore.ReliabilityConfig.on()
        assert t.recovery_horizon() >= sum(t.rto_after(i) for i in range(t.retransmit_budget))
        assert t.idle_grace() > t.recovery_horizon()
        assert (t.recovery_horizon(), t.idle_grace()) == (j.recovery_horizon(), j.idle_grace())
        assert vars(t) == vars(j)


class TestWireFormat:
    def test_seq_and_ack_share_the_header_word(self):
        f = tcore.Frame(kind=tcore.FrameKind.BITCODE, name="x", payload=b"p",
                        seq=0x1234, ack=0xBEEF)
        raw = f.pack()
        hdr = tcore.peek_header(raw)
        assert hdr.seq == 0x1234 and hdr.ack == 0xBEEF
        jf = jcore.Frame(kind=jcore.FrameKind.BITCODE, name="x", payload=b"p",
                         seq=0x1234, ack=0xBEEF)
        assert raw == jf.pack()  # the two packages' frames cross-parse
        assert jcore.peek_header(raw).ack == 0xBEEF

    def test_piggybacked_ack_costs_zero_wire_bytes(self):
        a = tcore.Frame(kind=tcore.FrameKind.BITCODE, name="x", payload=b"p")
        b = tcore.Frame(kind=tcore.FrameKind.BITCODE, name="x", payload=b"p",
                        seq=9, ack=1 << 31)
        assert len(a.pack()) == len(b.pack())
        jb = jcore.Frame(kind=jcore.FrameKind.BITCODE, name="x", payload=b"p",
                         seq=9, ack=1 << 31)
        assert b.pack() == jb.pack()

    def test_ack_frame_is_header_only(self):
        f = tcore.Frame(kind=tcore.FrameKind.ACK, name="", payload=b"", ack=17)
        wire = f.wire_bytes(cached=True)
        assert tcore.peek_header(wire).ack == 17
        assert len(wire) <= 80  # a bare header, no payload/code sections
        jf = jcore.Frame(kind=jcore.FrameKind.ACK, name="", payload=b"", ack=17)
        assert wire == jf.wire_bytes(cached=True)


class TestRetransmit:
    def test_lost_frame_is_retransmitted_and_completes(self):
        def run(P):
            fabric, client, server = rel_pair(P, rto_ticks=2)
            client.send_ifunc("server0", "tsi", np.array([5], I32))
            server.endpoint.inbox.clear()  # the wire ate it
            assert client.wire.unacked_frames("server0") == 1
            drive(client, server, 40)
            assert server.region("counter")[0] == 5
            assert client.stats.retransmits >= 1
            assert client.wire.unacked_frames("server0") == 0
            return pair_snap(fabric, client, server)

        both(run)

    def test_retransmit_backoff_is_exponential(self):
        def run(P):
            fabric, client, server = rel_pair(P, rto_ticks=2, backoff=2.0)
            client.send_ifunc("server0", "tsi", np.array([1], I32))
            retx_at = []
            before = 0
            for _ in range(2 + 4 + 8 + 4):
                server.endpoint.inbox.clear()
                client.poll()
                if client.stats.retransmits > before:
                    retx_at.append(client.progress.tick)
                    before = client.stats.retransmits
            assert len(retx_at) >= 3
            gaps = np.diff(retx_at)
            assert list(gaps[:2]) == [4, 8]  # rto_after(1)=4, rto_after(2)=8
            return pair_snap(fabric, client, server) | {"retx_at": retx_at}

        both(run)

    def test_budget_exhaustion_escalates_suspect_then_dead(self):
        def run(P):
            fabric, client, server = rel_pair(P, rto_ticks=1, retransmit_budget=2)
            client.send_ifunc("server0", "tsi", np.array([1], I32))
            for _ in range(30):
                server.endpoint.inbox.clear()
                client.poll()
                if client.wire.suspects():
                    break
            assert "server0" in client.wire.suspects()
            assert "server0" in client.progress.detector.suspects
            assert client.stats.peers_suspected == 1
            retx_at_suspect = client.stats.retransmits
            for _ in range(30):
                server.endpoint.inbox.clear()
                client.poll()
            assert "server0" in client.progress.detector.dead
            assert client.stats.retransmits == retx_at_suspect
            assert client.wire.unacked_frames("server0") == 0
            return pair_snap(fabric, client, server) | {"tick": client.progress.tick}

        both(run)

    def test_sign_of_life_clears_suspicion(self):
        def run(P):
            fabric, client, server = rel_pair(P, rto_ticks=1, retransmit_budget=2,
                                              max_misses=8)
            client.send_ifunc("server0", "tsi", np.array([7], I32))
            held = [bytes(b) for b in server.endpoint.inbox]
            for _ in range(30):
                server.endpoint.inbox.clear()
                client.poll()
                if client.wire.suspects():
                    break
            assert "server0" in client.wire.suspects()
            for raw in held:
                server.endpoint.deliver(raw, src="client")
            drive(client, server, 60)
            assert "server0" not in client.wire.suspects()
            assert "server0" not in client.progress.detector.dead
            assert server.region("counter")[0] == 7
            return pair_snap(fabric, client, server)

        both(run)


class TestExactlyOnce:
    def test_duplicate_is_dropped_at_the_seq_gate(self):
        def run(P):
            fabric, client, server = rel_pair(P)
            client.send_ifunc("server0", "tsi", np.array([5], I32))
            dup = bytes(server.endpoint.inbox[0])
            server.poll()
            assert server.region("counter")[0] == 5
            server.endpoint.deliver(dup, src="client")
            assert server.poll() >= 1
            assert server.region("counter")[0] == 5
            assert server.stats.dup_frames_dropped == 1
            return pair_snap(fabric, client, server)

        both(run)

    def test_out_of_order_frames_apply_in_seq_order(self):
        def run(P):
            fabric, client, server = rel_pair(P)
            for v in (10, 20, 30):
                client.send_ifunc("server0", "tsi", np.array([v], I32))
            server.endpoint.inbox.rotate(1)  # arrival order 30, 10, 20
            drive(client, server, 10)
            assert server.region("counter")[0] == 60
            assert server.stats.frames_held_ooo >= 1
            return pair_snap(fabric, client, server)

        both(run)

    def test_invokes_exactly_once_under_heavy_loss(self):
        """20% loss from one seed: the counter ends exactly at the sum in
        both packages, after the same drops and the same retransmits."""
        def run(P):
            fabric, client, server = rel_pair(P, rto_ticks=2)
            fabric.set_loss(0.2, seed=42)
            vals = list(range(1, 21))
            for v in vals:
                client.send_ifunc("server0", "tsi", np.array([v], I32))
            for _ in range(300):
                if server.region("counter")[0] == sum(vals) and \
                        client.wire.unacked_frames() == 0:
                    break
                client.poll()
                server.poll()
            assert server.region("counter")[0] == sum(vals)
            assert fabric.stats.frames_lost > 0
            return pair_snap(fabric, client, server)

        both(run)


class TestLossInjection:
    @pytest.mark.parametrize("rate", [1.0, -0.1])
    def test_loss_rate_validated(self, rate):
        for P in (JAX, TORCH):
            with pytest.raises(ValueError):
                P.transport.Fabric("ideal").set_loss(rate)

    def test_loss_is_seeded_and_accounted(self):
        def run(P, seed):
            fabric, client, server = rel_pair(P)
            fabric.set_loss(0.3, seed=seed)
            for v in range(10):
                client.send_ifunc("server0", "tsi", np.array([v], I32))
            return fabric.stats.frames_lost

        assert run(TORCH, 7) == run(TORCH, 7) > 0  # deterministic
        assert [run(TORCH, s) for s in (7, 8, 9)] == [run(JAX, s) for s in (7, 8, 9)]

    def test_zero_loss_changes_nothing(self):
        def run(P):
            fabric, client, server = rel_pair(P)
            client.send_ifunc("server0", "tsi", np.array([5], I32))
            server.poll()
            assert fabric.stats.frames_lost == 0
            assert server.region("counter")[0] == 5
            return pair_snap(fabric, client, server)

        both(run)


class TestFailureDetector:
    def test_killed_peer_is_declared_dead_and_state_cleared(self):
        def run(P):
            cl = cluster(P, 2)
            cl.set_reliability(P.core.ReliabilityConfig.on(rto_ticks=1, retransmit_budget=2,
                                                           max_misses=2))
            svc = service(P, cl, vocab=64, dim=4, n_keys=4, max_slots=8)
            svc.gather(jsvc.ragged_batches(64, 4, 4, seed=0))  # warm everything
            cl.kill_server(1)
            cl.client.send_ifunc("server1", "gatherer", np.full(4, -1, I32))
            assert cl.client.wire.unacked_frames("server1") == 1
            for _ in range(60):
                cl.client.poll()
            det = cl.client.progress.detector
            assert "server1" in det.dead
            assert cl.client.stats.peers_declared_dead == 1
            assert cl.client.wire.unacked_frames("server1") == 0
            assert cl.fabric.credit_outstanding("client", "server1") == 0
            return snap(cl.fabric, cl.pes())

        both(run)

    def test_quiet_healthy_peer_is_never_declared_dead(self):
        def run(P):
            cl = cluster(P, 2)
            cl.set_reliability(P.core.ReliabilityConfig.on(max_misses=1))
            svc = service(P, cl, vocab=64, dim=4, n_keys=4, max_slots=8)
            svc.gather(jsvc.ragged_batches(64, 2, 4, seed=0))
            for _ in range(50):
                cl.client.poll()
            assert not cl.client.progress.detector.dead
            return snap(cl.fabric, cl.pes())

        both(run)


def _finished(svc) -> list:
    return [
        (r.rid, r.degraded, None if r.valid is None else r.valid.tolist(),
         None if r.rows is None else r.rows.view(I32).tolist(), r.resubmits)
        for r in svc.finished
    ]


class TestServiceRecovery:
    def test_owner_death_degrades_to_partial_with_valid_mask(self):
        def run(P):
            cl = cluster(P, 3)
            svc = service(P, cl, vocab=96, dim=4, n_keys=4, max_slots=8)
            cl.set_reliability(P.core.ReliabilityConfig.on(
                rto_ticks=1, retransmit_budget=2, max_misses=2, future_deadline=16))
            keys = np.array([5, 40, 70], I32)  # touches all three shards
            svc.submit(keys)
            cl.kill_server(1)  # owner of key 40
            svc.run()
            (req,) = svc.finished
            assert req.degraded
            assert req.valid.tolist() == [True, False, True]
            np.testing.assert_array_equal(req.rows[req.valid], svc.table[keys][req.valid])
            assert svc.cq.free_slots == svc.max_slots
            return snap(cl.fabric, cl.pes()) | {"done": _finished(svc), "ticks": svc.ticks}

        both(run)

    def test_all_owners_dead_completes_all_invalid(self):
        def run(P):
            cl = cluster(P, 2)
            svc = service(P, cl, vocab=64, dim=4, n_keys=4, max_slots=8)
            cl.set_reliability(P.core.ReliabilityConfig.on(
                rto_ticks=1, retransmit_budget=2, max_misses=2, future_deadline=8))
            svc.submit(np.array([5, 40], I32))
            cl.kill_server(0)
            cl.kill_server(1)
            svc.run()
            (req,) = svc.finished
            assert req.degraded and not req.valid.any()
            return snap(cl.fabric, cl.pes()) | {"done": _finished(svc), "ticks": svc.ticks}

        both(run)

    def test_idle_timeout_names_the_stuck_requests(self):
        def run(P):
            cl = cluster(P, 2)
            svc = service(P, cl, vocab=64, dim=4, n_keys=4, max_slots=8)
            svc.gather([np.array([1], I32)])
            svc.submit(np.array([3, 40], I32))
            svc.submit(np.array([7], I32))
            svc._admit()
            cl.servers[1].endpoint.inbox.clear()
            cl.servers[0].endpoint.inbox.clear()
            with pytest.raises(TimeoutError) as exc:
                svc.run()
            msg = str(exc.value)
            assert "service idle but requests outstanding" in msg
            assert "owners=" in msg and "arrived=" in msg and "rid=" in msg
            assert "server0" in msg
            return snap(cl.fabric, cl.pes()) | {"msg": untimed(msg)}

        both(run)

    @staticmethod
    def _exhaust_two(P, strict_recovery=False):
        cl = cluster(P, 2)
        svc = service(P, cl, vocab=64, dim=4, n_keys=4, max_slots=8,
                      strict_recovery=strict_recovery)
        cl.set_reliability(P.core.ReliabilityConfig.on(
            rto_ticks=64, retransmit_budget=1, max_misses=64, future_deadline=2))
        svc.gather([np.array([1], I32), np.array([40], I32)])
        svc.submit(np.array([3, 40], I32))
        svc.submit(np.array([45], I32))
        svc._admit()

        def eat_and_expire():
            for srv in cl.servers:
                srv.endpoint.inbox.clear()
            svc.cq.advance(2)

        eat_and_expire()
        assert svc._recover() == 2
        assert svc._admit() == 2
        req0 = next(r for r in svc.active.values() if r.keys[0] == 3)
        stride = (2 + svc.cq.width) * 4
        base = req0.future.slot * stride
        cl.fabric.put_region(
            "server0", cl.client.name, svc.cq.region,
            base + 8, svc.table[3].tobytes(), doorbell=(base, 1, "or"),
        )
        eat_and_expire()
        return cl, svc

    def test_budget_exhaustion_degrades_every_expired_request(self):
        def run(P):
            cl, svc = self._exhaust_two(P)
            svc._recover()
            assert not svc.active and not svc.queue
            assert svc.cq.free_slots == svc.max_slots
            done = {r.rid: r for r in svc.finished}
            r0, r1 = done[2], done[3]
            assert r0.degraded and r1.degraded
            assert r0.resubmits == 2 and r1.resubmits == 2
            assert r0.valid.tolist() == [True, False]
            np.testing.assert_array_equal(r0.rows[0], svc.table[3])
            assert r1.valid.tolist() == [False]
            return snap(cl.fabric, cl.pes()) | {"done": _finished(svc)}

        both(run)

    def test_strict_recovery_raises_once_after_the_sweep(self):
        def run(P):
            cl, svc = self._exhaust_two(P, strict_recovery=True)
            with pytest.raises(TimeoutError) as exc:
                svc._recover()
            assert not svc.active
            assert svc.cq.free_slots == svc.max_slots
            assert len(svc.finished) == 2
            msg = str(exc.value)
            assert "rid=2" in msg and "rid=3" in msg
            assert "resubmit budget" in msg
            return snap(cl.fabric, cl.pes()) | {"done": _finished(svc), "msg": untimed(msg)}

        both(run)


class TestKillMidRendezvous:
    def test_source_death_between_descriptor_and_get(self):
        def run(P):
            cl = cluster(P, 2)
            svc = service(P, cl, vocab=64, dim=64, n_keys=4, max_slots=8)
            rndv = P.core.DataPlaneConfig.rendezvous(rndv_min=1)
            cl.set_reliability(P.core.ReliabilityConfig.on(
                rto_ticks=1, retransmit_budget=2, max_misses=2, future_deadline=16))
            cl.set_dataplane(rndv)
            svc.gather(jsvc.ragged_batches(64, 2, 4, seed=0), dataplane=rndv)
            cl.set_dataplane(rndv)
            svc.submit(np.array([3, 5], I32))
            svc._admit()
            cl.servers[0].poll()
            kinds = [P.core.peek_header(bytes(b)).kind for b in cl.client.endpoint.inbox]
            assert P.core.FrameKind.RNDV in kinds
            cl.kill_server(0)
            svc.run()
            (req,) = svc.finished
            assert req.degraded and not req.valid.any()
            assert cl.client.stats.rndv_dead_pulls >= 1
            assert "server0" in cl.client.progress.detector.dead
            assert svc.cq.free_slots == svc.max_slots
            return snap(cl.fabric, cl.pes()) | {"done": _finished(svc)}

        both(run)


class TestPublishDedupRetirement:
    @staticmethod
    def _tsi_cluster(P):
        cl = cluster(P, 2)
        cl.set_reliability(P.core.ReliabilityConfig.on(ack_delay=1))
        cl.client.register_source(P.core.make_tsi())
        for pe in cl.servers:
            pe.register_region("counter", np.zeros(1, I32))
        return cl

    def test_seen_pubs_retire_once_acked(self):
        def run(P):
            cl = self._tsi_cluster(P)
            rounds = []
            for _ in range(5):
                cl.client.publish_ifunc("tsi", np.array([1], I32))
                rounds.append(cl.drain_rounds())
            for pe in cl.servers:
                assert pe.region("counter")[0] == 5
                assert not pe.progress._pub_log
                assert not pe.progress._seen_pubs
            return snap(cl.fabric, cl.pes()) | {"rounds": rounds}

        both(run)

    def test_replayed_publish_after_retirement_is_still_dropped(self):
        def run(P):
            cl = self._tsi_cluster(P)
            cl.client.publish_ifunc("tsi", np.array([1], I32))
            replay = [bytes(b) for b in cl.servers[0].endpoint.inbox]
            cl.drain_rounds()
            assert not cl.servers[0].progress._seen_pubs
            for raw in replay:
                cl.servers[0].endpoint.deliver(raw, src="client")
            cl.drain_rounds()
            for pe in cl.servers:
                assert pe.region("counter")[0] == 1
            return snap(cl.fabric, cl.pes())

        both(run)


class TestDisabledIsBitCompatible:
    def test_frames_carry_no_seq_when_disabled(self):
        def run(P):
            fabric = P.transport.Fabric("ideal")
            tc = P.ifunc.Toolchain()
            names = ["server0", "client"]
            server = P.ifunc.PE("server0", fabric, triple="cpu-bf2", toolchain=tc,
                                peers=names, **P.kw)
            client = P.ifunc.PE("client", fabric, triple="cpu-host", toolchain=tc,
                                peers=names, **P.kw)
            server.register_region("counter", np.zeros(1, I32))
            client.register_source(P.core.make_tsi())
            client.send_ifunc("server0", "tsi", np.array([5], I32))
            hdr = P.core.peek_header(bytes(server.endpoint.inbox[0]))
            assert hdr.ack == 0
            assert client.wire.unacked_frames() == 0
            assert not client.progress._recv and not client.progress._ack_owed
            return pair_snap(fabric, client, server) | {"seq": hdr.seq, "kind": int(hdr.kind)}

        both(run)

    def test_gather_wire_bytes_identical_with_reliability_off(self):
        def run(P, reliability):
            cl = cluster(P, 2)
            svc = service(P, cl, vocab=64, dim=4, n_keys=4, max_slots=8)
            if reliability:
                cl.set_reliability(P.core.ReliabilityConfig())
            rep = svc.gather(jsvc.ragged_batches(64, 6, 4, seed=3))
            return rep.put_bytes, rep.wire_bytes_by_kind

        assert run(TORCH, False) == run(TORCH, True)
        # code bytes excepted, the port's wire bytes are the reference's
        got, want = run(TORCH, False)[1], run(JAX, False)[1]
        assert {k: v for k, v in got.items() if k != "code"} == {
            k: v for k, v in want.items() if k != "code"
        }
