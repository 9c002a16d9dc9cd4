"""Multi-tenant serving on the port, against the JAX package.

Ports ``tests/test_tenancy.py``: the router's shedding and accounting,
per-tenant CQ-slot quotas, credit budgets, the express lane, the quota
edges, the recovery sweep with quota-held requests, the remote-embedding
decode and the isolation property.  Each case runs on both packages from
the same seeds: the port passes the reference's assertions, and both end
in equal state — served rows bit for bit, ``router.report()`` dicts (tick
latencies included), and every code-free wire and PE counter.  The last
case replays ``benchmarks/tenancy.py``'s ``--tiny`` settings through both
routers (the port's arm is ``chip_smoke.py``'s) and requires equal
reports in all three arms.
"""

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st  # hypothesis, or local fallback

import repro.core as jcore
import repro.runtime.embed_service as jsvc
import repro.runtime.tenancy as jten
import repro_torch.core as tcore
import repro_torch.runtime.embed_service as tsvc
import repro_torch.runtime.tenancy as tten

I32 = np.int32
REPO = Path(__file__).resolve().parent.parent
JAX = SimpleNamespace(core=jcore, svc=jsvc, ten=jten, kw={})
TORCH = SimpleNamespace(core=tcore, svc=tsvc, ten=tten, kw={"device": "cpu"})
CODE_FIELDS = {"put_bytes", "modeled_us", "modeled_tput_us", "hop_bytes", "lost_bytes",
               "tenant_put_bytes"}


def snap(cl, **extra) -> dict:
    """Every code-free counter of one cluster."""
    st_ = cl.fabric.stats
    fab = {k: v for k, v in vars(st_).items() if k not in CODE_FIELDS | {"by_kind"}}
    fab["by_kind"] = {k: v for k, v in st_.by_kind.items() if k != "code"}
    out = {"fabric": fab}
    for pe in cl.pes():
        out[pe.name] = {k: v for k, v in pe.stats.as_dict().items()
                        if not k.endswith("_ms_total")}
    return out | extra


def both(scenario, *args):
    want = scenario(JAX, *args)
    got = scenario(TORCH, *args)
    assert got == want


def done_rows(done) -> list:
    return sorted((r.rid, r.degraded, r.rows.view(I32).tolist(),
                   None if r.valid is None else r.valid.tolist()) for r in done)


def service(P, n_servers=2, max_slots=8, n_keys=4, dim=4, vocab_per_shard=16, **cl_kw):
    cl = P.core.Cluster(n_servers, **P.kw, **cl_kw)
    svc = P.svc.EmbedShardService(
        cl, vocab=vocab_per_shard * n_servers, dim=dim, n_keys=n_keys, max_slots=max_slots,
    )
    svc.gather([np.arange(1, n_keys + 1, dtype=I32)])
    return cl, svc


def batches(svc, n, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, svc.vocab, rng.integers(1, svc.n_keys + 1)).astype(I32)
        for _ in range(n)
    ]


# ================================================================ router
class TestRouter:
    def test_duplicate_class_names_rejected(self):
        _, svc = service(TORCH)
        with pytest.raises(ValueError):
            tten.TenantRouter(svc, [tten.TenantClass("a"), tten.TenantClass("a")])

    def test_shed_at_queue_limit_is_exactly_once(self):
        def run(P):
            cl, svc = service(P)
            router = P.ten.TenantRouter(svc, [P.ten.TenantClass("t", queue_limit=2)])
            keys = batches(svc, 5)
            rids = [router.submit("t", k) for k in keys]
            accepted = [r for r in rids if r is not None]
            assert len(accepted) == 2 and rids[2:] == [None, None, None]
            assert router.stats["t"].shed == 3
            done = []
            while svc.queue or svc.active:
                done += router.tick()
            assert sorted(r.rid for r in done) == sorted(accepted)
            for req, k in zip(sorted(done, key=lambda r: r.rid), keys[:2]):
                assert np.array_equal(req.rows, svc.table[k])
            again = router.submit("t", keys[0])
            assert again is not None
            return snap(cl, report=router.report(), rows=done_rows(done), again=again)

        both(run)

    def test_outstanding_tracks_completion(self):
        def run(P):
            cl, svc = service(P)
            router = P.ten.TenantRouter(svc, [P.ten.TenantClass("t", queue_limit=4)])
            router.submit("t", np.array([1, 2], I32))
            assert router.outstanding("t") == 1
            while svc.queue or svc.active:
                router.tick()
            assert router.outstanding("t") == 0
            assert router.stats["t"].latencies
            return snap(cl, report=router.report(), lat=router.stats["t"].latencies)

        both(run)

    def test_unknown_tenant_raises(self):
        _, svc = service(TORCH)
        router = tten.TenantRouter(svc, [tten.TenantClass("a")])
        with pytest.raises(KeyError):
            router.submit("nobody", np.array([1], I32))


# ============================================================ slot quota
class TestSlotQuota:
    def test_quota_caps_cq_occupancy(self):
        def run(P):
            cl, svc = service(P, max_slots=8)
            router = P.ten.TenantRouter(svc, [P.ten.TenantClass("t", slot_quota=1)])
            keys = batches(svc, 6)
            rids = [router.submit("t", k) for k in keys]
            done = []
            while svc.queue or svc.active:
                done += router.tick()
                assert svc.cq.tag_inflight("t") <= 1
            assert sorted(r.rid for r in done) == rids
            for req in done:
                assert np.array_equal(req.rows, svc.table[keys[rids.index(req.rid)]])
            assert svc.cq.tag_inflight("t") == 0
            return snap(cl, report=router.report(), rows=done_rows(done))

        both(run)

    def test_quota_block_does_not_head_of_line_block(self):
        def run(P):
            cl, svc = service(P, max_slots=8)
            router = P.ten.TenantRouter(
                svc, [P.ten.TenantClass("hot", slot_quota=1), P.ten.TenantClass("bg")]
            )
            for k in batches(svc, 4, seed=1):
                router.submit("hot", k)
            router.submit("bg", np.array([3, 5], I32))
            svc._admit()
            assert svc.cq.tag_inflight("hot") == 1
            assert any(r.tenant == "bg" for r in svc.active.values())
            assert sum(1 for r in svc.queue if r.tenant == "hot") == 3
            while svc.queue or svc.active:
                router.tick()
            assert router.stats["bg"].served == 1
            return snap(cl, report=router.report())

        both(run)


# ========================================================= credit budget
def warm_counter_cluster(P):
    cl = P.core.Cluster(n_servers=1, wire="ideal", **P.kw)
    cl.servers[0].register_region("counter", np.zeros(1, I32))
    cl.toolchain.publish(P.core.make_tsi())
    cl.client.send_ifunc("server0", "tsi", np.array([0], I32))
    cl.drain()
    return cl


class TestCreditBudget:
    def test_budget_stalls_excess_and_conserves(self):
        def run(P):
            cl = warm_counter_cluster(P)
            cl.set_tenant_budgets({"t": 1})
            for _ in range(3):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32), tenant="t")
            assert cl.fabric.tenant_outstanding("client", "t") == 1
            assert cl.client.wire.queued_credit_frames(tenant="t") == 2
            assert cl.fabric.stats.tenant_stalls["t"] == 2
            assert cl.client.stats.tenant_stalls["t"] == 2
            cl.drain()
            assert int(cl.servers[0].region("counter")[0]) == 3
            assert cl.fabric.tenant_outstanding("client", "t") == 0
            assert cl.client.wire.queued_credit_frames() == 0
            return snap(cl)

        both(run)

    def test_budget_lanes_are_per_tenant(self):
        def run(P):
            cl = warm_counter_cluster(P)
            cl.set_tenant_budgets({"a": 1})
            cl.client.send_ifunc("server0", "tsi", np.array([1], I32), tenant="a")
            cl.client.send_ifunc("server0", "tsi", np.array([1], I32), tenant="a")
            before = int(cl.fabric.stats.puts)
            cl.client.send_ifunc("server0", "tsi", np.array([10], I32), tenant="b")
            assert int(cl.fabric.stats.puts) == before + 1
            cl.drain()
            assert int(cl.servers[0].region("counter")[0]) == 12
            return snap(cl)

        both(run)

    def test_untenanted_traffic_ignores_budgets(self):
        def run(P):
            cl = warm_counter_cluster(P)
            cl.set_tenant_budgets({"t": 1})
            for _ in range(4):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            assert cl.client.wire.queued_credit_frames() == 0
            cl.drain()
            assert int(cl.servers[0].region("counter")[0]) == 4
            return snap(cl)

        both(run)


# =========================================================== express lane
class TestExpressLane:
    @staticmethod
    def _backlogged(P, express_last=True):
        cl = warm_counter_cluster(P)
        srv = cl.servers[0]
        for _ in range(3):
            cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
        cl.client.send_ifunc("server0", "tsi", np.array([100], I32), express=express_last)
        srv.batching = True
        srv.poll_budget = 1
        return cl, srv

    def test_express_jumps_the_bulk_backlog(self):
        def run(P):
            cl, srv = self._backlogged(P)
            srv.lanes = True
            srv.poll()
            assert int(srv.region("counter")[0]) == 100
            cl.drain()
            assert int(srv.region("counter")[0]) == 103
            return snap(cl)

        both(run)

    def test_express_without_lanes_stays_fifo(self):
        def run(P):
            cl, srv = self._backlogged(P)
            srv.lanes = False
            srv.poll()
            assert int(srv.region("counter")[0]) == 1
            cl.drain()
            assert int(srv.region("counter")[0]) == 103
            return snap(cl)

        both(run)


# ============================================================ quota edges
class TestQuotaEdges:
    def test_zero_quota_fields_mean_unlimited(self):
        def run(P):
            cl, svc = service(P, max_slots=4)
            router = P.ten.TenantRouter(svc, [P.ten.TenantClass("t")])
            rids = [router.submit("t", k) for k in batches(svc, 10)]
            assert None not in rids and router.stats["t"].shed == 0
            done = []
            while svc.queue or svc.active:
                done += router.tick()
            assert sorted(r.rid for r in done) == rids
            assert svc.cq.free_slots == svc.max_slots
            return snap(cl, report=router.report(), rows=done_rows(done))

        both(run)

    def test_slot_quota_exactly_at_max_slots(self):
        def run(P):
            cl, svc = service(P, max_slots=4)
            router = P.ten.TenantRouter(svc, [P.ten.TenantClass("t", slot_quota=svc.max_slots)])
            rids = [router.submit("t", k) for k in batches(svc, 7)]
            done = []
            while svc.queue or svc.active:
                done += router.tick()
                assert svc.cq.tag_inflight("t") <= svc.max_slots
            assert sorted(r.rid for r in done) == rids
            assert svc.cq.tag_inflight("t") == 0
            assert svc.cq.free_slots == svc.max_slots
            return snap(cl, report=router.report(), rows=done_rows(done))

        both(run)

    def test_queue_limit_exactly_at_offered_load(self):
        def run(P):
            cl, svc = service(P)
            router = P.ten.TenantRouter(svc, [P.ten.TenantClass("t", queue_limit=3)])
            keys = batches(svc, 4)
            rids = [router.submit("t", k) for k in keys[:3]]
            assert None not in rids and router.stats["t"].shed == 0
            assert router.submit("t", keys[3]) is None
            assert router.stats["t"].shed == 1
            while svc.queue or svc.active:
                router.tick()
            assert router.stats["t"].served == 3
            return snap(cl, report=router.report())

        both(run)

    def test_quota_held_requests_survive_recovery_sweep(self):
        def run(P):
            cl, svc = service(P, n_servers=2, max_slots=4, vocab_per_shard=16)
            cl.set_reliability(P.core.ReliabilityConfig.on(
                rto_ticks=1, retransmit_budget=2, max_misses=2, future_deadline=8))
            router = P.ten.TenantRouter(svc, [P.ten.TenantClass("hot", slot_quota=1)])
            keys = [np.array([2 + i, 18 + i], I32) for i in range(4)]
            rids = [router.submit("hot", k) for k in keys]
            assert None not in rids
            done = router.tick()
            assert len(svc.queue) == 3
            cl.kill_server(0)
            ticks = 0
            while svc.queue or svc.active:
                done += router.tick()
                assert svc.cq.tag_inflight("hot") <= 1
                ticks += 1
                assert ticks < 10_000
            done += router.tick()
            assert sorted(r.rid for r in done) == rids
            for req, k in zip(sorted(done, key=lambda r: r.rid), keys):
                if req.degraded:
                    assert not req.valid.tolist()[0]
                    for j, ok in enumerate(req.valid.tolist()):
                        if ok:
                            np.testing.assert_array_equal(req.rows[j], svc.table[k[j]])
                else:
                    np.testing.assert_array_equal(req.rows, svc.table[k])
            assert sum(r.degraded for r in done) >= 3
            assert svc.cq.free_slots == svc.max_slots
            assert svc.cq.tag_inflight("hot") == 0
            return snap(cl, report=router.report(), rows=done_rows(done), ticks=ticks)

        both(run)


# ===================================================== remote-embed decode
@pytest.fixture(scope="module")
def served():
    """yi smoke in f32: the JAX config and weights, and the port's copy."""
    from repro.configs import get_config as jax_get_config
    from repro.models import zoo as jzoo
    from repro_torch.configs import get_config
    from repro_torch.models import zoo

    jcfg = jax_get_config("yi-9b", smoke=True).replace(dtype=jnp.float32)
    cfg = get_config("yi-9b", smoke=True).replace(dtype=torch.float32)
    jp, _ = jzoo.build_params(jcfg, 0)
    flat = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    return jcfg, jp, cfg, zoo.from_jax_params(cfg, flat, device="cpu"), flat["embed.tok"]


class TestRemoteEmbedDecode:
    def test_rows_bit_identical_to_table(self, served):
        *_, table = served
        ids = np.random.default_rng(3).integers(0, table.shape[0], (2, 7)).astype(I32)
        want_client = jten.RemoteEmbedClient(table, n_servers=2, n_keys=4)
        client = tten.RemoteEmbedClient(table, n_servers=2, n_keys=4, device="cpu")
        got, want = client.rows(ids), want_client.rows(ids)
        assert got.shape == (2, 7, table.shape[1])
        assert np.array_equal(got, table[ids])
        assert np.array_equal(got.view(I32), want.view(I32))
        assert client.gathers == want_client.gathers
        assert snap(client.cluster) == snap(want_client.cluster)

    def test_decode_stream_bit_identical_local_vs_remote(self, served):
        """A scheduler fed by remote embedding rows emits the local
        scheduler's stream, and the port's streams are the JAX package's."""
        from repro.runtime.serving import ServeScheduler as JaxScheduler
        from repro_torch.runtime import ServeScheduler

        jcfg, jp, cfg, model, table = served
        prompts = [np.arange(1, 6, dtype=I32), np.array([7, 3, 2], I32)]

        def stream(sched):
            for p in prompts:
                sched.submit(p, 5)
            return {r.rid: r.out for r in sched.run()}

        want = stream(ServeScheduler(cfg, model, slots=2, t_max=32))
        embed = tten.RemoteEmbedClient(table, device="cpu")
        got = stream(ServeScheduler(cfg, model, slots=2, t_max=32, embed_client=embed))
        assert got == want
        assert embed.gathers > 0
        jembed = jten.RemoteEmbedClient(table)
        assert stream(JaxScheduler(jcfg, jp, slots=2, t_max=32, embed_client=jembed)) == got
        assert jembed.gathers == embed.gathers


# ==================================================== isolation property
def _isolation(P, seed, quota, limit, budget, n_hot, n_bg, lanes, loss):
    cl, svc = service(P, n_servers=2, max_slots=4)
    cl.set_flow(lanes=lanes)
    if loss:
        cl.set_reliability(P.core.ReliabilityConfig.on(retransmit_budget=50))
        cl.fabric.set_loss(loss, seed=seed + 7)
    router = P.ten.TenantRouter(svc, [
        P.ten.TenantClass("hot", slot_quota=quota, queue_limit=limit, credit_budget=budget),
        P.ten.TenantClass("bg", express=True),
    ])
    rng = np.random.default_rng(seed)
    offered = [("hot", k) for k in batches(svc, n_hot, seed)]
    offered += [("bg", k) for k in batches(svc, n_bg, seed + 1)]
    rng.shuffle(offered)
    expected, done = {}, []
    for i, (tenant, keys) in enumerate(offered):
        rid = router.submit(tenant, keys)
        if rid is not None:
            expected[rid] = svc.table[keys]
        if i % 3 == 2:
            done += router.tick()
    ticks = 0
    while svc.queue or svc.active:
        done += router.tick()
        ticks += 1
        assert ticks < 10_000
    done += router.tick()
    assert sorted(r.rid for r in done) == sorted(expected)
    shed = sum(s.shed for s in router.stats.values())
    assert len(expected) + shed == len(offered)
    for req in done:
        assert not req.degraded
        assert np.array_equal(req.rows, expected[req.rid])
    for tenant in ("hot", "bg"):
        assert cl.fabric.tenant_outstanding("client", tenant) == 0
        assert svc.cq.tag_inflight(tenant) == 0
    assert cl.client.wire.queued_credit_frames() == 0
    assert svc.cq.free_slots == svc.max_slots
    return snap(cl, report=router.report(), rows=done_rows(done), ticks=ticks)


@settings(max_examples=10, deadline=None)
@given(
    seed=st.integers(0, 2**16),
    quota=st.integers(1, 3),
    limit=st.integers(0, 4),
    budget=st.integers(0, 2),
    n_hot=st.integers(1, 10),
    n_bg=st.integers(1, 5),
    lanes=st.sampled_from([False, True]),
    loss=st.sampled_from([0.0, 0.05]),
)
def test_tenant_isolation_invariants(seed, quota, limit, budget, n_hot, n_bg, lanes, loss):
    """Any QoS configuration and interleaved two-tenant workload, lossy or
    not: exactly-once accounting, oracle rows, drained ledgers — and the
    port's schedule, latencies and counters equal to the reference's."""
    both(_isolation, seed, quota, limit, budget, n_hot, n_bg, lanes, loss)


# ================================== benchmarks/tenancy.py --tiny, both routers
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tiny_tenancy_benchmark_reports_equal():
    """``benchmarks/tenancy.py --tiny`` (4 servers, 10 ticks, a hot tenant
    at 4 requests a tick, one background tenant) through the JAX router,
    and the same schedule through the port's router as ``chip_smoke.py``
    drives it: equal ``report()`` dicts, drain ticks, shed totals and
    stalls in the solo, shared and qos arms."""
    sys.path.insert(0, str(REPO))
    from benchmarks import tenancy as bench

    smoke = _chip_smoke()
    tiny = dict(n_servers=4, duration=10, hot_rate=4, n_bg=1)
    want = bench.tenancy_ab(**tiny)
    cfg = want["config"]
    tenants = [("hot", cfg["hot_rate"])] + [(f"bg{i}", cfg["bg_rate"]) for i in range(cfg["n_bg"])]
    vocab = 64 * cfg["n_servers"]
    plan = smoke.make_schedule(tenants, vocab, 8, cfg["duration"], 1)
    ref_plan = bench.make_schedule(tenants, vocab, 8, cfg["duration"], 1)
    assert [[(t, k.tolist()) for t, k in tick] for tick in plan] == [
        [(t, k.tolist()) for t, k in tick] for tick in ref_plan
    ]
    got = smoke.tenancy_ab(torch.device("cpu"), tenants, plan, cfg)
    keys = ("tenants", "drain_ticks", "shed_total", "shed_exactly_once", "credit_stalls",
            "tenant_stalls")
    for arm in ("shared", "qos"):
        assert {k: got[arm][k] for k in keys} == {k: want[arm][k] for k in keys}, arm
    for name, _ in tenants:
        assert {k: got["solo"][name][k] for k in keys} == {
            k: want["solo"][name][k] for k in keys}, name
    for k in ("bg_p95_ratio", "bg_p95_ratio_unprotected", "hot_p95_ratio", "shed_total",
              "hot_credit_stalls"):
        assert got[k] == want[k], k
