"""Safe code injection on the port, against the JAX package.

Ports ``tests/test_sandbox.py``: the install-time verifier (transport
staging regions, region whitelists, the op budget, cold verification once
then stamp hits), the run-time quotas, the ttl ceiling, cluster-wide
quarantine, the strictest-policy merge and the tenant router's policy.
The hostile fixtures (``rndv_thief``, ``action_bomb``, ``reminter``) are
authored twice: in jnp for the JAX package, and as torch functions for
the port's ``IFunc.build``.  Each case runs the same schedule on both
packages: the same ``SandboxViolation`` message class, and equal refusal
reasons and counts, quarantine sets, verifies and stamp hits, and every
code-free wire and PE counter.

One budget differs on purpose: the port counts ATen graph nodes (default
640) where the reference counts StableHLO ops (default 4,096), so the op
bomb is built per package to exceed its own default.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.verify as jverify
import repro.runtime.embed_service as jsvc
import repro.runtime.tenancy as jten
import repro_torch.core as tcore
import repro_torch.core.verify as tverify
import repro_torch.runtime.embed_service as tsvc
import repro_torch.runtime.tenancy as tten
from repro_torch.core.bitcode import load_program

I32 = np.int32
TARGETS = ("cpu-host", "cpu-bf2")  # two triples keep toolchain builds cheap
CODE_FIELDS = {"put_bytes", "modeled_us", "modeled_tput_us", "hop_bytes", "lost_bytes",
               "tenant_put_bytes"}


# ------------------------------------------------------------ hostile code
def jax_rndv_thief():
    def entry(payload, region):
        return region + payload

    return jcore.IFunc.build(
        name="rndv_thief", fn=entry, payload_aval=jax.ShapeDtypeStruct((1,), I32),
        dep_avals=(jax.ShapeDtypeStruct((1,), I32),), deps=("region:rndv/client/0",),
        abi="update", targets=TARGETS,
    )


def torch_rndv_thief():
    def entry(payload, region):
        return region + payload

    return tcore.IFunc.build(
        name="rndv_thief", fn=entry, payload_aval=tcore.ShapeDtypeStruct((1,), torch.int32),
        dep_avals=(tcore.ShapeDtypeStruct((1,), torch.int32),),
        deps=("region:rndv/client/0",), abi="update", targets=TARGETS,
    )


def jax_action_bomb():
    def entry(payload):
        row = jnp.zeros(jcore.ACTION_WIDTH, I32)
        return row.at[0].set(jcore.A_RETURN).at[2].set(1).at[3].set(payload[0])

    return jcore.IFunc.build(
        name="action_bomb", fn=entry, payload_aval=jax.ShapeDtypeStruct((1,), I32),
        abi="xrdma", targets=TARGETS,
    )


def row(like, *slots):
    """An i32 action row from 0-d tensors and ints (no view, no index)."""
    one = torch.ones_like(like)
    vals = [s if isinstance(s, torch.Tensor) else one * s for s in slots]
    return torch.stack([*vals, *([one * 0] * (tcore.ACTION_WIDTH - len(slots)))])


def torch_action_bomb():
    """Emits an A_RETURN row without declaring a ``returns:`` dep."""
    def entry(payload):
        return row(payload[0], tcore.A_RETURN, 0, 1, payload[0])

    return tcore.IFunc.build(
        name="action_bomb", fn=entry, payload_aval=tcore.ShapeDtypeStruct((1,), torch.int32),
        abi="xrdma", targets=TARGETS,
    )


def jax_reminter():
    def entry(payload, log, meta):
        me, n = meta[0], meta[1]
        nxt = jnp.where(me + 1 >= n, 0, me + 1)
        r = jnp.zeros(jcore.ACTION_WIDTH, I32)
        r = r.at[0].set(jcore.A_PUBLISH).at[1].set(nxt).at[2].set(3)
        r = r.at[3].set(9).at[5].set(payload[1])
        return log + 1, r

    return jcore.IFunc.build(
        name="reminter", fn=entry, payload_aval=jax.ShapeDtypeStruct((2,), I32),
        dep_avals=(jax.ShapeDtypeStruct((2,), I32), jax.ShapeDtypeStruct((2,), I32)),
        deps=("region:gossip_log", "cap:gossip_meta"), abi="propagate", targets=TARGETS,
    )


def torch_reminter():
    """A rogue gossiper: each arrival re-publishes itself granting ttl 9."""
    def entry(payload, log, meta):
        me, n = meta[0], meta[1]
        nxt = torch.where(me + 1 >= n, me * 0, me + 1)
        return log + 1, row(me, tcore.A_PUBLISH, nxt, 3, 9, 0, payload[1])

    i32 = tcore.ShapeDtypeStruct((2,), torch.int32)
    return tcore.IFunc.build(
        name="reminter", fn=entry, payload_aval=i32, dep_avals=(i32, i32),
        deps=("region:gossip_log", "cap:gossip_meta"), abi="propagate", targets=TARGETS,
    )


# the op bombs: a chain of x * 3 + 1 past each package's default budget
JAX_BOMB_STEPS, TORCH_BOMB_STEPS = 1400, 330


def jax_op_bomb():
    def entry(payload, counter):
        x = counter + payload[0]
        for _ in range(JAX_BOMB_STEPS):
            x = x * 3 + 1
        return x

    return jcore.IFunc.build(
        name="op_bomb", fn=entry, payload_aval=jax.ShapeDtypeStruct((1,), I32),
        dep_avals=(jax.ShapeDtypeStruct((1,), I32),), deps=("region:counter",),
        abi="update", targets=TARGETS,
    )


def torch_op_bomb():
    def entry(payload, counter):
        x = counter + payload[0]
        for _ in range(TORCH_BOMB_STEPS):
            x = x * 3 + 1
        return x

    i32 = tcore.ShapeDtypeStruct((1,), torch.int32)
    return tcore.IFunc.build(
        name="op_bomb", fn=entry, payload_aval=i32, dep_avals=(i32,),
        deps=("region:counter",), abi="update", targets=TARGETS,
    )


@pytest.fixture(scope="module")
def pkgs():
    """Both packages with their hostile fixtures, built once."""
    jax_pkg = SimpleNamespace(
        core=jcore, svc=jsvc, ten=jten, kw={}, tsi=jcore.make_tsi(),
        gossiper=jcore.make_gossiper(), rndv_thief=jax_rndv_thief(),
        action_bomb=jax_action_bomb(), reminter=jax_reminter(), op_bomb=jax_op_bomb(),
    )
    torch_pkg = SimpleNamespace(
        core=tcore, svc=tsvc, ten=tten, kw={"device": "cpu"}, tsi=tcore.make_tsi(),
        gossiper=tcore.make_gossiper(), rndv_thief=torch_rndv_thief(),
        action_bomb=torch_action_bomb(), reminter=torch_reminter(), op_bomb=torch_op_bomb(),
    )
    return jax_pkg, torch_pkg


def both(pkgs, scenario):
    jax_pkg, torch_pkg = pkgs
    want = scenario(jax_pkg)
    got = scenario(torch_pkg)
    assert got == want


def snap(cl, **extra) -> dict:
    """Every code-free counter of one cluster, its refusals and verifiers."""
    st_ = cl.fabric.stats
    fab = {k: v for k, v in vars(st_).items() if k not in CODE_FIELDS | {"by_kind"}}
    fab["by_kind"] = {k: v for k, v in st_.by_kind.items() if k != "code"}
    out = {"fabric": fab, "refusals": cl.refusals()}
    for pe in cl.pes():
        out[pe.name] = {k: v for k, v in pe.stats.as_dict().items()
                        if not k.endswith("_ms_total")}
        out[pe.name]["verifier"] = (pe.verifier.verifies, pe.verifier.stamp_hits,
                                    len(pe.verifier.quarantined))
    return out | extra


def cluster(P, n_servers):
    return P.core.Cluster(n_servers=n_servers, **P.kw)


def counter_cluster(P, n_servers=2, sandbox=None):
    cl = cluster(P, n_servers)
    for pe in cl.servers:
        pe.register_region("counter", np.zeros(1, I32))
    cl.toolchain.publish(P.tsi)
    if sandbox is not None:
        cl.set_sandbox(sandbox)
    return cl


def counters(cl):
    return [int(pe.region("counter")[0]) for pe in cl.servers]


def gossip_cluster(P, ifunc, n_servers=2, sandbox=None):
    cl = cluster(P, n_servers)
    n = n_servers + 1
    for i, pe in enumerate(cl.pes()):
        pe.register_region("gossip_log", np.zeros(2, I32))
        pe.register_cap("gossip_meta", np.array([i, n], I32))
    cl.toolchain.publish(ifunc)
    if sandbox is not None:
        cl.set_sandbox(sandbox)
    return cl


def violation(P, poll, match) -> str:
    """Poll, expect the named SandboxViolation; its message's reason part."""
    with pytest.raises(P.core.SandboxViolation, match=match) as exc:
        poll()
    return str(exc.value).split("]", 1)[-1]


# ========================================================== install verifier
class TestInstallVerifier:
    def test_rndv_region_always_refused(self, pkgs):
        def run(P):
            cl = cluster(P, 1)
            cl.toolchain.publish(P.rndv_thief)
            cl.set_sandbox(P.core.SandboxConfig.on())
            cl.client.send_ifunc("server0", "rndv_thief", np.array([1], I32))
            msg = violation(P, cl.servers[0].poll, "rndv")
            srv = cl.servers[0]
            assert srv.stats.refusals["verify_region"] == 1
            assert not srv.target_cache.has_name("rndv_thief")
            assert P.rndv_thief.digest.hex() in srv.verifier.quarantined
            return snap(cl, msg=msg)

        both(pkgs, run)

    def test_region_whitelist_enforced(self, pkgs):
        def run(P):
            ok = counter_cluster(P, sandbox=P.core.SandboxConfig.on(allowed_regions=("counter",)))
            ok.client.send_ifunc("server0", "tsi", np.array([5], I32))
            ok.drain()
            assert counters(ok) == [5, 0]
            bad = counter_cluster(P, sandbox=P.core.SandboxConfig.on(allowed_regions=("other",)))
            bad.client.send_ifunc("server0", "tsi", np.array([5], I32))
            msg = violation(P, bad.servers[0].poll, "counter")
            assert bad.servers[0].stats.refusals["verify_region"] == 1
            assert counters(bad) == [0, 0]
            return snap(ok) | {"bad": snap(bad, msg=msg)}

        both(pkgs, run)

    def test_op_budget_refused_before_compile(self, pkgs):
        def run(P):
            cl = counter_cluster(P, sandbox=P.core.SandboxConfig.on(max_ops=1))
            srv = cl.servers[0]
            jit0 = srv.stats.jit_ms_total
            cl.client.send_ifunc("server0", "tsi", np.array([5], I32))
            violation(P, srv.poll, "ops")
            assert srv.stats.refusals["verify_ops"] == 1
            assert srv.stats.jit_ms_total == jit0
            assert not srv.target_cache.has_name("tsi")
            return snap(cl)

        both(pkgs, run)

    def test_op_bomb_refused_at_the_default_budget(self, pkgs):
        """Each package's default budget (640 ATen nodes here, 4,096
        StableHLO ops in the reference) refuses its own op bomb at install,
        quarantined, never compiled — and admits the TSI beside it."""
        jax_pkg, torch_pkg = pkgs
        assert tverify.MAX_OPS_DEFAULT == 640 and jverify.SandboxConfig().max_ops == 4096
        j_ops = jverify.count_ops(jax.export.deserialize(
            jax_pkg.op_bomb.fat.extract("cpu-bf2").blob))
        t_ops = tverify.count_ops(load_program(
            torch_pkg.op_bomb.fat.extract("cpu-bf2").blob, "cpu"))
        assert j_ops > 4096 and t_ops > 640

        def run(P):
            cl = counter_cluster(P, sandbox=P.core.SandboxConfig.on())
            cl.toolchain.publish(P.op_bomb)
            srv = cl.servers[0]
            cl.client.send_ifunc("server0", "tsi", np.array([2], I32))
            cl.drain()
            jit0 = srv.stats.jit_ms_total
            cl.client.send_ifunc("server0", "op_bomb", np.array([1], I32))
            violation(P, srv.poll, "ops")
            assert srv.stats.refusals["verify_ops"] == 1
            assert srv.stats.jit_ms_total == jit0
            assert not srv.target_cache.has_name("op_bomb")
            assert all(P.op_bomb.digest.hex() in pe.verifier.quarantined for pe in cl.pes())
            assert counters(cl) == [2, 0]
            return snap(cl)

        both(pkgs, run)

    def test_cold_verify_once_then_stamp_hits(self, pkgs):
        def run(P):
            cl = counter_cluster(P, sandbox=P.core.SandboxConfig.on())
            for _ in range(4):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
                cl.drain()
            ver = cl.servers[0].verifier
            assert ver.verifies == 1
            assert ver.stamp_hits >= 3
            assert counters(cl) == [4, 0]
            return snap(cl)

        both(pkgs, run)

    def test_warm_tree_publish_is_all_stamp_hits(self, pkgs):
        def run(P):
            cl = counter_cluster(P, n_servers=4, sandbox=P.core.SandboxConfig.on())
            cl.client.publish_ifunc("tsi", np.array([5], I32))
            cl.drain()
            assert all(pe.verifier.verifies == 1 for pe in cl.servers)
            cl.client.publish_ifunc("tsi", np.array([2], I32))
            cl.drain()
            assert all(pe.verifier.verifies == 1 for pe in cl.servers)
            assert all(pe.verifier.stamp_hits >= 1 for pe in cl.servers)
            assert counters(cl) == [7, 7, 7, 7]
            return snap(cl)

        both(pkgs, run)

    def test_disabled_path_runs_zero_verification(self, pkgs):
        def run(P):
            cl = counter_cluster(P, n_servers=4)
            cl.client.publish_ifunc("tsi", np.array([5], I32))
            cl.drain()
            for pe in cl.pes():
                assert not pe.sandbox.enabled
                assert pe.verifier.verifies == 0
                assert pe.verifier.stamp_hits == 0
                assert pe.verifier.stamps == {}
            assert cl.refusals() == {}
            assert counters(cl) == [5, 5, 5, 5]
            return snap(cl)

        both(pkgs, run)

    def test_count_ops_is_deterministic(self, pkgs):
        _, torch_pkg = pkgs
        program = load_program(torch_pkg.tsi.fat.extract("cpu-bf2").blob, "cpu")
        assert tverify.count_ops(program) == tverify.count_ops(program) > 0
        assert tverify.count_ops(None) == 0


# ============================================================ runtime quotas
class TestRuntimeQuotas:
    def test_action_outside_stamp_refused(self, pkgs):
        def run(P):
            cl = cluster(P, 1)
            cl.toolchain.publish(P.action_bomb)
            cl.set_sandbox(P.core.SandboxConfig.on())
            cl.client.send_ifunc("server0", "action_bomb", np.array([3], I32))
            msg = violation(P, cl.servers[0].poll, "A_RETURN")
            srv = cl.servers[0]
            assert srv.stats.refusals["verify_action"] == 1
            assert P.action_bomb.digest.hex() in srv.verifier.quarantined
            return snap(cl, msg=msg)

        both(pkgs, run)

    def test_invoke_budget_burn_stops_at_quota(self, pkgs):
        def run(P):
            cl = counter_cluster(P, sandbox=P.core.SandboxConfig.on(max_invokes=3))
            for _ in range(3):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
                cl.drain()
            assert counters(cl) == [3, 0]
            cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            msg = violation(P, cl.servers[0].poll, "quota")
            assert counters(cl) == [3, 0]
            assert cl.servers[0].stats.refusals["quota_invokes"] == 1
            return snap(cl, msg=msg)

        both(pkgs, run)

    def test_per_invoke_payload_cap(self, pkgs):
        def run(P):
            cl = counter_cluster(P, sandbox=P.core.SandboxConfig.on(max_invoke_payload_bytes=2))
            cl.client.send_ifunc("server0", "tsi", np.array([5], I32))
            msg = violation(P, cl.servers[0].poll, "payload")
            assert counters(cl) == [0, 0]
            assert cl.servers[0].stats.refusals["quota_payload"] == 1
            return snap(cl, msg=msg)

        both(pkgs, run)

    def test_cumulative_payload_quota(self, pkgs):
        def run(P):
            cl = counter_cluster(P, sandbox=P.core.SandboxConfig.on(max_payload_bytes=10))
            for _ in range(2):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
                cl.drain()
            assert counters(cl) == [2, 0]
            cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            msg = violation(P, cl.servers[0].poll, "cumulative")
            assert counters(cl) == [2, 0]
            assert cl.servers[0].stats.refusals["quota_payload"] == 1
            return snap(cl, msg=msg)

        both(pkgs, run)

    def test_publish_fanout_quota(self, pkgs):
        def run(P):
            cl = gossip_cluster(P, P.gossiper,
                                sandbox=P.core.SandboxConfig.on(max_publish_fanout=1))
            cl.client.send_ifunc("server0", "gossiper", np.array([1, 5], I32))
            cl.drain()
            assert cl.servers[0].region("gossip_log").tolist() == [1, 5]
            cl.client.send_ifunc("server0", "gossiper", np.array([1, 7], I32))
            msg = violation(P, cl.servers[0].poll, "fan-out")
            assert cl.servers[0].stats.refusals["quota_fanout"] == 1
            return snap(cl, msg=msg)

        both(pkgs, run)


# =============================================================== ttl ceiling
class TestTtlCeiling:
    def test_remint_beyond_config_ceiling(self, pkgs):
        def run(P):
            cl = gossip_cluster(P, P.reminter, sandbox=P.core.SandboxConfig.on(max_publish_ttl=4))
            cl.client.send_ifunc("server0", "reminter", np.array([1, 5], I32))
            msg = violation(P, cl.servers[0].poll, "ttl 9")
            srv = cl.servers[0]
            assert srv.stats.refusals["verify_ttl"] == 1
            assert P.reminter.digest.hex() in srv.verifier.quarantined
            assert cl.servers[1].region("gossip_log").tolist() == [0, 0]
            return snap(cl, msg=msg)

        both(pkgs, run)

    def test_remint_beyond_admitted_hop_ttl(self, pkgs):
        def run(P):
            cl = gossip_cluster(P, P.reminter, sandbox=P.core.SandboxConfig.on())
            assert cl.client.sandbox.max_publish_ttl >= 9
            cl.client.publish_to("server0", "reminter", np.array([1, 5], I32), ttl=2)
            msg = violation(P, cl.servers[0].poll, "ceiling 2")
            assert cl.servers[0].stats.refusals["verify_ttl"] == 1
            return snap(cl, msg=msg)

        both(pkgs, run)


# ================================================================ quarantine
class TestQuarantine:
    def test_quarantine_is_cluster_wide(self, pkgs):
        def run(P):
            cl = counter_cluster(P, n_servers=4, sandbox=P.core.SandboxConfig.on(max_invokes=1))
            cl.client.publish_ifunc("tsi", np.array([5], I32))
            cl.drain()
            assert counters(cl) == [5, 5, 5, 5]
            hexd = P.tsi.digest.hex()
            cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            violation(P, cl.servers[0].poll, "quota")
            for pe in cl.pes():
                assert hexd in pe.verifier.quarantined
                assert not pe.target_cache.has_name("tsi")
                for peer in ("server0", "server1", "server2", "server3", "client"):
                    assert not pe.sender_cache.has(peer, hexd)
            assert counters(cl) == [5, 5, 5, 5]
            cl.client.send_ifunc("server1", "tsi", np.array([1], I32))
            violation(P, cl.servers[1].poll, "quarantined")
            roll = cl.refusals()
            assert roll["quota_invokes"] == 1
            assert roll["verify_quarantined"] >= 1
            assert counters(cl) == [5, 5, 5, 5]
            return snap(cl)

        both(pkgs, run)

    def test_quarantine_drops_queued_frames(self, pkgs):
        def run(P):
            cl = counter_cluster(P, sandbox=P.core.SandboxConfig.on(max_invokes=1))
            cl.set_flow(credit_window=1)
            cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            cl.drain()
            assert counters(cl) == [1, 0]
            for _ in range(3):
                cl.client.send_ifunc("server0", "tsi", np.array([1], I32))
            assert cl.client.wire.queued_credit_frames() == 2
            violation(P, cl.servers[0].poll, "quota")
            assert cl.client.wire.queued_credit_frames() == 0
            assert cl.client.stats.refusals["quarantine_drop"] == 2
            cl.drain()
            assert counters(cl) == [1, 0]
            return snap(cl)

        both(pkgs, run)

    def test_quarantine_degrades_inflight_cq_futures(self, pkgs):
        def run(P):
            cl = counter_cluster(P, sandbox=P.core.SandboxConfig.on())
            cq = P.core.CompletionQueue(cl.client, shape=(1,), dtype=I32, max_slots=2)
            fut = cl.client.submit("server0", "tsi", np.array([7], I32), cq, expected=1)
            assert fut is not None and not fut.expired()
            cl.client.verifier.quarantine(P.tsi.digest.hex(), "tsi")
            assert fut.poisoned and fut.expired()
            rows, mask = fut.result_partial()
            assert not mask.any()
            assert cq.free_slots == 2
            return snap(cl, mask=mask.tolist())

        both(pkgs, run)


# ==================================================== tenancy + config merge
class TestStrictestMerge:
    def test_empty_is_disabled_default(self):
        assert tcore.SandboxConfig.strictest([]) == tcore.SandboxConfig()

    def test_quotas_take_tightest_nonzero(self):
        for P in (jcore, tcore):
            merged = P.SandboxConfig.strictest([
                P.SandboxConfig.on(max_invokes=10, max_payload_bytes=0),
                P.SandboxConfig.on(max_invokes=3, max_payload_bytes=64),
            ])
            assert merged.enabled
            assert merged.max_invokes == 3
            assert merged.max_payload_bytes == 64

    def test_actions_intersect_regions_union_iff_all_restrict(self):
        for P in (jcore, tcore):
            a = P.SandboxConfig.on(allowed_actions=(0, 4, 5), allowed_regions=("x",))
            b = P.SandboxConfig.on(allowed_actions=(0, 1, 4), allowed_regions=("y",))
            merged = P.SandboxConfig.strictest([a, b])
            assert merged.allowed_actions == (0, 4)
            assert merged.allowed_regions == ("x", "y")
            assert P.SandboxConfig.strictest([a, P.SandboxConfig.on()]).allowed_regions == ()

    def test_ttl_ceiling_is_min(self):
        for P in (jcore, tcore):
            merged = P.SandboxConfig.strictest(
                [P.SandboxConfig.on(max_publish_ttl=8), P.SandboxConfig.on()])
            assert merged.max_publish_ttl == 8


class TestTenantThreading:
    @pytest.mark.parametrize("triple", ["cpu-bf2", "cuda-sm90"])
    def test_router_installs_strictest_policy_and_serves(self, pkgs, triple):
        """The strictest declared policy goes on every PE and the Gather
        substrate verifies clean under it.  On ``cuda-sm90`` servers the
        rows come from the kernel's custom op (its plain version here)."""
        def run(P):
            kw = dict(P.kw, server_triple=triple) if P.kw else {}
            cl = P.core.Cluster(2, **kw)
            svc = P.svc.EmbedShardService(cl, vocab=32, dim=4, n_keys=4, max_slots=8)
            router = P.ten.TenantRouter(svc, [
                P.ten.TenantClass("a", sandbox=P.core.SandboxConfig.on(max_invokes=500)),
                P.ten.TenantClass("b", sandbox=P.core.SandboxConfig.on(max_invokes=200)),
                P.ten.TenantClass("c"),
            ])
            assert cl.client.sandbox.enabled
            assert cl.client.sandbox.max_invokes == 200
            keys = np.array([3, 17, 30], I32)
            assert router.submit("a", keys) is not None
            done = []
            while svc.queue or svc.active:
                done += router.tick()
            (req,) = done
            assert not req.degraded
            np.testing.assert_array_equal(req.rows, svc.table[keys])
            assert cl.refusals() == {}
            assert any(pe.verifier.verifies > 0 for pe in cl.pes())
            return snap(cl, report=router.report())

        both(pkgs, run)

    def test_no_declared_sandbox_leaves_cluster_unsandboxed(self):
        cl = tcore.Cluster(2, device="cpu")
        svc = tsvc.EmbedShardService(cl, vocab=32, dim=4, n_keys=4, max_slots=8)
        tten.TenantRouter(svc, [tten.TenantClass("a"), tten.TenantClass("b")])
        assert not cl.client.sandbox.enabled


# ================================================================ back-compat
class TestRefusalAccounting:
    def test_legacy_properties_mirror_the_dict(self):
        for P in (jcore, tcore):
            stats = P.PEStats()
            stats.refuse("publish_ttl")
            stats.refuse("publish_cycle", 2)
            stats.refuse("publish_digest")
            assert stats.publish_refused_ttl == 1
            assert stats.publish_refused_cycle == 2
            assert stats.publish_refused_digest == 1
            assert stats.as_dict()["refusals"] == {
                "publish_ttl": 1, "publish_cycle": 2, "publish_digest": 1,
            }

    def test_cluster_rollup_sums_across_pes(self, pkgs):
        def run(P):
            cl = counter_cluster(P, n_servers=2)
            cl.servers[0].stats.refuse("quota_invokes")
            cl.servers[1].stats.refuse("quota_invokes", 2)
            cl.client.stats.refuse("verify_ttl")
            assert cl.refusals() == {"quota_invokes": 3, "verify_ttl": 1}
            return cl.refusals()

        both(pkgs, run)
