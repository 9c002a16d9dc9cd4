"""The port's placement layer against the JAX package: capability vectors,
initiator pricing, the cost-model optimizer and restart hygiene (the cases
of ``tests/test_placement.py``), and ``benchmarks/placement.py``'s six
cells re-run in both packages at a reduced request count.

The optimizer is pure float arithmetic over the advertised capabilities, so
its ``pushdown_us``/``pull_us``/choice must be bit-equal to the
reference's, and the cells' wire counters equal, code bytes excepted (both
packages warm every server first, so no code travels in a measured arm).
Tolerance: exact everywhere."""

import json
import pathlib

import numpy as np
import pytest

from repro.core import Cluster as JaxCluster
from repro.runtime.embed_service import FilterShardService as JaxFilterService
from repro.sharding.placement import PlacementOptimizer as JaxOptimizer
from repro_torch.core import (
    MEM_BW_CLASS,
    TRIPLE_WIRE,
    WIRE_PROFILES,
    Capability,
    Cluster,
    PointerChaseApp,
    chase_ref,
)
from repro_torch.runtime import EmbedShardService, FilterShardService
from repro_torch.sharding import PlacementOptimizer

REPO = pathlib.Path(__file__).resolve().parent.parent


def port_cluster(n_servers, **kw):
    return Cluster(n_servers=n_servers, device="cpu", **kw)


def test_restart_readvertises_and_invalidates_plans():
    """A restarted PE must re-advertise its capability vector (fresh
    epoch) AND every cached placement plan priced against the dead
    incarnation must be dropped."""
    cl = port_cluster(2, hetero_wire=True)
    svc = FilterShardService(cl, vocab=256, dim=16, window=8)
    opt = PlacementOptimizer(cl)
    svc.plan_with(opt, [0])
    assert opt.cached_plans == 1
    epoch0 = cl.capabilities()["server0"].epoch
    cl.restart_server(0)
    cap = cl.capabilities()["server0"]
    assert cap is not None, "restarted PE did not re-advertise"
    assert cap.epoch > epoch0, "restart must mint a fresh capability epoch"
    assert opt.cached_plans == 0, "cached plans routed to the restarted PE survived restart"
    again = svc.plan_with(opt, [0])
    assert again.executor_epoch == cap.epoch and opt.priced == 2


# --------------------------------------------------------------- capabilities
def test_every_pe_advertises_at_connect():
    cl = port_cluster(3)
    caps = cl.capabilities()
    assert set(caps) == {"server0", "server1", "server2", "client"}
    srv, cli = caps["server0"], caps["client"]
    assert srv.isa == "cpu-bf2" and srv.wire == "thor_bf2"
    assert cli.isa == "cpu-host" and cli.wire == "thor_xeon"
    assert srv.mem_bw_class == "ddr-dpu" and cli.mem_bw_class == "ddr-host"
    assert srv.alpha_us == WIRE_PROFILES["thor_bf2"].alpha_us
    assert cli.beta_Bus == WIRE_PROFILES["thor_xeon"].beta_Bus
    assert len({c.epoch for c in caps.values()}) == len(caps)
    # the same vectors as the JAX package's, epochs included
    ref = JaxCluster(n_servers=3).capabilities()
    assert {k: v.as_dict() for k, v in caps.items()} == {
        k: dict(v.as_dict(), platform="cpu") for k, v in ref.items()
    }


def test_card_pes_advertise_cuda_sm90():
    """The card's PEs (here their cuda-sm90 slice on the CPU) advertise the
    host's NIC arithmetic and an HBM scan class, not the DDR fallback."""
    cl = port_cluster(2, server_triple="cuda-sm90")
    cap = cl.capabilities()["server0"]
    assert (cap.isa, cap.wire, cap.mem_bw_class) == ("cuda-sm90", "thor_xeon", "hbm")
    assert TRIPLE_WIRE["cuda-sm90"] == "thor_xeon" and MEM_BW_CLASS["cuda-sm90"] == "hbm"


def test_kill_withdraws_capability():
    cl = port_cluster(2)
    cl.fabric.kill("server1")
    assert "server1" not in cl.capabilities()
    assert "server0" in cl.capabilities()
    cl.fabric.revive("server1")
    assert "server1" not in cl.capabilities()


def test_hetero_pricing_uses_initiator_model():
    """With hetero accounting on, the same GET costs different modeled
    time depending on who sends it; off, accounting is profile-uniform —
    and bit-equal to the JAX fabric's either way."""
    us = {}
    for hetero in (False, True):
        for name, make in (("port", port_cluster), ("jax", JaxCluster)):
            cl = make(n_servers=1, wire="thor_bf2", hetero_wire=hetero)
            cl.servers[0].register_region("r", np.zeros(4096, np.uint8))
            cl.fabric.stats.reset()
            cl.fabric.get("client", "server0", "r", 0, 4096)
            cl.fabric.put("server0", "client", b"\0" * 100)
            us[name, hetero] = cl.fabric.stats.modeled_us
        assert us["port", hetero] == us["jax", hetero]
    xeon, bf2 = WIRE_PROFILES["thor_xeon"], WIRE_PROFILES["thor_bf2"]
    assert us["port", False] == pytest.approx(
        2 * bf2.alpha_us + 4096 / bf2.beta_Bus + bf2.latency_us(100)
    )
    assert us["port", True] == pytest.approx(
        2 * xeon.alpha_us + 4096 / xeon.beta_Bus + bf2.latency_us(100)
    )


# ------------------------------------------------------------- the cost model
def _mixed_optimizer(server_triple="cpu-bf2", jax=False):
    if jax:
        cl = JaxCluster(n_servers=2, wire="thor_xeon", server_triple=server_triple,
                        hetero_wire=True)
        return cl, JaxOptimizer(cl)
    cl = port_cluster(2, wire="thor_xeon", server_triple=server_triple, hetero_wire=True)
    return cl, PlacementOptimizer(cl)


PLAN_KW = dict(
    operand_bytes=24 * 96 * 4,
    result_bytes=24 * 96 * 4,
    request_payload_bytes=20,
    return_header_bytes=(3 + 24) * 4,
    op_name="filter",
    return_name="filter_return",
)


def _fields(d):
    return (d.choice, d.pushdown_us, d.pull_us, d.requester, d.executor)


def test_optimizer_is_bit_deterministic():
    _, opt = _mixed_optimizer()
    a = opt.plan(requester="client", executor="server0", selectivity=0.25, **PLAN_KW)
    _, opt2 = _mixed_optimizer()
    b = opt2.plan(requester="client", executor="server0", selectivity=0.25, **PLAN_KW)
    assert a == b
    assert opt.priced == opt2.priced == 1
    opt.plan(requester="client", executor="server0", selectivity=0.25, **PLAN_KW)
    assert opt.priced == 1


@pytest.mark.parametrize("server_triple", ["cpu-bf2", "cpu-host"])
@pytest.mark.parametrize("selectivity", [0.0, 0.05, 0.25, 0.5, 0.75, 1.0])
def test_optimizer_plans_bit_equal_to_reference(server_triple, selectivity):
    """Every priced float bit, every choice: the port's arithmetic is the
    reference's, for the filter's prices, a code-carrying cold plan and
    the chase's."""
    _, port = _mixed_optimizer(server_triple)
    _, ref = _mixed_optimizer(server_triple, jax=True)
    for kw in (dict(PLAN_KW), dict(PLAN_KW, code_bytes=33_565, code_cached=False,
                                   n_requests=96)):
        a = port.plan(requester="client", executor="server0", selectivity=selectivity, **kw)
        b = ref.plan(requester="client", executor="server0", selectivity=selectivity, **kw)
        assert _fields(a) == _fields(b)
    for depth in (1, 64):
        a = port.plan_chase(requester="client", executor="server0", depth=depth)
        b = ref.plan_chase(requester="client", executor="server0", depth=depth)
        assert _fields(a) == _fields(b)


def test_selectivity_sweep_crosses_over():
    _, opt = _mixed_optimizer("cpu-bf2")
    lo = opt.plan(requester="client", executor="server0", selectivity=0.05, **PLAN_KW)
    hi = opt.plan(requester="client", executor="server0", selectivity=0.75, **PLAN_KW)
    assert lo.choice == "pushdown" and hi.choice == "pull"
    assert lo.pull_us == hi.pull_us


def test_executor_overhead_flips_the_decision():
    """The identical request refuses pushdown on the DPU (fat per-message
    o_us) but pushes down on the Xeon."""
    _, dpu = _mixed_optimizer("cpu-bf2")
    _, xeon = _mixed_optimizer("cpu-host")
    on_dpu = dpu.plan(requester="client", executor="server0", selectivity=0.75, **PLAN_KW)
    on_xeon = xeon.plan(requester="client", executor="server0", selectivity=0.75, **PLAN_KW)
    assert on_dpu.choice == "pull" and on_xeon.choice == "pushdown"


def test_unadvertised_peer_prices_with_fabric_profile():
    cl, opt = _mixed_optimizer()
    cl.fabric.kill("server0")
    d = opt.plan(requester="client", executor="server0", selectivity=0.5, **PLAN_KW)
    assert d.executor_epoch == 0
    cl_ref, ref = _mixed_optimizer(jax=True)
    cl_ref.fabric.kill("server0")
    e = ref.plan(requester="client", executor="server0", selectivity=0.5, **PLAN_KW)
    assert _fields(d) == _fields(e)


def test_invalidate_all_and_cached_plans():
    _, opt = _mixed_optimizer()
    for sel in (0.1, 0.2):
        opt.plan(requester="client", executor="server0", selectivity=sel, **PLAN_KW)
    opt.plan(requester="client", executor="server1", selectivity=0.1, **PLAN_KW)
    assert opt.cached_plans == 3
    assert opt.invalidate_peer("server1") == 1
    assert opt.invalidate_all() == 2 and opt.cached_plans == 0


# ------------------------------------------------------- the filter operator
@pytest.fixture(scope="module")
def filter_svc():
    cl = port_cluster(2, hetero_wire=True)
    return FilterShardService(cl, vocab=256, dim=16, window=8, seed=7)


def test_filter_matches_oracle_both_placements(filter_svc):
    svc = filter_svc
    los = svc.windows(6, seed=2)
    for sel in (0.05, 0.5, 0.95):
        th = svc.thresh_for_selectivity(sel)
        want = svc.oracle_filter(los, th)
        for arm in ("pushdown", "pull"):
            rep = svc.filter(los, th, placement=arm)
            for got, w in zip(rep.results, want):
                np.testing.assert_array_equal(got, w)


def test_filter_wire_bytes_scale_with_selectivity(filter_svc):
    svc = filter_svc
    los = svc.windows(8, seed=3)
    th_lo = svc.thresh_for_selectivity(0.05)
    th_hi = svc.thresh_for_selectivity(0.95)
    svc.filter(los, th_lo)  # warm
    lo = svc.filter(los, th_lo).put_bytes
    hi = svc.filter(los, th_hi).put_bytes
    assert lo < hi, "ragged RETURNs must shrink with survivors"


def test_filter_rejects_misaligned_windows(filter_svc):
    svc = filter_svc
    boundary = svc.rows_per_shard - svc.n_keys // 2
    with pytest.raises(ValueError, match="crosses a shard boundary"):
        svc.filter([boundary], 0.0)
    with pytest.raises(ValueError, match="outside the table"):
        svc.filter([svc.vocab - 1], 0.0)


def test_placement_policy_threads_through_cluster():
    cl = port_cluster(2, hetero_wire=True)
    svc = FilterShardService(cl, vocab=256, dim=16, window=8)
    los = svc.windows(3, seed=1)
    th = svc.thresh_for_selectivity(0.5)
    cl.set_placement("pull")
    rep = svc.filter(los, th)
    assert rep.gets == 3 and rep.puts == 0
    cl.set_placement("pushdown")
    rep = svc.filter(los, th)
    assert rep.gets == 0 and rep.puts > 0
    cl.set_placement("auto")  # small operand: the model picks pull here
    rep = svc.filter(los, th)
    assert rep.gets == 3 and rep.puts == 0
    with pytest.raises(ValueError):
        cl.set_placement("sideways")


def test_gather_placement_param():
    cl = port_cluster(2)
    svc = EmbedShardService(cl, vocab=64, dim=8, n_keys=4)
    batches = [np.array([1, 40], np.int32), np.array([9], np.int32)]
    want = svc.oracle(batches)
    for placement in ("pushdown", "pull", "auto", None):
        rep = svc.gather(batches, placement=placement)
        for got, w in zip(rep.results, want):
            np.testing.assert_array_equal(got, w)
    with pytest.raises(ValueError, match="placement must be"):
        svc.gather(batches, placement="sideways")


@pytest.mark.parametrize("service", ["gather", "filter"])
def test_auto_and_an_optimizer_instance_route_like_the_reference(service):
    """``placement="auto"`` and an optimizer passed in take the side the
    reference takes on the same cluster shape, and return the oracle's
    rows."""
    table = np.random.default_rng(1).standard_normal((256, 16)).astype(np.float32)
    routes = {}
    for name, make_cl, Svc, Opt in (
        ("port", port_cluster, (EmbedShardService, FilterShardService), PlacementOptimizer),
        ("jax", JaxCluster, None, JaxOptimizer),
    ):
        if Svc is None:
            from repro.runtime.embed_service import EmbedShardService as JaxEmbedService

            Svc = (JaxEmbedService, JaxFilterService)
        cl = make_cl(n_servers=2, wire="thor_xeon", hetero_wire=True)
        if service == "gather":
            svc = Svc[0](cl, vocab=256, dim=16, n_keys=8, table=table)
            work = [np.array([1, 200, 3], np.int32), np.array([129], np.int32)]
            run = lambda placement: svc.gather(work, placement=placement)
            want = svc.oracle(work)
        else:
            svc = Svc[1](cl, vocab=256, dim=16, window=8, table=table)
            work = svc.windows(4, seed=2)
            th = svc.thresh_for_selectivity(0.25)
            run = lambda placement: svc.filter(work, th, placement=placement)
            want = svc.oracle_filter(work, th)
        for placement in ("auto", Opt(cl)):
            rep = run(placement)
            for got, w in zip(rep.results, want):
                np.testing.assert_array_equal(got, w)
            routes[name, isinstance(placement, str)] = "pull" if rep.gets else "pushdown"
    assert routes["port", True] == routes["jax", True]
    assert routes["port", False] == routes["jax", False]


def test_dapc_placement_pricing():
    _, opt = _mixed_optimizer()
    deep = opt.plan_chase(requester="client", executor="server0", depth=64)
    assert deep.choice == "pushdown"
    assert deep.pull_us > deep.pushdown_us


def test_dapc_placement_priced_for_a_live_app():
    """plan_chase beside a DAPC run on the same cluster: the priced side
    serves the chases the oracle expects."""
    cl = port_cluster(2, hetero_wire=True)
    app = PointerChaseApp(cl, n_entries=256, max_slots=8, seed=1)
    opt = PlacementOptimizer(cl)
    d = opt.plan_chase(requester="client", executor="server0", depth=16)
    starts = np.array([0, 100, 200], np.int32)
    mode = "bitcode" if d.choice == "pushdown" else "gbpc"
    rep = app.dapc(starts, 16, mode=mode)
    assert rep.results.tolist() == [chase_ref(app.table, s, 16) for s in starts]


@pytest.mark.parametrize("triple", sorted(TRIPLE_WIRE))
def test_capability_for_triple_table(triple):
    wire = TRIPLE_WIRE[triple]
    cap = Capability.for_triple(triple, "cpu" if "cpu" in triple else "cuda")
    assert cap.wire == wire
    assert cap.alpha_us == WIRE_PROFILES[wire].alpha_us
    assert cap.scan_Bus > 0
    assert cap.as_dict()["isa"] == triple
    assert cap.mem_bw_class == MEM_BW_CLASS[triple]


# ------------------------------------------ benchmarks/placement.py's cells
SERVER_CELLS = (("dpu", "cpu-bf2"), ("xeon", "cpu-host"))
SELECTIVITIES = (0.05, 0.25, 0.75)
N_SERVERS, N_REQUESTS, WINDOW, DIM, VOCAB = 4, 16, 24, 96, 4096


def _scored(rep, arm, caps, n, operand_bytes):
    """``benchmarks/placement.py``'s ``_scored``."""
    client, server = caps["client"], caps["server0"]
    if arm == "pushdown":
        return (rep.modeled_us + n * (client.o_us + server.o_us)
                + n * operand_bytes / server.scan_Bus)
    return rep.modeled_us + n * operand_bytes / client.scan_Bus


def _cells(make_cluster, Service, Optimizer) -> dict:
    """The benchmark's matrix at N_REQUESTS windows a cell, each cell's arms
    oracle-checked; every server warmed first so no arm carries code."""
    operand = WINDOW * DIM * 4
    out = {}
    for kind, triple in SERVER_CELLS:
        cl = make_cluster(n_servers=N_SERVERS, wire="thor_xeon", server_triple=triple,
                          hetero_wire=True)
        svc = Service(cl, vocab=VOCAB, dim=DIM, window=WINDOW, max_slots=64, seed=0)
        opt = Optimizer(cl)
        caps = cl.capabilities()
        los = svc.windows(N_REQUESTS, seed=1)
        svc.filter([s * svc.rows_per_shard for s in range(N_SERVERS)], 0.0,
                   placement="pushdown")
        for sel in SELECTIVITIES:
            thresh = svc.thresh_for_selectivity(sel)
            want = svc.oracle_filter(los, thresh)
            reps = {arm: svc.filter(los, thresh, placement=arm) for arm in ("pushdown", "pull")}
            for rep in reps.values():
                for got, w in zip(rep.results, want):
                    np.testing.assert_array_equal(got.view(np.int32), w.view(np.int32))
            push, pull = reps["pushdown"], reps["pull"]
            assert push.puts == 2 * N_REQUESTS
            payload_push = (push.put_bytes - N_REQUESTS * (72 + len(svc.op_name))
                            - N_REQUESTS * (72 + len(svc.return_name)))
            scored = {arm: _scored(rep, arm, caps, N_REQUESTS, operand)
                      for arm, rep in reps.items()}
            decision = svc.plan_with(opt, los)
            assert decision == svc.plan_with(opt, los)
            out[kind, sel] = {
                "counters": {arm: (rep.puts, rep.gets, rep.put_bytes, rep.get_bytes,
                                   rep.modeled_us, rep.wire_bytes_by_kind)
                             for arm, rep in reps.items()},
                "payload": (int(payload_push), int(pull.get_bytes)),
                "ab_winner": min(scored, key=scored.get),
                "optimizer": _fields(decision),
            }
    return out


@pytest.fixture(scope="module")
def cells():
    port = _cells(port_cluster, FilterShardService, PlacementOptimizer)
    ref = _cells(JaxCluster, JaxFilterService, JaxOptimizer)
    return port, ref


@pytest.mark.parametrize("sel", SELECTIVITIES)
@pytest.mark.parametrize("kind", [k for k, _ in SERVER_CELLS])
def test_placement_cell_matches_reference(cells, kind, sel):
    port, ref = cells
    a, b = port[kind, sel], ref[kind, sel]
    assert a["counters"] == b["counters"]  # no code bytes: every server was warm
    assert a["payload"] == b["payload"]
    assert a["optimizer"] == b["optimizer"]
    assert a["ab_winner"] == b["ab_winner"] == a["optimizer"][0]
    # and the committed record's prices (rounded as benchmarks/placement.py
    # writes them) and winner at its 96 requests a cell
    bench = json.loads((REPO / "BENCH_placement.json").read_text())
    cell = next(c for c in bench["cells"] if c["servers"] == kind and c["selectivity"] == sel)
    assert cell["optimizer"] == {
        "choice": a["optimizer"][0], "pushdown_us": round(a["optimizer"][1], 6),
        "pull_us": round(a["optimizer"][2], 6), "requester": "client", "executor": "server0",
    }
    assert cell["ab_winner"] == a["ab_winner"]


def test_hardware_sensitive_flip(cells):
    """At selectivity 0.75 the DPU-homed cell refuses pushdown while the
    Xeon-homed cell still pushes down, in both packages."""
    for pkg in cells:
        assert pkg["dpu", 0.75]["ab_winner"] == "pull"
        assert pkg["xeon", 0.75]["ab_winner"] == "pushdown"
        assert pkg["dpu", 0.05]["ab_winner"] == pkg["xeon", 0.05]["ab_winner"] == "pushdown"
