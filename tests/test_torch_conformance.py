"""Cross-mode conformance of the port's control layers, against the JAX
package.

Ports the loss, autotune, Gather-loss and Filter loss/sandbox cells of
``tests/test_conformance.py`` and
``tests/test_placement.py::test_flow_profile_carries_placement_knob``.
Every cell runs on both packages from the same seeds: results equal the
numpy oracle bit for bit, loss really happened, and every code-free wire
counter and per-PE counter (retransmits, ACKs, duplicates dropped,
refusals) is the reference's.  The Filter cells also run with
``cuda-sm90`` servers, whose window goes through ``embed_lookup``'s plain
version here (results only: the heterogeneous wire prices that triple
apart from the reference's ``cpu-bf2``).

One reference fault is pinned, not fixed: a batched zero-copy Gather
burst under loss completes requests with all-zero rows, not degraded, in
both packages alike (ROADMAP T14).
"""

from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest

import repro.analysis as janalysis
import repro.core as jcore
import repro.runtime.embed_service as jsvc
import repro_torch.analysis as tanalysis
import repro_torch.core as tcore
import repro_torch.runtime.embed_service as tsvc

I32 = np.int32
SEEDS = (0, 1, 2)
LOSS_RATE = 0.05
JAX = SimpleNamespace(core=jcore, svc=jsvc, analysis=janalysis, kw={})
TORCH = SimpleNamespace(core=tcore, svc=tsvc, analysis=tanalysis, kw={"device": "cpu"})
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


def app_for(P, seed: int, wire: str = "ideal"):
    cl = P.core.Cluster(n_servers=4, wire=wire, **P.kw)
    return P.core.PointerChaseApp(cl, n_entries=512, max_slots=16, seed=seed)


def lossy_app(P, seed: int, loss: float):
    app = app_for(P, seed)
    app.cluster.set_reliability(P.core.ReliabilityConfig.on())
    app.cluster.fabric.set_loss(loss, seed=seed + 1)
    starts = np.random.default_rng(seed + 100).integers(0, app.n_entries, 8).astype(I32)
    return app, starts


def oracle(app, starts, depth):
    return np.array([tcore.chase_ref(app.table, s, depth) for s in starts], I32)


# ------------------------------------------------------------- loss axis
@pytest.mark.parametrize("batching", [False, True], ids=["permsg", "batched"])
@pytest.mark.parametrize("mode", ["bitcode", "binary", "am"])
@pytest.mark.parametrize("seed", SEEDS, ids=lambda s: f"seed{s}")
def test_dapc_conformance_under_loss(seed, mode, batching):
    """Every mode cell survives 5% loss bit-identically, per-message invokes
    equal the lossless run's, and the recovery is the reference's."""
    depth = 16

    def run(P):
        app, starts = lossy_app(P, seed, LOSS_RATE)
        want = oracle(app, starts, depth)
        rep = app.dapc(starts, depth, mode=mode, batching=batching)
        np.testing.assert_array_equal(rep.results, want)
        assert app.cluster.fabric.stats.frames_lost > 0
        if not batching:
            ref_app, ref_starts = lossy_app(P, seed, 0.0)
            ref = ref_app.dapc(ref_starts, depth, mode=mode, batching=False)
            assert rep.invokes == ref.invokes
        return snap(app.cluster, results=rep.results.tolist(), rounds=rep.rounds)

    both(run)


# -------------------------------------------------- autotuned-profile axis
def _tuned(P):
    app = app_for(P, 0, wire="thor_xeon")
    starts = np.random.default_rng(100).integers(0, 512, 8).astype(I32)
    app.dapc(starts, 16)
    with P.analysis.capture(app.cluster) as rec:
        app.dapc(starts, 16)
    return P.analysis.autotune(rec, seed=0).profile


@pytest.fixture(scope="module")
def autotuned_profile():
    """The port's tuned profile, which must be the reference's."""
    prof = _tuned(TORCH)
    assert prof.as_dict() == _tuned(JAX).as_dict()
    return prof


def _stressed(profile):
    return replace(profile, lanes=True, credit_window=8, poll_budget=8, k_code=2)


def _in(P, prof):
    """The same knob set as package ``P``'s FlowProfile."""
    return P.analysis.FlowProfile.from_dict(prof.as_dict())


@pytest.mark.parametrize("variant", ["tuned", "stressed"])
@pytest.mark.parametrize("plane", ["framed", "zerocopy", "rendezvous"],
                         ids=["framed", "zerocopy", "rndv"])
@pytest.mark.parametrize("batching", [False, True], ids=["permsg", "batched"])
@pytest.mark.parametrize("mode", ["bitcode", "binary", "am"])
def test_dapc_conformance_under_autotuned_profile(autotuned_profile, mode, batching, plane,
                                                  variant):
    prof = autotuned_profile if variant == "tuned" else _stressed(autotuned_profile)
    prof = replace(
        prof, batching=batching, zerocopy=plane == "zerocopy",
        eager_max=0 if plane == "zerocopy" else 256,
        rndv_min=0 if plane == "rendezvous" else prof.rndv_min,
    )
    depth = 16

    def run(P):
        p = _in(P, prof)
        app = app_for(P, 0)
        starts = np.random.default_rng(100).integers(0, 512, 8).astype(I32)
        want = oracle(app, starts, depth)
        p.apply(app.cluster)
        rep = app.dapc(starts, depth, mode=mode, batching=p.batching, dataplane=p.dataplane())
        np.testing.assert_array_equal(rep.results, want)
        return snap(app.cluster, results=rep.results.tolist(), rounds=rep.rounds)

    both(run)


@pytest.mark.parametrize("batching", [False, True], ids=["permsg", "batched"])
@pytest.mark.parametrize("mode", ["bitcode", "binary", "am"])
def test_dapc_autotuned_profile_under_loss(autotuned_profile, mode, batching):
    depth = 16
    prof = _stressed(autotuned_profile)

    def run(P):
        app, starts = lossy_app(P, 0, LOSS_RATE)
        want = oracle(app, starts, depth)
        p = _in(P, prof)
        p.apply(app.cluster)
        rep = app.dapc(starts, depth, mode=mode, batching=batching, dataplane=p.dataplane())
        np.testing.assert_array_equal(rep.results, want)
        assert app.cluster.fabric.stats.frames_lost > 0
        return snap(app.cluster, results=rep.results.tolist(), rounds=rep.rounds)

    both(run)


# ------------------------------------------------------ Gather under loss
def _planes(P):
    return {
        "framed": None,
        "zerocopy": P.core.DataPlaneConfig.zero_copy(eager_max=0),
        "rendezvous": P.core.DataPlaneConfig.rendezvous(rndv_min=1),
    }


@pytest.mark.parametrize("plane", ["framed", "zerocopy", "rendezvous"],
                         ids=["framed", "zerocopy", "rndv"])
def test_gather_conformance_under_loss(plane):
    """The Gather service in every plane at 5% loss: oracle rows, and the
    same losses, retransmits and resubmissions as the reference."""
    def run(P):
        cl = P.core.Cluster(n_servers=4, wire="ideal", **P.kw)
        svc = P.svc.EmbedShardService(cl, vocab=128, dim=16, n_keys=6, max_slots=8)
        cl.set_reliability(P.core.ReliabilityConfig.on())
        cl.fabric.set_loss(LOSS_RATE, seed=17)
        batches = jsvc.ragged_batches(128, 16, 6, seed=17)
        rep = svc.gather(batches, dataplane=_planes(P)[plane])
        for got, want in zip(rep.results, svc.oracle(batches)):
            np.testing.assert_array_equal(got, want)
        assert cl.fabric.stats.frames_lost > 0 or cl.fabric.stats.region_writes_lost > 0
        return snap(cl, rows=[r.view(I32).tolist() for r in rep.results], rounds=rep.rounds)

    both(run)


def test_gather_kernel_slice_under_loss_matches_reference():
    """``cuda-sm90`` servers (the kernel's plain version here) under 5%
    loss: the reference's rows and recovery counters."""
    def run(P):
        kw = dict(P.kw, server_triple="cuda-sm90") if P.kw else {}
        cl = P.core.Cluster(n_servers=4, wire="thor_xeon", **kw)
        svc = P.svc.EmbedShardService(cl, vocab=256, dim=8, n_keys=8, max_slots=16)
        cl.set_reliability(P.core.ReliabilityConfig.on())
        cl.fabric.set_loss(LOSS_RATE, seed=5)
        batches = jsvc.ragged_batches(256, 24, 8, seed=5)
        rep = svc.gather(batches, batching=True)
        for got, want in zip(rep.results, svc.oracle(batches)):
            np.testing.assert_array_equal(got, want)
        assert cl.fabric.stats.frames_lost > 0
        return snap(cl, rows=[r.view(I32).tolist() for r in rep.results])

    both(run)


def test_batched_zero_copy_gather_under_loss_is_the_reference_fault():
    """ROADMAP T14, pinned: a batched zero-copy burst at 5% loss completes
    requests with all-zero rows, not degraded, in the reference; the port
    does exactly the same (per-message zero-copy is exact: the cell above)."""
    table = np.random.default_rng(0).standard_normal((1024, 32), dtype=np.float32)

    def run(P):
        cl = P.core.Cluster(n_servers=4, wire="thor_xeon", **P.kw)
        svc = P.svc.EmbedShardService(cl, vocab=1024, dim=32, n_keys=16, max_slots=64,
                                      table=table)
        reqs = jsvc.ragged_batches(1024, 48, 16, seed=3)
        svc.gather([np.array([s * 256], I32) for s in range(4)])
        cl.set_reliability(P.core.ReliabilityConfig.on())
        cl.fabric.set_loss(LOSS_RATE, seed=1)
        rep = svc.gather(reqs, batching=True, dataplane=P.core.DataPlaneConfig.zero_copy(
            eager_max=0))
        want = svc.oracle(reqs)
        bad = [i for i, (g, w) in enumerate(zip(rep.results, want)) if not np.array_equal(g, w)]
        zeros = all(not rep.results[i][np.any(want[i] != rep.results[i], axis=1)].any()
                    for i in bad)
        return snap(cl, bad=bad, zeros=zeros)

    want = run(JAX)
    assert want["bad"] and want["zeros"]  # the fault shows in the reference
    assert run(TORCH) == want


# ------------------------------------------------------------ Filter axis
PLACEMENTS = ("pushdown", "pull", "auto")


def _filter_cell(P, loss: float = 0.0, sandbox: bool = False, triple: str = "cpu-bf2"):
    kw = dict(P.kw, server_triple=triple) if P.kw else {}
    cl = P.core.Cluster(n_servers=4, wire="ideal", hetero_wire=True, **kw)
    svc = P.svc.FilterShardService(cl, vocab=512, dim=16, window=8, max_slots=8, seed=5)
    if sandbox:
        cl.set_sandbox(P.core.SandboxConfig.on())
    if loss:
        cl.set_reliability(P.core.ReliabilityConfig.on())
        cl.fabric.set_loss(loss, seed=11)
    los = svc.windows(12, seed=6)
    th = svc.thresh_for_selectivity(0.4)
    return svc, los, th, svc.oracle_filter(los, th)


def _filter_run(loss, sandbox, placement, triple):
    def run(P):
        svc, los, th, want = _filter_cell(P, loss=loss, sandbox=sandbox, triple=triple)
        rep = svc.filter(los, th, placement=placement)
        for got, w in zip(rep.results, want):
            np.testing.assert_array_equal(got, w, err_msg=f"placement={placement}")
        if loss and placement == "pushdown":
            assert svc.cluster.fabric.stats.frames_lost > 0
        if sandbox:
            assert sum(svc.cluster.refusals().values()) == 0
        return snap(svc.cluster, rows=[r.view(I32).tolist() for r in rep.results])

    return run


@pytest.mark.parametrize("triple", ["cpu-bf2", "cuda-sm90"])
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_filter_placement_conformance_under_loss(placement, triple):
    run = _filter_run(LOSS_RATE, False, placement, triple)
    if triple == "cpu-bf2":
        both(run)
    else:
        run(TORCH)


@pytest.mark.parametrize("triple", ["cpu-bf2", "cuda-sm90"])
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_filter_placement_conformance_under_sandbox(placement, triple):
    """The verifier admits the Filter pair's ABI, the ragged survivor
    RETURN included, and the sandbox refuses nothing."""
    run = _filter_run(0.0, True, placement, triple)
    if triple == "cpu-bf2":
        both(run)
    else:
        run(TORCH)


# --------------------------------------------------- test_placement.py cell
def test_flow_profile_carries_placement_knob():
    assert "placement" in tanalysis.KNOB_GRID
    prof = tanalysis.FlowProfile(wire="thor_xeon", placement="pull")
    assert tanalysis.FlowProfile.from_dict(prof.as_dict()) == prof
    cl = tcore.Cluster(n_servers=1, device="cpu")
    prof.apply(cl)
    assert cl.placement_policy == "pull"
    ref = jcore.Cluster(n_servers=1)
    janalysis.FlowProfile.from_dict(prof.as_dict()).apply(ref)
    assert ref.placement_policy == cl.placement_policy
