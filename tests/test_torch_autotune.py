"""The autotuner on the port, against the JAX package.

Ports ``tests/test_autotune.py`` (determinism, the profile's round trip,
loading a profile into a live cluster) onto ``repro_torch.analysis``, and
adds the cross-package cases: the same warm trace tunes to the same
``FlowProfile.as_dict()`` and the same search in both packages, the
replay prices it alike, and a profile JSON written by the reference loads
through the port's ``Cluster.set_flow(profile=path)``.
"""

import json

import numpy as np
import pytest

import repro.analysis as janalysis
import repro.core as jcore
from repro_torch.analysis import (
    KNOB_GRID,
    RNDV_OFF,
    FlowProfile,
    ProfileError,
    ReplayModel,
    TraceError,
    autotune,
    capture,
    load_trace,
    replay_stats,
    save_trace,
)
from repro_torch.core import Cluster, PointerChaseApp, chase_ref

I32 = np.int32


def _captured(jax: bool):
    """One warm dapc run captured under the default runtime."""
    if jax:
        cl = jcore.Cluster(n_servers=4, wire="thor_xeon")
        app = jcore.PointerChaseApp(cl, n_entries=512, max_slots=16, seed=0)
        cap = janalysis.capture
    else:
        cl = Cluster(n_servers=4, wire="thor_xeon", device="cpu")
        app = PointerChaseApp(cl, n_entries=512, max_slots=16, seed=0)
        cap = capture
    starts = np.random.default_rng(1).integers(0, 512, 16).astype(I32)
    app.dapc(starts, 16)
    app.dapc(starts, 16, batching=True)
    with cap(cl) as rec:
        rep = app.dapc(starts, 16)
    want = np.array([chase_ref(app.table, s, 16) for s in starts], I32)
    np.testing.assert_array_equal(rep.results, want)
    return rec, rep.modeled_us


@pytest.fixture(scope="module")
def captured():
    return _captured(jax=False)


@pytest.fixture(scope="module")
def jax_captured():
    return _captured(jax=True)


# ------------------------------------------------------------ determinism
def test_autotune_is_deterministic(captured):
    rec, _ = captured
    a, b = autotune(rec, seed=0), autotune(rec, seed=0)
    assert a.profile == b.profile
    assert a.as_dict() == b.as_dict()


def test_autotune_deterministic_across_serialization(captured, tmp_path):
    rec, _ = captured
    path = str(tmp_path / "run.jsonl")
    save_trace(rec, path)
    assert autotune(load_trace(path), seed=0).as_dict() == autotune(rec, seed=0).as_dict()


def test_seed_changes_knob_order_not_validity(captured):
    rec, _ = captured
    a, b = autotune(rec, seed=0), autotune(rec, seed=7)
    assert a.knob_order != b.knob_order
    assert a.tuned_us < a.default_us
    assert b.tuned_us < b.default_us


def test_tuned_beats_default_on_replay(captured):
    rec, live_default_us = captured
    rep = autotune(rec, seed=0)
    model = ReplayModel(rec)
    assert model.cost(FlowProfile(wire="thor_xeon")) == pytest.approx(live_default_us, abs=1e-6)
    assert rep.default_us == pytest.approx(live_default_us, abs=1e-6)
    assert rep.tuned_us < rep.default_us
    assert rep.improvement_pct > 0
    assert rep.evaluations >= sum(len(v) for v in KNOB_GRID.values())


def test_autotune_unknown_wire_raises(captured):
    rec, _ = captured
    with pytest.raises(TraceError, match="unknown wire"):
        autotune(rec, wire="warp_drive")


# ------------------------------------------------------ profile round trip
def test_flowprofile_save_load_roundtrip(tmp_path):
    p = FlowProfile(
        wire="thor_bf2", batching=True, lanes=True, credit_window=16, poll_budget=8,
        eager_max=64, rndv_min=4096, zerocopy=True, k_code=3,
        tenant_budgets=(("bg", 4), ("hot", 32)),
    )
    path = str(tmp_path / "prof.json")
    p.save(path)
    assert FlowProfile.load(path) == p
    assert json.load(open(path))["schema"] == "xrdma-flowprofile/1"
    assert janalysis.FlowProfile.load(path).as_dict() == p.as_dict()


def test_flowprofile_defaults_are_runtime_defaults():
    p = FlowProfile(wire="ideal")
    assert not p.batching and not p.lanes and not p.zerocopy
    assert p.credit_window == 0 and p.poll_budget is None
    assert p.eager_max == 256 and p.rndv_min == RNDV_OFF
    assert p.k_code is None and p.tenant_budgets == ()
    assert p.as_dict() == janalysis.FlowProfile(wire="ideal").as_dict()
    assert KNOB_GRID == janalysis.KNOB_GRID


@pytest.mark.parametrize(
    "bad",
    [
        {"schema": "xrdma-flowprofile/999"},
        {"schema": "xrdma-flowprofile/1", "credit_window": "many"},
        {"schema": "xrdma-flowprofile/1", "rndv_min": [1]},
        {"schema": "xrdma-flowprofile/1", "tenant_budgets": {"t": "much"}},
        "not a dict",
        42,
    ],
)
def test_malformed_profile_raises_profile_error(bad):
    with pytest.raises(ProfileError):
        FlowProfile.from_dict(bad)


def test_profile_load_errors_are_typed(tmp_path):
    with pytest.raises(ProfileError, match="cannot read"):
        FlowProfile.load(str(tmp_path / "absent.json"))
    p = tmp_path / "garbage.json"
    p.write_text("{nope")
    with pytest.raises(ProfileError, match="invalid JSON"):
        FlowProfile.load(str(p))


# ------------------------------------------------------------ live loading
def _knobs(cl) -> list:
    return [(pe.batching, pe.lanes, pe.credit_window, pe.poll_budget, pe.dataplane.eager_max,
             pe.dataplane.rndv_min, pe.dataplane.zerocopy, pe.propagation.topology,
             pe.propagation.k, pe.wire.tenant_budgets) for pe in cl.pes()]


def test_set_flow_loads_profile_from_disk(tmp_path):
    prof = FlowProfile(
        wire="ideal", batching=True, lanes=True, credit_window=8, poll_budget=16,
        eager_max=64, rndv_min=4096, zerocopy=True, k_code=2, tenant_budgets=(("bg", 4),),
    )
    path = str(tmp_path / "tuned.json")
    prof.save(path)
    cl = Cluster(n_servers=2, wire="ideal", device="cpu")
    cl.set_flow(profile=path)
    for pe in cl.pes():
        assert pe.batching is True
        assert pe.lanes is True
        assert pe.credit_window == 8
        assert pe.poll_budget == 16
        assert pe.dataplane.eager_max == 64
        assert pe.dataplane.rndv_min == 4096
        assert pe.dataplane.zerocopy is True
        assert pe.propagation.topology == "kary" and pe.propagation.k == 2
        assert pe.wire.tenant_budgets == {"bg": 4}
    ref = jcore.Cluster(n_servers=2, wire="ideal")
    ref.set_flow(profile=path)
    assert _knobs(cl) == _knobs(ref)


def test_set_flow_explicit_kwargs_beat_profile():
    cl = Cluster(n_servers=2, wire="ideal", device="cpu")
    prof = FlowProfile(wire="ideal", lanes=True, credit_window=64, poll_budget=8)
    cl.set_flow(lanes=False, credit_window=4, profile=prof.as_dict())
    for pe in cl.pes():
        assert pe.lanes is False
        assert pe.credit_window == 4
        assert pe.poll_budget == 8


def test_profile_apply_matches_set_flow(tmp_path):
    prof = FlowProfile(wire="ideal", batching=True, lanes=True, credit_window=8)
    a = Cluster(n_servers=2, wire="ideal", device="cpu")
    b = Cluster(n_servers=2, wire="ideal", device="cpu")
    prof.apply(a)
    path = str(tmp_path / "p.json")
    prof.save(path)
    b.set_flow(profile=path)
    assert _knobs(a) == _knobs(b)


def test_tuned_profile_improves_live_run_oracle_identical(captured, tmp_path):
    rec, _ = captured
    tuned = autotune(rec, seed=0).profile
    cl = Cluster(n_servers=4, wire="thor_xeon", device="cpu")
    app = PointerChaseApp(cl, n_entries=512, max_slots=16, seed=0)
    starts = np.random.default_rng(1).integers(0, 512, 16).astype(I32)
    want = np.array([chase_ref(app.table, s, 16) for s in starts], I32)
    app.dapc(starts, 16)
    app.dapc(starts, 16, batching=True)
    default = app.dapc(starts, 16)
    np.testing.assert_array_equal(default.results, want)
    path = str(tmp_path / "tuned.json")
    tuned.save(path)
    cl.set_flow(profile=path)
    live = app.dapc(starts, 16, batching=tuned.batching, dataplane=tuned.dataplane())
    np.testing.assert_array_equal(live.results, want)
    assert live.modeled_us < default.modeled_us
    assert ReplayModel(rec).cost(tuned) == pytest.approx(live.modeled_us, abs=1e-6)


def test_replay_fidelity_of_tuning_trace(captured):
    rec, live_default_us = captured
    st, _ = replay_stats(rec)
    assert st.modeled_us == pytest.approx(live_default_us, abs=1e-9)


# ----------------------------------------------------------- cross-package
def test_same_warm_trace_tunes_alike_in_both_packages(captured, jax_captured):
    """The warm traces are equal event for event, so both tuners walk the
    same search and emit the same profile; each prices it on the other's
    trace exactly as on its own."""
    rec, live_us = captured
    jrec, jlive_us = jax_captured
    assert rec.events == jrec.events
    assert live_us == jlive_us
    for seed in (0, 7):
        got, want = autotune(rec, seed=seed), janalysis.autotune(jrec, seed=seed)
        assert got.profile.as_dict() == want.profile.as_dict()
        assert got.as_dict() == want.as_dict()
    tuned = autotune(rec, seed=0).profile
    jtuned = janalysis.FlowProfile.from_dict(tuned.as_dict())
    assert ReplayModel(rec).cost(tuned) == janalysis.ReplayModel(jrec).cost(jtuned)


def test_reference_profile_loads_through_the_port(jax_captured, tmp_path):
    """A profile the reference tuned and saved installs through the port's
    ``set_flow(profile=path)`` exactly as through the reference's."""
    jrec, _ = jax_captured
    jprof = janalysis.autotune(jrec, seed=0).profile
    path = str(tmp_path / "reference.json")
    jprof.save(path)
    assert FlowProfile.load(path).as_dict() == jprof.as_dict()
    cl = Cluster(n_servers=4, wire="thor_xeon", device="cpu")
    ref = jcore.Cluster(n_servers=4, wire="thor_xeon")
    cl.set_flow(profile=path)
    ref.set_flow(profile=path)
    assert _knobs(cl) == _knobs(ref)
    assert cl.placement_policy == ref.placement_policy


def test_cold_traces_tune_to_the_same_profile():
    """On a cold trace the port's larger code frames (ROADMAP F3) raise the
    replayed cost, yet the search takes the same steps to the same profile
    as the reference's."""
    def cold(jax: bool):
        cap = janalysis.capture if jax else capture
        cl = (jcore.Cluster(n_servers=4, wire="thor_xeon") if jax
              else Cluster(n_servers=4, wire="thor_xeon", device="cpu"))
        app = (jcore.PointerChaseApp if jax else PointerChaseApp)(
            cl, n_entries=512, max_slots=16, seed=0)
        starts = np.random.default_rng(1).integers(0, 512, 16).astype(I32)
        with cap(cl) as rec:
            app.dapc(starts, 16)
        return rec

    got, want = autotune(cold(False), seed=0), janalysis.autotune(cold(True), seed=0)
    assert got.profile.as_dict() == want.profile.as_dict()
    assert [h[:2] for h in got.history] == [h[:2] for h in want.history]
    assert got.default_us > want.default_us  # the code bytes
