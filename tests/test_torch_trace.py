"""Trace capture and replay on the port, against the JAX package.

Ports ``tests/test_trace.py`` (round trip to the live counters, typed
errors on bad files, capture as observation only) onto
``repro_torch.analysis``, and adds the cross-package cases: a warm DAPC
trace from each package is equal event for event, a cold one equal apart
from the code bytes (``send.cb``, and ``n`` / ``by.code`` of the frames
that carry code), each package's trace loads in the other's
``load_trace``, and either package's ``replay_stats`` equals the live
run's counters.
"""

import json
import os
import tempfile

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st  # hypothesis, or local fallback

import repro.analysis as janalysis
import repro.core as jcore
from repro_torch.analysis import (
    EVENT_KINDS,
    SCHEMA,
    Trace,
    TraceError,
    TraceRecorder,
    capture,
    dump_trace,
    load_trace,
    parse_trace,
    pe_stats_subset,
    replay_stats,
    save_trace,
)
from repro_torch.core import Cluster, PointerChaseApp, chase_ref

I32 = np.int32


class _Sink:
    def __init__(self):
        self.lines = []

    def write(self, s):
        self.lines.append(s)

    def text(self) -> str:
        return "".join(self.lines)


def _run_captured(seed: int, depth: int, batching: bool, jax: bool = False, warm: bool = True):
    """One small dapc run under capture (warm by default: code moves off
    the trace); returns (cluster, recorder, live TrafficStats dict, per-PE
    stat deltas), for the port or the JAX package."""
    if jax:
        cl = jcore.Cluster(n_servers=2, wire="thor_xeon")
        app = jcore.PointerChaseApp(cl, n_entries=128, max_slots=8, seed=seed)
        cap, subset = janalysis.capture, janalysis.trace.pe_stats_subset
    else:
        cl = Cluster(n_servers=2, wire="thor_xeon", device="cpu")
        app = PointerChaseApp(cl, n_entries=128, max_slots=8, seed=seed)
        cap, subset = capture, pe_stats_subset
    starts = np.random.default_rng(seed + 1).integers(0, 128, 6).astype(I32)
    if warm:
        app.dapc(starts, depth)
    before = {pe.name: subset(pe.stats) for pe in cl.pes()}
    with cap(cl, meta={"seed": seed}) as rec:
        rep = app.dapc(starts, depth, batching=batching)
    want = np.array([chase_ref(app.table, s, depth) for s in starts], I32)
    np.testing.assert_array_equal(rep.results, want)
    deltas = {}
    for pe in cl.pes():
        after = subset(pe.stats)
        deltas[pe.name] = {k: after[k] - before[pe.name][k] for k in after}
    return cl, rec, cl.fabric.stats.as_dict(), deltas


# ------------------------------------------------------------- round trip
@settings(max_examples=6, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=2**16),
    depth=st.sampled_from([1, 4, 16]),
    batching=st.sampled_from([False, True]),
)
def test_roundtrip_reproduces_live_counters(seed, depth, batching):
    """capture → JSONL → parse → replay == the live run, bit-identical, and
    the port's events are the JAX package's."""
    cl, rec, live, deltas = _run_captured(seed % 97, depth, batching)
    sink = _Sink()
    dump_trace(rec, sink)
    tr = parse_trace(sink.text().splitlines())
    assert len(tr) == len(rec)
    st_, pes = replay_stats(tr)
    assert st_.as_dict() == live
    assert st_.modeled_us == cl.fabric.stats.modeled_us
    assert st_.modeled_tput_us == cl.fabric.stats.modeled_tput_us
    for name, counted in pes.items():
        assert counted == deltas[name], name
    _, jrec, jlive, _ = _run_captured(seed % 97, depth, batching, jax=True)
    assert rec.events == jrec.events
    assert live == jlive


SYNTHETIC = [
    {"k": "put", "src": "a", "dst": "b", "n": 100, "p": 1},
    {"k": "put", "src": "a", "dst": "b", "n": 64, "p": 3,
     "by": {"payload": 24}, "hop": 1, "tn": "t0"},
    {"k": "rput", "src": "a", "dst": "c", "n": 256, "w": 4},
    {"k": "get", "src": "c", "dst": "a", "n": 128},
    {"k": "send", "src": "a", "dst": "b", "n": 90, "p": 1,
     "kind": 1, "name": "f", "pb": 8, "cb": 0, "cached": True},
    {"k": "stall", "src": "a", "dst": "b", "tn": "t1", "budget": True},
    {"k": "retx", "src": "b", "dst": "a", "seq": 3, "n": 72},
    {"k": "ack", "src": "b", "dst": "a", "ack": 5},
    {"k": "poll", "src": "b", "tick": 2, "p": 3},
    {"k": "frame", "src": "a", "dst": "b", "p": 2, "done": True},
    {"k": "ret", "src": "b", "dst": "a", "name": "r", "n": 40,
     "zc": 44, "cached": True, "proto": "zerocopy"},
    {"k": "cq_alloc", "src": "a", "slot": 0, "epoch": 1},
    {"k": "cq_free", "src": "a", "slot": 0},
]


@settings(max_examples=20, deadline=None)
@given(events=st.lists(st.sampled_from(SYNTHETIC), min_size=0, max_size=24))
def test_synthetic_stream_roundtrip(events):
    """Any valid event stream survives serialize → parse unchanged, and
    replays to the same counters in both packages, before and after."""
    rec = TraceRecorder("thor_bf2", meta={"synthetic": True})
    for ev in events:
        ev = dict(ev)
        k = ev.pop("k")
        rec.emit(k, **ev)
    sink = _Sink()
    dump_trace(rec, sink)
    tr = parse_trace(sink.text().splitlines())
    assert tr.events == Trace.from_recorder(rec).events
    assert tr.wire_name == "thor_bf2"
    a, pa = replay_stats(rec)
    b, pb = replay_stats(tr)
    assert a.as_dict() == b.as_dict()
    assert pa == pb
    jtr = janalysis.trace.parse_trace(sink.text().splitlines())
    c, pc = janalysis.replay_stats(jtr)
    assert c.as_dict() == a.as_dict() and pc == pa


def test_save_load_file_roundtrip(tmp_path):
    _, rec, live, _ = _run_captured(3, 4, True)
    path = str(tmp_path / "run.jsonl")
    n = save_trace(rec, path)
    assert n == len(rec)
    tr = load_trace(path)
    assert tr.header["meta"] == {"seed": 3}
    st_, _ = replay_stats(tr)
    assert st_.as_dict() == live


def test_schema_and_kinds_match_the_reference():
    assert SCHEMA == janalysis.trace.SCHEMA == "xrdma-trace/1"
    assert EVENT_KINDS == janalysis.trace.EVENT_KINDS


# ----------------------------------------------------------- typed errors
def _write(tmp_path, text: str) -> str:
    p = tmp_path / "t.jsonl"
    p.write_text(text)
    return str(p)


def test_empty_file_raises_trace_error(tmp_path):
    with pytest.raises(TraceError, match="no header"):
        load_trace(_write(tmp_path, ""))


def test_missing_file_raises_trace_error(tmp_path):
    with pytest.raises(TraceError, match="cannot read"):
        load_trace(str(tmp_path / "absent.jsonl"))


def test_garbage_json_raises_trace_error(tmp_path):
    header = json.dumps({"schema": SCHEMA, "wire": "ideal", "events": 1})
    with pytest.raises(TraceError, match="invalid JSON"):
        load_trace(_write(tmp_path, header + "\n{not json@@@\n"))


def test_wrong_schema_raises_trace_error(tmp_path):
    bad = json.dumps({"schema": "xrdma-trace/999", "events": 0})
    with pytest.raises(TraceError, match="not a xrdma-trace/1"):
        load_trace(_write(tmp_path, bad + "\n"))


def test_non_object_header_raises_trace_error(tmp_path):
    with pytest.raises(TraceError, match="not a xrdma-trace/1"):
        load_trace(_write(tmp_path, "[1,2,3]\n"))


def test_unknown_kind_raises_trace_error(tmp_path):
    header = json.dumps({"schema": SCHEMA, "wire": "ideal", "events": 1})
    ev = json.dumps({"k": "warp", "i": 0, "src": "a"})
    with pytest.raises(TraceError, match="unknown event kind"):
        load_trace(_write(tmp_path, header + "\n" + ev + "\n"))


def test_missing_field_raises_trace_error(tmp_path):
    header = json.dumps({"schema": SCHEMA, "wire": "ideal", "events": 1})
    ev = json.dumps({"k": "put", "i": 0, "src": "a", "dst": "b", "p": 1})
    with pytest.raises(TraceError, match="field 'n'"):
        load_trace(_write(tmp_path, header + "\n" + ev + "\n"))


def test_mistyped_field_raises_trace_error(tmp_path):
    header = json.dumps({"schema": SCHEMA, "wire": "ideal", "events": 1})
    ev = json.dumps({"k": "put", "i": 0, "src": "a", "dst": "b", "n": True, "p": 1})
    with pytest.raises(TraceError, match="field 'n'"):
        load_trace(_write(tmp_path, header + "\n" + ev + "\n"))


def test_truncated_trace_raises_trace_error(tmp_path):
    _, rec, _, _ = _run_captured(0, 4, False)
    sink = _Sink()
    dump_trace(rec, sink)
    lines = sink.text().splitlines()
    truncated = "\n".join(lines[: len(lines) // 2]) + "\n"
    with pytest.raises(TraceError, match="truncated"):
        load_trace(_write(tmp_path, truncated))


def test_event_not_object_raises_trace_error(tmp_path):
    header = json.dumps({"schema": SCHEMA, "wire": "ideal", "events": 1})
    with pytest.raises(TraceError, match="not an object"):
        load_trace(_write(tmp_path, header + "\n[1,2]\n"))


@settings(max_examples=30, deadline=None)
@given(blob=st.binary(min_size=0, max_size=80))
def test_fuzzed_garbage_never_escapes_typed_error(blob):
    """Arbitrary bytes either parse as a valid trace or raise TraceError."""
    fd, path = tempfile.mkstemp(suffix=".jsonl")
    try:
        with os.fdopen(fd, "wb") as fp:
            fp.write(blob)
        try:
            load_trace(path)
        except TraceError:
            pass
    finally:
        os.unlink(path)


# ------------------------------------------------- zero overhead when off
def _small_app():
    cl = Cluster(n_servers=2, wire="ideal", device="cpu")
    return cl, PointerChaseApp(cl, n_entries=64, max_slots=4, seed=0)


def test_no_tracer_attached_by_default():
    cl, app = _small_app()
    assert cl.fabric.tracer is None
    app.dapc(np.array([1, 2, 3], I32), 4)
    assert cl.fabric.tracer is None


def test_capture_detaches_on_exit_and_freezes_recorder():
    cl, app = _small_app()
    starts = np.array([1, 2, 3], I32)
    app.dapc(starts, 4)
    with capture(cl) as rec:
        app.dapc(starts, 4)
    n = len(rec)
    assert n > 0
    assert cl.fabric.tracer is None
    app.dapc(starts, 4)
    assert len(rec) == n


def test_capture_nesting_restores_previous_recorder():
    cl, app = _small_app()
    starts = np.array([1, 2], I32)
    app.dapc(starts, 2)
    with capture(cl) as outer:
        with capture(cl) as inner:
            app.dapc(starts, 2)
        assert cl.fabric.tracer is outer
    assert len(inner) > 0
    assert len(outer) == 0
    assert cl.fabric.tracer is None


def test_capture_is_observation_not_perturbation():
    def run(with_capture: bool):
        cl = Cluster(n_servers=2, wire="thor_bf2", device="cpu")
        app = PointerChaseApp(cl, n_entries=128, max_slots=8, seed=5)
        starts = np.random.default_rng(6).integers(0, 128, 6).astype(I32)
        app.dapc(starts, 8)
        if with_capture:
            with capture(cl) as rec:
                rep = app.dapc(starts, 8, batching=True)
            assert len(rec) > 0
        else:
            rep = app.dapc(starts, 8, batching=True)
        return rep.results, cl.fabric.stats.as_dict()

    res_off, stats_off = run(False)
    res_on, stats_on = run(True)
    np.testing.assert_array_equal(res_off, res_on)
    assert stats_off == stats_on


# ----------------------------------------------------------- cross-package
def _code_free(ev: dict) -> dict:
    """An event without its code bytes: ``cb``, and the wire size of a
    frame that carries code (a ``send`` with ``cb``, a ``put`` whose byte
    kinds name code)."""
    ev = dict(ev)
    carries = ev.pop("cb", 0) > 0 or "code" in ev.get("by", {})
    if carries:
        ev.pop("n", None)
        ev["by"] = {k: v for k, v in ev.get("by", {}).items() if k != "code"}
    return ev


@pytest.mark.parametrize("batching", [False, True], ids=["permsg", "batched"])
def test_warm_traces_equal_event_for_event(batching):
    _, rec, live, deltas = _run_captured(11, 16, batching)
    _, jrec, jlive, jdeltas = _run_captured(11, 16, batching, jax=True)
    assert len(rec) == len(jrec) > 0
    assert rec.events == jrec.events
    assert (live, deltas) == (jlive, jdeltas)


@pytest.mark.parametrize("batching", [False, True], ids=["permsg", "batched"])
def test_cold_traces_equal_apart_from_code_bytes(batching):
    _, rec, _, deltas = _run_captured(12, 8, batching, warm=False)
    _, jrec, _, jdeltas = _run_captured(12, 8, batching, jax=True, warm=False)
    assert len(rec) == len(jrec)
    cb = [ev.get("cb", 0) for ev in rec.events]
    jcb = [ev.get("cb", 0) for ev in jrec.events]
    assert [c > 0 for c in cb] == [c > 0 for c in jcb] and any(cb)
    assert sum(cb) > sum(jcb)  # the port's slices are the larger (ROADMAP F3)
    assert [_code_free(e) for e in rec.events] == [_code_free(e) for e in jrec.events]
    assert deltas == jdeltas


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_traces_cross_load_and_replay_to_live(tmp_path, warm):
    """A trace written by either package loads in the other's
    ``load_trace``, and either package's replay equals the run's live
    counters, the code-carrying cold traces included."""
    for jax, name in ((False, "port"), (True, "jax")):
        _, rec, live, deltas = _run_captured(13, 8, True, jax=jax, warm=warm)
        path = str(tmp_path / f"{name}.jsonl")
        (janalysis.save_trace if jax else save_trace)(rec, path)
        mine, other = load_trace(path), janalysis.load_trace(path)
        assert mine.events == other.events and mine.header == other.header
        for replay, tr in ((replay_stats, mine), (janalysis.replay_stats, other)):
            traffic, pes = replay(tr)
            assert traffic.as_dict() == live
            assert all(pes[pe] == deltas[pe] for pe in pes)
