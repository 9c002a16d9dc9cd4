"""Unified trace capture: every wire/runtime event as one replayable record.

The benchmarks so far reported *aggregate* counters (``TrafficStats`` /
``PEStats``).  This module adds the event stream underneath them: a
:class:`TraceRecorder` attached to a :class:`repro_torch.core.transport.Fabric`
(``fabric.tracer``) receives one record per PUT, one-sided write burst,
GET, frame send, credit stall, retransmit, ACK, poll, frame consumption,
RETURN protocol decision, and CQ slot transition — tagged with a global
event index, src/dst endpoint names, byte counts, and tenant.  Captured
runs serialize to JSONL (:func:`save_trace` / :func:`load_trace`) and
replay *losslessly* back into the aggregate counters the live run
reported (:func:`replay_stats`), which is what makes trace-driven
autotuning (:mod:`repro_torch.analysis.autotune`) testable: any knob decision
justified on a trace can be re-derived from the file alone.

Capture is strictly opt-in and zero-overhead when off: every hook in the
core runtime is ``tracer = ...; if tracer is not None: tracer.emit(...)``
— no event objects, no buffering, no per-frame allocation unless a
recorder is attached (tests/test_torch_trace.py pins this down).

Event schema (``"k"`` selects the kind; ``"i"`` is the global sequence):

======== ============================== ===================================
kind     emitted by                     fields beyond k/i
======== ============================== ===================================
put      ``Fabric.put``                 src dst n p [by hop tn lost]
rput     ``Fabric.put_region_multi``    src dst n w [lw gd]
get      ``Fabric.get``                 src dst n [region]
send     ``WireLayer._transmit``        src dst n p kind name pb cb cached
                                        [hop tn seq]
stall    ``WireLayer.put_now``          src dst [tn budget]
retx     ``WireLayer.on_tick``          src dst seq n
ack      ``WireLayer.send_ack``         src dst ack
poll     ``ProgressEngine.poll``        src tick p
frame    ``ProgressEngine`` (consume)   src dst p done
ret      ``PE.return_payload``          src dst name n zc cached proto
cq_alloc ``CompletionQueue.try_alloc``  src slot epoch [tn]
cq_free  ``CompletionQueue._release``   src slot
======== ============================== ===================================

``n`` is always bytes (for ``ret``: the framed payload bytes, with ``zc``
the zero-copy write-burst bytes, ``-1`` when the RETURN has no slab);
``p`` is payload units; ``by`` the :data:`repro_torch.core.transport.BYTE_KINDS`
attribution of a framed PUT.
"""

from __future__ import annotations

import json
from typing import IO, Iterable

from ..core.transport import WIRE_PROFILES, TrafficStats, WireModel

#: Trace file format identifier (first JSONL record's ``schema`` field).
SCHEMA = "xrdma-trace/1"

#: Every event kind a valid trace may contain.
EVENT_KINDS = frozenset(
    {
        "put", "rput", "get", "send", "stall", "retx", "ack",
        "poll", "frame", "ret", "cq_alloc", "cq_free",
    }
)

#: Per-kind required fields (beyond ``k``/``i``) and their types —
#: validated at load time so a replay never dies on ``KeyError``.
_REQUIRED: dict[str, tuple[tuple[str, type], ...]] = {
    "put": (("src", str), ("dst", str), ("n", int), ("p", int)),
    "rput": (("src", str), ("dst", str), ("n", int), ("w", int)),
    "get": (("src", str), ("dst", str), ("n", int)),
    "send": (("src", str), ("dst", str), ("n", int), ("p", int)),
    "stall": (("src", str), ("dst", str)),
    "retx": (("src", str), ("dst", str), ("n", int)),
    "ack": (("src", str), ("dst", str)),
    "poll": (("src", str), ("p", int)),
    "frame": (("src", str), ("dst", str), ("p", int)),
    "ret": (("src", str), ("dst", str), ("n", int)),
    "cq_alloc": (("src", str), ("slot", int)),
    "cq_free": (("src", str), ("slot", int)),
}


class TraceError(ValueError):
    """A trace file/stream is truncated, malformed, or schema-incompatible.

    The *only* error surface of :func:`load_trace`: raw ``KeyError`` /
    ``json.JSONDecodeError`` never escape (garbage input is an expected
    condition for files that travel between machines and CI artifacts)."""


class TraceRecorder:
    """Append-only event sink one :class:`Fabric` publishes into.

    Hot-path contract: :meth:`emit` is only ever called behind a
    ``tracer is not None`` guard, so a detached runtime pays one attribute
    load per hook site and nothing else."""

    __slots__ = ("events", "wire_name", "meta")

    def __init__(self, wire_name: str = "ideal", meta: dict | None = None) -> None:
        self.events: list[dict] = []
        self.wire_name = wire_name
        self.meta = dict(meta or {})

    def emit(self, k: str, **fields) -> None:
        fields["k"] = k
        fields["i"] = len(self.events)
        self.events.append(fields)

    def __len__(self) -> int:
        return len(self.events)


class Trace:
    """A loaded (or freshly captured) trace: header + validated events."""

    __slots__ = ("header", "events")

    def __init__(self, header: dict, events: list[dict]) -> None:
        self.header = header
        self.events = events

    @property
    def wire_name(self) -> str:
        return self.header.get("wire", "ideal")

    @classmethod
    def from_recorder(cls, rec: TraceRecorder) -> "Trace":
        header = {"schema": SCHEMA, "wire": rec.wire_name, "events": len(rec.events)}
        if rec.meta:
            header["meta"] = dict(rec.meta)
        return cls(header, list(rec.events))

    def __len__(self) -> int:
        return len(self.events)


def capture(target, meta: dict | None = None):
    """Context manager: attach a fresh recorder to ``target`` (a Cluster,
    an app holding ``.fabric``, or a Fabric) for the duration of the block.

    >>> with capture(cluster) as rec:
    ...     app.dapc(starts, depth, batching=True)
    >>> save_trace(rec, "run.jsonl")
    """
    return _Capture(target, meta)


class _Capture:
    def __init__(self, target, meta: dict | None) -> None:
        self.fabric = getattr(target, "fabric", target)
        self.meta = meta
        self.recorder: TraceRecorder | None = None
        self._prev = None

    def __enter__(self) -> TraceRecorder:
        self.recorder = TraceRecorder(self.fabric.wire.name, self.meta)
        self._prev = self.fabric.tracer
        self.fabric.tracer = self.recorder
        return self.recorder

    def __exit__(self, *exc) -> None:
        self.fabric.tracer = self._prev


# ------------------------------------------------------------ serialization
def _trace_of(trace) -> Trace:
    if isinstance(trace, TraceRecorder):
        return Trace.from_recorder(trace)
    if isinstance(trace, Trace):
        return trace
    raise TypeError(f"expected Trace or TraceRecorder, got {type(trace).__name__}")


def dump_trace(trace: Trace | TraceRecorder, fp: IO[str]) -> int:
    """Write one header line + one line per event; returns events written."""
    tr = _trace_of(trace)
    fp.write(json.dumps(tr.header, separators=(",", ":")) + "\n")
    for ev in tr.events:
        fp.write(json.dumps(ev, separators=(",", ":")) + "\n")
    return len(tr.events)


def save_trace(trace: Trace | TraceRecorder, path: str) -> int:
    with open(path, "w") as fp:
        return dump_trace(trace, fp)


def _check_event(ev, lineno: int) -> dict:
    if not isinstance(ev, dict):
        raise TraceError(f"line {lineno}: event is not an object")
    kind = ev.get("k")
    if kind not in EVENT_KINDS:
        raise TraceError(f"line {lineno}: unknown event kind {kind!r}")
    for name, typ in _REQUIRED[kind]:
        val = ev.get(name)
        # bool is an int subclass; an int field holding True is garbage
        if not isinstance(val, typ) or (typ is int and isinstance(val, bool)):
            raise TraceError(
                f"line {lineno}: {kind!r} event field {name!r} missing or "
                f"not {typ.__name__} (got {val!r})"
            )
    return ev


def parse_trace(lines: Iterable[str]) -> Trace:
    """Parse JSONL trace lines; every malformation raises :class:`TraceError`."""
    header: dict | None = None
    events: list[dict] = []
    lineno = 0
    for line in lines:
        lineno += 1
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise TraceError(f"line {lineno}: invalid JSON ({e.msg})") from None
        if header is None:
            if not isinstance(obj, dict) or obj.get("schema") != SCHEMA:
                raise TraceError(
                    f"line 1: not a {SCHEMA} trace header "
                    f"(got {obj.get('schema') if isinstance(obj, dict) else obj!r})"
                )
            header = obj
            continue
        events.append(_check_event(obj, lineno))
    if header is None:
        raise TraceError("empty trace: no header line")
    declared = header.get("events")
    if isinstance(declared, int) and declared != len(events):
        raise TraceError(
            f"truncated trace: header declares {declared} events, file has "
            f"{len(events)}"
        )
    return Trace(header, events)


def load_trace(path: str) -> Trace:
    """Load + validate one JSONL trace file; raises :class:`TraceError` on
    any truncation or garbage (never ``KeyError``/``JSONDecodeError``)."""
    try:
        with open(path) as fp:
            return parse_trace(fp)
    except OSError as e:
        raise TraceError(f"cannot read trace {path!r}: {e}") from None
    except UnicodeDecodeError as e:
        raise TraceError(f"trace {path!r} is not UTF-8 text: {e}") from None


# ------------------------------------------------------------------- replay
def replay_stats(
    trace: Trace | TraceRecorder, wire: WireModel | str | None = None
) -> tuple[TrafficStats, dict[str, dict[str, int]]]:
    """Re-derive the live run's aggregate counters from the event stream.

    Returns ``(traffic, pe_stats)`` where ``traffic`` reproduces every
    field of the fabric's :class:`TrafficStats` — including the modeled
    float accumulators, bit-identically, because events replay in emission
    order through the same arithmetic — and ``pe_stats`` maps PE name to
    the trace-visible :class:`PEStats` subset: ``sends``, ``code_sends``,
    ``credit_stalls``, ``retransmits``, ``acks_sent``, ``msgs``,
    ``zerocopy_returns``, ``rndv_returns``.
    """
    tr = _trace_of(trace)
    if wire is None:
        wire = tr.wire_name
    w = WIRE_PROFILES[wire] if isinstance(wire, str) else wire
    st = TrafficStats()
    pes: dict[str, dict[str, int]] = {}

    def pe(name: str) -> dict[str, int]:
        got = pes.get(name)
        if got is None:
            got = pes[name] = {
                "sends": 0, "code_sends": 0, "credit_stalls": 0,
                "retransmits": 0, "acks_sent": 0, "msgs": 0,
                "zerocopy_returns": 0, "rndv_returns": 0,
            }
        return got

    for ev in tr.events:
        k = ev["k"]
        if k == "put":
            n = ev["n"]
            t = w.latency_us(n)
            st.puts += 1
            st.put_bytes += n
            st.modeled_us += t
            st.modeled_tput_us += w.inverse_throughput_us(n)
            by = ev.get("by")
            st.add_kinds(by if by is not None else {"payload": n})
            p = ev["p"]
            if p > 1:
                st.coalesced_frames += 1
                st.coalesced_payloads += p
            if ev.get("hop"):
                st.hop_frames += 1
                st.hop_bytes += n
            tn = ev.get("tn")
            if tn is not None:
                st.tenant_puts[tn] = st.tenant_puts.get(tn, 0) + 1
                st.tenant_put_bytes[tn] = st.tenant_put_bytes.get(tn, 0) + n
            if ev.get("lost"):
                st.frames_lost += 1
                st.lost_bytes += n
        elif k == "rput":
            n, nw = ev["n"], ev["w"]
            t = w.latency_us(n) + (nw - 1) * w.o_us
            st.region_puts += 1
            st.region_put_bytes += n
            st.modeled_us += t
            st.modeled_tput_us += (nw - 1) * w.o_us + w.inverse_throughput_us(n)
            st.add_kinds({"region": n})
            st.region_writes_lost += ev.get("lw", 0)
            st.region_guard_drops += ev.get("gd", 0)
        elif k == "get":
            n = ev["n"]
            t = 2 * w.alpha_us + n / w.beta_Bus
            st.gets += 1
            st.get_bytes += n
            st.modeled_us += t
            st.modeled_tput_us += t
            st.add_kinds({"region": n})
        elif k == "stall":
            st.credit_stalls += 1
            pe(ev["src"])["credit_stalls"] += 1
            tn = ev.get("tn")
            if ev.get("budget") and tn is not None:
                st.tenant_stalls[tn] = st.tenant_stalls.get(tn, 0) + 1
        elif k == "send":
            d = pe(ev["src"])
            d["sends"] += 1
            if not ev.get("cached", True) and ev.get("cb", 0) > 0:
                d["code_sends"] += 1
        elif k == "retx":
            pe(ev["src"])["retransmits"] += 1
        elif k == "ack":
            pe(ev["src"])["acks_sent"] += 1
        elif k == "frame":
            if ev.get("done", True):
                pe(ev["dst"])["msgs"] += 1
        elif k == "ret":
            proto = ev.get("proto", "framed")
            if proto == "zerocopy":
                pe(ev["src"])["zerocopy_returns"] += 1
            elif proto == "rendezvous":
                pe(ev["src"])["rndv_returns"] += 1
        # poll / cq_alloc / cq_free carry no aggregate counters
    return st, pes


def pe_stats_subset(stats) -> dict[str, int]:
    """Project one live :class:`PEStats` onto the trace-visible subset
    :func:`replay_stats` reconstructs (for round-trip assertions)."""
    return {
        "sends": stats.sends,
        "code_sends": stats.code_sends,
        "credit_stalls": stats.credit_stalls,
        "retransmits": stats.retransmits,
        "acks_sent": stats.acks_sent,
        "msgs": stats.msgs,
        "zerocopy_returns": stats.zerocopy_returns,
        "rndv_returns": stats.rndv_returns,
    }
