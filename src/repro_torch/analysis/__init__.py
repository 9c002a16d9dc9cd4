"""Runtime analysis: replayable trace capture and the knob-space autotuner.

The port's own copies of the reference's numpy-only trace and autotune
modules.  They read the port's wire models (``WIRE_PROFILES``, the
``cuda-sm90`` rows included) and write and read the same
``xrdma-trace/1`` JSONL schema, so a trace captured by either package
loads in the other."""

from .autotune import (
    KNOB_GRID,
    RNDV_OFF,
    FlowProfile,
    ProfileError,
    ReplayModel,
    TuneReport,
    autotune,
    load_traces,
)
from .trace import (
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

__all__ = [
    "EVENT_KINDS",
    "FlowProfile",
    "KNOB_GRID",
    "ProfileError",
    "RNDV_OFF",
    "ReplayModel",
    "SCHEMA",
    "Trace",
    "TraceError",
    "TraceRecorder",
    "TuneReport",
    "autotune",
    "capture",
    "dump_trace",
    "load_trace",
    "load_traces",
    "parse_trace",
    "pe_stats_subset",
    "replay_stats",
    "save_trace",
]
