"""Liveness primitive: last-seen heartbeat tracking.

This is the clock-agnostic half of failure detection — track when each
peer was last heard from, declare the silent ones dead after
``max_misses`` intervals.  It lives in ``core`` because the progress
engine's :class:`repro_torch.core.pe.progress.FailureDetector` folds it into
the poll loop (tick-clocked: ``interval_s=1`` tick, every ingested frame
a beat); the wall-clock deployment face (straggler policy, step timers,
the multi-pod monitoring story) stays in :mod:`repro_torch.runtime.monitor`,
which re-exports this class unchanged.
"""

from __future__ import annotations

import time


class HeartbeatMonitor:
    """Tracks last-seen times; a PE missing ``max_misses`` beats is dead."""

    def __init__(self, interval_s: float = 1.0, max_misses: int = 3):
        self.interval_s = interval_s
        self.max_misses = max_misses
        self.last_seen: dict[str, float] = {}
        self.dead: set[str] = set()

    def beat(self, name: str, now: float | None = None) -> None:
        self.last_seen[name] = time.monotonic() if now is None else now
        self.dead.discard(name)

    def check(self, now: float | None = None) -> set[str]:
        """Returns the set of PEs newly declared dead."""
        now = time.monotonic() if now is None else now
        newly = set()
        for name, seen in self.last_seen.items():
            if name in self.dead:
                continue
            if now - seen > self.interval_s * self.max_misses:
                self.dead.add(name)
                newly.add(name)
        return newly
