"""Health monitoring for the training loop: heartbeats and straggler
detection (the counterpart of ``repro.runtime.monitor``).

``HeartbeatMonitor`` lives in :mod:`repro_torch.core.liveness` and is
re-exported here; ``StragglerPolicy`` and ``StepTimer`` are training-loop
policy.  Straggler policy: per-step wall-time EWMA; a host whose step time
exceeds ``factor`` x the fleet median for ``patience`` consecutive steps is
marked a persistent straggler, which triggers the same elastic path as a
death (drop the host, restore).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

from ..core.liveness import HeartbeatMonitor

__all__ = ["HeartbeatMonitor", "StragglerPolicy", "StepTimer"]


@dataclass
class StragglerPolicy:
    factor: float = 1.7  # x median step time
    patience: int = 5  # consecutive slow steps before acting
    ewma: float = 0.5


class StepTimer:
    """Per-host step-time EWMA + straggler detection."""

    def __init__(self, policy: StragglerPolicy | None = None):
        self.policy = policy or StragglerPolicy()
        self.t: dict[str, float] = {}
        self.slow_streak: dict[str, int] = defaultdict(int)

    def record(self, host: str, step_s: float) -> None:
        a = self.policy.ewma
        self.t[host] = step_s if host not in self.t else a * step_s + (1 - a) * self.t[host]

    def median(self) -> float:
        vals = sorted(self.t.values())
        if not vals:
            return 0.0
        return vals[len(vals) // 2]

    def stragglers(self) -> set[str]:
        med = self.median()
        if med <= 0:
            return set()
        out = set()
        for host, t in self.t.items():
            if t > self.policy.factor * med:
                self.slow_streak[host] += 1
                if self.slow_streak[host] >= self.policy.patience:
                    out.add(host)
            else:
                self.slow_streak[host] = 0
        return out
