"""Reliability policy: the knobs the exactly-once delivery layer runs on.

The paper's X-RDMA frames ride UCX's reliable RC transport; the simulated
fabric here is at-least-once *and* — with :meth:`Fabric.set_loss` armed —
lossy.  :class:`ReliabilityConfig` parameterizes the recovery machinery
spread across the PE layers:

* the **sender** (:class:`repro_torch.core.pe.wire.WireLayer`) assigns per-peer
  sequence numbers, keeps the exact transmitted bytes of every unacked
  frame, and retransmits on a tick clock with exponential backoff
  (``rto_ticks``, ``backoff``); a frame retransmitted ``retransmit_budget``
  times without an ACK escalates its peer to *suspect*;
* the **receiver** (:class:`repro_torch.core.pe.progress.ProgressEngine`) ingests
  in seq order (out-of-order frames held, duplicates dropped — exactly-once
  delivery into the lanes), piggybacks cumulative ACKs on every frame it
  sends back, and emits a standalone ACK frame after ``ack_delay`` idle
  ticks so a one-directional flow still completes;
* the **failure detector** (also in the progress engine) declares a
  *suspected* peer dead after ``max_misses`` further silent ticks, then
  clears every piece of state entangled with it — credits, sender-cache
  rows, retransmit queues — the way ``Cluster.restart_server`` does;
* **completion deadlines**: a :class:`repro_torch.core.pe.cq.GatherFuture`
  submitted under reliability expires after ``future_deadline`` ticks, at
  which point the service layer resubmits it to a surviving owner or
  degrades it to a partial result with a per-position validity mask.

Everything defaults to *off*: ``ReliabilityConfig()`` is the pre-reliability
runtime, bit-for-bit (frames carry seq 0 / ack 0 and bypass all of the
above).  ``ReliabilityConfig.on()`` enables the layer with the defaults the
benchmarks use.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ReliabilityConfig:
    """Knobs for the reliable-delivery / failure-recovery layer.

    ``rto_ticks``          base retransmission timeout, in progress-engine
                           ticks (one tick = one ``poll`` of the PE).
    ``backoff``            exponential backoff factor: the (n+1)-th
                           retransmission waits ``rto_ticks * backoff**n``.
    ``retransmit_budget``  retransmissions per frame before the peer is
                           escalated to *suspect* (retransmission pauses).
    ``max_misses``         ticks a suspected peer may stay silent before the
                           failure detector declares it dead.
    ``ack_delay``          ticks a received frame may wait for a piggyback
                           opportunity before a standalone ACK is emitted.
    ``future_deadline``    ticks before an in-flight completion-queue future
                           expires and the service resubmits or degrades it.
    """

    enabled: bool = False
    rto_ticks: int = 4
    backoff: float = 2.0
    retransmit_budget: int = 5
    max_misses: int = 3
    ack_delay: int = 2
    future_deadline: int = 64

    @classmethod
    def on(cls, **kwargs) -> "ReliabilityConfig":
        """The enabled configuration (benchmark/test defaults)."""
        kwargs.setdefault("enabled", True)
        return cls(**kwargs)

    def rto_after(self, attempts: int) -> int:
        """Timeout (ticks) before retransmission number ``attempts + 1``."""
        return max(1, int(math.ceil(self.rto_ticks * self.backoff**attempts)))

    def recovery_horizon(self) -> int:
        """Worst-case ticks from a frame's first transmission to its peer
        being declared dead: every backoff interval, then the detector's
        silence window."""
        return (
            sum(self.rto_after(i) for i in range(self.retransmit_budget))
            + self.max_misses
            + self.ack_delay
        )

    def idle_grace(self) -> int:
        """Zero-progress polls a scheduler loop must tolerate before calling
        the cluster wedged: recovery is *supposed* to look idle between a
        backoff timer arming and firing."""
        return self.recovery_horizon() + 4
