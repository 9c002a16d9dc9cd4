"""Cost-model-driven placement: ship compute to data, or pull data to compute.

The paper's central claim is that moving *code* (a few hundred bytes of
bitcode, sent once thanks to the SenderCache) next to the data beats
moving the *data* to the code — but only when the hardware and the
workload cooperate.  A BlueField DPU has cheap proximity to its DRAM and
an expensive per-message CPU overhead; a Xeon initiator has a fat
read path but pays two wire alphas per GET.  This module prices both
sides of that trade with the same calibrated wire arithmetic the
autotuner replays traces through, and emits a deterministic
:class:`PlacementDecision` that the serving tier
(``runtime/embed_service.py``) and the pointer-chase miniapp consume.

Per request the two scores are::

  pushdown = [cold code frame / n]                      (SenderCache-amortized)
           + lat_req(request frame) + o_req             (initiator posts request)
           + lat_exe(return frame(selectivity)) + o_exe (executor posts survivors)
           + operand_bytes / scan_bw(executor)          (executor touches operand)

  pull     = pull_messages * 2*alpha_req
           + operand_bytes / beta_req                   (GET round trips)
           + operand_bytes / scan_bw(initiator)         (initiator touches operand)

where every coefficient comes from the *advertised capability vector* of
the PE that initiates each message (``Fabric.advertise``), not from a
cluster-wide wire profile — that asymmetry is the whole point: a filter
whose survivors are 5% of the window pushes down on a DPU-homed shard,
and the very same request pulls when the executor's per-message ``o_us``
is high or the selectivity approaches 1.

Decisions are pure float arithmetic over the advertised coefficients:
same capabilities + same arguments is bit-identical, and plans are cached
by argument until :meth:`PlacementOptimizer.invalidate_peer` drops them
(``Cluster.restart_server`` calls that — a restarted PE re-advertises and
its old prices are garbage).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..core.transport import Capability, WireModel

#: Fixed header + trailing MAGIC bytes around one frame's name/payload
#: sections (mirrors ``core/frame.py`` and ``analysis/autotune.py``).
FRAME_OVERHEAD = 64 + 8


def _fallback_capability(wire: WireModel) -> Capability:
    """Price an un-advertised peer with the fabric-wide profile (legacy
    PEs connected before the capability layer, or test doubles)."""
    return Capability(
        isa="unknown",
        platform="cpu",
        wire=wire.name,
        alpha_us=wire.alpha_us,
        beta_Bus=wire.beta_Bus,
        o_us=wire.o_us,
        beta_tput_Bus=wire.beta_tput_Bus or wire.beta_Bus,
        mem_bw_class="ddr-host",
    )


@dataclass(frozen=True)
class PlacementDecision:
    """One priced placement choice (both sides kept for auditability)."""

    choice: str  # "pushdown" | "pull"
    pushdown_us: float  # per-request estimate, code cost amortized over n
    pull_us: float
    requester: str
    executor: str
    requester_epoch: int  # capability epochs the prices were read under
    executor_epoch: int

    @property
    def margin_us(self) -> float:
        """How much the chosen side wins by (>= 0)."""
        return abs(self.pull_us - self.pushdown_us)

    def as_dict(self) -> dict:
        return {
            "choice": self.choice,
            "pushdown_us": round(self.pushdown_us, 6),
            "pull_us": round(self.pull_us, 6),
            "requester": self.requester,
            "executor": self.executor,
        }


class PlacementOptimizer:
    """Prices pushdown vs pull against the fabric's capability registry.

    Construct it over a live :class:`~repro_torch.core.cluster.Cluster`; it
    registers itself so ``Cluster.restart_server`` can invalidate cached
    plans whose prices referenced the dead PE's capability vector.
    """

    def __init__(self, cluster):
        self.cluster = cluster
        self._plans: dict[tuple, PlacementDecision] = {}
        self.priced = 0  # cache misses — observability + tests
        cluster.register_placement(self)

    # -- capability access ---------------------------------------------------
    def capability(self, name: str) -> Capability:
        cap = self.cluster.fabric.capability(name)
        if cap is None:
            return _fallback_capability(self.cluster.fabric.wire)
        return cap

    # -- the decision --------------------------------------------------------
    def plan(
        self,
        *,
        requester: str,
        executor: str,
        operand_bytes: int,
        result_bytes: int,
        selectivity: float = 1.0,
        request_payload_bytes: int = 0,
        op_name: str = "filter",
        return_name: str = "filter_return",
        return_header_bytes: int = 0,
        code_bytes: int = 0,
        code_cached: bool = True,
        n_requests: int = 1,
        pull_messages: int = 1,
    ) -> PlacementDecision:
        """Price one operator placement and cache the decision.

        ``operand_bytes`` is what the executing side must touch per
        request; ``result_bytes * selectivity`` is what comes back over
        the wire under pushdown; ``pull_messages`` is how many GETs the
        pull side needs to fetch the operand (1 for a contiguous window,
        K for K scattered rows).
        """
        key = (
            requester, executor, op_name, return_name,
            int(operand_bytes), int(result_bytes), float(selectivity),
            int(request_payload_bytes), int(return_header_bytes),
            int(code_bytes), bool(code_cached), int(n_requests),
            int(pull_messages),
        )
        hit = self._plans.get(key)
        if hit is not None:
            return hit
        req = self.capability(requester)
        exe = self.capability(executor)
        self.priced += 1
        push = self._pushdown_us(
            req, exe, operand_bytes, result_bytes, selectivity,
            request_payload_bytes, op_name, return_name,
            return_header_bytes, code_bytes, code_cached, n_requests,
        )
        pull = self._pull_us(req, operand_bytes, pull_messages)
        decision = PlacementDecision(
            choice="pushdown" if push < pull else "pull",
            pushdown_us=push,
            pull_us=pull,
            requester=requester,
            executor=executor,
            requester_epoch=req.epoch,
            executor_epoch=exe.epoch,
        )
        self._plans[key] = decision
        return decision

    def _pushdown_us(
        self, req: Capability, exe: Capability,
        operand_bytes: int, result_bytes: int, selectivity: float,
        request_payload_bytes: int, op_name: str, return_name: str,
        return_header_bytes: int, code_bytes: int, code_cached: bool,
        n_requests: int,
    ) -> float:
        req_m, exe_m = req.model(), exe.model()
        code_us = 0.0
        if not code_cached and code_bytes:
            # one cold frame carries the whole fat-bitcode; the
            # SenderCache truncates every later frame, so amortize
            code_us = req_m.latency_us(
                FRAME_OVERHEAD + len(op_name) + request_payload_bytes + code_bytes
            ) / max(n_requests, 1)
        request_us = (
            req_m.latency_us(FRAME_OVERHEAD + len(op_name) + request_payload_bytes)
            + req.o_us
        )
        survivor_bytes = int(math.ceil(selectivity * result_bytes))
        return_us = (
            exe_m.latency_us(
                FRAME_OVERHEAD + len(return_name) + return_header_bytes + survivor_bytes
            )
            + exe.o_us
        )
        scan_us = operand_bytes / exe.scan_Bus
        return code_us + request_us + return_us + scan_us

    def _pull_us(
        self, req: Capability, operand_bytes: int, pull_messages: int
    ) -> float:
        pull_messages = max(int(pull_messages), 1)
        wire_us = (
            pull_messages * 2.0 * req.alpha_us + operand_bytes / req.beta_Bus
        )
        return wire_us + operand_bytes / req.scan_Bus

    # -- pointer-chase placement --------------------------------------------
    def plan_chase(
        self,
        *,
        requester: str,
        executor: str,
        depth: int,
        locality_breaks: int | None = None,
        entry_bytes: int = 4,
        code_bytes: int = 0,
        code_cached: bool = True,
        n_chases: int = 1,
    ) -> PlacementDecision:
        """DAPC vs GBPC through the same arithmetic.

        A chase of ``depth`` hops pulls ``depth`` entry-sized GETs under
        GBPC; under DAPC it ships one request and hops between shards
        only at locality breaks (default: every hop — the worst case the
        paper's Sec. IV-C measures against).
        """
        breaks = depth if locality_breaks is None else locality_breaks
        return self.plan(
            requester=requester,
            executor=executor,
            operand_bytes=depth * entry_bytes,
            # FORWARD frames between shards + one final RETURN payload
            result_bytes=(breaks + 1) * 4 * entry_bytes,
            selectivity=1.0,
            request_payload_bytes=16,
            op_name="chaser",
            return_name="chaser",
            code_bytes=code_bytes,
            code_cached=code_cached,
            n_requests=n_chases,
            pull_messages=depth,
        )

    # -- cache maintenance ---------------------------------------------------
    def invalidate_peer(self, name: str) -> int:
        """Drop every cached plan priced against ``name``'s capability
        vector.  Returns how many plans were dropped."""
        stale = [
            k for k, d in self._plans.items()
            if name in (d.requester, d.executor)
        ]
        for k in stale:
            del self._plans[k]
        return len(stale)

    def invalidate_all(self) -> int:
        n = len(self._plans)
        self._plans.clear()
        return n

    @property
    def cached_plans(self) -> int:
        return len(self._plans)
