"""Wire layer: frame egress — batching queues, coalesced flush, rendezvous
staging, and per-peer credit-based flow control.

This layer owns everything between "the runtime decided to send a frame"
and "bytes hit the fabric": sequence numbering, the per-destination send
queues the batched runtime coalesces at :meth:`WireLayer.flush`, the
sender-cache truncation decision (code travels once per peer), the
rendezvous staging ring, and the credit window.

Credit-based flow control (the progress-engine half lives in
:mod:`repro_torch.core.pe.progress`): each framed PUT consumes one receive
credit at the destination; when ``credit_window`` is set and the window is
exhausted, further *data* frames queue locally in FIFO order instead of
flooding a slow peer's receive buffer.  Credits return when the receiver's
progress engine processes the frames, and the sender's next
:meth:`pump` (called from its own poll/flush) drains the queue.  Control
frames — PUBLISH hops and rendezvous descriptors — never consume credits:
they are small, latency-critical, and starving them behind bulk data is
exactly the priority inversion the lane/credit design removes.

Multi-tenant QoS (:attr:`WireLayer.tenant_budgets`): a frame tagged with a
tenant additionally charges that tenant's slice of the sender's outgoing
occupancy (the fabric's per-tenant ledger).  A tenant over its budget
stalls *its own* frames in a per-(destination, tenant) queue — other
tenants' frames to the same peer keep flowing, which is the isolation
property.  Stalled frames are unsequenced (seqs are assigned at transmit
time), so cross-tenant reordering at one destination is invisible to the
reliability layer's per-peer streams.  EXPRESS-flagged frames still
consume credits and budgets — the flag only buys drain priority at the
receiver (see :mod:`repro_torch.core.pe.progress`), never window exemption.
"""

from __future__ import annotations

from collections import deque
from typing import TYPE_CHECKING, Callable

import numpy as np

from ..frame import Frame, FrameFlags, FrameKind, coalesce, pack_rndv, rndv_region
from ..reliability import ReliabilityConfig
from ..transport import EndpointDead, Fabric, RegionWrite

if TYPE_CHECKING:  # pragma: no cover - annotations only
    from ..cache import SenderCache
    from ..transport import Endpoint
    from .source import IFunc

# rendezvous staging ring depth: outstanding staged RETURN payloads per PE
# before the oldest registration is reclaimed (bounds pinned memory the way
# a real transport bounds its rendezvous buffer pool)
RNDV_STAGING_DEPTH = 1024


def is_control(kind: int, flags: int) -> bool:
    """The lane classification both ends of the wire agree on: PUBLISH hop
    frames, rendezvous descriptors, and ACKs are control traffic (small,
    latency-critical); everything else — ifunc payloads, RETURN data,
    AMs — is bulk data."""
    return bool(flags & FrameFlags.HOP) or kind in (FrameKind.RNDV, FrameKind.ACK)


class WireLayer:
    """Frame egress for one PE: queues, credits, coalescing, staging."""

    def __init__(
        self,
        name: str,
        fabric: Fabric,
        endpoint: "Endpoint",
        sender_cache: "SenderCache",
        stats,
        peers: list[str],
    ) -> None:
        self.name = name
        self.fabric = fabric
        self.endpoint = endpoint
        self.sender_cache = sender_cache
        self.stats = stats  # the PE's PEStats (shared across layers)
        self.peers = peers  # shared list reference (facade owns it)
        self.batching = False  # batched runtime: queue sends for flush()
        self.caching_enabled = True  # benchmark switch: uncached mode
        self.credit_window = 0  # 0 = flow control off (unlimited window)
        # tenant -> outgoing-payload budget (0/absent = unbudgeted); the
        # per-tenant carve-out of the receive-window occupancy
        self.tenant_budgets: dict[str, int] = {}
        self._seq = 0
        self._sendq: dict[str, list[Frame]] = {}  # per-destination pending frames
        self._regionq: dict[str, list[RegionWrite]] = {}  # pending one-sided writes
        # frames awaiting credits, one FIFO lane per (dst, tenant) so a
        # stalled tenant never heads-of-line-blocks its neighbours
        self._creditq: dict[tuple[str, str | None], deque[Frame]] = {}
        self._rndv_tokens: deque[str] = deque()  # staged rendezvous regions (ring)
        self._rndv_seq = 0
        # --- reliability (sender half; receiver half in progress.py) ---
        self.reliability = ReliabilityConfig()  # disabled by default
        # cumulative-ack provider: the progress engine's per-source ingest
        # high-water mark, stamped into every outgoing frame (piggyback)
        self.ack_provider: Callable[[str], int] | None = None
        # escalation hook: peer exhausted its retransmit budget -> suspect
        self.on_suspect: Callable[[str], None] | None = None
        self._tick = 0  # mirror of the progress engine's tick clock
        self._peer_seq: dict[str, int] = {}  # next seq to assign, per peer
        # per-peer retransmit queue, seq order.  Entries are mutable lists
        # [seq, wire_bytes, n_payloads, kinds, hop, control, due, attempts]:
        # the EXACT first-transmit bytes are kept and resent verbatim, so a
        # retransmitted code-carrying frame is not wrongly truncated by the
        # sender-cache entry its first flight created.
        self._unacked: dict[str, deque[list]] = {}
        self._suspect: set[str] = set()  # budget-exhausted peers (paused)
        self._acked_sent: dict[str, int] = {}  # highest ack stamped per peer

    # --- sequencing -------------------------------------------------------
    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    # --- egress -----------------------------------------------------------
    def put_frame(self, dst: str, frame: Frame) -> int:
        """PUT a frame now, or queue it for the next :meth:`flush`.

        Returns wire bytes sent, or 0 when the frame was queued (the wire
        size of a queued frame is only known after coalescing).
        """
        if self.batching:
            self._sendq.setdefault(dst, []).append(frame)
            return 0
        return self.put_now(dst, frame)

    def put_now(self, dst: str, frame: Frame) -> int:
        """PUT one frame, honouring the credit window and tenant budget.

        Control frames (hop headers, rendezvous descriptors) always
        transmit; a data frame beyond the peer window or its tenant's
        budget — or behind earlier stalled frames of the same (dst,
        tenant) lane, so per-lane FIFO order holds — queues locally and
        travels on a later :meth:`pump`.  Returns wire bytes sent (0 when
        credit-queued).
        """
        if not is_control(int(frame.kind), int(frame.flags)):
            lane = (dst, frame.tenant)
            window_full = bool(self.credit_window) and not self._credit_ok(dst)
            budget_full = not self._tenant_ok(frame.tenant)
            if self._creditq.get(lane) or window_full or budget_full:
                self._creditq.setdefault(lane, deque()).append(frame)
                self.stats.credit_stalls += 1
                self.fabric.stats.credit_stalls += 1
                if budget_full:
                    ts = self.fabric.stats.tenant_stalls
                    ts[frame.tenant] = ts.get(frame.tenant, 0) + 1
                    self.stats.bump_tenant("stalls", frame.tenant)
                tracer = getattr(self.fabric, "tracer", None)
                if tracer is not None:
                    ev = {"src": self.name, "dst": dst}
                    if frame.tenant is not None:
                        ev["tn"] = frame.tenant
                    if budget_full:
                        ev["budget"] = True
                    tracer.emit("stall", **ev)
                return 0
        return self._transmit(dst, frame)

    def _credit_ok(self, dst: str) -> bool:
        return self.fabric.credit_outstanding(self.name, dst) < self.credit_window

    def _tenant_ok(self, tenant: str | None) -> bool:
        if tenant is None:
            return True
        budget = self.tenant_budgets.get(tenant, 0)
        if not budget:
            return True
        return self.fabric.tenant_outstanding(self.name, tenant) < budget

    def _transmit(self, dst: str, frame: Frame) -> int:
        if frame.kind in (FrameKind.ACTIVE_MESSAGE, FrameKind.RNDV):
            cached = True  # AM / rendezvous descriptors never carry code
        else:
            cached = self.caching_enabled and self.sender_cache.check_and_add(
                dst, frame.digest.hex(), len(frame.code)
            )
        rel = self.reliability
        tracked = rel.enabled and dst != self.name
        if tracked:
            # per-peer stream: one seq space per (src, dst), in-order
            # ingest at the receiver (the per-QP ordering of a real RC
            # transport); the piggybacked ack rides for free in the header
            seq = self._peer_seq.get(dst, 0) + 1
            self._peer_seq[dst] = seq
            frame.seq = seq & 0xFFFFFFFF
            frame.ack = self._ack_for(dst)
        wire = frame.wire_bytes(cached=cached)
        kinds = frame.kind_breakdown(cached)
        hop = bool(frame.flags & FrameFlags.HOP)
        self.stats.sends += 1
        if not cached and frame.code:
            self.stats.code_sends += 1
        if tracked:
            self._unacked.setdefault(dst, deque()).append([
                frame.seq, wire, frame.n_payloads, kinds, hop,
                is_control(int(frame.kind), int(frame.flags)),
                self._tick + rel.rto_after(0), 0, frame.tenant,
            ])
        if frame.tenant is not None:
            self.stats.bump_tenant("sends", frame.tenant)
        tracer = getattr(self.fabric, "tracer", None)
        if tracer is not None:
            ev = {
                "src": self.name, "dst": dst, "n": len(wire),
                "p": frame.n_payloads, "kind": int(frame.kind),
                "name": frame.name, "pb": kinds.get("payload", 0),
                "cb": kinds.get("code", 0), "cached": cached,
            }
            if hop:
                ev["hop"] = True
            if frame.tenant is not None:
                ev["tn"] = frame.tenant
            if tracked:
                ev["seq"] = frame.seq
            tracer.emit("send", **ev)
        try:
            self.fabric.put(
                self.name, dst, wire, n_payloads=frame.n_payloads,
                kinds=kinds, hop=hop, tenant=frame.tenant,
            )
        except EndpointDead:
            if not tracked:
                raise
            # under reliability a synchronous dead-endpoint PUT is just a
            # lost frame: it stays on the retransmit queue and the failure
            # detector — not the caller — attributes the death
            self.stats.sends_to_dead += 1
        return len(wire)

    # --- reliability: sender half -----------------------------------------
    def _ack_for(self, dst: str) -> int:
        if self.ack_provider is None:
            return 0
        ack = int(self.ack_provider(dst))
        if ack > self._acked_sent.get(dst, 0):
            self._acked_sent[dst] = ack
        return ack

    def acked_sent(self, peer: str) -> int:
        """Highest cumulative ack this PE has stamped toward ``peer``."""
        return self._acked_sent.get(peer, 0)

    def on_ack(self, peer: str, ack: int) -> None:
        """Retire every unacked frame to ``peer`` with seq <= ``ack``
        (cumulative ACK, piggybacked or standalone)."""
        q = self._unacked.get(peer)
        if not q:
            return
        while q and q[0][0] <= ack:
            q.popleft()
            self.stats.frames_acked += 1
        if not q:
            del self._unacked[peer]

    def peer_alive(self, peer: str) -> None:
        """Any frame from ``peer`` is a sign of life: clear suspicion and
        re-arm its retransmit timers from now."""
        if peer not in self._suspect:
            return
        self._suspect.discard(peer)
        for e in self._unacked.get(peer, ()):
            e[6] = self._tick + self.reliability.rto_after(0)
            e[7] = 0

    def on_tick(self, tick: int) -> int:
        """Drive the retransmit clock one tick: resend every due unacked
        frame (control frames first) with exponential backoff; a frame out
        of budget escalates its peer to *suspect* via :attr:`on_suspect`
        and pauses that peer's retransmissions.  Returns frames resent."""
        self._tick = tick
        rel = self.reliability
        if not rel.enabled:
            return 0
        resent = 0
        for dst in list(self._unacked):
            if dst in self._suspect:
                continue
            q = self._unacked[dst]
            due = [e for e in q if e[6] <= tick]
            if not due:
                continue
            due.sort(key=lambda e: (not e[5], e[0]))  # control first, then seq
            for e in due:
                if e[7] >= rel.retransmit_budget:
                    self._suspect.add(dst)
                    self.stats.peers_suspected += 1
                    if self.on_suspect is not None:
                        self.on_suspect(dst)
                    break
                e[7] += 1
                e[6] = tick + rel.rto_after(e[7])
                self.stats.retransmits += 1
                resent += 1
                tracer = getattr(self.fabric, "tracer", None)
                if tracer is not None:
                    tracer.emit(
                        "retx", src=self.name, dst=dst, seq=e[0], n=len(e[1])
                    )
                try:
                    # the exact bytes of the first flight — same truncation,
                    # same seq, same (now possibly stale, harmlessly lower)
                    # piggybacked ack; the tenant pays for its own
                    # retransmissions (they occupy the same receive buffer)
                    self.fabric.put(
                        self.name, dst, e[1], n_payloads=e[2],
                        kinds=e[3], hop=e[4], tenant=e[8],
                    )
                except EndpointDead:
                    self.stats.sends_to_dead += 1
        return resent

    def send_ack(self, dst: str, ack: int) -> None:
        """Emit one standalone cumulative-ACK frame (header-only, never
        sequenced or retransmitted — ACKs are not acked; a lost one is
        covered by the next piggyback or the sender's retransmit)."""
        frame = Frame(kind=FrameKind.ACK, name="", payload=b"", ack=ack)
        if ack > self._acked_sent.get(dst, 0):
            self._acked_sent[dst] = ack
        wire = frame.wire_bytes(cached=True)
        self.stats.acks_sent += 1
        tracer = getattr(self.fabric, "tracer", None)
        if tracer is not None:
            tracer.emit("ack", src=self.name, dst=dst, ack=ack)
        try:
            # n_payloads=0: an ACK occupies no receive-buffer credit and is
            # consumed at ingest without ever entering a lane
            self.fabric.put(
                self.name, dst, wire, n_payloads=0, kinds={"header": len(wire)}
            )
        except EndpointDead:
            pass  # the detector owns death attribution

    def suspects(self) -> set[str]:
        return set(self._suspect)

    def unacked_frames(self, peer: str | None = None) -> int:
        if peer is not None:
            return len(self._unacked.get(peer, ()))
        return sum(len(q) for q in self._unacked.values())

    def forget_peer(self, peer: str) -> None:
        """Drop every piece of sender-side reliability and queue state for
        ``peer`` (declared dead or restarted): its retransmit queue, its
        seq stream, its credit-stalled frames, its suspicion."""
        dropped = len(self._unacked.pop(peer, ()))
        self.stats.unacked_dropped += dropped
        for lane in [k for k in self._creditq if k[0] == peer]:
            self.stats.credit_dropped += len(self._creditq.pop(lane))
        self._peer_seq.pop(peer, None)
        self._acked_sent.pop(peer, None)
        self._suspect.discard(peer)

    def drop_queued_digest(self, digest: bytes) -> int:
        """Purge every not-yet-transmitted frame carrying ``digest`` from
        the batching send queues and the credit-stall lanes: the digest
        was quarantined, and a queued frame must not carry banished code
        (or a digest-only reference to it) onto the fabric after the
        uninstall.  Returns the number of frames dropped."""
        dropped = 0
        for dst, frames in list(self._sendq.items()):
            kept = [f for f in frames if f.digest != digest]
            dropped += len(frames) - len(kept)
            if kept:
                self._sendq[dst] = kept
            else:
                del self._sendq[dst]
        for lane, q in list(self._creditq.items()):
            kept_q = deque(f for f in q if f.digest != digest)
            dropped += len(q) - len(kept_q)
            if kept_q:
                self._creditq[lane] = kept_q
            else:
                del self._creditq[lane]
        return dropped

    def pump(self) -> int:
        """Transmit credit-stalled frames whose window (and tenant budget)
        reopened; returns the number sent.  Lanes drain independently —
        one tenant's backlog never gates another's.  A destination that
        died while frames were queued loses exactly its own lanes (the
        fabric's loss model — those frames were in flight), counted in
        ``stats.credit_dropped``."""
        sent = 0
        for lane in list(self._creditq):
            dst, tenant = lane
            q = self._creditq[lane]
            while (
                q
                and (not self.credit_window or self._credit_ok(dst))
                and self._tenant_ok(tenant)
            ):
                frame = q.popleft()
                try:
                    self._transmit(dst, frame)
                    sent += 1
                except EndpointDead:
                    self.stats.credit_dropped += 1 + len(q)
                    q.clear()
            if not q:
                del self._creditq[lane]
        return sent

    def queued_credit_frames(
        self, dst: str | None = None, tenant: str | None = None
    ) -> int:
        if dst is not None:
            return sum(
                len(q)
                for lane, q in self._creditq.items()
                if lane[0] == dst and (tenant is None or lane[1] == tenant)
            )
        if tenant is not None:
            return sum(
                len(q) for lane, q in self._creditq.items() if lane[1] == tenant
            )
        return sum(len(q) for q in self._creditq.values())

    # --- one-sided writes -------------------------------------------------
    def put_region(self, dst: str, writes: list[RegionWrite]) -> None:
        """Issue (or, under batching, queue) a slab-write burst to one peer."""
        if self.batching:
            self._regionq.setdefault(dst, []).extend(writes)
        else:
            try:
                self.fabric.put_region_multi(self.name, dst, writes)
            except EndpointDead:
                if not self.reliability.enabled:
                    raise
                # one-sided writes have no retransmit queue (the data lived
                # in the dispatch that produced it): the requester's CQ
                # deadline recovers — resubmit or degrade with a mask
                self.stats.region_write_failures += 1

    # --- batched flush ----------------------------------------------------
    def flush(self) -> int:
        """Emit every queued frame and one-sided write burst.

        A burst of same-type frames to one peer travels as a single
        coalesced PUT (one ``alpha_us``, summed bytes); a burst of queued
        zero-copy slab writes to one peer travels as a single doorbell-
        batched WQE chain (one ``alpha_us``, one ``o_us`` per extra
        segment).  A failing destination (e.g. a killed endpoint) loses
        only its own traffic — every other destination's queue is still
        delivered, then the first error is re-raised.  Returns the number
        of wire operations issued.
        """
        puts = self.pump()
        queued, self._sendq = self._sendq, {}
        regionq, self._regionq = self._regionq, {}
        errors: list[Exception] = []
        for dst, frames in queued.items():
            # group by ifunc type AND payload size (AM payloads are caller-
            # defined and xrdma plen varies, so same-name frames can be
            # ragged — those travel as separate coalesced PUTs), preserving
            # first-seen order.  PUBLISH hop frames never coalesce: each
            # carries its own per-edge path header.  EXPRESS and tenant are
            # part of the key: a coalesced frame has one lane class and one
            # budget to charge, so mixed-QoS bursts travel separately.
            groups: dict[tuple[int, str, bytes, int, int, str | None], list[Frame]] = {}
            for f in frames:
                key = (
                    int(f.kind), f.name, f.digest, len(f.payload),
                    int(f.flags) & (FrameFlags.HOP | FrameFlags.EXPRESS),
                    f.tenant,
                )
                groups.setdefault(key, []).append(f)
            for key, members in groups.items():
                batch = [coalesce(members)] if not key[4] & FrameFlags.HOP else members
                for frame in batch:
                    try:
                        if self.put_now(dst, frame):
                            puts += 1
                    except Exception as e:  # noqa: BLE001 - deliver the rest first
                        errors.append(e)
        for dst, writes in regionq.items():
            try:
                self.fabric.put_region_multi(self.name, dst, writes)
                puts += 1
            except EndpointDead as e:
                if self.reliability.enabled:
                    self.stats.region_write_failures += 1
                else:
                    errors.append(e)
            except Exception as e:  # noqa: BLE001 - deliver the rest first
                errors.append(e)
        if puts:
            self.stats.flushes += 1
        if errors:
            raise errors[0]
        return puts

    # --- rendezvous staging (sender side) ---------------------------------
    def rndv_send(self, dst: str, ifn: "IFunc", pay: np.ndarray) -> None:
        """Rendezvous RETURN: stage the payload in a source-registered
        region and frame only the 16-byte descriptor; the requester pulls
        the data with a one-sided GET (cost ``2*alpha + n/beta``, correct
        when the payload dwarfs ``2*alpha``)."""
        token = self._rndv_seq
        self._rndv_seq += 1
        staging = rndv_region(self.name, token)
        # explicit copy: `pay` may be a view into a whole batched action
        # matrix, and registering the view would pin that matrix in the
        # staging ring long after the dispatch that produced it
        data = np.array(pay, np.int32)
        self.endpoint.register_region(staging, data)
        self._rndv_tokens.append(staging)
        while len(self._rndv_tokens) > RNDV_STAGING_DEPTH:
            self.endpoint.unregister_region(self._rndv_tokens.popleft())
        desc = pack_rndv(self.peers.index(self.name), token, data.nbytes)
        self.put_frame(
            dst,
            Frame(kind=FrameKind.RNDV, name=ifn.name, payload=desc, seq=self.next_seq()),
        )

    def fetch_rndv(self, src: str, token: int, nbytes: int) -> bytes:
        """Pull one staged rendezvous payload from ``src`` (receiver side)."""
        return self.fabric.get(self.name, src, rndv_region(src, token), 0, nbytes)
