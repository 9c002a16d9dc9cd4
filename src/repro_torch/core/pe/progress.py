"""Progress engine: the poll loop that drives a PE forward.

This is the paper's 'UCX ifunc polling function' grown into an explicit
runtime layer (HAM keeps its messaging progress separate from execution
for the same reason): one place that ingests arrived wire buffers, decides
*what to work on next*, routes frames to the code-cache / execution
layers, and returns flow-control credits to senders as receive buffers
retire.

Two scheduling features beyond the flat FIFO drain:

* **Priority lanes** (``lanes=True``): arrivals are classified at ingest —
  PUBLISH hop frames and rendezvous descriptors into the *control* lane,
  everything else (ifunc payloads, bulk RETURN data, AMs) into the *data*
  lane — and the control lane drains first.  Under overload a code
  distribution no longer queues behind thousands of bulk RETURNs
  (benchmarks/overload.py measures exactly this inversion).
* **Poll budget** (``budget=N``): at most N *payloads* are processed per
  poll — a coalesced frame counts as its packed payload count, and a frame
  bigger than the remaining budget is consumed partially (the engine
  remembers its offset), so one giant burst cannot blow through the bound.
  The remainder stays queued in the engine's lanes (receive buffers still
  held, so their credits stay consumed — which is what makes the
  sender-side window in :mod:`repro_torch.core.pe.wire` an honest backpressure
  signal).  ``budget=None`` (default) drains everything, which is
  bit-compatible with the pre-layered runtime.

Credits: every framed PUT consumed one receive credit at this endpoint;
the engine returns it to the sender the moment the frame is taken for
processing.  The engine also pumps this PE's own credit-stalled sends at
the end of every poll, so a reopened window is used without waiting for
an unrelated flush.
"""

from __future__ import annotations

from collections import deque
from typing import TYPE_CHECKING

from ..cache import CachedExecutable
from ..frame import (
    CorruptFrame,
    FrameFlags,
    FrameKind,
    ProtocolError,
    peek_header,
    split_hop,
    split_payloads,
    unpack,
    unpack_rndv,
    uvarint_decode,
)
from ..liveness import HeartbeatMonitor
from ..propagate import tree_children
from ..transport import EndpointDead
from .codecache import ISAMismatch
from .wire import is_control

if TYPE_CHECKING:  # pragma: no cover - annotations only
    from .codecache import CodeCacheLayer
    from .exec import ExecLayer
    from .wire import WireLayer


class FailureDetector:
    """Suspect-gated peer-death detection on the progress-engine tick.

    This folds :class:`repro_torch.core.liveness.HeartbeatMonitor` into the
    poll loop: the tick counter is the clock (``interval_s=1`` tick), every
    ingested frame from a peer is its heartbeat, and — the gate — only
    peers the wire layer escalated to *suspect* (retransmit budget
    exhausted) are eligible to be declared dead after ``max_misses`` silent
    ticks.  A healthy-but-quiet peer is never a failure: with nothing
    unacked there is no evidence against it, so the monitor's timeout alone
    must not kill it.  ``declare_dead`` is the bypass for *definitive*
    evidence (a one-sided GET against freed memory).
    """

    def __init__(self, max_misses: int = 3) -> None:
        self.monitor = HeartbeatMonitor(interval_s=1.0, max_misses=max_misses)
        self.suspects: set[str] = set()

    @property
    def dead(self) -> set[str]:
        return self.monitor.dead

    def alive(self, name: str, tick: int) -> None:
        self.monitor.beat(name, now=float(tick))
        self.suspects.discard(name)

    def suspect(self, name: str, tick: int) -> None:
        self.suspects.add(name)
        self.monitor.last_seen.setdefault(name, float(tick))

    def declare_dead(self, name: str) -> bool:
        """Immediate death on definitive evidence; True if newly dead."""
        newly = name not in self.monitor.dead
        self.monitor.dead.add(name)
        self.suspects.add(name)
        return newly

    def check(self, tick: int) -> set[str]:
        """Peers newly declared dead at ``tick`` (suspects only)."""
        newly = self.monitor.check(now=float(tick))
        for name in list(newly):
            if name not in self.suspects:
                self.monitor.dead.discard(name)  # quiet, not suspect: spare
                newly.discard(name)
        return newly

    def forgive(self, name: str) -> None:
        """Forget a peer entirely (it restarted with a fresh identity)."""
        self.monitor.dead.discard(name)
        self.monitor.last_seen.pop(name, None)
        self.suspects.discard(name)


class ProgressEngine:
    """Poll-driven scheduler for one PE: lanes, budget, credits, routing."""

    def __init__(self, rt, wire: "WireLayer", codecache: "CodeCacheLayer",
                 execl: "ExecLayer", stats) -> None:
        self.rt = rt
        self.wire = wire
        self.codecache = codecache
        self.execl = execl
        self.stats = stats  # the PE's PEStats (shared across layers)
        self.lanes = False  # control-before-data drain priority
        self.budget: int | None = None  # payloads processed per poll (None = all)
        # lane entries are mutable [src, buf, consumed_payloads]: a frame
        # bigger than the remaining budget is consumed in pieces, and the
        # offset of the first unprocessed payload rides with the buffer
        self._control: deque[list] = deque()
        self._data: deque[list] = deque()
        self._seen_pubs: set[tuple[bytes, int, int]] = set()  # publish dedup
        # --- reliability (receiver half; sender half in wire.py) ---
        self.tick = 0  # the tick clock: one per poll while reliability is on
        self.detector = FailureDetector()
        # per-source receive state [cum, held]: ``cum`` the contiguous
        # ingest high-water mark (everything <= cum entered the lanes
        # exactly once, in order), ``held`` the out-of-order frames parked
        # until the gap before them fills
        self._recv: dict[str, list] = {}
        self._ack_owed: dict[str, int] = {}  # src -> tick the debt started
        # buffers consumed at the seq gate since the last poll returned
        # (dups dropped, ACKs absorbed, OOO frames parked): link progress
        # the idle detectors must see even though no lane entry resulted
        self._gate_progress = 0
        # publish dedup keys waiting to retire: (src, seq, key) retired
        # once the ack for seq has actually been stamped toward src
        self._pub_log: deque[tuple[str, int, tuple]] = deque()

    # --- lane bookkeeping --------------------------------------------------
    def _ingest(self) -> int:
        """Move arrived wire buffers from the endpoint inbox into the
        engine's lanes, classifying control vs data at ingest (a header
        peek, no full parse).  With lanes disabled everything lands in the
        data lane in arrival order — the flat FIFO of the old runtime.

        With reliability on, ingest is also the seq gate: frames from each
        source enter the lanes in seq order exactly once — duplicates
        (retransmits that raced the ack) are dropped here with their
        credits returned, out-of-order frames are held until the gap
        before them fills, ACK frames are consumed without ever entering a
        lane, and every sequenced frame's piggybacked ack retires the wire
        layer's retransmit state.  Returns buffers drained (held and
        dropped ones included: a duplicate arriving IS link progress)."""
        rel = self.wire.reliability
        n = 0
        for buf in self.rt.endpoint.drain():
            src = getattr(buf, "src", "")
            raw = bytes(buf)
            n += 1
            if not (rel.enabled and src and src != self.rt.name):
                self._admit_lane(src, raw)
                continue
            try:
                hdr = peek_header(raw)
            except CorruptFrame:
                hdr = None  # the error surfaces when the frame is processed
            if hdr is None:
                self._admit_lane(src, raw)
                continue
            self.wire.peer_alive(src)
            self.detector.alive(src, self.tick)
            if hdr.ack:
                self.wire.on_ack(src, hdr.ack)
            if hdr.kind == FrameKind.ACK:
                self.stats.acks_received += 1
                self._gate_progress += 1
                continue  # header-only: no payload, no credit, no lane
            if hdr.seq == 0:
                self._admit_lane(src, raw)  # unsequenced (pre-reliability)
                continue
            st = self._recv.setdefault(src, [0, {}])
            if hdr.seq <= st[0] or hdr.seq in st[1]:
                # duplicate delivery: drop before it can re-invoke, return
                # the receive credit its PUT consumed, re-owe the ack (ours
                # may have been the loss that caused the retransmit)
                self.stats.dup_frames_dropped += 1
                self._gate_progress += 1
                self.rt.fabric.credit_return(
                    src, self.rt.name, self._payloads_in(raw)
                )
                self._owe_ack(src)
                continue
            if hdr.seq > st[0] + 1:
                st[1][hdr.seq] = raw  # out of order: hold for the gap
                self.stats.frames_held_ooo += 1
                self._gate_progress += 1
                continue
            st[0] = hdr.seq
            self._admit_lane(src, raw)
            while st[0] + 1 in st[1]:  # release now-contiguous held frames
                st[0] += 1
                self._admit_lane(src, st[1].pop(st[0]))
            self._owe_ack(src)
        return n

    def _admit_lane(self, src: str, raw: bytes) -> None:
        lane = self._control if self.lanes and self._is_control(raw) else self._data
        lane.append([src, raw, 0])

    def _owe_ack(self, src: str) -> None:
        self._ack_owed.setdefault(src, self.tick)

    def cum_for(self, src: str) -> int:
        """Cumulative ingest high-water mark for ``src`` — what the wire
        layer piggybacks as the ack on every frame sent back to it."""
        st = self._recv.get(src)
        return st[0] if st is not None else 0

    def _is_control(self, raw: bytes) -> bool:
        """Control-lane admission: hop frames, rendezvous descriptors, and
        EXPRESS-flagged tenant frames — but only when they are
        *self-contained*.  A digest-only frame whose code this PE does not
        hold yet, or a descriptor for an uninstalled ifunc, depends on an
        earlier code-carrying data frame; promoting it past that frame
        would turn the sender-cache truncation protocol's in-order
        assumption into a spurious stale-cache refusal, so those stay in
        FIFO order with the data lane.  EXPRESS is a receive-side drain
        priority only: the frames still consumed credits at the sender
        (see :mod:`repro_torch.core.pe.wire`)."""
        try:
            hdr = peek_header(raw)
        except CorruptFrame:
            return False  # the error surfaces when the frame is processed
        if hdr is None:
            return False
        if is_control(int(hdr.kind), int(hdr.flags)):
            if hdr.flags & FrameFlags.HOP:
                has_code = len(raw) >= hdr.full_total and hdr.code_len > 0
                return has_code or (
                    self.codecache.cache.lookup_digest(hdr.digest.hex()) is not None
                )
            # rendezvous descriptors never carry code: the exe must be resident
            return self.codecache.cache.has_name(hdr.name)
        if hdr.flags & FrameFlags.EXPRESS:
            # an express tenant frame drains ahead of bulk data when it is
            # self-contained (code on board or already resident)
            has_code = len(raw) >= hdr.full_total and hdr.code_len > 0
            return has_code or (
                self.codecache.cache.lookup_digest(hdr.digest.hex()) is not None
            )
        return False

    def pending(self) -> int:
        """Frames held in the engine's lanes (ingested, not yet processed)."""
        return len(self._control) + len(self._data)

    def forget_publisher(self, root: int) -> None:
        """Drop publish-dedup state for one root peer index.  A restarted
        peer re-mints pub_ids from zero; without this, its fresh publishes
        of already-seen code collide with the stale (digest, root, pub_id)
        keys recorded for its previous life and are silently dropped as
        duplicates — exactly-once would quietly become at-most-zero."""
        self._seen_pubs = {k for k in self._seen_pubs if k[1] != root}

    def _front(self) -> deque | None:
        """The lane to serve next: control drains before data."""
        if self._control:
            return self._control
        if self._data:
            return self._data
        return None

    def _take(self) -> list | None:
        """Pop the next whole frame to process — control lane first — and
        return its receive credits to the sender (the buffer is consumed)."""
        lane = self._front()
        if lane is None:
            return None
        entry = lane.popleft()
        self.rt.fabric.credit_return(
            entry[0], self.rt.name, self._payloads_in(entry[1]) - entry[2]
        )
        return entry

    @staticmethod
    def _payloads_in(buf: bytes) -> int:
        """Payload units one wire buffer carries (1, or a BATCH frame's
        packed count) — the currency the poll budget is denominated in.
        Malformed frames count as 1; their error surfaces at processing."""
        try:
            hdr = peek_header(buf)
        except CorruptFrame:
            return 1
        if hdr is None or not hdr.flags & FrameFlags.BATCH:
            return 1
        try:
            return max(1, uvarint_decode(buf, hdr.header_len)[0])
        except (CorruptFrame, IndexError):
            return 1

    # --- the poll loop -----------------------------------------------------
    def poll(self, max_msgs: int | None = None) -> int:
        """Drain the endpoint buffer, installing and invoking arrivals.

        With :attr:`WireLayer.batching` on, the drained frames are grouped
        by code digest, each group's payloads are decoded into one
        ``(B, ...)`` block and retired by a single batched dispatch,
        and everything the dispatches emitted is flushed as coalesced
        per-destination PUTs.  Returns a progress count: frames processed
        plus credit-stalled sends pumped.
        """
        budget = max_msgs if max_msgs is not None else self.budget
        rel = self.wire.reliability
        if rel.enabled:
            self.tick += 1
        if self.wire.batching:
            processed = self._poll_batched(budget)
        else:
            processed = self._poll_single(budget)
        processed += self.wire.pump()
        if rel.enabled:
            processed += self._reliability_tick()
            processed += self._gate_progress
            self._gate_progress = 0
        return processed

    def _reliability_tick(self) -> int:
        """The per-poll reliability work: drive the sender's retransmit
        clock, flush overdue standalone ACKs, retire publish-dedup keys
        whose seq window is now cumulatively acked, and run the failure
        detector.  Returns a progress count (retransmits + acks + deaths —
        recovery activity must read as progress to the idle detectors)."""
        rel = self.wire.reliability
        n = self.wire.on_tick(self.tick)
        for src, since in list(self._ack_owed.items()):
            cum = self.cum_for(src)
            if cum <= self.wire.acked_sent(src):
                del self._ack_owed[src]  # a piggyback already covered it
                continue
            if self.tick - since >= rel.ack_delay:
                self.wire.send_ack(src, cum)
                del self._ack_owed[src]
                n += 1
        # bounded publish-dedup memory: once the ack for a key's carrying
        # frame has been stamped toward its sender, every future replay of
        # that frame dies at the seq gate before reaching the publish
        # handler — the key has no work left to do
        while self._pub_log:
            src, seq, key = self._pub_log[0]
            if seq > self.wire.acked_sent(src):
                break
            self._seen_pubs.discard(key)
            self._pub_log.popleft()
        for name in self.detector.check(self.tick):
            self.rt.on_peer_dead(name)
            n += 1
        return n

    def forget_src(self, src: str) -> None:
        """Drop receiver-side reliability state for one peer (declared
        dead or restarted): its seq stream restarts from zero with its
        next life, so held fragments and the old high-water mark are
        meaningless — keeping them would silently swallow the fresh
        stream's first frames as duplicates."""
        self._recv.pop(src, None)
        self._ack_owed.pop(src, None)
        if self._pub_log:
            self._pub_log = deque(e for e in self._pub_log if e[0] != src)

    def _poll_single(self, budget: int | None) -> int:
        """Per-message mode: handle frames one at a time, FIFO within each
        lane.  The first bad frame raises immediately (the old runtime's
        blast radius); the rest stays queued for the next poll."""
        self._ingest()
        n = used = 0
        while budget is None or used < budget:
            # re-ingest when the lanes run dry: a handler's sends may
            # deliver to this very endpoint (self-directed frames), and
            # the old drain loop picked those up within the same poll
            if not self.pending() and self._ingest() == 0:
                break
            entry = self._take()
            if entry is None:
                break
            # entry[2] is nonzero when a previous *batched* poll consumed
            # the frame partially and the mode switched: resume from the
            # recorded offset or the retired payloads would invoke twice
            consumed = self._payloads_in(entry[1]) - entry[2]
            used += consumed
            self.execute_frame(entry[1], start=entry[2], src=entry[0])
            n += 1
            self.stats.msgs += 1
            tracer = getattr(self.rt.fabric, "tracer", None)
            if tracer is not None:
                tracer.emit(
                    "frame", src=entry[0], dst=self.rt.name, p=consumed, done=True
                )
        if n:
            tracer = getattr(self.rt.fabric, "tracer", None)
            if tracer is not None:
                tracer.emit("poll", src=self.rt.name, tick=self.tick, p=used)
        return n

    def _poll_batched(self, budget: int | None) -> int:
        """Batched mode: take up to ``budget`` payloads (control lane
        first, big coalesced frames consumed partially), handle control/AM
        inline, group data payloads by code digest, and retire each group
        in ONE batched dispatch; then flush the coalesced output burst
        even if a frame was bad."""
        self._ingest()
        taken: list[tuple[bytes, int, int | None, str]] = []  # (buf, start, stop, src)
        used = 0
        tracer = getattr(self.rt.fabric, "tracer", None)
        while budget is None or used < budget:
            lane = self._front()
            if lane is None:
                break
            src, raw, start = lane[0]
            n_pay = self._payloads_in(raw)
            remaining = n_pay - start
            take = remaining if budget is None else min(remaining, budget - used)
            if take <= 0:
                break
            used += take
            # credits are payload-denominated: return exactly what this
            # poll consumed, whether or not the frame is finished
            self.rt.fabric.credit_return(src, self.rt.name, take)
            done = start + take >= n_pay
            if tracer is not None:
                tracer.emit(
                    "frame", src=src, dst=self.rt.name, p=take, done=done
                )
            if done:
                taken.append((raw, start, None, src))
                lane.popleft()
                self.stats.msgs += 1
            else:
                # partial consumption: remember the offset, keep the buffer
                # at the lane head for the next poll
                taken.append((raw, start, start + take, src))
                lane[0][2] = start + take
        if taken and tracer is not None:
            tracer.emit("poll", src=self.rt.name, tick=self.tick, p=used)
        if taken:
            try:
                self._execute_batch(taken)
            finally:
                self.wire.flush()  # emitted actions travel even if a frame was bad
        return len(taken)

    # --- frame routing -----------------------------------------------------
    def execute_frame(self, buf: bytes, start: int = 0, src: str = "") -> None:
        """Route one wire buffer: publish hop, AM, rendezvous descriptor,
        or plain ifunc frame (install if needed, invoke per payload).
        ``start`` skips payloads a previous (budgeted, batched) poll
        already retired from this same frame; ``src`` is the sending peer
        when known (reliability bookkeeping)."""
        hdr = peek_header(buf)
        if hdr is None:
            raise ProtocolError("short frame")
        if hdr.flags & FrameFlags.HOP:
            self._handle_publish(buf, hdr, src)
            return
        if hdr.kind == FrameKind.ACTIVE_MESSAGE:
            self._handle_am(unpack(buf, has_code=False), start)
            return
        if hdr.kind == FrameKind.RNDV:
            frame = unpack(buf, has_code=False)
            for desc in split_payloads(frame)[start:]:
                exe, data = self._rndv_pull(frame.name, desc)
                if exe is None:
                    continue  # source died before the pull (detector fed)
                self.execl.invoke(exe, data)
            return
        # ifunc path: does this wire carry code? (sender truncates iff it
        # believes we have it; len tells the truth, the registry must agree)
        exe, frame = self.codecache.resolve_exe(buf, hdr)
        for pay in split_payloads(frame)[start:]:
            self.execl.invoke(exe, pay)

    def _execute_batch(self, bufs: list[tuple[bytes, int, int | None]]) -> None:
        """Group frames by code digest and invoke each group once.

        Each entry is ``(buf, start, stop)``: the payload slice the budget
        admitted this poll (``(buf, 0, None)`` = the whole frame).  A frame
        that fails to resolve (stale sender cache after a restart) or a
        group that fails to invoke (corrupt payload block) must not take
        the rest of the batch down with it: every healthy frame/group is
        still processed, then the first error is re-raised — the same
        blast radius as the per-message path.
        """
        groups: dict[bytes, tuple[CachedExecutable, list[bytes]]] = {}
        errors: list[Exception] = []
        for buf, start, stop, src in bufs:
            try:
                hdr = peek_header(buf)
                if hdr is None:
                    raise ProtocolError("short frame")
                if hdr.flags & FrameFlags.HOP:
                    # publishes are install-dominated and rare (one per PE
                    # per code distribution): handled inline, re-publishes
                    # ride the post-poll flush as everything else does
                    self._handle_publish(buf, hdr, src)
                    continue
                if hdr.kind == FrameKind.ACTIVE_MESSAGE:
                    self._handle_am(unpack(buf, has_code=False), start, stop)
                    continue
                if hdr.kind == FrameKind.RNDV:
                    # pull each staged payload, then fold it into the same
                    # digest group as any framed payloads of the same ifunc:
                    # rendezvous and eager arrivals retire in ONE dispatch
                    frame = unpack(buf, has_code=False)
                    for desc in split_payloads(frame)[start:stop]:
                        exe, data = self._rndv_pull(frame.name, desc)
                        if exe is None:
                            continue  # source died before the pull
                        entry = groups.setdefault(bytes.fromhex(exe.digest), (exe, []))
                        entry[1].append(data)
                    continue
                exe, frame = self.codecache.resolve_exe(buf, hdr)
                entry = groups.setdefault(hdr.digest, (exe, []))
                entry[1].extend(split_payloads(frame)[start:stop])
            except (ProtocolError, ValueError, ISAMismatch, EndpointDead) as e:
                errors.append(e)
        for exe, pays in groups.values():
            try:
                self.execl.invoke_batch(exe, pays)
            except Exception as e:  # noqa: BLE001 - process remaining groups
                errors.append(e)
        if errors:
            raise errors[0]

    # --- handlers ----------------------------------------------------------
    def _handle_am(self, frame, start: int = 0, stop: int | None = None) -> None:
        handler = self.rt.am_table.get(frame.name)
        if handler is None:
            raise ProtocolError(f"{self.rt.name}: no AM handler {frame.name!r}")
        for pay in split_payloads(frame)[start:stop]:
            self.stats.am_handled += 1
            handler(self.rt, pay)

    def _rndv_pull(self, name: str, desc: bytes):
        """Resolve a rendezvous descriptor: GET the staged payload from the
        source's staging region; returns ``(exe, data)``.  The executable
        must already be cached — descriptors cannot carry code (the sender
        only selects rendezvous for cache-warm peers), so a miss here means
        a stale sender cache.  Under reliability, a source that died
        between staging and the pull returns ``(None, None)`` after feeding
        the failure detector (kill-mid-rendezvous: the CQ deadline recovers
        the requester, nothing is left pinned here)."""
        src_idx, token, nbytes = unpack_rndv(desc)  # CorruptFrame if malformed
        exe = self.codecache.cache.lookup(name)
        if exe is None:
            raise ProtocolError(
                f"{self.rt.name}: rendezvous descriptor for unregistered ifunc "
                f"{name!r} (stale sender cache — was this PE restarted?)"
            )
        if not 0 <= src_idx < len(self.rt.peers):
            raise ProtocolError(
                f"{self.rt.name}: rendezvous src index {src_idx} out of range"
            )
        src = self.rt.peers[src_idx]
        try:
            data = self.wire.fetch_rndv(src, token, nbytes)
        except EndpointDead:
            if not self.wire.reliability.enabled:
                raise  # pre-reliability containment: loud at the caller
            # definitive evidence — the staging memory died with its
            # process; skip the detector's silence window entirely
            self.stats.rndv_dead_pulls += 1
            if self.detector.declare_dead(src):
                self.rt.on_peer_dead(src)
            return None, None
        except KeyError:
            # staging ring evicted the region, or the source restarted with
            # fresh (empty) registered memory — loud but contained, like the
            # framed path's stale-sender-cache refusal
            raise ProtocolError(
                f"{self.rt.name}: rendezvous staging region for token {token} "
                f"gone at {src!r} (evicted or source restarted)"
            ) from None
        return exe, data

    def _handle_publish(self, buf: bytes, hdr, src: str = "") -> None:
        """One PUBLISH hop: validate -> install -> invoke -> re-publish.

        The validation ladder runs *before* anything is installed or
        invoked, in blast-radius order (Kourtis et al.: injected code must
        be validated at every hop, not only at the origin):

        1. poisoned code — the code section's sha256 must equal the header
           digest; a mismatch is refused loudly and, crucially, is NOT
           re-published, so a poisoned frame cannot ride the tree.
        2. duplicate — (code digest, root, pub_id) already handled here:
           dropped silently (the fabric is at-least-once; re-delivery is
           normal, and the drop is what makes a forwarding loop starve).
        3. ttl expired — a frame arriving with no hop budget left was
           forwarded by a peer that should have stopped: refused loudly.
        4. cycle — this PE's own index on the visited path: refused loudly
           (the path digest was already verified by the hop parser).

        An accepted publish installs the code, invokes the payload (if the
        publish carries one — a bare publish is pure code distribution),
        and re-publishes code + payload to its tree children with one hop
        spent and itself appended to the path.  Warm children receive
        digest-only frames: the SenderCache truncation applies to hop
        frames exactly as to point-to-point sends.
        """
        has_code = len(buf) >= hdr.full_total and hdr.code_len > 0
        frame = unpack(buf, has_code=has_code)
        if frame.flags & FrameFlags.BATCH:
            raise ProtocolError(f"{self.rt.name}: publish frames never coalesce")
        hop, inner = split_hop(frame.payload)  # CorruptFrame on tampering
        me = self.rt.peer_index(self.rt.name)
        if has_code:
            self.codecache.validate_publish_code(frame, hdr)
        key = (hdr.digest, hop.root, hop.pub_id)
        if key in self._seen_pubs:
            self.stats.publish_dupes += 1
            return
        if hop.ttl <= 0:
            self.stats.refuse("publish_ttl")
            raise ProtocolError(
                f"{self.rt.name}: publish of {hdr.name!r} arrived with expired "
                f"ttl (path {hop.path})"
            )
        if me in hop.path:
            self.stats.refuse("publish_cycle")
            raise ProtocolError(
                f"{self.rt.name}: publish of {hdr.name!r} would cycle — own "
                f"index {me} already on path {hop.path}"
            )
        # the admitting hop's ttl clamps the verifier's capability stamp:
        # code delivered with budget t may never re-mint a tree deeper than t
        if has_code:
            exe = self.codecache.install(frame, admitted_ttl=hop.ttl)
        else:
            exe = self.codecache.resolve_publish_exe(hdr, admitted_ttl=hop.ttl)
        self._seen_pubs.add(key)
        if src and hdr.seq and self.wire.reliability.enabled:
            # queued for retirement once this frame's seq is cumulatively
            # acked toward src (bounded dedup memory under long gossip:
            # replays after that die at the ingest seq gate instead)
            self._pub_log.append((src, hdr.seq, key))
        self.stats.publish_handled += 1
        if inner:
            self.execl.invoke(exe, inner)
        children = tree_children(hop.k, hop.root, me, len(self.rt.peers))
        if not children:
            return
        if hop.ttl < 2:
            self.stats.publish_stopped_ttl += 1
            return
        code = frame.code if has_code else exe.extras.get("code", b"")
        self.rt.publish_to_children(
            hop.child_hop(me),
            FrameKind(exe.kind),
            exe.name,
            inner,
            code,
            exe.deps,
            bytes.fromhex(exe.digest),
        )
