"""The PE facade: one processing element, wired from the four runtime layers.

``PE`` composes (and owns the state shared by) the layered runtime:

* :class:`repro_torch.core.pe.wire.WireLayer` — frame egress, batching queues,
  coalesced flush, rendezvous staging, per-peer credit windows.
* :class:`repro_torch.core.pe.codecache.CodeCacheLayer` — install arriving code,
  digest validation, bucketed batched executables.
* :class:`repro_torch.core.pe.exec.ExecLayer` — invoke, the masked-scan update
  ABI, action application.
* :class:`repro_torch.core.pe.progress.ProgressEngine` — the poll loop: priority
  lanes, per-poll budget, credit return.

The facade itself keeps the *policy* the layers are parameterized by —
source registry, dataplane protocol selection, propagation topology,
capability/region linking — plus the source-side API (``send_ifunc``,
``publish_ifunc``, ``submit``).  Everything here is re-exported through
:mod:`repro_torch.core.ifunc`, whose import surface is guaranteed stable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from ..bitcode import local_triple, platform_of, resolve_device
from ..cache import CachedExecutable, SenderCache, TargetCodeCache
from ..dataplane import DataPlaneConfig
from ..frame import Frame, FrameFlags, FrameKind, HopHeader, ProtocolError, pack_hop
from ..propagate import PropagationConfig, tree_children
from ..reliability import ReliabilityConfig
from ..transport import Capability, EndpointDead, Fabric
from ..verify import SandboxConfig, Verifier
from .codecache import CodeCacheLayer
from .cq import CompletionQueue, GatherFuture
from .exec import ExecLayer
from .progress import ProgressEngine
from .source import IFunc, Toolchain
from .wire import WireLayer


@dataclass
class PEStats:
    msgs: int = 0
    ifunc_installs: int = 0
    invokes: int = 0  # dispatches (a batched dispatch counts once)
    batched_invokes: int = 0  # dispatches that retired >1 payload
    invoked_payloads: int = 0  # payloads retired across all dispatches
    forwards: int = 0
    returns: int = 0
    spawns: int = 0
    sends: int = 0  # frames this PE PUT on the wire (any kind)
    code_sends: int = 0  # of those, frames that carried code bytes
    zerocopy_returns: int = 0  # RETURNs that went one-sided (no frame/dispatch)
    rndv_returns: int = 0  # RETURNs that went descriptor + GET
    am_handled: int = 0
    flushes: int = 0
    # --- credit-based flow control (wire layer) ---
    credit_stalls: int = 0  # sends deferred because the peer window was full
    credit_dropped: int = 0  # stalled frames dropped when their peer died
    # --- recursive propagation (PUBLISH hops) ---
    publishes: int = 0  # hop frames sent (root fan-out + re-publishes)
    publish_handled: int = 0  # publishes accepted (installed/invoked) here
    publish_dupes: int = 0  # re-delivered publishes dropped by the dedup key
    publish_stopped_ttl: int = 0  # had children but no hop budget left
    publish_send_failures: int = 0  # child endpoint dead at re-publish time
    # --- reliability layer (sender: wire.py / receiver: progress.py) ---
    retransmits: int = 0  # unacked frames resent after an rto expiry
    frames_acked: int = 0  # unacked frames retired by a cumulative ack
    acks_sent: int = 0  # standalone ACK frames emitted (piggybacks are free)
    acks_received: int = 0  # standalone ACK frames consumed at ingest
    dup_frames_dropped: int = 0  # duplicate deliveries dropped at the seq gate
    frames_held_ooo: int = 0  # out-of-order arrivals parked for a gap
    peers_suspected: int = 0  # retransmit budget exhausted -> suspect
    peers_declared_dead: int = 0  # suspects the failure detector gave up on
    sends_to_dead: int = 0  # PUTs absorbed against a dead endpoint
    unacked_dropped: int = 0  # retransmit-queue frames dropped with a dead peer
    region_write_failures: int = 0  # one-sided bursts absorbed against a dead peer
    rndv_dead_pulls: int = 0  # rendezvous pulls whose source died pre-GET
    jit_ms_total: float = 0.0
    # --- multi-tenant QoS (wire layer) ---
    tenant_sends: dict = field(default_factory=dict)  # frames sent, per tenant
    tenant_stalls: dict = field(default_factory=dict)  # budget stalls, per tenant
    # --- unified refusal accounting (publish path + verifier + quotas) ---
    # reason -> count; reasons: publish_ttl / publish_cycle / publish_digest
    # (the publish-path refusals), verify_quarantined / verify_ops /
    # verify_region / verify_action / verify_ttl (install-time verifier),
    # quota_payload / quota_invokes / quota_actions / quota_fanout (runtime
    # sandbox), quarantine_drop (queued frames purged on quarantine)
    refusals: dict = field(default_factory=dict)

    def refuse(self, reason: str, n: int = 1) -> None:
        self.refusals[reason] = self.refusals.get(reason, 0) + n

    # legacy spellings of the publish-path counters, now keys in the
    # unified dict (read-only: writers must go through refuse())
    @property
    def publish_refused_ttl(self) -> int:
        return self.refusals.get("publish_ttl", 0)

    @property
    def publish_refused_cycle(self) -> int:
        return self.refusals.get("publish_cycle", 0)

    @property
    def publish_refused_digest(self) -> int:
        return self.refusals.get("publish_digest", 0)

    def bump_tenant(self, which: str, tenant: str, n: int = 1) -> None:
        d = self.tenant_sends if which == "sends" else self.tenant_stalls
        d[tenant] = d.get(tenant, 0) + n

    def as_dict(self) -> dict[str, float]:
        d = self.__dict__.copy()
        d["jit_ms_total"] = round(self.jit_ms_total, 3)
        d["tenant_sends"] = dict(self.tenant_sends)
        d["tenant_stalls"] = dict(self.tenant_stalls)
        d["refusals"] = dict(self.refusals)
        return d


class PE:
    """A processing element: endpoint + layered ifunc runtime + local state.

    ``triple`` models the ISA/uarch (hosts are ``cpu-host`` Xeons, DPUs are
    ``cpu-bf2`` BlueField Arm cores, A64FX nodes ``cpu-a64fx``, Hopper cards
    ``cuda-sm90``) and picks the slice a fat-bitcode archive installs;
    ``device`` is where this PE's code runs and its regions are mirrored —
    the card unless the caller names the CPU (see
    :func:`repro_torch.core.bitcode.resolve_device`); ``triple`` defaults to
    the device's own.  Triple *mismatch logic* is real: binary ifuncs
    require an exact triple, fat-bitcode falls back by platform (Sec. III-C).

    The triple's platform must be the device's: a CPU slice on the card
    would run the plain body there and never the card's kernels.  The one
    exception is a ``cuda`` triple on an explicit ``device="cpu"``: its
    slice's custom ops take their plain CPU versions, which is how the
    parity tests run the card's slice on a host.

    Runtime knobs (all default to the pre-layered behaviour):

    * ``batching`` — coalesced sends + grouped single-dispatch polls.
    * ``caching_enabled`` — sender-cache code truncation (benchmark switch).
    * ``credit_window`` — per-peer send window (in payloads); 0 disables
      flow control.
    * ``lanes`` — control-before-data drain priority in the progress engine.
    * ``poll_budget`` — max *payloads* processed per poll (a coalesced
      frame counts as its packed payload count and is consumed partially
      when it exceeds the remainder); ``None`` drains all.
    """

    def __init__(
        self,
        name: str,
        fabric: Fabric,
        triple: str | None = None,
        toolchain: Toolchain | None = None,
        peers: Sequence[str] = (),
        device: "torch.device | str | None" = None,
    ) -> None:
        self.device = resolve_device(device)
        triple = triple or local_triple(self.device)
        platform = platform_of(triple)
        if platform != self.device.type and not (
            platform == "cuda" and self.device.type == "cpu"
        ):
            raise ValueError(
                f"{name}: triple {triple!r} ({platform} slices) cannot run on "
                f"device {self.device}"
            )
        self.name = name
        self.triple = triple
        self.fabric = fabric
        self.endpoint = fabric.connect(name)
        # advertise the platform/capability vector at connect time; a
        # restarted PE re-advertises here with a fresh epoch
        self.capability = fabric.advertise(
            name, Capability.for_triple(triple, platform)
        )
        self.toolchain = toolchain
        self.peers: list[str] = list(peers)
        self.target_cache = TargetCodeCache()
        self.sender_cache = SenderCache()
        self.source_registry: dict[str, IFunc] = {}
        self.am_table: dict[str, Callable[["PE", bytes], None]] = {}
        self.caps: dict[str, np.ndarray] = {}
        self.completed: list[np.ndarray] = []
        self.stats = PEStats()
        self.dataplane = DataPlaneConfig()  # protocol selection (default: framed)
        self.propagation = PropagationConfig()  # tree multicast policy
        self._region_dev: dict[str, tuple[int, torch.Tensor]] = {}
        self._cap_dev: dict[str, torch.Tensor] = {}
        self._pub_seq = 0  # publish ids minted by this PE as a tree root
        # completion queues draining into this PE (quarantine sweeps them)
        self.completion_queues: list[CompletionQueue] = []
        # --- the layers (constructed over the shared state above) ---
        self.verifier = Verifier(name, self.stats)
        self.verifier.local_cleanup = self._quarantine_cleanup
        self.wire = WireLayer(
            name, fabric, self.endpoint, self.sender_cache, self.stats, self.peers
        )
        self.codecache = CodeCacheLayer(
            name, triple, self.target_cache, self.stats, self.verifier,
            device=self.device,
        )
        self.execl = ExecLayer(self, self.codecache, self.stats, self.verifier)
        self.progress = ProgressEngine(
            self, self.wire, self.codecache, self.execl, self.stats
        )
        # reliability cross-wiring: the wire layer piggybacks the progress
        # engine's cumulative acks, and budget exhaustion feeds the
        # progress engine's failure detector
        self.wire.ack_provider = self.progress.cum_for
        self.wire.on_suspect = self._on_peer_suspect
        self.on_peer_dead_callbacks: list[Callable[[str], None]] = []

    # --- runtime knobs (delegated to the owning layer) ---------------------
    @property
    def batching(self) -> bool:
        """Batched runtime: coalesced sends + grouped polls (wire layer)."""
        return self.wire.batching

    @batching.setter
    def batching(self, enabled: bool) -> None:
        self.wire.batching = enabled

    @property
    def caching_enabled(self) -> bool:
        """Sender-cache truncation on/off (benchmark switch, wire layer)."""
        return self.wire.caching_enabled

    @caching_enabled.setter
    def caching_enabled(self, enabled: bool) -> None:
        self.wire.caching_enabled = enabled

    @property
    def credit_window(self) -> int:
        """Per-peer credit window for data frames; 0 = flow control off."""
        return self.wire.credit_window

    @credit_window.setter
    def credit_window(self, window: int) -> None:
        self.wire.credit_window = int(window)

    @property
    def lanes(self) -> bool:
        """Control-before-data drain priority (progress engine)."""
        return self.progress.lanes

    @lanes.setter
    def lanes(self, enabled: bool) -> None:
        self.progress.lanes = enabled

    @property
    def poll_budget(self) -> int | None:
        """Payloads processed per poll (coalesced frames count as their
        packed payload count); ``None`` drains everything."""
        return self.progress.budget

    @poll_budget.setter
    def poll_budget(self, budget: int | None) -> None:
        self.progress.budget = budget

    @property
    def reliability(self) -> ReliabilityConfig:
        """The reliable-delivery / failure-recovery policy (see
        :class:`repro_torch.core.reliability.ReliabilityConfig`); the default
        (disabled) config is the pre-reliability runtime bit-for-bit."""
        return self.wire.reliability

    @reliability.setter
    def reliability(self, config: ReliabilityConfig | None) -> None:
        cfg = config or ReliabilityConfig()
        self.wire.reliability = cfg
        self.progress.detector.monitor.max_misses = cfg.max_misses

    @property
    def sandbox(self) -> SandboxConfig:
        """The safe-code-injection policy (see
        :class:`repro_torch.core.verify.SandboxConfig`); the default (disabled)
        config is the unverified runtime bit-for-bit."""
        return self.verifier.config

    @sandbox.setter
    def sandbox(self, config: SandboxConfig | None) -> None:
        self.verifier.config = config or SandboxConfig()

    # --- failure handling ---------------------------------------------------
    def _on_peer_suspect(self, peer: str) -> None:
        self.progress.detector.suspect(peer, self.progress.tick)

    def on_peer_dead(self, peer: str) -> None:
        """The failure detector declared ``peer`` dead: clear every piece
        of state entangled with it, exactly the invalidation
        :meth:`repro_torch.core.cluster.Cluster.restart_server` performs —
        retransmit/credit queues, seq streams, sender-cache rows, publish
        dedup for its root index, fabric credits — then notify listeners
        (e.g. a service that must degrade or resubmit its futures)."""
        self.stats.peers_declared_dead += 1
        self.forget_peer_state(peer, forgive=False)
        for cb in list(self.on_peer_dead_callbacks):
            cb(peer)

    def forget_peer_state(self, peer: str, forgive: bool = True) -> None:
        """Drop all per-peer runtime state for ``peer`` (both wire and
        progress halves).  ``forgive=True`` additionally clears the
        failure detector's verdict — the restart case, where the peer's
        next life must start with a clean slate."""
        self.wire.forget_peer(peer)
        self.progress.forget_src(peer)
        self.sender_cache.invalidate_endpoint(peer)
        if peer in self.peers:
            self.forget_publisher(self.peer_index(peer))
        self.fabric.clear_peer_credits(self.name, peer)
        if forgive:
            self.progress.detector.forgive(peer)

    def _quarantine_cleanup(self, digest: str, name: str) -> None:
        """Local teardown for one quarantined digest (the verifier's
        ``local_cleanup`` hook): uninstall the compiled executable, forget
        every sender-cache truncation belief, purge queued frames still
        carrying the digest, and degrade in-flight CQ futures waiting on
        it via the validity-mask path instead of letting them hang."""
        exe = self.target_cache.lookup_digest(digest)
        if exe is not None:
            self.target_cache.deregister(exe.name)
        elif name:
            held = self.target_cache.lookup(name)
            if held is not None and held.digest == digest:
                self.target_cache.deregister(name)
        self.sender_cache.invalidate_digest(digest)
        dropped = self.wire.drop_queued_digest(bytes.fromhex(digest))
        if dropped:
            self.stats.refuse("quarantine_drop", dropped)
        for cq in self.completion_queues:
            for fut in list(cq._inflight.values()):
                if fut.code_digest == digest:
                    fut.poison()

    # --- local state ------------------------------------------------------
    def register_region(self, name: str, arr: np.ndarray) -> None:
        self.endpoint.register_region(name, arr)

    def region(self, name: str) -> np.ndarray:
        return self.endpoint.regions[name]

    def region_device(self, name: str) -> torch.Tensor:
        """Device-resident view of a region, cached until the region is
        rewritten (read-mostly shards stay resident, like RDMA-registered
        memory staying pinned).  Versioning lives on the endpoint so that
        *remote* one-sided writes (zero-copy RETURNs landing in a slab)
        also invalidate the device mirror — otherwise a framed fold could
        read a stale snapshot and overwrite bytes the fabric just wrote."""
        ver = self.endpoint.region_ver.get(name, 0)
        hit = self._region_dev.get(name)
        if hit is not None and hit[0] == ver:
            return hit[1]
        dev = torch.from_numpy(self.endpoint.regions[name]).to(self.device, copy=True)
        self._region_dev[name] = (ver, dev)
        return dev

    def write_region(
        self, name: str, value: np.ndarray, dev: torch.Tensor | None = None
    ) -> None:
        """Store a dispatch's result into a region.  ``dev`` is the same
        value still on the device: it becomes the fresh mirror, so the next
        fold reads it without copying the region back up."""
        np.copyto(self.endpoint.regions[name], value)
        self.endpoint.touch_region(name)
        if dev is not None:
            self._region_dev[name] = (self.endpoint.region_ver.get(name, 0), dev)

    def register_cap(self, name: str, arr: np.ndarray) -> None:
        self.caps[name] = np.asarray(arr)
        self._cap_dev.pop(name, None)

    def cap_device(self, name: str) -> torch.Tensor:
        """Device copy of a capability (small constant array), made once."""
        dev = self._cap_dev.get(name)
        if dev is None:
            dev = self._cap_dev[name] = torch.from_numpy(
                np.array(self.caps[name])
            ).to(self.device)
        return dev

    # --- source side --------------------------------------------------------
    def register_source(self, ifunc: IFunc) -> IFunc:
        self.source_registry[ifunc.name] = ifunc
        return ifunc

    def resolve_source(self, name: str) -> IFunc:
        got = self.source_registry.get(name)
        if got is None:
            if self.toolchain is None:
                raise ProtocolError(f"{self.name}: no source artifact for {name!r}")
            got = self.register_source(self.toolchain.lookup(name))
        return got

    # stable alias: pre-layering callers reached the private spelling
    _resolve_source = resolve_source

    def send_ifunc(
        self,
        dst: str,
        name: str,
        payload: np.ndarray | bytes,
        *,
        express: bool = False,
        tenant: str | None = None,
    ) -> int:
        """Create and PUT an ifunc message; returns wire bytes sent.

        ``express`` flags the frame for control-lane drain priority at the
        receiver (it still consumes credits); ``tenant`` charges the frame
        against that tenant's credit budget and traffic counters."""
        ifunc = self.resolve_source(name)
        pay = payload if isinstance(payload, bytes) else np.asarray(payload).tobytes()
        frame = ifunc.make_frame(pay, seq=self.wire.next_seq())
        if express:
            frame.flags = int(frame.flags) | int(FrameFlags.EXPRESS)
        frame.tenant = tenant
        return self.wire.put_frame(dst, frame)

    def send_am(self, dst: str, name: str, payload: np.ndarray | bytes) -> int:
        """Active Message baseline: payload-only frame, handler pre-deployed."""
        pay = payload if isinstance(payload, bytes) else np.asarray(payload).tobytes()
        frame = Frame(
            kind=FrameKind.ACTIVE_MESSAGE, name=name, payload=pay,
            seq=self.wire.next_seq(),
        )
        return self.wire.put_frame(dst, frame)

    def peer_index(self, name: str) -> int:
        """This cluster's dense peer index for ``name`` (the index space
        X-RDMA action vectors use for ``dst``/``requester``)."""
        return self.peers.index(name)

    # --- recursive propagation: source side ---------------------------------
    def publish_ifunc(
        self,
        name: str,
        payload: np.ndarray | bytes = b"",
        *,
        ttl: int | None = None,
        config: PropagationConfig | None = None,
    ) -> list[str]:
        """Publish an ifunc down this PE's spanning tree (paper Sec. I:
        code that "recursively propagate[s] itself to other remote
        machines").

        Sends one PUBLISH hop frame to each of this PE's *tree children*
        only — O(log n) for the binomial default — and every child that
        installs the code re-publishes it to its own children, so coverage
        reaches all n peers without the root sending n frames.  An empty
        ``payload`` is a pure code distribution (install + re-publish, no
        invoke); a non-empty payload is invoked at every covered PE (the
        broadcast the multi-hop collectives build on).  Returns the peer
        names actually sent to.
        """
        cfg = config or self.propagation
        ifunc = self.resolve_source(name)
        pay = payload if isinstance(payload, bytes) else np.asarray(payload).tobytes()
        me = self.peer_index(self.name)
        self._pub_seq += 1
        hop = HopHeader(
            ttl=ttl if ttl is not None else cfg.ttl,
            root=me,
            pub_id=self._pub_seq,
            path=(me,),
            k=cfg.k_code,
        )
        return self.publish_to_children(
            hop, ifunc.kind, name, pay, ifunc.code_bytes, ifunc.deps, ifunc.digest
        )

    def forget_publisher(self, root: int) -> None:
        """Drop publish-dedup state for one root peer index (see
        :meth:`repro_torch.core.pe.progress.ProgressEngine.forget_publisher`)."""
        self.progress.forget_publisher(root)

    def publish_to(
        self,
        dst: str,
        name: str,
        payload: np.ndarray | bytes = b"",
        *,
        ttl: int = 1,
    ) -> None:
        """Publish directly to one named peer (no tree fan-out at this end;
        the receiver still re-publishes if ``ttl`` allows).  This is the
        re-parenting primitive: when a mid-tree PE dies, the root re-covers
        the orphaned subtree by publishing straight to its survivors."""
        ifunc = self.resolve_source(name)
        # a direct publish exists because the normal delivery is in doubt —
        # drop our cache belief so the code travels again (a dropped hop
        # upstream may have warmed this entry without the bytes ever landing)
        self.sender_cache.forget(dst, ifunc.digest.hex())
        pay = payload if isinstance(payload, bytes) else np.asarray(payload).tobytes()
        me = self.peer_index(self.name)
        self._pub_seq += 1
        hop = HopHeader(
            ttl=ttl, root=me, pub_id=self._pub_seq, path=(me,),
            k=self.propagation.k_code,
        )
        self.send_publish(
            dst, hop, ifunc.kind, name, pay, ifunc.code_bytes, ifunc.deps,
            ifunc.digest,
        )

    def publish_to_children(
        self,
        hop: HopHeader,
        kind: FrameKind,
        name: str,
        inner: bytes,
        code: bytes,
        deps: tuple[str, ...],
        digest: bytes,
    ) -> list[str]:
        """Send one hop frame per tree child; a dead child loses only its
        own subtree's frame (counted), the rest of the fan-out proceeds."""
        me = self.peer_index(self.name)
        sent: list[str] = []
        for child in tree_children(hop.k, hop.root, me, len(self.peers)):
            dst = self.peers[child]
            try:
                self.send_publish(dst, hop, kind, name, inner, code, deps, digest)
                sent.append(dst)
            except EndpointDead:
                self.stats.publish_send_failures += 1
                # the PUT never landed: roll back the cache entry the send
                # just added, or a later re-publish would wrongly truncate
                self.sender_cache.forget(dst, digest.hex())
        return sent

    def send_publish(
        self,
        dst: str,
        hop: HopHeader,
        kind: FrameKind,
        name: str,
        inner: bytes,
        code: bytes,
        deps: tuple[str, ...],
        digest: bytes,
    ) -> None:
        frame = Frame(
            kind=kind,
            name=name,
            payload=pack_hop(hop) + inner,
            code=code,
            deps=deps,
            digest=digest,
            seq=self.wire.next_seq(),
            flags=FrameFlags.HOP,
        )
        self.stats.publishes += 1
        # publishes bypass the batching send queue even when batching is on:
        # hop frames never coalesce (per-edge path headers), and a dead
        # child must surface EndpointDead HERE — synchronously — so the
        # fan-out's per-child containment and sender-cache rollback apply
        # identically on both runtimes (a queued send would defer the error
        # to flush() and skip both).
        self.wire.put_now(dst, frame)

    # --- completion-tracked submissions -------------------------------------
    def submit(
        self,
        dst: str,
        name: str,
        body: np.ndarray,
        queue: CompletionQueue,
        expected: int,
        *,
        express: bool = False,
        tenant: str | None = None,
        slot_quota: int = 0,
    ) -> GatherFuture | None:
        """Submit a completion-tracked X-RDMA op and return its future —
        or ``None`` (would-block) when every completion-queue slot is in
        flight, so a saturated queue backpressures admission instead of
        raising mid-batch.

        Multi-tenant QoS: ``tenant`` tags the request's frames with the
        budget they charge, ``express`` requests control-lane drain
        priority, and ``slot_quota`` caps how many CQ slots this tenant
        may hold concurrently (the same would-block ``None`` contract as
        global saturation, so per-tenant admission control composes with
        the existing backpressure loop).

        The completion-queue wire convention: the runtime prepends the
        routing header ``[requester, slot, epoch]`` to the caller's
        ``body``, so every shipped op under this protocol sees
        ``payload[0]`` = the requester's peer index, ``payload[1]`` = the
        slot its RETURNs must target, and ``payload[2]`` = the slot's
        generation tag (RETURN code drops stale generations, making slot
        recycling safe under at-least-once delivery).  ``expected`` is how
        many result units (e.g. resolved rows) must arrive — possibly via
        several out-of-order RETURNs from different PEs — before the
        future reads done.
        """
        alloc = queue.try_alloc(tag=tenant, quota=slot_quota)
        if alloc is None:
            return None
        slot, epoch = alloc
        hdr = np.array([self.peer_index(self.name), slot, epoch], np.int32)
        payload = np.concatenate([hdr, np.asarray(body, np.int32)])
        rel = self.reliability
        fut = GatherFuture(
            queue=queue, slot=slot, expected=int(expected),
            submit_tick=queue.ticks,
            deadline=rel.future_deadline if rel.enabled else 0,
            code_digest=self.resolve_source(name).digest.hex(),
        )
        queue._inflight[slot] = fut
        try:
            self.send_ifunc(dst, name, payload, express=express, tenant=tenant)
        except Exception:
            fut.cancel()  # a failed send must not leak the slot
            raise
        return fut

    # --- progress ----------------------------------------------------------
    def poll(self, max_msgs: int | None = None) -> int:
        """Drive the progress engine one step (see
        :meth:`repro_torch.core.pe.progress.ProgressEngine.poll`)."""
        return self.progress.poll(max_msgs)

    def flush(self) -> int:
        """Emit every queued frame and one-sided write burst (see
        :meth:`repro_torch.core.pe.wire.WireLayer.flush`)."""
        return self.wire.flush()

    # --- action sinks (called by the exec layer) ----------------------------
    def forward_ifunc(self, dst: str, exe: CachedExecutable, pay: np.ndarray) -> None:
        """FORWARD: re-inject *this same ifunc*, code and all, to ``dst``."""
        frame = Frame(
            kind=FrameKind(exe.kind),
            name=exe.name,
            payload=pay.tobytes(),
            code=exe.extras["code"],
            deps=exe.deps,
            digest=bytes.fromhex(exe.digest),
            seq=self.wire.next_seq(),
        )
        self.wire.put_frame(dst, frame)

    def return_payload(self, dst: str, target: str, pay: np.ndarray) -> None:
        """Ship one RETURN payload under the data plane's protocol selection.

        ``framed`` re-injects the RETURN ifunc (the framed path, coalescable);
        ``zerocopy`` writes the payload one-sidedly into the requester's
        registered slab per the ifunc's :class:`SlabLayout` and bumps the
        doorbell — no frame, no requester-side dispatch; ``rendezvous``
        stages the payload locally and frames only a 16-byte descriptor
        the requester GETs against.
        """
        ifn = self.resolve_source(target)
        cached = self.caching_enabled and self.sender_cache.has(dst, ifn.digest.hex())
        proto = self.dataplane.select(
            int(pay.nbytes), slab=ifn.slab is not None, code_cached=cached
        )
        tracer = getattr(self.fabric, "tracer", None)
        if tracer is not None:
            # `zc` is what a zero-copy write burst of this RETURN would
            # carry (data + doorbell words), -1 when the ifunc has no slab
            # — the counterfactual the autotuner's protocol re-selection
            # needs even when the live run framed it
            if ifn.slab is not None:
                plan = ifn.slab.plan(np.ascontiguousarray(pay, np.int32))
                zc = sum(len(w.data) for w in plan) + 4 * sum(
                    1 for w in plan if w.doorbell is not None
                )
            else:
                zc = -1
            tracer.emit(
                "ret", src=self.name, dst=dst, name=target,
                n=int(pay.nbytes), zc=zc, cached=cached, proto=proto,
            )
        if proto == "zerocopy":
            self.stats.zerocopy_returns += 1
            writes = ifn.slab.plan(np.ascontiguousarray(pay, np.int32))
            self.wire.put_region(dst, writes)
        elif proto == "rendezvous":
            self.stats.rndv_returns += 1
            self.wire.rndv_send(dst, ifn, pay)
        else:
            self.send_ifunc(dst, target, pay)

    def publish_self(self, dst: str, exe: CachedExecutable, pay: np.ndarray) -> None:
        """A_PUBLISH: shipped code re-publishing *itself* — ``pay[0]`` is
        the hop budget it grants, the rest travels as the published
        payload; the paper's "recursively propagate itself" emitted by the
        code, not the runtime."""
        self.verifier.check_publish_ttl(exe, int(pay[0]))
        me = self.peer_index(self.name)
        self._pub_seq += 1
        hop = HopHeader(
            ttl=int(pay[0]),
            root=me,
            pub_id=self._pub_seq,
            path=(me,),
            k=self.propagation.k_code,
        )
        try:
            self.send_publish(
                dst,
                hop,
                FrameKind(exe.kind),
                exe.name,
                np.ascontiguousarray(pay[1:]).tobytes(),
                exe.extras.get("code", b""),
                exe.deps,
                bytes.fromhex(exe.digest),
            )
        except EndpointDead:
            self.stats.publish_send_failures += 1
