"""Simulated RDMA fabric: endpoints, one-sided PUT/GET, wire-time accounting.

The paper evaluates on 100 Gb/s InfiniBand (ConnectX-6 HCAs / BlueField-2
DPUs).  The fabric here drives no NIC: it is an in-process software RDMA: a PUT copies wire bytes into the target's receive
buffer (the target discovers delivery by MAGIC-polling, as in Sec. III-D); a
GET reads a registered memory region *without running any code on the target*
(one-sided semantics, the GBPC baseline relies on this).

Every operation is additionally *accounted* against a calibrated wire model
(:class:`WireModel`) so that benchmarks report a modeled wire time next to
the measured in-process time.  The models are calibrated from the paper's own
Tables I-III (two-point fit: cached 26 B frame and uncached 5185 B frame), so
modeled cached/uncached and DAPC/GBPC *ratios* are directly comparable with
the paper's.  Byte counts — the quantity the paper's caching argument is
about — are exact, not modeled.
"""

from __future__ import annotations

import struct
import threading
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Iterator, Sequence

import numpy as np


# --------------------------------------------------------------------- wire
@dataclass(frozen=True)
class WireModel:
    """Latency/throughput model: ``t_us(n) = alpha_us + n / beta_Bus``.

    ``alpha_us``    per-message latency floor (doorbell, WQE, fabric hop).
    ``beta_Bus``    effective small-message payload bandwidth in bytes/us
                    (far below the 12.5 GB/s line rate of 100 Gb/s IB -
                    the paper's own numbers imply 2.1-3.2 B/ns).
    ``o_us``        per-message *throughput* cost for back-to-back messages
                    (message-rate benchmarks; pipelining makes o < alpha).

    Calibration (paper Tables I-VI), two-point fits:
      ookami     cached 26B @ 2.62us, uncached 5185B @ 5.02us, AM rate 1.32M/s
      thor_bf2   cached 26B @ 1.85us, uncached 5185B @ 3.45us, AM rate 0.974M/s
      thor_xeon  cached 26B @ 1.51us, uncached 5185B @ 3.58us, AM rate 6.754M/s
    """

    name: str
    alpha_us: float
    beta_Bus: float  # latency-regime bytes/us (single message in flight)
    o_us: float  # per-message throughput overhead (pipelined)
    beta_tput_Bus: float = 0.0  # throughput-regime bytes/us (pipelined)

    def latency_us(self, nbytes: int) -> float:
        return self.alpha_us + nbytes / self.beta_Bus

    def inverse_throughput_us(self, nbytes: int) -> float:
        beta = self.beta_tput_Bus or self.beta_Bus
        return self.o_us + nbytes / beta

    def rate_msg_per_s(self, nbytes: int) -> float:
        return 1e6 / self.inverse_throughput_us(nbytes)


WIRE_PROFILES: dict[str, WireModel] = {
    # latency fit:    beta = (5185-26)/(t_unc - t_cached); alpha = t_cached - 26/beta
    # throughput fit: beta_t = (5185-26)/(1/r_unc - 1/r_cached); o = 1/r_cached - 26/beta_t
    # (two-point fits straight from Tables I-VI; pipelining makes beta_t >> beta)
    "ookami": WireModel(
        "ookami", alpha_us=2.6079, beta_Bus=2149.6, o_us=0.5896, beta_tput_Bus=2762.0
    ),
    "thor_bf2": WireModel(
        "thor_bf2", alpha_us=1.8419, beta_Bus=3224.4, o_us=0.7546, beta_tput_Bus=3159.0
    ),
    "thor_xeon": WireModel(
        "thor_xeon", alpha_us=1.4996, beta_Bus=2492.3, o_us=0.1463, beta_tput_Bus=15041.0
    ),
    # zero-cost model for pure byte accounting
    "ideal": WireModel(
        "ideal", alpha_us=0.0, beta_Bus=float("inf"), o_us=0.0,
        beta_tput_Bus=float("inf"),
    ),
}


# ------------------------------------------------------------- capabilities
#: Which calibrated wire profile a PE of a given toolchain triple fronts:
#: the host Xeon and the BlueField-2 DPU sit on the *same* 100 Gb/s link
#: but pay very different per-message costs (Tables I-VI), which is the
#: asymmetry the placement optimizer prices.
TRIPLE_WIRE: dict[str, str] = {
    "cpu-host": "thor_xeon",
    "cpu-a64fx": "ookami",
    "cpu-bf2": "thor_bf2",
    "tpu-v5e": "thor_xeon",
}

#: Memory-bandwidth class per triple — the DPU's weak Arm cores stream a
#: shard scan far slower than the host (the paper's BF2 caveat, Sec. V).
MEM_BW_CLASS: dict[str, str] = {
    "cpu-host": "ddr-host",
    "cpu-a64fx": "hbm",
    "cpu-bf2": "ddr-dpu",
    "tpu-v5e": "hbm",
}

#: Effective single-core streaming scan rate per class, bytes/us.  Modeled,
#: not measured, calibrated to the qualitative gap the
#: paper reports: BF2 DDR ~half the host's effective rate, HBM far above.
MEM_BW_BUS: dict[str, float] = {
    "ddr-host": 16000.0,
    "ddr-dpu": 8000.0,
    "hbm": 60000.0,
}


@dataclass(frozen=True)
class Capability:
    """A PE's advertised platform/capability vector.

    Registered in the :class:`Fabric` when the PE connects, for the
    placement layer (``sharding/placement.py``, not ported yet): the wire
    coefficients are the PE's *own* calibrated profile (what its HCA pays
    to initiate a message), ``mem_bw_class`` prices operand scans executed
    next to the data.  ``epoch`` is the advertisement generation — bumped
    on every (re)advertise so cached placement plans can detect restarts.
    """

    isa: str  # toolchain triple, e.g. "cpu-bf2"
    platform: str  # export platform ("cpu" | "cuda")
    wire: str  # calibrated WireModel name (TRIPLE_WIRE)
    alpha_us: float
    beta_Bus: float
    o_us: float
    beta_tput_Bus: float
    mem_bw_class: str  # see MEM_BW_CLASS / MEM_BW_BUS
    epoch: int = 0

    @classmethod
    def for_triple(cls, triple: str, platform: str) -> "Capability":
        wire = TRIPLE_WIRE.get(triple, "thor_xeon")
        m = WIRE_PROFILES[wire]
        return cls(
            isa=triple,
            platform=platform,
            wire=wire,
            alpha_us=m.alpha_us,
            beta_Bus=m.beta_Bus,
            o_us=m.o_us,
            beta_tput_Bus=m.beta_tput_Bus or m.beta_Bus,
            mem_bw_class=MEM_BW_CLASS.get(triple, "ddr-host"),
        )

    def model(self) -> WireModel:
        return WireModel(
            self.wire, self.alpha_us, self.beta_Bus, self.o_us, self.beta_tput_Bus
        )

    @property
    def scan_Bus(self) -> float:
        """Effective streaming scan bandwidth, bytes/us."""
        return MEM_BW_BUS[self.mem_bw_class]

    def as_dict(self) -> dict:
        return {
            "isa": self.isa,
            "platform": self.platform,
            "wire": self.wire,
            "alpha_us": self.alpha_us,
            "beta_Bus": self.beta_Bus,
            "o_us": self.o_us,
            "beta_tput_Bus": self.beta_tput_Bus,
            "mem_bw_class": self.mem_bw_class,
            "epoch": self.epoch,
        }


# ------------------------------------------------------------------ fabric
#: Categories every wire byte falls into (``TrafficStats.by_kind``):
#: ``header`` frame headers + sentinels + batch sub-headers, ``payload``
#: actual ifunc payload bytes, ``code`` fat-bitcode + deps sections,
#: ``region`` one-sided data (RDMA READ/WRITE of registered memory,
#: including doorbell words).  Benchmarks report the framing tax directly
#: from this split instead of deriving it by hand.
BYTE_KINDS = ("header", "payload", "code", "region")


@dataclass
class TrafficStats:
    """Per-fabric aggregate accounting (resettable by benchmarks)."""

    puts: int = 0
    gets: int = 0
    put_bytes: int = 0
    get_bytes: int = 0
    modeled_us: float = 0.0  # serial wire-latency accounting
    modeled_tput_us: float = 0.0  # back-to-back (message-rate) accounting
    coalesced_frames: int = 0  # PUTs that carried >1 payload (multi-payload frames)
    coalesced_payloads: int = 0  # payloads that travelled inside those PUTs
    region_puts: int = 0  # one-sided RDMA WRITE batches into registered memory
    region_put_bytes: int = 0  # data + doorbell bytes those writes carried
    region_guard_drops: int = 0  # guarded writes dropped by a stale generation
    hop_frames: int = 0  # PUBLISH frames (propagation hop header on board)
    hop_bytes: int = 0  # wire bytes those publish frames carried
    credit_stalls: int = 0  # sends deferred by an exhausted per-peer window
    # --- per-tenant accounting (multi-tenant QoS; untenanted traffic is
    # not broken out — it is the difference against the aggregates) ---
    tenant_puts: dict[str, int] = field(default_factory=dict)
    tenant_put_bytes: dict[str, int] = field(default_factory=dict)
    tenant_stalls: dict[str, int] = field(default_factory=dict)  # budget stalls
    # --- injected loss (set_loss): sender-paid bytes that never arrived ---
    frames_lost: int = 0  # PUTs the loss model ate (bytes still accounted)
    lost_bytes: int = 0  # wire bytes those eaten PUTs carried
    region_writes_lost: int = 0  # one-sided slab writes the loss model ate
    by_kind: dict[str, int] = field(default_factory=dict)  # see BYTE_KINDS

    def reset(self) -> None:
        self.puts = self.gets = 0
        self.put_bytes = self.get_bytes = 0
        self.modeled_us = 0.0
        self.modeled_tput_us = 0.0
        self.coalesced_frames = 0
        self.coalesced_payloads = 0
        self.region_puts = self.region_put_bytes = 0
        self.region_guard_drops = 0
        self.hop_frames = self.hop_bytes = 0
        self.credit_stalls = 0
        self.frames_lost = self.lost_bytes = 0
        self.region_writes_lost = 0
        self.by_kind = {}
        self.tenant_puts = {}
        self.tenant_put_bytes = {}
        self.tenant_stalls = {}

    def add_kinds(self, kinds: dict[str, int] | None) -> None:
        for k, v in (kinds or {}).items():
            if v:
                self.by_kind[k] = self.by_kind.get(k, 0) + v

    @property
    def wire_bytes_by_kind(self) -> dict[str, int]:
        return {k: self.by_kind.get(k, 0) for k in BYTE_KINDS}

    def report_kwargs(self) -> dict:
        """Snapshot of the wire-side fields every per-run report shares —
        ChaseReport and GatherReport construct themselves from this one
        definition so the two benchmarks' accounting cannot drift."""
        return {
            "puts": self.puts,
            "gets": self.gets,
            "put_bytes": self.put_bytes,
            "get_bytes": self.get_bytes,
            "modeled_us": self.modeled_us,
            "coalesced_frames": self.coalesced_frames,
            "coalesced_payloads": self.coalesced_payloads,
            "region_puts": self.region_puts,
            "region_put_bytes": self.region_put_bytes,
            "hop_frames": self.hop_frames,
            "wire_bytes_by_kind": self.wire_bytes_by_kind,
        }

    def as_dict(self) -> dict[str, float]:
        return {
            "puts": self.puts,
            "gets": self.gets,
            "put_bytes": self.put_bytes,
            "get_bytes": self.get_bytes,
            "modeled_us": round(self.modeled_us, 3),
            "modeled_tput_us": round(self.modeled_tput_us, 3),
            "coalesced_frames": self.coalesced_frames,
            "coalesced_payloads": self.coalesced_payloads,
            "region_puts": self.region_puts,
            "region_put_bytes": self.region_put_bytes,
            "region_guard_drops": self.region_guard_drops,
            "hop_frames": self.hop_frames,
            "hop_bytes": self.hop_bytes,
            "credit_stalls": self.credit_stalls,
            "frames_lost": self.frames_lost,
            "lost_bytes": self.lost_bytes,
            "region_writes_lost": self.region_writes_lost,
            "wire_bytes_by_kind": self.wire_bytes_by_kind,
            "tenant_puts": dict(self.tenant_puts),
            "tenant_put_bytes": dict(self.tenant_put_bytes),
            "tenant_stalls": dict(self.tenant_stalls),
        }


class WireReportMixin:
    """Derived wire totals shared by the per-run report dataclasses (which
    carry the :meth:`TrafficStats.report_kwargs` field set)."""

    @property
    def wire_bytes(self) -> int:
        return self.put_bytes + self.get_bytes + self.region_put_bytes

    @property
    def network_ops(self) -> int:
        """Wire operations: PUTs + GETs + slab-write batches (what
        batching and the zero-copy plane amortize)."""
        return self.puts + self.gets + self.region_puts


@dataclass(frozen=True)
class RegionWrite:
    """One one-sided write into a peer's registered memory.

    ``doorbell`` — optional ``(byte_offset, value, op)`` with ``op`` in
    {"or", "add"}: after the data lands, the fabric atomically folds
    ``value`` into the int32 word at ``byte_offset`` of the same region
    (RDMA atomic FETCH_ADD / masked-CAS).  The receiver discovers
    completion by polling that word — no inbox, no frame, no dispatch.

    ``guard`` — optional ``(byte_offset, expected)``: the write applies
    only while the int32 word at ``byte_offset`` still equals
    ``expected``.  This models generation-tagged memory registration (a
    retired slot's rkey is invalidated): a stale write's bytes still
    cross the wire but the NIC refuses to apply them.
    """

    region: str
    offset: int
    data: bytes
    doorbell: tuple[int, int, str] | None = None
    guard: tuple[int, int] | None = None


class EndpointDead(RuntimeError):
    """Raised on operations against a killed endpoint (fault injection)."""


class WireBuf(bytearray):
    """A received wire buffer, tagged with the peer that PUT it.

    Behaves exactly like the ``bytearray`` the inbox always held (tests
    slice, corrupt, and re-deliver these), but carries ``src`` so the
    progress engine can return flow-control credits to the right sender
    when the buffer is finally processed.  Buffers delivered outside
    :meth:`Fabric.put` (tests re-injecting captured frames) carry an empty
    ``src`` and simply return no credit.
    """

    src: str = ""


class Endpoint:
    """One processing element's network identity: receive queue + regions.

    The receive queue models the ifunc message buffer the target polls; the
    regions dict models RDMA-registered memory exposed for one-sided GET/PUT
    (numpy arrays, addressable by (region_name, byte offset)).
    """

    def __init__(self, name: str) -> None:
        self.name = name
        self.inbox: deque[bytearray] = deque()
        self.regions: dict[str, np.ndarray] = {}
        self.region_ver: dict[str, int] = {}  # bumped on every (re)register/write
        self.alive = True
        self._lock = threading.Lock()

    # registered memory -----------------------------------------------------
    def register_region(self, name: str, arr: np.ndarray) -> None:
        # RDMA registration pins physical pages: a non-C-contiguous view
        # (transpose, stride slice) has no single pinnable extent, so it is
        # materialized contiguously at registration time — same rule as
        # ibv_reg_mr over a copy buffer.  Contiguous arrays register
        # in place (zero copy), preserving caller aliasing.
        self.regions[name] = np.ascontiguousarray(arr)
        self.region_ver[name] = self.region_ver.get(name, 0) + 1

    def touch_region(self, name: str) -> None:
        """Record that a region's bytes changed underneath its registration
        (local in-place mutation): device-resident mirrors must refresh."""
        self.region_ver[name] = self.region_ver.get(name, 0) + 1

    def unregister_region(self, name: str) -> None:
        """Drop a registration and its version bookkeeping (rkey invalidated)."""
        self.regions.pop(name, None)
        self.region_ver.pop(name, None)

    def read_region(self, region: str, offset: int, nbytes: int) -> bytes:
        buf = self.regions[region].view(np.uint8).reshape(-1)
        return bytes(buf[offset : offset + nbytes])

    def write_region(self, region: str, offset: int, data: bytes) -> None:
        buf = self.regions[region].view(np.uint8).reshape(-1)
        buf[offset : offset + len(data)] = np.frombuffer(data, np.uint8)
        self.touch_region(region)

    def read_region_i32(self, region: str, offset: int) -> int:
        return struct.unpack("<i", self.read_region(region, offset, 4))[0]

    # receive side ----------------------------------------------------------
    def deliver(self, wire: bytes, src: str = "") -> None:
        buf = WireBuf(wire)
        buf.src = src
        with self._lock:
            self.inbox.append(buf)

    def drain(self) -> Iterator[bytearray]:
        while True:
            with self._lock:
                if not self.inbox:
                    return
                yield self.inbox.popleft()


class Fabric:
    """The interconnect: owns endpoints, implements PUT/GET, accounts bytes."""

    def __init__(self, wire: WireModel | str = "ideal") -> None:
        self.wire = WIRE_PROFILES[wire] if isinstance(wire, str) else wire
        self.endpoints: dict[str, Endpoint] = {}
        self.stats = TrafficStats()
        # advertised platform/capability vectors (PE.__init__ advertises on
        # connect; kill/revive drop the entry until the restarted PE
        # re-advertises)
        self.capabilities: dict[str, Capability] = {}
        self._cap_epoch = 0
        # framed payloads in flight per (src, dst): bumped on put (by the
        # frame's packed payload count — credits are payload-denominated so
        # a coalesced burst is accounted at its true size), released as the
        # receiver's progress engine processes them.  This is the
        # receive-buffer occupancy a credit window bounds.
        self._credit_out: dict[tuple[str, str], int] = {}
        # per-tenant slice of that occupancy: a FIFO ledger of
        # [tenant, n_payloads] entries per (src, dst) link, plus the
        # aggregate per-(src, tenant) outstanding count a tenant budget
        # bounds.  Attribution on credit_return is FIFO — exact when the
        # receiver drains in order, approximate under lane reordering,
        # but conserved either way: a tenant's count only ever drains by
        # what it deposited.
        self._tenant_fifo: dict[tuple[str, str], deque] = {}
        self._tenant_out: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()
        # seeded Bernoulli loss injection (set_loss): 0.0 = lossless
        self._loss_rate = 0.0
        self._loss_rng: np.random.Generator | None = None
        # optional trace capture (analysis/trace.py): every hook in the
        # runtime reaches the recorder through this single attach point,
        # guarded by `is not None` — detached runs pay one attribute load
        self.tracer = None

    # loss injection ---------------------------------------------------------
    def set_loss(self, rate: float, seed: int = 0) -> None:
        """Arm (or disarm, ``rate=0``) seeded Bernoulli frame loss.

        Each framed PUT and each one-sided region write is independently
        dropped with probability ``rate`` *after* the sender pays for it
        (bytes and modeled time are accounted — the NIC sent them; the
        receiver just never sees them, and no receive credit is consumed).
        One mechanism shared by the chaos suites and
        ``benchmarks/reliability.py``; the seeded generator makes every
        loss schedule reproducible under the deterministic scheduler.
        """
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"loss rate {rate} outside [0, 1)")
        self._loss_rate = float(rate)
        self._loss_rng = np.random.default_rng(seed) if rate else None

    def _lose(self) -> bool:
        return (
            self._loss_rng is not None
            and float(self._loss_rng.random()) < self._loss_rate
        )

    def connect(self, name: str) -> Endpoint:
        ep = Endpoint(name)
        self.endpoints[name] = ep
        self._clear_credits(name)
        return ep

    # capability registry -----------------------------------------------------
    def advertise(self, name: str, cap: Capability) -> Capability:
        """Register (or refresh) ``name``'s capability vector.

        Every advertisement mints a fresh fabric-wide epoch so consumers
        (cached placement plans) can tell a restarted PE from the one they
        priced against.  Returns the epoch-stamped vector.
        """
        with self._lock:
            self._cap_epoch += 1
            cap = replace(cap, epoch=self._cap_epoch)
            self.capabilities[name] = cap
        return cap

    def capability(self, name: str) -> Capability | None:
        return self.capabilities.get(name)

    # credit accounting ------------------------------------------------------
    def credit_outstanding(self, src: str, dst: str) -> int:
        """Payloads PUT by ``src`` that ``dst`` has not yet processed."""
        return self._credit_out.get((src, dst), 0)

    def tenant_outstanding(self, src: str, tenant: str) -> int:
        """Payloads PUT by ``src`` on ``tenant``'s behalf (any destination)
        not yet processed — what a per-tenant credit budget bounds."""
        return self._tenant_out.get((src, tenant), 0)

    def _tenant_credit(self, src: str, tenant: str, delta: int) -> None:
        # lock held by caller
        key = (src, tenant)
        left = self._tenant_out.get(key, 0) + delta
        if left > 0:
            self._tenant_out[key] = left
        else:
            self._tenant_out.pop(key, None)

    def _drain_tenant_fifo(self, key: tuple[str, str], n: int) -> None:
        # lock held by caller; attribute n retired payloads FIFO-first
        fifo = self._tenant_fifo.get(key)
        while n > 0 and fifo:
            entry = fifo[0]  # mutable [tenant, n_payloads]
            take = min(entry[1], n)
            entry[1] -= take
            n -= take
            self._tenant_credit(key[0], entry[0], -take)
            if entry[1] == 0:
                fifo.popleft()
        if fifo is not None and not fifo:
            self._tenant_fifo.pop(key, None)

    def credit_return(self, src: str, dst: str, n: int = 1) -> None:
        """Release ``n`` receive credits from ``dst`` back to ``src``
        (called by the receiver's progress engine as frames retire)."""
        if not src:
            return
        with self._lock:
            key = (src, dst)
            left = self._credit_out.get(key, 0) - n
            if left > 0:
                self._credit_out[key] = left
            else:
                self._credit_out.pop(key, None)
            self._drain_tenant_fifo(key, n)

    def _release_tenant_fifo(self, key: tuple[str, str]) -> None:
        # lock held by caller; give every ledgered payload on this link
        # back to its tenant (the frames themselves are gone)
        for tenant, count in self._tenant_fifo.pop(key, ()):
            self._tenant_credit(key[0], tenant, -count)

    def _clear_credits(self, name: str) -> None:
        """Drop all credit state involving ``name`` (its frames are gone —
        a dead inbox drops them, a fresh endpoint starts empty — so a
        sender's window against it must not stay consumed forever)."""
        with self._lock:
            for key in [k for k in self._credit_out if name in k]:
                self._credit_out.pop(key, None)
            for key in [k for k in self._tenant_fifo if name in k]:
                self._release_tenant_fifo(key)

    def clear_peer_credits(self, a: str, b: str) -> None:
        """Drop credit state between one pair of peers, both directions —
        what a PE that just declared ``b`` dead clears, without touching
        other senders' windows against ``b`` (each PE's failure detector
        makes its own call)."""
        with self._lock:
            self._credit_out.pop((a, b), None)
            self._credit_out.pop((b, a), None)
            self._release_tenant_fifo((a, b))
            self._release_tenant_fifo((b, a))

    def _target(self, dst: str) -> Endpoint:
        ep = self.endpoints[dst]
        if not ep.alive:
            raise EndpointDead(dst)
        return ep

    # one-sided ops ---------------------------------------------------------
    def put(
        self,
        src: str,
        dst: str,
        wire_bytes: bytes,
        n_payloads: int = 1,
        kinds: dict[str, int] | None = None,
        hop: bool = False,
        tenant: str | None = None,
    ) -> float:
        """One-sided PUT of a (possibly truncated, possibly coalesced) frame.

        Returns the modeled wire time in us.  The receiver is not notified;
        it discovers the message by polling (MAGIC sentinels).  A coalesced
        PUT (``n_payloads > 1``) is *one* wire message: one ``alpha_us`` /
        ``o_us`` charge for the summed bytes — exactly the amortization the
        batched runtime is after — and is counted in ``coalesced_frames`` so
        benchmarks can report it.  ``kinds`` attributes the bytes across
        :data:`BYTE_KINDS` (omitted = all counted as payload).  ``hop``
        marks a propagation PUBLISH frame (hop header on board) so tree
        multicasts are visible in the fabric accounting.  ``tenant`` charges
        the frame's payloads against that tenant's credit ledger (and its
        per-tenant traffic counters) — multi-tenant QoS accounting.
        """
        ep = self._target(dst)
        n = len(wire_bytes)
        model = self.wire
        t = model.latency_us(n)
        with self._lock:
            self.stats.puts += 1
            self.stats.put_bytes += n
            self.stats.modeled_us += t
            self.stats.modeled_tput_us += model.inverse_throughput_us(n)
            self.stats.add_kinds(kinds if kinds is not None else {"payload": n})
            if n_payloads > 1:
                self.stats.coalesced_frames += 1
                self.stats.coalesced_payloads += n_payloads
            if hop:
                self.stats.hop_frames += 1
                self.stats.hop_bytes += n
            if tenant is not None:
                tp = self.stats.tenant_puts
                tp[tenant] = tp.get(tenant, 0) + 1
                tb = self.stats.tenant_put_bytes
                tb[tenant] = tb.get(tenant, 0) + n
            lost = self._lose()
            if lost:
                # the sender paid for the bytes but they never land: no
                # delivery, no receive-buffer occupancy, no credit consumed
                self.stats.frames_lost += 1
                self.stats.lost_bytes += n
            if self.tracer is not None:
                ev = {"src": src, "dst": dst, "n": n, "p": n_payloads}
                if kinds is not None:
                    ev["by"] = kinds
                if hop:
                    ev["hop"] = True
                if tenant is not None:
                    ev["tn"] = tenant
                if lost:
                    ev["lost"] = True
                self.tracer.emit("put", **ev)
            if lost:
                return t
            if n_payloads:
                self._credit_out[(src, dst)] = (
                    self._credit_out.get((src, dst), 0) + n_payloads
                )
                if tenant is not None:
                    self._tenant_fifo.setdefault((src, dst), deque()).append(
                        [tenant, n_payloads]
                    )
                    self._tenant_credit(src, tenant, n_payloads)
        ep.deliver(wire_bytes, src=src)
        return t

    def put_region(
        self,
        src: str,
        dst: str,
        region: str,
        offset: int,
        data: bytes,
        *,
        doorbell: tuple[int, int, str] | None = None,
        guard: tuple[int, int] | None = None,
    ) -> float:
        """One-sided RDMA WRITE into ``dst``'s registered region.

        No frame, no inbox, no receiver dispatch: the bytes land in memory
        and the optional ``doorbell`` word is bumped atomically so the
        receiver discovers completion by polling memory (the paper's
        pointer chase 'returns its result with a final PUT').  See
        :class:`RegionWrite` for doorbell/guard semantics.
        """
        return self.put_region_multi(
            src,
            dst,
            [RegionWrite(region, offset, data, doorbell=doorbell, guard=guard)],
        )

    def put_region_multi(self, src: str, dst: str, writes: Sequence[RegionWrite]) -> float:
        """A doorbell-batched chain of one-sided writes to one peer.

        Models a posted WQE chain: the first segment pays the full
        ``alpha_us`` latency, each further segment only the pipelined
        per-message overhead ``o_us``, and all data bytes share the wire at
        ``beta_Bus``.  Each write's guard is checked independently — a
        stale-generation write is dropped at the 'NIC' without disturbing
        its chain-mates — and each doorbell folds in only after its own
        data landed.
        """
        if not writes:
            return 0.0
        ep = self._target(dst)
        nbytes = sum(len(w.data) for w in writes) + 4 * sum(
            1 for w in writes if w.doorbell is not None
        )
        model = self.wire
        t = model.latency_us(nbytes) + (len(writes) - 1) * model.o_us
        with self._lock:
            self.stats.region_puts += 1
            self.stats.region_put_bytes += nbytes
            self.stats.modeled_us += t
            self.stats.modeled_tput_us += (
                len(writes) - 1
            ) * model.o_us + model.inverse_throughput_us(nbytes)
            self.stats.add_kinds({"region": nbytes})
            lw0 = self.stats.region_writes_lost
            gd0 = self.stats.region_guard_drops
            lost = False
            for w in writes:
                if lost or self._lose():
                    # a lost WQE segment takes the rest of the chain with
                    # it: QP delivery is in order, so the fenced doorbell
                    # on the last segment never fires over a gap — a
                    # half-landed partial stays invisible until resubmit
                    lost = True
                    self.stats.region_writes_lost += 1
                    continue
                if w.guard is not None:
                    g_off, g_want = w.guard
                    if ep.read_region_i32(w.region, g_off) != g_want:
                        self.stats.region_guard_drops += 1
                        continue
                if w.data:
                    ep.write_region(w.region, w.offset, w.data)
                if w.doorbell is not None:
                    d_off, d_val, d_op = w.doorbell
                    cur = ep.read_region_i32(w.region, d_off)
                    new = (cur | d_val) if d_op == "or" else (cur + d_val)
                    ep.write_region(w.region, d_off, struct.pack("<i", new))
            if self.tracer is not None:
                ev = {"src": src, "dst": dst, "n": nbytes, "w": len(writes)}
                lw = self.stats.region_writes_lost - lw0
                gd = self.stats.region_guard_drops - gd0
                if lw:
                    ev["lw"] = lw
                if gd:
                    ev["gd"] = gd
                self.tracer.emit("rput", **ev)
        return t

    def get(self, src: str, dst: str, region: str, offset: int, nbytes: int) -> bytes:
        """One-sided GET: read target memory; no target-side code runs.

        Modeled as a full round trip (request + data), the cost structure of
        an RDMA READ: latency ~ 2*alpha + n/beta.
        """
        ep = self._target(dst)
        data = ep.read_region(region, offset, nbytes)
        model = self.wire
        t = 2 * model.alpha_us + nbytes / model.beta_Bus
        with self._lock:
            self.stats.gets += 1
            self.stats.get_bytes += nbytes
            self.stats.modeled_us += t
            self.stats.modeled_tput_us += t  # GETs are round-trips; no pipelining
            self.stats.add_kinds({"region": nbytes})
            if self.tracer is not None:
                self.tracer.emit("get", src=src, dst=dst, n=nbytes, region=region)
        return data

    # fault injection ---------------------------------------------------------
    def kill(self, name: str) -> None:
        """Endpoint process death: queue drops, memory unreachable."""
        ep = self.endpoints[name]
        ep.alive = False
        ep.inbox.clear()
        self.capabilities.pop(name, None)
        self._clear_credits(name)

    def revive(self, name: str) -> Endpoint:
        """Restarted process: fresh endpoint state (all caches/regions gone).

        The capability vector does NOT survive: the revived process must
        re-advertise (PE.__init__ does) before the fabric lists it again."""
        ep = Endpoint(name)
        self.endpoints[name] = ep
        self.capabilities.pop(name, None)
        self._clear_credits(name)
        return ep
