"""Embedding-shard serving over the X-RDMA Gather substrate.

The serving shape DOLMA calls data-object-level disaggregation: a large
embedding (or KV) table lives row-sharded across server PEs, and clients
stream small key-batches at it.  The move-data-to-compute baseline GETs
every row individually (one RDMA round trip per key); the X-RDMA path
ships the Gatherer once, then each request is one tiny key-frame to the
first owner, partial resolution next to every shard it touches, and
partial RETURNs racing back into the requester's completion queue.

:class:`EmbedShardService` is the continuous-batching scheduler for that
substrate: requests queue, admit into free completion-queue slots as
others retire, and many gathers overlay in flight.  Under ``batching=True``
the whole pipeline rides the coalesced-frame / single-dispatch runtime: one
PUT per (destination, tick) carrying every key-frame, one dispatch per
(PE, tick) resolving every arrived request (one kernel launch on the card),
one masked-fold dispatch folding every partial RETURN into the queue
region.

:class:`FilterShardService` is the predicate-pushdown sibling on the same
substrate: a Filter ifunc scans a shard-aligned window next to its shard
and RETURNs only the survivors.  Both services route a burst by
``placement=``: pushdown, pull (the GET baseline), or ``"auto"`` — the
cost model of :mod:`repro_torch.sharding.placement` over the PEs'
advertised capability vectors.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import (
    Cluster,
    CompletionQueue,
    DataPlaneConfig,
    GatherFuture,
    PropagationConfig,
)
from repro_torch.core.transport import WireReportMixin
from repro_torch.core.xrdma import (
    make_filter,
    make_filter_return,
    make_gather_return,
    make_gatherer,
)


def ragged_batches(
    vocab: int, n_requests: int, n_keys: int, seed: int
) -> list[np.ndarray]:
    """The canonical request mix for benchmarks/tests/examples: ``n_requests``
    batches of 1..``n_keys`` uniform-random row ids (one shared definition so
    every consumer exercises the same workload shape)."""
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, vocab, rng.integers(1, n_keys + 1)).astype(np.int32)
        for _ in range(n_requests)
    ]


@dataclass
class GatherRequest:
    rid: int
    keys: np.ndarray  # (n,) int32 real keys, n <= n_keys
    rows: np.ndarray | None = None  # (n, D) float32 result
    future: GatherFuture | None = None
    done: bool = False
    t_submit: float = 0.0
    t_done: float = 0.0
    valid: np.ndarray | None = None  # (n,) bool; None = all positions valid
    degraded: bool = False  # completed partially (an owner died)
    resubmits: int = 0  # deadline-driven re-submissions of this request
    # --- multi-tenant QoS (set by the serving tier's router) ---
    tenant: str | None = None  # whose credit budget the frames charge
    express: bool = False  # control-lane drain priority at the servers
    slot_quota: int = 0  # max CQ slots this tenant may hold (0 = uncapped)
    t_admit: float = 0.0  # when the request last entered the fabric


@dataclass
class GatherReport(WireReportMixin):
    """Per-run accounting, the gather sibling of ChaseReport."""

    results: list[np.ndarray]
    rounds: int
    puts: int
    gets: int
    put_bytes: int
    get_bytes: int
    modeled_us: float
    invokes: int = 0  # dispatches across all PEs (batched dispatch = 1)
    coalesced_frames: int = 0
    coalesced_payloads: int = 0
    region_puts: int = 0  # one-sided slab-write batches (zero-copy RETURNs)
    region_put_bytes: int = 0  # data + doorbell bytes those writes carried
    hop_frames: int = 0  # PUBLISH hop frames (tree code distribution)
    wire_bytes_by_kind: dict = field(default_factory=dict)


class EmbedShardService:
    """Continuous-batching embedding-shard service on a PE cluster."""

    #: The pushdown operator this service ships and dispatches on; a
    #: sibling service overrides these plus :meth:`_publish_ops` /
    #: :meth:`_request_body` and shares admission, recovery, retirement
    #: and reporting.
    op_name = "gatherer"
    return_name = "gather_return"

    def __init__(
        self,
        cluster: Cluster,
        vocab: int,
        dim: int,
        n_keys: int = 8,
        max_slots: int = 64,
        seed: int = 0,
        table: np.ndarray | None = None,
        strict_recovery: bool = False,
    ) -> None:
        if vocab % cluster.n_servers:
            raise ValueError("vocab must divide evenly across servers")
        self.cluster = cluster
        self.vocab = vocab
        self.dim = dim
        self.n_keys = n_keys
        self.max_slots = max_slots
        # strict_recovery: resubmit-budget exhaustion raises (after the
        # recovery sweep completes) instead of silently degrading
        self.strict_recovery = strict_recovery
        self.rows_per_shard = vocab // cluster.n_servers
        if table is None:
            rng = np.random.default_rng(seed)
            table = rng.standard_normal((vocab, dim)).astype(np.float32)
        self.table = np.asarray(table, np.float32)
        assert self.table.shape == (vocab, dim)
        # shards + metadata to the servers (rows stay put forever after)
        for i, pe in enumerate(cluster.servers):
            lo = i * self.rows_per_shard
            pe.register_region(
                "embed_shard", self.table[lo : lo + self.rows_per_shard].copy()
            )
            pe.register_cap(
                "gather_meta",
                np.array([i, self.rows_per_shard, cluster.n_servers], np.int32),
            )
        # toolchain artifacts (code travels on first contact, then caches)
        self._publish_ops()
        self.cq = CompletionQueue(
            cluster.client, shape=(n_keys, dim), dtype=np.float32,
            max_slots=max_slots,
        )
        self.queue: deque[GatherRequest] = deque()
        self.active: dict[int, GatherRequest] = {}  # slot -> request
        self.finished: list[GatherRequest] = []
        self._next_rid = 0
        self.batching = False
        self.ticks = 0  # scheduler rounds driven; also the CQ deadline clock

    # ------------------------------------------------------------------ util
    def owner(self, key: int) -> int:
        return int(key) // self.rows_per_shard

    def _pad(self, keys: np.ndarray) -> np.ndarray:
        padded = np.full(self.n_keys, -1, np.int32)
        padded[: len(keys)] = keys
        return padded

    def _publish_ops(self) -> None:
        """Publish this service's pushdown operator pair to the toolchain."""
        self.cluster.toolchain.publish(
            make_gatherer(
                self.rows_per_shard, self.cluster.n_servers, self.n_keys, self.dim
            )
        )
        self.cluster.toolchain.publish(
            make_gather_return(self.max_slots, self.n_keys, self.dim)
        )

    def _request_body(self, req: GatherRequest) -> np.ndarray:
        """The operator-specific request payload (appended after the
        runtime's ``[requester, slot, epoch]`` header by ``PE.submit``)."""
        return self._pad(req.keys)

    # -------------------------------------------------------- placement layer
    def plan_with(self, optimizer, workload) -> "object":
        """Price this service's pushdown against its pull baseline through
        a :class:`~repro_torch.sharding.placement.PlacementOptimizer` (duck-
        typed — anything with a compatible ``plan``).  The gather pull side
        is one GET round trip *per row*."""
        n = max(len(workload), 1)
        rows = sum(len(b) for b in workload) / n
        kb = max(int(round(rows)), 1)
        return optimizer.plan(
            requester=self.cluster.client.name,
            executor=self.cluster.servers[0].name,
            operand_bytes=kb * self.dim * 4,
            result_bytes=kb * self.dim * 4,
            selectivity=1.0,
            request_payload_bytes=(3 + self.n_keys) * 4,
            op_name=self.op_name,
            return_name=self.return_name,
            return_header_bytes=3 * 4,
            n_requests=n,
            pull_messages=kb,
        )

    def _resolve_placement(self, placement, workload) -> str:
        """Resolve a placement directive to ``"pushdown"`` or ``"pull"``.

        Precedence: explicit argument > the cluster's policy
        (``Cluster.set_placement``) > pushdown.  ``"auto"`` (or passing an
        optimizer instance) consults the cost model against the advertised
        capability vectors."""
        choice = placement if placement is not None else self.cluster.placement_policy
        if choice is None:
            return "pushdown"
        if not isinstance(choice, str):
            return self.plan_with(choice, workload).choice
        if choice == "auto":
            return self.plan_with(self._auto_optimizer(), workload).choice
        if choice not in ("pushdown", "pull"):
            raise ValueError(
                f"placement must be 'pushdown', 'pull', 'auto', or an "
                f"optimizer, got {choice!r}"
            )
        return choice

    def _auto_optimizer(self):
        opt = self.cluster.placement()
        if opt is not None:
            return opt
        from repro_torch.sharding.placement import PlacementOptimizer

        return PlacementOptimizer(self.cluster)

    # ------------------------------------------------------------------- API
    def submit(
        self,
        keys: np.ndarray,
        tenant: str | None = None,
        express: bool = False,
        slot_quota: int = 0,
    ) -> int:
        """Queue one gather request (a batch of up to ``n_keys`` row ids).

        ``tenant``/``express``/``slot_quota`` thread the serving tier's
        per-tenant QoS down to the PE runtime: credit-budget attribution,
        control-lane drain priority, and CQ-slot admission quota."""
        keys = np.asarray(keys, np.int32)
        if not (1 <= len(keys) <= self.n_keys):
            raise ValueError(f"request must carry 1..{self.n_keys} keys")
        if keys.min() < 0 or keys.max() >= self.vocab:
            raise ValueError("key out of table range")
        req = GatherRequest(
            self._next_rid, keys, t_submit=time.perf_counter(),
            tenant=tenant, express=express, slot_quota=slot_quota,
        )
        self._next_rid += 1
        self.queue.append(req)
        return req.rid

    def _dead_peers(self) -> set[str]:
        """Peers the failure detector has declared dead, from any alive
        PE's point of view (the client's matters most: it submits)."""
        dead: set[str] = set()
        for pe in self.cluster.alive_pes():
            dead |= pe.progress.detector.dead
        return dead

    def _entry_server(self, req: GatherRequest, dead: set[str]) -> str | None:
        """Pick the request's entry server, skipping detector-dead owners.
        ``None`` means every shard the request touches is dead."""
        for key in req.keys:
            name = f"server{self.owner(key)}"
            if name not in dead:
                return name
        return None

    def _admit(self) -> int:
        admitted = 0
        dead = self._dead_peers() if self.cluster.client.reliability.enabled else set()
        held: list[GatherRequest] = []
        while self.queue:
            req = self.queue.popleft()
            entry = self._entry_server(req, dead)
            if entry is None:
                # every owning shard is dead: nothing can serve any key —
                # complete degraded with an all-invalid mask rather than
                # submitting into a void
                req.rows = np.zeros((len(req.keys), self.dim), np.float32)
                req.valid = np.zeros(len(req.keys), bool)
                req.degraded = True
                req.done = True
                req.t_done = time.perf_counter()
                self.finished.append(req)
                admitted += 1
                continue
            fut = self.cluster.client.submit(
                entry,
                self.op_name,
                self._request_body(req),
                self.cq,
                expected=len(req.keys),
                express=req.express,
                tenant=req.tenant,
                slot_quota=req.slot_quota,
            )
            if fut is None:
                if self.cq.free_slots == 0:
                    # completion queue saturated: submit would-block (CQ
                    # backpressure admission) — requeue at the front and
                    # stop admitting until retirements free slots.
                    # In-flight requests are untouched; nothing raises
                    # mid-batch.
                    self.queue.appendleft(req)
                    break
                # slots remain but this request's tenant is at its CQ
                # quota: hold IT back and keep admitting other tenants —
                # one tenant's backlog must not head-of-line-block the rest
                held.append(req)
                continue
            fut.attempts = req.resubmits
            req.future = fut
            req.t_admit = time.perf_counter()
            self.active[fut.slot] = req
            admitted += 1
        for req in reversed(held):
            self.queue.appendleft(req)
        return admitted

    def _recover(self) -> int:
        """Deadline-driven recovery: each expired in-flight gather either
        degrades to a partial result (an owning shard is detector-dead —
        its positions can never arrive) or is resubmitted to the surviving
        owners (the loss was transient: a dropped one-sided RETURN write
        has no retransmit queue, so the service layer is the retry).
        Returns a progress count so recovery rounds read as progress."""
        rel = self.cluster.client.reliability
        if not rel.enabled:
            return 0
        actions = 0
        dead = self._dead_peers()
        exhausted: list[tuple[GatherRequest, list[str]]] = []
        for fut in self.cq.expired():
            req = self.active.get(fut.slot)
            if req is None:  # not one of ours (foreign submission)
                continue
            owners = {f"server{self.owner(k)}" for k in req.keys}
            del self.active[fut.slot]
            dead_owner = bool(owners & dead)
            if not dead_owner:
                req.resubmits += 1
            if dead_owner or req.resubmits > rel.retransmit_budget:
                # attributed: an owner died, or the budget is spent with
                # owners alive — either way degrade to whatever arrived
                # (result_partial preserves landed rows + validity mask;
                # cancelling first would discard them) and keep sweeping.
                # Raising here used to abandon every later expired future
                # mid-sweep, leaking its slot and stranding its request.
                rows, mask = fut.result_partial()
                req.future = None
                req.rows = rows[: len(req.keys)]
                req.valid = mask[: len(req.keys)]
                req.degraded = True
                req.done = True
                req.t_done = time.perf_counter()
                self.finished.append(req)
                if not dead_owner:
                    exhausted.append((req, sorted(owners)))
                actions += 1
                continue
            # owners all believed alive, budget remains: transient loss —
            # resubmit (a dropped one-sided RETURN has no retransmit
            # queue, so the service layer is the retry)
            fut.cancel()
            req.future = None
            self.queue.appendleft(req)
            actions += 1
        if exhausted and self.strict_recovery:
            detail = "; ".join(
                f"rid={r.rid} owners={o} resubmits={r.resubmits}"
                for r, o in exhausted
            )
            raise TimeoutError(
                f"{len(exhausted)} gather(s) exceeded resubmit budget "
                f"({rel.retransmit_budget}) with owners alive: {detail}"
            )
        return actions

    def _retire(self) -> int:
        retired = 0
        for slot, req in list(self.active.items()):
            assert req.future is not None
            if req.future.done():
                req.rows = req.future.result()[: len(req.keys)]
                req.done = True
                req.t_done = time.perf_counter()
                self.finished.append(req)
                del self.active[slot]
                retired += 1
        return retired

    def tick(self) -> int:
        """One scheduler round: admit -> flush -> poll every PE -> recover
        -> retire.  Returns a progress count (admissions + polled messages
        + recovery actions + retires)."""
        self.ticks += 1
        self.cq.advance()
        progress = self._admit()
        if self.batching:
            self.cluster.client.flush()
        for pe in self.cluster.alive_pes():
            progress += pe.poll()
        progress += self._recover()
        progress += self._retire()
        return progress

    def _outstanding_detail(self) -> str:
        """The attributed tail for the idle-timeout error: which requests
        are stuck, where, and for how long (satellite of the reliability
        layer — a bare timeout names nothing actionable)."""
        now = time.perf_counter()
        lines = []
        for slot, req in sorted(self.active.items()):
            fut = req.future
            arrived = self.cq._count(slot) if fut is not None else 0
            owners = sorted({f"server{self.owner(k)}" for k in req.keys})
            age_t = self.cq.ticks - fut.submit_tick if fut is not None else 0
            lines.append(
                f"  slot {slot}: rid={req.rid} arrived={arrived}/"
                f"{len(req.keys)} owners={owners} age={age_t} ticks "
                f"({now - req.t_submit:.3f}s) resubmits={req.resubmits}"
            )
        if self.queue:
            lines.append(f"  +{len(self.queue)} queued, never admitted")
        return "\n".join(lines)

    def run(self, max_rounds: int = 1_000_000) -> int:
        """Drive ticks until every queued/active request finished; returns
        the number of rounds.  Raises TimeoutError if the cluster goes idle
        with work outstanding (a lost frame — the fault-injection tests'
        detection path); under reliability, idleness is tolerated through
        the recovery horizon plus the CQ deadline before giving up, and
        the error enumerates every stuck request (slot, owners, ages)."""
        rel = self.cluster.client.reliability
        idle_limit = rel.idle_grace() + rel.future_deadline if rel.enabled else 2
        rounds = idle = 0
        while self.queue or self.active:
            if self.tick():
                idle = 0
            else:
                idle += 1
                if idle > idle_limit:
                    raise TimeoutError(
                        "service idle but requests outstanding:\n"
                        + self._outstanding_detail()
                    )
            rounds += 1
            if rounds > max_rounds:
                raise TimeoutError("max_rounds exceeded")
        return rounds

    # ------------------------------------------------- measured entry points
    def _invokes(self) -> int:
        return sum(pe.stats.invokes for pe in self.cluster.pes())

    def _report(
        self, results: list[np.ndarray], rounds: int, invokes0: int
    ) -> GatherReport:
        st = self.cluster.fabric.stats
        return GatherReport(
            results=results,
            rounds=rounds,
            invokes=self._invokes() - invokes0,
            **st.report_kwargs(),
        )

    def distribute_code(self, propagation: PropagationConfig) -> None:
        """Tree-publish the Gatherer to every alive server (code-only: no
        invoke) and mark every sender's cache for the covered peers, so the
        whole request stream — client key-frames and server-to-server
        FORWARDs alike — travels digest-only from the first request.
        Orphaned subtrees (dead mid-tree PE, dropped hop) are re-covered
        by the shared :meth:`repro_torch.core.cluster.Cluster.distribute_code`."""
        self.cluster.distribute_code(self.op_name, propagation)

    def gather(
        self,
        key_batches: list[np.ndarray],
        batching: bool = False,
        dataplane: DataPlaneConfig | None = None,
        propagation: PropagationConfig | None = None,
        placement: object | None = None,
    ) -> GatherReport:
        """Submit a burst of requests, run to completion, report results in
        submission order plus wire/dispatch accounting for this run only.
        ``dataplane`` selects the partial-RETURN protocol: framed (default),
        zero-copy slab writes into the completion queue's registered region,
        or rendezvous descriptor + GET.  ``propagation`` pre-distributes the
        Gatherer down a spanning tree instead of letting each first contact
        push the code flat.  ``placement`` routes the burst: ``"pushdown"``
        (the X-RDMA path), ``"pull"`` (the per-row GET baseline),
        ``"auto"``/a :class:`~repro_torch.sharding.placement.PlacementOptimizer`
        (cost-model choice); ``None`` defers to the cluster's policy."""
        if self._resolve_placement(placement, key_batches) == "pull":
            return self.gather_get(key_batches)
        self.cluster.fabric.stats.reset()
        invokes0 = self._invokes()
        n0 = len(self.finished)
        self.cluster.set_batching(batching)
        self.cluster.set_dataplane(dataplane)
        self.batching = batching
        if propagation is not None:
            self.distribute_code(propagation)
        try:
            rids = [self.submit(k) for k in key_batches]
            rounds = self.run()
        finally:
            self.batching = False
            self.cluster.set_batching(False)
            self.cluster.set_dataplane(None)
        # consume this burst's retirements: a long-running service must not
        # accumulate result rows for requests already handed back
        done_now, self.finished = self.finished[n0:], self.finished[:n0]
        by_rid = {r.rid: r for r in done_now}
        results = [by_rid[rid].rows for rid in rids]
        return self._report(results, rounds, invokes0)

    def gather_get(self, key_batches: list[np.ndarray]) -> GatherReport:
        """The move-data-to-compute baseline: one one-sided GET round trip
        per row, client does all the work (the gather sibling of GBPC)."""
        self.cluster.fabric.stats.reset()
        invokes0 = self._invokes()
        fabric = self.cluster.fabric
        client = self.cluster.client
        row_bytes = self.dim * 4
        results = []
        for keys in key_batches:
            keys = np.asarray(keys, np.int32)
            rows = np.empty((len(keys), self.dim), np.float32)
            for j, key in enumerate(keys):
                srv = self.owner(key)
                off = (int(key) - srv * self.rows_per_shard) * row_bytes
                data = fabric.get(
                    client.name, f"server{srv}", "embed_shard", off, row_bytes
                )
                rows[j] = np.frombuffer(data, np.float32)
            results.append(rows)
        return self._report(results, rounds=0, invokes0=invokes0)

    def oracle(self, key_batches: list[np.ndarray]) -> list[np.ndarray]:
        """Numpy take-based oracle for any gather implementation."""
        return [self.table[np.asarray(k, np.int32)] for k in key_batches]


class FilterShardService(EmbedShardService):
    """Predicate pushdown over the embedding-shard substrate.

    A request names a contiguous shard-aligned window ``[lo, lo+W)`` and a
    float32 threshold; the Filter ifunc evaluates ``rows[:, 0] > thresh``
    *next to the shard* and RETURNs only the survivors (a ragged payload —
    wire bytes scale with selectivity, the whole point of pushdown).  The
    result contract matches the oracle ``where(pred, window, 0)``: each
    surviving row lands at its original window position, dropped positions
    read zero.  On the card the servers' ``cuda-sm90`` slice resolves each
    window through the ``embed_lookup`` kernel.

    The pull baseline (:meth:`filter_pull`) fetches the window with one
    range GET and filters client-side — cheaper than pushdown exactly when
    the cost model says so (high selectivity, or an executor with a fat
    per-message overhead), which is what :meth:`filter`'s ``placement=``
    machinery decides.
    """

    op_name = "filter"
    return_name = "filter_return"

    def __init__(
        self,
        cluster: Cluster,
        vocab: int,
        dim: int,
        window: int = 16,
        max_slots: int = 64,
        seed: int = 0,
        table: np.ndarray | None = None,
        strict_recovery: bool = False,
    ) -> None:
        super().__init__(
            cluster, vocab, dim, n_keys=window, max_slots=max_slots,
            seed=seed, table=table, strict_recovery=strict_recovery,
        )
        self._thresh_bits = 0
        self._selectivity_hint = 1.0

    def _publish_ops(self) -> None:
        self.cluster.toolchain.publish(
            make_filter(
                self.rows_per_shard, self.cluster.n_servers, self.n_keys, self.dim
            )
        )
        self.cluster.toolchain.publish(
            make_filter_return(self.max_slots, self.n_keys, self.dim)
        )

    def _request_body(self, req: GatherRequest) -> np.ndarray:
        # [lo, thresh_bits]; PE.submit prepends [requester, slot, epoch]
        return np.array([int(req.keys[0]), self._thresh_bits], np.int32)

    def plan_with(self, optimizer, workload):
        w, d = self.n_keys, self.dim
        return optimizer.plan(
            requester=self.cluster.client.name,
            executor=self.cluster.servers[0].name,
            operand_bytes=w * d * 4,
            result_bytes=w * d * 4,
            selectivity=self._selectivity_hint,
            request_payload_bytes=5 * 4,  # [requester, slot, epoch, lo, thresh]
            op_name=self.op_name,
            return_name=self.return_name,
            return_header_bytes=(3 + w) * 4,  # [slot, epoch, evalmask] + spos
            n_requests=max(len(workload), 1),
            pull_messages=1,  # a window is one contiguous range GET
        )

    # -------------------------------------------------------------- workloads
    def windows(self, n_requests: int, seed: int = 0) -> np.ndarray:
        """``n_requests`` uniform-random shard-aligned window starts."""
        rng = np.random.default_rng(seed)
        w, rp = self.n_keys, self.rows_per_shard
        srv = rng.integers(0, self.cluster.n_servers, n_requests)
        off = rng.integers(0, rp - w + 1, n_requests)
        return (srv * rp + off).astype(np.int64)

    def thresh_for_selectivity(self, selectivity: float) -> np.float32:
        """The column-0 threshold whose pass rate is ``selectivity``."""
        q = np.quantile(self.table[:, 0].astype(np.float64), 1.0 - selectivity)
        return np.float32(q)

    def selectivity_of(self, thresh) -> float:
        return float(np.mean(self.table[:, 0] > np.float32(thresh)))

    def _window_keys(self, lo: int) -> np.ndarray:
        lo, w = int(lo), self.n_keys
        if not (0 <= lo and lo + w <= self.vocab):
            raise ValueError(f"window [{lo}, {lo + w}) outside the table")
        if self.owner(lo) != self.owner(lo + w - 1):
            raise ValueError(f"window [{lo}, {lo + w}) crosses a shard boundary")
        return np.arange(lo, lo + w, dtype=np.int32)

    # ------------------------------------------------------------ entrypoints
    def filter(
        self,
        los,
        thresh,
        batching: bool = False,
        dataplane: DataPlaneConfig | None = None,
        propagation: PropagationConfig | None = None,
        placement: object | None = None,
        selectivity: float | None = None,
    ) -> GatherReport:
        """Filter a burst of windows; one request per ``lo``.

        ``selectivity`` is the cost model's survivor-fraction estimate;
        by default it is computed exactly from the service's own table
        (deterministic, and what a real system's statistics catalog
        provides).  Placement resolution is as in :meth:`gather`."""
        thresh = np.float32(thresh)
        if selectivity is None:
            selectivity = self.selectivity_of(thresh)
        self._selectivity_hint = float(selectivity)
        if self._resolve_placement(placement, los) == "pull":
            return self.filter_pull(los, thresh)
        self._thresh_bits = int(
            np.frombuffer(np.float32(thresh).tobytes(), np.int32)[0]
        )
        batches = [self._window_keys(lo) for lo in los]
        return super().gather(
            batches, batching=batching, dataplane=dataplane,
            propagation=propagation, placement="pushdown",
        )

    def filter_pull(self, los, thresh) -> GatherReport:
        """Move-data-to-compute baseline: one range GET per window, the
        client evaluates the predicate after the whole operand crossed."""
        self.cluster.fabric.stats.reset()
        invokes0 = self._invokes()
        fabric, client = self.cluster.fabric, self.cluster.client
        w, d = self.n_keys, self.dim
        thresh = np.float32(thresh)
        results = []
        for lo in los:
            self._window_keys(lo)  # validate alignment like the pushdown path
            srv = self.owner(lo)
            off = (int(lo) - srv * self.rows_per_shard) * d * 4
            data = fabric.get(
                client.name, f"server{srv}", "embed_shard", off, w * d * 4
            )
            window = np.frombuffer(data, np.float32).reshape(w, d)
            results.append(
                np.where((window[:, 0] > thresh)[:, None], window, 0.0).astype(
                    np.float32
                )
            )
        return self._report(results, rounds=0, invokes0=invokes0)

    def oracle_filter(self, los, thresh) -> list[np.ndarray]:
        """Numpy oracle: ``where(col0 > thresh, window, 0)`` per window."""
        thresh = np.float32(thresh)
        out = []
        for lo in los:
            win = self.table[int(lo) : int(lo) + self.n_keys]
            out.append(
                np.where((win[:, 0] > thresh)[:, None], win, 0.0).astype(np.float32)
            )
        return out
