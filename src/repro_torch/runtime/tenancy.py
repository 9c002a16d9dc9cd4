"""Multi-tenant serving tier: per-tenant QoS over the PE fabric, and the
LM's remote embedding client.

The serving shape: many tenants multiplex one embedding-shard substrate
(:class:`repro_torch.runtime.embed_service.EmbedShardService`).  Without QoS a
single hot tenant saturates the shared completion queue and the per-peer
credit windows, and every other tenant's tail latency collapses with it.
The router maps each tenant's :class:`TenantClass` onto the three
isolation mechanisms the runtime already has:

* **lanes** — ``express`` tenants' frames carry :data:`FrameFlags.EXPRESS`
  and drain through the progress engine's control lane ahead of bulk data;
* **credits** — ``credit_budget`` carves a per-tenant slice out of the
  sender's outgoing occupancy (the fabric's tenant ledger): a tenant over
  budget stalls its *own* (dst, tenant) wire lane while neighbours flow;
* **slots** — ``slot_quota`` caps the CQ slots a tenant may hold, reusing
  the ``submit -> None`` would-block contract for admission control.

Load shedding happens *above* the fabric: a tenant at ``queue_limit``
outstanding requests has new submissions refused at the router (``None``
rid) — a shed request never consumes a credit, a slot, or a wire byte, so
shedding is trivially exactly-once (nothing to cancel or dedup).  On the
card every served request's rows resolve through the servers'
``embed_lookup`` kernel, whatever the tenant.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import Cluster
from ..core.verify import SandboxConfig
from .embed_service import EmbedShardService


@dataclass(frozen=True)
class TenantClass:
    """One tenant's QoS contract (all zeros = best-effort, no isolation).

    ``sandbox`` optionally declares the code-injection policy this tenant
    is willing to run under; the router merges every declaring class's
    policy with :meth:`SandboxConfig.strictest` and installs the result
    cluster-wide — the substrate is shared, so the fabric must enforce
    the strictest contract any tenant demanded."""

    name: str
    express: bool = False  # control-lane drain priority at the receivers
    credit_budget: int = 0  # outgoing payloads in flight (0 = unbudgeted)
    slot_quota: int = 0  # concurrent CQ slots (0 = uncapped)
    queue_limit: int = 0  # outstanding requests before shedding (0 = never)
    sandbox: SandboxConfig | None = None  # code-injection policy (None = none)


@dataclass
class TenantStats:
    """Per-tenant serving accounting (ticks are scheduler rounds)."""

    submitted: int = 0  # requests accepted by the router
    served: int = 0  # requests completed (degraded ones included)
    shed: int = 0  # requests refused at queue_limit (never entered fabric)
    degraded: int = 0  # served with a partial validity mask
    latencies: list = field(default_factory=list)  # ticks, submit -> done

    def percentile(self, q: float) -> float:
        if not self.latencies:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies, np.float64), q))

    def as_dict(self) -> dict:
        return {
            "submitted": self.submitted,
            "served": self.served,
            "shed": self.shed,
            "degraded": self.degraded,
            "p50_ticks": self.percentile(50),
            "p95_ticks": self.percentile(95),
        }


class TenantRouter:
    """Request router multiplexing tenants onto one EmbedShardService.

    The router owns no queues of its own: admission control lives in the
    service (CQ backpressure + per-tenant slot quotas) and the wire layer
    (credit budgets), so the router's job is classification — stamp each
    request with its tenant's QoS — plus shedding and accounting.
    """

    def __init__(
        self, service: EmbedShardService, classes: "list[TenantClass]"
    ) -> None:
        self.service = service
        self.classes = {c.name: c for c in classes}
        if len(self.classes) != len(classes):
            raise ValueError("duplicate tenant class names")
        self.stats = {c.name: TenantStats() for c in classes}
        self._submit_tick: dict[int, int] = {}  # rid -> service tick
        self._rid_tenant: dict[int, str] = {}
        # install the credit carve-out on every PE's wire layer
        service.cluster.set_tenant_budgets(
            {c.name: c.credit_budget for c in classes if c.credit_budget}
        )
        # install the strictest declared code-injection policy cluster-wide
        boxes = [c.sandbox for c in classes if c.sandbox is not None]
        if boxes:
            service.cluster.set_sandbox(SandboxConfig.strictest(boxes))

    # ------------------------------------------------------------------ API
    def outstanding(self, tenant: str) -> int:
        """Requests accepted for ``tenant`` and not yet completed."""
        st = self.stats[tenant]
        return st.submitted - st.served

    def submit(self, tenant: str, keys: np.ndarray) -> int | None:
        """Route one gather request; returns its rid, or ``None`` when the
        tenant is at its queue limit and the request was shed (it never
        touched the fabric — exactly-once by construction)."""
        cls = self.classes[tenant]
        st = self.stats[tenant]
        if cls.queue_limit and self.outstanding(tenant) >= cls.queue_limit:
            st.shed += 1
            return None
        rid = self.service.submit(
            keys,
            tenant=tenant,
            express=cls.express,
            slot_quota=cls.slot_quota,
        )
        st.submitted += 1
        self._submit_tick[rid] = self.service.ticks
        self._rid_tenant[rid] = tenant
        return rid

    def _harvest(self) -> list:
        """Consume the service's finished list, attributing completions."""
        done, self.service.finished = self.service.finished, []
        for req in done:
            tenant = self._rid_tenant.pop(req.rid, None)
            if tenant is None:
                continue  # not router traffic (e.g. a warm-up gather)
            st = self.stats[tenant]
            st.served += 1
            if req.degraded:
                st.degraded += 1
            st.latencies.append(self.service.ticks - self._submit_tick.pop(req.rid))
        return done

    def tick(self) -> list:
        """One scheduler round; returns this round's completed requests."""
        self.service.tick()
        return self._harvest()

    def run(self, max_rounds: int = 1_000_000) -> int:
        """Drive ticks until every accepted request completed."""
        rounds = 0
        while self.service.queue or self.service.active:
            self.tick()
            rounds += 1
            if rounds > max_rounds:
                raise TimeoutError("tenant router exceeded max_rounds")
        self._harvest()
        return rounds

    def report(self) -> dict:
        return {name: st.as_dict() for name, st in sorted(self.stats.items())}


class RemoteEmbedClient:
    """Embedding rows as a service: the LM decode loop's token embeddings
    fetched through CQ-tracked gathers instead of a local table lookup.

    Owns a private cluster whose servers hold the (row-padded, f32)
    embedding table; :meth:`rows` chunks a token batch into ``n_keys``-row
    gathers and reassembles the result.  Rows travel bit-exactly (f32
    bit-cast through the int32 CQ words), so a decode stream fed by this
    client is bit-identical to the local-embed stream.  On the card each
    server resolves its rows with the ``embed_lookup`` kernel.
    """

    def __init__(
        self,
        embed_table: np.ndarray,
        n_servers: int = 2,
        n_keys: int = 8,
        max_slots: int = 16,
        device: "torch.device | str | None" = None,
    ) -> None:
        table = np.asarray(embed_table, np.float32)
        self.vocab = table.shape[0]
        pad = (-self.vocab) % n_servers
        if pad:
            table = np.concatenate([table, np.zeros((pad, table.shape[1]), np.float32)])
        self.cluster = Cluster(n_servers, device=device)
        self.service = EmbedShardService(
            self.cluster,
            vocab=table.shape[0],
            dim=table.shape[1],
            n_keys=n_keys,
            max_slots=max_slots,
            table=table,
        )
        self.gathers = 0  # CQ-tracked gather requests issued

    def rows(self, ids: np.ndarray) -> np.ndarray:
        """Fetch embedding rows for ``ids`` (any shape) via the service."""
        ids = np.asarray(ids, np.int32)
        flat = ids.reshape(-1)
        n = self.service.n_keys
        batches = [flat[i : i + n] for i in range(0, len(flat), n)]
        report = self.service.gather(batches)
        self.gathers += len(batches)
        out = np.concatenate(report.results, axis=0)
        return out.reshape(*ids.shape, -1)
