"""Serving runtimes over the port's X-RDMA substrate: the embedding-shard
service and its predicate-pushdown sibling, the multi-tenant router over
it, and the LM's continuous-batching scheduler with its remote
embedding client; and the LM's fault-tolerant training driver with its
health monitors."""

from .driver import TrainDriver, TrainReport
from .embed_service import (
    EmbedShardService,
    FilterShardService,
    GatherReport,
    GatherRequest,
    ragged_batches,
)
from .monitor import HeartbeatMonitor, StepTimer, StragglerPolicy
from .serving import Request, ServeScheduler
from .tenancy import RemoteEmbedClient, TenantClass, TenantRouter, TenantStats

__all__ = [
    "EmbedShardService", "FilterShardService", "GatherReport", "GatherRequest", "RemoteEmbedClient", "Request",
    "ServeScheduler", "TenantClass", "TenantRouter", "TenantStats", "ragged_batches",
]
