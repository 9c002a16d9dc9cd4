"""Serving runtimes over the port's X-RDMA substrate: the embedding-shard
service and its predicate-pushdown sibling, and the LM's continuous-batching scheduler with its remote
embedding client."""

from .embed_service import (
    EmbedShardService,
    FilterShardService,
    GatherReport,
    GatherRequest,
    ragged_batches,
)
from .serving import Request, ServeScheduler
from .tenancy import RemoteEmbedClient

__all__ = [
    "EmbedShardService", "FilterShardService", "GatherReport", "GatherRequest", "RemoteEmbedClient", "Request",
    "ServeScheduler", "ragged_batches",
]
