"""Serving runtimes over the port's X-RDMA substrate: the embedding-shard
service, and the LM's continuous-batching scheduler with its remote
embedding client."""

from .embed_service import (
    EmbedShardService,
    GatherReport,
    GatherRequest,
    ragged_batches,
)
from .serving import Request, ServeScheduler
from .tenancy import RemoteEmbedClient

__all__ = [
    "EmbedShardService", "GatherReport", "GatherRequest", "RemoteEmbedClient", "Request",
    "ServeScheduler", "ragged_batches",
]
