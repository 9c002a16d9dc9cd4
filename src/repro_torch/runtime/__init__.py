"""Serving runtimes over the port's X-RDMA substrate."""

from .embed_service import (
    EmbedShardService,
    GatherReport,
    GatherRequest,
    ragged_batches,
)

__all__ = ["EmbedShardService", "GatherReport", "GatherRequest", "ragged_batches"]
