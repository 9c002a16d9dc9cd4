"""Distribution layer of the port: heterogeneous placement pricing and the
X-RDMA multi-hop tree collectives.

The JAX package's logical-axis partition rules, its compute-to-data
``shard_map`` programs and its compiled-mesh gradient reductions come with
the compiled SPMD rendering (ROADMAP, port queue item 7)."""

from .collectives import (
    PropagateReport,
    ReduceReport,
    xrdma_bcast,
    xrdma_flat_push,
    xrdma_reduce,
)
from .placement import PlacementDecision, PlacementOptimizer

__all__ = [
    "PlacementDecision",
    "PlacementOptimizer",
    "PropagateReport",
    "ReduceReport",
    "xrdma_bcast",
    "xrdma_flat_push",
    "xrdma_reduce",
]
