"""Distribution layer of the port: heterogeneous placement pricing, the
X-RDMA multi-hop tree collectives, and the compiled SPMD rendering over
``torch.distributed`` (a named :class:`Mesh`, the compute-to-data DAPC and
Gather programs, and the compiled-mesh gradient reductions).

The JAX package's logical-axis partition rules (``sharding/partition.py``)
come with the training runtime (ROADMAP, port queue item 5)."""

from .collectives import (
    PropagateReport,
    ReduceReport,
    compressed_psum_with_feedback,
    dequantize_int8,
    hierarchical_psum,
    init_error_feedback,
    quantize_int8,
    xrdma_bcast,
    xrdma_flat_push,
    xrdma_reduce,
)
from .compute_to_data import (
    chase_oracle,
    dapc_shard_map,
    gather_ref,
    gather_shard_map,
    gbpc_reference,
)
from .mesh import Mesh, init_mesh, shard_rows
from .placement import PlacementDecision, PlacementOptimizer

__all__ = [
    "Mesh",
    "PlacementDecision",
    "PlacementOptimizer",
    "PropagateReport",
    "ReduceReport",
    "chase_oracle",
    "compressed_psum_with_feedback",
    "dapc_shard_map",
    "dequantize_int8",
    "gather_ref",
    "gather_shard_map",
    "gbpc_reference",
    "hierarchical_psum",
    "init_error_feedback",
    "init_mesh",
    "quantize_int8",
    "shard_rows",
    "xrdma_bcast",
    "xrdma_flat_push",
    "xrdma_reduce",
]
