"""Distribution layer of the port: heterogeneous placement pricing, the
X-RDMA multi-hop tree collectives, and the compiled SPMD rendering over
``torch.distributed`` (a named :class:`Mesh` and its collectives that carry
gradients, the compute-to-data DAPC and Gather programs, and the
compiled-mesh gradient reductions), and the logical-axis partition rules
(``partition.py``) that lay a model's leaves out on a mesh for training and
for serving (``SERVE_RULES``, the KV cache's ``cache_specs``)."""

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
from .mesh import (
    Mesh,
    all_to_all_region,
    copy_to_region,
    gather_from_region,
    init_mesh,
    pmean_region,
    reduce_from_region,
    reduce_scatter_to_region,
    scatter_to_region,
    shard_rows,
)
from .partition import Layout, MeshShape, full_leaf, local_block, rules_for_train, spec_for
from .placement import PlacementDecision, PlacementOptimizer

__all__ = [
    "Layout",
    "Mesh",
    "MeshShape",
    "PlacementDecision",
    "PlacementOptimizer",
    "PropagateReport",
    "ReduceReport",
    "all_to_all_region",
    "chase_oracle",
    "copy_to_region",
    "compressed_psum_with_feedback",
    "dapc_shard_map",
    "dequantize_int8",
    "full_leaf",
    "gather_from_region",
    "gather_ref",
    "gather_shard_map",
    "gbpc_reference",
    "hierarchical_psum",
    "init_error_feedback",
    "init_mesh",
    "local_block",
    "pmean_region",
    "quantize_int8",
    "reduce_from_region",
    "reduce_scatter_to_region",
    "rules_for_train",
    "scatter_to_region",
    "shard_rows",
    "spec_for",
    "xrdma_bcast",
    "xrdma_flat_push",
    "xrdma_reduce",
]
