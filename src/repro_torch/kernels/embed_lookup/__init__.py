from .kernel import embed_grid, embed_lookup, embed_lookup_op, embed_route
from .ref import embed_lookup_ref

__all__ = ["embed_grid", "embed_lookup", "embed_lookup_op", "embed_lookup_ref", "embed_route"]
