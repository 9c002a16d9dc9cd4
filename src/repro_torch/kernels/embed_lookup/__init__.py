from .kernel import embed_lookup, embed_lookup_op
from .ref import embed_lookup_ref

__all__ = ["embed_lookup", "embed_lookup_op", "embed_lookup_ref"]
