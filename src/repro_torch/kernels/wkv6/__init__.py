from .kernel import HEAD_DIMS, wkv6
from .ref import wkv6_ref

__all__ = ["HEAD_DIMS", "wkv6", "wkv6_ref"]
