from .kernel import HEAD_DIMS, ROUTES, SPLIT_MIN_T, wkv6, wkv6_route, split_chunk
from .ref import wkv6_ref, wkv6_split_ref

__all__ = ["HEAD_DIMS", "ROUTES", "SPLIT_MIN_T", "wkv6", "wkv6_ref",
           "wkv6_route", "split_chunk", "wkv6_split_ref"]
