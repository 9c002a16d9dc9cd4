from .kernel import (
    BWD_ROUTES, HEAD_DIMS, MMA_CHUNK, ROUTES, SPLIT_MIN_T, bwd_chunk, bwd_route, split_chunk, wkv6,
    wkv6_bwd, wkv6_route,
)
from .ref import wkv6_bwd_mma_ref, wkv6_bwd_ref, wkv6_bwd_split_ref, wkv6_ref, wkv6_split_ref

__all__ = ["BWD_ROUTES", "HEAD_DIMS", "MMA_CHUNK", "ROUTES", "SPLIT_MIN_T", "bwd_chunk",
           "bwd_route", "split_chunk", "wkv6", "wkv6_bwd", "wkv6_bwd_mma_ref", "wkv6_bwd_ref",
           "wkv6_bwd_split_ref", "wkv6_ref", "wkv6_route", "wkv6_split_ref"]
