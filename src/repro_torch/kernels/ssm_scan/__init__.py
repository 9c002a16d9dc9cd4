from .kernel import (
    BWD_CHUNK, BWD_ROUTES, REGS_CHANNELS, ROUTES, SPLIT_MIN_T, STATE_DIMS, split_chunk,
    ssm_scan, ssm_scan_bwd, ssm_scan_route,
)
from .ref import ssm_scan_bwd_ref, ssm_scan_bwd_split_ref, ssm_scan_ref, ssm_scan_split_ref

__all__ = ["BWD_CHUNK", "BWD_ROUTES", "REGS_CHANNELS", "ROUTES", "SPLIT_MIN_T", "STATE_DIMS",
           "split_chunk", "ssm_scan", "ssm_scan_bwd", "ssm_scan_bwd_ref", "ssm_scan_bwd_split_ref",
           "ssm_scan_ref", "ssm_scan_route", "ssm_scan_split_ref"]
