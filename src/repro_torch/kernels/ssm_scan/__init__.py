from .kernel import ROUTES, SPLIT_MIN_T, STATE_DIMS, ssm_scan, ssm_scan_route, split_chunk
from .ref import ssm_scan_ref, ssm_scan_split_ref

__all__ = ["ROUTES", "SPLIT_MIN_T", "STATE_DIMS", "ssm_scan", "ssm_scan_ref",
           "ssm_scan_route", "split_chunk", "ssm_scan_split_ref"]
