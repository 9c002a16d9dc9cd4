from .kernel import STATE_DIMS, ssm_scan
from .ref import ssm_scan_ref

__all__ = ["STATE_DIMS", "ssm_scan", "ssm_scan_ref"]
