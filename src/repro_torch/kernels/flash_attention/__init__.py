from .kernel import (
    HEAD_DIMS, ROUTES, flash_attention, flash_attention_bwd, flash_route, split_plan,
)
from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["HEAD_DIMS", "ROUTES", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_ref", "flash_route", "split_plan"]
