from .kernel import (
    BWD_ROUTES, HEAD_DIMS, ROUTES, bwd_route, bwd_route_forced, flash_attention,
    flash_attention_bwd, flash_route, split_plan,
)
from .ref import (
    flash_attention_bwd_ref, flash_attention_bwd_step_ref, flash_attention_lse_ref,
    flash_attention_ref,
)

__all__ = ["BWD_ROUTES", "HEAD_DIMS", "ROUTES", "bwd_route", "bwd_route_forced", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_ref", "flash_attention_bwd_step_ref",
           "flash_attention_lse_ref",
           "flash_attention_ref", "flash_route", "split_plan"]
