from .kernel import HEAD_DIMS, flash_attention
from .ref import flash_attention_ref

__all__ = ["HEAD_DIMS", "flash_attention", "flash_attention_ref"]
