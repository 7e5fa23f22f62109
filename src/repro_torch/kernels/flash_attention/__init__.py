from .ops import FlashAttentionFn, flash_attention, flash_attention_backward
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_backward",
           "attention_ref", "attention_lse_ref", "attention_bwd_ref"]
