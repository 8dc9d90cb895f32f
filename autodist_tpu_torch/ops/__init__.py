"""Fused operators: the flash attention of the training path.

Counterpart of ``autodist_tpu/ops``; only the flash attention is ported
(the sparse embedding sync belongs to ROADMAP Queue 1, item 8).
"""
from autodist_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_with_lse,
                                                    is_flash_attention_fn,
                                                    make_attention_fn)

__all__ = ["flash_attention", "flash_attention_with_lse",
           "make_attention_fn", "is_flash_attention_fn"]
