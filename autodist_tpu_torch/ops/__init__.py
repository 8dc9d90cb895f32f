"""Fused and sharding-aware operators: the flash attention of the
training path and the touched-rows embedding sync.

Counterpart of ``autodist_tpu/ops``.
"""
from autodist_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_with_lse,
                                                    is_flash_attention_fn,
                                                    make_attention_fn)
from autodist_tpu_torch.ops.sparse import ShardedEmbedding, embedding_lookup

__all__ = ["flash_attention", "flash_attention_with_lse",
           "make_attention_fn", "is_flash_attention_fn", "ShardedEmbedding",
           "embedding_lookup"]
