"""The transformer configuration and its plain attention.

Counterpart of ``autodist_tpu/models/transformer.py``: the same
:class:`TransformerConfig` fields and defaults (``dtype`` is a torch
dtype), and the einsum attention the single-shot prefill runs.  The
flax modules (``EncoderLayer``, ``TransformerLM``) belong to the
training slice and are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from autodist_tpu_torch.kernel import NEG_INF


@dataclasses.dataclass(unsafe_hash=True)
class TransformerConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    attention_dropout_rate: float = 0.1
    dtype: Any = torch.bfloat16
    remat: bool = False
    attention_fn: Optional[Callable] = None  # (q, k, v, mask, dropout_rng) -> out
    position_fn: Optional[Callable] = None
    causal: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def dot_product_attention(q, k, v, mask, *, dropout_rate=0.0,
                          dropout_rng=None, dtype=torch.bfloat16):
    """Plain einsum attention (softmax in fp32 for stability).

    ``q``/``k``/``v``: ``[..., L, heads, head_dim]``; ``mask``
    broadcastable to ``[..., heads, Lq, Lk]`` (True = visible).  Masked
    scores take the finite float32 minimum, as in the JAX package.
    """
    if dropout_rate > 0.0 and dropout_rng is not None:
        raise NotImplementedError(
            "attention dropout belongs to the training path (ROADMAP "
            "Queue 1, slice 2), not ported yet")
    depth = q.shape[-1]
    scores = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(depth)
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("...hqk,...khd->...qhd", probs, v.to(dtype))
