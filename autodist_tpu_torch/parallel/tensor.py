"""Megatron matmul boundaries and the vocab epilogue, at tensor parallel 1.

Counterpart of ``autodist_tpu/parallel/tensor.py`` for the
``model_axis=None`` branch only: with one shard every collective is the
identity, so each function is the plain unsharded math.  A
``model_axis`` raises ``NotImplementedError`` until the tensor-parallel
slice ports the collectives (ROADMAP Queue 1, slice 3).
"""
from __future__ import annotations

import torch

from autodist_tpu_torch.kernel import NEG_INF


def _tp1_only(model_axis, comm_overlap=None):
    if model_axis is not None or comm_overlap:
        raise NotImplementedError(
            "tensor-parallel collectives (model_axis / comm_overlap) are "
            "not ported yet (ROADMAP Queue 1, slice 3: tensor and "
            "pipeline parallel on multiple GPUs)")


def column_parallel(x, kernel, bias=None, *, model_axis=None, axes: int = 1,
                    comm_overlap=None):
    """``x @ kernel (+ bias)``: ``axes`` contraction dims from the end of
    ``x`` and the front of ``kernel`` (tensordot semantics)."""
    _tp1_only(model_axis, comm_overlap)
    y = torch.tensordot(x, kernel, dims=axes)
    return y + bias if bias is not None else y


def row_parallel(x, kernel, bias=None, *, model_axis=None, axes: int = 1,
                 comm_overlap=None):
    """``x @ kernel (+ bias)`` — at tp=1 the same product as
    :func:`column_parallel` (the row split only moves the psum)."""
    _tp1_only(model_axis, comm_overlap)
    y = torch.tensordot(x, kernel, dims=axes)
    return y + bias if bias is not None else y


def vocab_parallel_embedding(tokens, embedding, *, model_axis=None,
                             comm_overlap=None):
    """Token lookup on the (unsharded) embedding table.  Ids outside the
    table clamp to its edge rows, as JAX indexing does."""
    _tp1_only(model_axis, comm_overlap)
    return embedding[tokens.long().clamp(0, embedding.shape[0] - 1)]


def vocab_parallel_greedy_token(x, embedding, *, vocab_size: int,
                                model_axis=None):
    """Greedy next-token ids from last-position hidden states ``[B, H]``
    against the tied unembedding ``[V, H]``.  Logits are fp32 against
    the fp32 table whatever the model dtype; ties keep the smallest id.
    Returns ``(token [B] int32, max logit [B] fp32)``."""
    _tp1_only(model_axis)
    rows = embedding.shape[0]
    logits = x.float() @ embedding.float().T
    valid = torch.arange(rows, device=logits.device) < vocab_size
    logits = torch.where(valid, logits, NEG_INF)
    return _resolve_global_argmax(logits, 0, vocab_size, model_axis)


def _resolve_global_argmax(scores, start, vocab_size: int, model_axis):
    """The argmax election of the JAX package at one shard: the local
    argmax (first, i.e. smallest, id among equal maxima) wins unless its
    score fails ``>= max`` — which happens only for a NaN row, whose
    token becomes ``vocab_size`` exactly as in the JAX package."""
    _tp1_only(model_axis)
    m = scores.max(dim=-1).values
    am = (start + scores.argmax(dim=-1)).to(torch.int32)
    tok = torch.where(m >= m, am, torch.full_like(am, vocab_size))
    return tok, m
