"""A sharding-aware embedding layer.

Counterpart of ``autodist_tpu/models/embedding.py``: the same parameter
name and shape as :class:`~autodist_tpu_torch.models.transformer.Embed`
(``embedding [num_embeddings, features]``), its lookups routed through
:func:`~autodist_tpu_torch.ops.sparse.embedding_lookup`, so that under
a vocab-sharded strategy (``Parallax``, ``PartitionedPS``) the table
arrives as a :class:`~autodist_tpu_torch.ops.sparse.ShardedEmbedding`
and only touched rows cross the wire.  A plain ``F.embedding`` on such a
table works too, through the dense decay.
"""
from __future__ import annotations

import torch
from torch import nn

from autodist_tpu_torch.models.transformer import normal
from autodist_tpu_torch.ops.sparse import embedding_lookup


class SparseEmbed(nn.Module):
    """Embedding lookup with touched-rows-only synchronization.  The
    table is cast to ``dtype`` (when given) before the lookup, so rows
    move at compute precision."""

    def __init__(self, num_embeddings: int, features: int, generator, *,
                 dtype=None, param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(normal(
            (num_embeddings, features), 1.0 / features ** 0.5,
            generator).to(param_dtype))

    def forward(self, ids):
        table = self.embedding
        if self.dtype is not None:
            table = table.to(self.dtype)
        return embedding_lookup(table, ids)
