"""Touched-rows-only synchronization for vocab-sharded embeddings.

Counterpart of ``autodist_tpu/ops/sparse.py``.  Under a strategy that
stores an embedding table split along its rows over the data axis
(``Parallax``, ``PartitionedPS`` on an ``is_sparse`` variable), the
lowering hands the loss a :class:`ShardedEmbedding` in place of the
gathered table, and a row lookup moves only what the batch touches:

* forward: the ids are all-gathered (small), each rank answers the ids
  its row block owns (zeros elsewhere), and a reduce-scatter returns to
  each rank exactly the rows of its own ids;
* backward: the (ids, row gradients) pairs are all-gathered and each
  rank scatter-adds the entries it owns into its block (duplicates and
  hot rows accumulate).

A row lookup is :func:`embedding_lookup` or ``table[ids]`` with integer
ids.  Any other torch op on the wrapper sees the gathered table (the
dense decay, which ``__jax_array__`` gives the JAX package): the
wrapper is a tensor subclass of the logical shape whose
``__torch_function__`` replaces it by :meth:`ShardedEmbedding.to_full`,
a differentiable all-gather, so a model built on ``nn.Module``s and
``torch.func.functional_call`` (BERT's ``F.embedding`` and tied decode)
trains as it would on the full table and pays the dense price, as the
JAX BERT's ``nn.Embed`` does.  ``.to(dtype)`` keeps the wrapper (JAX's
``astype``), and one wrapper gathers at most once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from autodist_tpu_torch.kernel import common

# Tensor properties that yield data (a dense use); every other property
# read (shape, dtype, device, requires_grad, ...) is metadata.
_DATA_PROPERTIES = frozenset(("T", "mT", "H", "mH", "real", "imag", "data"))


def _local_hits(shard, gids, index: int):
    """Rows of ``shard`` for the global ids it owns, zeros elsewhere;
    the local row index of every id and whether this block owns it."""
    rows_per_shard = shard.shape[0]
    local = gids.long() - index * rows_per_shard
    ok = (local >= 0) & (local < rows_per_shard)
    idx = local.clamp(0, rows_per_shard - 1)
    rows = shard.index_select(0, idx)
    return torch.where(ok[:, None], rows, torch.zeros_like(rows)), idx, ok


class _CollectiveLookup(torch.autograd.Function):
    """Rows of a row-sharded table for this rank's ids; backward: the
    touched rows' gradients scatter-added into each owner's block."""

    @staticmethod
    def forward(ctx, shard, ids, axis):
        ctx.axis, ctx.rows = axis, shard.shape[0]
        ctx.save_for_backward(ids)
        flat = ids.reshape(-1)
        gids = axis.all_gather(flat)                           # [n B]
        rows, _, _ = _local_hits(shard, gids, axis.index)     # [n B, D]
        mine = axis.psum_scatter(rows.reshape(-1))             # [B D]
        return mine.view(*ids.shape, shard.shape[1])

    @staticmethod
    def backward(ctx, g):
        axis, rows_per_shard = ctx.axis, ctx.rows
        (ids,) = ctx.saved_tensors
        d = g.shape[-1]
        gids = axis.all_gather(ids.reshape(-1))
        grows = axis.all_gather(g.reshape(-1, d).contiguous())
        local = gids.long() - axis.index * rows_per_shard
        ok = (local >= 0) & (local < rows_per_shard)
        contrib = torch.where(ok[:, None], grows, torch.zeros_like(grows))
        d_shard = torch.zeros((rows_per_shard, d), dtype=g.dtype,
                              device=g.device)
        d_shard.index_add_(0, local.clamp(0, rows_per_shard - 1), contrib)
        return d_shard, None, None


class ShardedEmbedding(torch.Tensor):
    """A row-sharded embedding table as the loss sees it: ``shard`` is
    this rank's contiguous row block of a ``full_rows``-row table
    padded to ``axis.size`` equal blocks, ``axis`` the data axis.  Its
    ``shape`` is the logical table's."""

    @staticmethod
    def __new__(cls, shard, full_rows: int, axis):
        shape = (full_rows,) + tuple(shard.shape[1:])
        out = torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=shard.dtype, device=shard.device)
        out.shard, out.full_rows, out.axis = shard, full_rows, axis
        out._full = None
        return out

    def __init__(self, shard, full_rows: int, axis):
        super().__init__()

    def __repr__(self):
        return (f"ShardedEmbedding(rows={self.full_rows}, shard="
                f"{tuple(self.shard.shape)}, axis={self.axis.name!r})")

    def lookup(self, ids):
        """The rows of ``ids`` (any shape), touched rows only."""
        expect = common.ceil_div(self.full_rows, self.axis.size)
        if self.shard.shape[0] != expect:
            raise ValueError(
                f"shard has {self.shard.shape[0]} rows; a {self.full_rows}"
                f"-row table over {self.axis.size} shards stores {expect} "
                "rows per shard (backward scatter offsets assume this)")
        if self.axis.size == 1:
            return F.embedding(ids.long(), self.shard)
        return _CollectiveLookup.apply(self.shard, ids, self.axis)

    def to_full(self):
        """The dense escape: the all-gathered table (differentiable;
        gathered once a wrapper)."""
        if self._full is None:
            self._full = common.all_gather_axis(self.shard, self.axis, 0,
                                                self.full_rows)
        return self._full

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self = args[0] if args and isinstance(args[0], cls) else None
        if self is not None:
            if func is torch.Tensor.__getitem__ and isinstance(
                    args[1], torch.Tensor) and not args[1].is_floating_point() \
                    and args[1].dtype != torch.bool:
                return self.lookup(args[1])
            if func is torch.Tensor.to:
                with torch._C.DisableTorchFunctionSubclass():
                    shard = self.shard.to(*args[1:], **kwargs)
                return cls(shard, self.full_rows, self.axis)
            if getattr(func, "__name__", "") == "__get__" and getattr(
                    func.__self__, "__name__", "") not in _DATA_PROPERTIES:
                with torch._C.DisableTorchFunctionSubclass():
                    return func(*args, **kwargs)

        def dense(a):
            return a.to_full() if isinstance(a, cls) else a

        args = torch.utils._pytree.tree_map(dense, args)
        kwargs = torch.utils._pytree.tree_map(dense, kwargs)
        return func(*args, **kwargs)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"ShardedEmbedding reached {func} below "
                           f"__torch_function__; it holds no data itself")


def embedding_lookup(table, ids):
    """Rows of ``table`` for ``ids``: touched rows only from a
    :class:`ShardedEmbedding`, a plain gather from a tensor."""
    if isinstance(table, ShardedEmbedding):
        return table.lookup(ids)
    return F.embedding(ids.long(), table)
