"""KV cache for batched decode: dense lanes and a block-paged pool.

Counterpart of ``autodist_tpu/serving/kv_cache.py``.  **Dense**: one
pair of tensors holds every layer's keys and values, ``[layer, slot,
heads, max_len, head_dim]``.  **Paged**: a pool ``[layer, num_blocks,
heads, block_len, head_dim]`` with a per-slot block table ``[num_slots, max_blocks]`` mapping logical block ``j`` of a
slot's sequence to a pool block, and a host-side refcounted
:class:`BlockAllocator` (prefix caching shares blocks between slots,
keyed by :func:`prefix_block_keys`, and copies one before a write with
:func:`copy_pool_block`); logical position ``p`` of slot ``s`` lives at
``(block_table[s, p // block_len], p % block_len)``.  In both layouts
``k[layer]`` is contiguous, which the kernels need.

JAX arrays are immutable, and the JAX engine donates the cache so XLA
aliases its updates.  Here the writers update the cache tensor **in
place** (and return it, so call sites read like the JAX ones).  The
per-slot Python loops of the JAX writers become one advanced-index
write each, with the JAX semantics kept exactly, including at the
edges where JAX clamps rather than raises:

* a dense write at ``pos >= T`` lands at ``T - 1``
  (``lax.dynamic_update_slice`` clamps its start);
* a paged logical block ``pos // block_len >= max_blocks`` reads the
  table row's last column (the jnp gather clamps) — the slot's own
  tail block, which the engine tail-fills;
* a row whose write is masked off (``write_mask``, ``admit``, the
  ``lo < p_lens`` block rule) leaves its target bit for
  bit, and where two rows of one call hit one target the later wins,
  as in the JAX writers' sequential loop.

Reads are always masked to ``pos <= length``, so stale rows of a
previous occupant are never observable.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
from typing import Any

import numpy as np
import torch

from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel import NEG_INF
from autodist_tpu_torch.kernel.flash_decode import gather_lanes


@dataclasses.dataclass
class KVCache:
    """Dense decode state.  ``k``/``v``: ``[L, B, heads, T, head_dim]``;
    ``lengths``: ``[B]`` int32 — tokens materialized per slot (the next
    write position)."""

    k: Any
    v: Any
    lengths: Any


def init_cache(num_layers: int, num_slots: int, num_heads: int,
               head_dim: int, max_len: int, dtype=torch.float32,
               device=None) -> KVCache:
    """All-zero cache with every slot empty, on ``device`` (``None``:
    the card)."""
    dev = resolve_device(device)
    shape = (num_layers, num_slots, num_heads, max_len, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   lengths=torch.zeros(num_slots, dtype=torch.int32,
                                       device=dev))


def write_token(cache_arr, layer: int, kv, positions):
    """Write one decode step's projections ``kv [B, 1, heads, d]`` in
    place: slot ``i``'s row lands at ``[layer, i, :, positions[i], :]``,
    clamped to the last lane position."""
    B, T = kv.shape[0], cache_arr.shape[3]
    slots = torch.arange(B, device=cache_arr.device)
    pos = positions.long().clamp(0, T - 1)
    cache_arr[layer, slots, :, pos, :] = kv[:, 0].to(cache_arr.dtype)
    return cache_arr


def write_prompt(cache_arr, layer: int, kv, admit):
    """Write a prefill's whole prompt bucket ``kv [B, S, heads, d]`` in
    place at ``[layer, i, :, 0:S, :]`` for admitted slots; the other
    slots' rows are kept bit for bit."""
    S = kv.shape[1]
    new = kv.transpose(1, 2).to(cache_arr.dtype)         # [B, H, S, d]
    cur = cache_arr[layer, :, :, :S]
    cache_arr[layer, :, :, :S] = torch.where(
        admit.bool()[:, None, None, None], new, cur)
    return cache_arr


def cached_attention(q, k_layer, v_layer, lengths, *, dtype=torch.float32):
    """The composed decode attention of the JAX package: ``q [B, 1,
    heads, d]`` over ``[B, heads, T, d]`` lanes, keys ``<= lengths``
    visible, fp32 softmax whose probabilities are cast to ``dtype``
    before the value product.  The flash kernels differ from it at bf16
    exactly there; this function is kept as the JAX golden's
    counterpart, the engine does not call it."""
    T = k_layer.shape[2]
    ok = (torch.arange(T, device=q.device)[None, None, None, :]
          <= lengths.long()[:, None, None, None])
    return _composed(q, k_layer, v_layer, ok, dtype)


def chunk_attention(q, k_layer, v_layer, starts, *, dtype=torch.float32):
    """The composed causal window attention: row ``r`` of slot ``i``
    (``q [B, C, heads, d]``) sees cached keys at positions ``<=
    starts[i] + r`` of ``[B, heads, T, d]`` lanes."""
    C, T = q.shape[1], k_layer.shape[2]
    rows = starts.long()[:, None] + torch.arange(C, device=q.device)
    ok = (torch.arange(T, device=q.device)[None, None, None, :]
          <= rows[:, None, :, None])
    return _composed(q, k_layer, v_layer, ok, dtype)


def _composed(q, k_layer, v_layer, ok, dtype):
    q2 = q.transpose(1, 2)                               # [B, H, C, d]
    scores = (q2 @ k_layer.to(q.dtype).transpose(-1, -2)) \
        / math.sqrt(q.shape[-1])
    scores = torch.where(ok, scores.float(), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return (probs @ v_layer.to(dtype)).transpose(1, 2)   # [B, C, H, d]


# --------------------------------------------------------------------------- #
# Block-paged cache
# --------------------------------------------------------------------------- #
class PoolExhaustedError(RuntimeError):
    """The block pool cannot satisfy an allocation: the request must
    wait in the admission queue instead of corrupting another slot's
    blocks."""

    code = "serve/kv_pool_exhausted"


class BlockAllocator:
    """Host-side refcounted free list over the pool's ``num_blocks`` ids
    (pure accounting, no device traffic), the JAX package's allocator.

    ``free_blocks + used_blocks == num_blocks`` always, ``used_blocks``
    counting physical blocks with a reference.  Prefix caching shares a
    block between slots by taking another reference (:meth:`share`); a
    block returns to the free list when its last reference drops
    (:meth:`free_one`).  Double-frees and foreign ids raise.

    Every alloc, share and free is appended to :attr:`events`, and the
    engine notes the ``write`` and ``cow`` events of what it dispatches
    (:meth:`note`): the trace the JAX package's ``lint_block_trace``
    replays to show that no shared block is written through a table
    entry without a copy first."""

    #: the trace is bounded, so a long-lived server cannot grow it
    #: without bound.
    TRACE_LIMIT = 1 << 18

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        self.num_blocks = int(num_blocks)
        # LIFO free list: deterministic reuse order, the JAX package's.
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._rc: dict = {}
        self.events = collections.deque(maxlen=self.TRACE_LIMIT)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._rc)

    def refcount(self, block: int) -> int:
        return self._rc.get(block, 0)

    def note(self, *event) -> None:
        """Append an event the engine observed (``write``, ``cow``)."""
        self.events.append(tuple(event))

    def alloc(self, n: int) -> list:
        if n < 0:
            raise ValueError("alloc count must be >= 0")
        if n > len(self._free):
            raise PoolExhaustedError(
                f"[{PoolExhaustedError.code}] {n} block(s) requested, "
                f"{len(self._free)} free of {self.num_blocks} — the "
                "admission predicate must gate on free blocks")
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._rc[b] = 1
            self.events.append(("alloc", b))
        return blocks

    def share(self, block: int) -> int:
        """Take one more reference on an allocated block (a prefix
        hit)."""
        if block not in self._rc:
            raise ValueError(f"block {block} is not allocated — cannot "
                             "share a free block")
        self._rc[block] += 1
        self.events.append(("share", block))
        return block

    def free(self, blocks) -> list:
        """Drop one reference per listed block; returns the blocks whose
        last reference dropped (now free again)."""
        return [b for b in blocks if self.free_one(b)]

    def free_one(self, block: int) -> bool:
        """Drop one reference; True iff the block is free again."""
        if block not in self._rc:
            raise ValueError(
                f"block {block} is not allocated (double-free or foreign "
                "id)")
        self.events.append(("free", block))
        self._rc[block] -= 1
        if self._rc[block] == 0:
            del self._rc[block]
            self._free.append(block)
            return True
        return False


def blocks_for(tokens: int, block_len: int) -> int:
    """Pool blocks covering ``tokens`` logical positions."""
    return -(-max(int(tokens), 0) // int(block_len))


def prefix_block_keys(prompt, block_len: int):
    """Content keys of a prompt's blocks, chained so that a key commits
    to the whole prefix through its block: ``(full_keys, partial_key)``,
    one ``("full", sha1)`` a full block and ``("partial", n, sha1)`` for
    a trailing partial block of ``n`` tokens (``None`` when the prompt
    fills its last block).  The JAX package's keys: the sha1 chain over
    the int64 token bytes from the seed ``b"adt-prefix"``."""
    toks = np.asarray(prompt, dtype=np.int64)
    bl = int(block_len)
    n_full = len(toks) // bl
    full_keys, h = [], hashlib.sha1(b"adt-prefix")
    for j in range(n_full):
        h.update(toks[j * bl:(j + 1) * bl].tobytes())
        full_keys.append(("full", h.hexdigest()))
    partial_key = None
    tail = toks[n_full * bl:]
    if len(tail):
        h.update(tail.tobytes())
        partial_key = ("partial", len(tail), h.hexdigest())
    return full_keys, partial_key


def copy_pool_block(k_pool, v_pool, src: int, dst: int):
    """Copy pool block ``src`` into ``dst`` in every layer's k and v
    pools, in place (the copy-on-write data move: the writer's table row
    turns to ``dst``, the other holders keep reading ``src``)."""
    k_pool[:, dst].copy_(k_pool[:, src])
    v_pool[:, dst].copy_(v_pool[:, src])
    return k_pool, v_pool


@dataclasses.dataclass
class PagedKVCache:
    """Paged decode state.  ``k``/``v``: ``[L, num_blocks, heads,
    block_len, head_dim]``; ``lengths``: ``[num_slots]`` int32;
    ``block_table``: ``[num_slots, max_blocks]`` int32 (unassigned
    entries hold 0 and are never read unmasked)."""

    k: Any
    v: Any
    lengths: Any
    block_table: Any


def init_paged_cache(num_layers: int, num_slots: int, num_heads: int,
                     head_dim: int, max_len: int, *, block_len: int,
                     num_blocks: int, dtype=torch.float32,
                     device=None) -> PagedKVCache:
    """All-zero pool with every slot empty and no block mapped."""
    if block_len < 1:
        raise ValueError("block_len must be >= 1")
    max_blocks = blocks_for(max_len, block_len)
    if num_blocks < max_blocks:
        raise ValueError(
            f"num_blocks={num_blocks} cannot hold even one full-length "
            f"request ({max_blocks} blocks of {block_len} for "
            f"max_len={max_len})")
    dev = resolve_device(device)
    shape = (num_layers, num_blocks, num_heads, block_len, head_dim)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        lengths=torch.zeros(num_slots, dtype=torch.int32, device=dev),
        block_table=torch.zeros((num_slots, max_blocks), dtype=torch.int32,
                                device=dev))


def _write_rows(cache_arr, layer: int, blk, off, rows, take):
    """``cache_arr[layer, blk[i], :, off[i], :] = rows[i]`` for every
    ``i`` with ``take[i]``, in place and without a host sync.

    Sequential semantics of the JAX writers: where several taken rows
    hit one target the last one wins.  An index write with duplicate
    targets has no defined order, so the later duplicates are resolved
    first, and each row not taken is redirected onto the first taken
    row's target carrying that row's value — identical duplicate
    writes.  With no row taken, every row rewrites the current value of
    row 0's target."""
    n = blk.shape[0]
    tid = blk * cache_arr.shape[3] + off
    idx = torch.arange(n, device=blk.device)
    shadowed = ((tid[None, :] == tid[:, None]) & (idx[None, :] > idx[:, None])
                & take[None, :]).any(1)
    take = take & ~shadowed
    rows = rows.to(cache_arr.dtype)
    # First taken row, else 0.  A 1-element index, not a 0-d one: PyTorch
    # turns a 0-d index tensor into a Python int, a host sync per write.
    first = take.int().argmax().reshape(1)
    fill = torch.where(take.any(), rows[first],
                       cache_arr[layer, blk[first], :, off[first], :])
    cache_arr[layer, torch.where(take, blk, blk[first]), :,
              torch.where(take, off, off[first]), :] = \
        torch.where(take[:, None, None], rows, fill)
    return cache_arr


def paged_write_token(cache_arr, layer: int, kv, positions, block_table,
                      block_len: int, write_mask=None):
    """The paged :func:`write_token`: slot ``i``'s row ``kv[i, 0]``
    lands in pool block ``block_table[i, positions[i] // block_len]``
    (column clamped to the table's extent) at offset ``positions[i] %
    block_len``.  Slots where ``write_mask`` is False keep the target
    row bit for bit — an unreserved slot's zeroed table row points at
    block 0, which may be another slot's live block."""
    B, mb = kv.shape[0], block_table.shape[1]
    pos = positions.long()
    col = (pos // block_len).clamp(0, mb - 1)
    slots = torch.arange(B, device=kv.device)
    blk = block_table[slots, col].long()
    take = (torch.ones(B, dtype=torch.bool, device=kv.device)
            if write_mask is None else write_mask.bool())
    return _write_rows(cache_arr, layer, blk, pos % block_len, kv[:, 0],
                       take)


def _write_block_rows(cache_arr, layer, kv, admit, block_table, block_len,
                      first_pos, p_lens, write_from=None):
    """Rows ``first_pos + p`` of ``kv [B, S, heads, d]`` through the
    table, block-granular: a logical block ``j`` is written whole when
    the slot is admitted, its first position lies below ``p_lens`` and
    ``j >= write_from`` (where given); otherwise it is left untouched.
    ``first_pos`` is an int or a device scalar."""
    B, S = kv.shape[:2]
    mb = block_table.shape[1]
    r = torch.arange(S, device=kv.device)
    j = first_pos // block_len + r // block_len         # logical block [S]
    lo = first_pos + (r // block_len) * block_len       # its first position
    blk = block_table[:, j.clamp(0, mb - 1)].long()    # [B, S]
    take = admit.bool()[:, None] & (lo[None, :] < p_lens.long()[:, None])
    if write_from is not None:
        take = take & (j[None, :] >= write_from.long()[:, None])
    return _write_rows(cache_arr, layer, blk.reshape(-1),
                       (r % block_len).repeat(B),
                       kv.reshape(B * S, *kv.shape[2:]), take.reshape(-1))


def paged_write_prompt(cache_arr, layer: int, kv, admit, block_table,
                       block_len: int, p_lens, write_from=None):
    """The paged :func:`write_prompt`: an admitted slot's prompt bucket
    ``kv [B, S, heads, d]`` lands block by block through the table.  A
    logical block holding no real prompt row (``j * block_len >=
    p_lens[i]``) is left untouched; the final partial prompt block is
    written whole, its tail taking the bucket's padding projections
    (unreachable behind the length mask).  ``write_from`` (``[B]``
    int32, optional) skips logical blocks ``j < write_from[i]``: prefix
    hits, whose shared blocks already hold these projections."""
    return _write_block_rows(cache_arr, layer, kv, admit, block_table,
                             block_len, 0, p_lens, write_from)


def paged_write_chunk(cache_arr, layer: int, kv, admit, block_table,
                      block_len: int, chunk_start, p_lens, write_from=None):
    """The chunked :func:`paged_write_prompt`: one prompt chunk ``kv [B,
    C, heads, d]`` (``C % block_len == 0``) at positions ``chunk_start +
    r`` (``chunk_start`` an int or a device scalar, as JAX traces it),
    under the same block rules."""
    if kv.shape[1] % block_len:
        raise ValueError(f"chunk of {kv.shape[1]} rows is not a multiple "
                         f"of block_len={block_len}")
    return _write_block_rows(cache_arr, layer, kv, admit, block_table,
                             block_len, chunk_start, p_lens, write_from)


def gather_blocks(pool, block_table):
    """Per-slot contiguous lanes ``[B, heads, max_blocks * block_len,
    d]`` from one layer's pool ``[num_blocks, heads, block_len, d]``."""
    return gather_lanes(pool, block_table)


def paged_cached_attention(q, k_pool, v_pool, lengths, block_table, *,
                           block_len: int, dtype=torch.float32):
    """The composed paged decode attention: gather, then
    :func:`cached_attention`."""
    del block_len  # implied by the pool's block extent
    return cached_attention(q, gather_blocks(k_pool, block_table),
                            gather_blocks(v_pool, block_table), lengths,
                            dtype=dtype)


def paged_chunk_attention(q, k_pool, v_pool, starts, block_table, *,
                          block_len: int, dtype=torch.float32):
    """The composed paged chunk attention: gather, then
    :func:`chunk_attention`."""
    del block_len  # implied by the pool's block extent
    return chunk_attention(q, gather_blocks(k_pool, block_table),
                           gather_blocks(v_pool, block_table), starts,
                           dtype=dtype)
