"""Ring attention: sequence parallelism over the ``seq`` mesh axis.

Counterpart of ``autodist_tpu/parallel/ring_attention.py``.  q, k and v
are this rank's ``[B, Lc, H, D]`` chunk of the sequence; k and v travel
around the ring one rank a step while each rank accumulates its
queries' attention, so every token attends globally and a rank holds
one chunk of keys at a time.

* :func:`ring_self_attention` computes each step with einsums and an
  online softmax (the JAX function's arithmetic: ``q`` scaled in its
  own dtype, then fp32; masked scores at the float32 minimum; the
  denominator clamped at 1e-30).  It holds ``[B, H, Lc, Lc]`` fp32
  scores a step.
* :func:`ring_flash_attention` runs each step through the flash kernels
  (K1 forward, K2a/K2b backward, :func:`~autodist_tpu_torch.ops
  .flash_attention.flash_attention_with_lse`) and merges the chunks by
  logsumexp in fp32.  Under causal masking a step is full (the keys'
  owner is before this rank), the causal triangle (the diagonal) or
  skipped (the owner is after it); the rank index is known to the host,
  so Python picks the branch.

k and v rotate as one stacked ``[2, B, Lc, H, D]`` tensor through
:func:`~autodist_tpu_torch.parallel.axis.ring_shift`, ``p - 1`` shifts a
call (JAX's last rotation is dead).  That keeps one chain of shifts, the
same on every rank, so the backward's exchanges pair up across ranks
whatever the branches; a skipped step hands its keys a zero gradient,
so every shift of the chain lies on the backward's path, as every
branch of JAX's ``lax.switch`` does.

The functions find the ring through the axis name that the sequence
lowering binds (:func:`~autodist_tpu_torch.parallel.axis.bound_axis`).
"""
from __future__ import annotations

from typing import Optional

import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.kernel import NEG_INF
from autodist_tpu_torch.ops.flash_attention import flash_attention_with_lse
from autodist_tpu_torch.parallel.axis import (axis_scope, bound_axis,
                                              ring_shift)


def _online_block_update(o, m, l, scores, v_blk):
    """Flash-style accumulation of one key block.

    ``o`` ``[B, Lq, H, D]`` the running unnormalized output, ``m`` and
    ``l`` ``[B, H, Lq]`` the running max and denominator, ``scores``
    ``[B, H, Lq, Lk]`` fp32."""
    new_m = torch.maximum(m, scores.amax(-1))
    correction = torch.exp(m - new_m)
    p = torch.exp(scores - new_m[..., None])
    new_l = l * correction + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
    new_o = o * correction.transpose(1, 2)[..., None] + pv
    return new_o, new_m, new_l


def _ring(k, v, axis):
    """The key/value blocks a rank sees, step by step: ``(src, kv)``
    with ``kv`` the stacked ``[2, B, Lc, H, D]`` block that rank
    ``src`` owns (``p - 1`` shifts in all)."""
    p, my = axis.size, axis.index
    kv = torch.stack([k, v])
    for step in range(p):
        if step:
            kv = ring_shift(kv, axis)
        yield (my - step) % p, kv


def ring_self_attention(q, k, v, *, axis_name: str = const.SEQ_AXIS,
                        causal: bool = False,
                        scale: Optional[float] = None):
    """Ring attention over sequence chunks, with einsums.

    ``q``/``k``/``v``: this rank's ``[B, Lc, H, D]`` chunk; ``causal``
    masks by global position.  Returns ``[B, Lc, H, D]`` in ``q``'s
    dtype."""
    axis = bound_axis(axis_name)
    B, Lc, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    qf = (q * scale).float()
    dev = q.device
    q_pos = axis.index * Lc + torch.arange(Lc, device=dev)
    o = torch.zeros((B, Lc, H, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Lc), float("-inf"), device=dev)
    l = torch.zeros((B, H, Lc), dtype=torch.float32, device=dev)
    for src, kv in _ring(k, v, axis):
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kv[0].float())
        if causal:
            kv_pos = src * Lc + torch.arange(Lc, device=dev)
            scores = torch.where(q_pos[:, None] >= kv_pos[None, :], scores,
                                 NEG_INF)
        o, m, l = _online_block_update(o, m, l, scores, kv[1])
    norm = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return (o / norm).to(q.dtype)


def _merge_chunks(o_a, lse_a, o_b, lse_b):
    """Two normalized attention partials combined exactly: each weighted
    by ``exp(lse - lse_merged)``.  A ``NEG_INF`` lse (an empty chunk)
    weighs 0 once a real chunk has arrived."""
    m = torch.maximum(lse_a, lse_b)
    w_a = torch.exp(lse_a - m)
    w_b = torch.exp(lse_b - m)
    denom = w_a + w_b
    o = (o_a * w_a[..., None] + o_b * w_b[..., None]) / denom[..., None]
    return o, m + torch.log(denom)


class _SkipChunk(torch.autograd.Function):
    """A skipped step's partial, ``(0, NEG_INF)`` in fp32, with a zero
    gradient for the key/value block it did not read (the skip branch
    of JAX's ``lax.switch``)."""

    @staticmethod
    def forward(ctx, kv):
        ctx.set_materialize_grads(False)
        ctx.meta = (kv.shape, kv.dtype, kv.device)
        _, B, Lc, H, D = kv.shape
        return (kv.new_zeros((B, Lc, H, D), dtype=torch.float32),
                kv.new_full((B, Lc, H), NEG_INF, dtype=torch.float32))

    @staticmethod
    def backward(ctx, g_o, g_lse):
        shape, dtype, device = ctx.meta
        return torch.zeros(shape, dtype=dtype, device=device)


def ring_flash_attention(q, k, v, *, axis_name: str = const.SEQ_AXIS,
                         causal: bool = False,
                         scale: Optional[float] = None):
    """Ring attention with the flash kernels as the per-chunk compute:
    never materializes ``[Lc, Lc]`` scores.  Arguments and result as
    :func:`ring_self_attention`."""
    axis = bound_axis(axis_name)
    B, Lc, H, D = q.shape
    my = axis.index
    q = q.contiguous()          # the kernels take q, k, v of one layout
    o = q.new_zeros((B, Lc, H, D), dtype=torch.float32)
    lse = q.new_full((B, Lc, H), NEG_INF, dtype=torch.float32)
    for src, kv in _ring(k, v, axis):
        if causal and src > my:
            o_c, lse_c = _SkipChunk.apply(kv)
        else:
            o_c, lse_c = flash_attention_with_lse(
                q, kv[0], kv[1], causal=causal and src == my, scale=scale)
        o, lse = _merge_chunks(o, lse, o_c.float(), lse_c)
    return o.to(q.dtype)


def make_ring_attention_fn(*, seq_axis: str = const.SEQ_AXIS,
                           causal: bool = False):
    """A ``TransformerConfig.attention_fn`` running
    :func:`ring_self_attention` over ``seq_axis`` (the model's mask is
    ignored: causality comes from global positions)."""

    def attention_fn(q, k, v, mask, dropout_rng):
        del mask, dropout_rng
        return ring_self_attention(q, k, v, axis_name=seq_axis,
                                   causal=causal)

    return attention_fn


def make_ring_flash_attention_fn(*, seq_axis: str = const.SEQ_AXIS,
                                 causal: bool = False):
    """Like :func:`make_ring_attention_fn` with the flash kernels per
    chunk: the long-chunk configuration."""

    def attention_fn(q, k, v, mask, dropout_rng):
        del mask, dropout_rng
        return ring_flash_attention(q, k, v, axis_name=seq_axis,
                                    causal=causal)

    return attention_fn


class _GatherChunks(torch.autograd.Function):
    """This rank's chunk all-gathered along ``dim``; backward, the
    rank's slice of the (replicated) global cotangent."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return axis.all_gather(x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


def sequence_sharded_attention(q, k, v, axis, *, causal: bool = False,
                               flash: bool = False):
    """Host-level entry: every rank of ``axis`` (the seq
    :class:`~autodist_tpu_torch.parallel.axis.Axis`) passes the same
    global ``[B, L, H, D]`` tensors, runs the ring on its chunk of dim 1
    and gets the global output back.  Differentiable: a rank's inputs
    receive the gradient of its own chunks (sum the ranks' gradients for
    the global one).  ``flash=True`` runs the flash kernels per chunk."""
    L = q.shape[1]
    if L % axis.size:
        raise ValueError(f"sequence length {L} does not divide by the "
                         f"{axis.size}-way {axis.name!r} axis")
    n = L // axis.size
    q, k, v = (t.narrow(1, axis.index * n, n) for t in (q, k, v))
    ring = ring_flash_attention if flash else ring_self_attention
    with axis_scope({axis.name: axis}):
        out = ring(q, k, v, axis_name=axis.name, causal=causal)
    return _GatherChunks.apply(out, axis, 1)
