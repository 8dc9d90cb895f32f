"""Megatron tensor-parallel boundaries, their precision and kernel
scopes, and the vocab epilogue at tensor parallel 1.

Counterpart of ``autodist_tpu/parallel/tensor.py``.  A transformer
block splits into a column-parallel matmul (output features sharded over
the model axis) and a row-parallel one (input features sharded), with
one activation all-reduce at the row matmul's output.  The two
boundaries are the pair of autograd functions the JAX package writes as
custom VJPs (Megatron's ``f`` and ``g``):

* :func:`gather_grads` — identity forward, sum over the model axis
  backward (the input of a column-parallel matmul);
* :func:`sum_partials` — sum forward, identity backward (the output of
  a row-parallel matmul).

``model_axis`` is an :class:`~autodist_tpu_torch.parallel.axis.Axis`
(or ``None``: every boundary the identity, the unsharded math).

The reduction each boundary runs follows the active scopes, as in the
JAX package: :func:`precision_scope` sets the ``tp_psum`` wire
precision and :func:`kernel_scope` the kernel election (``quant_ring``
takes the fused int8 ring).  JAX reads the scopes while tracing, so a
custom VJP's backward sees the policy of its forward.  Here the backward
runs later, after the ``with`` block may have closed, so each boundary
picks its reduction when its forward runs and keeps it on the autograd
context; no backward reads a scope.

``comm_overlap="matmul"`` turns the row boundary into the chunked
collective-matmul ring (:mod:`autodist_tpu_torch.kernel
.collective_matmul`; fused with the ``collective_matmul`` kernel) and
the column boundary's backward sum into a reduce-scatter + all-gather
pair at fp32.  ``"rsag"`` and narrowed precisions under overlap are not
ported (ROADMAP Queue 1, slice 3 leftovers); nor is vocab parallelism
(the vocab functions take ``model_axis=None`` only).
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

from autodist_tpu_torch.kernel import NEG_INF
from autodist_tpu_torch.kernel import quantize as qz
from autodist_tpu_torch.kernel.collective_matmul import (
    RingMatmul, collective_matmul_row_fused)
from autodist_tpu_torch.kernel.quant_ring import (ring_gather_grads,
                                                  ring_sum_partials)

_OVERLAP_ITEM = "ROADMAP Queue 1, slice 3 leftovers, item 3"
_VOCAB_ITEM = "ROADMAP Queue 1, slice 3 leftovers, item 2"


# --------------------------------------------------------------------------- #
# Precision and kernel scopes
# --------------------------------------------------------------------------- #
_FP32_SLOTS = {"tp_psum": "fp32", "vocab_stats": "fp32"}
_active_slots = dict(_FP32_SLOTS)
_active_kernels: frozenset = frozenset()


@contextlib.contextmanager
def precision_scope(policy):
    """Activate a per-boundary precision policy (``{"tp_psum": ...,
    "vocab_stats": ...}``; missing slots stay fp32) for the boundaries
    whose forward runs inside the ``with`` body."""
    global _active_slots
    prev = _active_slots
    slots = dict(_FP32_SLOTS)
    for k, v in (policy or {}).items():
        if k in slots:
            slots[k] = qz.check_precision(v, where=k)
    _active_slots = slots
    try:
        yield
    finally:
        _active_slots = prev


def active_precision(slot: str) -> str:
    return _active_slots.get(slot, "fp32")


@contextlib.contextmanager
def kernel_scope(kernel):
    """Activate a kernel election (a ``normalize_kernel`` dict or an
    iterable of kernel names) for the boundaries whose forward runs
    inside the ``with`` body."""
    global _active_kernels
    prev = _active_kernels
    names = kernel.keys() if isinstance(kernel, dict) else (kernel or ())
    _active_kernels = frozenset(names)
    try:
        yield
    finally:
        _active_kernels = prev


def active_kernel(name: str) -> bool:
    return name in _active_kernels


# --------------------------------------------------------------------------- #
# The boundary pair
# --------------------------------------------------------------------------- #
class _SumPartials(torch.autograd.Function):
    """``reduce`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, reduce):
        return reduce(x)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _GatherGrads(torch.autograd.Function):
    """Identity forward, ``reduce`` backward; ``reduce`` was chosen when
    the forward ran and is kept on ``ctx``."""

    @staticmethod
    def forward(ctx, x, reduce):
        ctx.reduce = reduce
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ctx.reduce(ct), None


def gather_grads(x, model_axis):
    """Identity forward / sum over ``model_axis`` backward (Megatron f),
    the backward sum at the ``tp_psum`` precision active now: the fp32
    sum, the composed narrowed sum, or the int8 ring with
    ``quant_ring`` elected."""
    if model_axis is None:
        return x
    prec = active_precision("tp_psum")
    if prec == "int8" and active_kernel("quant_ring"):
        return ring_gather_grads(x, model_axis)
    return _GatherGrads.apply(x, functools.partial(
        qz.quantized_psum, axis=model_axis, precision=prec))


def sum_partials(x, model_axis):
    """Sum over ``model_axis`` forward / identity backward (Megatron g),
    at the active ``tp_psum`` precision; int8 with ``quant_ring``
    elected takes the fused ring."""
    if model_axis is None:
        return x
    prec = active_precision("tp_psum")
    if prec == "int8" and active_kernel("quant_ring"):
        return ring_sum_partials(x, model_axis)
    return _SumPartials.apply(x, functools.partial(
        qz.quantized_psum, axis=model_axis, precision=prec))


# --------------------------------------------------------------------------- #
# Latency-hiding forms
# --------------------------------------------------------------------------- #
def normalize_comm_overlap(mode):
    """``None``/``False``/"" -> ``None`` (blocking sum), ``True`` ->
    ``"matmul"``; otherwise one of ``"rsag"`` / ``"matmul"``."""
    if mode in (None, False, ""):
        return None
    if mode is True:
        return "matmul"
    if mode in ("rsag", "matmul"):
        return mode
    raise ValueError(
        f"comm_overlap must be one of None/False, True, 'rsag', 'matmul'; "
        f"got {mode!r}")


def psum_decomposed(x, axis):
    """The fp32 sum over ``axis`` as a reduce-scatter + all-gather pair
    over the flat payload, zero-padded to divide the axis size."""
    n = axis.size
    if n == 1:
        return x
    flat = x.reshape(-1)
    size = flat.numel()
    pad = (-size) % n
    if pad:
        flat = F.pad(flat, (0, pad))
    full = axis.all_gather(axis.psum_scatter(flat))
    return full[:size].view(x.shape)


def gather_grads_decomposed(x, model_axis):
    """Identity forward / decomposed (rs + ag) sum backward: the
    ``comm_overlap`` form of :func:`gather_grads`."""
    if model_axis is None:
        return x
    if active_precision("tp_psum") != "fp32":
        raise NotImplementedError(
            f"a {active_precision('tp_psum')} collective precision under "
            f"comm_overlap is not ported yet ({_OVERLAP_ITEM})")
    return _GatherGrads.apply(x, functools.partial(psum_decomposed,
                                                   axis=model_axis))


def collective_matmul_row(x, kernel, model_axis, axes: int = 1):
    """Row-parallel matmul with the output sum as the composed chunked
    ``ppermute`` ring; backward the local tensordot transpose."""
    return RingMatmul.apply(x, kernel, model_axis, axes, False)


# --------------------------------------------------------------------------- #
# The Megatron layers
# --------------------------------------------------------------------------- #
def column_parallel(x, kernel, bias=None, *, model_axis=None, axes: int = 1,
                    comm_overlap=None):
    """``x @ kernel (+ bias)``: ``axes`` contraction dims from the end of
    ``x`` and the front of ``kernel`` (tensordot semantics).  With
    ``model_axis``, ``kernel``/``bias`` are the local output shard and
    the input's backward cotangent sums over the group (decomposed under
    ``comm_overlap``)."""
    overlap = normalize_comm_overlap(comm_overlap)
    if overlap == "rsag":
        raise NotImplementedError(
            f"comm_overlap='rsag' is not ported yet ({_OVERLAP_ITEM})")
    if model_axis is not None:
        x = (gather_grads_decomposed(x, model_axis) if overlap
             else gather_grads(x, model_axis))
    y = torch.tensordot(x, kernel, dims=axes)
    return y + bias if bias is not None else y


def row_parallel(x, kernel, bias=None, *, model_axis=None, axes: int = 1,
                 comm_overlap=None):
    """``x @ kernel (+ bias)`` with the kernel's input dims sharded: the
    partial products sum over the model group (blocking, or the
    collective-matmul ring under ``comm_overlap="matmul"``, fused with
    the ``collective_matmul`` kernel elected), then the replicated bias
    is added."""
    overlap = normalize_comm_overlap(comm_overlap)
    if overlap == "rsag":
        raise NotImplementedError(
            f"comm_overlap='rsag' is not ported yet ({_OVERLAP_ITEM})")
    if model_axis is not None and overlap == "matmul":
        if active_kernel("collective_matmul") and kernel.dim() == axes + 1:
            y = collective_matmul_row_fused(x, kernel, model_axis, axes)
        else:
            y = collective_matmul_row(x, kernel, model_axis, axes)
    else:
        y = sum_partials(torch.tensordot(x, kernel, dims=axes), model_axis)
    return y + bias if bias is not None else y


# --------------------------------------------------------------------------- #
# The vocab epilogue, at tensor parallel 1
# --------------------------------------------------------------------------- #
def _unsharded_vocab(model_axis):
    if model_axis is not None:
        raise NotImplementedError(
            f"vocab parallelism (a vocab-sharded embedding) is not ported "
            f"yet ({_VOCAB_ITEM})")


def vocab_parallel_embedding(tokens, embedding, *, model_axis=None,
                             comm_overlap=None):
    """Token lookup on the (unsharded) embedding table.  Ids outside the
    table clamp to its edge rows, as JAX indexing does."""
    _unsharded_vocab(model_axis)
    return embedding[tokens.long().clamp(0, embedding.shape[0] - 1)]


def vocab_parallel_greedy_token(x, embedding, *, vocab_size: int,
                                model_axis=None):
    """Greedy next-token ids from last-position hidden states ``[B, H]``
    against the tied unembedding ``[V, H]``.  Logits are fp32 against
    the fp32 table whatever the model dtype; ties keep the smallest id.
    Returns ``(token [B] int32, max logit [B] fp32)``."""
    _unsharded_vocab(model_axis)
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
    _unsharded_vocab(model_axis)
    m = scores.max(dim=-1).values
    am = (start + scores.argmax(dim=-1)).to(torch.int32)
    tok = torch.where(m >= m, am, torch.full_like(am, vocab_size))
    return tok, m
