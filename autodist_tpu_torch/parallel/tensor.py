"""Megatron tensor-parallel boundaries, their precision and kernel
scopes, and the vocab-parallel embedding and epilogues.

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
ported (ROADMAP Queue 1, slice 3 leftovers).

Vocab parallelism shards the tied embedding's rows over the model axis:
:func:`vocab_parallel_embedding` is a masked shard lookup and a sum,
:func:`vocab_parallel_cross_entropy` the streaming loss head, and
:func:`vocab_parallel_greedy_token` the serving epilogue; the last two
share one argmax election (:func:`_resolve_global_argmax`).  Their
statistics sums run at the ``vocab_stats`` precision.
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
# Vocab parallelism: the sharded lookup, the streaming cross-entropy and
# the greedy epilogue
# --------------------------------------------------------------------------- #
def vocab_pad(vocab_size: int, tp: int) -> int:
    """Rows of zero-padding that make ``vocab_size`` divide ``tp``."""
    return (-vocab_size) % max(tp, 1)


def _shard_start(rows: int, model_axis) -> int:
    """The global id of a vocab shard's first row."""
    return 0 if model_axis is None else model_axis.index * rows


def _in_shard(ids, rows: int, model_axis):
    """``(in_shard, safe)``: whether each id falls in this shard's rows,
    and its local row clamped into the shard."""
    local = ids.long() - _shard_start(rows, model_axis)
    return (local >= 0) & (local < rows), local.clamp(0, rows - 1)


def _check_overlap_precision(prec: str, slot: str):
    if prec != "fp32":
        raise NotImplementedError(
            f"a {prec} {slot} precision under comm_overlap is not ported "
            f"yet ({_OVERLAP_ITEM})")


def sum_partials_decomposed(x, model_axis):
    """Decomposed (rs + ag) sum forward / identity backward: the
    ``comm_overlap`` form of :func:`sum_partials`, at fp32."""
    if model_axis is None:
        return x
    _check_overlap_precision(active_precision("tp_psum"), "tp_psum")
    return _SumPartials.apply(x, functools.partial(psum_decomposed,
                                                   axis=model_axis))


def vocab_parallel_embedding(tokens, embedding, *, model_axis=None,
                             comm_overlap=None):
    """Token lookup on a vocab-sharded (dim 0) embedding table.

    With ``model_axis``, ``embedding`` is the local ``[V_pad/tp, H]``
    shard (zero rows at the tail of the last shard when the vocabulary
    does not divide): each shard contributes its rows' vectors, zeros
    for the ids it does not hold, and :func:`sum_partials` (decomposed
    under ``comm_overlap``) assembles the lookup; its identity backward
    leaves the masked scatter into this shard's rows, with no model-axis
    collective.  ``model_axis=None`` is the unsharded lookup, ids
    outside the table clamped to its edge rows as JAX indexing does."""
    if model_axis is None:
        return embedding[tokens.long().clamp(0, embedding.shape[0] - 1)]
    in_shard, safe = _in_shard(tokens, embedding.shape[0], model_axis)
    out = embedding[safe] * in_shard[..., None].to(embedding.dtype)
    if normalize_comm_overlap(comm_overlap):
        return sum_partials_decomposed(out, model_axis)
    return sum_partials(out, model_axis)


def _resolve_seq_chunk(length: int, seq_chunk) -> int:
    """Largest divisor of ``length`` at most the requested chunk
    (default 128), so the sequence splits into equal chunks."""
    want = max(min(length, seq_chunk or 128), 1)
    for c in range(want, 0, -1):
        if length % c == 0:
            return c
    return length


def _masked_logits(x, embedding, vocab_size: int, model_axis):
    """fp32 ``x @ embedding.T`` over this shard's rows, the rows at or
    past ``vocab_size`` (the zero padding) at the fp32 minimum."""
    rows = embedding.shape[0]
    logits = x.float() @ embedding.float().T
    ids = _shard_start(rows, model_axis) + torch.arange(rows,
                                                        device=x.device)
    return torch.where(ids < vocab_size, logits, NEG_INF)


def _resolve_global_argmax(scores, start, vocab_size: int, model_axis,
                           precision: str = "fp32"):
    """The argmax election the greedy epilogue and the cross-entropy's
    ``pred`` share: each shard proposes its local argmax's global id (the
    first, i.e. smallest, among equal maxima), a max over the model axis
    at ``precision`` (:func:`~autodist_tpu_torch.kernel.quantize
    .quantized_pmax`) finds the global max score, losers propose
    ``vocab_size`` and a min over the axis keeps the smallest winner.  A
    NaN row fails ``>=`` everywhere and yields ``vocab_size``.  Under a
    narrowed precision the shard max is rounded to bf16 before the
    comparison, so the winner's rounded max equals the group max exactly
    (its fp32 value might sit below a rounded-up group max, and then
    every shard would propose ``vocab_size``).  Returns ``(token [...]
    int32, the group max [...] fp32)``."""
    m_loc = scores.max(dim=-1).values
    if model_axis is not None and precision != "fp32":
        m_loc = m_loc.to(torch.bfloat16).float()
    m = m_loc if model_axis is None else qz.quantized_pmax(
        m_loc, model_axis, precision)
    am = (start + scores.argmax(dim=-1)).to(torch.int32)
    cand = torch.where(m_loc >= m, am, torch.full_like(am, vocab_size))
    tok = cand if model_axis is None else model_axis.pmin(cand)
    return tok, m


class _VocabCrossEntropy(torch.autograd.Function):
    """The streaming cross-entropy: ``(x [B, L, H], shard [rows, H],
    targets [B, L])`` to ``(nll [B, L] fp32, pred [B, L] int32)``, one
    sequence chunk at a time in both passes.  ``psum`` is the statistics
    sum (at ``vocab_stats``; decomposed under overlap); the backward
    recomputes each chunk's logits from the saved ``(x, shard, lse)``."""

    @staticmethod
    def forward(ctx, x, emb, targets, vocab_size, model_axis, chunk, prec,
                psum):
        rows = emb.shape[0]
        start = _shard_start(rows, model_axis)
        nll, pred, lse = [], [], []
        for c in range(0, x.shape[1], chunk):
            logits = _masked_logits(x[:, c:c + chunk], emb, vocab_size,
                                    model_axis)
            p, m = _resolve_global_argmax(logits, start, vocab_size,
                                          model_axis, prec)
            s = psum(torch.exp(logits - m[..., None]).sum(-1))
            in_shard, safe = _in_shard(targets[:, c:c + chunk], rows,
                                       model_axis)
            tgt_loc = logits.gather(-1, safe[..., None])[..., 0]
            tgt = psum(torch.where(in_shard, tgt_loc, 0.0))
            lse_c = m + torch.log(s)
            nll.append(lse_c - tgt)
            pred.append(p)
            lse.append(lse_c)
        ctx.save_for_backward(x, emb, targets, torch.cat(lse, 1))
        ctx.args = (vocab_size, model_axis, chunk, psum)
        pred = torch.cat(pred, 1)
        ctx.mark_non_differentiable(pred)
        return torch.cat(nll, 1), pred

    @staticmethod
    def backward(ctx, ct_nll, _ct_pred):
        x, emb, targets, lse = ctx.saved_tensors
        vocab_size, model_axis, chunk, psum = ctx.args
        rows = emb.shape[0]
        ct_nll = ct_nll.float()
        emb32 = emb.float()
        dW = torch.zeros((rows, emb.shape[1]), dtype=torch.float32,
                         device=emb.device)
        dx = []
        for c in range(0, x.shape[1], chunk):
            xc = x[:, c:c + chunk]
            logits = _masked_logits(xc, emb, vocab_size, model_axis)
            g = torch.exp(logits - lse[:, c:c + chunk, None])
            in_shard, safe = _in_shard(targets[:, c:c + chunk], rows,
                                       model_axis)
            g.scatter_add_(-1, safe[..., None], -in_shard[..., None].float())
            g = g * ct_nll[:, c:c + chunk, None]
            dx.append(g @ emb32)
            dW += g.reshape(-1, rows).T @ xc.float().reshape(-1, xc.shape[-1])
        dx = psum(torch.cat(dx, 1))
        return (dx.to(x.dtype), dW.to(emb.dtype), None, None, None, None,
                None, None)


def vocab_parallel_cross_entropy(x, embedding, targets, *, vocab_size: int,
                                 model_axis=None, seq_chunk=None,
                                 comm_overlap=None):
    """Streaming softmax cross-entropy against a vocab-sharded tied
    unembedding.

    ``x``: ``[B, L, H]`` final hidden states; ``embedding``: the local
    ``[V_pad/tp, H]`` shard (the full ``[V, H]`` table when
    ``model_axis`` is ``None``); ``targets``: ``[B, L]`` ids below
    ``vocab_size``.  Returns ``(nll [B, L] fp32, pred [B, L] int32)``,
    ``pred`` the argmax with ties to the smallest id.

    Per sequence chunk (:func:`_resolve_seq_chunk`) the local ``[B,
    chunk, V/tp]`` fp32 logits reduce to token-shaped statistics: the
    shard max and its group max (:func:`_resolve_global_argmax`, which
    also elects ``pred``), the sum-exp and the target logit, both summed
    over the model axis at the active ``vocab_stats`` precision.  The
    backward recomputes each chunk's logits from ``(x, shard, lse)``,
    accumulates the shard's ``dW`` locally and sums ``dx`` over the axis
    once.  Neither pass holds a ``[B, L, V/tp]`` buffer.  Padded rows sit
    at the fp32 minimum: they never win the argmax, add ``exp(-huge) =
    0`` to the sum and get no gradient.  ``comm_overlap`` (any mode)
    takes the statistics and ``dx`` sums as the decomposed pair, at fp32
    only.  ``model_axis=None`` runs the same math with no collective."""
    prec = active_precision("vocab_stats")
    if model_axis is None:
        def psum(v):
            return v
    elif normalize_comm_overlap(comm_overlap):
        _check_overlap_precision(prec, "vocab_stats")
        psum = functools.partial(psum_decomposed, axis=model_axis)
    else:
        psum = functools.partial(qz.quantized_psum, axis=model_axis,
                                 precision=prec)
    chunk = _resolve_seq_chunk(targets.shape[1], seq_chunk)
    return _VocabCrossEntropy.apply(x, embedding, targets, vocab_size,
                                    model_axis, chunk, prec, psum)


def vocab_parallel_greedy_token(x, embedding, *, vocab_size: int,
                                model_axis=None):
    """Greedy next-token ids from last-position hidden states ``[B, H]``
    against the (vocab-sharded with ``model_axis``) tied unembedding.
    Logits are fp32 against the fp32 table whatever the model dtype,
    padded rows masked; the election is the cross-entropy's ``pred``
    (:func:`_resolve_global_argmax`).  The live logits are ``[B,
    V/tp]``.  Returns ``(token [B] int32, max logit [B] fp32)``."""
    logits = _masked_logits(x, embedding, vocab_size, model_axis)
    return _resolve_global_argmax(
        logits, _shard_start(embedding.shape[0], model_axis), vocab_size,
        model_axis)
