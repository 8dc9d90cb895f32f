"""Quantize/dequantize arithmetic for collectives, and the composed psums.

Counterpart of ``autodist_tpu/kernel/quantize.py`` for what the
tensor-parallel boundaries and the gradient compressors use: the
precision vocabulary, the symmetric int8 scale and levels,
:func:`quantized_psum` at fp32, bf16 and int8, :func:`quantized_pmax`
(the vocab epilogue's stabilizing max), the error-feedback pair
:func:`ef_correct` / :func:`ef_residual`
(:mod:`~autodist_tpu_torch.kernel.compressor`) and the flat pair of the
ZeRO-3 gather's ``zero3_gather`` slot,
:func:`quantized_psum_scatter_flat` and
:func:`quantized_all_gather_flat`.  The decomposed int8/bf16 halves of
the tensor-parallel boundaries belong to the overlap item (ROADMAP
Queue 1).

Two numeric rules keep the port bit-exact with the JAX package:

* ``x / scale`` is a true IEEE division by a tensor on ``x``'s device
  (PyTorch's CUDA division by a host scalar multiplies by the
  reciprocal instead, which rounds differently);
* ``torch.round`` rounds half to even, as ``jnp.round`` does.

The int8 psum sums integer levels on an fp16 wire, as the JAX package
does: levels in [-127, 127] are exact in fp16 and so is their running
sum while its magnitude stays at or below 2048 (16 full-scale ranks).
gloo and NCCL both sum fp16.
"""
from __future__ import annotations

import torch

# The per-boundary precision vocabulary of the Strategy IR policy.
PRECISIONS = ("fp32", "bf16", "int8")

# Scale floor: an all-zero block would otherwise divide by zero; any
# positive floor maps it to all-zero levels exactly.
SCALE_FLOOR = 1e-20


class UnknownPrecisionError(ValueError):
    """A precision value outside :data:`PRECISIONS`."""


def check_precision(value, *, where: str = "precision") -> str:
    """Canonicalize one precision value (``None`` -> ``"fp32"``);
    anything outside :data:`PRECISIONS` raises
    :class:`UnknownPrecisionError`."""
    if value is None:
        return "fp32"
    if value not in PRECISIONS:
        raise UnknownPrecisionError(
            f"{where}: unknown precision {value!r}; expected one of "
            f"{list(PRECISIONS)}")
    return value


def _scalar(value, like):
    """A 0-d tensor on ``like``'s device, made there (no host copy)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _scale_of(amax):
    """``max(amax / 127, 1e-20)`` in fp32, the division a true one; a
    NaN stays NaN, as ``jnp.maximum`` keeps it."""
    return torch.maximum(amax / _scalar(127.0, amax),
                         _scalar(SCALE_FLOOR, amax))


def abs_max_scale(x):
    """Symmetric per-tensor int8 scale: ``max|x| / 127``, floored so an
    all-zero block quantizes to exact zeros.  A 0-d tensor on ``x``'s
    device."""
    return _scale_of(x.abs().max())


def quantize_levels(x, scale):
    """Integer levels in [-127, 127], kept in ``x``'s float dtype:
    ``clip(round(x / scale))`` with IEEE division and half-to-even
    rounding."""
    return torch.clamp(torch.round(x / scale), -127, 127)


def quantize_int8(x):
    """``(q, scale)``: ``q`` a true ``int8`` payload, ``scale`` its fp32
    per-tensor scale."""
    scale = abs_max_scale(x)
    return quantize_levels(x, scale).to(torch.int8), scale


def dequantize_int8(q, scale):
    return q.float() * scale


def shared_scale(x, axis):
    """Group-wide int8 scale: every rank proposes ``max|x|`` and a max
    over ``axis`` makes them agree, so quantized payloads are summable."""
    return _scale_of(axis.pmax(x.abs().max()))


def quantized_psum(x, axis, precision: str):
    """All-reduce ``x`` over ``axis`` at the requested wire precision;
    the result is cast back to ``x.dtype``.

    ``fp32`` is the exact sum; ``bf16`` casts the payload; ``int8``
    agrees a shared scale (a scalar max), sums integer levels on an
    fp16 wire and rescales.  Stateless (no error feedback)."""
    precision = check_precision(precision)
    if precision == "fp32":
        return axis.psum(x)
    if precision == "bf16":
        return axis.psum(x.to(torch.bfloat16)).to(x.dtype)
    scale = shared_scale(x, axis)
    q = quantize_levels(x.float(), scale)
    summed = axis.psum(q.to(torch.float16))
    return (summed.float() * scale).to(x.dtype)


def quantized_pmax(x, axis, precision: str):
    """Group max at the wire precision.  A max is order-free, so a
    narrowed wire only rounds the result; ``int8`` takes the bf16 wire
    (8-bit levels would waste the max's role as a softmax stabilizer)."""
    precision = check_precision(precision)
    if precision == "fp32":
        return axis.pmax(x)
    return axis.pmax(x.to(torch.bfloat16)).to(x.dtype)


def ef_correct(grad, residual):
    """The carried quantization error applied before compressing:
    ``grad + residual`` in fp32."""
    return grad.float() + residual


def ef_residual(corrected, wire):
    """Next step's residual: what this step's wire form lost."""
    return corrected - wire.float()


def quantized_psum_scatter_flat(flat, axis, precision: str):
    """Reduce-scatter of a padded flat payload (its length divides the
    axis size) at the wire precision: this rank's fp32 chunk of the
    sum.  ``int8`` agrees a shared scale and sums integer levels on an
    fp16 wire, as :func:`quantized_psum` does."""
    precision = check_precision(precision)
    if precision == "fp32":
        return axis.psum_scatter(flat)
    if precision == "bf16":
        return axis.psum_scatter(flat.to(torch.bfloat16)).float()
    scale = shared_scale(flat, axis)
    q = quantize_levels(flat.float(), scale)
    return axis.psum_scatter(q.to(torch.float16)).float() * scale


def quantized_all_gather_flat(shard, axis, precision: str):
    """All-gather of equal flat shards at the wire precision: the fp32
    flat concatenation in axis order.  A gather never sums, so ``int8``
    carries true ``int8`` levels, each source shard's fp32 scale
    gathered beside them, and every row dequantizes with its own."""
    precision = check_precision(precision)
    if precision == "fp32":
        return axis.all_gather(shard)
    if precision == "bf16":
        return axis.all_gather(shard.to(torch.bfloat16)).float()
    q, scale = quantize_int8(shard.float())
    rows = axis.all_gather(q.unsqueeze(0))               # [n, shard] int8
    scales = axis.all_gather(scale.reshape(1))           # [n] fp32
    return (rows.float() * scales[:, None]).reshape(-1)
