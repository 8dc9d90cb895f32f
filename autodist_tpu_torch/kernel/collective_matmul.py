"""The collective-matmul ring: a row-parallel matmul whose output sum
travels a ``ppermute`` ring chunk by chunk.

Counterpart of ``autodist_tpu/kernel/pallas/collective_matmul.py`` and
of ``collective_matmul_row`` in ``autodist_tpu/parallel/tensor.py``.
The kernel's output dim splits into ``tp`` chunks; the carry a rank
starts with is chunk ``me - 1``, each hop sends the carry to rank ``me +
1`` and adds the local product of the chunk that just arrived, and after
``tp - 1`` hops rank ``me`` owns the full sum of chunk ``me``; a closing
all-gather concatenates the chunks in position order.  Widths that do
not divide ``tp`` are zero-padded and sliced off.

:func:`fused_matmul_add` (K4) is one step's ``carry + x @ k`` in one
pass with fp32 accumulation and one rounding to the carry's type.  On
CUDA tensors it launches the kernel of ``csrc/collective_matmul.cu`` and
counts the launch in its ``launches`` attribute; on CPU tensors it runs
:func:`fused_matmul_add_plain`.  The bf16 kernel reads ``x`` and ``k``
through TMA tensor maps, which need 16-byte aligned rows; an operand
without them is first copied into a zero-padded aligned buffer
(:func:`tma_operands`), counted in ``fused_matmul_add.staged``.  The
main path's operands never need it.  The composed ring (``fused=False``)
instead adds a separately rounded ``tensordot`` to the carry, as the
JAX package's composed ring does.

Both rings share one backward: the local ``tensordot`` transpose, with
no model-axis collective of its own (the cotangent of the row layer's
output is already replicated).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from autodist_tpu_torch import cuda_graph
from autodist_tpu_torch.kernel import build
from autodist_tpu_torch.kernel.flash_decode import (DTYPE_CODES, on_cuda,
                                                    raise_on_error,
                                                    stream_of)


def fused_matmul_add_plain(carry, x2d, kc2d):
    """Plain PyTorch version of :func:`fused_matmul_add`: the product in
    fp32 (exact products of bf16 inputs, fp32 sums), the carry added in
    fp32, one cast back."""
    acc = torch.matmul(x2d.float(), kc2d.float())
    return (carry.float() + acc).to(carry.dtype)


def tma_ready(t) -> bool:
    """True when TMA can read the 2-D operand ``t`` where it lies: a
    16-byte aligned start, a row pitch of a 16-byte multiple and unit
    column stride."""
    return (t.data_ptr() % 16 == 0 and t.stride(1) == 1
            and t.stride(0) * t.element_size() % 16 == 0)


def tma_operands(x2d, kc2d):
    """``(x, k, staged)``: the operands as the bf16 kernel reads them.
    ``x [M, K]`` and ``k [K, C]`` are returned as they are when TMA can
    read them and K is a multiple of 8 (x's pitch); otherwise as
    zero-padded copies ``x [M, Kp]`` and ``k [Kp, C]`` (row pitch
    rounded up to 8 elements), Kp = K rounded up to 8 (at least 8).  The
    padding is zeros in K, so ``x @ k`` is unchanged; ``staged`` says
    whether anything was copied."""
    K = x2d.shape[1]
    Kp = max(8, -(-K // 8) * 8)
    pad_k = Kp != K
    if not pad_k and tma_ready(x2d):
        x_out = x2d
    else:
        x_out = x2d.new_zeros((x2d.shape[0], Kp))
        x_out[:, :K] = x2d
    if not pad_k and tma_ready(kc2d):
        k_out = kc2d
    else:
        C = kc2d.shape[1]
        k_out = kc2d.new_zeros((Kp, -(-C // 8) * 8))[:, :C]
        k_out[:K] = kc2d
    return x_out, k_out, x_out is not x2d or k_out is not kc2d


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _c_kernel():
    fn = build.load_library().adt_matmul_acc
    fn.argtypes = [_P] * 4 + [_I, _I, _I, _L, _I, _P]
    fn.restype = _I
    return fn


def fused_matmul_add(carry, x2d, kc2d):
    """``carry + x2d @ kc2d`` (K4): ``carry [M, C]``, ``x2d [M, K]``
    contiguous, ``kc2d [K, C]`` with unit column stride (a column slice
    of a wider matrix is read in place), all of one type (fp32 or
    bf16).  Returns a new ``[M, C]`` tensor."""
    M, C = carry.shape
    K = x2d.shape[1]
    if tuple(x2d.shape) != (M, K) or tuple(kc2d.shape) != (K, C):
        raise ValueError(f"shapes carry {tuple(carry.shape)}, x "
                         f"{tuple(x2d.shape)}, k {tuple(kc2d.shape)} do not "
                         f"chain as [M, C] + [M, K] @ [K, C]")
    if not on_cuda(carry, x2d, kc2d):
        return fused_matmul_add_plain(carry, x2d, kc2d)
    dt = carry.dtype
    if dt not in DTYPE_CODES or x2d.dtype != dt or kc2d.dtype != dt:
        raise TypeError(f"kernel takes one type of {list(DTYPE_CODES)}; got "
                        f"carry {dt}, x {x2d.dtype}, k {kc2d.dtype}")
    if not (carry.is_contiguous() and x2d.is_contiguous()):
        raise ValueError("carry and x must be contiguous")
    if kc2d.stride(1) != 1 and C > 1:
        raise ValueError("k must have unit column stride")
    if dt == torch.bfloat16:
        x2d, kc2d, staged = tma_operands(x2d, kc2d)
        fused_matmul_add.staged += staged
        K = x2d.shape[1]
    out = torch.empty_like(carry)
    with torch.cuda.device(carry.device):
        rc = _c_kernel()(carry.data_ptr(), x2d.data_ptr(), kc2d.data_ptr(),
                         out.data_ptr(), M, K, C, kc2d.stride(0),
                         DTYPE_CODES[dt], stream_of(carry))
    raise_on_error(rc, "collective_matmul fused_matmul_add")
    fused_matmul_add.launches += 1
    return out


cuda_graph.counted(fused_matmul_add, "launches", "staged")


def _ring_forward(x, kernel, axis, axes: int, fused: bool):
    """``psum(tensordot(x, kernel, axes))`` over ``axis`` as the chunked
    ring; ``fused`` takes :func:`fused_matmul_add` per step."""
    tp, me = axis.size, axis.index
    width = kernel.shape[-1]
    pad = (-width) % tp
    if pad:
        kernel = F.pad(kernel, (0, pad))
    cw = (width + pad) // tp
    if fused:
        lead = x.shape[:x.dim() - axes]
        M = math.prod(lead) or 1
        K = math.prod(x.shape[x.dim() - axes:]) or 1
        x2d = x.reshape(M, K)
        kflat = kernel.reshape(K, cw * tp)

        def part(carry, c):
            return fused_matmul_add(carry, x2d, kflat[:, c * cw:(c + 1) * cw])

        owned = part(torch.zeros((M, cw), dtype=x.dtype, device=x.device),
                     (me - 1) % tp)
        for h in range(1, tp):
            owned = part(axis.ppermute(owned), (me - h - 1) % tp)
        y = axis.all_gather(owned, dim=1).reshape(*lead, cw * tp)
    else:
        def part(c):
            return torch.tensordot(x, kernel.narrow(-1, c * cw, cw),
                                   dims=axes)

        owned = part((me - 1) % tp)
        for h in range(1, tp):
            owned = axis.ppermute(owned) + part((me - h - 1) % tp)
        y = axis.all_gather(owned, dim=owned.dim() - 1)
    return y[..., :width] if pad else y


def tensordot_transpose(x, kernel, ct, axes: int):
    """The cotangents of ``tensordot(x, kernel, axes)`` for ``ct``."""
    K = math.prod(kernel.shape[:axes])
    O = math.prod(kernel.shape[axes:])
    x2d = x.reshape(-1, K)
    ct2d = ct.reshape(-1, O)
    k2d = kernel.reshape(K, O)
    return ((ct2d @ k2d.T).reshape(x.shape),
            (x2d.T @ ct2d).reshape(kernel.shape))


class RingMatmul(torch.autograd.Function):
    """The ring forward, the local tensordot transpose backward."""

    @staticmethod
    def forward(ctx, x, kernel, axis, axes, fused):
        ctx.save_for_backward(x, kernel)
        ctx.axes = axes
        return _ring_forward(x, kernel, axis, axes, fused)

    @staticmethod
    def backward(ctx, ct):
        x, kernel = ctx.saved_tensors
        gx, gk = tensordot_transpose(x, kernel, ct, ctx.axes)
        return gx, gk, None, None, None


def collective_matmul_row_fused(x, kernel, axis, axes: int = 1):
    """Row-parallel matmul on the fused ring (the ``collective_matmul``
    kernel election): equals ``sum_partials(tensordot(x, kernel,
    axes))`` up to float summation order."""
    if kernel.dim() != axes + 1:
        raise ValueError(
            "collective_matmul_row_fused expects a kernel with exactly "
            f"one output dim after {axes} contraction dim(s); got shape "
            f"{tuple(kernel.shape)} — use the composed collective_matmul_row")
    return RingMatmul.apply(x, kernel, axis, axes, True)
