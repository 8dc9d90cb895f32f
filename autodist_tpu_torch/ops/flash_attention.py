"""Flash attention over ``[batch, length, heads, head_dim]``, forward and backward.

Counterpart of ``autodist_tpu/ops/flash_attention.py``: the same
layout contract (q, k, v and ``out`` are ``[B, L, H, D]``, ``lse`` is
``[B, L, H]``), softmax statistics in fp32 whatever the input dtype, and
a backward that recomputes the probabilities from the saved logsumexp.
Three kernels carry it, each a wrapper here around a hand-written CUDA
kernel of ``kernel/csrc/flash_attention.cu``:

* :func:`flash_attention_fwd` (K1) — ``out`` in the input dtype and the
  fp32 ``lse``;
* :func:`flash_attention_bwd_dq` (K2a) — fp32 ``dq``;
* :func:`flash_attention_bwd_dkv` (K2b) — fp32 ``dk`` and ``dv``.

Given CUDA tensors a wrapper launches its kernel (built at first use;
fp32 in full fp32 on the CUDA cores, bf16 with its products on the
tensor cores) and counts the launch in its ``launches`` attribute, or
raises; given
CPU tensors it runs its plain version below, which has the Pallas
kernels' numerics: scores ``q . k * scale`` in fp32, masked scores at
the finite float32 minimum, ``p`` cast to the input dtype before the
value product (K1), ``p`` and ``ds`` cast likewise before theirs (K2),
``lse = m + log l``.  The kernels take any length ``L`` as it is and
mask its ragged end themselves; the JAX wrapper pads ``L`` to a block
multiple instead, which gives the same values.

:class:`_FlashAttention` ties the three together as one autograd
function; ``delta = rowsum(g * out)`` is computed in fp32 outside the
kernels and the ``lse`` cotangent folds into it as ``delta - g_lse``.
Block sizes are the kernels' own: there is no tuning table.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from autodist_tpu_torch import cuda_graph
from autodist_tpu_torch.kernel import NEG_INF, build
from autodist_tpu_torch.kernel.flash_decode import (DTYPE_CODES,
                                                    SUPPORTED_HEAD_DIMS,
                                                    on_cuda, raise_on_error,
                                                    stream_of)


# --------------------------------------------------------------------------- #
# plain versions (the CPU path, and the reference the kernels are held to)
# --------------------------------------------------------------------------- #
def _scores(q, k, causal: bool, scale: float):
    """Masked fp32 scores ``[B, H, L, L]``."""
    s = (q.float().transpose(1, 2) @ k.float().permute(0, 2, 3, 1)) * scale
    if causal:
        L = q.shape[1]
        vis = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        s = torch.where(vis, s, NEG_INF)
    return s


def _bhl1(x):
    """``[B, L, H]`` statistics as ``[B, H, L, 1]``."""
    return x.transpose(1, 2)[..., None]


def flash_attention_fwd_plain(q, k, v, *, causal: bool, scale: float):
    """Plain PyTorch version of :func:`flash_attention_fwd` (K1)."""
    s = _scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = (p.to(q.dtype).float() @ v.float().transpose(1, 2)) / l
    lse = (m + torch.log(l))[..., 0]
    return (out.transpose(1, 2).to(q.dtype).contiguous(),
            lse.transpose(1, 2).contiguous())


def _probs_and_ds(q, k, v, g, lse, delta, causal, scale):
    """``p = exp(s - lse)`` and ``ds = p (dp - delta) scale``, fp32
    ``[B, H, L, L]``."""
    p = torch.exp(_scores(q, k, causal, scale) - _bhl1(lse))
    dp = g.float().transpose(1, 2) @ v.float().permute(0, 2, 3, 1)
    return p, p * (dp - _bhl1(delta)) * scale


def flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, *, causal: bool,
                                 scale: float):
    """Plain PyTorch version of :func:`flash_attention_bwd_dq` (K2a)."""
    _, ds = _probs_and_ds(q, k, v, g, lse, delta, causal, scale)
    dq = ds.to(k.dtype).float() @ k.float().transpose(1, 2)
    return dq.transpose(1, 2).contiguous()


def flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, *, causal: bool,
                                  scale: float):
    """Plain PyTorch version of :func:`flash_attention_bwd_dkv` (K2b)."""
    p, ds = _probs_and_ds(q, k, v, g, lse, delta, causal, scale)
    dv = p.to(g.dtype).float().transpose(-1, -2) @ g.float().transpose(1, 2)
    dk = ds.to(q.dtype).float().transpose(-1, -2) @ q.float().transpose(1, 2)
    return (dk.transpose(1, 2).contiguous(), dv.transpose(1, 2).contiguous())


# --------------------------------------------------------------------------- #
# argument checks and the C entry points
# --------------------------------------------------------------------------- #
def _check_qkv(q, k, v):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, L, H, D]; got shape {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q has "
                             f"{tuple(q.shape)} (self-attention)")
    if q.shape[1] == 0 or q.shape[0] * q.shape[2] == 0:
        raise ValueError(f"empty attention input {tuple(q.shape)}")


def _check_stats(L_shape, **stats):
    for name, t in stats.items():
        if tuple(t.shape) != L_shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{L_shape}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32")


def _kernel_code(q, k, v, *contiguous):
    """What the kernels take: fp32 or bf16 at a supported head dim, one
    dtype throughout, q/k/v with unit last stride and shared 16-byte
    aligned strides, the other tensors contiguous.  Returns the dtype
    code and q's (batch, length, head) strides in elements."""
    dt = q.dtype
    if dt not in DTYPE_CODES:
        raise TypeError(f"kernel takes {list(DTYPE_CODES)}; got {dt}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {SUPPORTED_HEAD_DIMS}; "
                         f"got {q.shape[-1]}")
    esize = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)) + contiguous:
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, expected {dt}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in (("k", k), ("v", v)):
        if t.stride() != q.stride():
            raise ValueError(f"{name} has strides {t.stride()}, q has "
                             f"{q.stride()}: q, k and v must share strides")
    sb, sl, sh, sd = q.stride()
    if sd != 1 or any(s * esize % 16 for s in (sb, sl, sh)):
        raise ValueError(f"q/k/v strides {q.stride()} must be 16-byte "
                         f"multiples with a unit last stride")
    for name, t in contiguous:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return DTYPE_CODES[dt], (sb, sl, sh)


_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)


@functools.lru_cache(maxsize=None)
def _c_kernels():
    lib = build.load_library()
    fwd = lib.adt_flash_attention_fwd
    fwd.argtypes = [_P] * 3 + [_L] * 3 + [_P] * 2 + [_I] * 5 + [_F, _I, _P]
    dq = lib.adt_flash_attention_bwd_dq
    dq.argtypes = [_P] * 3 + [_L] * 3 + [_P] * 4 + [_I] * 5 + [_F, _I, _P]
    dkv = lib.adt_flash_attention_bwd_dkv
    dkv.argtypes = [_P] * 3 + [_L] * 3 + [_P] * 5 + [_I] * 5 + [_F, _I, _P]
    for fn in (fwd, dq, dkv):
        fn.restype = _I
    return fwd, dq, dkv


def _scale_of(q, scale):
    return float(1.0 / math.sqrt(q.shape[-1]) if scale is None else scale)


# --------------------------------------------------------------------------- #
# wrappers
# --------------------------------------------------------------------------- #
def flash_attention_fwd(q, k, v, *, causal: bool = False, scale=None):
    """Flash attention forward (K1).

    ``q``/``k``/``v``: ``[B, L, H, D]`` of one dtype (on the card: fp32
    or bf16, D = 64, sharing strides — slices of one ``[B, L, 3, H, D]``
    projection qualify).  Returns ``out [B, L, H, D]`` in that dtype and
    ``lse [B, L, H]`` fp32."""
    _check_qkv(q, k, v)
    scale = _scale_of(q, scale)
    if not on_cuda(q, k, v):
        return flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
    code, (sb, sl, sh) = _kernel_code(q, k, v)
    B, L, H, D = q.shape
    fwd, _, _ = _c_kernels()
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, L, H), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), sb, sl, sh,
                 out.data_ptr(), lse.data_ptr(), B, L, H, D, code, scale,
                 int(causal), stream_of(q))
    raise_on_error(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


cuda_graph.counted(flash_attention_fwd, "launches")


def flash_attention_bwd_dq(q, k, v, g, lse, delta, *, causal: bool = False,
                           scale=None):
    """Flash attention backward, dq (K2a).

    ``g``: the cotangent of ``out`` ``[B, L, H, D]`` in the input dtype;
    ``lse``/``delta``: ``[B, L, H]`` fp32.  Returns fp32 ``dq``."""
    _check_qkv(q, k, v)
    _check_stats(tuple(q.shape[:3]), lse=lse, delta=delta)
    scale = _scale_of(q, scale)
    if not on_cuda(q, k, v, g, lse, delta):
        return flash_attention_bwd_dq_plain(q, k, v, g, lse, delta,
                                            causal=causal, scale=scale)
    code, (sb, sl, sh) = _kernel_code(q, k, v, ("g", g))
    B, L, H, D = q.shape
    _, dq_fn, _ = _c_kernels()
    dq = torch.empty((B, L, H, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = dq_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), sb, sl, sh,
                   g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                   dq.data_ptr(), B, L, H, D, code, scale, int(causal),
                   stream_of(q))
    raise_on_error(rc, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


cuda_graph.counted(flash_attention_bwd_dq, "launches")


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, *, causal: bool = False,
                            scale=None):
    """Flash attention backward, dk and dv (K2b).  Arguments as
    :func:`flash_attention_bwd_dq`; returns fp32 ``(dk, dv)``."""
    _check_qkv(q, k, v)
    _check_stats(tuple(q.shape[:3]), lse=lse, delta=delta)
    scale = _scale_of(q, scale)
    if not on_cuda(q, k, v, g, lse, delta):
        return flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta,
                                             causal=causal, scale=scale)
    code, (sb, sl, sh) = _kernel_code(q, k, v, ("g", g))
    B, L, H, D = q.shape
    _, _, dkv_fn = _c_kernels()
    dk = torch.empty((B, L, H, D), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        rc = dkv_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), sb, sl, sh,
                    g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), B, L, H, D, code, scale,
                    int(causal), stream_of(q))
    raise_on_error(rc, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


cuda_graph.counted(flash_attention_bwd_dkv, "launches")


# --------------------------------------------------------------------------- #
# autograd
# --------------------------------------------------------------------------- #
class _FlashAttention(torch.autograd.Function):
    """``(out, lse)`` with the kernels' backward: saves ``(q, k, v, out,
    lse)``, recomputes from ``lse`` and casts ``dq, dk, dv`` back to the
    input dtype.  An ``lse`` cotangent folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        g = torch.zeros_like(out) if g is None else g.contiguous()
        delta = (g.float() * out.float()).sum(-1)
        if g_lse is not None:
            delta = delta - g_lse.float()
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q, k, v, *, causal: bool = False, scale=None):
    """Fused attention over ``[batch, length, heads, head_dim]`` inputs,
    differentiable through K2a and K2b."""
    return _FlashAttention.apply(q, k, v, bool(causal), _scale_of(q, scale))[0]


def flash_attention_with_lse(q, k, v, *, causal: bool = False, scale=None):
    """``(out, lse)`` with ``lse`` ``[batch, length, heads]``; both are
    differentiable (the ring-merge primitive of the JAX package)."""
    return _FlashAttention.apply(q, k, v, bool(causal), _scale_of(q, scale))


def make_attention_fn(causal: bool):
    """Adapter for ``TransformerConfig.attention_fn``: ``(q, k, v, mask,
    dropout_rng) -> out``.

    As in the JAX package, the kernel supports no masking or the causal
    triangle: with ``causal=True`` the model's mask is taken to be the
    causal one, with ``causal=False`` any mask (a padding mask) is
    rejected, and so is attention dropout."""

    def attention_fn(q, k, v, mask, dropout_rng):
        if dropout_rng is not None:
            raise ValueError(
                "flash attention does not support attention dropout; set "
                "attention_dropout_rate=0 or use the default attention")
        if mask is not None and not causal:
            raise ValueError(
                "flash attention supports only causal or no masking; got a "
                "mask with causal=False (padding masks need the default "
                "attention)")
        return flash_attention(q, k, v, causal=causal)

    attention_fn._adt_flash = True
    attention_fn.causal = bool(causal)
    return attention_fn


def is_flash_attention_fn(fn) -> bool:
    """True for :func:`make_attention_fn`'s adapter and for
    :func:`flash_attention` itself."""
    return bool(getattr(fn, "_adt_flash", False)) or fn is flash_attention
