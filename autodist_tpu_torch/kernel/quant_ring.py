"""The quantized ring all-reduce (EQuARX): one fused kernel per hop.

Counterpart of ``autodist_tpu/kernel/pallas/quant_ring.py``.  The
composed int8 psum (:func:`autodist_tpu_torch.kernel.quantize
.quantized_psum`) quantizes once against a shared scale and sums levels
on an fp16 wire; this ring re-quantizes each hop's partial sum against
its own scale, so every hop's wire carries a true ``int8`` chunk and one
fp32 scale.

:func:`fused_hop` (K3) is one hop's arithmetic: ``acc = f32(q_in) *
scale_in + local`` (separately rounded), ``scale = max(max|acc| / 127,
1e-20)``, ``q_out = int8(clip(round(acc / scale), -127, 127))``.  On
CUDA tensors it launches the kernel of ``csrc/quant_ring.cu`` (one
cooperative launch a hop) and counts the launch in its ``launches``
attribute, and in ``unaligned`` the launches whose arrays were not all
16-byte aligned (the kernel's element-wise path); on CPU tensors it runs
:func:`fused_hop_plain`.  ``scale_in = 0`` makes the incoming term
vanish, so the same hop is the ring's opening quantizer.

:func:`quantized_ring_all_reduce` follows the JAX ring hop for hop:
flatten to fp32, zero-pad to ``n`` chunks, one opening quantize of chunk
``me``, ``n - 1`` reduce-scatter hops (after hop ``h`` rank ``me`` holds
the partial sum of chunk ``me - h``), ``n - 1`` all-gather hops of the
owned chunks, and the cast back.  Each hop sends the chunk and its scale
to rank ``me + 1`` as one message (:func:`send`): a 16-byte header
whose first 4 bytes hold the scale, then the levels, so that the levels
that arrive start 16-byte aligned and the next hop takes the kernel's
vector path.  The scale stays a device tensor: the ring
reads nothing back to the host beyond what the transport itself moves.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from autodist_tpu_torch import cuda_graph
from autodist_tpu_torch.kernel import build
from autodist_tpu_torch.kernel import quantize as qz
from autodist_tpu_torch.kernel.flash_decode import (on_cuda, raise_on_error,
                                                    stream_of)


def _quantize_pair(acc):
    scale = qz.abs_max_scale(acc)
    return qz.quantize_levels(acc, scale).to(torch.int8), scale


def fused_hop_plain(q_in, scale_in, local):
    """Plain PyTorch version of :func:`fused_hop`."""
    return _quantize_pair(q_in.float() * scale_in + local.float())


_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# Words of the hop kernels' block-maxima scratch (one a block): more
# blocks than a card keeps resident (an H100 holds 132 of 1024 threads).
SCRATCH_WORDS = 1024
# Bytes of the wire's header: the scale, then padding to 16 bytes.
WIRE_HEADER = 16


def aligned(*tensors) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary: the
    hop kernels' vector path (int4 levels, float4 values)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


@functools.lru_cache(maxsize=None)
def _c_kernel():
    hop = build.load_library().adt_quant_ring_hop
    hop.argtypes = [_P] * 6 + [_L, _L, _I, _P]
    hop.restype = ctypes.c_int
    return hop


def fused_hop(q_in, scale_in, local):
    """One fused ring hop (K3): ``q_in`` int8, ``scale_in`` a one-element
    fp32 tensor, ``local`` fp32 of ``q_in``'s shape -> ``(q_out int8,
    scale_out 0-d fp32)``, both on ``local``'s device."""
    if q_in.shape != local.shape:
        raise ValueError(f"q_in {tuple(q_in.shape)} and local "
                         f"{tuple(local.shape)} differ in shape")
    if scale_in.numel() != 1:
        raise ValueError(f"scale_in must hold one value, got "
                         f"{tuple(scale_in.shape)}")
    if not on_cuda(q_in, scale_in, local):
        return fused_hop_plain(q_in, scale_in.reshape(()), local)
    for name, t, dt in (("q_in", q_in, torch.int8),
                        ("scale_in", scale_in, torch.float32),
                        ("local", local, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    q_out = torch.empty_like(q_in)
    scale_out = torch.empty((), dtype=torch.float32, device=local.device)
    block_max = torch.empty(SCRATCH_WORDS, dtype=torch.int32,
                            device=local.device)
    vec = aligned(q_in, local, q_out)
    with torch.cuda.device(local.device):
        rc = _c_kernel()(q_in.data_ptr(), scale_in.data_ptr(),
                         local.data_ptr(), q_out.data_ptr(),
                         scale_out.data_ptr(), block_max.data_ptr(),
                         SCRATCH_WORDS, local.numel(), int(vec),
                         stream_of(local))
    raise_on_error(rc, "quant_ring fused_hop")
    fused_hop.launches += 1
    fused_hop.unaligned += not vec
    return q_out, scale_out


cuda_graph.counted(fused_hop, "launches", "unaligned")


@functools.lru_cache(maxsize=None)
def _header_pad(device):
    return torch.zeros(WIRE_HEADER - 4, dtype=torch.uint8, device=device)


def send(axis, q, s, shift=1):
    """Pass levels ``q`` and scale ``s`` ``shift`` ranks along the ring
    as one uint8 message (the scale's 4 bytes, zeros to ``WIRE_HEADER``
    bytes, then the levels); returns ``(levels int8, scale [1] fp32)``
    of what rank ``me - shift`` sent, views of the message that arrived,
    the levels 16-byte aligned."""
    wire = torch.cat([s.reshape(1).view(torch.uint8), _header_pad(q.device),
                      q.view(torch.uint8)])
    got = axis.ppermute(wire, shift=shift)
    return got[WIRE_HEADER:].view(torch.int8), got[:4].view(torch.float32)


def quantized_ring_all_reduce(x, axis):
    """All-reduce ``x`` over ``axis`` as the fused-q/dq ring; the result
    is cast back to ``x.dtype``.  Same contract as
    ``quantized_psum(x, axis, "int8")``, a true int8 wire.  Any shape is
    legal: the flat payload zero-pads to ``n`` equal chunks."""
    n, me = axis.size, axis.index
    if n == 1:
        return x
    flat = x.reshape(-1).float()
    size = flat.numel()
    pad = (-size) % n
    if pad:
        flat = F.pad(flat, (0, pad))
    chunk = (size + pad) // n
    chunks = flat.view(n, chunk)
    # Reduce-scatter: rank me opens with chunk me; after hop h it holds
    # the partial sum of chunk (me - h) % n, after n - 1 hops the full
    # sum of chunk (me + 1) % n.
    q, s = fused_hop(torch.zeros(chunk, dtype=torch.int8, device=x.device),
                     torch.zeros((), dtype=torch.float32, device=x.device),
                     chunks[me])
    for h in range(1, n):
        q, s = send(axis, q, s)
        q, s = fused_hop(q, s, chunks[(me - h) % n])
    # All-gather: after j + 1 hops the arriving chunk is chunk
    # (me - j) % n.
    out = torch.empty((n, chunk), dtype=torch.float32, device=x.device)
    out[(me + 1) % n] = q.float() * s
    for j in range(n - 1):
        q, s = send(axis, q, s)
        out[(me - j) % n] = q.float() * s
    return out.view(-1)[:size].view(x.shape).to(x.dtype)


def reference_ring_all_reduce(shards):
    """Host-side mirror of the ring over a list of per-rank payloads
    (identical shapes), op for op: the exactness golden of
    :func:`quantized_ring_all_reduce`."""
    n = len(shards)
    shards = [torch.as_tensor(s) for s in shards]
    if n == 1:
        return [shards[0]]
    flats = [s.reshape(-1).float() for s in shards]
    size = flats[0].numel()
    pad = (-size) % n
    mats = [F.pad(f, (0, pad)).view(n, -1) for f in flats]
    chunk = mats[0].shape[1]
    carry = {me: _quantize_pair(mats[me][me]) for me in range(n)}
    for h in range(1, n):
        carry = {me: fused_hop_plain(*carry[(me - 1) % n],
                                     mats[me][(me - h) % n])
                 for me in range(n)}
    out = torch.empty((n, chunk))
    for src in range(n):
        q, s = carry[src]
        out[(src + 1) % n] = q.float() * s
    full = out.view(-1)[:size].view(shards[0].shape)
    return [full.clone() for _ in range(n)]


# --------------------------------------------------------------------------- #
# The boundary-layer entry (parallel/tensor.py dispatches here)
# --------------------------------------------------------------------------- #
class RingSumPartials(torch.autograd.Function):
    """Ring all-reduce forward, identity backward: ``sum_partials``
    under an int8 ``tp_psum`` policy with ``quant_ring`` elected."""

    @staticmethod
    def forward(ctx, x, axis):
        return quantized_ring_all_reduce(x, axis)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class RingGatherGrads(torch.autograd.Function):
    """Identity forward, ring all-reduce backward: ``gather_grads``
    under the same policy.  The axis is kept on ``ctx``; the backward
    takes the ring whatever scope is open when it runs."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return quantized_ring_all_reduce(ct, ctx.axis), None


def ring_sum_partials(x, axis):
    return RingSumPartials.apply(x, axis)


def ring_gather_grads(x, axis):
    return RingGatherGrads.apply(x, axis)
