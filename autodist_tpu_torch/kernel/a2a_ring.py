"""The quantized all-to-all ring: one fused kernel per hop.

Counterpart of ``autodist_tpu/kernel/pallas/a2a_ring.py``.  The MoE
dispatch/combine boundary is a tiled all-to-all; the composed int8
lowering (:func:`autodist_tpu_torch.parallel.moe.quantized_all_to_all`)
quantizes the whole payload against one scale around one ``int8``
collective.  This ring moves the quantize and dequantize into the hops:
every chunk on the wire is a true ``int8`` chunk with its own fp32
scale, and the rank's own chunk never leaves it and stays exact.

:func:`fused_hop` (K8) is one hop's arithmetic: ``arrived = f32(q_in) *
scale_in``, then for the next outgoing chunk ``scale = max(max|nxt| /
127, 1e-20)`` and ``q_out = int8(clip(round(nxt / scale), -127, 127))``.
On CUDA tensors it launches the kernel of ``csrc/a2a_ring.cu`` (one
cooperative launch a hop) and counts the launch in its ``launches``
attribute, and in ``unaligned`` the launches whose arrays were not all
16-byte aligned; on CPU tensors it runs :func:`fused_hop_plain`.
``out=`` lets the ring dequantize straight into its output row.

:func:`quantized_ring_all_to_all` follows the JAX ring hop for hop: a
warm-up hop quantizes the chunk for rank ``me + 1`` (``scale_in = 0``,
nothing arrived), then ``n - 1`` shift-``h`` hops, each sending the
scale and the chunk to ``me + h`` as one message, receiving from ``me -
h`` and running one fused hop that dequantizes what arrived into its
row of the output and quantizes the chunk for hop ``h + 1`` (zeros
after the last).  The message is the K3 ring's
(:func:`autodist_tpu_torch.kernel.quant_ring.send`: a 16-byte header
with the scale, then the levels).  The result is reassembled in source
order.  The scale stays a device tensor: the ring reads nothing back to
the host beyond what the transport moves.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from autodist_tpu_torch import cuda_graph
from autodist_tpu_torch.kernel import build
from autodist_tpu_torch.kernel import quantize as qz
from autodist_tpu_torch.kernel.flash_decode import (on_cuda, raise_on_error,
                                                    stream_of)
from autodist_tpu_torch.kernel.quant_ring import SCRATCH_WORDS, aligned, send


def fused_hop_plain(q_in, scale_in, nxt, out=None):
    """Plain PyTorch version of :func:`fused_hop`."""
    scale = qz.abs_max_scale(nxt)
    return (torch.mul(q_in.float(), scale_in, out=out),
            qz.quantize_levels(nxt, scale).to(torch.int8), scale)


_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _c_kernel():
    hop = build.load_library().adt_a2a_ring_hop
    hop.argtypes = [_P] * 7 + [_L, _L, _I, _P]
    hop.restype = ctypes.c_int
    return hop


def fused_hop(q_in, scale_in, nxt, out=None):
    """One fused ring hop (K8): ``q_in`` int8, ``scale_in`` a one-element
    fp32 tensor, ``nxt`` fp32 of ``q_in``'s shape -> ``(arrived fp32,
    q_out int8, scale_out 0-d fp32)``, all on ``nxt``'s device.
    ``arrived`` is written into ``out`` (fp32 of ``nxt``'s shape,
    contiguous) where one is given."""
    if q_in.shape != nxt.shape:
        raise ValueError(f"q_in {tuple(q_in.shape)} and nxt "
                         f"{tuple(nxt.shape)} differ in shape")
    if scale_in.numel() != 1:
        raise ValueError(f"scale_in must hold one value, got "
                         f"{tuple(scale_in.shape)}")
    args = [("q_in", q_in, torch.int8), ("scale_in", scale_in, torch.float32),
            ("nxt", nxt, torch.float32)]
    if out is not None:
        if out.shape != nxt.shape:
            raise ValueError(f"out {tuple(out.shape)} and nxt "
                             f"{tuple(nxt.shape)} differ in shape")
        args.append(("out", out, torch.float32))
    if not on_cuda(*(t for _, t, _ in args)):
        return fused_hop_plain(q_in, scale_in.reshape(()), nxt, out)
    for name, t, dt in args:
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    arrived = torch.empty_like(nxt) if out is None else out
    q_out = torch.empty_like(q_in)
    scale_out = torch.empty((), dtype=torch.float32, device=nxt.device)
    block_max = torch.empty(SCRATCH_WORDS, dtype=torch.int32,
                            device=nxt.device)
    vec = aligned(q_in, nxt, arrived, q_out)
    with torch.cuda.device(nxt.device):
        rc = _c_kernel()(q_in.data_ptr(), scale_in.data_ptr(),
                         nxt.data_ptr(), arrived.data_ptr(),
                         q_out.data_ptr(), scale_out.data_ptr(),
                         block_max.data_ptr(), SCRATCH_WORDS, nxt.numel(),
                         int(vec), stream_of(nxt))
    raise_on_error(rc, "a2a_ring fused_hop")
    fused_hop.launches += 1
    fused_hop.unaligned += not vec
    return arrived, q_out, scale_out


cuda_graph.counted(fused_hop, "launches", "unaligned")


def _parts(x, n, split_axis):
    """``x`` as ``[n, L]`` fp32, row ``j`` the chunk destined for rank
    ``j``, and the chunks' shape in the split-axis-major layout."""
    moved = x.movedim(split_axis, 0).float()
    part_shape = (moved.shape[0] // n,) + tuple(moved.shape[1:])
    return moved.reshape(n, -1).contiguous(), part_shape


def _assemble(rows, part_shape, split_axis, concat_axis):
    """Source-ordered ``[n, L]`` rows concatenated along ``concat_axis``
    (the tiled all-to-all's output)."""
    parts = rows.view((rows.shape[0],) + part_shape)
    return torch.cat([p.movedim(0, split_axis) for p in parts],
                     dim=concat_axis)


def quantized_ring_all_to_all(x, axis, split_axis: int, concat_axis: int):
    """All-to-all ``x`` over ``axis`` (tiled ``lax.all_to_all``
    semantics) as the fused-q/dq shift ring; the result is cast back to
    ``x.dtype``.  ``x.shape[split_axis]`` must divide by the ring
    size."""
    n, me = axis.size, axis.index
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(
            f"all_to_all split dim {x.shape[split_axis]} (axis "
            f"{split_axis}) must divide the {n}-way {axis.name!r} ring")
    flat, part_shape = _parts(x, n, split_axis)
    L = flat.shape[1]
    out = torch.empty_like(flat)
    out[me] = flat[me]                   # the own chunk stays exact
    _, q, s = fused_hop(torch.zeros(L, dtype=torch.int8, device=x.device),
                        torch.zeros((), dtype=torch.float32,
                                    device=x.device), flat[(me + 1) % n])
    for h in range(1, n):
        q, s = send(axis, q, s, h)
        nxt = flat[(me + h + 1) % n] if h + 1 < n else torch.zeros_like(
            flat[0])
        # Rank me - h's chunk for me, dequantized into its row.
        _, q, s = fused_hop(q, s, nxt, out=out[(me - h) % n])
    return _assemble(out, part_shape, split_axis, concat_axis).to(x.dtype)


def reference_ring_all_to_all(shards, split_axis: int, concat_axis: int):
    """Host-side mirror of the ring over a list of per-rank payloads
    (identical shapes): every off-rank chunk quantized once against its
    own abs-max scale and dequantized on arrival, the own chunk exact.
    The exactness golden of :func:`quantized_ring_all_to_all`."""
    n = len(shards)
    shards = [torch.as_tensor(s) for s in shards]
    if n == 1:
        return [shards[0]]
    split = [_parts(s, n, split_axis) for s in shards]
    part_shape = split[0][1]
    outs = []
    for me in range(n):
        rows = torch.empty_like(split[0][0])
        for src in range(n):
            chunk = split[src][0][me]
            if src != me:
                scale = qz.abs_max_scale(chunk)
                chunk = qz.quantize_levels(chunk, scale).to(
                    torch.int8).float() * scale
            rows[src] = chunk
        outs.append(_assemble(rows, part_shape, split_axis, concat_axis)
                    .to(shards[0].dtype))
    return outs


# --------------------------------------------------------------------------- #
# The boundary-layer entry (parallel/moe.py dispatches here)
# --------------------------------------------------------------------------- #
class RingDispatch(torch.autograd.Function):
    """The ring all-to-all, with the transposed ring (split and concat
    axes swapped) as its backward: the MoE dispatch/combine boundary
    under an int8 ``moe_a2a`` policy with ``a2a_ring`` elected."""

    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis):
        ctx.args = (axis, concat_axis, split_axis)
        return quantized_ring_all_to_all(x, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, ct):
        return (quantized_ring_all_to_all(ct.contiguous(), *ctx.args),
                None, None, None)


def ring_dispatch(x, axis, split_axis: int, concat_axis: int):
    return RingDispatch.apply(x, axis, split_axis, concat_axis)
