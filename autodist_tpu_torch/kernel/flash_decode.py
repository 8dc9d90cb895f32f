"""Flash decode: one query per slot against the dense or paged KV cache.

Counterpart of ``autodist_tpu/kernel/pallas/flash_decode.py``.  Each
wrapper keeps the JAX function's signature and layouts:

* :func:`flash_decode_attention` (K5) — ``q [B, 1, heads, d]`` against
  one layer's dense cache lanes ``k_layer``/``v_layer`` ``[B, heads, T,
  d]``;
* :func:`flash_decode_attention_paged` (K6) — the same against one
  layer's block pools ``[num_blocks, heads, block_len, d]`` routed by
  ``block_table [B, max_blocks]``.

Keys at positions ``<= lengths[b]`` are visible (the token just written
attends to itself and everything before it).  On CUDA tensors a wrapper
launches the hand-written kernel of ``csrc/flash_decode.cu`` (built at
first use) and counts the launch in its ``launches`` attribute; on CPU
tensors it runs the plain version below.  Both compute fp32 scores
``q . k * (1 / sqrt(d))``, fp32 probabilities times fp32 values and one
cast to ``dtype`` at the end — the Pallas kernel's numerics, which
differ at bf16 from the composed ``cached_attention`` (that one casts
the probabilities to ``dtype`` before the value product).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from autodist_tpu_torch import cuda_graph
from autodist_tpu_torch.kernel import NEG_INF, build

SUPPORTED_HEAD_DIMS = (64,)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------- #
# plain versions (the CPU path, and the reference the kernels are held to)
# --------------------------------------------------------------------------- #
def plain_attention(q, k_lanes, v_lanes, visible, dtype):
    """Masked attention of ``q [B, C, heads, d]`` over contiguous lanes
    ``[B, heads, T, d]`` with per-row visibility ``visible [B, C, T]``,
    with the flash kernels' numerics.  Keys no row sees are zeroed
    before the value product so that a stale non-finite row behind the
    mask cannot leak (the kernels never read them).  A row that sees no
    key at all returns zeros, as the kernels do."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float().transpose(1, 2)                        # [B, H, C, d]
    scores = (qf @ k_lanes.float().transpose(-1, -2)) * scale
    vis = visible[:, None]                                # [B, 1, C, T]
    scores = torch.where(vis, scores, NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = torch.where(vis, p, 0.0)
    s = p.sum(-1, keepdim=True)
    seen = visible.any(1)[:, None, :, None]               # [B, 1, T, 1]
    vf = torch.where(seen, v_lanes.float(), 0.0)
    out = torch.where(s > 0, (p @ vf) / s, 0.0)           # [B, H, C, d]
    return out.transpose(1, 2).to(dtype)


def gather_lanes(pool, block_table):
    """``[B, heads, max_blocks * block_len, d]`` lanes from one layer's
    pool ``[num_blocks, heads, block_len, d]`` (the composed gather)."""
    B, mb = block_table.shape
    _, H, bl, d = pool.shape
    g = pool[block_table.long()]                  # [B, mb, H, bl, d]
    return g.transpose(1, 2).reshape(B, H, mb * bl, d)


def flash_decode_attention_plain(q, k_layer, v_layer, lengths, *,
                                 dtype=torch.float32):
    """Plain PyTorch version of :func:`flash_decode_attention`."""
    T = k_layer.shape[2]
    pos = torch.arange(T, device=q.device)
    visible = (pos[None, :] <= lengths.long()[:, None])[:, None, :]
    return plain_attention(q, k_layer, v_layer, visible, dtype)


def flash_decode_attention_paged_plain(q, k_pool, v_pool, lengths,
                                       block_table, *, block_len: int,
                                       dtype=torch.float32):
    """Plain PyTorch version of :func:`flash_decode_attention_paged`."""
    del block_len  # implied by the pool's block extent
    return flash_decode_attention_plain(
        q, gather_lanes(k_pool, block_table),
        gather_lanes(v_pool, block_table), lengths, dtype=dtype)


# --------------------------------------------------------------------------- #
# argument checks shared with the prefill wrapper
# --------------------------------------------------------------------------- #
def check_shape(t, name, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def on_cuda(*tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when every
    tensor lies on the CPU; raises on a mix."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on several devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def check_kernel_args(dtype, data, indices):
    """What the CUDA kernels take: one element type (fp32 or bf16)
    for the data tensors and for ``dtype``, int32 indices, contiguous
    tensors, 16-byte aligned data, a supported head dim."""
    dt = data[0][1].dtype
    if dt not in DTYPE_CODES:
        raise TypeError(f"kernel takes {list(DTYPE_CODES)}; got {dt}")
    if dtype != dt:
        raise TypeError(f"kernel output dtype must equal the input dtype "
                        f"{dt}; got {dtype}")
    for name, t in data:
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in indices:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    d = data[0][1].shape[-1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {SUPPORTED_HEAD_DIMS}; "
                         f"got {d}")
    return DTYPE_CODES[dt]


def raise_on_error(rc: int, name: str):
    if rc == -1:
        raise ValueError(f"{name}: no kernel for this dtype / head_dim")
    if rc == -2:
        raise ValueError(f"{name}: cuTensorMapEncodeTiled refused a TMA "
                         f"tensor map of an operand (alignment or strides)")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{rc}")


def stream_of(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _c_kernels():
    lib = build.load_library()
    dense = lib.adt_flash_decode_dense
    dense.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
    dense.restype = _I
    paged = lib.adt_flash_decode_paged
    paged.argtypes = [_P] * 6 + [_I] * 7 + [_F, _P]
    paged.restype = _I
    return dense, paged


# --------------------------------------------------------------------------- #
# wrappers
# --------------------------------------------------------------------------- #
def flash_decode_attention(q, k_layer, v_layer, lengths, *,
                           dtype=torch.float32):
    """Flash decode over dense cache lanes (K5).

    ``q``: ``[B, 1, heads, d]``; ``k_layer``/``v_layer``: ``[B, heads, T,
    d]`` (one layer's cache slice); ``lengths``: ``[B]`` int32, each
    ``>= 0``.  Returns ``[B, 1, heads, d]`` in ``dtype``."""
    B, _, H, d = q.shape
    T = k_layer.shape[2]
    check_shape(q, "q", (B, 1, H, d))
    check_shape(k_layer, "k_layer", (B, H, T, d))
    check_shape(v_layer, "v_layer", (B, H, T, d))
    check_shape(lengths, "lengths", (B,))
    if not on_cuda(q, k_layer, v_layer, lengths):
        return flash_decode_attention_plain(q, k_layer, v_layer, lengths,
                                            dtype=dtype)
    code = check_kernel_args(
        dtype, [("q", q), ("k_layer", k_layer), ("v_layer", v_layer)],
        [("lengths", lengths)])
    dense, _ = _c_kernels()
    out = torch.empty((B, 1, H, d), dtype=dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = dense(q.data_ptr(), k_layer.data_ptr(), v_layer.data_ptr(),
                   lengths.data_ptr(), out.data_ptr(), B, H, T, d, code,
                   1.0 / math.sqrt(d), stream_of(q))
    raise_on_error(rc, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


cuda_graph.counted(flash_decode_attention, "launches")


def flash_decode_attention_paged(q, k_pool, v_pool, lengths, block_table,
                                 *, block_len: int, dtype=torch.float32):
    """Flash decode over a paged pool (K6).

    ``q``: ``[B, 1, heads, d]``; ``k_pool``/``v_pool``: one layer's
    ``[num_blocks, heads, block_len, d]``; ``lengths``: ``[B]`` int32,
    each ``>= 0``; ``block_table``: ``[B, max_blocks]`` int32 with
    entries in ``[0, num_blocks)``.  Returns ``[B, 1, heads, d]`` in
    ``dtype``."""
    B, _, H, d = q.shape
    NB = k_pool.shape[0]
    mb = block_table.shape[1]
    check_shape(q, "q", (B, 1, H, d))
    check_shape(k_pool, "k_pool", (NB, H, block_len, d))
    check_shape(v_pool, "v_pool", (NB, H, block_len, d))
    check_shape(lengths, "lengths", (B,))
    check_shape(block_table, "block_table", (B, mb))
    if not on_cuda(q, k_pool, v_pool, lengths, block_table):
        return flash_decode_attention_paged_plain(
            q, k_pool, v_pool, lengths, block_table, block_len=block_len,
            dtype=dtype)
    code = check_kernel_args(
        dtype, [("q", q), ("k_pool", k_pool), ("v_pool", v_pool)],
        [("lengths", lengths), ("block_table", block_table)])
    _, paged = _c_kernels()
    out = torch.empty((B, 1, H, d), dtype=dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = paged(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   lengths.data_ptr(), block_table.data_ptr(),
                   out.data_ptr(), B, H, block_len, mb, NB, d, code,
                   1.0 / math.sqrt(d), stream_of(q))
    raise_on_error(rc, "flash_decode_attention_paged")
    flash_decode_attention_paged.launches += 1
    return out


cuda_graph.counted(flash_decode_attention_paged, "launches")
