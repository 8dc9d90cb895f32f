"""Paged flash prefill: a prompt chunk's causal attention over the pool.

Counterpart of ``autodist_tpu/kernel/pallas/flash_prefill.py``.
:func:`flash_prefill_attention_paged` (K7) keeps the JAX function's
signature and layouts: ``q [B, C, heads, d]`` — one chunk's queries,
row ``r`` of slot ``b`` at absolute position ``starts[b] + r`` —
against one layer's pools ``[num_blocks, heads, block_len, d]`` routed
by ``block_table [B, max_blocks]``.  Row ``r`` sees keys at positions
``<= starts[b] + r``: earlier chunks and this chunk's own rows, which
the caller writes first.

On CUDA tensors the wrapper launches the kernel of
``csrc/flash_prefill.cu`` and counts the launch in its ``launches``
attribute; on CPU tensors it runs the plain version, with the same
numerics (fp32 scores, fp32 probabilities times fp32 values, one cast
to ``dtype``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from autodist_tpu_torch.kernel import build
from autodist_tpu_torch.kernel.flash_decode import (check_kernel_args,
                                                    check_shape,
                                                    gather_lanes, on_cuda,
                                                    plain_attention,
                                                    raise_on_error,
                                                    stream_of)


def flash_prefill_attention_paged_plain(q, k_pool, v_pool, starts,
                                        block_table, *, block_len: int,
                                        dtype=torch.float32):
    """Plain PyTorch version of :func:`flash_prefill_attention_paged`."""
    del block_len  # implied by the pool's block extent
    C = q.shape[1]
    k = gather_lanes(k_pool, block_table)
    v = gather_lanes(v_pool, block_table)
    pos = torch.arange(k.shape[2], device=q.device)
    rows = starts.long()[:, None] + torch.arange(C, device=q.device)
    visible = pos[None, None, :] <= rows[:, :, None]      # [B, C, T]
    return plain_attention(q, k, v, visible, dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _c_kernels():
    prefill = build.load_library().adt_flash_prefill_paged
    prefill.argtypes = [_P] * 6 + [_I] * 8 + [_F, _P]
    prefill.restype = _I
    return prefill


def flash_prefill_attention_paged(q, k_pool, v_pool, starts, block_table,
                                  *, block_len: int, dtype=torch.float32):
    """Paged flash prefill (K7).

    ``q``: ``[B, C, heads, d]``; ``k_pool``/``v_pool``: one layer's
    ``[num_blocks, heads, block_len, d]``; ``starts``: ``[B]`` int32,
    each ``>= 0``; ``block_table``: ``[B, max_blocks]`` int32 with
    entries in ``[0, num_blocks)``.  Returns ``[B, C, heads, d]`` in
    ``dtype``."""
    B, C, H, d = q.shape
    NB = k_pool.shape[0]
    mb = block_table.shape[1]
    check_shape(k_pool, "k_pool", (NB, H, block_len, d))
    check_shape(v_pool, "v_pool", (NB, H, block_len, d))
    check_shape(starts, "starts", (B,))
    check_shape(block_table, "block_table", (B, mb))
    if not on_cuda(q, k_pool, v_pool, starts, block_table):
        return flash_prefill_attention_paged_plain(
            q, k_pool, v_pool, starts, block_table, block_len=block_len,
            dtype=dtype)
    code = check_kernel_args(
        dtype, [("q", q), ("k_pool", k_pool), ("v_pool", v_pool)],
        [("starts", starts), ("block_table", block_table)])
    prefill = _c_kernels()
    out = torch.empty((B, C, H, d), dtype=dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = prefill(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                     starts.data_ptr(), block_table.data_ptr(),
                     out.data_ptr(), B, C, H, block_len, mb, NB, d, code,
                     1.0 / math.sqrt(d), stream_of(q))
    raise_on_error(rc, "flash_prefill_attention_paged")
    flash_prefill_attention_paged.launches += 1
    return out


flash_prefill_attention_paged.launches = 0
