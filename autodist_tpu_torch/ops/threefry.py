"""The threefry2x32 counter-based hash, bit for bit as ``jax.random``
computes it under ``jax_default_prng_impl = threefry2x32`` and
``jax_threefry_partitionable = True``.

The serving sampler keys every draw on ``(seed, position, global vocab
row)`` alone (:func:`~autodist_tpu_torch.parallel.tensor
.vocab_parallel_sample_token`), so a sampled stream is the same on any
tensor-parallel split, run alone or interleaved, and against the JAX
package's engine on the same weights.  That needs the JAX package's
hash, not a ``torch.Generator``: this module reproduces

* :func:`fold_in` — ``jax.random.fold_in(key, data)``:
  ``threefry2x32(key, (0, data))``;
* :func:`random_bits32` — ``jax.random.bits`` of one uint32 under the
  partitionable flag: the hash of counter ``(0, 0)``, its two words
  xor-ed;
* :func:`uniform` — ``jax.random.uniform(key, (), float32, minval,
  maxval)`` (or of shape ``(num,)``, one hash a counter ``(0, i)``):
  the top 23 bits as a mantissa under exponent 0 (a float in
  ``[1, 2)``), minus 1, scaled and shifted with one rounding (XLA's
  fused multiply-add), then ``max(minval, .)``.

A key is a pair ``(k0, k1)`` of int64 tensors of one shape, each word
held in the low 32 bits: torch's uint32 arithmetic is thin, so every
sum and shift runs on int64 and is masked back to 32 bits.  Everything
is elementwise, with no host sync and no host-to-device copy, so the
hash runs inside a captured CUDA graph.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block of ``jax.random``'s
    ``threefry2x32_p`` on 32-bit words held in int64 tensors
    (broadcast together).  Returns the two output words."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed=0, device=None):
    """``jax.random.PRNGKey(seed)`` for a seed in ``[0, 2**32)``: an
    integer, or an integer tensor (read on the device, so a captured
    graph re-reads it at every replay)."""
    if isinstance(seed, torch.Tensor):
        word = seed.to(torch.int64) & _MASK
    else:
        word = torch.full((), int(seed) & _MASK, dtype=torch.int64,
                          device=device)
    return torch.zeros_like(word), word


def fold_in(key_pair, data):
    """``jax.random.fold_in``: a new key from ``key_pair`` and integer
    ``data`` (any integer tensor, taken modulo ``2**32`` as JAX's
    ``uint32`` conversion does); broadcasts."""
    k0, k1 = key_pair
    data = data.to(torch.int64) & _MASK
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def random_bits32(key_pair):
    """One uint32 a key (``jax.random.bits(key, (), uint32)`` under the
    partitionable flag), as int64."""
    k0, k1 = key_pair
    zero = torch.zeros_like(k0)
    y0, y1 = threefry2x32(k0, k1, zero, zero)
    return y0 ^ y1


def bits_at(key_pair, hi, lo):
    """One uint32 a counter ``(hi, lo)`` under a key (as int64): the two
    words of ``threefry2x32(key, (hi, lo))`` xor-ed, which at ``(0, 0)``
    is :func:`random_bits32`.  A stream of counters draws a tensor of
    bits under one key with one hash an element."""
    k0, k1 = key_pair
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return y0 ^ y1


def uniform(key_pair, minval: float, maxval: float, num=None):
    """``jax.random.uniform(key, (), float32, minval, maxval)`` a key,
    bit for bit (float32); with ``num``, ``jax.random.uniform(key,
    (num,), ...)`` of one key (counter ``(0, i)`` for element ``i``)."""
    if num is None:
        bits = random_bits32(key_pair)
    else:
        lo = torch.arange(num, dtype=torch.int64, device=key_pair[0].device)
        bits = bits_at(key_pair, torch.zeros_like(lo), lo)
    mantissa = (bits >> 9) | 0x3F800000            # 1.0's exponent
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0
    dev = floats.device
    lo = torch.full((), minval, dtype=torch.float32, device=dev)
    scale = torch.full((), maxval, dtype=torch.float32, device=dev) - lo
    # XLA fuses ``floats * scale + lo`` into one rounding (a fused
    # multiply-add).  In float64 the product and the sum are exact for
    # minval, maxval in [0, 1] (at most 47 significant bits), so the one
    # cast to float32 is that single rounding.
    fused = (floats.double() * scale.double() + lo.double()).float()
    return torch.maximum(lo, fused)
