"""Gradient compressors for the all-reduce synchronizer.

Counterpart of ``autodist_tpu/kernel/compressor.py``: the no-op mean,
the fp16 and bf16 casts, their error-feedback forms, the shared-scale
int8 all-reduce with error feedback, the int8-wire ring and rank-``r``
PowerSGD.  Each works on one flat fp32 bucket and an
:class:`~autodist_tpu_torch.parallel.axis.Axis`:
``allreduce(flat, state, axis) -> (mean, new_state)``, ``state`` this
rank's row of compressor state (``None`` for a stateless compressor;
:meth:`Compressor.init_state_flat` makes the first row, the same on
every rank).  Everything is composed torch ops and ``torch.distributed``
collectives, with no host read, so a step that runs them on NCCL
groups is captured whole in a CUDA graph; PowerSGD's Gram-Schmidt is
branch-free (``torch.where``) for that reason.

Numerics follow the JAX package step for step: the cast compressors
sum at the wire dtype and divide in fp32; the int8 ones use
:mod:`~autodist_tpu_torch.kernel.quantize`'s scale and levels (a true
division, half-to-even rounding); PowerSGD's first ``Q`` comes from
``np.random.RandomState(total % (2**31 - 1))``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from autodist_tpu_torch.kernel import quantize as qz


def _mean(summed, n: int):
    """``summed / n`` in fp32, a true division on ``summed``'s device."""
    return summed.float() / torch.full((), float(n), device=summed.device)


class Compressor:
    """Base and no-op: the exact mean over ``axis``."""

    name = "none"
    stateful = False

    def init_state_flat(self, total: int) -> np.ndarray:
        return np.zeros(total, np.float32)

    def allreduce(self, flat, state, axis):
        return _mean(axis.psum(flat), axis.size), state

    _registry: dict = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if getattr(cls, "name", None):
            Compressor._registry[cls.name] = cls

    @classmethod
    def parse_arg(cls, arg: str) -> dict:
        raise ValueError(
            f"compressor {cls.name!r} takes no ':{arg}' argument")

    @classmethod
    def create(cls, name: str, **kw) -> "Compressor":
        """By name: ``none`` (or ``""``/``None``), ``fp16``, ``bf16``,
        ``fp16_ef``, ``bf16_ef``, ``int8_ef``, ``int8_ring``,
        ``powersgd`` or ``powersgd:<rank>``."""
        if name in ("", "none", None):
            return Compressor()
        base, _, arg = name.partition(":")
        if base not in cls._registry:
            raise ValueError(
                f"unknown compressor {name!r}; have {sorted(cls._registry)}")
        sub = cls._registry[base]
        if arg:
            kw = {**kw, **sub.parse_arg(arg)}
        return sub(**kw)


class CastCompressor(Compressor):
    """The sum at a narrower wire dtype, the mean taken after in fp32."""

    name = "fp16"
    wire_dtype = torch.float16

    def allreduce(self, flat, state, axis):
        return _mean(axis.psum(flat.to(self.wire_dtype)), axis.size), state


class BF16CastCompressor(CastCompressor):
    name = "bf16"
    wire_dtype = torch.bfloat16


class _ErrorFeedback(Compressor):
    """Compress ``grad + residual``; what the wire form lost is the next
    step's residual."""

    name = None
    stateful = True

    def _wire(self, x):
        raise NotImplementedError

    def allreduce(self, flat, state, axis):
        corrected = qz.ef_correct(flat, state)
        wire = self._wire(corrected)
        return (_mean(axis.psum(wire), axis.size),
                qz.ef_residual(corrected, wire))


class FP16EFCompressor(_ErrorFeedback):
    name = "fp16_ef"

    def _wire(self, x):
        return x.to(torch.float16)


class BF16EFCompressor(_ErrorFeedback):
    name = "bf16_ef"

    def _wire(self, x):
        return x.to(torch.bfloat16)


class Int8EFCompressor(_ErrorFeedback):
    """Shared-scale int8 with error feedback: the ranks agree on a scale
    (a max), and the integer levels are summed on an fp16 wire (exact
    up to 16 full-scale ranks)."""

    name = "int8_ef"

    def allreduce(self, flat, state, axis):
        corrected = qz.ef_correct(flat, state)
        scale = qz.shared_scale(corrected, axis)
        q = qz.quantize_levels(corrected, scale)
        new_state = qz.ef_residual(corrected, q * scale)
        summed = axis.psum(q.to(torch.float16)).float() * scale
        return _mean(summed, axis.size), new_state


def _orthonormalize(p, rel_eps: float = 1e-5):
    """Modified Gram-Schmidt over the few columns of ``p``, branch-free:
    a column whose norm collapses against its norm before projection
    (dependent on the earlier ones) becomes zero instead of a unit junk
    direction."""
    cols = []
    for i in range(p.shape[1]):
        c0 = p[:, i]
        c = c0
        for cj in cols:
            c = c - torch.dot(cj, c) * cj
        norm = torch.linalg.vector_norm(c)
        keep = norm > rel_eps * (torch.linalg.vector_norm(c0) + 1e-30)
        cols.append(torch.where(keep, c / torch.clamp(norm, min=1e-30),
                                torch.zeros_like(c)))
    return torch.stack(cols, dim=1)


class PowerSGDCompressor(Compressor):
    """Rank-``r`` PowerSGD with error feedback and a warm-started ``Q``
    (Vogels et al., NeurIPS 2019): the bucket as a near-square ``[nrow,
    m]`` matrix ``M``, ``P = mean(M Q)`` orthonormalized, ``Q' =
    mean(Mᵀ P)``, the approximation ``P Q'ᵀ``; the wire carries ``(nrow
    + m) r`` values.  The state row is the residual, then ``Q``.  Name
    ``powersgd`` (rank 2) or ``powersgd:<rank>``."""

    name = "powersgd"
    stateful = True

    def __init__(self, rank: int = 2):
        if rank < 1:
            raise ValueError("powersgd rank must be >= 1")
        self.rank = rank

    @classmethod
    def parse_arg(cls, arg: str) -> dict:
        return {"rank": int(arg)}

    @staticmethod
    def _dims(total: int) -> tuple:
        nrow = max(1, math.isqrt(max(total - 1, 0)) + 1)       # ceil(sqrt)
        return nrow, -(-total // nrow)

    def init_state_flat(self, total: int) -> np.ndarray:
        _, m = self._dims(total)
        rng = np.random.RandomState(total % (2 ** 31 - 1))
        q = rng.randn(m, self.rank).astype(np.float32)
        q /= np.maximum(np.linalg.norm(q, axis=0, keepdims=True), 1e-8)
        return np.concatenate([np.zeros(total, np.float32), q.reshape(-1)])

    def allreduce(self, flat, state, axis):
        total = flat.numel()
        nrow, m = self._dims(total)
        residual, q = state[:total], state[total:].view(m, self.rank)
        corrected = flat.float() + residual
        mat = F.pad(corrected, (0, nrow * m - total)).view(nrow, m)
        p = _orthonormalize(axis.pmean(mat @ q))            # wire: nrow r
        q = axis.pmean(mat.T @ p)                           # wire: m r
        approx = (p @ q.T).reshape(-1)[:total]
        return approx, torch.cat([corrected - approx, q.reshape(-1)])


def _pack(q, s):
    """One ring message: the fp32 scale's 4 bytes, then the levels."""
    return torch.cat([s.reshape(1).view(torch.int8), q])


def _unpack(msg):
    return msg[4:], msg[:4].view(torch.float32)[0]


class Int8RingCompressor(Compressor):
    """The int8-wire ring all-reduce: every byte on the wire is an int8
    level (plus one fp32 scale a chunk and hop).  A ring reduce-scatter
    of ``p - 1`` hops, each dequantizing the arriving partial sum,
    adding this rank's chunk and requantizing, then a ring all-gather of
    the owned chunks quantized once.  Error feedback keeps each rank's
    own first quantization error; the hops' requantization noise is
    not fed back.  The hops are :meth:`Axis.ppermute` (a paired
    ``batch_isend_irecv``)."""

    name = "int8_ring"
    stateful = True

    def allreduce(self, flat, state, axis):
        p, me = axis.size, axis.index
        total = flat.numel()
        corrected = flat.float() + state
        if p == 1:
            return corrected, torch.zeros_like(state)
        chunk = -(-total // p)
        rows = F.pad(corrected, (0, p * chunk - total)).view(p, chunk)
        s0 = qz._scale_of(rows.abs().amax(1))
        q0 = qz.quantize_levels(rows, s0[:, None]).to(torch.int8)
        deq0 = q0.float() * s0[:, None]
        new_state = (rows - deq0).reshape(-1)[:total]
        # Ring reduce-scatter: at hop h this rank forwards the partial
        # sum of chunk (me - h) mod p and receives chunk (me - h - 1).
        msg = _pack(q0[me], s0[me])
        for h in range(p - 1):
            q, s = _unpack(axis.ppermute(msg))
            acc = q.float() * s + deq0[(me - h - 1) % p]
            q, s = qz.quantize_int8(acc)
            msg = _pack(q, s)
        # acc: the fp32 sum of chunk (me + 1) mod p; msg its levels.
        arrivals = [_unpack(msg)]
        for _ in range(p - 1):
            msg = axis.ppermute(msg)
            arrivals.append(_unpack(msg))
        # Arrival k holds chunk (me - k + 1) mod p; position j takes
        # arrival (me + 1 - j) mod p.
        ordered = [arrivals[(me + 1 - j) % p] for j in range(p)]
        out = (torch.stack([q for q, _ in ordered]).float()
               * torch.stack([s for _, s in ordered])[:, None])
        return _mean(out.reshape(-1)[:total], p), new_state
