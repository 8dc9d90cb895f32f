"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel replaces one Pallas TPU kernel of the JAX package:

* :mod:`~autodist_tpu_torch.kernel.flash_decode` — dense and paged
  flash decode (``autodist_tpu/kernel/pallas/flash_decode.py``);
* :mod:`~autodist_tpu_torch.kernel.flash_prefill` — paged flash
  prefill (``autodist_tpu/kernel/pallas/flash_prefill.py``);
* :mod:`~autodist_tpu_torch.kernel.quant_ring` — the quantized ring
  all-reduce's fused hop (``autodist_tpu/kernel/pallas/quant_ring.py``);
* :mod:`~autodist_tpu_torch.kernel.collective_matmul` — the
  collective-matmul ring's fused step
  (``autodist_tpu/kernel/pallas/collective_matmul.py``).

The flash-attention kernels of ``autodist_tpu/ops/flash_attention.py``
live in :mod:`autodist_tpu_torch.ops.flash_attention`.

The CUDA sources live in ``csrc/`` and are compiled by
:mod:`~autodist_tpu_torch.kernel.build` the first time a CUDA tensor
reaches a wrapper.  A wrapper given CPU tensors runs the kernel's plain
PyTorch version instead (the CPU tests' path); given CUDA tensors it
launches the kernel or raises — it never falls back.
"""
from __future__ import annotations

# The Strategy IR's kernel-slot vocabulary, copied from
# ``autodist_tpu/kernel/pallas/__init__.py`` so that an election names
# the same kernels in both packages.
KERNEL_CHOICES = ("flash_decode", "flash_prefill", "quant_ring",
                  "collective_matmul", "a2a_ring")

# Finite mask value shared by every kernel and plain version: with
# ``-inf`` a fully masked tile would give ``inf - inf = NaN``.
NEG_INF = -3.4028234663852886e38     # float32 finfo.min
