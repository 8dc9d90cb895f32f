"""K4's staging decision for TMA, on CPU tensors.

The bf16 collective-matmul kernel reads ``x`` and ``k`` through TMA
tensor maps, which need a 16-byte aligned start and a row pitch of a
16-byte multiple.  ``collective_matmul.tma_operands`` decides which
operands can be read in place and copies the others into zero-padded
aligned buffers; the decision and the copies are plain tensor code, so
they are held here without a card.
"""
import numpy as np
import pytest
import torch

from autodist_tpu_torch.kernel import collective_matmul as cm


def _operands(M, K, C, ldk, x_offset=0):
    """bf16 ``carry [M, C]``, ``x [M, K]`` (starting ``x_offset``
    elements into its buffer) and ``k``, the last C columns of a ``[K,
    ldk]`` matrix, from a numpy seed."""
    rng = np.random.RandomState(M + K + C + ldk + x_offset)

    def bf16(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()

    x = bf16(M * K + x_offset)[x_offset:].view(M, K)
    return bf16(M, C), x, bf16(K, ldk)[:, ldk - C:]


@pytest.mark.parametrize("K", [512, 2048])
def test_main_path_operands_need_no_staging(K):
    """The tensor-parallel window's hops: x [4096, K] contiguous, k the
    chunk [K, 512] of a [K, 1024] shard, read where they lie."""
    _, x, k = _operands(4096, K, 512, 1024)
    assert cm.tma_ready(x) and cm.tma_ready(k)
    x2, k2, staged = cm.tma_operands(x, k)
    assert not staged and x2 is x and k2 is k


@pytest.mark.parametrize("M,K,C,ldk,x_offset", [
    (100, 70, 38, 76, 0),    # x's pitch 140 bytes, k starts 76 bytes in
    (100, 72, 38, 76, 0),    # k's pitch 152 bytes
    (100, 72, 36, 76, 0),    # k starts 80 bytes in, pitch 152 bytes
    (100, 72, 40, 80, 4),    # x starts 8 bytes in
    (3, 5, 4, 4, 0),         # K below 8
])
def test_unaligned_operands_are_staged_with_zero_padding(M, K, C, ldk,
                                                         x_offset):
    """Operands TMA cannot read in place are copied into aligned buffers
    whose K padding is zeros; the plain product of the padded operands
    equals that of the originals bit for bit."""
    carry, x, k = _operands(M, K, C, ldk, x_offset)
    assert not (cm.tma_ready(x) and cm.tma_ready(k) and K % 8 == 0)
    x2, k2, staged = cm.tma_operands(x, k)
    assert staged
    Kp = max(8, -(-K // 8) * 8)
    assert x2.shape == (M, Kp) and k2.shape == (Kp, C)
    assert cm.tma_ready(x2) and cm.tma_ready(k2)
    assert torch.equal(x2[:, :K], x) and torch.equal(k2[:K], k)
    assert not x2[:, K:].any() and not k2[K:].any()
    assert torch.equal(cm.fused_matmul_add_plain(carry, x2, k2),
                       cm.fused_matmul_add_plain(carry, x, k))


def test_aligned_operand_keeps_its_storage_when_the_other_is_staged():
    """Only the operand that needs it is copied when K is a multiple of
    8: an aligned x stays, a k with an unaligned start is staged."""
    _, x, k = _operands(64, 72, 36, 76)
    x2, k2, staged = cm.tma_operands(x, k)
    assert staged and x2 is x and k2 is not k


def test_cpu_tensors_take_the_plain_version_without_staging():
    """On the CPU the wrapper runs the plain version on the operands as
    they are: nothing is staged or counted."""
    carry, x, k = _operands(100, 70, 38, 76)
    staged, launches = cm.fused_matmul_add.staged, cm.fused_matmul_add.launches
    got = cm.fused_matmul_add(carry, x, k)
    assert torch.equal(got, cm.fused_matmul_add_plain(carry, x, k))
    assert cm.fused_matmul_add.staged == staged
    assert cm.fused_matmul_add.launches == launches
