"""The port's attention kernels and KV-cache writers against the JAX package.

Inputs come from a numpy seed and go to both sides.  On the CPU each
kernel wrapper runs its plain PyTorch version, which is held here to the
JAX package's Pallas kernel (interpreter mode) and to its composed
fallback at atol = rtol = 1e-5 (both sides compute in fp32; only the
summation order differs).  The cache writers are held to the JAX writers
bit for bit, at the edges where JAX clamps instead of raising.  The
CUDA kernels themselves run only on the card, in
``tests/test_torch_cuda.py``.

JAX kernel modules are imported inside the tests, as the JAX package's
own tests do, so that the TPU-import collection guard stays quiet.
"""
import ast
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu_torch.kernel import build
from autodist_tpu_torch.kernel import flash_decode as fd
from autodist_tpu_torch.kernel import flash_prefill as fp
from autodist_tpu_torch.serving import kv_cache as tkv

TOL = dict(atol=1e-5, rtol=1e-5)


def _pair(a):
    """The same numpy array as a JAX array and a torch tensor."""
    return jnp.asarray(a), torch.as_tensor(a)


# --------------------------------------------------------------------------- #
# K5: dense flash decode
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("lengths,block_k", [([0, 3, 56], 16),
                                             ([1, 15, 16], 16),
                                             ([55, 2, 30], 13)])
def test_flash_decode_plain_matches_jax(lengths, block_k):
    """The wrapper's CPU path (the plain version) equals the Pallas
    kernel and the composed ``cached_attention`` at slot lengths shorter
    than a block, on block boundaries and near the full lane (T = 57
    divides neither key block)."""
    from autodist_tpu.kernel.pallas.flash_decode import \
        flash_decode_attention
    from autodist_tpu.serving.kv_cache import cached_attention

    B, H, T, d = 3, 2, 57, 8
    r = np.random.RandomState(0)
    qj, qt = _pair(r.randn(B, 1, H, d).astype(np.float32))
    kj, kt = _pair(r.randn(B, H, T, d).astype(np.float32))
    vj, vt = _pair(r.randn(B, H, T, d).astype(np.float32))
    lj, lt = _pair(np.asarray(lengths, np.int32))
    fd.flash_decode_attention.launches = 0
    got = fd.flash_decode_attention(qt, kt, vt, lt).numpy()
    assert fd.flash_decode_attention.launches == 0      # CPU: no launch
    want = flash_decode_attention(qj, kj, vj, lj, block_k=block_k)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, np.asarray(cached_attention(qj, kj, vj,
                                                                lj)), **TOL)
    # the port's own composed path equals the JAX one
    np.testing.assert_allclose(tkv.cached_attention(qt, kt, vt, lt).numpy(),
                               np.asarray(cached_attention(qj, kj, vj, lj)),
                               **TOL)


def test_flash_decode_never_reads_masked_values():
    """A stale non-finite row behind a slot's length (an earlier
    occupant's over-decode) does not reach the output: the kernel never
    reads masked keys, and the plain version zeroes them."""
    r = np.random.RandomState(1)
    q = torch.as_tensor(r.randn(2, 1, 2, 8).astype(np.float32))
    k = torch.as_tensor(r.randn(2, 2, 10, 8).astype(np.float32))
    v = torch.as_tensor(r.randn(2, 2, 10, 8).astype(np.float32))
    lengths = torch.tensor([3, 9], dtype=torch.int32)
    clean = fd.flash_decode_attention(q, k, v, lengths)
    k[0, :, 9] = float("nan")
    v[0, :, 9] = float("nan")
    torch.testing.assert_close(fd.flash_decode_attention(q, k, v, lengths)[0],
                               clean[0], atol=0, rtol=0)


# --------------------------------------------------------------------------- #
# K6: paged flash decode
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("lengths", [[0, 1, 5], [15, 16, 17], [32, 47, 63]])
def test_paged_flash_decode_plain_matches_jax(lengths):
    """Shorter than one block, on a block boundary, one past it, and
    the full padded extent — against the paged Pallas kernel and the
    composed gather path."""
    from autodist_tpu.kernel.pallas.flash_decode import \
        flash_decode_attention_paged
    from autodist_tpu.serving.kv_cache import paged_cached_attention

    r = np.random.RandomState(1)
    B, H, d, bl, nb, mb = 3, 2, 8, 16, 13, 4
    kj, kt = _pair(r.randn(nb, H, bl, d).astype(np.float32))
    vj, vt = _pair(r.randn(nb, H, bl, d).astype(np.float32))
    qj, qt = _pair(r.randn(B, 1, H, d).astype(np.float32))
    tj, tt = _pair(r.randint(0, nb, (B, mb)).astype(np.int32))
    lj, lt = _pair(np.asarray(lengths, np.int32))
    got = fd.flash_decode_attention_paged(qt, kt, vt, lt, tt,
                                          block_len=bl).numpy()
    assert fd.flash_decode_attention_paged.launches == 0
    np.testing.assert_allclose(got, np.asarray(flash_decode_attention_paged(
        qj, kj, vj, lj, tj, block_len=bl, interpret=True)), **TOL)
    np.testing.assert_allclose(got, np.asarray(paged_cached_attention(
        qj, kj, vj, lj, tj, block_len=bl)), **TOL)


# --------------------------------------------------------------------------- #
# K7: paged flash prefill
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("starts", [[0, 0, 0], [0, 4, 17], [3, 12, 20]])
def test_paged_flash_prefill_plain_matches_jax(starts):
    """Per-slot chunk starts (row ``r`` of slot ``b`` sees keys ``<=
    starts[b] + r``), including a chunk that reaches past the pool's
    logical extent, against the Pallas kernel and the composed path."""
    from autodist_tpu.kernel.pallas.flash_prefill import \
        flash_prefill_attention_paged
    from autodist_tpu.serving.kv_cache import paged_chunk_attention

    r = np.random.RandomState(2)
    B, C, H, d, bl, nb, mb = 3, 8, 2, 8, 4, 17, 6
    kj, kt = _pair(r.randn(nb, H, bl, d).astype(np.float32))
    vj, vt = _pair(r.randn(nb, H, bl, d).astype(np.float32))
    qj, qt = _pair(r.randn(B, C, H, d).astype(np.float32))
    tj, tt = _pair(r.randint(0, nb, (B, mb)).astype(np.int32))
    sj, st = _pair(np.asarray(starts, np.int32))
    got = fp.flash_prefill_attention_paged(qt, kt, vt, st, tt,
                                           block_len=bl).numpy()
    assert fp.flash_prefill_attention_paged.launches == 0
    np.testing.assert_allclose(got, np.asarray(flash_prefill_attention_paged(
        qj, kj, vj, sj, tj, block_len=bl, interpret=True)), **TOL)
    np.testing.assert_allclose(got, np.asarray(paged_chunk_attention(
        qj, kj, vj, sj, tj, block_len=bl)), **TOL)
    np.testing.assert_allclose(
        tkv.paged_chunk_attention(qt, kt, vt, st, tt, block_len=bl).numpy(),
        np.asarray(paged_chunk_attention(qj, kj, vj, sj, tj, block_len=bl)),
        **TOL)


@pytest.mark.parametrize("bad", ["shape", "device"])
def test_wrappers_reject_what_no_path_takes(bad):
    q = torch.zeros(2, 1, 2, 8)
    k = torch.zeros(2, 2, 5, 8)
    lengths = torch.zeros(2, dtype=torch.int32)
    if bad == "shape":
        with pytest.raises(ValueError, match="v_layer"):
            fd.flash_decode_attention(q, k, torch.zeros(2, 2, 6, 8), lengths)
    else:
        with pytest.raises(ValueError, match="several devices"):
            fd.flash_decode_attention(q, k, k.to("meta"), lengths)


# --------------------------------------------------------------------------- #
# cache writers: bit for bit against JAX, edges included
# --------------------------------------------------------------------------- #
def _both(fn_j, fn_t, cache, *args):
    """Run a JAX writer and its port on the same cache and inputs."""
    want = np.asarray(fn_j(jnp.asarray(cache), *[
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    got = fn_t(torch.as_tensor(cache.copy()), *[
        torch.as_tensor(a) if isinstance(a, np.ndarray) else a
        for a in args]).numpy()
    np.testing.assert_array_equal(got, want)


def test_write_token_clamps_past_the_lane():
    """``pos >= T`` lands at ``T - 1`` (``dynamic_update_slice``
    clamps its start)."""
    from autodist_tpu.serving import kv_cache as jkv

    r = np.random.RandomState(3)
    cache = r.randn(2, 3, 2, 6, 4).astype(np.float32)
    kv = r.randn(3, 1, 2, 4).astype(np.float32)
    _both(jkv.write_token, tkv.write_token, cache, 1, kv,
          np.asarray([0, 6, 9], np.int32))


def test_write_prompt_keeps_non_admitted_slots():
    from autodist_tpu.serving import kv_cache as jkv

    r = np.random.RandomState(4)
    cache = r.randn(2, 3, 2, 6, 4).astype(np.float32)
    kv = r.randn(3, 4, 2, 4).astype(np.float32)
    _both(jkv.write_prompt, tkv.write_prompt, cache, 0, kv,
          np.asarray([True, False, True]))


@pytest.mark.parametrize("case", ["masked", "past_table", "no_mask"])
def test_paged_write_token_matches_jax(case):
    """``write_mask=False`` keeps the target (slot 2's unreserved row
    points at block 0, slot 0's live block); ``pos // bl >= max_blocks``
    clamps to the row's last column; with no mask, two slots hitting one
    target resolve as the JAX loop does (the later slot wins)."""
    from autodist_tpu.serving import kv_cache as jkv

    r = np.random.RandomState(5)
    cache = r.randn(2, 6, 2, 4, 3).astype(np.float32)
    kv = r.randn(3, 1, 2, 3).astype(np.float32)
    table = np.asarray([[0, 1, 2], [3, 4, 4], [0, 0, 0]], np.int32)
    pos = {"masked": [1, 5, 1], "past_table": [2, 13, 0],
           "no_mask": [1, 5, 1]}[case]
    mask = None if case == "no_mask" else np.asarray([True, True, False])
    _both(lambda c, *a: jkv.paged_write_token(c, *a, write_mask=None
                                              if mask is None else
                                              jnp.asarray(mask)),
          lambda c, *a: tkv.paged_write_token(c, *a, write_mask=None
                                              if mask is None else
                                              torch.as_tensor(mask)),
          cache, 1, kv, np.asarray(pos, np.int32), table, 4)


@pytest.mark.parametrize("case", ["bucket", "shared_target"])
def test_paged_write_prompt_matches_jax(case):
    """Block-granular prompt writes.  ``bucket``: a bucket of 10 over
    blocks of 4 (partial last block), a slot whose prompt ends inside a
    block (that block written whole, the next untouched), a non-admitted
    slot whose table row points into another slot's blocks.
    ``shared_target``: two admitted slots whose rows route into the same
    pool blocks (the later slot wins, as in the JAX loop) and an
    admitted slot with an empty prompt (writes nothing)."""
    from autodist_tpu.serving import kv_cache as jkv

    r = np.random.RandomState(6)
    cache = r.randn(2, 9, 2, 4, 3).astype(np.float32)
    kv = r.randn(3, 10, 2, 3).astype(np.float32)
    if case == "bucket":
        table = [[0, 1, 2, 3], [4, 5, 5, 5], [1, 2, 0, 0]]
        admit, p_lens = [True, True, False], [10, 5, 7]
    else:
        table = [[0, 1, 2, 3], [6, 1, 2, 2], [7, 7, 7, 7]]
        admit, p_lens = [True, True, True], [10, 9, 0]
    _both(jkv.paged_write_prompt, tkv.paged_write_prompt, cache, 0, kv,
          np.asarray(admit), np.asarray(table, np.int32), 4,
          np.asarray(p_lens, np.int32))


@pytest.mark.parametrize("chunk_start", [0, 4, 8])
def test_paged_write_chunk_matches_jax(chunk_start):
    """One chunk of 4 rows at each start: the slot whose prompt ended
    earlier writes nothing, a chunk past the table clamps to its last
    column (and writes nothing there)."""
    from autodist_tpu.serving import kv_cache as jkv

    r = np.random.RandomState(7)
    cache = r.randn(2, 7, 2, 4, 3).astype(np.float32)
    kv = r.randn(2, 4, 2, 3).astype(np.float32)
    table = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    _both(jkv.paged_write_chunk, tkv.paged_write_chunk, cache, 1, kv,
          np.asarray([True, True]), table, 4, chunk_start,
          np.asarray([10, 3], np.int32))


def test_blocks_for_and_allocator_match_jax():
    from autodist_tpu.serving import kv_cache as jkv

    for n, bl in [(0, 4), (1, 4), (16, 16), (17, 16), (1023, 16)]:
        assert tkv.blocks_for(n, bl) == jkv.blocks_for(n, bl)
    ja, ta = jkv.BlockAllocator(5), tkv.BlockAllocator(5)
    assert ja.alloc(3) == ta.alloc(3)
    assert ja.free([1]) == ta.free([1])
    assert ja.alloc(2) == ta.alloc(2)          # LIFO reuse of block 1
    assert (ja.free_blocks, ja.used_blocks) == (ta.free_blocks,
                                                ta.used_blocks)
    with pytest.raises(tkv.PoolExhaustedError, match="kv_pool_exhausted"):
        ta.alloc(2)
    ta.free([1])
    with pytest.raises(ValueError, match="double-free"):
        ta.free([1])


# --------------------------------------------------------------------------- #
# the build: CUDA sources, flags, content hash
# --------------------------------------------------------------------------- #
def test_build_targets_sm90a_and_hashes_sources():
    assert [s.name for s in build.sources()] == ["flash_decode.cu",
                                                 "flash_prefill.cu"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.source_hash() == build.source_hash()
    for src in build.sources():
        head = src.read_text().split("#include")[0]
        assert "Replaces: autodist_tpu/kernel/pallas/" in head
        assert "Bound on this card" in head
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc") and not os.environ.get("CUDA_HOME"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.find_nvcc()


def test_wrappers_have_no_fallback_path():
    """A wrapper's only route to the plain version is a CPU tensor: no
    ``try`` in the kernel modules could swallow a failed launch."""
    for mod in (fd, fp):
        tree = ast.parse(open(mod.__file__).read())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
