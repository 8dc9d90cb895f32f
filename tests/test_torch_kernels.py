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
import importlib
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu_torch.kernel import a2a_ring as ar
from autodist_tpu_torch.kernel import build
from autodist_tpu_torch.kernel import collective_matmul as cm
from autodist_tpu_torch.kernel import flash_decode as fd
from autodist_tpu_torch.kernel import flash_prefill as fp
from autodist_tpu_torch.kernel import quant_ring as qr
from autodist_tpu_torch.serving import kv_cache as tkv
from test_torch_cuda import PREFILL_CHUNKS, prefill_edge_inputs, with_nan

fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")

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
# K5 and K6 at the CUDA kernel's tile and chunk edges
# --------------------------------------------------------------------------- #
# (lengths, extent, heads, paged block length): lengths at the edges of
# the CUDA kernel's chunks (48, 64, 96 and 128 keys at fp32 / bf16, paged
# / dense) +- 1, 0 and the extent's end; one long slot among short ones;
# an extent that is not a multiple of a chunk (paged: 5 blocks of 14
# rows); a long extent that a block walks in many chunks.
DECODE_EDGE_CASES = {
    "chunk_edges": ([0, 47, 48, 49, 63, 64, 65, 95, 96, 97, 127, 128, 129,
                     255, 256, 257, 1023], 1024, 1, 16),
    "one_long_slot": ([1023, 3, 0, 5, 17, 2, 9, 1], 1024, 2, 16),
    "ragged_extent": ([0, 17, 69], 70, 2, 14),
    "long_extent": ([2047, 700], 2048, 1, 16),
}


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("case", sorted(DECODE_EDGE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_plain_matches_jax_at_kernel_edges(dtype, case, layout):
    """The CPU path (the plain version the CUDA kernel is held to on the
    card) equals the Pallas kernel at the CUDA kernel's edge cases, at
    fp32 (atol = rtol = 1e-5) and bf16 (1e-2), with NaN written into
    every K and V row that no slot sees (the JAX side gets the clean
    rows: the plain version must not read what it masks)."""
    from autodist_tpu.kernel.pallas.flash_decode import (
        flash_decode_attention, flash_decode_attention_paged)

    lengths, T, H, bl = DECODE_EDGE_CASES[case]
    B, d = len(lengths), 64
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 \
        else dict(atol=1e-2, rtol=1e-2)
    r = np.random.RandomState(3)
    q = r.randn(B, 1, H, d).astype(np.float32)
    lj, lt = _pair(np.asarray(lengths, np.int32))
    if layout == "dense":
        k, v = (r.randn(B, H, T, d).astype(np.float32) for _ in range(2))
        stale = np.arange(T)[None, :] > np.asarray(lengths)[:, None]  # [B, T]
        kn, vn = k.copy(), v.copy()
        kn.transpose(0, 2, 1, 3)[stale] = np.nan
        vn.transpose(0, 2, 1, 3)[stale] = np.nan
        want = flash_decode_attention(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            lj, interpret=True)
        got = fd.flash_decode_attention(
            *(torch.as_tensor(a).to(dtype) for a in (q, kn, vn)), lt,
            dtype=dtype)
    else:
        mb = -(-T // bl)
        nb = B * mb + 3
        table = r.permutation(nb)[:B * mb].reshape(B, mb).astype(np.int32)
        k, v = (r.randn(nb, H, bl, d).astype(np.float32) for _ in range(2))
        seen = np.zeros((nb, bl), bool)
        for b, n in enumerate(lengths):
            pos = np.arange(min(n + 1, mb * bl))
            seen[table[b, pos // bl], pos % bl] = True
        kn, vn = k.copy(), v.copy()
        kn.transpose(0, 2, 1, 3)[~seen] = np.nan
        vn.transpose(0, 2, 1, 3)[~seen] = np.nan
        tj, tt = _pair(table)
        want = flash_decode_attention_paged(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            lj, tj, block_len=bl, interpret=True)
        got = fd.flash_decode_attention_paged(
            *(torch.as_tensor(a).to(dtype) for a in (q, kn, vn)), lt, tt,
            block_len=bl, dtype=dtype)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


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


@pytest.mark.parametrize("bl", [8, 16, 24])
@pytest.mark.parametrize("C", PREFILL_CHUNKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_flash_prefill_plain_matches_jax_at_kernel_edges(dtype, C, bl):
    """The CPU path (the plain version the CUDA kernels are held to on
    the card) equals the Pallas kernel and the composed
    ``paged_chunk_attention`` at the tensor-core kernel's row-group, tile
    and box edges (blocks of 8 and 16; 24 is the CUDA-core instance's at
    bf16), at fp32 (atol = rtol = 1e-5) and bf16 (1e-2), with NaN
    in every pool row that no chunk row sees (the JAX side gets the clean
    rows: the plain version must not read what it masks)."""
    from autodist_tpu.kernel.pallas.flash_prefill import \
        flash_prefill_attention_paged
    from autodist_tpu.serving.kv_cache import paged_chunk_attention

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 \
        else dict(atol=1e-2, rtol=1e-2)
    q, k, v, unseen, starts, table = prefill_edge_inputs(
        C, bl, np.random.RandomState(C + bl))
    kn, vn = with_nan(k, unseen), with_nan(v, unseen)
    sj, st = _pair(starts)
    tj, tt = _pair(table)
    qj, kj, vj = (jnp.asarray(a, jdt) for a in (q, k, v))
    got = fp.flash_prefill_attention_paged(
        *(torch.as_tensor(a).to(dtype) for a in (q, kn, vn)), st, tt,
        block_len=bl, dtype=dtype)
    assert bool(torch.isfinite(got).all())
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(flash_prefill_attention_paged(
        qj, kj, vj, sj, tj, block_len=bl, dtype=jdt, interpret=True),
        np.float32), **tol)
    np.testing.assert_allclose(got, np.asarray(paged_chunk_attention(
        qj, kj, vj, sj, tj, block_len=bl), np.float32), **tol)


@pytest.mark.parametrize("dtype,block_len,head_dim,want", [
    (torch.bfloat16, 8, 64, True),
    (torch.bfloat16, 16, 64, True),
    (torch.bfloat16, 32, 64, True),
    (torch.bfloat16, 64, 64, True),
    (torch.bfloat16, 128, 64, True),
    (torch.bfloat16, 4, 64, False),     # boxes under one swizzle atom
    (torch.bfloat16, 14, 64, False),    # not a multiple of 8
    (torch.bfloat16, 24, 64, False),    # does not divide 64
    (torch.bfloat16, 96, 64, False),    # not a multiple of 64
    (torch.bfloat16, 16, 128, False),   # no tensor-core head dim but 64
    (torch.float32, 16, 64, False),     # fp32 keeps the CUDA cores
])
def test_prefill_tensor_core_route(dtype, block_len, head_dim, want):
    """Which ``(dtype, block_len, head_dim)`` the wrapper sends to K7's
    tensor-core instance: bf16 at head dim 64 over blocks whose TMA
    boxes stack into a 64-key tile or hold one; the serve path's block
    16 and the engine tests' block 8 among them."""
    assert fp.tensor_core_route(dtype, block_len, head_dim) is want


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
    assert [s.name for s in build.sources()] == ["a2a_ring.cu",
                                                 "collective_matmul.cu",
                                                 "flash_attention.cu",
                                                 "flash_decode.cu",
                                                 "flash_prefill.cu",
                                                 "quant_ring.cu"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.source_hash() == build.source_hash()
    for src in build.sources():
        head = src.read_text().split("#include")[0]
        assert ("Replaces: autodist_tpu/kernel/pallas/" in head
                or "Replaces: autodist_tpu/ops/flash_attention.py" in head)
        assert "Bound on this card" in head
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc") and not os.environ.get("CUDA_HOME"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.find_nvcc()


def test_wrappers_have_no_fallback_path():
    """A wrapper's only route to the plain version is a CPU tensor: no
    ``try`` in the kernel modules could swallow a failed launch."""
    for mod in (fd, fp, fa, qr, cm, ar):
        tree = ast.parse(open(mod.__file__).read())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
