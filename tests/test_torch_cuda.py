"""The port's CUDA kernels and engine on the card.

The kernels have no CPU mode, so every test here needs an NVIDIA GPU
and skips without one.  The module imports no JAX, so that it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_cuda.py

(``--noconftest`` keeps out the JAX mesh set-up of ``tests/conftest.py``.)
The first CUDA call builds the kernels with ``nvcc``.
"""
import importlib

import numpy as np
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu_torch.kernel import a2a_ring as ar
from autodist_tpu_torch.kernel import collective_matmul as cm
from autodist_tpu_torch.kernel import flash_decode as fd
from autodist_tpu_torch.kernel import flash_prefill as fp
from autodist_tpu_torch.kernel import quant_ring as qr
from autodist_tpu_torch.kernel.common import flatten_with_names
from autodist_tpu_torch.models import bert

fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
ATTENTION = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
             fa.flash_attention_bwd_dkv)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 comparisons
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.bfloat16, 64)])
def test_cuda_kernels_match_plain(cuda, dtype, d):
    """Each kernel against its plain version: fp32 at atol = rtol = 1e-5
    (the same fp32 arithmetic in another summation order), bf16 at 1e-2
    (the same rounded inputs; the output differs by about one ulp).
    Lengths 0, 17 and the lane's end; a chunk starting on and past the
    table's extent; tail-filled table rows."""
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    g = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    B, H, T, bl, nb, mb, C = 3, 2, 70, 16, 9, 5, 40
    lengths = torch.tensor([0, 17, 69], dtype=torch.int32, device=cuda)
    table = torch.tensor([[0, 1, 2, 3, 4], [5, 6, 6, 6, 6], [7, 8, 1, 2, 3]],
                         dtype=torch.int32, device=cuda)
    q1, k, v = randn(B, 1, H, d), randn(B, H, T, d), randn(B, H, T, d)
    kp, vp = randn(nb, H, bl, d), randn(nb, H, bl, d)
    qc = randn(B, C, H, d)
    starts = torch.tensor([0, 15, 70], dtype=torch.int32, device=cuda)
    cases = [
        (fd.flash_decode_attention, fd.flash_decode_attention_plain,
         (q1, k, v, lengths), {}),
        (fd.flash_decode_attention_paged,
         fd.flash_decode_attention_paged_plain,
         (q1, kp, vp, lengths, table), {"block_len": bl}),
        (fp.flash_prefill_attention_paged,
         fp.flash_prefill_attention_paged_plain,
         (qc, kp, vp, starts, table), {"block_len": bl}),
    ]
    for wrapper, plain, args, kw in cases:
        before = wrapper.launches
        got = wrapper(*args, dtype=dtype, **kw)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert got.dtype == dtype and got.shape == args[0].shape
        torch.testing.assert_close(got.float(),
                                   plain(*args, dtype=dtype, **kw).float(),
                                   atol=tol, rtol=tol)


def _decode_inputs(cuda, dtype, lengths, T, H, bl, paged, seed=0):
    """K5 or K6 inputs with NaN in every K and V row past each slot's
    last visible key (dense lanes of extent ``T``; or a pool of
    ``bl``-row blocks, ``T // bl`` table entries a slot, tail-filled rows
    drawn from a shuffled pool whose unused blocks are all NaN)."""
    rng = np.random.RandomState(seed)
    B, d = len(lengths), 64
    n_vis = np.minimum(np.asarray(lengths) + 1, T)

    def randn(*shape):
        return torch.as_tensor(rng.randn(*shape), dtype=torch.float32)

    q = randn(B, 1, H, d)
    lens = torch.tensor(lengths, dtype=torch.int32)
    past = torch.as_tensor(np.arange(T)[None, :] >= n_vis[:, None])  # [B, T]
    if not paged:
        k, v = randn(B, H, T, d), randn(B, H, T, d)
        for x in (k, v):
            x[past[:, None, :, None].expand_as(x)] = float("nan")
        args = (q, k, v, lens)
    else:
        mb = T // bl
        counts = [-(-int(n) // bl) for n in n_vis]
        nb = sum(counts) + 3
        free = list(rng.permutation(nb))
        table = np.zeros((B, mb), np.int32)
        kp = torch.full((nb, H, bl, d), float("nan"))
        vp = torch.full((nb, H, bl, d), float("nan"))
        for i, n in enumerate(counts):
            blocks = [free.pop() for _ in range(n)]
            table[i, :] = blocks[-1]
            table[i, :n] = blocks
            for t in range(int(n_vis[i])):
                kp[table[i, t // bl], :, t % bl] = randn(H, d)
                vp[table[i, t // bl], :, t % bl] = randn(H, d)
        args = (q, kp, vp, lens, torch.as_tensor(table))
    return tuple(a.to(cuda, dtype) if a.is_floating_point() else a.to(cuda)
                 for a in args)


# (lengths, extent, heads, paged block length): lengths at the edges of
# the kernel's chunks (48, 64, 96 and 128 keys at fp32 / bf16, paged /
# dense) and at two chunks +- 1, 0 and the extent's end; one long slot
# among short ones; an extent that is not a multiple of a chunk (paged: 5
# blocks of 14 rows); an extent that a block walks in many chunks; many
# (slot, head) pairs, more than the card holds at once; many long slots.
DECODE_EDGE_CASES = {
    "chunk_edges": ([0, 47, 48, 49, 63, 64, 65, 95, 96, 97, 127, 128, 129,
                     191, 192, 193, 255, 256, 257, 1023], 1024, 2, 16),
    "one_long_slot": ([1023, 3, 0, 5, 17, 2, 9, 1], 1024, 2, 16),
    "ragged_extent": ([0, 17, 69], 70, 2, 14),
    "long_extent": ([4095, 1500], 4096, 2, 16),
    "many_pairs": ([511, 0, 200, 129] * 32, 512, 8, 16),
    "many_long_slots": ([1023, 700, 5] * 8, 1024, 2, 16),
}


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("case", sorted(DECODE_EDGE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_edge_cases(cuda, dtype, case, layout):
    """K5 and K6, one block a (slot, head), against their plain versions
    at fp32 (atol = rtol = 1e-5) and bf16 (1e-2) at the tile and chunk
    edges; NaN in every row past each slot's length leaves the output
    finite (the kernel never reads those rows); a second call on the
    same inputs is bit-identical."""
    lengths, T, H, bl = DECODE_EDGE_CASES[case]
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    args = _decode_inputs(cuda, dtype, lengths, T, H, bl, layout == "paged")
    wrapper, plain, kw = (
        (fd.flash_decode_attention, fd.flash_decode_attention_plain, {})
        if layout == "dense" else
        (fd.flash_decode_attention_paged,
         fd.flash_decode_attention_paged_plain, {"block_len": bl}))
    before = wrapper.launches
    got = wrapper(*args, dtype=dtype, **kw)
    again = wrapper(*args, dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(),
                               plain(*args, dtype=dtype, **kw).float(),
                               atol=tol, rtol=tol)


# K7's cases, shared with tests/test_torch_kernels.py, which holds the
# plain version to the Pallas kernel there: C at and around the
# tensor-core kernel's 64-row groups; slots starting at 0, 63, 64 and one
# whose chunk reaches past the table's extent.
PREFILL_CHUNKS = (1, 40, 64, 65, 100)
PREFILL_EXTENT = 192


def prefill_edge_inputs(C, bl, rng):
    """K7 inputs at ``C`` chunk rows over ``bl``-row blocks, as numpy:
    q, the pools, the mask of pool rows that no chunk row sees (the
    unused blocks whole), starts and a tail-filled block table (each
    slot's blocks drawn from one shuffled pool, the row filled past its
    last used block with that block); 2 heads of 64."""
    H, d = 2, 64
    starts = np.asarray([0, 63, 64, PREFILL_EXTENT - C // 2], np.int32)
    B, mb = len(starts), PREFILL_EXTENT // bl
    n_keys = np.minimum(starts + C, PREFILL_EXTENT)
    counts = -(-n_keys // bl)
    nb = int(counts.sum()) + 3
    free = list(rng.permutation(nb))
    table = np.zeros((B, mb), np.int32)
    seen = np.zeros((nb, bl), bool)
    for i, n in enumerate(counts):
        blocks = [free.pop() for _ in range(n)]
        table[i, :] = blocks[-1]
        table[i, :n] = blocks
        pos = np.arange(n_keys[i])
        seen[table[i, pos // bl], pos % bl] = True
    q = rng.randn(B, C, H, d).astype(np.float32)
    k, v = (rng.randn(nb, H, bl, d).astype(np.float32) for _ in range(2))
    return q, k, v, ~seen, starts, table


def with_nan(pool, unseen):
    """A copy of ``pool [nb, H, bl, d]`` with NaN in the rows ``unseen
    [nb, bl]``."""
    out = pool.copy()
    out.transpose(0, 2, 1, 3)[unseen] = np.nan
    return out


def _bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at each ``|x|``."""
    _, exp = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), exp - 8)


@pytest.mark.parametrize("bl", [8, 16, 24])
@pytest.mark.parametrize("C", PREFILL_CHUNKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_prefill_edge_cases(cuda, dtype, C, bl):
    """K7 against its plain version at fp32 (atol = rtol = 1e-5) and
    bf16 (1e-2) at the row-group, tile and box edges.  At bf16 over
    blocks of 8 and 16 the tensor-core instance runs, and its output is
    at most one bf16 ulp from the plain version's, element by element,
    beyond what the split p = hi + lo can move it: bf16 rounds to within
    2^-8, so |p - hi - lo| <= 2^-16 p and an output moves by at most
    2^-16 sum(p |v|) / l (the plain version over |v|), which matters
    only where the sum cancels to near 0.  Blocks of 24 and fp32 take
    the CUDA-core instance, counted apart.  NaN in every pool row that
    no chunk row sees leaves the output finite; a second call is
    bit-identical."""
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    q, k, v, unseen, starts, table = prefill_edge_inputs(
        C, bl, np.random.RandomState(C + bl))
    args = (*(torch.as_tensor(a).to(cuda, dtype)
              for a in (q, with_nan(k, unseen), with_nan(v, unseen))),
            torch.as_tensor(starts).to(cuda), torch.as_tensor(table).to(cuda))
    wrapper = fp.flash_prefill_attention_paged
    tc = fp.tensor_core_route(dtype, bl, 64)
    assert tc == (dtype == torch.bfloat16 and bl != 24)
    before = (wrapper.launches, wrapper.cuda_core_launches)
    got = wrapper(*args, block_len=bl, dtype=dtype)
    again = wrapper(*args, block_len=bl, dtype=dtype)
    torch.cuda.synchronize()
    assert wrapper.launches == before[0] + 2
    assert wrapper.cuda_core_launches == before[1] + (0 if tc else 2)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    ref = fp.flash_prefill_attention_paged_plain(*args, block_len=bl,
                                                 dtype=dtype)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    if tc:
        q, k, v, starts, table = args
        split = 2.0 ** -16 * fp.flash_prefill_attention_paged_plain(
            q, k, v.abs(), starts, table, block_len=bl,
            dtype=torch.float32)
        g, r = got.float(), ref.float()
        ulps = (((g - r).abs() - split).clamp_min(0)
                / torch.maximum(_bf16_ulp(g), _bf16_ulp(r)))
        assert float(ulps.max()) <= 1.0, f"{float(ulps.max())} bf16 ulps"


@pytest.mark.parametrize("bad", ["dtype", "fp16", "output_dtype",
                                 "contiguous", "head_dim", "index_dtype"])
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(cuda, bad):
    """Refused before any launch: the counter does not move and nothing
    falls back to the plain version."""
    q = torch.zeros(2, 1, 2, 64, device=cuda)
    k = torch.zeros(2, 2, 8, 64, device=cuda)
    lengths = torch.zeros(2, dtype=torch.int32, device=cuda)
    kw = {}
    if bad in ("dtype", "fp16"):
        q = q.to(torch.float64 if bad == "dtype" else torch.float16)
        k = k.to(q.dtype)
        kw["dtype"] = q.dtype
    elif bad == "output_dtype":
        kw["dtype"] = torch.bfloat16
    elif bad == "contiguous":
        k = torch.zeros(2, 2, 64, 8, device=cuda).transpose(-1, -2)
    elif bad == "head_dim":
        q = torch.zeros(2, 1, 2, 48, device=cuda)
        k = torch.zeros(2, 2, 8, 48, device=cuda)
    else:
        lengths = lengths.long()
    before = fd.flash_decode_attention.launches
    with pytest.raises((TypeError, ValueError)):
        fd.flash_decode_attention(q, k, k, lengths, **kw)
    assert fd.flash_decode_attention.launches == before


@pytest.mark.parametrize("layout", ["dense", "paged_chunked"])
def test_cuda_engine_streams_equal_the_cpu_engine(cuda, layout):
    """The same fp32 weights and requests through the engine on the card
    (the kernels) and on the CPU (their plain versions): equal tokens and
    finish reasons, including a request that runs into ``max_len``."""
    cfg = port.TransformerConfig(
        vocab_size=97, hidden_size=128, num_layers=2, num_heads=2, mlp_dim=256,
        max_len=48, dtype=torch.float32, dropout_rate=0.0,
        attention_dropout_rate=0.0)
    params = port.init_pipeline_lm_params(cfg, torch.Generator().manual_seed(0),
                                          device="cpu")
    kw = dict(num_slots=2, prefill_len=16, decode_steps=4)
    if layout == "paged_chunked":
        kw.update(kv_layout="paged", kv_block_len=8, prefill_chunk=16)
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 97, n).tolist(), m)
            for n, m in [(5, 9), (16, 7), (3, 100)]]

    def run(device):
        batcher = port.ContinuousBatcher(
            port.serve(cfg, params=params, device=device, **kw))
        rids = [batcher.submit(p, max_new_tokens=m) for p, m in reqs]
        done = batcher.run()
        return [(done[r].tokens, done[r].finish_reason) for r in rids]

    before = (fd.flash_decode_attention.launches
              + fd.flash_decode_attention_paged.launches)
    got = run(cuda)
    assert (fd.flash_decode_attention.launches
            + fd.flash_decode_attention_paged.launches) > before
    assert got == run("cpu")
    assert got[-1][1] == "max_len"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,causal", [(100, False), (17, True), (128, True),
                                      (64, False)])
def test_cuda_flash_attention_kernels_match_plain(cuda, dtype, L, causal):
    """K1, K2a and K2b against their plain versions on q/k/v sliced from
    one [B, L, 3, H, D] projection: fp32 at atol = rtol = 1e-5, bf16 at
    1e-2; lengths on and off the kernels' 32/64-row tiles."""
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    g = torch.Generator(device=cuda).manual_seed(L)
    qkv = torch.randn((3, L, 3, 4, 64), generator=g, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)
    go = torch.randn((3, L, 4, 64), generator=g, device=cuda).to(dtype)
    before = [w.launches for w in ATTENTION]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = (go.float() * out.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, go, lse, delta, causal=causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, go, lse, delta,
                                        causal=causal)
    torch.cuda.synchronize()
    assert [w.launches for w in ATTENTION] == [n + 1 for n in before]
    kw = dict(causal=causal, scale=0.125)
    want = (fa.flash_attention_fwd_plain(q, k, v, **kw)
            + (fa.flash_attention_bwd_dq_plain(q, k, v, go, lse, delta, **kw),)
            + fa.flash_attention_bwd_dkv_plain(q, k, v, go, lse, delta, **kw))
    for got, ref in zip((out, lse, dq, dk, dv), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("bad", ["fp16", "head_dim", "strides", "unaligned",
                                 "g_layout"])
def test_cuda_flash_attention_raises_on_what_the_kernels_do_not_take(cuda,
                                                                     bad):
    """Refused before any launch: no counter moves and nothing falls
    back to the plain version."""
    q = k = v = torch.zeros(2, 8, 2, 64, device=cuda)
    g = torch.zeros(2, 8, 2, 64, device=cuda)
    if bad == "fp16":
        q = k = v = g = q.half()
    elif bad == "head_dim":
        q = k = v = g = torch.zeros(2, 8, 2, 32, device=cuda)
    elif bad == "strides":
        k = torch.zeros(2, 2, 8, 64, device=cuda).transpose(1, 2)
    elif bad == "unaligned":
        q = k = v = torch.zeros(2, 8, 2, 65, device=cuda)[..., 1:]
    else:
        g = torch.zeros(2, 2, 8, 64, device=cuda).transpose(1, 2)
    lse = delta = torch.zeros(2, 8, 2, device=cuda)
    before = [w.launches for w in ATTENTION]
    with pytest.raises((TypeError, ValueError)):
        if bad == "g_layout":
            fa.flash_attention_bwd_dq(q, k, v, g, lse, delta)
        else:
            fa.flash_attention_fwd(q, k, v)
    assert [w.launches for w in ATTENTION] == before


def test_cuda_training_step_goes_through_the_kernels(cuda):
    """One AutoDist + AllReduce step of a small fp32 BERT with the flash
    attention on the card: each of K1, K2a, K2b launches once per layer,
    and loss and parameters equal the same step on the CPU (where the
    wrappers run their plain versions)."""
    cfg = port.TransformerConfig(
        vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
        mlp_dim=256, max_len=32, dtype=torch.float32, dropout_rate=0.0,
        attention_dropout_rate=0.0, attention_fn=fa.make_attention_fn(False))
    batch = bert.synthetic_mlm_batch(0, 4, 32, 4, 97)
    batch.pop("input_mask")

    def step(device):
        trainable = bert.make_mlm_trainable(
            cfg, port.optim.sgd(0.5), torch.Generator().manual_seed(0),
            with_input_mask=False, device=device)
        runner = port.AutoDist({}, port.AllReduce(), device=device).build(
            trainable)
        loss = runner.step(batch)["loss"]
        return loss.cpu(), {n: p.cpu() for n, p in
                            flatten_with_names(runner.get_params())}

    before = [w.launches for w in ATTENTION]
    loss, params = step(cuda)
    torch.cuda.synchronize()
    assert [w.launches for w in ATTENTION] == [n + cfg.num_layers
                                               for n in before]
    cpu_loss, cpu_params = step("cpu")
    torch.testing.assert_close(loss, cpu_loss, atol=1e-5, rtol=1e-5)
    for name, p in params.items():
        torch.testing.assert_close(p, cpu_params[name], atol=1e-5, rtol=1e-5,
                                   msg=name)


# --------------------------------------------------------------------------- #
# K3 and K4: the tensor-parallel hop kernels
# --------------------------------------------------------------------------- #
def _misaligned(q_in, x):
    """``q_in`` 4 bytes into a wire (a view ``wire[4:]``, as a 4-byte
    header would leave it) and ``x`` at an odd element offset: neither
    starts on a 16-byte boundary."""
    wire = torch.empty(q_in.numel() + 4, dtype=torch.int8, device=q_in.device)
    wire[4:] = q_in
    odd = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    odd[1:] = x
    return wire[4:], odd[1:]


def _hop_cases(n, cuda):
    """Each hop case of K3 and K8 at ``n`` elements: ``(name, q_in,
    scale_in, x, vector)``, ``x`` being K3's ``local`` or K8's ``nxt``
    and ``vector`` whether every array is 16-byte aligned."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, generator=g, device=cuda) * 3
    q_in = torch.randint(-127, 128, (n,), generator=g, device=cuda,
                         dtype=torch.int8)
    s_in = torch.full((1,), 0.0173, device=cuda)
    nan = x.clone()
    nan[n // 2] = float("nan")
    zero_q, zero_s = torch.zeros_like(q_in), torch.zeros(1, device=cuda)
    odd_q, odd_x = _misaligned(q_in, x)
    # Halves up to max |x| = 127: scale 1, every quotient a tie that
    # rint rounds to even.
    ties = torch.randint(-254, 255, (n,), generator=g, device=cuda) / 2
    ties[0] = 127.0
    return [("open", zero_q, zero_s, x, True),
            ("ties", zero_q, zero_s, ties, True),
            ("hop", q_in, s_in, x, True),
            ("zero", zero_q, zero_s, torch.zeros_like(x), True),
            ("last", q_in, s_in, torch.zeros_like(x), True),
            ("nan", q_in, s_in, nan, True),
            ("misaligned", odd_q, s_in, odd_x, False)]


# A chunk of 2^23 + 5 is more than a grid holds in registers (128 blocks
# of 1024 threads x 16 elements = 2^21 on an H100): the kernels walk it
# in tiles.
HOP_SIZES = [1, 1000, 2 ** 20 + 3, 8 * 512 * 1024 // 2, 2 ** 23 + 5]


@pytest.mark.parametrize("C", HOP_SIZES)
def test_cuda_quant_ring_hop_is_bit_exact(cuda, C):
    """K3 against its plain version, every level and the scale equal:
    the opening quantize (scale_in 0) of random values and of exact
    ties (halves at scale 1), a hop with an incoming chunk, an
    all-zero chunk (levels 0, scale 1e-20), a hop onto an all-zero
    local, a NaN in local (a NaN scale, levels 0), and the hop with q_in
    and local off a 16-byte boundary (the element-wise path, counted in
    ``unaligned``).  2^21 elements is the main path's chunk ([8, 512,
    1024] over 2 ranks)."""
    for case, q_in, s_in, local, vector in _hop_cases(C, cuda):
        before = (qr.fused_hop.launches, qr.fused_hop.unaligned)
        q, s = qr.fused_hop(q_in, s_in, local)
        torch.cuda.synchronize()
        assert (qr.fused_hop.launches, qr.fused_hop.unaligned) == (
            before[0] + 1, before[1] + (not vector)), case
        q_ref, s_ref = qr.fused_hop_plain(q_in, s_in, local)
        assert q.dtype == torch.int8 and q.shape == q_in.shape
        assert torch.equal(q, q_ref), case
        assert torch.equal(s.view(torch.int32), s_ref.view(torch.int32)), case
        assert torch.isnan(s) == (case == "nan")


@pytest.mark.parametrize("dtype,M,K,C,ldk", [
    (torch.bfloat16, 4096, 512, 512, 1024),    # out projection, a chunk
    (torch.bfloat16, 4096, 2048, 512, 1024),   # mlp wo, a chunk
    (torch.float32, 100, 72, 40, 40),          # ragged in M, K and C
    (torch.float32, 100, 72, 40, 80),
    (torch.bfloat16, 100, 72, 40, 80),         # ragged in M, K and C
    (torch.bfloat16, 100, 70, 38, 76),         # rows not 16-byte aligned
    (torch.bfloat16, 100, 72, 37, 80),         # odd C: one-element epilogue
] + [(torch.bfloat16, M, K, C, 2 * C)          # the wgmma tiles' edges
     for K in (16, 64, 72) for M in (1, 127, 129) for C in (8, 136)])
def test_cuda_matmul_acc_matches_plain(cuda, dtype, M, K, C, ldk):
    """K4 against its plain version: bf16 at 1e-2 (one rounding of the
    fp32 sum, in another order), fp32 at 1e-5; ``k`` a column slice of a
    wider matrix where ``ldk > C``.  Only the operands TMA cannot read
    in place (rows not 16-byte aligned) are staged, once a call: at an
    odd C, the slice of ``k`` starts off a 16-byte boundary."""
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    g = torch.Generator(device=cuda).manual_seed(M + K)
    carry = torch.randn(M, C, generator=g, device=cuda).to(dtype)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    wide = (torch.randn(K, ldk, generator=g, device=cuda) / K ** 0.5).to(dtype)
    k = wide[:, ldk - C:]
    before = cm.fused_matmul_add.launches
    staged = cm.fused_matmul_add.staged
    got = cm.fused_matmul_add(carry, x, k)
    torch.cuda.synchronize()
    assert cm.fused_matmul_add.launches == before + 1
    unaligned = dtype == torch.bfloat16 and ((K, ldk) == (70, 76) or C % 2)
    assert cm.fused_matmul_add.staged == staged + unaligned
    assert got.dtype == dtype and got.shape == (M, C)
    torch.testing.assert_close(got.float(),
                               cm.fused_matmul_add_plain(carry, x, k).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("pattern", ["identity", "one_k_row", "one_k_column"])
def test_cuda_matmul_acc_patterned(cuda, pattern):
    """K4 in bf16 on ``k`` patterns whose products are exact, so that a
    wrong operand layout (a shared-memory descriptor field, the
    transpose bit) shows as misplaced values: ``k = I`` gives ``out =
    carry + x``; one non-zero row of ``k`` or one column of ones give a
    rank-one product."""
    g = torch.Generator(device=cuda).manual_seed(7)
    M = K = C = 192
    carry = torch.randn(M, C, generator=g, device=cuda).bfloat16()
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    wide = torch.zeros(K, 2 * C, device=cuda, dtype=torch.bfloat16)
    k = wide[:, C:]
    if pattern == "identity":
        k.copy_(torch.eye(K, device=cuda))
    elif pattern == "one_k_row":
        k[37] = torch.randn(C, generator=g, device=cuda)
    else:
        k[:, 5] = 1
    got = cm.fused_matmul_add(carry, x, k)
    want = cm.fused_matmul_add_plain(carry, x, k)
    torch.cuda.synchronize()
    if pattern != "one_k_column":      # one product per element: exact
        assert torch.equal(got, want)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("layout", ["projection", "separate"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [1, 127, 128, 129, 255, 512])
def test_cuda_flash_attention_fwd_bf16_tile_edges(cuda, L, causal, layout):
    """K1 in bf16 (the wgmma kernel: 128 query rows a block, 128-key
    tiles) against its plain version at lengths on and around its tiles,
    on q/k/v sliced from one [B, L, 3, H, D] projection and on three
    contiguous tensors; atol = rtol = 1e-2."""
    g = torch.Generator(device=cuda).manual_seed(L)
    if layout == "projection":
        q, k, v = torch.randn((2, L, 3, 3, 64), generator=g,
                              device=cuda).bfloat16().unbind(2)
    else:
        q, k, v = (torch.randn((2, L, 3, 64), generator=g,
                               device=cuda).bfloat16() for _ in range(3))
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                    scale=0.125)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref_out.float(), atol=1e-2,
                               rtol=1e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=1e-2)


def _bwd_bf16(q, k, v, go, causal, scale=0.125):
    """K2a and K2b in bf16 with lse and delta from the plain forward,
    and the plain versions of both on the same inputs."""
    before = [fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches]
    out, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                            scale=scale)
    delta = (go.float() * out.float()).sum(-1)
    kw = dict(causal=causal, scale=scale)
    got = ((fa.flash_attention_bwd_dq(q, k, v, go, lse, delta, **kw),)
           + fa.flash_attention_bwd_dkv(q, k, v, go, lse, delta, **kw))
    torch.cuda.synchronize()
    assert [fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches] == [n + 1 for n in before]
    want = ((fa.flash_attention_bwd_dq_plain(q, k, v, go, lse, delta, **kw),)
            + fa.flash_attention_bwd_dkv_plain(q, k, v, go, lse, delta, **kw))
    return got, want


@pytest.mark.parametrize("layout", ["projection", "separate"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [1, 63, 65, 127, 128, 129, 255, 512])
def test_cuda_flash_attention_bwd_bf16_tile_edges(cuda, L, causal, layout):
    """K2a and K2b in bf16 (the wgmma kernels: 64 rows or keys a block,
    64-row tiles through the ring) against their plain versions at
    lengths on and around their tiles, on q/k/v sliced from one
    [B, L, 3, H, D] projection and on three contiguous tensors; fp32 dq,
    dk and dv at atol = rtol = 1e-2."""
    g = torch.Generator(device=cuda).manual_seed(L)
    if layout == "projection":
        q, k, v = torch.randn((2, L, 3, 3, 64), generator=g,
                              device=cuda).bfloat16().unbind(2)
    else:
        q, k, v = (torch.randn((2, L, 3, 64), generator=g,
                               device=cuda).bfloat16() for _ in range(3))
    go = torch.randn((2, L, 3, 64), generator=g, device=cuda).bfloat16()
    got, want = _bwd_bf16(q, k, v, go, causal)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == q.shape
        torch.testing.assert_close(a, b, atol=1e-2, rtol=1e-2)


def test_cuda_flash_attention_bwd_bf16_patterned(cuda):
    """K2a and K2b in bf16 on one-hot rows, so that a wrong shared-memory
    descriptor (K-major for Q, g, K and V in the score products,
    MN-major for g, Q and K in the gradient products) or a wrong head or
    row coordinate moves a known element: q, k and v rows are one-hot
    (three permutations of the 64 dims), g is one 1 at (row 150, head 1,
    dim 37).  Then only row 150 of head 1 of dq, only dim 37 of dv and
    only q[150]'s dim of dk can be non-zero, exactly; the values are
    held to the plain versions at 1e-2.  A scale of 4 makes the
    probabilities peaked."""
    L, i0, d0 = 192, 150, 37
    rows = torch.arange(L, device=cuda)

    def one_hot(dims):
        x = torch.zeros(1, L, 2, 64, device=cuda)
        x[0, rows, :, dims] = 1
        return x.bfloat16()

    q = one_hot((3 * rows + 2) % 64)
    k = one_hot((5 * rows + 3) % 64)
    v = one_hot((7 * rows + 1) % 64)
    go = torch.zeros(1, L, 2, 64, device=cuda, dtype=torch.bfloat16)
    go[0, i0, 1, d0] = 1
    (dq, dk, dv), want = _bwd_bf16(q, k, v, go, False, scale=4.0)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a != 0, b != 0)
        torch.testing.assert_close(a, b, atol=1e-2, rtol=1e-2)
    assert dq[0, i0, 1].abs().sum() > 0
    assert dq.abs().sum() == dq[0, i0, 1].abs().sum()
    assert torch.equal((dv != 0).nonzero()[:, 2:].unique(dim=0),
                       torch.tensor([[1, d0]], device=cuda))
    assert torch.equal((dk != 0).nonzero()[:, 2:].unique(dim=0),
                       torch.tensor([[1, (3 * i0 + 2) % 64]], device=cuda))


@pytest.mark.parametrize("causal", [False, True])
def test_cuda_flash_attention_with_lse_grads_match_the_cpu(cuda, causal):
    """``flash_attention_with_lse`` in bf16 with cotangents on both
    ``out`` and ``lse`` (the ring-merge path: the ``lse`` cotangent
    folds into delta as ``delta - g_lse``) through K1, K2a and K2b on
    the card, against the same inputs on the CPU, where the wrappers run
    their plain versions; atol = rtol = 1e-2."""
    rng = np.random.RandomState(3)
    q, k, v, go = (torch.from_numpy(rng.randn(2, 100, 3, 64)).float()
                   for _ in range(4))
    g_lse = torch.from_numpy(rng.randn(2, 100, 3)).float()

    def grads(device):
        x = [t.to(device, torch.bfloat16).requires_grad_()
             for t in (q, k, v)]
        out, lse = fa.flash_attention_with_lse(*x, causal=causal)
        loss = ((out.float() * go.to(device)).sum()
                + (lse * g_lse.to(device)).sum())
        return [t.float().cpu() for t in torch.autograd.grad(loss, x)]

    before = [w.launches for w in ATTENTION]
    got = grads(cuda)
    torch.cuda.synchronize()
    assert [w.launches for w in ATTENTION] == [n + 1 for n in before]
    for a, b in zip(got, grads("cpu")):
        torch.testing.assert_close(a, b, atol=1e-2, rtol=1e-2)


# --------------------------------------------------------------------------- #
# K8: the quantized all-to-all ring's hop
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("L", HOP_SIZES + [2 ** 20])
def test_cuda_a2a_ring_hop_is_bit_exact(cuda, L):
    """K8 against its plain version, bit for bit (arrived, levels and
    scale): the warm-up (scale_in 0) of random values and of exact ties,
    a hop, all zeros, the last hop
    (all-zero nxt: levels 0, scale 1e-20), a NaN in nxt (a NaN scale,
    levels 0), the hop with q_in and nxt off a 16-byte boundary (the
    element-wise path, counted in ``unaligned``), and the hop writing
    arrived into a row of a wider output (``out=``; off a 16-byte
    boundary where 4 does not divide ``L``).  2^21 and 2^20 are the
    main path's chunks at expert axis 2 and 4."""
    rows = torch.full((2, L), -1.0, device=cuda)
    cases = _hop_cases(L, cuda)
    cases.append(("out", *cases[1][1:4], L % 4 == 0))
    for case, q_in, s_in, nxt, vector in cases:
        out = rows[1] if case == "out" else None
        before = (ar.fused_hop.launches, ar.fused_hop.unaligned)
        got = ar.fused_hop(q_in, s_in, nxt, out=out)
        torch.cuda.synchronize()
        assert (ar.fused_hop.launches, ar.fused_hop.unaligned) == (
            before[0] + 1, before[1] + (not vector)), case
        want = ar.fused_hop_plain(q_in, s_in, nxt)
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.int8
        for a, b in zip(got, want):
            assert torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8)), case
        assert torch.isnan(got[2]) == (case == "nan")
        if out is not None:
            assert got[0].data_ptr() == out.data_ptr()
            assert torch.equal(rows[0], torch.full_like(rows[0], -1.0))


def _device_ops(fn):
    """The names of the device operations (kernels, copies, memsets)
    that ``fn()`` ran, from ``torch.profiler``'s CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


@pytest.mark.parametrize("n", [1000, 2 ** 21, 2 ** 23 + 5])
def test_cuda_ring_hops_are_one_kernel_each(cuda, n):
    """One ``fused_hop`` call of either ring is one device kernel (one
    cooperative launch) and no memset or copy, aligned or not."""
    for case, q_in, s_in, x, _ in _hop_cases(n, cuda):
        if case not in ("hop", "misaligned"):
            continue
        for hop in (qr.fused_hop, ar.fused_hop):
            hop(q_in, s_in, x)                   # the first call builds
            ops = _device_ops(lambda: hop(q_in, s_in, x))
            assert len(ops) == 1 and "ring_hop_kernel" in ops[0], (case, ops)


@pytest.mark.parametrize("n", [1000, 2 ** 21, 2 ** 23 + 5])
def test_cuda_ring_hops_repeat_bit_identically(cuda, n):
    """The same hop twice back to back, no synchronize between: equal
    bytes, so nothing a launch leaves on the card (its block maxima)
    changes the next one."""
    _, q_in, s_in, x, _ = _hop_cases(n, cuda)[1]
    for hop in (qr.fused_hop, ar.fused_hop):
        first, second = hop(q_in, s_in, x), hop(q_in, s_in, x)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8))


def test_cuda_a2a_ring_hop_raises_on_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(8, dtype=torch.int8, device=cuda)
    s = torch.zeros(1, device=cuda)
    with pytest.raises(TypeError, match="nxt must be"):
        ar.fused_hop(q, s, torch.zeros(8, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ar.fused_hop(q, s, torch.zeros(16, device=cuda)[::2])
    with pytest.raises(ValueError, match="several devices"):
        ar.fused_hop(q, s, torch.zeros(8))


# --------------------------------------------------------------------------- #
# Steps-per-loop: a run_steps window and a decode window as one graph replay
# --------------------------------------------------------------------------- #
def _bert_runner(cuda, dtype, attention, dropout, builder=None):
    """A 2-layer BERT (hidden 128, 2 heads of 64) through AutoDist +
    ``builder`` (``AllReduce()`` by default) on the card, weights from
    seed 0 (the same every call)."""
    cfg = port.TransformerConfig(
        vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
        mlp_dim=256, max_len=64, dtype=dtype, dropout_rate=dropout,
        attention_dropout_rate=dropout if attention == "einsum" else 0.0,
        attention_fn=fa.make_attention_fn(False) if attention == "flash"
        else None)
    trainable = bert.make_mlm_trainable(
        cfg, port.optim.adamw(1e-3), torch.Generator().manual_seed(0),
        with_input_mask=False, device=cuda)
    return port.AutoDist({}, builder or port.AllReduce(),
                         device=cuda).build(trainable)


def _bert_steps(k, seed0=0):
    batches = []
    for i in range(k):
        b = bert.synthetic_mlm_batch(seed0 + i, 4, 64, 8, 97)
        b.pop("input_mask")
        batches.append(b)
    return batches


def _leaves(runner, metrics):
    """What a window leaves behind: the metrics, then every parameter and
    optimizer moment, on the host."""
    out = {f"metric/{n}": t.detach().cpu() for n, t in metrics.items()}
    out.update((f"state/{n}", t.detach().cpu()) for n, t in
               flatten_with_names({"params": runner.state["params"],
                                   "opt": runner.state["opt_state"]}))
    return out


def _hold_to_eager(captured, eager_a, eager_b):
    """The determinism rule: bit-equal where two eager windows are
    bit-equal; elsewhere within the largest difference they show."""
    for name, a in eager_a.items():
        b, c = eager_b[name], captured[name]
        same = a == b
        assert torch.equal(c[same], a[same]), name
        if not same.all():
            spread = (a.float() - b.float()).abs().max()
            assert (c.float() - a.float()).abs().max() <= spread, name


@pytest.mark.parametrize("dtype,attention,dropout", [
    (torch.float32, "flash", 0.0), (torch.bfloat16, "flash", 0.0),
    (torch.float32, "einsum", 0.1), (torch.bfloat16, "einsum", 0.1),
    (torch.bfloat16, "flash", 0.1)])
def test_cuda_run_steps_replay_equals_step_calls(cuda, dtype, attention,
                                                 dropout):
    """A captured ``run_steps`` window of 4 steps against 4 ``step``
    calls from the same state and ``rngs``, under the determinism rule
    (two eager windows measure what the card's atomics leave open).
    With dropout the replay's masks come from ``GraphSeed``s seeded on
    the host, and equal the fresh generators of eager steps."""
    batches, rngs = _bert_steps(4), [3, 1, 4, 1 << 30]
    eager = []
    for _ in range(2):
        runner = _bert_runner(cuda, dtype, attention, dropout)
        m = [runner.step(b, rng=r) for b, r in zip(batches, rngs)]
        eager.append(_leaves(runner, {n: torch.stack([x[n] for x in m])
                                      for n in m[0]}))
        assert runner.captures == 0
        runner.close()
    runner = _bert_runner(cuda, dtype, attention, dropout)
    assert runner.lowered.capturable
    before = [w.launches for w in ATTENTION]
    metrics = runner.run_steps(port.stack_steps(batches), rngs=rngs)
    torch.cuda.synchronize()
    assert (runner.captures, runner.replays) == (1, 1)
    assert runner.state is runner._state_buf
    _hold_to_eager(_leaves(runner, metrics), *eager)
    want = 4 * 2 if attention == "flash" else 0
    assert [w.launches - n for w, n in zip(ATTENTION, before)] == [want] * 3
    runner.close()


def test_cuda_run_steps_step_run_steps_equals_five_steps(cuda):
    """``run_steps(k=2)``, ``step()``, ``run_steps(k=2)`` equals five
    ``step`` calls (bf16, flash, seeds from the runner's own stream) and
    captures once: the ``step`` in between leaves new tensors, which the
    second replay copies into the graph's state.  A window of another
    ``k`` captures once more; the kernel counters equal the steps
    run."""
    batches = _bert_steps(8)
    eager = []
    for _ in range(2):
        runner = _bert_runner(cuda, torch.bfloat16, "flash", 0.0)
        m = [runner.step(b) for b in batches[:5]]
        eager.append(_leaves(runner, {"loss": torch.stack(
            [x["loss"] for x in m])}))
        runner.close()
    runner = _bert_runner(cuda, torch.bfloat16, "flash", 0.0)
    before = [w.launches for w in ATTENTION]
    first = runner.run_steps(port.stack_steps(batches[:2]))
    middle = runner.step(batches[2])
    assert runner.state is not runner._state_buf
    last = runner.run_steps(port.stack_steps(batches[3:5]))
    torch.cuda.synchronize()
    assert (runner.captures, runner.replays) == (1, 2)
    assert runner.step_count == 5
    loss = torch.cat([first["loss"], middle["loss"][None], last["loss"]])
    _hold_to_eager(_leaves(runner, {"loss": loss}), *eager)
    runner.run_steps(port.stack_steps(batches[5:8]))
    torch.cuda.synchronize()
    assert (runner.captures, runner.replays) == (2, 3)
    assert runner.step_count == 8
    assert [w.launches - n for w, n in zip(ATTENTION, before)] == [16] * 3
    runner.close()


ZOO = {"PS": lambda: port.PS(),
       "PartitionedPS": lambda: port.PartitionedPS(),
       "UnevenPartitionedPS": lambda: port.UnevenPartitionedPS(),
       "bf16_ef": lambda: port.AllReduce(compressor="bf16_ef"),
       "powersgd": lambda: port.AllReduce(compressor="powersgd:2"),
       "GradAccumulation": lambda: port.GradAccumulation(port.AllReduce(),
                                                         2)}


@pytest.mark.parametrize("name", list(ZOO))
def test_cuda_zoo_run_steps_replay_equals_step_calls(cuda, name):
    """Each update space and a stateful compressor under capture: a
    ``run_steps`` window of 4 bf16 flash steps is one graph replay and
    equals 4 ``step`` calls under the determinism rule.  At one replica
    PS and PartitionedPS update flat shards (one shard), and
    UnevenPartitionedPS stores its tables split in 3 or more pieces
    over one rank (the token table behind a ``ShardedEmbedding``).  The
    attention kernels launch 4 steps x 2 layers, twice that under
    accumulation; the compressor's state row is carried."""
    batches, rngs = _bert_steps(4), [3, 1, 4, 1]
    eager = []
    for _ in range(2):
        runner = _bert_runner(cuda, torch.bfloat16, "flash", 0.0, ZOO[name]())
        m = [runner.step(b, rng=r) for b, r in zip(batches, rngs)]
        eager.append(_leaves(runner, {"loss": torch.stack(
            [x["loss"] for x in m])}))
        runner.close()
    runner = _bert_runner(cuda, torch.bfloat16, "flash", 0.0, ZOO[name]())
    assert runner.lowered.capturable
    before = [w.launches for w in ATTENTION]
    metrics = runner.run_steps(port.stack_steps(batches), rngs=rngs)
    torch.cuda.synchronize()
    assert (runner.captures, runner.replays) == (1, 1)
    _hold_to_eager(_leaves(runner, {"loss": metrics["loss"]}), *eager)
    want = 4 * 2 * (2 if name == "GradAccumulation" else 1)
    assert [w.launches - n for w, n in zip(ATTENTION, before)] == [want] * 3
    if name in ("bf16_ef", "powersgd"):
        assert runner.state["sync_state"]
    params = runner.get_params()
    assert params["token_embed"]["embedding"].shape == (97, 128)
    runner.close()


@pytest.mark.parametrize("layout", ["dense", "paged_chunked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_replay_equals_the_uncaptured_body(cuda, layout, dtype):
    """Requests through ``ContinuousBatcher`` on an engine whose decode
    windows replay one CUDA graph and on one that runs the window body
    uncaptured, with admissions and releases between windows (five
    requests, two slots, a ``max_len`` run): equal streams token for
    token, one capture, a replay for every window after the first, and
    the decode kernel's counter equal to the attention calls made."""
    cfg = port.TransformerConfig(
        vocab_size=97, hidden_size=128, num_layers=2, num_heads=2, mlp_dim=256,
        max_len=48, dtype=dtype, dropout_rate=0.0, attention_dropout_rate=0.0)
    params = port.init_pipeline_lm_params(cfg, torch.Generator().manual_seed(0),
                                          device="cpu")
    kw = dict(num_slots=2, prefill_len=16, decode_steps=4)
    if layout == "paged_chunked":
        kw.update(kv_layout="paged", kv_block_len=8, prefill_chunk=16)
    wrapper = (fd.flash_decode_attention if layout == "dense"
               else fd.flash_decode_attention_paged)
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(0, 97, n).tolist(), m)
            for n, m in [(5, 9), (16, 7), (3, 100), (11, 13), (1, 6)]]

    def run(graph):
        engine = port.serve(cfg, params=params, device=cuda,
                            decode_graph=graph, **kw)
        windows = []
        decode_window = engine.decode_window
        engine.decode_window = lambda a: windows.append(1) or \
            decode_window(a)
        batcher = port.ContinuousBatcher(engine)
        before = wrapper.launches
        rids = [batcher.submit(p, max_new_tokens=m) for p, m in reqs]
        done = batcher.run()
        torch.cuda.synchronize()
        assert wrapper.launches - before == \
            cfg.num_layers * kw["decode_steps"] * len(windows)
        assert engine.block_accounting()[1] == 0
        return engine, len(windows), [(done[r].tokens, done[r].finish_reason)
                                      for r in rids]

    engine, n, captured = run(True)
    assert (engine.captures, engine.replays) == (1, n - 1) and n > 2
    plain, _, uncaptured = run(False)
    assert (plain.captures, plain.replays) == (0, 0)
    assert captured == uncaptured
    assert captured[2][1] == "max_len"


@pytest.mark.parametrize("vocab", [1000, 999])
def test_cuda_streaming_cross_entropy_matches_the_cpu(cuda, vocab):
    """The vocab-parallel loss head's streaming cross-entropy (one shard)
    on CUDA tensors: nll, pred, dx and dW equal its CPU result within
    1e-5 (fp32, TF32 off)."""
    from autodist_tpu_torch.parallel.tensor import \
        vocab_parallel_cross_entropy

    r = np.random.RandomState(0)
    x = torch.tensor(r.randn(2, 96, 64), dtype=torch.float32)
    emb = torch.tensor(r.randn(vocab, 64) * 0.1, dtype=torch.float32)
    targets = torch.tensor(r.randint(0, vocab, (2, 96)))

    def run(device):
        xx = x.to(device).requires_grad_()
        ee = emb.to(device).requires_grad_()
        nll, pred = vocab_parallel_cross_entropy(
            xx, ee, targets.to(device), vocab_size=vocab, seq_chunk=32)
        nll.mean().backward()
        return [t.detach().cpu() for t in (nll, pred, xx.grad, ee.grad)]

    got, want = run(cuda), run("cpu")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


_TP_SERVING_WORKER = """
import sys
import torch
import autodist_tpu_torch as port
from autodist_tpu_torch import testing
from autodist_tpu_torch.kernel import flash_decode as fd
rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
testing.init_rank(rank, world, store)
job = torch.load(inp, weights_only=False)
engine = port.serve(job["cfg"], params=job["params"], device="cuda",
                    tensor_parallel=2, vocab_parallel=True, **job["kw"])
batcher = port.ContinuousBatcher(engine)
rids = [batcher.submit(p, max_new_tokens=m) for p, m in job["reqs"]]
done = batcher.run()
if rank == 0:
    torch.save({"streams": [done[r].tokens for r in rids],
                "launches": fd.flash_decode_attention.launches,
                "captures": engine.captures}, out)
testing.end_rank()
"""


def test_cuda_tp2_serving_stream_equals_tp1(cuda, tmp_path):
    """Two gloo ranks on the card serve at tensor parallel 2 with the
    vocabulary sharded (vocab 97, odd): their fp32 streams equal the
    tp-1 engine's on the card, K5 launches at 1 of the 2 heads, and the
    gloo group keeps the decode loop on the host (no capture)."""
    from autodist_tpu_torch import testing

    cfg = port.TransformerConfig(
        vocab_size=97, hidden_size=128, num_layers=2, num_heads=2, mlp_dim=256,
        max_len=48, dtype=torch.float32, dropout_rate=0.0,
        attention_dropout_rate=0.0)
    params = port.init_pipeline_lm_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    kw = dict(num_slots=2, prefill_len=16, decode_steps=4)
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 97, n).tolist(), m) for n, m in [(5, 9), (16, 7)]]
    inp, out = str(tmp_path / "job.pt"), str(tmp_path / "res.pt")
    torch.save({"cfg": cfg, "params": params, "kw": kw, "reqs": reqs}, inp)
    join = testing.launch(_TP_SERVING_WORKER, 2, (inp, out), tmp=tmp_path,
                          timeout=600)
    batcher = port.ContinuousBatcher(port.serve(cfg, params=params,
                                                device=cuda, **kw))
    rids = [batcher.submit(p, max_new_tokens=m) for p, m in reqs]
    done = batcher.run()
    join()
    got = torch.load(out, weights_only=False)
    assert got["streams"] == [done[r].tokens for r in rids]
    assert got["launches"] > 0 and got["captures"] == 0


# --------------------------------------------------------------------------- #
# Sequence parallelism: the ring and the causal LM
# --------------------------------------------------------------------------- #
def test_cuda_one_rank_flash_ring_is_flash_attention(cuda):
    """A seq axis of one rank: the flash ring is one diagonal chunk, so
    its output and dq, dk, dv in bf16 equal ``flash_attention`` causal
    on the card bit for bit, through one K1, K2a and K2b launch each."""
    from autodist_tpu_torch.parallel.axis import Axis, axis_scope
    from autodist_tpu_torch.parallel.ring_attention import (
        ring_flash_attention)

    rng = np.random.RandomState(4)
    q, k, v, go = (torch.from_numpy(rng.randn(2, 200, 4, 64)).to(
        cuda, torch.bfloat16) for _ in range(4))

    def run(fn):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*x)
        return [out.detach()] + list(torch.autograd.grad(out, x, go))

    before = [w.launches for w in ATTENTION]
    with axis_scope({"seq": Axis("seq")}):
        got = run(lambda *x: ring_flash_attention(*x, causal=True))
    torch.cuda.synchronize()
    assert [w.launches for w in ATTENTION] == [n + 1 for n in before]
    want = run(lambda *x: fa.flash_attention(*x, causal=True))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _lm_trainable(dtype, **kw):
    """A 2-layer ``TransformerLM`` with the causal flash ring and global
    positions (head dim 64), weights from seed 0 on the CPU."""
    from autodist_tpu_torch.parallel.ring_attention import (
        make_ring_flash_attention_fn)
    from autodist_tpu_torch.parallel.sequence import global_positions

    cfg = port.TransformerConfig(
        vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
        mlp_dim=256, max_len=256, dtype=dtype,
        attention_fn=make_ring_flash_attention_fn(causal=True),
        position_fn=global_positions, **{
            "dropout_rate": 0.0, "attention_dropout_rate": 0.0, **kw})
    return port.make_lm_trainable(cfg, port.optim.sgd(0.1),
                                  torch.Generator().manual_seed(0),
                                  device="cpu")


def _lm_loss_and_grads(tr, device, rng=None):
    """Loss and gradients of one batch on ``device``, under a one-rank
    seq axis."""
    from autodist_tpu_torch.kernel.common import unflatten
    from autodist_tpu_torch.parallel.axis import Axis, axis_scope

    x = torch.from_numpy(np.random.RandomState(5).randint(0, 512, (2, 256)))
    batch = {"x": x.to(device), "y": x.roll(-1, 1).to(device)}
    leaves = {n: t.to(device).requires_grad_()
              for n, t in flatten_with_names(tr.params)}
    with axis_scope({"seq": Axis("seq")}):
        loss, _, _ = tr.loss(unflatten(leaves), None, batch, rng)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach().float().cpu(), {n: g.float().cpu()
                                         for n, g in zip(leaves, grads)}


def test_cuda_transformer_lm_bf16_equals_its_cpu_run(cuda):
    """``TransformerLM`` in bf16 through the flash ring (K1, K2a, K2b
    on the card, their plain versions on the CPU): the loss within
    1e-2 relative and every gradient within atol = rtol = 2e-2 of the
    CPU run on the same weights and batch."""
    tr = _lm_trainable(torch.bfloat16)
    loss, grads = _lm_loss_and_grads(tr, cuda)
    want_loss, want = _lm_loss_and_grads(tr, "cpu")
    torch.testing.assert_close(loss, want_loss, atol=0, rtol=1e-2)
    for name, g in grads.items():
        torch.testing.assert_close(g, want[name], atol=2e-2, rtol=2e-2,
                                   msg=name)


def test_cuda_remat_equals_no_remat_with_dropout(cuda):
    """``cfg.remat`` on the card at dropout 0.1 (a CUDA generator): the
    recompute redraws the first pass's masks, so the fp32 loss is the
    same and every gradient agrees within 1e-6 (atomic sums may round
    in another order)."""
    drop = dict(dropout_rate=0.1, attention_dropout_rate=0.1)
    plain = _lm_loss_and_grads(_lm_trainable(torch.float32, **drop), cuda,
                               rng=7)
    remat = _lm_loss_and_grads(_lm_trainable(torch.float32, remat=True,
                                             **drop), cuda, rng=7)
    torch.testing.assert_close(remat[0], plain[0], atol=0, rtol=0)
    for name, g in plain[1].items():
        torch.testing.assert_close(remat[1][name], g, atol=1e-6, rtol=1e-6,
                                   msg=name)
