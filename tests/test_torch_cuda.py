"""The port's CUDA kernels and engine on the card.

The kernels have no CPU mode, so every test here needs an NVIDIA GPU
and skips without one.  The module imports no JAX, so that it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_cuda.py

(``--noconftest`` keeps out the JAX mesh set-up of ``tests/conftest.py``.)
The first CUDA call builds the kernels with ``nvcc``.
"""
import numpy as np
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu_torch.kernel import flash_decode as fd
from autodist_tpu_torch.kernel import flash_prefill as fp

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
