"""The capture helper's host side, on the CPU.

A graph itself needs the card (``tests/test_torch_cuda.py`` replays
training and decode windows there); what it relies on is plain host
code and is held here: a :class:`GraphSeed` folds and seeds its
generator exactly as a lowering folds an integer seed and as an eager
step seeds a fresh generator, a model reads either through
``dropout_generator``, and every kernel wrapper registers its counters.
"""
import importlib

import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu_torch import cuda_graph
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.models import bert

WRAPPERS = {
    "autodist_tpu_torch.ops.flash_attention": {
        "flash_attention_fwd": ("launches",),
        "flash_attention_bwd_dq": ("launches",),
        "flash_attention_bwd_dkv": ("launches",)},
    "autodist_tpu_torch.kernel.flash_decode": {
        "flash_decode_attention": ("launches",),
        "flash_decode_attention_paged": ("launches",)},
    "autodist_tpu_torch.kernel.flash_prefill": {
        "flash_prefill_attention_paged": ("launches", "cuda_core_launches")},
    "autodist_tpu_torch.kernel.collective_matmul": {
        "fused_matmul_add": ("launches", "staged")},
    "autodist_tpu_torch.kernel.quant_ring": {
        "fused_hop": ("launches", "unaligned")},
    "autodist_tpu_torch.kernel.a2a_ring": {
        "fused_hop": ("launches", "unaligned")},
}


@pytest.mark.parametrize("n,index", [(1, 0), (2, 1), (4, 3)])
def test_graph_seed_draws_what_the_folded_integer_seed_draws(n, index):
    """Folded over ``n`` replicas at ``index`` and set to a step's seed,
    a GraphSeed's generator draws the bits of a fresh generator seeded
    with ``seed * n + index``, the integer fold of the lowerings; set
    again, it starts over."""
    seed = cuda_graph.GraphSeed("cpu")
    assert cuda_graph.fold_seed(seed, n, index) is seed
    want = torch.rand(64, generator=cuda_graph.dropout_generator(
        cuda_graph.fold_seed(1234, n, index), "cpu"))
    for _ in range(2):
        seed.set(1234)
        torch.testing.assert_close(torch.rand(64, generator=seed.generator),
                                   want, atol=0, rtol=0)
    assert cuda_graph.fold_seed(None, n, index) is None
    assert cuda_graph.dropout_generator(None, "cpu") is None


def test_bert_dropout_reads_a_graph_seed_like_an_integer():
    """The BERT loss with dropout on (0.1, hidden and attention) given a
    GraphSeed set to a seed equals the loss given that integer seed, bit
    for bit, and another seed changes it."""
    cfg = port.TransformerConfig(vocab_size=97, hidden_size=32,
                                 num_layers=1, num_heads=2, mlp_dim=64,
                                 max_len=16, dtype=torch.float32,
                                 dropout_rate=0.1,
                                 attention_dropout_rate=0.1)
    tr = bert.make_mlm_trainable(cfg, port.optim.sgd(0.1),
                                 torch.Generator().manual_seed(0),
                                 device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             bert.synthetic_mlm_batch(0, 2, 16, 4, 97).items()}
    params = unflatten(dict(flatten_with_names(tr.params)))
    seed = cuda_graph.GraphSeed("cpu")
    seed.set(77)
    got = tr.loss(params, None, batch, seed)[0]
    assert torch.equal(got, tr.loss(params, None, batch, 77)[0])
    assert not torch.equal(got, tr.loss(params, None, batch, 78)[0])


def test_every_kernel_wrapper_registers_its_counters():
    """Each wrapper's counters start at an integer and are registered,
    so that a graph's replays add what its capture recorded."""
    modules = {m: importlib.import_module(m) for m in WRAPPERS}
    registered = {(id(owner), name) for owner, name in cuda_graph._COUNTERS}
    for module, wrappers in WRAPPERS.items():
        mod = modules[module]
        for fn_name, names in wrappers.items():
            fn = getattr(mod, fn_name)
            for name in names:
                assert isinstance(getattr(fn, name), int), (fn_name, name)
                assert (id(fn), name) in registered, (module, fn_name, name)


def test_counted_registers_fresh_counters():
    """``counted`` sets each named counter to 0 and registers it once,
    in order."""
    def wrapper():
        pass

    try:
        cuda_graph.counted(wrapper, "launches", "extra")
        assert (wrapper.launches, wrapper.extra) == (0, 0)
        assert [(o, n) for o, n in cuda_graph._COUNTERS if o is wrapper] \
            == [(wrapper, "launches"), (wrapper, "extra")]
    finally:
        cuda_graph._COUNTERS[:] = [(o, n) for o, n in cuda_graph._COUNTERS
                                   if o is not wrapper]
