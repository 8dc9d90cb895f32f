"""``chip_smoke.profile_summary``: the per-step summary of a profiled
window, held on the CPU with hand-made device intervals; and the launch
counts phase 7 holds each rank to, and how a missing profile prints.

``chip_smoke.py`` prints the summary for phases 3, 5, 7 and 9 on the
card; every field there must be per step (or per window), the top list
included.
"""
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_overlapping_intervals_count_once():
    """Two streams busy at once count once in the busy time; each launch
    keeps its own time in the per-name totals."""
    got = chip_smoke.profile_summary(
        [("gemm", 0.0, 400.0), ("nccl_kernel", 100.0, 300.0),
         ("gemm", 500.0, 600.0)], (0.0, 1000.0))
    wall_ms, busy_ms, n_launch, d2h, top = got
    assert (wall_ms, busy_ms, n_launch, d2h) == (1.0, 0.5, 3, 0)
    assert top == "gemm x2 0.500 ms; nccl_kernel x1 0.200 ms"


def test_intervals_are_clipped_to_the_window():
    """A launch that straddles an edge counts only its part inside the
    window, in the busy time and in its name's total; one wholly outside
    counts nowhere."""
    got = chip_smoke.profile_summary(
        [("before", -300.0, -100.0), ("edge", -100.0, 200.0),
         ("Memcpy DtoH (Device -> Pageable)", 900.0, 1200.0),
         ("after", 1100.0, 1500.0)], (0.0, 1000.0))
    wall_ms, busy_ms, n_launch, d2h, top = got
    assert (wall_ms, busy_ms, n_launch, d2h) == (1.0, 0.3, 2, 1)
    assert top == ("edge x1 0.200 ms; "
                   "Memcpy DtoH (Device -> Pageable) x1 0.100 ms")


def test_every_field_is_divided_by_k():
    """A window of k = 3 identical steps gives one step's numbers in
    every field: wall, busy, launches, copies and the top list."""
    step = [("dkv_kernel", 0.0, 300.0), ("dq_kernel", 300.0, 500.0),
            ("Memcpy DtoH (Device -> Pageable)", 600.0, 650.0)]
    window = [(name, lo + 1000.0 * i, hi + 1000.0 * i)
              for i in range(3) for name, lo, hi in step]
    one = chip_smoke.profile_summary(step, (0.0, 1000.0))
    three = chip_smoke.profile_summary(window, (0.0, 3000.0), k=3)
    assert one[:4] == pytest.approx(three[:4])
    assert three[:4] == pytest.approx((1.0, 0.55, 3, 1))
    assert three[4] == one[4] == (
        "dkv_kernel x1 0.300 ms; dq_kernel x1 0.200 ms; "
        "Memcpy DtoH (Device -> Pageable) x1 0.050 ms")


def test_top_list_keeps_six_names_and_no_device_time_gives_none():
    many = [(f"k{i}", 10.0 * i, 10.0 * i + i + 1) for i in range(8)]
    top = chip_smoke.profile_summary(many, (0.0, 100.0))[4]
    assert [t.split()[0] for t in top.split("; ")] == [
        "k7", "k6", "k5", "k4", "k3", "k2"]
    assert chip_smoke.profile_summary([], (0.0, 100.0)) is None
    assert chip_smoke.profile_summary([("k", 200.0, 300.0)],
                                      (0.0, 100.0)) is None


def test_watched_names_follow_the_top_six():
    """A name containing ``watch`` is listed after the six largest when
    it is not among them (phase 3 prints the decode kernel's time a
    window so), and is not repeated when it is."""
    many = [(f"k{i}", 10.0 * i, 10.0 * i + i + 1) for i in range(8)]

    def names(watch):
        top = chip_smoke.profile_summary(many, (0.0, 100.0), watch=watch)[4]
        return [t.split()[0] for t in top.split("; ")]

    assert names("k0") == ["k7", "k6", "k5", "k4", "k3", "k2", "k0"]
    assert names("k7") == ["k7", "k6", "k5", "k4", "k3", "k2"]
    assert names(None) == ["k7", "k6", "k5", "k4", "k3", "k2"]


@pytest.mark.parametrize("layers,k3,k4", [(4, 64, 32), (2, 32, 16)])
def test_phase7_holds_each_rank_to_its_layers(layers, k3, k4):
    """A rank's K3 and K4 launches a step follow the layers it holds:
    64 and 32 with all 4 at pipe 1, 32 and 16 with 2 at pipe 2 x model
    2 (bubble ticks run no stage); pipe rank 0 adds one K3 ring of 2
    hops, the vocab-parallel prologue's lookup sum; the other programs
    launch neither."""
    for first in (False, True):
        assert chip_smoke.tp_want("quant_ring", layers, first) == {
            "quant_ring_hop": k3 + 2 * first}
        assert chip_smoke.tp_want("collective_matmul", layers, first) == {
            "collective_matmul_hop": k4}
        assert chip_smoke.tp_want("int8", layers, first) == {}


def test_a_missing_profile_prints_not_measured():
    """The K2 pair's launches print as counted, or as not measured where
    the profiler saw no device time (never as "None")."""
    assert chip_smoke.in_launches(9) == "in 9 launches"
    assert "not measured" in chip_smoke.in_launches("not measured")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("index", [0, 1, 3])
def test_phase12_holds_each_seq_rank_to_its_chunks(monkeypatch, index,
                                                   remat):
    """The K1, K2a and K2b calls a step that phase 12 asserts
    (``seq_want``) are the calls a 4-layer ``TransformerLM`` with the
    causal flash ring makes on seq rank ``index`` (of 2, or of 4 at
    index 3; the ring's shifts stubbed to the identity on one process):
    index + 1 chunks a layer, K1 twice under remat."""
    import importlib

    import torch

    import autodist_tpu_torch as port
    from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
    from autodist_tpu_torch.parallel import ring_attention as ra
    from autodist_tpu_torch.parallel.axis import Axis, axis_scope
    from autodist_tpu_torch.parallel.sequence import global_positions

    fa_mod = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
    calls = dict.fromkeys(chip_smoke.TRAINING_KERNELS, 0)
    for name in calls:
        real = getattr(fa_mod, name)

        def counted(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(fa_mod, name, counted)
    monkeypatch.setattr(ra, "ring_shift", lambda x, axis: x.clone())
    cfg = port.TransformerConfig(
        vocab_size=32, hidden_size=16, num_layers=4, num_heads=2,
        mlp_dim=32, max_len=64, dtype=torch.float32, dropout_rate=0.0,
        attention_dropout_rate=0.0, remat=remat, position_fn=global_positions,
        attention_fn=ra.make_ring_flash_attention_fn(causal=True))
    tr = port.make_lm_trainable(cfg, port.optim.sgd(0.1), torch.Generator(),
                                device="cpu")
    leaves = {n: t.clone().requires_grad_()
              for n, t in flatten_with_names(tr.params)}
    x = torch.randint(0, 32, (2, 8))
    size = 4 if index == 3 else 2
    with axis_scope({"seq": Axis("seq", size=size, index=index)}):
        loss, _, _ = tr.loss(unflatten(leaves), None, {"x": x, "y": x}, None)
        torch.autograd.grad(loss, list(leaves.values()))
    assert calls == chip_smoke.seq_want(index, 4, remat)
