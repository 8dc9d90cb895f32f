"""The port's input pipeline against the JAX package's, on the CPU.

The cases of ``tests/unit/test_data.py``: the prefetching
``DataLoader`` feeding a runner (params equal to direct steps bit for
bit, and to the JAX package's loader-fed run within 1e-6), a callable
source with a limit, scalar leaves going whole, source errors reaching
the consumer, ``shard_batch`` equal to the JAX function, ``TokenFile``
on the native route (the port's own ``dataio.cc``) and the memmap route
equal to the JAX reader on the same file, its bounds and alignment
errors, and ``lm_window_loader``'s windows equal to the JAX source's for
the same seed, step by step, after a resume too.  On 2 gloo ranks the
loader with ``global_batches`` hands each rank exactly what
``runner.step`` cuts from the global batch, and trains to the same
parameters.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu import AllReduce as JAllReduce
from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu import Trainable as JTrainable
from autodist_tpu import data as jdata
from autodist_tpu_torch import data, testing


def prunner():
    def loss_fn(p, batch):
        return ((batch["x"] @ p["w"] - batch["y"]) ** 2).mean()

    return port.AutoDist({}, port.AllReduce(), device="cpu").build(
        port.Trainable.from_loss_fn(loss_fn, {"w": torch.zeros(4)},
                                    port.optim.sgd(0.1)))


def batches(n):
    r = np.random.RandomState(0)
    return [{"x": r.randn(16, 4).astype(np.float32),
             "y": r.randn(16).astype(np.float32)} for _ in range(n)]


def test_loader_matches_direct_steps_and_jax():
    bs = batches(4)
    r1 = prunner()
    for b in bs:
        r1.step(b, rng=1)
    r2 = prunner()
    losses = [float(r2.step(b, rng=1)["loss"])
              for b in data.DataLoader(list(bs), r2.mesh, device="cpu")]
    assert losses[-1] < losses[0]
    np.testing.assert_array_equal(r1.get_params()["w"].numpy(),
                                  r2.get_params()["w"].numpy())

    def jloss(p, batch):
        return jnp.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)

    jr = JAutoDist({}, JAllReduce()).build(JTrainable.from_loss_fn(
        jloss, {"w": jnp.zeros((4,), jnp.float32)}, optax.sgd(0.1)))
    for b in jdata.DataLoader(list(bs), jr.mesh):
        jr.step(b, rng=jax.random.PRNGKey(1))
    np.testing.assert_allclose(r2.get_params()["w"].numpy(),
                               np.asarray(jr.get_params()["w"]),
                               rtol=1e-6, atol=1e-6)


def test_loader_callable_source_and_limit():
    calls = []

    def src(i):
        calls.append(i)
        return batches(1)[0]

    out = list(data.DataLoader(src, prunner().mesh, num_batches=3,
                               device="cpu"))
    assert len(out) == 3 and calls == [0, 1, 2]
    assert all(b.examples == 16 for b in out)


def test_loader_scalar_leaves_whole():
    runner = prunner()
    b = dict(batches(1)[0], scale=np.float32(2.0))
    placed = next(iter(data.DataLoader([b], runner.mesh, device="cpu",
                                       global_batches=True,
                                       lowered=runner.lowered)))
    assert placed["scale"].shape == () and float(placed["scale"]) == 2.0
    assert placed["x"].shape == (16, 4)
    runner.step(placed)          # placed: the runner cuts nothing again


def test_loader_propagates_source_errors():
    def bad(i):
        if i == 1:
            raise RuntimeError("boom")
        return batches(1)[0]

    with pytest.raises(RuntimeError, match="boom"):
        list(data.DataLoader(bad, prunner().mesh, num_batches=3,
                             device="cpu"))


def test_loader_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.DataLoader(batches(1), prunner().mesh)


def test_shard_batch_matches_jax():
    b = {"x": np.arange(8).reshape(8, 1), "s": np.float32(1.0)}
    for pi in (0, 1):
        got = data.shard_batch(b, process_index=pi, process_count=2)
        want = jdata.shard_batch(b, process_index=pi, process_count=2)
        np.testing.assert_array_equal(got["x"], want["x"])
        assert got["s"] == want["s"] == np.float32(1.0)
    assert data.shard_batch(b) is b          # one rank: a no-op
    with pytest.raises(ValueError, match="not divisible"):
        data.shard_batch({"x": np.zeros((7, 1))}, process_index=0,
                         process_count=2)


# ---------------- TokenFile / native data IO ---------------------------- #
@pytest.fixture()
def token_file(tmp_path):
    tokens = np.arange(1000, dtype=np.int32)
    p = tmp_path / "tokens.bin"
    tokens.tofile(p)
    return str(p), tokens


@pytest.mark.parametrize("native", [True, False], ids=["native", "memmap"])
def test_token_file_gather_matches_jax(token_file, native):
    path, tokens = token_file
    tf_ = data.TokenFile(path, np.int32, native=native)
    assert (tf_._h is not None) == native
    ref = jdata.TokenFile(path, np.int32, native=False)
    assert len(tf_) == len(ref) == 1000
    offs = np.array([0, 7, 993], dtype=np.int64)
    got = tf_.gather(offs, 7)
    np.testing.assert_array_equal(got, ref.gather(offs, 7))
    for row, off in zip(got, offs):
        np.testing.assert_array_equal(row, tokens[off:off + 7])
    tf_.prefetch(offs, 7)


@pytest.mark.parametrize("native", [True, False], ids=["native", "memmap"])
def test_token_file_bounds(token_file, native):
    path, _ = token_file
    tf_ = data.TokenFile(path, np.int32, native=native)
    for off in (995, -1):
        with pytest.raises(IndexError):
            tf_.gather(np.array([off], dtype=np.int64), 7)


def test_token_file_rejects_misaligned(tmp_path):
    p = tmp_path / "odd.bin"
    p.write_bytes(b"\x01\x02\x03")      # 3 bytes: not a multiple of 4
    with pytest.raises(OSError):
        data.TokenFile(str(p), np.int32, native=True)


def test_lm_window_loader_matches_jax_after_resume(token_file):
    path, _ = token_file
    src = data.lm_window_loader(path, batch_size=4, seq_len=16, seed=7)
    ref = jdata.lm_window_loader(path, batch_size=4, seq_len=16, seed=7,
                                 native=False)
    uninterrupted = [src(i) for i in range(5)]
    for i in range(5):
        for k in ("x", "y"):
            np.testing.assert_array_equal(uninterrupted[i][k], ref(i)[k])
    np.testing.assert_array_equal(uninterrupted[0]["y"][:, :-1],
                                  uninterrupted[0]["x"][:, 1:])
    resumed = data.lm_window_loader(path, batch_size=4, seq_len=16, seed=7)
    for i in range(3, 5):               # a restart at step 3
        np.testing.assert_array_equal(resumed(i)["x"],
                                      uninterrupted[i]["x"])
    assert not np.array_equal(uninterrupted[0]["x"], uninterrupted[1]["x"])
    runner = prunner()
    for b in data.DataLoader(src, runner.mesh, num_batches=2,
                             device="cpu"):
        assert b["x"].shape == (4, 16) and b["x"].dtype == torch.int32


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import data, testing
    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)

    def runner():
        def loss_fn(p, b):
            return ((b["x"] @ p["w"] - b["y"]) ** 2).mean() * b["scale"]
        return port.AutoDist({}, port.AllReduce(), device="cpu").build(
            port.Trainable.from_loss_fn(loss_fn, {"w": torch.zeros(4)},
                                        port.optim.sgd(0.1)))

    r = np.random.RandomState(0)
    batches = [{"x": r.randn(16, 4).astype(np.float32),
                "y": r.randn(16).astype(np.float32),
                "scale": np.float32(1.5)} for _ in range(3)]
    direct, fed = runner(), runner()
    same = []
    loader = data.DataLoader(batches, fed.mesh, global_batches=True,
                             lowered=fed.lowered)
    for b, placed in zip(batches, loader):
        want = direct._place_batch(b)
        same.append(all(torch.equal(placed[k], want[k]) for k in b))
        direct.step(b, rng=3)
        fed.step(placed, rng=3)
    torch.save({"same": same, "direct": direct.get_params()["w"],
                "fed": fed.get_params()["w"],
                "x_rows": [int(p["x"].shape[0]) for p in data.DataLoader(
                    batches, fed.mesh, global_batches=True,
                    lowered=fed.lowered)],
                "shard": data.shard_batch(batches[0])["x"]},
               f"{out}.{rank}")
    testing.end_rank()
""")


def test_loader_feeds_what_step_cuts_on_two_ranks(tmp_path):
    testing.launch(_WORKER, 2, (tmp_path / "out",), tmp=tmp_path,
                   timeout=240)()
    r = np.random.RandomState(0)
    x0 = r.randn(16, 4).astype(np.float32)
    ws = []
    for rank in range(2):
        got = torch.load(tmp_path / f"out.{rank}", weights_only=False)
        assert got["same"] == [True] * 3
        assert got["x_rows"] == [8, 8, 8]
        np.testing.assert_array_equal(got["shard"],
                                      x0[rank * 8:(rank + 1) * 8])
        np.testing.assert_array_equal(got["direct"].numpy(),
                                      got["fed"].numpy())
        ws.append(got["fed"].numpy())
    np.testing.assert_array_equal(ws[0], ws[1])
