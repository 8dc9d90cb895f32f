"""The gradient compressors, against the JAX package on the CPU.

Each compressor's all-reduce runs on 2 and on 4 gloo ranks, three calls
in a row with the state row carried, on the same per-rank inputs (made
with numpy here and saved for the workers) as the JAX compressor under
``shard_map`` on a data axis of the same size.  The outputs and the
state rows agree: the casts and the error-feedback casts within rtol
1e-6; PowerSGD within rtol 1e-4; the int8 compressors within one level
(the scale over the rank count) everywhere, and the count of
elements off by a level is reported (0 expected but at exact ties, or
where XLA contracts the ring hop's ``q * s + local`` into one FMA).

The cases of ``tests/unit/test_compressor.py`` run on the 4-rank job
with their thresholds (the JAX cases use 8 devices), and
``AllReduce(compressor=...)`` trains the linear golden model through
the lowering on 2 and 4 ranks to the JAX runner's parameters and
compressor state rows.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from autodist_tpu_torch import testing
from autodist_tpu_torch.kernel.compressor import (Compressor,
                                                  PowerSGDCompressor)

WORLDS = (2, 4)
NAMES = ("none", "fp16", "bf16", "fp16_ef", "bf16_ef", "int8_ef",
         "int8_ring", "powersgd:2")
SIZES = (37, 1000)
CALLS = 3
LIN_BATCH, LIN_DIM, LIN_OUT = 16, 6, 3


def _inputs(world, total):
    return np.random.RandomState(total + world).randn(
        world, CALLS, total).astype(np.float32)


def _jax_calls(name, world, xs):
    """The JAX compressor on ``world`` simulated devices: (outputs,
    state rows) after each call, ``[CALLS, world, ...]``."""
    from autodist_tpu.kernel.compressor import Compressor as JaxCompressor

    comp = JaxCompressor.create(name)
    mesh = jax.make_mesh((world,), ("data",), devices=jax.devices()[:world])
    total = xs.shape[-1]
    row = (comp.init_state_flat(total) if comp.stateful
           else np.zeros(1, np.float32))
    state = jnp.asarray(np.tile(row[None], (world, 1)))

    def f(x, s):
        out, ns = comp.allreduce(x[0], s[0] if comp.stateful else None,
                                 "data")
        return out[None], (ns[None] if comp.stateful else s)

    g = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                              out_specs=(P("data"), P("data")),
                              check_vma=False))
    outs, states = [], []
    for c in range(CALLS):
        out, state = g(jnp.asarray(xs[:, c]), state)
        outs.append(np.asarray(out))
        states.append(np.asarray(state))
    return np.stack(outs), np.stack(states)


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import const, testing
    from autodist_tpu_torch.kernel.compressor import Compressor
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)
    axis = port.ResourceSpec({}).make_mesh().axis(const.DATA_AXIS)
    res = {}

    def calls(name, xs, steps=None):
        comp = Compressor.create(name)
        state = (torch.as_tensor(comp.init_state_flat(xs.shape[-1]))
                 if comp.stateful else None)
        outs, states = [], []
        for c in range(xs.shape[0] if steps is None else steps):
            x = torch.as_tensor(xs[c if steps is None else 0])
            o, state = comp.allreduce(x, state, axis)
            outs.append(o.numpy().copy())
            states.append(None if state is None else state.numpy().copy())
        return outs, states

    for name in job["names"]:
        for total in job["sizes"]:
            res[(name, total)] = calls(name, job["inputs"][(total, world)][rank])
    for key, (name, xs, steps) in job["unit"].get(world, {}).items():
        res[key] = calls(name, xs[rank][None] if steps else xs[rank],
                         steps)

    def lin_trainable(opt):
        def loss_fn(p, b):
            pred = b["x"] @ p["dense"]["w"] + p["dense"]["b"]
            return ((pred * p["scale"] - b["y"]) ** 2).mean()
        params = {"dense": {k: torch.as_tensor(v) for k, v in
                            job["lin_params"]["dense"].items()},
                  "scale": torch.as_tensor(job["lin_params"]["scale"])}
        return port.Trainable.from_loss_fn(loss_fn, params, opt)

    for name in job["names"]:
        runner = port.AutoDist({}, port.AllReduce(chunk_size=2,
                                                  compressor=name),
                               device="cpu").build(
            lin_trainable(port.optim.sgd(0.1)))
        losses = [float(runner.step(b)["loss"]) for b in job["lin_batches"]]
        res[("lin", name)] = {"params": runner.get_params(),
                              "sync": {k: v.numpy().copy() for k, v in
                                       runner.state["sync_state"].items()},
                              "losses": losses}
    for name, opt in job["trains"]:
        w = torch.as_tensor(job["train_w"][name])
        def loss_fn(p, b):
            return ((b["x"] @ p["w"] - b["y"]) ** 2).mean()
        runner = port.AutoDist({}, port.AllReduce(compressor=name),
                               device="cpu").build(port.Trainable.from_loss_fn(
                                   loss_fn, {"w": w}, port.optim.sgd(opt)))
        res[("train", name)] = [float(runner.step(job["train_batch"][name])
                                      ["loss"]) for _ in range(12)]
    torch.save(res, f"{out}.{rank}")
    testing.end_rank()
""")

# tests/unit/test_compressor.py's cases on 4 ranks: key -> (name, a
# [world, calls, total] input, steps repeating call 0 or None).
UNIT_WORLD = 4


def _unit_cases():
    w = UNIT_WORLD
    cases = {}
    for name in ("none", "fp16", "bf16"):
        cases[("stateless", name)] = (
            name, np.stack([np.full((1, 16), float(i), np.float32)
                            for i in range(w)]), None)
    for name in ("fp16_ef", "bf16_ef", "int8_ef"):
        cases[("ef", name)] = (
            name, np.stack([np.full((1, 8), 1.0 + 1e-4 * i, np.float32)
                            for i in range(w)]), None)
    cases[("ef_unbiased", "int8_ef")] = (
        "int8_ef", np.stack([np.full((8,), v, np.float32) for v in
                             np.linspace(0.9999, 1.0001, w)]), 50)
    u = np.linspace(1.0, 2.0, 8).astype(np.float32)
    v = np.linspace(-1.0, 1.0, 8).astype(np.float32)
    flat = np.outer(u, v).reshape(-1)
    cases[("powersgd_low_rank", "powersgd:2")] = (
        "powersgd:2", np.stack([flat[None] for _ in range(w)]), None)
    cases[("powersgd_ef", "powersgd")] = (
        "powersgd", np.random.RandomState(0).randn(w, 100).astype(
            np.float32), 40)
    cases[("ring_ef", "int8_ring")] = (
        "int8_ring", np.random.RandomState(0).randn(w, 96).astype(
            np.float32), 20)
    r = np.random.RandomState(1)
    for total in (64, 100, 7, 1):
        cases[("ring_mean", total)] = (
            "int8_ring", r.randn(w, 1, total).astype(np.float32), None)
    return cases


def _lin_params():
    r = np.random.RandomState(0)
    return {"dense": {"w": r.randn(LIN_DIM, LIN_OUT).astype(np.float32),
                      "b": np.zeros(LIN_OUT, np.float32)},
            "scale": np.ones((), np.float32)}


def _lin_batches():
    out = []
    for s in range(3):
        r = np.random.RandomState(s)
        out.append({"x": r.randn(LIN_BATCH, LIN_DIM).astype(np.float32),
                    "y": r.randn(LIN_BATCH, LIN_OUT).astype(np.float32)})
    return out


TRAINS = {"powersgd:4": ((32, 32), 0.2), "int8_ring": ((32, 16), 0.2)}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compressor")
    inp = tmp / "job.pt"
    trains_w, trains_batch = {}, {}
    for name, (shape, _) in TRAINS.items():
        trains_w[name] = (0.1 * np.random.RandomState(7).randn(*shape)
                          ).astype(np.float32)
        r = np.random.RandomState(0)
        trains_batch[name] = {
            "x": r.randn(16, shape[0]).astype(np.float32),
            "y": r.randn(16, shape[1]).astype(np.float32)}
    torch.save({
        "names": NAMES, "sizes": SIZES,
        "inputs": {(t, w): _inputs(w, t) for t in SIZES for w in WORLDS},
        "unit": {UNIT_WORLD: _unit_cases()},
        "lin_params": _lin_params(), "lin_batches": _lin_batches(),
        "trains": [(n, lr) for n, (_, lr) in TRAINS.items()],
        "train_w": trains_w, "train_batch": trains_batch}, inp)
    joins = {w: testing.launch(_WORKER, w, (inp, tmp / f"out{w}"),
                               tmp=tmp / f"w{w}", timeout=400)
             for w in WORLDS}
    return joins, tmp


@pytest.fixture(scope="module")
def port_runs(started):
    """Every rank's results, ``{world: [rank 0's, rank 1's, ...]}``."""
    joins, tmp = started
    runs = {}
    for w, join in joins.items():
        join()
        runs[w] = [torch.load(tmp / f"out{w}.{r}", weights_only=False)
                   for r in range(w)]
    return runs


WIRE_EPS = {"fp16": 2.0 ** -11, "bf16": 2.0 ** -8}


def _wire(name):
    return name.split("_")[0] if name.startswith(("fp16", "bf16")) else None


def _order_bound(name, xs, world):
    """How far two summation orders of a narrow-wire sum may part: each
    of the ``world - 1`` additions rounds to the wire dtype (half a
    unit of the running sum, bounded by the sum of magnitudes), then
    the mean divides by ``world``.  Zero at 2 ranks (``a + b`` is
    commutative) and for exact wires."""
    if _wire(name) is None or world == 2:
        return 0.0
    # The EF residual adds at most half a wire unit to each input.
    total = np.abs(xs).sum(axis=0) * (1 + WIRE_EPS[_wire(name)])
    return (world - 1) * WIRE_EPS[_wire(name)] * total / world


def _close(name, got, want, level=None, order=0.0):
    """Casts and EF at rtol 1e-6 (beyond ``order``, the summation-order
    bound of a narrow wire), PowerSGD at 1e-4, int8 within one
    ``level``; returns the count of elements off by more than rtol
    1e-6."""
    got, want = np.asarray(got), np.asarray(want)
    off = ~np.isclose(got, want, rtol=1e-6, atol=1e-7)
    if name.startswith("int8"):
        assert np.all(np.abs(got - want) <= level * 1.0001 + 1e-7), name
        return int(off.sum())
    if name.startswith("powersgd"):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        return 0
    assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-7
                  + order), name
    return int(off.sum())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("total", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_allreduce_and_state_rows_match_jax(name, total, world, port_runs):
    """Three calls in a row, state carried: every rank's output and
    state row against the JAX compressor's row of that rank.  A state
    row is this rank's own (no sum): exact for the casts."""
    xs = _inputs(world, total)
    jout, jstate = _jax_calls(name, world, xs)
    flips = 0
    for rank in range(world):
        outs, states = port_runs[world][rank][(name, total)]
        for c in range(CALLS):
            # A bound on one level: twice the largest input a rank fed
            # bounds |grad + residual|, and the ring's hops carry sums
            # of up to ``world`` of them (its mean divides by world).
            scale = np.abs(xs[:, c]).max() * 2 / 127
            level = scale if name == "int8_ring" else scale / world
            flips += _close(name, outs[c], jout[c, rank], level,
                            _order_bound(name, xs[:, c], world))
            if states[c] is not None:
                flips += _close(name, states[c], jstate[c, rank], scale)
    print(f"{name} at {world} ranks, {total} elements: {flips} "
          f"elements apart (int8: by one level; casts: by the order of "
          f"the narrow sum)")


def _unit(port_runs, key):
    return port_runs[UNIT_WORLD][0][key]


@pytest.mark.parametrize("name", ["none", "fp16", "bf16"])
def test_stateless_mean(name, port_runs):
    tol = {"none": 1e-6, "fp16": 1e-2, "bf16": 5e-2}[name]
    mean = (UNIT_WORLD - 1) / 2
    outs = [port_runs[UNIT_WORLD][r][("stateless", name)][0][0]
            for r in range(UNIT_WORLD)]
    np.testing.assert_allclose(outs[0], np.full(16, mean), rtol=tol,
                               atol=tol)
    for out in outs:
        np.testing.assert_array_equal(out, outs[0])


@pytest.mark.parametrize("name", ["fp16_ef", "bf16_ef", "int8_ef"])
def test_error_feedback_accumulates(name, port_runs):
    assert Compressor.create(name).stateful
    outs, states = _unit(port_runs, ("ef", name))
    np.testing.assert_allclose(
        outs[0], np.mean([1.0 + 1e-4 * i for i in range(UNIT_WORLD)]),
        rtol=5e-2)
    assert np.all(np.isfinite(states[0]))


def test_ef_unbiased_over_steps(port_runs):
    """The running mean of int8-EF outputs over 50 steps approaches the
    true mean (the point of error feedback)."""
    outs, _ = _unit(port_runs, ("ef_unbiased", "int8_ef"))
    true = float(np.mean(np.linspace(0.9999, 1.0001, UNIT_WORLD)))
    np.testing.assert_allclose(np.mean(outs, axis=0), true, rtol=1e-5)


def test_unknown_compressor_raises():
    with pytest.raises(ValueError):
        Compressor.create("powersgd9000")


def test_compressor_arg_parsing():
    assert Compressor.create("powersgd:8").rank == 8
    with pytest.raises(ValueError):
        Compressor.create("fp16:2")
    with pytest.raises(ValueError):
        PowerSGDCompressor(rank=0)


def test_powersgd_first_q_matches_jax():
    from autodist_tpu.kernel.compressor import Compressor as JaxCompressor

    for total in (1, 37, 64, 1000):
        np.testing.assert_array_equal(
            Compressor.create("powersgd:3").init_state_flat(total),
            JaxCompressor.create("powersgd:3").init_state_flat(total))


def test_powersgd_exact_for_low_rank(port_runs):
    """A rank-1 gradient, the same on every rank, comes back (nearly)
    exactly from rank-2 PowerSGD in one step."""
    u = np.linspace(1.0, 2.0, 8).astype(np.float32)
    v = np.linspace(-1.0, 1.0, 8).astype(np.float32)
    outs, states = _unit(port_runs, ("powersgd_low_rank", "powersgd:2"))
    np.testing.assert_allclose(outs[0], np.outer(u, v).reshape(-1),
                               rtol=1e-4, atol=1e-5)
    assert states[0].shape[0] == len(
        Compressor.create("powersgd:2").init_state_flat(64))
    assert np.all(np.isfinite(states[0]))


def test_powersgd_ef_converges_over_steps(port_runs):
    """With error feedback the running mean of rank-2 outputs tracks the
    true mean, better at 40 steps than at 10."""
    outs, _ = _unit(port_runs, ("powersgd_ef", "powersgd"))
    true = np.random.RandomState(0).randn(UNIT_WORLD, 100).astype(
        np.float32).mean(axis=0)
    total = np.cumsum(outs, axis=0)
    errs = {s: np.abs(total[s - 1] / s - true).max() for s in (10, 40)}
    assert errs[40] < errs[10] * 0.6, errs
    np.testing.assert_allclose(total[39] / 40, true, atol=0.1)


def test_int8_ring_matches_true_mean(port_runs):
    r = np.random.RandomState(1)
    for total in (64, 100, 7, 1):
        xs = r.randn(UNIT_WORLD, 1, total).astype(np.float32)
        outs = [port_runs[UNIT_WORLD][k][("ring_mean", total)]
                for k in range(UNIT_WORLD)]
        np.testing.assert_allclose(outs[0][0][0], xs[:, 0].mean(axis=0),
                                   atol=0.1, rtol=0.1)
        for out, states in outs:
            np.testing.assert_array_equal(out[0], outs[0][0][0])
            assert np.all(np.isfinite(states[0]))


def test_int8_ring_ef_converges_over_steps(port_runs):
    outs, _ = _unit(port_runs, ("ring_ef", "int8_ring"))
    true = np.random.RandomState(0).randn(UNIT_WORLD, 96).astype(
        np.float32).mean(axis=0)
    np.testing.assert_allclose(np.mean(outs, axis=0), true, atol=0.03)


@pytest.mark.parametrize("name", list(TRAINS))
def test_compressed_training_reduces_the_loss(name, port_runs):
    """``AllReduce(compressor=...)`` trains a 32-wide linear model on 4
    ranks: 12 SGD steps cut the loss below 0.7 of the first."""
    losses = port_runs[UNIT_WORLD][0][("train", name)]
    assert losses[-1] < losses[0] * 0.7, losses


def _jax_lin_run(name, world):
    from autodist_tpu import AllReduce, AutoDist, Trainable
    from autodist_tpu.resource import ResourceSpec

    def loss_fn(p, batch):
        pred = batch["x"] @ p["dense"]["w"] + p["dense"]["b"]
        return jnp.mean((pred * p["scale"] - batch["y"]) ** 2)

    tr = Trainable.from_loss_fn(
        loss_fn, jax.tree.map(jnp.asarray, _lin_params()), optax.sgd(0.1))
    runner = AutoDist(ResourceSpec({"topology": {
        "platform": "cpu", "num_devices": world}}),
        AllReduce(chunk_size=2, compressor=name)).build(tr)
    losses = [float(np.asarray(runner.step(b)["loss"]))
              for b in _lin_batches()]
    sync = {k: np.asarray(v) for k, v in
            jax.device_get(runner.state["sync_state"]).items()}
    return losses, jax.device_get(runner.get_params()), sync


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_compressed_allreduce_lowering_matches_jax(name, world, port_runs):
    """3 SGD steps of the linear golden model under ``AllReduce(
    chunk_size=2, compressor=name)``: parameters and losses against the
    JAX runner's, and every rank's compressor state row of every bucket
    within one wire step (twice the largest residual: the residual of a
    gradient that rounds the other way moves by one unit of the wire).
    Tolerances: the golden's; PowerSGD and int8 their own; at 4 ranks
    the fp16 and bf16 sums part by their order (held exactly in
    ``test_allreduce_and_state_rows_match_jax``), and with gradients of
    this model's size (the first loss is 9.7) a unit of the wire moves
    a parameter by up to lr x 3 steps x |g| x eps: 20 wire units."""
    losses, params, sync = _jax_lin_run(name, world)
    if name.startswith(("int8", "powersgd")):
        tol = dict(rtol=1e-4, atol=1e-5)
    elif _wire(name) and world > 2:
        tol = dict(rtol=20 * WIRE_EPS[_wire(name)],
                   atol=20 * WIRE_EPS[_wire(name)])
    else:
        tol = dict(rtol=2e-5, atol=2e-6)
    for rank in range(world):
        res = port_runs[world][rank][("lin", name)]
        np.testing.assert_allclose(res["losses"], losses, **tol)
        for got, want in ((res["params"]["dense"]["w"], params["dense"]["w"]),
                          (res["params"]["dense"]["b"], params["dense"]["b"]),
                          (res["params"]["scale"], params["scale"])):
            np.testing.assert_allclose(got.numpy(), want, **tol)
        assert sorted(res["sync"]) == sorted(sync)
        for key, rows in sync.items():
            row = rows[rank]
            step = 2 * np.abs(row[:len(row) if not name.startswith(
                "powersgd") else None]).max()
            if _wire(name) and world > 2:
                step = max(step, tol["atol"])
            np.testing.assert_allclose(
                res["sync"][key], row, err_msg=key,
                **(tol if name.startswith("powersgd")
                   else dict(rtol=0, atol=step * 1.0001 + 1e-7)))
