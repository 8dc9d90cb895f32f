"""The GSPMD builders on DTensor in the port against the JAX package on
the CPU: ``Sharded``, ``TensorParallel`` and ``FSDPSharded`` on 4 gloo
ranks at data 2 x model 2 (in place of the JAX goldens' 8 devices at
data 2 x model 4), the goldens of ``tests/unit/test_gspmd.py``.

One module-scoped job of 4 ranks runs every case, started before the
JAX references are computed:

* the linear model of ``tests/unit/test_end_to_end.py`` (``dense/w [6,
  3]``, ``dense/b``, a 0-d ``scale``; batches of 16) under ``Sharded()``,
  ``Sharded`` with a model-axis rule, ``FSDPSharded(min_size=1)`` (``w``'s
  6 rows split over data 2) and ``Sharded(zero_stage=1)`` with Adam,
  against the plain optax loop on one device (2e-5 relative, 2e-6
  absolute), each rank's local shard shapes against JAX's
  ``NamedSharding`` shard shapes of the same strategy;
* a scalar feed (``scale`` in the batch) reaching every replica: the
  loss at 0.5 is half the loss at 1 (1e-6 relative);
* the transformer LM of the JAX goldens on the flax weights under
  ``TensorParallel()``: Adam losses against the one-process
  ``AllReduce`` program (5e-4 relative, 5e-5 absolute), and params after
  3 SGD steps against a plain optax loop on one device (2e-5, 2e-6);
* BERT MLM with the flash-attention adapter (its kernel under
  ``local_map`` on each rank's batch rows and heads) under
  ``TensorParallel()``: params after 3 SGD steps against the
  one-process ``AllReduce`` program (2e-5, 2e-6);
* the lowering's warnings for a compressor and ``zero_stage > 1``.

The strategies serialize to the JAX builders' JSON, and ``PS(sync=False)``
raises, as in the JAX lowering.
"""
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu_torch import testing
from autodist_tpu_torch.kernel.common import flatten_with_names
from autodist_tpu_torch.models import bert

MESH = {"data": 2, "model": 2}
JSPEC = {"topology": {"platform": "cpu", "num_devices": 4}, "mesh": MESH}
TOL = dict(rtol=2e-5, atol=2e-6)
RULES = [(r"dense/w$", ["model", None])]
LM = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
          mlp_dim=32, max_len=16, dropout_rate=0.0, attention_dropout_rate=0.0)
BERT = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
            mlp_dim=32, max_len=16, dropout_rate=0.0,
            attention_dropout_rate=0.0)
# case -> (builder spec, optimizer, steps)
LINEAR = {
    "sharded": (("Sharded", {}), ("sgd", 0.1), 3),
    "rules": (("Sharded", {"rules": RULES}), ("sgd", 0.1), 2),
    "fsdp": (("FSDPSharded", {"min_size": 1}), ("sgd", 0.1), 2),
    "zero1": (("Sharded", {"zero_stage": 1}), ("adam", 1e-2), 2),
}


def _linear_batch(seed):
    from tests.unit.test_end_to_end import make_batch

    return make_batch(seed)


def _jax_linear(opt):
    from tests.unit.test_end_to_end import make_trainable

    return make_trainable(optax.sgd(opt[1]) if opt[0] == "sgd"
                          else optax.adam(opt[1]))


def _torch_tree(tree):
    """A JAX tree of arrays as the same tree of torch tensors."""
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def _jbuilder(spec):
    from autodist_tpu.strategy import gspmd_builders

    name, kw = spec
    return getattr(gspmd_builders, name)(**kw)


def _lm_batches(n, vocab=64):
    r = np.random.RandomState(0)
    return [{"x": x, "y": x} for x in
            (r.randint(0, vocab, (8, 8)).astype(np.int32) for _ in range(n))]


def _flax_lm():
    from autodist_tpu import models

    cfg = models.TransformerConfig(**LM, dtype=jnp.float32)
    model = models.TransformerLM(cfg)
    params = model.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((4, 8), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _bert_batches(n):
    out = []
    for i in range(n):
        b = bert.synthetic_mlm_batch(i, 8, 16, 4, 64)
        b.pop("input_mask")
        out.append(b)
    return out


_WORKER = textwrap.dedent("""
    import importlib
    import logging
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.kernel.common import flatten_with_names
    from autodist_tpu_torch.models import bert
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)
    fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
    res = {}

    def opt(spec):
        return getattr(port.optim, spec[0])(spec[1])

    def linear(spec, optimizer):
        def loss_fn(p, batch):
            pred = (batch["x"] @ p["dense"]["w"] + p["dense"]["b"]) \\
                * p["scale"]
            loss = ((pred - batch["y"]) ** 2).mean()
            return loss * batch["k"] if "k" in batch else loss
        tr = port.Trainable.from_loss_fn(loss_fn, job["linear"],
                                         opt(optimizer))
        name, kw = spec
        return port.AutoDist({"mesh": job["mesh"]},
                             getattr(port, name)(**kw),
                             device="cpu").build(tr)

    for case, (spec, optimizer, steps) in job["linear_cases"].items():
        r = linear(spec, optimizer)
        for b in job["linear_batches"][:steps]:
            r.step(b)
        res[case] = {
            "params": r.get_params(),
            "local": {nm: tuple(t.shape)
                      for nm, t in r.state["params"].items()},
            "opt_local": {nm: tuple(t.shape) for nm, t in
                          r.state["opt_state"].get("mu", {}).items()},
            "strategy": r.strategy.to_json()}
    r = linear(("Sharded", {}), ("sgd", 0.1))
    b = job["linear_batches"][0]
    res["scalar"] = [float(r.eval_step(dict(b, k=torch.tensor(k)))["loss"])
                     for k in (1.0, 0.5)]

    lm_cfg = port.TransformerConfig(**job["lm_sizes"], dtype=torch.float32)
    for case, optimizer, steps, zero in (
            ("tp_lm", ("adam", 1e-2), 4, 0), ("tp_golden", ("sgd", 0.5), 3, 0),
            ("tp_zero1", ("adam", 1e-2), 4, 1)):
        tr = port.make_lm_trainable(lm_cfg, opt(optimizer),
                                    torch.Generator(), device="cpu")
        tr.params = job["lm_params"]
        r = port.AutoDist({"mesh": job["mesh"]},
                          port.TensorParallel(zero_stage=zero),
                          device="cpu").build(tr)
        losses = [float(r.step(b)["loss"])
                  for b in job["lm_batches"][:steps]]
        res[case] = {"losses": losses, "params": r.get_params(),
                     "strategy": r.strategy.to_json(),
                     "qkv": tuple(r.state["params"][
                         "encoder/layer_0/attention/qkv/kernel"].shape),
                     "opt_local": {nm: tuple(t.shape) for nm, t in
                                   r.state["opt_state"].get("mu",
                                                            {}).items()}}

    bert_cfg = port.TransformerConfig(
        **job["bert_sizes"], dtype=torch.float32,
        attention_fn=fa.make_attention_fn(False))
    tr = bert.make_mlm_trainable(bert_cfg, port.optim.sgd(0.5),
                                 torch.Generator().manual_seed(0),
                                 with_input_mask=False, device="cpu")
    r = port.AutoDist({"mesh": job["mesh"]}, port.TensorParallel(),
                      device="cpu").build(tr)
    res["bert"] = {"losses": [float(r.step(b)["loss"])
                              for b in job["bert_batches"]],
                   "params": r.get_params()}

    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    logging.getLogger("autodist_tpu_torch.kernel.gspmd").addHandler(handler)
    strategy = port.Strategy.from_json(job["warn_json"])
    tr = port.Trainable.from_loss_fn(lambda p, b: (p["dense"]["w"] ** 2).sum(),
                                     job["linear"], port.optim.sgd(0.1))
    port.AutoDist({"mesh": job["mesh"]}, device="cpu").lower(tr, strategy)
    res["warnings"] = records
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")


def _warn_json():
    """A ``Sharded`` strategy whose ``dense/w`` carries a compressor and
    whose ``dense/b`` a PS at ``zero_stage=2``."""
    tr = _jax_linear(("sgd", 0.1))
    from autodist_tpu.resource import ResourceSpec
    from autodist_tpu.strategy.gspmd_builders import Sharded

    d = json.loads(Sharded().build(tr, ResourceSpec(JSPEC)).to_json())
    for nc in d["node_configs"]:
        if nc["var_name"] == "dense/w":
            nc["synchronizer"]["compressor"] = "bf16"
        if nc["var_name"] == "dense/b":
            nc["synchronizer"] = {"kind": "ps", "zero_stage": 2}
    return json.dumps(d)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The 4-rank gloo job, started before the references are
    computed."""
    tmp = tmp_path_factory.mktemp("gspmd")
    inp, out = str(tmp / "job.pt"), str(tmp / "res.pt")
    _, lm_params = _flax_lm()
    torch.save({
        "mesh": MESH, "linear_cases": LINEAR,
        "linear": _torch_tree(_jax_linear(("sgd", 0.1)).params),
        "linear_batches": [_linear_batch(s) for s in range(3)],
        "lm_sizes": LM, "lm_params": port.from_jax_params(lm_params,
                                                          device="cpu"),
        "lm_batches": _lm_batches(4), "bert_sizes": BERT,
        "bert_batches": _bert_batches(3), "warn_json": _warn_json()}, inp)
    join = testing.launch(_WORKER, 4, (inp, out), tmp=tmp, timeout=300)

    def result():
        join()
        return torch.load(out, weights_only=False)

    return result


def _single_device(optimizer, steps):
    from tests.unit.test_end_to_end import single_device_reference

    return jax.device_get(single_device_reference(
        _jax_linear(optimizer), [_linear_batch(s) for s in range(steps)]))


def _jflat(tree):
    from autodist_tpu.capture import path_to_name

    return {path_to_name(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_refs(started):
    """The JAX references: the single-device loops, the shard shapes of
    the JAX runners' state, and the strategies' JSON."""
    from autodist_tpu import AutoDist

    out = {}
    for case, (spec, optimizer, steps) in LINEAR.items():
        runner = AutoDist(JSPEC, _jbuilder(spec)).build(
            _jax_linear(optimizer))
        try:
            shard = {nm: tuple(a.sharding.shard_shape(a.shape)) for nm, a in
                     _jflat_arrays(runner.state["params"]).items()}
            opt_shard = {nm: tuple(a.sharding.shard_shape(a.shape))
                         for nm, a in _jflat_arrays(
                             runner.state["opt_state"][0].mu).items()} \
                if optimizer[0] == "adam" else {}
            text = runner.strategy.to_json()
        finally:
            runner.close()
        out[case] = (_single_device(optimizer, steps), shard, opt_shard, text)
    return out


def _jflat_arrays(tree):
    from autodist_tpu.capture import path_to_name

    return {path_to_name(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def ranks(started, jax_refs):
    return started()


@pytest.mark.parametrize("case", list(LINEAR))
def test_linear_model_matches_single_device(ranks, jax_refs, case):
    """Each builder's params after its steps against the plain optax
    loop on one device (the JAX golden's bar)."""
    want = _jflat(jax_refs[case][0])
    got = dict(flatten_with_names(ranks[case]["params"]))
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), want[name], err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("case", list(LINEAR))
def test_local_shards_are_the_jax_shard_shapes(ranks, jax_refs, case):
    """Each rank stores the shard that ``NamedSharding`` gives its device:
    ``dense/w`` as [3, 3] under the model-axis rule and under FSDP (6
    rows over 2), the rest whole; under ZeRO-1 each Adam moment is the
    shard of JAX ``opt_spec_for``'s placement (the data axis beside the
    model rule where a dim divides)."""
    _, shard, opt_shard, _ = jax_refs[case]
    assert ranks[case]["local"] == shard
    if opt_shard:
        assert ranks[case]["opt_local"] == opt_shard


@pytest.mark.parametrize("case", list(LINEAR))
def test_strategy_json_is_the_jax_builders(ranks, jax_refs, case):
    """The port's builders serialize to the JAX builders' JSON byte for
    byte (ids aside): ``lowering="gspmd"``, the rules' specs, PS under
    ZeRO-1."""
    text = jax_refs[case][3]
    mine = ranks[case]["strategy"]
    assert mine.replace(json.loads(mine)["id"], json.loads(text)["id"],
                        1) == text
    assert json.loads(mine)["graph_config"]["lowering"] == "gspmd"


def test_scalar_feed_reaches_every_replica(ranks):
    """A 0-d batch leaf is replicated, not split: the loss at 0.5 is half
    the loss at 1."""
    l1, l05 = ranks["scalar"]
    np.testing.assert_allclose(l05, 0.5 * l1, rtol=1e-6)


def test_tensor_parallel_lm_matches_all_reduce(ranks):
    """``TensorParallel()`` on the transformer LM: the qkv kernel stored
    as its model shard; Adam losses against the one-process
    ``AllReduce`` program on the same weights."""
    _, params = _flax_lm()
    tr = port.make_lm_trainable(port.TransformerConfig(
        **LM, dtype=torch.float32), port.optim.adam(1e-2),
        torch.Generator(), device="cpu")
    tr.params = port.from_jax_params(params, device="cpu")
    runner = port.AutoDist({}, port.AllReduce(), device="cpu").build(tr)
    want = [float(runner.step(b)["loss"]) for b in _lm_batches(4)]
    got = ranks["tp_lm"]
    assert got["qkv"] == (16, 3, 1, 8)
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], want, rtol=5e-4, atol=5e-5)
    # ZeRO-1 beside the model split: Adam's moments shard over data too
    # (``wo`` rows over model x data), and the program trains alike.
    np.testing.assert_allclose(ranks["tp_zero1"]["losses"], want,
                               rtol=5e-4, atol=5e-5)


def test_tensor_parallel_zero1_state_is_the_jax_shard_shapes(ranks):
    """``TensorParallel(zero_stage=1)`` on the LM: each rank's Adam
    moments are the shards ``opt_spec_for``'s placements give its device
    in the JAX runner (dim 0 extended over data beside the model split,
    else the first free divisible dim)."""
    from autodist_tpu import AutoDist, Trainable

    _, params = _flax_lm()
    jtr = Trainable.from_loss_fn(lambda p, b: 0.0, params, optax.adam(1e-2))
    runner = AutoDist(JSPEC, _jbuilder(("TensorParallel",
                                        {"zero_stage": 1}))).build(jtr)
    try:
        want = {nm: tuple(a.sharding.shard_shape(a.shape)) for nm, a in
                _jflat_arrays(runner.state["opt_state"][0].mu).items()}
    finally:
        runner.close()
    got = ranks["tp_zero1"]["opt_local"]
    assert got == want
    assert got["encoder/layer_0/mlp/wo/kernel"] == (8, 16)


def test_tensor_parallel_params_match_single_device(ranks):
    """Params after 3 SGD steps under ``TensorParallel()`` at data 2 x
    model 2 against a plain optax loop on one device, the JAX golden."""
    from autodist_tpu import models

    model, params = _flax_lm()

    def loss_fn(p, batch):
        logits = model.apply({"params": p}, batch["x"], deterministic=True)
        return models.lm_loss_head(logits, batch)[0]

    ref = jax.tree.map(jnp.asarray, params)
    opt = optax.sgd(0.5)
    state = opt.init(ref)
    for b in _lm_batches(3):
        grads = jax.grad(loss_fn)(ref, jax.tree.map(jnp.asarray, b))
        updates, state = opt.update(grads, state, ref)
        ref = optax.apply_updates(ref, updates)
    want = _jflat(jax.device_get(ref))
    for name, p in flatten_with_names(ranks["tp_golden"]["params"]):
        np.testing.assert_allclose(p.numpy(), want[name], err_msg=name,
                                   **TOL)


def test_tensor_parallel_strategy_json_is_the_jax_builders(ranks):
    """``TensorParallel()`` on the LM serializes to the JAX builder's
    JSON (ids aside)."""
    from autodist_tpu import AutoDist, Trainable

    _, params = _flax_lm()
    jtr = Trainable.from_loss_fn(lambda p, b: 0.0, params, optax.sgd(0.5))
    text = AutoDist(JSPEC, _jbuilder(("TensorParallel", {}))) \
        .build_or_load_strategy(jtr).to_json()
    mine = ranks["tp_golden"]["strategy"]
    assert mine.replace(json.loads(mine)["id"], json.loads(text)["id"],
                        1) == text


def test_bert_with_flash_attention_matches_all_reduce(ranks):
    """BERT MLM with the flash-attention adapter under
    ``TensorParallel()``: the kernel runs under ``local_map`` on each
    rank's rows and heads; params after 3 SGD steps against the
    one-process ``AllReduce`` program."""
    fa = __import__("importlib").import_module(
        "autodist_tpu_torch.ops.flash_attention")
    cfg = port.TransformerConfig(**BERT, dtype=torch.float32,
                                 attention_fn=fa.make_attention_fn(False))
    tr = bert.make_mlm_trainable(cfg, port.optim.sgd(0.5),
                                 torch.Generator().manual_seed(0),
                                 with_input_mask=False, device="cpu")
    runner = port.AutoDist({}, port.AllReduce(), device="cpu").build(tr)
    want = [float(runner.step(b)["loss"]) for b in _bert_batches(3)]
    got = ranks["bert"]
    np.testing.assert_allclose(got["losses"], want, **TOL)
    ref = dict(flatten_with_names(runner.get_params()))
    for name, p in flatten_with_names(got["params"]):
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(),
                                   err_msg=name, **TOL)


def test_compressor_and_zero_stage_warn(ranks):
    """A compressor and a ``zero_stage > 1`` PS lower with the JAX
    lowering's warnings and train the plain program."""
    warned = " ".join(ranks["warnings"])
    assert "ignores compressor config" in warned
    assert "zero_stage>1" in warned


def test_async_ps_raises():
    """``PS(sync=False)`` under the gspmd lowering raises in the JAX
    package's words, which name the ``AsyncPSRunner`` (before any group
    is made); a stale PS lowers with its bound."""
    tr = _jax_linear(("sgd", 0.1))
    from autodist_tpu.resource import ResourceSpec
    from autodist_tpu.strategy.gspmd_builders import Sharded

    d = json.loads(Sharded().build(tr, ResourceSpec(JSPEC)).to_json())
    d["node_configs"][0]["synchronizer"] = {"kind": "ps", "sync": False}
    ptr = port.Trainable.from_loss_fn(lambda p, b: p["scale"],
                                      _torch_tree(tr.params),
                                      port.optim.sgd(0.1))
    with pytest.raises(NotImplementedError,
                       match=r"sync=False.*\(AsyncPSRunner\)"):
        port.AutoDist({}, device="cpu").lower(
            ptr, port.Strategy.from_json(json.dumps(d)))
    d["node_configs"][0]["synchronizer"] = {"kind": "ps", "staleness": 3}
    lowered = port.AutoDist({}, device="cpu").lower(
        ptr, port.Strategy.from_json(json.dumps(d)))
    assert lowered.ssp_staleness == 3
    lowered.release()


def test_builder_checks_match_jax():
    """``zero_stage > 1`` and a rule of the wrong rank raise the JAX
    builders' ValueErrors."""
    from autodist_tpu.resource import ResourceSpec

    with pytest.raises(ValueError, match="FSDPSharded"):
        port.Sharded(zero_stage=2)
    with pytest.raises(ValueError, match="does not match rank"):
        port.Sharded([(r"dense/w$", ["model"])]).build(
            port.Trainable.from_loss_fn(
                lambda p, b: 0.0, {"dense": {"w": torch.zeros(6, 3)}},
                port.optim.sgd(0.1)),
            ResourceSpec({"mesh": {"data": 1}}))


_ONE_RANK = textwrap.dedent("""
    import torch
    import torch.distributed as dist
    import autodist_tpu_torch as port
    cfg = port.TransformerConfig(
        vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
        mlp_dim=32, max_len=16, dtype=torch.float32, dropout_rate=0.0,
        attention_dropout_rate=0.0)
    x = torch.randint(0, 64, (4, 8), generator=torch.Generator().manual_seed(0))
    runners = [port.AutoDist({"mesh": {"data": 1, "model": 1}},
                             port.TensorParallel(), device="cpu").build(
                   port.make_lm_trainable(cfg, port.optim.sgd(0.1),
                                          torch.Generator(), device="cpu"))
               for _ in range(2)]
    assert dist.is_initialized() and dist.get_world_size() == 1
    losses = [float(r.step({"x": x, "y": x})["loss"]) for r in runners]
    assert losses[0] == losses[1], losses
    runners[0].close()
    assert dist.is_initialized(), "the first close took the shared group"
    runners[1].step({"x": x, "y": x})
    runners[1].close()
    runners[1].close()
    assert not dist.is_initialized(), "the last close left the group"
""")


def test_one_rank_group_goes_with_the_last_runner(tmp_path):
    """A process with no process group gets a one-rank group from the
    gspmd lowering; the runners on it share it, and the last one's
    ``close()`` destroys it."""
    testing.launch(_ONE_RANK, 1, tmp=tmp_path, timeout=120)()
