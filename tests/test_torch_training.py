"""The port's training path against the JAX package's, on the CPU.

A 2-layer BERT (hidden 128, 2 heads of 64, vocabulary 97) is built by
the JAX package, its weights are converted into the port
(:func:`autodist_tpu_torch.from_jax_params`), and both sides get the
same numpy batches (``synthetic_mlm_batch``, one stream for an integer
seed).  Everything runs in fp32 with dropout off (the two packages'
random bits differ), and agreements are held at atol = rtol = 1e-5:
both sides compute the same fp32 arithmetic, in other summation orders.
Attention is the einsum path here; the flash path's parity is
``tests/test_torch_flash_attention.py``.
"""
import copy
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
from autodist_tpu import AllReduce as JaxAllReduce
from autodist_tpu import AutoDist as JaxAutoDist
from autodist_tpu.capture import path_to_name
from autodist_tpu.models import bert as jbert
from autodist_tpu.models.transformer import TransformerConfig as JaxConfig
from autodist_tpu.resource import ResourceSpec as JaxResourceSpec
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.models import bert as tbert
from autodist_tpu_torch.ops.flash_attention import make_attention_fn
from autodist_tpu_torch.resource import H100

TOL = dict(atol=1e-5, rtol=1e-5)
SIZES = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
             mlp_dim=256, max_len=32, dropout_rate=0.0,
             attention_dropout_rate=0.0)
B, L, P = 4, 16, 4


def _tcfg(**kw):
    return port.TransformerConfig(**SIZES, dtype=torch.float32, **kw)


def _jflat(tree):
    return {path_to_name(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(seed):
    return jbert.synthetic_mlm_batch(seed, B, L, P, SIZES["vocab_size"])


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jtrainable():
    return jbert.make_mlm_trainable(
        JaxConfig(**SIZES, dtype=jnp.float32), optax.sgd(0.1),
        jax.random.PRNGKey(0), batch_size=2, seq_len=L, num_masked=P)


@pytest.fixture(scope="module")
def jparams(jtrainable):
    return jax.tree.map(np.asarray, jtrainable.params)


def _jax_trainable(optimizer, jtrainable):
    trainable = copy.copy(jtrainable)
    trainable.optimizer = optimizer
    return trainable


def _port_trainable(optimizer, jparams, **cfg_kw):
    trainable = tbert.make_mlm_trainable(
        _tcfg(**cfg_kw), optimizer, torch.Generator().manual_seed(0),
        device="cpu", with_input_mask="attention_fn" not in cfg_kw)
    trainable.params = port.from_jax_params(jparams, device="cpu")
    return trainable


def _port_loss_and_grads(trainable, batch):
    leaves = {n: t.clone().requires_grad_()
              for n, t in flatten_with_names(trainable.params)}
    loss, _, metrics = trainable.loss(unflatten(leaves), None,
                                      _torch_batch(batch), 0)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, metrics, dict(zip(leaves, grads))


def test_var_infos_match_jax(jtrainable, jparams):
    ttr = _port_trainable(port.optim.sgd(0.1), jparams)
    assert ([(v.name, v.shape, v.is_sparse) for v in ttr.var_infos()]
            == [(v.name, tuple(v.shape), v.is_sparse)
                for v in jtrainable.var_infos()])


def test_loss_and_every_gradient_match_jax(jtrainable, jparams):
    """At fp32 on converted weights: the MLM loss, its accuracy metric
    and the gradient of every variable."""
    batch = _batch(3)

    def jloss(p):
        loss, _, metrics = jtrainable.loss(p, None, batch,
                                           jax.random.PRNGKey(1))
        return loss, metrics

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        jtrainable.params)
    loss, metrics, grads = _port_loss_and_grads(
        _port_trainable(port.optim.sgd(0.1), jparams), batch)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    np.testing.assert_allclose(float(metrics["mlm_accuracy"]),
                               float(jm["mlm_accuracy"]), **TOL)
    jg = _jflat(jg)
    assert set(grads) == set(jg)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jg[name], **TOL,
                                   err_msg=name)


def test_flash_attention_fn_trains_like_the_einsum_path(jparams):
    """The same model with ``attention_fn=make_attention_fn(False)``
    (batches without ``input_mask``) gives the einsum path's loss and
    gradients."""
    batch = _batch(4)
    batch.pop("input_mask")
    el, _, eg = _port_loss_and_grads(
        _port_trainable(port.optim.sgd(0.1), jparams), batch)
    fl, _, fg = _port_loss_and_grads(
        _port_trainable(port.optim.sgd(0.1), jparams,
                        attention_fn=make_attention_fn(False)), batch)
    torch.testing.assert_close(fl, el, **TOL)
    for name in eg:
        torch.testing.assert_close(fg[name], eg[name], **TOL)


def test_flash_attention_fn_refuses_a_padding_mask_at_build():
    with pytest.raises(ValueError, match="input_mask"):
        tbert.make_mlm_trainable(
            _tcfg(attention_fn=make_attention_fn(False)), port.optim.sgd(0.1),
            torch.Generator().manual_seed(0), device="cpu")


def test_sgd_steps_through_autodist_match_the_jax_runner(jtrainable,
                                                         jparams):
    """Three SGD steps through ``AutoDist`` + ``AllReduce(chunk_size=2)``
    on one replica each: the losses and the parameters after the steps."""
    jr = JaxAutoDist(JaxResourceSpec({"topology": {"num_devices": 1}}),
                     JaxAllReduce(chunk_size=2)).build(
        _jax_trainable(optax.sgd(0.1), jtrainable))
    tr = port.AutoDist({}, port.AllReduce(chunk_size=2), device="cpu").build(
        _port_trainable(port.optim.sgd(0.1), jparams))
    assert len(tr.lowered.plan.buckets) == 17       # 34 variables, 2 each
    for i in range(3):
        batch = _batch(10 + i)
        np.testing.assert_allclose(float(tr.step(batch)["loss"]),
                                   float(jr.step(batch)["loss"]), **TOL)
    want = _jflat(jr.get_params())
    for name, p in flatten_with_names(tr.get_params()):
        np.testing.assert_allclose(p.numpy(), want[name], **TOL,
                                   err_msg=name)
    assert tr.step_count == 3


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(weight_decay=0.01, mu_dtype="bfloat16")),
    ("adamw", dict()),
    ("adam", dict(b1=0.8, eps=1e-6)),
    ("sgd", dict()),
])
def test_optimizer_matches_optax(name, kw):
    """Three updates of the port's optimizer against optax's on the same
    params and gradients; with ``mu_dtype=bfloat16`` the first moments
    agree too, bit for bit as bf16 values."""
    r = np.random.RandomState(0)
    params = {"a": r.randn(7, 5).astype(np.float32),
              "b": {"c": r.randn(11).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: r.randn(*x.shape).astype(np.float32),
                          params) for _ in range(3)]
    jkw = dict(kw, mu_dtype=jnp.bfloat16) if "mu_dtype" in kw else kw
    tkw = dict(kw, mu_dtype=torch.bfloat16) if "mu_dtype" in kw else kw
    jopt = getattr(optax, name)(1e-2, **jkw)
    topt = getattr(port.optim, name)(1e-2, **tkw)
    jp, jstate = params, jopt.init(params)
    tp = {n: torch.as_tensor(x) for n, x in flatten_with_names(params)}
    tstate = topt.init(tp)
    for g in grads:
        upd, jstate = jopt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tg = {n: torch.as_tensor(x) for n, x in flatten_with_names(g)}
        tupd, tstate = topt.update(tg, tstate, tp)
        tp = port.optim.apply_updates(tp, tupd)
    for n, x in flatten_with_names(jp):
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(x), **TOL)
    if "mu_dtype" in kw:
        mu = _jflat(jstate[0].mu)
        for n, m in tstate["mu"].items():
            assert m.dtype == torch.bfloat16
            np.testing.assert_array_equal(m.float().numpy(),
                                          mu[n].astype(np.float32))


def test_allreduce_strategy_json_round_trips_byte_for_byte(jtrainable,
                                                          jparams):
    """A strategy the JAX AllReduce builder wrote reads back into the
    port and re-emits the same bytes; the port's builder emits the same
    node configs for the same model."""
    jstrategy = JaxAllReduce(chunk_size=2).build(
        jtrainable,
        JaxResourceSpec({"topology": {"num_devices": 1}}))
    text = jstrategy.to_json()
    assert port.Strategy.from_json(text).to_json() == text
    mine = port.AllReduce(chunk_size=2).build(
        _port_trainable(port.optim.sgd(0.1), jparams), port.ResourceSpec({}))
    mine.id = jstrategy.id
    assert mine.to_json() == text


def test_interop_round_trips_the_bert_tree_bit_exactly(jparams):
    back = port.to_jax_params(port.from_jax_params(jparams, device="cpu"))
    got, want = _jflat(back), _jflat(jparams)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])


def test_interop_rejects_a_partial_bert_tree(jparams):
    tree = jax.tree.map(np.asarray, jparams)
    del tree["encoder"]["layer_1"]["mlp"]
    with pytest.raises(ValueError, match="layer_1/mlp/wi/kernel"):
        port.from_jax_params(tree, device="cpu")


def test_run_steps_equals_step_calls(jparams):
    """A ``run_steps`` window of k steps and k ``step`` calls from the
    same seed: the same metrics, stacked ``[k]``, and the same params."""
    batches = [_batch(20 + i) for i in range(3)]

    def runner():
        return port.AutoDist({}, port.AllReduce(), device="cpu").build(
            _port_trainable(port.optim.adamw(1e-3), jparams), seed=5)

    a, b = runner(), runner()
    stepped = [a.step(batch)["loss"] for batch in batches]
    window = b.run_steps(port.stack_steps(batches))
    assert window["loss"].shape == (3,)
    torch.testing.assert_close(window["loss"], torch.stack(stepped),
                               atol=0, rtol=0)
    for (n, x), (_, y) in zip(flatten_with_names(a.get_params()),
                              flatten_with_names(b.get_params())):
        torch.testing.assert_close(x, y, atol=0, rtol=0, msg=n)


def test_run_steps_with_dropout_equals_step_calls_with_those_seeds():
    """Dropout on (hidden and attention, 0.1) and explicit ``rngs``: a
    ``run_steps`` window equals ``step`` calls given the same seeds, bit
    for bit, and other seeds give other losses.  (On the card the window
    is one CUDA-graph replay that draws each step's masks from a
    ``GraphSeed``; here it is the host loop, which the GPU tests hold
    the replay to.)"""
    cfg = port.TransformerConfig(**dict(SIZES, dropout_rate=0.1,
                                        attention_dropout_rate=0.1),
                                 dtype=torch.float32)
    batches = [_batch(40 + i) for i in range(3)]
    rngs = [101, 7, 2 ** 31 - 2]

    def runner():
        return port.AutoDist({}, port.AllReduce(), device="cpu").build(
            tbert.make_mlm_trainable(cfg, port.optim.sgd(0.1),
                                     torch.Generator().manual_seed(0),
                                     device="cpu"))

    a, b, c = runner(), runner(), runner()
    stepped = [a.step(batch, rng=r)["loss"] for batch, r in
               zip(batches, rngs)]
    window = b.run_steps(port.stack_steps(batches), rngs=rngs)
    torch.testing.assert_close(window["loss"], torch.stack(stepped),
                               atol=0, rtol=0)
    for (n, x), (_, y) in zip(flatten_with_names(a.get_params()),
                              flatten_with_names(b.get_params())):
        torch.testing.assert_close(x, y, atol=0, rtol=0, msg=n)
    other = c.run_steps(port.stack_steps(batches), rngs=[5, 6, 8])["loss"]
    assert not torch.equal(other, window["loss"])
    assert not b.lowered.capturable and b.captures == b.replays == 0


@pytest.mark.parametrize("bad", ["ragged", "scalar"])
def test_run_steps_window_shape_errors_raise(jparams, bad):
    """``run_steps`` needs one leading steps dimension on every leaf
    (the contract of the JAX package's
    ``test_run_steps_ragged_leading_dim_raises``): a ragged one, or a
    leaf without it, raises before any step runs."""
    runner = port.AutoDist({}, port.AllReduce(), device="cpu").build(
        _port_trainable(port.optim.sgd(0.1), jparams))
    window = port.stack_steps([_batch(1), _batch(2)])
    if bad == "ragged":
        window["masked_ids"] = window["masked_ids"][:1]
    else:
        window["masked_weights"] = np.float32(1.0)
    with pytest.raises(ValueError, match="same leading steps dimension"):
        runner.run_steps(window)
    assert runner.step_count == 0


_STAGING_WORKER = textwrap.dedent("""
    import json, sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.models import bert
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    cfg = port.TransformerConfig(vocab_size=97, hidden_size=128, num_layers=1,
                                 num_heads=2, mlp_dim=256, max_len=32,
                                 dropout_rate=0.0, attention_dropout_rate=0.0,
                                 dtype=torch.float32)

    def lowered():
        trainable = bert.make_mlm_trainable(
            cfg, port.optim.sgd(0.5), torch.Generator().manual_seed(0),
            device="cpu")
        runner = port.AutoDist({}, port.AllReduce(), device="cpu").build(
            trainable)
        runner.run_steps(port.stack_steps(
            [bert.synthetic_mlm_batch(i, 4, 16, 4, 97) for i in range(2)]))
        return {"host_staged": runner.lowered.host_staged,
                "capturable": runner.lowered.capturable,
                "captures": runner.captures}

    alone = lowered()
    testing.init_rank(rank, world, store)
    joined = lowered()
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"alone": alone, "gloo": joined}, f)
    testing.end_rank()
""")


def test_a_lowering_over_a_gloo_group_reports_host_staging(tmp_path):
    """Two gloo ranks stage every CUDA collective through host memory,
    which a CUDA graph cannot hold: their lowering says so and takes the
    host loop (no capture); the same model in one process stages
    nothing."""
    out = tmp_path / "staging.json"
    testing.launch(_STAGING_WORKER, 2, (str(out),), tmp=tmp_path,
                   timeout=180)()
    got = json.loads(out.read_text())
    assert got["alone"] == {"host_staged": False, "capturable": False,
                            "captures": 0}
    assert got["gloo"] == {"host_staged": True, "capturable": False,
                           "captures": 0}


_GLOO_WORKER = textwrap.dedent("""
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.models import bert
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    if world > 1:
        testing.init_rank(rank, world, store)
    cfg = port.TransformerConfig(vocab_size=97, hidden_size=128, num_layers=2,
                                 num_heads=2, mlp_dim=256, max_len=32,
                                 dropout_rate=0.0, attention_dropout_rate=0.0,
                                 dtype=torch.float32)
    trainable = bert.make_mlm_trainable(cfg, port.optim.sgd(0.5),
                                        torch.Generator().manual_seed(0),
                                        device="cpu")
    runner = port.AutoDist({}, port.AllReduce(chunk_size=8),
                           device="cpu").build(trainable)
    losses = [runner.step(bert.synthetic_mlm_batch(30 + i, 4, 16, 4, 97))["loss"]
              for i in range(2)]
    if rank == 0:
        torch.save({"losses": torch.stack(losses),
                    "params": runner.get_params()}, out)
    testing.end_rank()
""")


def _run_gloo(world, tmp_path):
    tmp = tmp_path / f"world{world}"
    out = str(tmp / "out.pt")
    testing.launch(_GLOO_WORKER, world, (out,), tmp=tmp, timeout=180)()
    return torch.load(out)


def test_two_gloo_ranks_on_half_batches_match_one_rank(tmp_path):
    """Two processes, each stepping on its half of the batch and meeting
    in the bucketed gloo all-reduce, train the same model as one process
    on the whole batch: the same (rank-averaged) losses and params."""
    one, two = _run_gloo(1, tmp_path), _run_gloo(2, tmp_path)
    torch.testing.assert_close(two["losses"], one["losses"], **TOL)
    for (n, x), (_, y) in zip(flatten_with_names(two["params"]),
                              flatten_with_names(one["params"])):
        torch.testing.assert_close(x, y, **TOL, msg=n)


_PRECISION_WORKER = textwrap.dedent("""
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.models import bert
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)
    cfg = port.TransformerConfig(**job["sizes"], dtype=torch.float32)
    trainable = bert.make_mlm_trainable(cfg, port.optim.sgd(0.1),
                                        torch.Generator().manual_seed(0),
                                        device="cpu")
    trainable.params = job["params"]
    runner = port.AutoDist({}, device="cpu").build(
        trainable, port.Strategy.from_json(job["strategy"]))
    losses = [float(runner.step(b)["loss"]) for b in job["batches"]]
    if rank == 0:
        torch.save({"losses": losses, "params": runner.get_params(),
                    "unapplied": runner.lowered.unapplied}, out)
    testing.end_rank()
""")


def test_collective_precision_policy_trains_the_jax_fp32_program(
        jtrainable, jparams, tmp_path):
    """An ``AllReduce`` strategy whose JSON sets ``precision`` (the
    ``grad`` and ``tp_psum`` slots) on the collective lowering, on 2 gloo
    ranks: the JAX package's collective lowering reads no precision, so
    the JAX program is the fp32 one; the port's losses and parameters
    after 3 SGD steps equal the JAX runner's on 2 devices (1e-5), and
    both slots are recorded as unapplied."""
    spec = JaxResourceSpec({"topology": {"num_devices": 2}})
    doc = JaxAllReduce(chunk_size=2).build(jtrainable, spec).to_json()
    assert '"precision": {}' in doc
    batches = [_batch(20 + i) for i in range(3)]
    inp, out = str(tmp_path / "job.pt"), str(tmp_path / "out.pt")
    torch.save({"sizes": SIZES, "params": port.from_jax_params(
        jparams, device="cpu"), "batches": batches,
        "strategy": doc.replace('"precision": {}', '"precision": '
                                '{"grad": "bf16", "tp_psum": "int8"}')},
        inp)
    join = testing.launch(_PRECISION_WORKER, 2, (inp, out), tmp=tmp_path,
                          timeout=180)
    jr = JaxAutoDist(spec, JaxAllReduce(chunk_size=2)).build(
        _jax_trainable(optax.sgd(0.1), jtrainable))
    want = [float(jr.step(b)["loss"]) for b in batches]
    join()
    got = torch.load(out, weights_only=False)
    np.testing.assert_allclose(got["losses"], want, **TOL)
    params = _jflat(jr.get_params())
    for name, p in flatten_with_names(got["params"]):
        np.testing.assert_allclose(p.numpy(), params[name], **TOL,
                                   err_msg=name)
    assert set(got["unapplied"]) == {"grad", "tp_psum"}


@pytest.mark.parametrize("what", ["compressor", "compressor_json",
                                  "builder", "ps_json", "partitioner_json",
                                  "mesh_axis", "topology_key", "multihost",
                                  "remat", "default_builder"])
def test_out_of_slice_options_raise(what, jtrainable, jparams):
    """What this slice does not port raises ``NotImplementedError``
    naming its ROADMAP item.  The cases once refused that run now are
    held to what they build: the pipeline's compressors and remat
    beside ``comm_overlap="rsag"``, the GSPMD builders by name, and the
    multi-slice spec (a ``dcn`` axis, ``topology.num_slices``) against
    the JAX package's plan."""
    jstrategy = JaxAllReduce().build(
        jtrainable,
        JaxResourceSpec({"topology": {"num_devices": 1}}))
    doc = jstrategy.to_json()
    spec = JaxResourceSpec({"topology": {"num_devices": 1}})
    if what == "compressor_json":
        # A precision policy on the collective lowering trains the fp32
        # program, as the JAX package's (which reads none), its slots
        # recorded as unapplied.
        strategy = port.Strategy.from_json(doc.replace(
            '"precision": {}', '"precision": {"grad": "bf16"}'))
        lowered = port.AutoDist({}, port.AllReduce(), device="cpu").lower(
            _port_trainable(port.optim.sgd(0.1), jparams), strategy)
        assert set(lowered.unapplied) == {"grad"}
        return
    if what in ("compressor", "remat"):
        b = port.Pipeline(compressor="bf16_ef", tensor_parallel=2,
                          comm_overlap="rsag") if what == "compressor" \
            else port.Pipeline(remat=True, tensor_parallel=2,
                               comm_overlap="rsag")
        assert b.comm_overlap == "rsag"
        return
    if what == "builder":
        ad = port.AutoDist({}, "FSDPSharded", min_size=16)
        assert isinstance(ad.strategy_builder, port.FSDPSharded)
        strategy = ad.build_or_load_strategy(
            _port_trainable(port.optim.sgd(0.1), jparams))
        assert strategy.graph_config.lowering == "gspmd"
        return
    if what in ("ps_json", "partitioner_json"):
        # Asynchronous PS, and stale-synchronous PS: the JSON reads
        # back.  The lowering refuses sync=False in the JAX package's
        # words and AutoDist.build runs it on the AsyncPSRunner; a stale
        # PS lowers, its bound on the lowered program.
        from autodist_tpu import PS as JaxPS

        kw = {"sync": False} if what == "ps_json" else {"staleness": 2}
        strategy = port.Strategy.from_json(
            JaxPS(**kw).build(jtrainable, spec).to_json())
        ad = port.AutoDist({}, device="cpu")
        tr = _port_trainable(port.optim.sgd(0.1), jparams)
        if what == "partitioner_json":
            lowered = ad.lower(tr, strategy)
            assert lowered.ssp_staleness == 2
            assert lowered.plan.ssp_staleness == 2
            return
        with pytest.raises(NotImplementedError,
                           match=r"sync=False.*AsyncPSRunner"):
            ad.lower(tr, strategy)
        runner = ad.build(tr, strategy)
        assert isinstance(runner, port.AsyncPSRunner)
        runner.close()
        return
    if what == "mesh_axis":
        # A dcn axis is the outer replica axis: the AllReduce plan of a
        # dcn x data layout (planned on the declared devices) is the
        # JAX package's.
        sliced = {"topology": {"num_devices": 2}, "mesh": {"data": 1,
                                                          "dcn": 2}}
        strategy = port.AllReduce().build(
            _port_trainable(port.optim.sgd(0.1), jparams),
            port.ResourceSpec(sliced))
        jdoc = JaxAllReduce().build(jtrainable,
                                    JaxResourceSpec(sliced)).to_json()
        assert strategy.graph_config.replicas == 2
        assert json.loads(strategy.to_json())["graph_config"] == \
            json.loads(jdoc)["graph_config"]
        return
    if what == "topology_key":
        # platform, generation and num_slices are ported; an unknown
        # key is refused.
        port.ResourceSpec({"topology": {"platform": "gpu",
                                        "generation": "h100"}})
        assert port.ResourceSpec({"topology": {
            "num_devices": 4, "num_slices": 2}}).resolved_mesh_shape() \
            == {"dcn": 2, "data": 2}
        with pytest.raises(ValueError, match="unknown topology keys"):
            port.ResourceSpec({"topology": {"num_pods": 2}})
        return
    if what == "multihost":
        # The multihost block plans on a declared device count until it
        # bootstraps, a dcn axis among its mesh axes.
        spec = port.ResourceSpec({"topology": {"num_devices": 2},
                                  "multihost": {"num_processes": 2}})
        assert spec.is_multihost and spec.num_devices() == 2
        sliced = port.ResourceSpec({"topology": {"num_devices": 2},
                                    "multihost": {"num_processes": 2},
                                    "mesh": {"dcn": 2, "data": 1}})
        assert sliced.three_d() == (2, 1, 1)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        # The default builder runs; AutoStrategy does not yet.
        port.AutoDist({}, "AutoStrategy")


def test_chip_spec_is_the_h100s_alone():
    """``ResourceSpec.chip`` gives the H100's rates on an H100 and
    raises on any other device, the CPU included."""
    spec = port.ResourceSpec({})
    if torch.cuda.is_available() and "H100" in torch.cuda.get_device_name(0):
        assert spec.chip is H100 and spec.chip.peak_bf16_tflops == 989.0
    else:
        with pytest.raises(NotImplementedError, match="only the H100"):
            spec.chip


def test_entry_points_default_to_the_card():
    """``device=None`` means CUDA: without a card the entry points raise
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbert.make_mlm_trainable(_tcfg(), port.optim.sgd(0.1),
                                 torch.Generator())
    trainable = tbert.make_mlm_trainable(_tcfg(), port.optim.sgd(0.1),
                                         torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.AutoDist({}, port.AllReduce()).build(trainable)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_hot_lookups_equal_the_gathers_they_replace(dtype):
    """BERT's segment lookup and masked-position gather are one-hot
    products (their backward sums repeated rows in a fixed order on the
    card): bit-equal to ``F.embedding`` and ``torch.gather``, with rows
    and positions picked many times; their gradients are the float64
    sums within one rounding of the result (2^-8 relative in bf16, 2^-24
    in fp32) and an fp32 sum's error, n 2^-24 times the sum of the
    terms' magnitudes (n = 128, the rows looked up)."""
    b = tbert.synthetic_mlm_batch(0, 4, 32, 12, 64)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, 48, generator=gen).to(dtype)
    table = torch.randn(2, 48, generator=gen).to(dtype)
    seg = torch.as_tensor(b["segment_ids"]).long()
    pos = torch.as_tensor(b["masked_positions"]).long()
    assert (pos[:, 1:] == pos[:, :-1]).any()          # repeated positions

    def lookups(table, x, one_hot):
        if one_hot:
            return (tbert.one_hot(seg, 2, table.dtype) @ table,
                    tbert.one_hot(pos, 32, x.dtype) @ x)
        return (torch.nn.functional.embedding(seg, table),
                torch.gather(x, 1, pos[..., None].expand(-1, -1, 48)))

    leaves = (table.requires_grad_(), x.requires_grad_())
    got, want = lookups(*leaves, True), lookups(*leaves, False)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    dy = [torch.randn(t.shape, generator=gen).to(dtype) for t in got]
    grads = torch.autograd.grad(got, leaves, dy)
    wide = [t.detach().double().requires_grad_() for t in leaves]
    exact = torch.autograd.grad(lookups(*wide, False), wide,
                                [t.double() for t in dy])
    magnitude = torch.autograd.grad(lookups(*wide, False), wide,
                                    [t.double().abs() for t in dy])
    unit = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
    for g, e, m in zip(grads, exact, magnitude):
        bound = unit * e.abs() + 128 * 2.0 ** -24 * m
        assert ((g.double() - e).abs() <= bound).all()
