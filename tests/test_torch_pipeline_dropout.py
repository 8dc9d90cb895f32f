"""Per-(stage, row) dropout and per-stage aux losses in the port's
pipeline, on 4 gloo ranks on the CPU.

The pipelined LM with dropout (``stage_rng``: each mask keyed on the
global chunk and the global row, drawn counter-based) must reproduce
the port's own sequential program (``PipelineTrainable.loss``) for any
microbatch count, with interleaving, under ``GradAccumulation`` and with
the batch split over a data axis: the JAX package's contract
(``tests/unit/test_pipeline_dropout.py``), whose masks the port does not
reproduce bit for bit (flax folds module paths into its keys).  At
dropout 0 the program is held to the JAX ``Pipeline`` runner.  A stage
with an aux loss on dict activations is held to JAX
``test_pipeline_pytree_activations_and_stage_aux``'s program.

The config of the JAX goldens (vocab 64, hidden 16, 4 layers, 2 heads,
mlp 32, length 16, fp32, dropout 0.1 and attention dropout 0.1) at data
2 x pipe 2, V = 2, on the JAX trainable's weights; 2 SGD steps at lr 0.1
on numpy batches of 8 with seeds 100 and 101.  Tolerances: params 1e-5
absolute and relative against the sequential program, and against the
JAX program at dropout 0; the aux program's loss, aux and params 1e-5.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu_torch import testing
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.models import pipeline_lm as tlm

SIZES = dict(vocab_size=64, hidden_size=16, num_layers=4, num_heads=2,
             mlp_dim=32, max_len=16)
DROP = dict(dropout_rate=0.1, attention_dropout_rate=0.1)
NO_DROP = dict(dropout_rate=0.0, attention_dropout_rate=0.0)
MESH = {"data": 2, "pipe": 2}
SEEDS = (100, 101)
LR = 0.1
TOL = dict(atol=1e-5, rtol=1e-5)
HID = 8
# name -> (Pipeline keywords, accumulation steps)
CASES = {
    "m1": (dict(num_microbatches=1, virtual_stages=2), 1),
    "m2": (dict(num_microbatches=2, virtual_stages=2), 1),
    "m4": (dict(num_microbatches=4, virtual_stages=2), 1),
    "accum": (dict(num_microbatches=2, virtual_stages=2), 2),
}


def _batches():
    out = []
    for seed in range(len(SEEDS)):
        x = np.random.RandomState(seed).randint(0, 64, (8, 16)).astype(
            np.int32)
        out.append({"x": x, "y": np.roll(x, -1, axis=1)})
    return out


def _jax_trainable(drop):
    from autodist_tpu.models.pipeline_lm import make_pipeline_lm_trainable
    from autodist_tpu.models.transformer import TransformerConfig

    return make_pipeline_lm_trainable(
        TransformerConfig(**SIZES, **drop, dtype=jnp.float32),
        optax.sgd(LR), rng=0)


def _aux_inputs():
    """The JAX golden's weights and batch: ``w [4, 8, 8]``, ``x = {"h":
    [8, 8], "scale": [8, 1]}``, ``y [8, 8]``."""
    r = np.random.RandomState(5)
    w = (r.randn(4, HID, HID) * 0.3).astype(np.float32)
    b = {"x": {"h": r.randn(8, HID).astype(np.float32),
               "scale": np.ones((8, 1), np.float32)},
         "y": r.randn(8, HID).astype(np.float32)}
    return w, b


def _jax_aux():
    """JAX ``_build_pipeline`` on a pipe axis of 4, M = 2: one SGD step's
    loss, aux and params."""
    from jax.sharding import Mesh

    from autodist_tpu.parallel.pipeline import _build_pipeline

    w, b = _aux_inputs()

    def tree_stage(params, act):
        h = jax.nn.relu(act["h"] @ params["w"])
        return {"h": h, "scale": act["scale"]}, jnp.mean(h ** 2)

    def loss_head(outputs, batch):
        return jnp.mean((outputs["h"] * outputs["scale"]
                         - batch["y"]) ** 2), {}

    logical = {"w": jnp.asarray(w)}
    built = _build_pipeline(tree_stage, logical, loss_head, optax.sgd(0.05),
                            Mesh(np.array(jax.devices()[:4]), ("pipe",)),
                            num_microbatches=2, batch_key="x",
                            stage_aux=True)
    state = built.init_fn(logical)
    state, metrics = built.step_fn(state, jax.tree.map(jnp.asarray, b),
                                   jax.random.PRNGKey(0))
    params = jax.device_get(built.unpad_params(state["params"]))
    return (float(np.asarray(metrics["loss"])),
            float(np.asarray(metrics["aux_loss"])), np.asarray(params["w"]))


_WORKER = textwrap.dedent("""
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.models import pipeline_lm
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)
    res = {}

    def trainable(drop):
        tr = pipeline_lm.make_pipeline_lm_trainable(
            port.TransformerConfig(**job["sizes"], **drop,
                                   dtype=torch.float32),
            port.optim.sgd(job["lr"]), torch.Generator(), device="cpu")
        tr.params = job["params"]
        return tr

    def runner(drop, kw, accum):
        builder = port.Pipeline(**kw)
        if accum > 1:
            builder = port.GradAccumulation(builder, accum)
        return port.AutoDist({"mesh": job["mesh"]}, builder,
                             device="cpu").build(trainable(drop))

    for name, (kw, accum) in job["cases"].items():
        r = runner(job["drop"], kw, accum)
        losses = [float(r.step(b, rng=s)["loss"])
                  for b, s in zip(job["batches"], job["seeds"])]
        res[name] = {"losses": losses, "params": r.get_params()}
        if name == "m2":
            b = job["batches"][0]
            res["eval"] = [float(r.eval_step(b, rng=s)["loss"])
                           for s in (1, 2)]
    r = runner(job["no_drop"], *job["cases"]["m2"])
    res["no_drop"] = {"losses": [float(r.step(b, rng=s)["loss"]) for b, s
                                 in zip(job["batches"], job["seeds"])],
                      "params": r.get_params()}

    # stage_aux on dict activations, a pipe axis of 4.
    def tree_stage(params, act):
        h = torch.relu(act["h"] @ params["w"])
        return {"h": h, "scale": act["scale"]}, (h ** 2).mean()

    def loss_head(outputs, batch):
        return ((outputs["h"] * outputs["scale"] - batch["y"]) ** 2).mean(), {}

    w, b = job["aux"]
    tr = port.capture.PipelineTrainable(
        tree_stage, {"w": w}, loss_head, port.optim.sgd(0.05), num_stages=4,
        stage_aux=True)
    lowered = port.AutoDist({"mesh": {"pipe": 4}},
                            port.Pipeline(num_microbatches=2),
                            device="cpu").lower(tr)
    state, metrics = lowered.step_fn(lowered.init_state(tr), b, 0)
    res["aux"] = (float(metrics["loss"]), float(metrics["aux_loss"]),
                  lowered.full_params(state["params"])["w"])
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, _jax_trainable(NO_DROP).params)


@pytest.fixture(scope="module")
def started(jparams, tmp_path_factory):
    """The 4-rank gloo job, started before the references are
    computed."""
    tmp = tmp_path_factory.mktemp("dropout")
    inp, out = str(tmp / "job.pt"), str(tmp / "res.pt")
    w, b = _aux_inputs()
    torch.save({"sizes": SIZES, "drop": DROP, "no_drop": NO_DROP,
                "lr": LR, "mesh": MESH, "cases": CASES,
                "params": port.from_jax_params(jparams, device="cpu"),
                "batches": _batches(), "seeds": SEEDS,
                "aux": (torch.as_tensor(w), {
                    "x": {k: torch.as_tensor(v) for k, v in b["x"].items()},
                    "y": torch.as_tensor(b["y"])})}, inp)
    join = testing.launch(_WORKER, 4, (inp, out), tmp=tmp, timeout=300)

    def result():
        join()
        return torch.load(out, weights_only=False)

    return result


def _sequential(jparams, drop, batches, seeds):
    """The port's sequential program (``PipelineTrainable.loss``, every
    stage in order on one process): SGD steps; returns the losses and
    the final params."""
    tr = tlm.make_pipeline_lm_trainable(
        port.TransformerConfig(**SIZES, **drop, dtype=torch.float32),
        port.optim.sgd(LR), torch.Generator(), device="cpu")
    params = dict(flatten_with_names(port.from_jax_params(jparams,
                                                          device="cpu")))
    losses = []
    for b, seed in zip(batches, seeds):
        leaves = {nm: p.clone().requires_grad_() for nm, p in params.items()}
        loss, _, _ = tr.loss(unflatten(leaves), None,
                             {k: torch.as_tensor(v) for k, v in b.items()},
                             seed)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        params = {nm: (p - LR * g).detach()
                  for (nm, p), g in zip(leaves.items(), grads)}
        losses.append(float(loss.detach()))
    return losses, params


@pytest.fixture(scope="module")
def sequential(jparams, started):
    return _sequential(jparams, DROP, _batches(), SEEDS)


@pytest.fixture(scope="module")
def ranks(started, sequential):
    return started()


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_dropout_matches_sequential(ranks, sequential, case):
    """Every microbatch count, V = 2 and accumulation: the pipelined
    program's losses and params equal the sequential program's (the
    same masks drawn for the same (chunk, row))."""
    want_losses, want = sequential
    got = ranks[case]
    np.testing.assert_allclose(got["losses"], want_losses, **TOL)
    for name, p in flatten_with_names(got["params"]):
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


def test_dropout_is_active_and_eval_deterministic(ranks, jparams):
    """Dropout moves the training loss off the deterministic one; the
    eval program draws nothing (the same loss under two seeds), and its
    loss is not the training loss."""
    drop, nodrop = ranks["m2"]["losses"][0], ranks["no_drop"]["losses"][0]
    assert abs(drop - nodrop) > 1e-4
    e1, e2 = ranks["eval"]
    assert e1 == e2
    assert abs(e1 - drop) > 1e-4
    want, _ = _sequential(jparams, NO_DROP, _batches()[:1], SEEDS[:1])
    np.testing.assert_allclose(nodrop, want[0], **TOL)


def test_no_dropout_matches_jax(ranks):
    """At dropout 0 the data 2 x pipe 2 program's losses and params
    against the JAX ``Pipeline`` runner's at the same mesh."""
    from autodist_tpu import AutoDist
    from autodist_tpu.capture import path_to_name

    spec = {"topology": {"platform": "cpu", "num_devices": 4}, "mesh": MESH}
    runner = AutoDist(spec, "Pipeline", **CASES["m2"][0]).build(
        _jax_trainable(NO_DROP))
    try:
        losses = [float(np.asarray(runner.step(b, rng=jax.random.PRNGKey(
            s))["loss"])) for b, s in zip(_batches(), SEEDS)]
        final = {path_to_name(p): np.asarray(x) for p, x in
                 jax.tree_util.tree_flatten_with_path(
                     runner.get_params())[0]}
    finally:
        runner.close()
    got = ranks["no_drop"]
    np.testing.assert_allclose(got["losses"], losses, **TOL)
    for name, p in flatten_with_names(got["params"]):
        np.testing.assert_allclose(p.numpy(), final[name], err_msg=name,
                                   **TOL)


def test_stage_aux_on_dict_activations_matches_jax(ranks):
    """Dict activations cross the pipe ring; each stage's aux loss
    enters the loss as aux / M, summed over the pipe axis as the
    ``aux_loss`` metric: the loss, the aux and the params after one SGD
    step against the JAX program's."""
    loss, aux, w = ranks["aux"]
    jloss, jaux, jw = _jax_aux()
    np.testing.assert_allclose(loss, jloss, **TOL)
    np.testing.assert_allclose(aux, jaux, **TOL)
    np.testing.assert_allclose(w.numpy(), jw, **TOL)


def test_stage_aux_sequential_loss_matches_jax():
    """``PipelineTrainable(stage_aux=True).loss``, the sequential
    program, adds the stages' aux to the head loss and reports it as
    ``aux_loss``, as the JAX trainable's does."""
    from autodist_tpu.capture import PipelineTrainable as JPipe

    w, b = _aux_inputs()

    def jstage(params, act):
        h = jax.nn.relu(act["h"] @ params["w"])
        return {"h": h, "scale": act["scale"]}, jnp.mean(h ** 2)

    def jhead(outputs, batch):
        return jnp.mean((outputs["h"] * outputs["scale"] - batch["y"]) ** 2), {}

    def stage(params, act):
        h = torch.relu(act["h"] @ params["w"])
        return {"h": h, "scale": act["scale"]}, (h ** 2).mean()

    def head(outputs, batch):
        return ((outputs["h"] * outputs["scale"] - batch["y"]) ** 2).mean(), {}

    jl, _, jm = JPipe(jstage, {"w": jnp.asarray(w)}, jhead, optax.sgd(0.1),
                      num_stages=4, stage_aux=True).loss(
        {"w": jnp.asarray(w)}, None, jax.tree.map(jnp.asarray, b), None)
    tb = {"x": {k: torch.as_tensor(v) for k, v in b["x"].items()},
          "y": torch.as_tensor(b["y"])}
    tw = {"w": torch.as_tensor(w)}
    pl, _, pm = port.capture.PipelineTrainable(
        stage, tw, head, port.optim.sgd(0.1), num_stages=4,
        stage_aux=True).loss(tw, None, tb, None)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(pm["aux_loss"]), float(jm["aux_loss"]),
                               rtol=1e-6)


def test_keyed_masks_depend_only_on_chunk_row_and_site():
    """A row's mask is the same whatever rows sit beside it (the
    microbatching invariance), differs between rows, sites and chunks,
    keeps about ``1 - rate``, and scales kept values by ``1 / (1 -
    rate)``; no key is the identity."""
    from autodist_tpu_torch.capture import stage_key

    x = torch.ones(6, 4, 5)
    rows = torch.arange(6)
    key = stage_key(7, 3, "cpu")
    full = tlm.keyed_dropout(x, 0.25, key, rows, 1)
    part = tlm.keyed_dropout(x[2:4], 0.25, key, rows[2:4], 1)
    torch.testing.assert_close(part, full[2:4], rtol=0, atol=0)
    assert not torch.equal(full[0], full[1])
    assert not torch.equal(full, tlm.keyed_dropout(x, 0.25, key, rows, 2))
    assert not torch.equal(full, tlm.keyed_dropout(
        x, 0.25, stage_key(7, 4, "cpu"), rows, 1))
    kept = full != 0
    assert 0.6 < kept.float().mean() < 0.9
    torch.testing.assert_close(full[kept], torch.full_like(full[kept],
                                                           1 / 0.75))
    assert tlm.keyed_dropout(x, 0.25, None, rows, 1) is x
