"""The pipeline family's state manifest and elastic restore, against the
JAX package on the CPU.

On the pipelined LM of ``tests/unit/test_elastic.py`` (hidden 16, 2
heads, mlp 32, length 8, fp32, SGD with momentum 0.9), on gloo ranks:

* the port's ``Lowered.state_manifest`` of a ``Pipeline`` lowering is
  ``{"family": "pipeline", ...}`` and equals the JAX package's for the
  same strategy and mesh, leaf for leaf and op for op (global stored
  shape, logical shape, dtype and recipe; the port's ``split`` dropped,
  optimizer leaves matched by the JAX suffix rule): ZeRO-3 rows at
  ``virtual_stages=2`` (the inverse interleave permutation), ZeRO-1's
  pipe-major flat state, the vocab-padded table at tensor parallel 2
  (and its model-major ZeRO-1 state), a ``bf16_ef`` compressor's rows,
  and a ``dcn`` axis among the replica axes, where the step also
  matches the JAX runner (1e-5);
* the golden of ``tests/unit/test_elastic.py:242`` at small size: tensor
  parallel 2 with ``vocab_parallel`` (vocabulary 33, padded to 34) on
  ``{"pipe": 2, "model": 2}`` re-laid live (the fast route) as
  ``{"data": 2, "pipe": 2}`` at tensor parallel 1: the reshard is
  bit-exact, and the continued trajectory matches never having
  switched within the JAX golden's tolerance (rtol 2e-5, atol 2e-6);
* the golden of ``tests/unit/test_elastic.py:270``: ZeRO-3 on ``{"data":
  2, "pipe": 2}`` at ``virtual_stages=2`` saved (its sidecar written,
  with no warning) and restored by ``Saver.restore_elastic`` on ``{"data":
  2, "pipe": 4}`` at ``virtual_stages=1`` (8 ranks, the staged route):
  bit-exact at the restore, trajectory-close after.
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
from autodist_tpu_torch.kernel.common import flatten_with_names

SIZES = dict(hidden_size=16, num_heads=2, mlp_dim=32, max_len=8,
             dropout_rate=0.0, attention_dropout_rate=0.0)
CLOSE = dict(rtol=2e-5, atol=2e-6)        # tests/unit/test_elastic.py
TOL = dict(rtol=1e-5, atol=1e-5)
V_ODD = 33
DP2_PP2 = {"data": 2, "pipe": 2}
# label -> (mesh, layers, vocab, Pipeline keywords)
MANIFESTS = {
    "zero3_v2": (DP2_PP2, 4, 37, dict(virtual_stages=2, zero_stage=3)),
    "zero1": (DP2_PP2, 2, 37, dict(zero_stage=1)),
    "tp2_vocab": ({"pipe": 2, "model": 2}, 2, V_ODD,
                  dict(tensor_parallel=2, vocab_parallel=True)),
    "tp2_vocab_zero1": ({"pipe": 2, "model": 2}, 2, V_ODD,
                        dict(tensor_parallel=2, vocab_parallel=True,
                             zero_stage=1)),
    "bf16_ef": (DP2_PP2, 2, 37, dict(compressor="bf16_ef")),
    "dcn": ({"dcn": 2, "pipe": 2}, 2, 37, {}),
}


def lm_batches(k=4, vocab=V_ODD):
    r = np.random.RandomState(0)
    return [{"x": r.randint(0, vocab, (8, 8)).astype(np.int32),
             "y": r.randint(0, vocab, (8, 8)).astype(np.int32)}
            for _ in range(k)]


def jax_lm(layers, vocab):
    from autodist_tpu.models.pipeline_lm import make_pipeline_lm_trainable
    from autodist_tpu.models.transformer import TransformerConfig

    cfg = TransformerConfig(vocab_size=vocab, num_layers=layers,
                            dtype=jnp.float32, **SIZES)
    return make_pipeline_lm_trainable(cfg, optax.sgd(0.1, momentum=0.9),
                                      jax.random.PRNGKey(0))


_PREAMBLE = textwrap.dedent("""
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.checkpoint import Saver
    from autodist_tpu_torch.kernel.common import flatten_with_names
    from autodist_tpu_torch.models import pipeline_lm
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)


    def lm(layers, vocab, params=None):
        tr = pipeline_lm.make_pipeline_lm_trainable(
            port.TransformerConfig(vocab_size=vocab, num_layers=layers,
                                   dtype=torch.float32, **job["sizes"]),
            port.optim.sgd(0.1, momentum=0.9),
            torch.Generator().manual_seed(0), device="cpu")
        if params is not None:
            tr.params = params
        return tr


    def build(mesh, layers, vocab, params=None, **kw):
        return port.AutoDist({"mesh": mesh}, port.Pipeline(
            num_microbatches=2, **kw), device="cpu").build(
            lm(layers, vocab, params))


    def run(runner, batches, start):
        return [float(runner.step(b, rng=start + i)["loss"])
                for i, b in enumerate(batches)]


    def params(runner):
        return {n: t.clone() for n, t in
                flatten_with_names(runner.get_params())}
""")

_WORKER4 = _PREAMBLE + textwrap.dedent("""
    import logging
    from autodist_tpu_torch.elastic import reshard_state
    from autodist_tpu_torch.elastic.reshard import meta_template

    res = {"manifests": {}}
    for label, (mesh, layers, vocab, kw) in job["manifests"].items():
        runner = build(mesh, layers, vocab, job["params"][label], **kw)
        res["manifests"][label] = runner.lowered.state_manifest(
            runner.state)
        if label == "dcn":
            res["dcn_losses"] = run(runner, job["batches37"][:3], 0)
            res["dcn_params"] = params(runner)
        runner.close()

    # tests/unit/test_elastic.py:242 at small size, the live route
    batches = job["batches33"]
    tp = dict(tensor_parallel=2, vocab_parallel=True)
    ref = build({"pipe": 2, "model": 2}, 2, 33, **tp)
    run(ref, batches, 0)
    res["tp_ref"] = params(ref)
    src = build({"pipe": 2, "model": 2}, 2, 33, **tp)
    run(src, batches[:2], 0)
    res["tp_pre"] = params(src)
    res["tp_padded"] = tuple(src.state["params"]["shared/embedding"].shape)
    dst = build({"data": 2, "pipe": 2}, 2, 33)
    dst.state = reshard_state(src.lowered, src.state, dst.lowered,
                              meta_template(dst.state))
    res["tp_step"] = int(dst.state["step"])
    res["tp_post"] = params(dst)
    run(dst, batches[2:], 2)
    res["tp_final"] = params(dst)

    # tests/unit/test_elastic.py:270, the writing side
    batches = job["batches37"]
    z3 = dict(virtual_stages=2, zero_stage=3)
    ref = build({"data": 2, "pipe": 2}, 4, 37, **z3)
    run(ref, batches, 0)
    res["z3_ref"] = params(ref)
    src = build({"data": 2, "pipe": 2}, 4, 37, **z3)
    run(src, batches[:2], 0)
    res["z3_pre"] = params(src)
    warned = []
    handler = logging.Handler()
    handler.emit = lambda r: warned.append(r.getMessage())
    logging.getLogger("autodist_tpu_torch").addHandler(handler)
    saver = Saver(job["ckpt"])
    saver.save(src)
    saver.wait()
    logging.getLogger("autodist_tpu_torch").removeHandler(handler)
    res["z3_warned"] = [m for m in warned if "sidecar" in m]
    side = saver.read_sidecar(2)
    res["z3_sidecar"] = None if side is None else side["manifest"]["family"]
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")

_WORKER8 = _PREAMBLE + textwrap.dedent("""
    # tests/unit/test_elastic.py:270, the restoring side: 8 ranks
    batches = job["batches37"]
    dst = build({"data": 2, "pipe": 4}, 4, 37)
    Saver(job["ckpt"]).restore_elastic(dst)
    res = {"step": dst.step_count, "post": params(dst),
           "routes": [r["route"] for r in port.telemetry.get().events
                      if r["kind"] == "reshard"]}
    run(dst, batches[2:], 2)
    res["final"] = params(dst)
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")


def _launch(script, world, job, tmp):
    tmp.mkdir()
    inp, out = tmp / "job.pt", tmp / "res.pt"
    torch.save(job, inp)
    join = testing.launch(script, world, (inp, out), tmp=tmp, timeout=300)

    def result():
        join()
        return torch.load(out, weights_only=False)

    return result


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The 4-rank job (started before the JAX programs), then the 8-rank
    restore of its checkpoint."""
    tmp = tmp_path_factory.mktemp("elastic_pipeline")
    jparams = {label: port.from_jax_params(jax.tree.map(
        np.asarray, jax_lm(layers, vocab).params), device="cpu")
        for label, (_, layers, vocab, _) in MANIFESTS.items()}
    common = {"sizes": SIZES, "ckpt": str(tmp / "ckpt"),
              "batches33": lm_batches(), "batches37": lm_batches(vocab=37)}
    four = _launch(_WORKER4, 4, dict(common, manifests=MANIFESTS,
                                     params=jparams), tmp / "four")
    return four, lambda: _launch(_WORKER8, 8, common, tmp / "eight")()


@pytest.fixture(scope="module")
def jax_side(job):
    from autodist_tpu import AutoDist
    from autodist_tpu.strategy.parallel_builders import Pipeline

    out = {}
    for label, (mesh, layers, vocab, kw) in MANIFESTS.items():
        spec = {"topology": {"num_devices": 4}, "mesh": mesh}
        runner = AutoDist(spec, Pipeline(num_microbatches=2, **kw)).build(
            jax_lm(layers, vocab))
        out[label] = runner.lowered.state_manifest(runner.state)
        if label == "dcn":
            batches = lm_batches(vocab=37)[:3]
            out["dcn_losses"] = [
                float(np.asarray(runner.step(b, rng=jax.random.PRNGKey(i))
                                 ["loss"])) for i, b in enumerate(batches)]
            out["dcn_params"] = dict(flatten_with_names(
                jax.tree.map(np.asarray, runner.get_params())))
    return out


@pytest.fixture(scope="module")
def four(job, jax_side):
    return job[0]()


@pytest.fixture(scope="module")
def eight(four, job):
    return job[1]()


def _jax_name(name: str, jleaves) -> str:
    """The JAX leaf of a port leaf: the same name, or for an optimizer
    leaf the JAX one whose path past its optax chain index is the
    port's."""
    if name in jleaves or not name.startswith("opt_state/"):
        return name
    rest = name[len("opt_state/"):]
    found = [j for j in jleaves if j.startswith("opt_state/")
             and j.split("/", 2)[-1] == rest]
    assert len(found) == 1, (name, found)
    return found[0]


@pytest.mark.parametrize("label", list(MANIFESTS))
def test_pipeline_manifest_matches_jax(four, jax_side, label):
    mine, want = four["manifests"][label], jax_side[label]
    assert mine["family"] == want["family"] == "pipeline"
    assert mine["sync"] == want["sync"]
    jleaves = want["leaves"]
    matched = set()
    for name, rec in mine["leaves"].items():
        jname = _jax_name(name, jleaves)
        matched.add(jname)
        assert {k: v for k, v in rec.items() if k != "split"} \
            == jleaves[jname], name
    assert matched == set(jleaves)
    if label == "zero3_v2":
        rec = mine["leaves"]["params/stages/attention/qkv/kernel"]
        assert [s["axis"] for s in rec["split"]] == ["pipe", "data"]
        assert rec["ops"][-1]["op"] == "index0"
    if label == "dcn":
        rec = mine["leaves"]["params/stages/attention/qkv/kernel"]
        assert rec["split"] == [{"axis": "pipe", "dim": 0, "ranks": 2}]


def test_dcn_replica_axis_pipeline_matches_jax(four, jax_side):
    np.testing.assert_allclose(four["dcn_losses"], jax_side["dcn_losses"],
                               **TOL)
    got = {n: t.numpy() for n, t in four["dcn_params"].items()}
    assert set(got) == set(jax_side["dcn_params"])
    for n, v in got.items():
        np.testing.assert_allclose(v, jax_side["dcn_params"][n], **TOL,
                                   err_msg=n)


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for n in a:
        assert torch.equal(a[n], b[n]), n


def _close(a: dict, b: dict):
    for n in a:
        np.testing.assert_allclose(a[n].numpy(), b[n].numpy(), **CLOSE,
                                   err_msg=n)


def test_tp_change_with_vocab_pad_live_golden(four):
    """tests/unit/test_elastic.py:242: the padded table (33 -> 34 rows
    at tp 2) un-pads and re-replicates; bit-exact, then on track."""
    assert four["tp_padded"] == (17, 16)
    assert four["tp_step"] == 2
    _equal(four["tp_post"], four["tp_pre"])
    _close(four["tp_final"], four["tp_ref"])


def test_zero3_pp_change_grow_checkpoint_golden(four, eight):
    """tests/unit/test_elastic.py:270: ZeRO-3 rows at V = 2 on 4 ranks,
    saved with its sidecar (no warning), restored as plain storage at
    pipe 4, V = 1 on 8 ranks."""
    assert four["z3_sidecar"] == "pipeline" and four["z3_warned"] == []
    assert eight["step"] == 2 and eight["routes"] == ["staged"]
    _equal(eight["post"], four["z3_pre"])
    _close(eight["final"], four["z3_ref"])
