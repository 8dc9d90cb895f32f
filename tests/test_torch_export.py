"""``export_model`` / ``load_exported`` and ``serve(artifact=)`` in the
port, against the JAX package's models on the CPU.

The cases of ``tests/unit/test_export.py`` without its exporter (whose
tests are slow): a flax-shaped 2-layer MLP trained under
``PartitionedPS`` by both packages on the same weights and batches; the
port's artifact, reloaded, gives the JAX model's ``apply`` on the JAX
runner's parameters within 1e-5, and its ``params/`` are the logical
tree, read with ``torch.load(weights_only=True)`` alone.  The pipelined
LM (vocabulary 33, 2 layers) trained through ``Pipeline`` exports its
logits program, equal to the JAX ``sequential_logits`` within 1e-5, and
``serve(cfg, artifact=dir)`` decodes, token for token, what
``serve(cfg, runner=runner)`` decodes, dense and paged + chunked (the
engine's own parity with the JAX engine is ``test_torch_serving.py``'s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu import PartitionedPS as JPartitionedPS
from autodist_tpu import Trainable as JTrainable
from autodist_tpu.models.pipeline_lm import \
    make_pipeline_lm_trainable as jax_lm_trainable
from autodist_tpu.models.pipeline_lm import \
    sequential_logits as jax_sequential_logits
from autodist_tpu.models.transformer import TransformerConfig as JConfig
from autodist_tpu_torch.checkpoint import export as texport
from autodist_tpu_torch.models import pipeline_lm

TOL = dict(rtol=1e-5, atol=1e-5)


def mlp_params():
    r = np.random.RandomState(0)
    return {"h": {"kernel": r.randn(8, 16).astype(np.float32) * 0.3,
                  "bias": np.zeros(16, np.float32)},
            "out": {"kernel": r.randn(16, 3).astype(np.float32) * 0.3,
                    "bias": np.zeros(3, np.float32)}}


def jax_apply(p, x):
    h = jax.nn.relu(x @ p["h"]["kernel"] + p["h"]["bias"])
    return h @ p["out"]["kernel"] + p["out"]["bias"]


def port_apply(p, x):
    h = torch.relu(x @ p["h"]["kernel"] + p["h"]["bias"])
    return h @ p["out"]["kernel"] + p["out"]["bias"]


def mlp_batches():
    r = np.random.RandomState(1)
    return [{"x": r.randn(16, 8).astype(np.float32),
             "y": r.randn(16, 3).astype(np.float32)} for _ in range(3)]


def test_export_under_fsdp_roundtrip(tmp_path):
    jt = JTrainable.from_loss_fn(
        lambda p, b: jnp.mean((jax_apply(p, b["x"]) - b["y"]) ** 2),
        jax.tree.map(jnp.asarray, mlp_params()), optax.adam(1e-2))
    jr = JAutoDist({}, JPartitionedPS()).build(jt)
    t = port.Trainable.from_loss_fn(
        lambda p, b: ((port_apply(p, b["x"]) - b["y"]) ** 2).mean(),
        jax.tree.map(torch.tensor, mlp_params()), port.optim.adam(1e-2))
    runner = port.AutoDist({}, port.PartitionedPS(), device="cpu").build(t)
    for b in mlp_batches():
        jr.step(b)
        runner.step(b)
    path = port.export_model(str(tmp_path / "artifact"), port_apply, None,
                             [np.zeros((4, 8), np.float32)], runner=runner)

    params = torch.load(tmp_path / "artifact" / "params" / "params.pt",
                        weights_only=True)
    assert params["h"]["kernel"].shape == (8, 16)
    for (_, a), (_, b) in zip(
            port.kernel.common.flatten_with_names(params),
            port.kernel.common.flatten_with_names(runner.get_params())):
        assert torch.equal(a, b)

    served = port.load_exported(path, device="cpu")
    assert served.meta["num_inputs"] == 1
    assert served.meta["params"]["h"]["kernel"] == {"shape": [8, 16],
                                                    "dtype": "float32"}
    x = np.random.RandomState(2).randn(4, 8).astype(np.float32)
    want = np.asarray(jax_apply(jr.get_params(), x))
    np.testing.assert_allclose(served(x).numpy(), want, **TOL)


def test_parse_dtype_and_missing_artifact(tmp_path):
    assert texport.parse_dtype("bfloat16") is torch.bfloat16
    assert texport.parse_dtype("torch.int32") is torch.int32
    assert texport.parse_dtype(np.dtype("float32").name) is torch.float32
    with pytest.raises(ValueError, match="nonsense"):
        texport.parse_dtype("nonsense")
    with pytest.raises(FileNotFoundError, match="not an export artifact"):
        port.load_exported_params(str(tmp_path))


V, MAX_LEN = 33, 24
SMALL = dict(vocab_size=V, hidden_size=16, num_layers=2, num_heads=2,
             mlp_dim=32, max_len=MAX_LEN, dropout_rate=0.0,
             attention_dropout_rate=0.0)
ENGINE = dict(num_slots=2, max_len=MAX_LEN, prefill_len=12, decode_steps=3)
LAYOUTS = {"dense": {},
           "paged_chunked": dict(kv_layout="paged", kv_block_len=4,
                                 prefill_chunk=4)}
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3], [2, 7, 1, 8]]


def _streams(engine):
    batcher = port.ContinuousBatcher(engine)
    rids = [batcher.submit(p, max_new_tokens=6) for p in PROMPTS]
    done = batcher.run()
    return [done[r].tokens for r in rids]


def test_export_and_serve_the_pipelined_lm(tmp_path):
    jcfg = JConfig(dtype=jnp.float32, **SMALL)
    tcfg = port.TransformerConfig(dtype=torch.float32, **SMALL)
    jt = jax_lm_trainable(jcfg, optax.sgd(0.5), jax.random.PRNGKey(0))
    jr = JAutoDist({"topology": {"platform": "cpu", "num_devices": 1},
                    "mesh": {"data": 1, "pipe": 1}}, "Pipeline",
                   num_microbatches=2, virtual_stages=2).build(jt)
    tt = pipeline_lm.make_pipeline_lm_trainable(
        tcfg, port.optim.sgd(0.5), torch.Generator(), device="cpu")
    tt.params = port.from_jax_params(jax.tree.map(np.asarray, jt.params),
                                     device="cpu")
    runner = port.AutoDist({"mesh": {"data": 1, "pipe": 1, "model": 1}},
                           port.Pipeline(num_microbatches=2,
                                         virtual_stages=2),
                           device="cpu").build(tt)
    rng = np.random.RandomState(0)
    for _ in range(2):
        x = rng.randint(0, V, (4, 8)).astype(np.int32)
        b = {"x": x, "y": np.concatenate([x[:, 1:], x[:, :1]], 1)}
        jr.step(b)
        runner.step(b)
    jparams = jax.device_get(jr.get_params())

    def apply_fn(p, tokens):
        return pipeline_lm.sequential_logits(tcfg, p, tokens)

    path = port.export_model(str(tmp_path / "lm"), apply_fn, None,
                             [np.zeros((2, 8), np.int32)], runner=runner)
    restored = port.load_exported_params(path)
    assert restored["shared"]["embedding"].shape == (V, 16)
    assert restored["stages"]["mlp"]["wi"]["kernel"].shape == (2, 16, 32)
    toks = rng.randint(0, V, (2, 8)).astype(np.int32)
    got = port.load_exported(path, device="cpu")(toks).numpy()
    want = np.asarray(jax_sequential_logits(jcfg, jparams, toks))
    np.testing.assert_allclose(got, want, **TOL)

    for layout, kw in LAYOUTS.items():
        kw = dict(ENGINE, **kw)
        from_artifact = _streams(port.serve(tcfg, artifact=path,
                                            device="cpu", **kw))
        from_runner = _streams(port.serve(tcfg, runner=runner,
                                          device="cpu", **kw))
        assert from_artifact == from_runner, layout
