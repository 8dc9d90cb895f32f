"""Touched-rows-only embedding sync (``ops/sparse.py``), against the JAX
package on the CPU.

The cases of ``tests/unit/test_sparse.py`` on 2 and 4 gloo ranks, each
held to the JAX runner on a data axis of the same size (the JAX
golden's tolerance, 2e-6): a vocab-sharded table under ``Parallax`` and
``PartitionedPS`` with SGD and Adam; every lookup hitting one row (the
scatter-add accumulates duplicates and hot rows); a dense use of the
table (a tied decode through ``@``) through the dense decay; a module
model (``Embed`` + ``Linear`` through ``torch.func.functional_call``,
flax's ``nn.Embed`` case) and the ``SparseEmbed`` layer.  The traffic
check replaces the JAX HLO grep: every collective a step makes is
logged, and none moves a payload of the table's size.  The wrapper's
own behaviour (shape, the dense decay, ``.to``) is held in one
process.
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
from autodist_tpu_torch.ops import sparse

VOCAB, DIM, BATCH, SEQ = 64, 8, 16, 4
TRAFFIC_VOCAB = 4096
WORLDS = (2, 4)
TOL = dict(rtol=2e-6, atol=2e-6)
OPTS = {"sgd": ("sgd", 0.1), "adam": ("adam", 1e-2)}


def _params(vocab=VOCAB, seed=0):
    r = np.random.RandomState(seed)
    return {"embedding": (r.randn(vocab, DIM) * 0.1).astype(np.float32),
            "head": {"w": (r.randn(DIM, 1) * 0.1).astype(np.float32)}}


def _batch(seed=1, vocab=VOCAB):
    r = np.random.RandomState(seed)
    ids = r.randint(0, vocab, (BATCH, SEQ)).astype(np.int32)
    ids[:, 0] = ids[0, 0]             # a hot row shared by the batch
    return {"ids": ids, "y": r.randn(BATCH).astype(np.float32)}


def _hot_batch():
    return {"ids": np.zeros((BATCH, SEQ), np.int32),
            "y": np.ones(BATCH, np.float32)}


# The models, each as the JAX package writes it and as the port does.
def _jax_model(kind, params, opt):
    from autodist_tpu import Trainable
    from autodist_tpu.ops import embedding_lookup

    def lookup(p, batch):
        return embedding_lookup(p["embedding"], batch["ids"])

    if kind == "dense":
        def loss_fn(p, batch):
            emb = lookup(p, batch).mean(axis=1)
            logits = emb @ jnp.asarray(p["embedding"]).T
            return -jnp.mean(jax.nn.log_softmax(logits)[:, 0])
    else:
        def loss_fn(p, batch):
            pred = (lookup(p, batch).mean(axis=1) @ p["head"]["w"])[:, 0]
            return jnp.mean((pred - batch["y"]) ** 2)
    return Trainable.from_loss_fn(
        loss_fn, jax.tree.map(jnp.asarray, params), opt,
        sparse_params=("embedding",))


def _jax_module_model(kind, params):
    """flax's ``nn.Embed`` (the dense decay) or the JAX ``SparseEmbed``,
    then a Dense head; with ``params`` ``None``, its initial params."""
    import flax.linen as nn

    from autodist_tpu import Trainable
    from autodist_tpu.models.embedding import SparseEmbed

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, ids):
            embed = (nn.Embed(VOCAB, DIM, name="embed") if kind == "module"
                     else SparseEmbed(VOCAB, DIM, name="embed"))
            return nn.Dense(1, name="out")(embed(ids).mean(axis=1))[:, 0]

    model = Tiny()

    def loss_fn(p, batch):
        return jnp.mean((model.apply({"params": p}, batch["ids"])
                         - batch["y"]) ** 2)

    if params is None:
        return model.init(jax.random.PRNGKey(0),
                          jnp.zeros((2, SEQ), jnp.int32))["params"]
    return Trainable.from_loss_fn(loss_fn, params, optax.sgd(0.1),
                                  sparse_params=("embed/embedding",))


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.models.embedding import SparseEmbed
    from autodist_tpu_torch.models.transformer import Embed
    from autodist_tpu_torch.ops.sparse import embedding_lookup
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)

    def tensors(tree):
        return {k: tensors(v) if isinstance(v, dict) else torch.as_tensor(v)
                for k, v in tree.items()}

    def model(kind, params, opt):
        if kind == "dense":
            def loss_fn(p, b):
                emb = embedding_lookup(p["embedding"], b["ids"]).mean(1)
                logits = emb @ p["embedding"].T
                return -torch.log_softmax(logits, -1)[:, 0].mean()
        else:
            def loss_fn(p, b):
                emb = embedding_lookup(p["embedding"], b["ids"]).mean(1)
                return (((emb @ p["head"]["w"])[:, 0] - b["y"]) ** 2).mean()
        return port.Trainable.from_loss_fn(loss_fn, tensors(params), opt,
                                           sparse_params=("embedding",))

    # flax's Tiny: an embedding (Embed read with F.embedding, the dense
    # decay, or SparseEmbed), the mean over the sequence, a Dense head.
    class Tiny(torch.nn.Module):
        def __init__(self, kind):
            super().__init__()
            gen, v, d = torch.Generator(), job["vocab"], job["dim"]
            self.kind = kind
            self.embed = (Embed(v, d, gen) if kind == "module"
                          else SparseEmbed(v, d, gen))
            self.out = torch.nn.Linear(d, 1)

        def forward(self, ids):
            ids = ids.long()
            emb = (F.embedding(ids, self.embed.embedding)
                   if self.kind == "module" else self.embed(ids))
            return self.out(emb.mean(1))[:, 0]

    def module_model(kind, params):
        net = Tiny(kind)

        def loss_fn(p, b):
            flat = {"embed.embedding": p["embed"]["embedding"],
                    "out.weight": p["out"]["kernel"].T,
                    "out.bias": p["out"]["bias"]}
            pred = torch.func.functional_call(net, flat, (b["ids"],))
            return ((pred - b["y"]) ** 2).mean()
        return port.Trainable.from_loss_fn(loss_fn, tensors(params),
                                           port.optim.sgd(0.1),
                                           sparse_params=("embed/embedding",))

    def run(builder, tr, batches):
        runner = port.AutoDist({}, builder, device="cpu").build(tr)
        losses = [float(runner.step(b)["loss"]) for b in batches]
        sparse = [nm for nm, vp in runner.lowered.plan.var_plans.items()
                  if vp.sparse_lookup]
        return {"params": runner.get_params(), "losses": losses,
                "sparse": sparse}

    res = {}
    for name, spec in job["opts"].items():
        opt = getattr(port.optim, spec[0])(spec[1])
        for b in ("Parallax", "PartitionedPS"):
            res[(b, name)] = run(b, model("lookup", job["params"], opt),
                                 job["batches"])
    res["hot"] = run("Parallax", model("lookup", job["params"],
                                       port.optim.sgd(0.1)), [job["hot"]])
    res["dense"] = run("Parallax", model("dense", job["params"],
                                         port.optim.sgd(0.1)),
                       job["batches"][:2])
    for kind in ("module", "sparse_embed"):
        res[kind] = run("Parallax", module_model(kind, job["module_params"]),
                        job["module_batches"])

    # Traffic: log the payload of every collective of one step.
    sizes = []
    for fn in ("all_reduce", "all_gather", "reduce_scatter_tensor",
               "all_to_all_single"):
        orig = getattr(dist, fn)
        def logged(*args, _orig=orig, **kw):
            for a in args:
                for t in (a if isinstance(a, list) else [a]):
                    if isinstance(t, torch.Tensor):
                        sizes.append(t.numel())
            return _orig(*args, **kw)
        setattr(dist, fn, logged)
    tr = model("lookup", job["traffic_params"], port.optim.sgd(0.1))
    runner = port.AutoDist({}, "Parallax", device="cpu").build(tr)
    sizes.clear()
    runner.step(job["traffic_batch"])
    res["traffic"] = list(sizes)
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")


@pytest.fixture(scope="module")
def module_params():
    return jax.tree.map(np.asarray, _jax_module_model("module", None))


@pytest.fixture(scope="module")
def started(module_params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sparse")
    inp = tmp / "job.pt"
    torch.save({"opts": OPTS, "params": _params(), "vocab": VOCAB,
                "dim": DIM, "batches": [_batch(s) for s in range(3)],
                "hot": _hot_batch(), "module_params": module_params,
                "module_batches": [_batch()] * 3,
                "traffic_params": _params(TRAFFIC_VOCAB),
                "traffic_batch": _batch(vocab=TRAFFIC_VOCAB)}, inp)
    joins = {w: testing.launch(_WORKER, w, (inp, tmp / f"out{w}.pt"),
                               tmp=tmp / f"w{w}", timeout=300)
             for w in WORLDS}

    def result(world):
        joins[world]()
        return torch.load(tmp / f"out{world}.pt", weights_only=False)

    return result


def _jax_run(trainable, builder, world, batches):
    from autodist_tpu import AutoDist
    from autodist_tpu.capture import path_to_name
    from autodist_tpu.resource import ResourceSpec

    runner = AutoDist(ResourceSpec({"topology": {
        "platform": "cpu", "num_devices": world}}), builder).build(trainable)
    losses = [float(np.asarray(runner.step(b)["loss"])) for b in batches]
    params = {path_to_name(p): np.asarray(x) for p, x in
              jax.tree_util.tree_flatten_with_path(
                  jax.device_get(runner.get_params()))[0]}
    return params, losses


@pytest.fixture(scope="module")
def jax_runs(started, module_params):
    from autodist_tpu import Parallax, PartitionedPS

    out = {}
    batches = [_batch(s) for s in range(3)]
    for w in WORLDS:
        for name, (opt, lr) in OPTS.items():
            for cls in (Parallax, PartitionedPS):
                out[(w, cls.__name__, name)] = _jax_run(
                    _jax_model("lookup", _params(), getattr(optax, opt)(lr)),
                    cls(), w, batches)
        out[(w, "hot")] = _jax_run(
            _jax_model("lookup", _params(), optax.sgd(0.1)), Parallax(), w,
            [_hot_batch()])
        out[(w, "dense")] = _jax_run(
            _jax_model("dense", _params(), optax.sgd(0.1)), Parallax(), w,
            batches[:2])
        for kind in ("module", "sparse_embed"):
            out[(w, kind)] = _jax_run(
                _jax_module_model(kind, jax.tree.map(jnp.asarray,
                                                     module_params)),
                Parallax(), w, [_batch()] * 3)
    return out


@pytest.fixture(scope="module")
def port_runs(started, jax_runs):
    return {w: started(w) for w in WORLDS}


def _check(res, want, sparse=("embedding",)):
    params, losses = want
    got = {n: t.numpy() for n, t in flatten_with_names(res["params"])}
    assert sorted(got) == sorted(params)
    for name in params:
        assert got[name].shape == params[name].shape, name
        np.testing.assert_allclose(got[name], params[name], err_msg=name,
                                   **TOL)
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
    assert res["sparse"] == list(sparse)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("builder", ["Parallax", "PartitionedPS"])
def test_vocab_sharded_embedding_matches_jax(builder, opt, world, port_runs,
                                             jax_runs):
    """The table is stored row-sharded, the loss sees a
    ``ShardedEmbedding`` and 3 steps end at the JAX runner's params."""
    _check(port_runs[world][(builder, opt)],
           jax_runs[(world, builder, opt)])


@pytest.mark.parametrize("world", WORLDS)
def test_duplicate_and_hot_rows_accumulate(world, port_runs, jax_runs):
    """Every lookup of every rank hits row 0: the owner sums them all."""
    _check(port_runs[world]["hot"], jax_runs[(world, "hot")])


@pytest.mark.parametrize("world", WORLDS)
def test_dense_use_decays_to_the_gathered_table(world, port_runs, jax_runs):
    """``emb @ table.T`` on the wrapper sees the all-gathered table."""
    _check(port_runs[world]["dense"], jax_runs[(world, "dense")])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["module", "sparse_embed"])
def test_module_models_train_as_jax(kind, world, port_runs, jax_runs):
    """``Embed`` (``F.embedding``: the dense decay, flax's ``nn.Embed``
    case) and ``SparseEmbed`` (touched rows) inside
    ``torch.func.functional_call``: the JAX models' parameters, and the
    loss falls over 3 steps on one batch."""
    res = port_runs[world][kind]
    _check(res, jax_runs[(world, kind)], sparse=("embed/embedding",))
    assert res["losses"][-1] < res["losses"][0]


@pytest.mark.parametrize("world", WORLDS)
def test_no_collective_moves_the_table(world, port_runs):
    """A Parallax step on a 4096-row table moves ids, touched rows and
    the dense head's gradient: no collective payload has the table's
    size (the JAX test greps the HLO for a [4096, 8] collective)."""
    sizes = port_runs[world]["traffic"]
    assert sizes and max(sizes) < TRAFFIC_VOCAB * DIM // world, sizes


def _axis(n=1):
    from autodist_tpu_torch.parallel.axis import Axis

    return Axis("data", size=n)


def test_wrapper_shape_decay_and_cast():
    """One rank: the logical shape, a lookup, the dense decay through
    ``@``, ``.T`` and ``F.embedding``, ``.to`` keeping the wrapper, and
    gradients reaching the shard through both."""
    shard = torch.randn(10, 3, requires_grad=True)
    table = sparse.ShardedEmbedding(shard, 10, _axis())
    assert table.shape == (10, 3) and table.dtype == torch.float32
    assert isinstance(table.to(torch.float64), sparse.ShardedEmbedding)
    ids = torch.tensor([[1, 2], [2, 9]])
    rows = sparse.embedding_lookup(table, ids)
    torch.testing.assert_close(rows, shard[ids])
    torch.testing.assert_close(table[ids], shard[ids])
    x = torch.randn(4, 3)
    torch.testing.assert_close(x @ table.T, x @ shard.T)
    torch.testing.assert_close(
        torch.nn.functional.embedding(ids, table), shard[ids])
    (rows.sum() + (x @ table.T).sum()).backward()
    want = torch.zeros(10, 3).index_add_(0, ids.reshape(-1),
                                         torch.ones(4, 3))
    want += x.sum(0).expand(10, 3)
    torch.testing.assert_close(shard.grad, want)
    with pytest.raises(ValueError, match="rows per shard"):
        sparse.ShardedEmbedding(shard[:9], 10, _axis(2)).lookup(ids)
    torch.testing.assert_close(
        sparse.embedding_lookup(shard.detach(), ids), shard.detach()[ids])
