"""Ring attention and the causal LM of sequence parallelism, against the
JAX package on the CPU.

The same numpy inputs go through the JAX package's
``sequence_sharded_attention`` on its simulated 8-device mesh (the
flash ring through the Pallas kernels in interpret mode) and through the
port's ring on 2 and 4 gloo ranks (``autodist_tpu_torch.testing
.launch``), the einsum ring and the flash ring (K1/K2's plain versions
on the CPU), causal and not: outputs within 1e-5, gradients within 2e-4
(the JAX tests' tolerances).  ``global_positions`` and the unbound-axis
error are held to the JAX functions in one process, and so are
``TransformerLM`` and ``lm_loss_head`` (logits and loss within 1e-5,
every gradient within 1e-5); ``cfg.remat`` gives the same loss and
gradients as no remat at a nonzero dropout rate.
"""
import functools
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu_torch import testing
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.models import transformer as tt
from autodist_tpu_torch.parallel import sequence as tseq
from autodist_tpu_torch.parallel.axis import Axis, axis_scope

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
B, L, H, D = 2, 16, 2, 16
CASES = [(flash, causal) for flash in (False, True) for causal in (False,
                                                                    True)]


def _inputs():
    r = np.random.RandomState(0)
    return [r.randn(B, L, H, D).astype(np.float32) for _ in range(4)]


_WORKER = textwrap.dedent("""
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.parallel.ring_attention import (
        sequence_sharded_attention)
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)
    axis = port.ResourceSpec({"mesh": {"seq": world}}).make_mesh().axis(
        "seq")
    res = {}
    for flash, causal in job["cases"]:
        q, k, v = (torch.tensor(x, requires_grad=True)
                   for x in job["inputs"][:3])
        o = sequence_sharded_attention(q, k, v, axis, causal=causal,
                                       flash=flash)
        (o * torch.as_tensor(job["inputs"][3])).sum().backward()
        # each rank holds its chunks' gradients: their sum is the global
        res[(flash, causal)] = [o.detach()] + [axis.psum(t.grad)
                                               for t in (q, k, v)]
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")


def _jax_ring(mesh_size, flash, causal):
    from jax.sharding import Mesh

    from autodist_tpu.parallel.ring_attention import (
        sequence_sharded_attention)

    mesh = Mesh(np.array(jax.devices()[:mesh_size]), ("seq",))
    q, k, v, g = _inputs()

    def f(q, k, v):
        return sequence_sharded_attention(q, k, v, mesh, causal=causal,
                                          flash=flash)

    def out_and_grads(q, k, v):
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(jnp.asarray(g))

    out, grads = jax.jit(out_and_grads)(q, k, v)
    return [np.asarray(out)] + [np.asarray(x) for x in grads]


@pytest.fixture(scope="module")
def port_rings(tmp_path_factory):
    """The port's rings on 2 and 4 gloo ranks, started together."""
    tmp = tmp_path_factory.mktemp("ring")
    joins = {}
    for world in (2, 4):
        d = tmp / f"w{world}"
        d.mkdir()
        torch.save({"cases": CASES, "inputs": _inputs()}, d / "job.pt")
        joins[world] = (testing.launch(_WORKER, world, (d / "job.pt",
                                                        d / "res.pt"),
                                       tmp=d, timeout=300), d / "res.pt")
    out = {}
    for world, (join, res) in joins.items():
        join()
        out[world] = torch.load(res, weights_only=False)
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("flash,causal", CASES)
def test_ring_matches_jax_sequence_sharded_attention(port_rings, world,
                                                     flash, causal):
    """The einsum and the flash ring on ``world`` ranks: the output
    within 1e-5 and dq, dk, dv within 2e-4 of JAX's."""
    got = port_rings[world][(flash, causal)]
    want = _jax_ring(world, flash, causal)
    np.testing.assert_allclose(got[0].numpy(), want[0], **OUT_TOL)
    for name, a, b in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_one_rank_ring_is_flash_attention():
    """A seq axis of one rank: the flash ring is one diagonal chunk,
    ``flash_attention`` causal, bit for bit; the einsum ring agrees
    within 1e-5."""
    from autodist_tpu_torch.ops.flash_attention import flash_attention
    from autodist_tpu_torch.parallel.ring_attention import (
        ring_flash_attention, ring_self_attention)

    q, k, v, _ = (torch.as_tensor(x) for x in _inputs())
    with axis_scope({"seq": Axis("seq")}):
        flash = ring_flash_attention(q, k, v, causal=True)
        plain = ring_self_attention(q, k, v, causal=True)
    want = flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(flash, want, atol=0, rtol=0)
    torch.testing.assert_close(plain, want, **OUT_TOL)


def test_global_positions_match_jax():
    """Each rank's global positions equal the JAX function's under
    ``shard_map``; the ``max_len`` check raises the JAX ValueError in
    both packages, and an unbound axis name raises in both."""
    from jax.sharding import Mesh, PartitionSpec as P

    from autodist_tpu.parallel.sequence import global_positions

    mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))
    want = jax.shard_map(lambda: global_positions(5), mesh=mesh,
                         in_specs=(), out_specs=P("seq"))()
    got = []
    for i in range(4):
        with axis_scope({"seq": Axis("seq", size=4, index=i)}):
            got.append(tseq.global_positions(5))
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="does not cover"):
        jax.shard_map(lambda: global_positions(5, max_len=19), mesh=mesh,
                      in_specs=(), out_specs=P("seq"))()
    with axis_scope({"seq": Axis("seq", size=4, index=1)}):
        with pytest.raises(ValueError, match="does not cover"):
            tseq.global_positions(5, max_len=19)
        assert tseq.global_positions(5, max_len=20).tolist() == [5, 6, 7, 8,
                                                                  9]
    with pytest.raises(NameError, match="unbound axis name"):
        jax.jit(lambda: global_positions(5))()
    with pytest.raises(NameError, match="unbound axis name"):
        tseq.global_positions(5)


# --------------------------------------------------------------------------- #
# TransformerLM and lm_loss_head
# --------------------------------------------------------------------------- #
LM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
          mlp_dim=64, max_len=16)


def _lm_batch(weights=False):
    r = np.random.RandomState(3)
    x = r.randint(0, 64, (3, 16)).astype(np.int32)
    batch = {"x": x, "y": np.roll(x, -1, axis=1)}
    if weights:
        batch["w"] = (r.rand(3, 16) > 0.3).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_lm_params():
    from autodist_tpu.models.transformer import (TransformerConfig,
                                                 TransformerLM)

    cfg = TransformerConfig(**LM, dtype=jnp.float32)
    return jax.tree.map(np.asarray, jax.jit(TransformerLM(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))["params"])


def _port_lm(params, **kw):
    cfg = port.TransformerConfig(**LM, dtype=torch.float32, **{
        "dropout_rate": 0.0, "attention_dropout_rate": 0.0, **kw})
    tr = port.make_lm_trainable(cfg, port.optim.sgd(0.1), torch.Generator(),
                                device="cpu")
    tr.params = port.from_jax_params(params, device="cpu")
    return tr


def _loss_and_grads(tr, batch, rng=None):
    leaves = {n: t.clone().requires_grad_()
              for n, t in flatten_with_names(tr.params)}
    loss, _, metrics = tr.loss(unflatten(leaves), None,
                               {k: torch.as_tensor(v)
                                for k, v in batch.items()}, rng)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, metrics, dict(zip(leaves, grads))


@pytest.mark.parametrize("weights", [False, True])
def test_transformer_lm_matches_jax(weights):
    """Logits, ``lm_loss_head``'s loss and accuracy (with and without
    the ``w`` weights) and every gradient against the JAX model's on the
    same weights, at 1e-5."""
    from autodist_tpu.capture import path_to_name
    from autodist_tpu.models.transformer import (TransformerConfig,
                                                 TransformerLM, lm_loss_head)

    params, batch = _jax_lm_params(), _lm_batch(weights)
    model = TransformerLM(TransformerConfig(**LM, dtype=jnp.float32,
                                            dropout_rate=0.0,
                                            attention_dropout_rate=0.0))

    def jloss(p):
        loss, m = lm_loss_head(model.apply({"params": p}, batch["x"]),
                               batch)
        return loss, m

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tr = _port_lm(params)
    lm = tt.TransformerLM(port.TransformerConfig(**LM, dtype=torch.float32),
                          torch.Generator())
    logits = torch.func.functional_call(
        lm, {n.replace("/", "."): t for n, t in flatten_with_names(tr.params)},
        (torch.as_tensor(batch["x"]),))
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(jax.jit(model.apply)({"params": params}, batch["x"])),
        **OUT_TOL)
    loss, metrics, grads = _loss_and_grads(tr, batch)
    np.testing.assert_allclose(float(loss), float(jl), **OUT_TOL)
    np.testing.assert_allclose(float(metrics["accuracy"]),
                               float(jm["accuracy"]), **OUT_TOL)
    jg = {path_to_name(p): np.asarray(x)
          for p, x in jax.tree_util.tree_flatten_with_path(jg)[0]}
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jg[name], **OUT_TOL,
                                   err_msg=name)


def test_remat_equals_no_remat_with_dropout():
    """``cfg.remat`` at dropout 0.1: the recompute redraws the first
    pass's masks, so the loss and every gradient equal the run without
    remat; a different seed gives a different loss."""
    params, batch = _jax_lm_params(), _lm_batch()
    drop = dict(dropout_rate=0.1, attention_dropout_rate=0.1)
    plain = _loss_and_grads(_port_lm(params, **drop), batch, rng=7)
    remat = _loss_and_grads(_port_lm(params, remat=True, **drop), batch,
                            rng=7)
    torch.testing.assert_close(remat[0], plain[0], atol=0, rtol=0)
    for name, g in plain[2].items():
        torch.testing.assert_close(remat[2][name], g, atol=0, rtol=0,
                                   msg=name)
    other = _loss_and_grads(_port_lm(params, **drop), batch, rng=8)
    assert float(other[0]) != float(plain[0])


def test_interop_round_trips_the_lm_tree():
    """The TransformerLM tree converts leaf for leaf both ways, bit for
    bit; a tree with a leaf missing is refused."""
    params = _jax_lm_params()
    back = dict(flatten_with_names(port.to_jax_params(
        port.from_jax_params(params, device="cpu"))))
    for name, a in flatten_with_names(params):
        np.testing.assert_array_equal(back[name], a)
    flat = dict(flatten_with_names(params))
    flat.pop("ln_final/bias")
    with pytest.raises(ValueError, match="ln_final/bias"):
        port.from_jax_params(unflatten(flat), device="cpu")
