"""NeuMF and the lm1b LSTM LM, and the optimizers the zoo trains with,
the port against the JAX package on the CPU.

The port draws the parameters, ``interop.to_jax_params`` carries them
to the JAX trainable (built under ``jax.eval_shape``, its own init never
drawn), and one numpy batch from a seed goes through both losses: the
loss within 1e-5 relative, every gradient of ``jax.value_and_grad``
within 1e-5 of each tensor's largest value (floor 1e-3), at fp32.

lm1b runs at vocab 2000, widths 32 and 2 LSTM layers; its negatives come
from the same key in both packages (the port's threefry ``uniform`` on
``PRNGKey(seed)``), and ``neg_ids`` are bit-equal, at vocab 2000 and at
the full model's 800000.  ``sgd`` with momentum (and Nesterov) and
``adagrad`` are held to optax over 3 updates within 1e-6 of each
tensor's largest value (``adagrad``'s ``rsqrt`` is the only op that may
round differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu_torch import models as pm
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.models import lm1b as plm1b
from autodist_tpu_torch.ops import threefry

import test_torch_models_vision as h

LM = dict(vocab_size=2000, embed_dim=32, hidden_dim=32, num_layers=2)


def check_loss_and_grads(ptr, jtr, np_batch, prng_seed):
    """The port's loss and autograd against ``jax.value_and_grad`` of the
    JAX trainable's loss on the port's parameters."""
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.loss(p, None, jb, jax.random.PRNGKey(prng_seed))[:2],
        has_aux=True))(port.to_jax_params(ptr.params))
    leaves = {n: t.clone().requires_grad_(True)
              for n, t in flatten_with_names(ptr.params)}
    loss, _, metrics = ptr.loss(
        unflatten(leaves), None,
        {k: torch.as_tensor(v) for k, v in np_batch.items()}, prng_seed)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=h.LOSS_RTOL)
    h.close({n: g.numpy() for n, g in zip(leaves, grads)}, h.named(jgrads),
            h.TOL, "grad")
    return metrics


def test_neumf_matches_jax():
    from autodist_tpu.models import ncf

    ptr = pm.make_ncf_trainable(port.optim.adam(1e-3),
                                torch.Generator().manual_seed(0),
                                num_users=60, num_items=40, device="cpu")
    jtr = h.jax_trainable(lambda k: ncf.make_ncf_trainable(
        optax.adam(1e-3), k, num_users=60, num_items=40))
    r = np.random.RandomState(1)
    batch = {"users": r.randint(0, 60, 32).astype(np.int32),
             "items": r.randint(0, 40, 32).astype(np.int32),
             "labels": r.randint(0, 2, 32).astype(np.int32)}
    metrics = check_loss_and_grads(ptr, jtr, batch, 0)
    assert 0.0 <= float(metrics["accuracy"]) <= 1.0
    sparse = {i.name for i in ptr.var_infos() if i.is_sparse}
    assert sparse == {f"{t}/embedding" for t in pm.ncf.TABLES}


def test_lm1b_matches_jax():
    """The LSTM (flax's ``OptimizedLSTMCell`` leaves through
    ``torch._VF.lstm``) and the sampled softmax on the same key."""
    from autodist_tpu.models import lm1b

    ptr = pm.make_lm1b_trainable(port.optim.adagrad(0.2),
                                 torch.Generator().manual_seed(0),
                                 device="cpu", **LM)
    jtr = h.jax_trainable(lambda k: lm1b.make_lm1b_trainable(
        optax.adagrad(0.2), k, **LM))
    r = np.random.RandomState(2)
    batch = {"x": r.randint(0, 2000, (4, 6)).astype(np.int32),
             "y": r.randint(0, 2000, (4, 6)).astype(np.int32)}
    batch["y"][0, 0] = 3                     # likely among the negatives
    check_loss_and_grads(ptr, jtr, batch, 11)
    assert {i.name for i in ptr.var_infos() if i.is_sparse} == {
        "embedding/embedding", "softmax_w"}


@pytest.mark.parametrize("vocab", [2000, 800_000])
@pytest.mark.parametrize("seed", [0, 11, 2 ** 31 - 7])
def test_lm1b_negatives_are_bit_equal(vocab, seed):
    from autodist_tpu.models import lm1b

    jids, jq = lm1b.log_uniform_sample(jax.random.PRNGKey(seed), 64, vocab)
    ids, q = plm1b.log_uniform_sample(threefry.key(seed), 64, vocab)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-6)


def test_sampled_softmax_masks_accidental_hits():
    """Labels drawn among the negatives (two rows hit, one misses): the
    masked loss is finite and equals the JAX package's."""
    key = threefry.key(5)
    ids, _ = plm1b.log_uniform_sample(key, 16, 50)
    g = torch.Generator().manual_seed(0)
    w = torch.randn(50, 8, generator=g)
    b = torch.randn(50, generator=g)
    hid = torch.randn(3, 8, generator=g)
    labels = torch.stack([ids[0], ids[0], (ids[0] + 1) % 50]).to(torch.int32)
    got = plm1b.sampled_softmax_loss(key, w, b, hid, labels, 16, 50)
    assert torch.isfinite(got)
    from autodist_tpu.models import lm1b

    want = lm1b.sampled_softmax_loss(
        jax.random.PRNGKey(5), w.numpy(), b.numpy(), hid.numpy(),
        labels.numpy(), 16, 50)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("name,make_port,make_optax", [
    ("sgd momentum", lambda: port.optim.sgd(0.1, momentum=0.9),
     lambda: optax.sgd(0.1, momentum=0.9)),
    ("sgd nesterov", lambda: port.optim.sgd(0.1, momentum=0.9,
                                            nesterov=True),
     lambda: optax.sgd(0.1, momentum=0.9, nesterov=True)),
    ("adagrad", lambda: port.optim.adagrad(0.2),
     lambda: optax.adagrad(0.2)),
    ("adagrad from 0", lambda: port.optim.adagrad(
        0.2, initial_accumulator_value=0.0),
     lambda: optax.adagrad(0.2, initial_accumulator_value=0.0)),
])
def test_optimizers_match_optax(name, make_port, make_optax):
    """3 updates on the same gradients (one zero entry, which keeps an
    accumulator from 0 at 0), parameters within 1e-6 of their largest
    value."""
    r = np.random.RandomState(3)
    params = {"a": r.randn(5, 3).astype(np.float32),
              "b": r.randn(7).astype(np.float32)}
    popt, jopt = make_port(), make_optax()
    tp = {k: torch.tensor(v) for k, v in params.items()}
    jp = jax.tree.map(jnp.asarray, params)
    ps, js = popt.init(tp), jopt.init(jp)
    for i in range(3):
        g = {k: r.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
        g["b"][0] = 0.0
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        pu, ps = popt.update({k: torch.tensor(v) for k, v in g.items()},
                             ps, tp)
        tp = port.optim.apply_updates(tp, pu)
    h.close({k: t.numpy() for k, t in tp.items()},
            {k: np.asarray(v) for k, v in jp.items()}, 1e-6, name)
