"""The image models of the zoo, the MNIST CNN, linear regression and
flax's BatchNorm, the port against the JAX package on the CPU.

Each model case draws the port's parameters (and ``batch_stats``) from a
seeded generator, carries them to the JAX package with
``interop.to_jax_params`` (and back, bit for bit), and compares, at
fp32 on one numpy batch, the loss, the logits and every gradient of
``jax.value_and_grad`` of the JAX trainable's loss with the port's
autograd, and the new running statistics (for the image models the
JAX trainable's loss body, one ``model.apply``, which keeps the logits
and traces the flax model once).  The BatchNorm models are
built with ``axis_name=None`` here: one replica's statistics are the
whole batch's, and the cross-replica mean is held on 2 ranks in
``test_torch_models_lowering.py``.

Tolerances: the loss within 1e-5 relative; every other tensor (logits,
gradients, running statistics) within a tolerance of its largest value
(floored at 1e-3): 1e-5 for the models without BatchNorm; for the
BatchNorm models 1e-4 (logits, statistics) and 1e-3 (gradients).  flax's
fast variance ``E[x^2] - E[x]^2`` cancels at this test's deepest layers
(a 1x1 map over a batch of 4), where the two packages' fp32 summation
orders part by up to 3e-4 in a norm's scale gradient.  That the gap is
rounding and not a difference of math is held in float64
(``jax.enable_x64``): ResNet18 through the lowering on 2 ranks against
the JAX runner at 1e-5 (``test_torch_models_lowering.py``), DenseNet121
and InceptionV3 at 1e-6, a bound set by the fp32 head both packages
keep (their own files).

One JAX jit a case; where a JAX trainable is built, it is built under
``jax.eval_shape``, so its parameters are never drawn (the port's are
used).  DenseNet121 and InceptionV3 have files of their own
(``test_torch_models_densenet.py``, ``_inception.py``): their JAX
compiles take most of a file's budget.
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
from autodist_tpu_torch.models import layers

LOSS_RTOL = 1e-5
TOL = 1e-5
BN_TOL = {"logits": 1e-4, "grad": 1e-3, "batch_stats": 1e-4}
F64_TOL = 1e-6          # float64 cases (DenseNet121, InceptionV3)


def jax_trainable(make):
    """The JAX trainable ``make(key)`` builds, its init only traced
    (``jax.eval_shape``): the loss closure is what the tests use."""
    box = []

    def build(key):
        box.append(make(key))
        return box[0].params

    jax.eval_shape(build, jax.random.PRNGKey(0))
    return box[0]


def named(tree) -> dict:
    return {n: np.asarray(v) for n, v in flatten_with_names(tree)}


def close(got: dict, want: dict, tol: float, what: str):
    """Each tensor within ``tol`` of its largest value (floor 1e-3)."""
    assert sorted(got) == sorted(want), what
    for n in want:
        assert got[n].shape == want[n].shape, (what, n)
        scale = max(float(np.abs(want[n]).max()), 1e-3)
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= tol * scale, f"{what} {n}: {err} > {tol} x {scale}"


def image_batch(size, batch, classes, seed=0):
    r = np.random.RandomState(seed)
    return {"x": r.rand(batch, size, size, 3).astype(np.float32),
            "y": r.randint(0, classes, batch).astype(np.int32)}


def check_image_model(jmodel, pdef, size, batch=4, classes=10,
                      tol=None, dtype=torch.float32):
    """One model case: the port's init through ``to_jax_params`` into the
    JAX ``make_image_trainable``'s train loss (one ``model.apply`` and
    ``classification_loss_head``, its logits kept; ``value_and_grad``,
    jitted) against the port's loss and autograd, every tensor within
    ``tol`` (by kind) of its largest value.  ``dtype`` float64 runs the
    parameters and the batch in float64 (under ``jax.enable_x64``)."""
    from autodist_tpu.models import resnet as jresnet

    np_batch = image_batch(size, batch, classes)
    np_batch["x"] = np_batch["x"].astype(str(dtype)[6:])
    ptr = pm.make_image_trainable(pdef(), port.optim.sgd(0.1),
                                  torch.Generator().manual_seed(0),
                                  image_size=size, device="cpu")
    tol = tol or dict.fromkeys(("logits", "grad", "batch_stats"), TOL)
    if dtype != torch.float32:
        cast = lambda tree: unflatten({n: t.to(dtype) for n, t in  # noqa: E731
                                       flatten_with_names(tree)})
        ptr.params = cast(ptr.params)
        ptr.extra = ptr.extra and cast(ptr.extra)
    jparams = port.to_jax_params(ptr.params)
    back = named(port.from_jax_params(jparams, device="cpu"))
    assert all(np.array_equal(back[n], t) for n, t in
               named(ptr.params).items())
    has_bn = ptr.extra is not None
    jextra = ({"batch_stats": port.to_jax_params(ptr.extra["batch_stats"])}
              if has_bn else None)
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}

    def jfn(p):
        # The JAX make_image_trainable's train loss, its logits kept.
        variables = {"params": p, **(jextra or {})}
        if has_bn:
            logits, updates = jmodel.apply(variables, jb["x"], train=True,
                                           mutable=["batch_stats"])
            new_extra = {"batch_stats": updates["batch_stats"]}
        else:
            logits, new_extra = jmodel.apply(variables, jb["x"]), None
        loss, _ = jresnet.classification_loss_head(logits, jb)
        return loss, (new_extra, logits)

    (jloss, (jnew, jlogits)), jgrads = jax.jit(
        jax.value_and_grad(jfn, has_aux=True))(jparams)

    leaves = {n: t.clone().requires_grad_(True)
              for n, t in flatten_with_names(ptr.params)}
    pb = {k: torch.as_tensor(v) for k, v in np_batch.items()}
    loss, new_extra, metrics = ptr.loss(unflatten(leaves), ptr.extra, pb, 1)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    logits, _ = torch.func.functional_call(
        layers.init_params(pdef(), torch.Generator(), "cpu"),
        layers.functional_tensors(ptr.params, ptr.extra), (pb["x"],))

    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=LOSS_RTOL)
    close({"logits": logits.detach().numpy()},
          {"logits": np.asarray(jlogits)}, tol["logits"], "logits")
    close({n: g.numpy() for n, g in zip(leaves, grads)}, named(jgrads),
          tol["grad"], "grad")
    if has_bn:
        close(named(new_extra), named(jnew), tol["batch_stats"],
              "batch_stats")
    else:
        assert new_extra is None and jnew is None


def test_resnet18_matches_jax():
    from autodist_tpu.models import resnet

    check_image_model(
        resnet.ResNet18(num_classes=10, num_filters=8, dtype=jnp.float32,
                        axis_name=None),
        lambda: pm.ResNet18(num_classes=10, num_filters=8,
                            dtype=torch.float32, axis_name=None), 32,
        tol=BN_TOL)


def test_resnet50_matches_jax():
    from autodist_tpu.models import resnet

    check_image_model(
        resnet.ResNet50(num_classes=10, num_filters=8, dtype=jnp.float32,
                        axis_name=None),
        lambda: pm.ResNet50(num_classes=10, num_filters=8,
                            dtype=torch.float32, axis_name=None), 32,
        tol=BN_TOL)


def test_vgg11_matches_jax():
    from autodist_tpu.models import vgg

    check_image_model(
        vgg.VGG11(num_classes=10, hidden=32, dtype=jnp.float32),
        lambda: pm.VGG11(num_classes=10, hidden=32, dtype=torch.float32,
                         image_size=32), 32)


def test_mnist_cnn_matches_jax():
    """The MNIST CNN (flattened in flax's NHWC order) through both
    packages' ``make_cnn_trainable``."""
    from autodist_tpu.models import cnn

    r = np.random.RandomState(3)
    np_batch = {"x": r.rand(4, 28, 28, 1).astype(np.float32),
                "y": r.randint(0, 10, 4).astype(np.int32)}
    ptr = pm.make_cnn_trainable(port.optim.sgd(0.1),
                                torch.Generator().manual_seed(0),
                                device="cpu")
    jtr = jax_trainable(lambda k: cnn.make_cnn_trainable(optax.sgd(0.1), k))
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    jparams = port.to_jax_params(ptr.params)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.loss(p, None, jb, None)[:2], has_aux=True))(jparams)
    leaves = {n: t.clone().requires_grad_(True)
              for n, t in flatten_with_names(ptr.params)}
    loss, _, _ = ptr.loss(unflatten(leaves), None,
                          {k: torch.as_tensor(v) for k, v in
                           np_batch.items()}, None)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    close({n: g.numpy() for n, g in zip(leaves, grads)}, named(jgrads), TOL,
          "grad")


def test_linear_regression_matches_jax():
    """The same numpy init bit for bit, and the same loss and
    gradients."""
    from autodist_tpu.models import cnn

    ptr = pm.make_linear_regression_trainable(port.optim.sgd(0.1), dim=13,
                                              seed=4, device="cpu")
    jtr = cnn.make_linear_regression_trainable(optax.sgd(0.1), dim=13,
                                               seed=4)
    assert all(np.array_equal(named(ptr.params)[n], v)
               for n, v in named(jtr.params).items())
    r = np.random.RandomState(5)
    np_batch = {"x": r.randn(16, 13).astype(np.float32),
                "y": r.randn(16, 1).astype(np.float32)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtr.loss(p, None, np_batch, None)[:2],
        has_aux=True)(jtr.params)
    leaves = {n: t.clone().requires_grad_(True)
              for n, t in flatten_with_names(ptr.params)}
    loss, _, _ = ptr.loss(unflatten(leaves), None,
                          {k: torch.as_tensor(v) for k, v in
                           np_batch.items()}, None)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    close({n: g.numpy() for n, g in zip(leaves, grads)}, named(jgrads), TOL,
          "grad")


def test_batchnorm_matches_flax():
    """flax's BatchNorm alone: the train output, the running statistics
    after it (the biased variance, momentum 0.9, not torch's unbiased
    update), and the eval output on those statistics."""
    import flax.linen as nn

    r = np.random.RandomState(6)
    x = (r.randn(4, 5, 3, 6) * 2 + 1).astype(np.float32)     # NHWC
    scale = r.rand(6).astype(np.float32) + 0.5
    bias = r.randn(6).astype(np.float32)
    stats = {"mean": r.randn(6).astype(np.float32),
             "var": r.rand(6).astype(np.float32) + 0.5}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                      epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": stats}
    jy, upd = bn.apply(variables, x, mutable=["batch_stats"])
    jeval = nn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]},
        x)

    norm = layers.init_params(layers.BatchNorm(6), torch.Generator(), "cpu")
    tensors = {"scale": torch.tensor(scale), "bias": torch.tensor(bias),
               "mean": torch.tensor(stats["mean"]),
               "var": torch.tensor(stats["var"])}
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    ctx = layers.NormContext(train=True)
    y = torch.func.functional_call(norm, tensors, (xt, ctx))
    mean, var = ctx.updates[norm]
    close({"y": y.permute(0, 2, 3, 1).numpy(), "mean": mean.numpy(),
           "var": var.numpy()},
          {"y": np.asarray(jy), "mean": np.asarray(upd["batch_stats"]["mean"]),
           "var": np.asarray(upd["batch_stats"]["var"])}, TOL, "train")
    batch_var = x.reshape(-1, 6).var(0)                    # biased
    np.testing.assert_allclose(var.numpy(), 0.9 * stats["var"]
                               + 0.1 * batch_var, rtol=1e-5)
    torch_bn = torch.nn.BatchNorm2d(6, momentum=0.1)
    torch_bn.running_var.copy_(torch.tensor(stats["var"]))
    torch_bn.train()(xt)
    assert not np.allclose(torch_bn.running_var.numpy(), var.numpy(),
                           rtol=1e-4)
    tensors.update(mean=mean, var=var)
    yeval = torch.func.functional_call(
        norm, tensors, (xt, layers.NormContext(train=False)))
    close({"y": yeval.permute(0, 2, 3, 1).numpy()},
          {"y": np.asarray(jeval)}, TOL, "eval")


@pytest.mark.parametrize("size,stride,want", [
    (56, 2, (0, 1)), (57, 2, (1, 1)), (17, 1, (1, 1)), (8, 2, (0, 1)),
    (35, 1, (1, 1))])
def test_same_padding_is_lax_s(size, stride, want):
    """``"SAME"`` pads as ``lax.padtype_to_pads``: a 3x3 stride-2 conv
    on an even input pads 0 before and 1 after."""
    from jax import lax

    assert layers.same_pads(size, 3, stride) == want
    assert tuple(lax.padtype_to_pads((size,), (3,), (stride,),
                                     "SAME")[0]) == want


def test_asymmetric_padding_conv_matches_lax():
    """A 3x3 stride-2 ``"SAME"`` conv on 8x8 against
    ``lax.conv_general_dilated``; ``padding=1`` in ``F.conv2d`` would
    differ."""
    from jax import lax

    r = np.random.RandomState(7)
    x = r.randn(2, 8, 8, 3).astype(np.float32)
    k = r.randn(3, 3, 3, 4).astype(np.float32)
    want = np.asarray(lax.conv_general_dilated(
        x, k, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    conv = layers.init_params(layers.Conv(3, 4, (3, 3), (2, 2),
                                          use_bias=False),
                              torch.Generator(), "cpu")
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    got = torch.func.functional_call(conv, {"kernel": torch.tensor(k)},
                                     (xt,)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    sym = torch.nn.functional.conv2d(xt, torch.tensor(k).permute(3, 2, 0, 1),
                                     stride=2, padding=1)
    assert not np.allclose(sym.permute(0, 2, 3, 1).numpy(), want,
                           atol=1e-3)


def test_unbound_data_axis_raises_as_in_jax():
    """A BatchNorm model trained outside a lowering names an axis nobody
    bound: both packages raise ``NameError``."""
    from autodist_tpu.models import resnet

    np_batch = image_batch(16, 2, 10)
    ptr = pm.make_image_trainable(
        pm.ResNet18(num_classes=10, num_filters=4, dtype=torch.float32),
        port.optim.sgd(0.1), torch.Generator(), image_size=16, device="cpu")
    with pytest.raises(NameError, match="unbound axis name"):
        ptr.loss(ptr.params, ptr.extra,
                 {k: torch.as_tensor(v) for k, v in np_batch.items()}, 1)
    jmodel = resnet.ResNet18(num_classes=10, num_filters=4,
                             dtype=jnp.float32)
    jtr = jax_trainable(lambda k: resnet.make_image_trainable(
        jmodel, optax.sgd(0.1), k, image_size=16, batch_size=2))
    with pytest.raises(NameError, match="unbound axis name"):
        jtr.loss(port.to_jax_params(ptr.params),
                 {"batch_stats": port.to_jax_params(
                     ptr.extra["batch_stats"])}, np_batch,
                 jax.random.PRNGKey(0))


def test_image_trainable_checks_the_sample():
    """The definition runs on a ``meta`` sample of the trainable's
    shape, as flax's init does: a VGG sized for 224 px refuses 32."""
    with pytest.raises(ValueError, match="does not take"):
        pm.make_image_trainable(pm.VGG11(hidden=8), port.optim.sgd(0.1),
                                torch.Generator(), image_size=32,
                                device="cpu")


def test_interop_recognizes_the_zoo():
    """Every zoo tree converts both ways bit for bit; a tree that is no
    model's raises."""
    gen = torch.Generator().manual_seed(1)
    tr = pm.make_image_trainable(
        pm.DenseNet121(num_classes=3, growth_rate=2, dtype=torch.float32),
        port.optim.sgd(0.1), gen, image_size=32, device="cpu")
    for tree in (tr.params, tr.extra["batch_stats"], tr.extra):
        back = port.from_jax_params(port.to_jax_params(tree), device="cpu")
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(flatten_with_names(tree), flatten_with_names(back)))
    for tree in (pm.make_ncf_trainable(port.optim.sgd(0.1), gen,
                                       device="cpu").params,
                 pm.make_lm1b_trainable(port.optim.sgd(0.1), gen,
                                        vocab_size=50, embed_dim=4,
                                        hidden_dim=4, num_layers=2,
                                        device="cpu").params):
        port.from_jax_params(port.to_jax_params(tree), device="cpu")
    broken = dict(tr.params)
    broken.pop("head")
    with pytest.raises(ValueError, match="model zoo"):
        port.from_jax_params(port.to_jax_params(broken), device="cpu")
