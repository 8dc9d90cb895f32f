"""InceptionV3, the port against the JAX package on the CPU: the case of
``test_torch_models_vision.py`` (its harness), forward and backward at
75 px and batch 2, the smallest input on which every block still runs
(the stem takes 75 px to 7, ``InceptionB`` to 3, ``InceptionD`` to 1;
299 px is too slow for the CPU), in float64 (``jax.enable_x64``), every
tensor within 1e-6 of its largest value (floor 1e-3), a bound set by the
fp32 head both packages keep.

Not in fp32: ``InceptionE`` normalizes a 1x1 map over 2 samples whose
features hardly differ, where flax's fast variance cancels to rounding
noise; there the fp32 losses part by 1.7 % and the logits by 9 %, while
in float64 every tensor agrees within 5e-7.

The naming case holds flax's construction order: in
``cbn(a)(cbn(b)(x))`` the outer conv is ``ConvBN_i`` and the inner
``ConvBN_{i+1}``.
"""
import jax
import jax.numpy as jnp
import torch

from autodist_tpu_torch import models as pm
from autodist_tpu_torch.interop import zoo_leaves

import test_torch_models_vision as h


def test_inception_v3_matches_jax_in_float64():
    from autodist_tpu.models import inception

    with jax.enable_x64(True):
        h.check_image_model(
            inception.InceptionV3(num_classes=10, dtype=jnp.float64,
                                  axis_name=None),
            lambda: pm.InceptionV3(num_classes=10, dtype=torch.float64,
                                   axis_name=None), 75, batch=2,
            tol=dict.fromkeys(h.BN_TOL, h.F64_TOL), dtype=torch.float64)


def test_inception_v3_names_follow_flax_construction_order():
    """``InceptionA``'s 5x5 branch: ``ConvBN_1`` is the 5x5 on 48
    channels, ``ConvBN_2`` the 1x1 to 48 applied before it."""
    from autodist_tpu.models import inception

    shapes = jax.eval_shape(
        lambda k: inception.InceptionV3(num_classes=10).init(
            k, jnp.zeros((1, 75, 75, 3)), train=False),
        jax.random.PRNGKey(0))["params"]["InceptionA_0"]
    assert shapes["ConvBN_1"]["Conv_0"]["kernel"].shape == (5, 5, 48, 64)
    assert shapes["ConvBN_2"]["Conv_0"]["kernel"].shape == (1, 1, 192, 48)
    block = pm.InceptionV3(num_classes=10).InceptionA_0
    assert tuple(block.ConvBN_1.Conv_0.kernel.shape) == (5, 5, 48, 64)
    assert tuple(block.ConvBN_2.Conv_0.kernel.shape) == (1, 1, 192, 48)
    assert "InceptionE_1/ConvBN_8/BatchNorm_0/scale" in \
        zoo_leaves()["InceptionV3"][0]
