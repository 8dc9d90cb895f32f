"""DenseNet121, the port against the JAX package on the CPU: the case of
``test_torch_models_vision.py`` (its harness) at ``growth_rate=8`` on 32
px, in float64 (``jax.enable_x64``), every tensor within 1e-6 of its
largest value (floor 1e-3), a bound set by the fp32 head both packages
keep.

Not in fp32: the fourth dense block runs on a 1x1 map over a batch of
4, where the features hardly differ between samples, and flax's fast
variance ``E[x^2] - E[x]^2`` cancels to rounding noise; there the fp32
gradients of either package part from the other's by up to 130 % of a
tensor's largest value (the loss by 3e-7), while in float64 they agree
within 4e-7.  XLA's optimizations are off for this file's one compile
(restored after), which keeps it inside its time budget.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from autodist_tpu_torch import models as pm

import test_torch_models_vision as h


@pytest.fixture(autouse=True)
def quick_compile():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def test_densenet121_matches_jax_in_float64():
    from autodist_tpu.models import densenet

    with jax.enable_x64(True):
        h.check_image_model(
            densenet.DenseNet121(num_classes=10, growth_rate=8,
                                 dtype=jnp.float64, axis_name=None),
            lambda: pm.DenseNet121(num_classes=10, growth_rate=8,
                                   dtype=torch.float64, axis_name=None),
            32, tol=dict.fromkeys(h.BN_TOL, h.F64_TOL), dtype=torch.float64)
