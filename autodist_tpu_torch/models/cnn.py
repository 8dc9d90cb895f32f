"""Small models: linear regression and the MNIST CNN.

Counterpart of ``autodist_tpu/models/cnn.py``: ``MnistCNN`` (conv 32,
2x2 average pool, conv 64, pool, flattened in flax's NHWC order, dense
128, dense to the classes; fp32, flax's ``Conv_i`` and ``Dense_i``
names) and the linear-regression smoke model.
"""
from __future__ import annotations

import numpy as np
import torch

from autodist_tpu_torch.capture import Trainable
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.models.layers import (Conv, Dense, avg_pool,
                                              flatten_nhwc, functional_tensors,
                                              init_params, module_params)
from autodist_tpu_torch.models.resnet import (ImageModel,
                                              classification_loss_head)


class MnistCNN(ImageModel):
    """Conv-pool-conv-pool-dense (the reference's Keras example shape);
    ``image_size`` sets ``Dense_0``'s input, which flax infers from its
    init sample."""

    def __init__(self, num_classes: int = 10, image_size: int = 28,
                 channels: int = 1):
        super().__init__()
        self.Conv_0 = Conv(channels, 32, (3, 3))
        self.Conv_1 = Conv(32, 64, (3, 3))
        side = image_size // 2 // 2
        self.Dense_0 = Dense(64 * side * side, 128)
        self.Dense_1 = Dense(128, num_classes)

    def body(self, x, ctx, generator=None):
        x = avg_pool(torch.relu(self.Conv_0(x)), (2, 2), (2, 2))
        x = avg_pool(torch.relu(self.Conv_1(x)), (2, 2), (2, 2))
        x = torch.relu(self.Dense_0(flatten_nhwc(x)))
        return self.Dense_1(x)


def make_cnn_trainable(optimizer, generator, *, image_size=28, channels=1,
                       num_classes=10, batch_size=8, device=None):
    """A Trainable for :class:`MnistCNN` on ``{"x": [B, H, W, C], "y":
    [B]}``, its parameters drawn from ``generator`` and placed on
    ``device`` (``None``: the card)."""
    del batch_size
    model = init_params(MnistCNN(num_classes, image_size, channels),
                        generator, device)

    def loss(p, extra, batch, rng):
        logits, _ = torch.func.functional_call(model, functional_tensors(p),
                                               (batch["x"],))
        l, metrics = classification_loss_head(logits, batch)
        return l, extra, dict(metrics, loss=l)

    return Trainable(loss, module_params(model), optimizer)


def make_linear_regression_trainable(optimizer, *, dim=13, seed=0,
                                     device=None):
    """≙ reference ``examples/linear_regression.py`` (the smoke test):
    ``w`` drawn from the JAX package's numpy stream for ``seed``, ``b``
    zero, on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    params = {"w": torch.as_tensor(rng.randn(dim, 1) * 0.01,
                                   dtype=torch.float32, device=dev),
              "b": torch.zeros((1,), dtype=torch.float32, device=dev)}

    def loss_fn(p, batch):
        pred = batch["x"] @ p["w"] + p["b"]
        return torch.mean((pred - batch["y"]) ** 2)

    return Trainable.from_loss_fn(loss_fn, params, optimizer)
