"""DenseNet (DenseNet121/169/201) for ImageNet-style classification.

Counterpart of ``autodist_tpu/models/densenet.py``: a 7x7 stem
(``conv_init``, ``bn_init``, 3x3 max pool), dense blocks of
``DenseLayer_i`` (BN-ReLU-Conv1x1 to ``4k``, BN-ReLU-Conv3x3 to ``k``,
concatenated onto the input along the channels, dim 1 of the NCHW
view), ``TransitionLayer_i`` between blocks (BN-ReLU-Conv1x1 halving the
channels, 2x2 average pool), ``bn_final`` and an fp32 ``head``; bf16
activations and fp32 BatchNorm statistics averaged over the ``"data"``
axis while training.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from autodist_tpu_torch.models.layers import (BatchNorm, Conv, Dense,
                                              avg_pool, max_pool)
from autodist_tpu_torch.models.resnet import ImageModel

_CFG = {
    121: (6, 12, 24, 16),
    169: (6, 12, 32, 32),
    201: (6, 12, 48, 32),
}


class DenseLayer(nn.Module):
    """BN-ReLU-Conv1x1 (bottleneck 4k) -> BN-ReLU-Conv3x3 (growth k)."""

    def __init__(self, in_features, growth_rate, conv, norm):
        super().__init__()
        self.BatchNorm_0 = norm(in_features)
        self.Conv_0 = conv(in_features, 4 * growth_rate, (1, 1))
        self.BatchNorm_1 = norm(4 * growth_rate)
        self.Conv_1 = conv(4 * growth_rate, growth_rate, (3, 3))

    def forward(self, x, ctx):
        y = self.Conv_0(torch.relu(self.BatchNorm_0(x, ctx)))
        y = self.Conv_1(torch.relu(self.BatchNorm_1(y, ctx)))
        return torch.cat([x, y], dim=1)


class TransitionLayer(nn.Module):
    """BN-ReLU-Conv1x1 (halve channels) -> 2x2 average pool."""

    def __init__(self, in_features, out_features, conv, norm):
        super().__init__()
        self.BatchNorm_0 = norm(in_features)
        self.Conv_0 = conv(in_features, out_features, (1, 1))

    def forward(self, x, ctx):
        x = self.Conv_0(torch.relu(self.BatchNorm_0(x, ctx)))
        return avg_pool(x, (2, 2), (2, 2))


class DenseNet(ImageModel):
    """flax ``DenseNet`` (a definition)."""

    def __init__(self, depth: int = 121, growth_rate: int = 32,
                 num_classes: int = 1000, dtype=torch.bfloat16,
                 axis_name="data", channels: int = 3):
        super().__init__()
        self.axis_name = axis_name
        conv = functools.partial(Conv, use_bias=False, padding="SAME",
                                 dtype=dtype)
        norm = functools.partial(BatchNorm, dtype=dtype, momentum=0.9,
                                 epsilon=1e-5)
        features = 2 * growth_rate
        self.conv_init = conv(channels, features, (7, 7), (2, 2),
                              padding=((3, 3), (3, 3)))
        self.bn_init = norm(features)
        self.order = []
        layers = transitions = 0
        block_sizes = _CFG[depth]
        for i, n_layers in enumerate(block_sizes):
            for _ in range(n_layers):
                name = f"DenseLayer_{layers}"
                self.add_module(name, DenseLayer(features, growth_rate,
                                                 conv, norm))
                self.order.append(name)
                features += growth_rate
                layers += 1
            if i != len(block_sizes) - 1:
                name = f"TransitionLayer_{transitions}"
                self.add_module(name, TransitionLayer(features, features // 2,
                                                      conv, norm))
                self.order.append(name)
                features //= 2
                transitions += 1
        self.bn_final = norm(features)
        self.head = Dense(features, num_classes, dtype=torch.float32)

    def body(self, x, ctx, generator=None):
        x = torch.relu(self.bn_init(self.conv_init(x), ctx))
        x = max_pool(x, 3, 2, ((1, 1), (1, 1)))
        for name in self.order:
            x = getattr(self, name)(x, ctx)
        x = torch.relu(self.bn_final(x, ctx))
        return self.head(x.mean((2, 3)))


DenseNet121 = functools.partial(DenseNet, depth=121)
DenseNet169 = functools.partial(DenseNet, depth=169)
DenseNet201 = functools.partial(DenseNet, depth=201)
