"""Inception v3 for ImageNet-style classification (299x299 input).

Counterpart of ``autodist_tpu/models/inception.py``: the stem, three
``InceptionA``, ``InceptionB`` (35 -> 17), four ``InceptionC`` (the
factorized 7x7 branches), ``InceptionD`` (17 -> 8) and two
``InceptionE``, then the mean over the map and an fp32 ``head``; no
auxiliary classifier.  Every conv is a ``ConvBN`` (a bias-free conv,
BatchNorm at eps 1e-3, ReLU) with bf16 activations and fp32 statistics
averaged over the ``"data"`` axis while training.

flax names a block's ``ConvBN_i`` in the order the modules are
constructed, and in ``cbn(a)(cbn(b)(x))`` the outer ``cbn(a)`` is
constructed first: ``InceptionA``'s 5x5 branch is ``ConvBN_1`` (the 5x5
on 48 channels) applied after ``ConvBN_2`` (the 1x1 to 48).  Each block
below lists its convs in that order and applies them by index.  The
``(1, 7)`` and ``(7, 1)`` ``"SAME"`` convs pad symmetrically, the
``"VALID"`` reductions pad nothing, and the 3x3 stride-1 ``"SAME"``
average pool divides by 9 at the border.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from autodist_tpu_torch.models.layers import (BatchNorm, Conv, Dense,
                                              avg_pool, max_pool)
from autodist_tpu_torch.models.resnet import ImageModel


class ConvBN(nn.Module):
    def __init__(self, in_features, features, kernel, strides=(1, 1),
                 padding="SAME", *, conv, norm):
        super().__init__()
        self.Conv_0 = conv(in_features, features, kernel, strides,
                           padding=padding)
        self.BatchNorm_0 = norm(features)

    def forward(self, x, ctx):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x), ctx))


class _Block(nn.Module):
    """A block whose ``ConvBN_i`` are built from ``specs`` in flax's
    construction order: ``(in, features, kernel[, strides, padding])``."""

    def __init__(self, specs, conv, norm):
        super().__init__()
        for i, spec in enumerate(specs):
            self.add_module(f"ConvBN_{i}",
                            ConvBN(*spec, conv=conv, norm=norm))

    def chain(self, x, ctx, *indices):
        """``x`` through ``ConvBN_i`` for each index, in order."""
        for i in indices:
            x = getattr(self, f"ConvBN_{i}")(x, ctx)
        return x


class InceptionA(_Block):
    def __init__(self, c, pool_features, conv, norm):
        super().__init__([(c, 64, (1, 1)), (48, 64, (5, 5)),
                          (c, 48, (1, 1)), (96, 96, (3, 3)),
                          (64, 96, (3, 3)), (c, 64, (1, 1)),
                          (c, pool_features, (1, 1))], conv, norm)

    def forward(self, x, ctx):
        b4 = avg_pool(x, (3, 3), (1, 1), "SAME")
        return torch.cat([self.chain(x, ctx, 0), self.chain(x, ctx, 2, 1),
                          self.chain(x, ctx, 5, 4, 3),
                          self.chain(b4, ctx, 6)], dim=1)


class InceptionB(_Block):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, c, conv, norm):
        super().__init__([(c, 384, (3, 3), (2, 2), "VALID"),
                          (96, 96, (3, 3), (2, 2), "VALID"),
                          (64, 96, (3, 3)), (c, 64, (1, 1))], conv, norm)

    def forward(self, x, ctx):
        return torch.cat([self.chain(x, ctx, 0), self.chain(x, ctx, 3, 2, 1),
                          max_pool(x, 3, 2)], dim=1)


class InceptionC(_Block):
    """Factorized 7x7 branches at 17x17."""

    def __init__(self, c_in, c, conv, norm):
        super().__init__([(c_in, 192, (1, 1)),
                          (c_in, c, (1, 1)), (c, c, (1, 7)),
                          (c, 192, (7, 1)),
                          (c_in, c, (1, 1)), (c, c, (7, 1)), (c, c, (1, 7)),
                          (c, c, (7, 1)), (c, 192, (1, 7)),
                          (c_in, 192, (1, 1))], conv, norm)

    def forward(self, x, ctx):
        b4 = avg_pool(x, (3, 3), (1, 1), "SAME")
        return torch.cat([self.chain(x, ctx, 0), self.chain(x, ctx, 1, 2, 3),
                          self.chain(x, ctx, 4, 5, 6, 7, 8),
                          self.chain(b4, ctx, 9)], dim=1)


class InceptionD(_Block):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, c, conv, norm):
        super().__init__([(192, 320, (3, 3), (2, 2), "VALID"),
                          (c, 192, (1, 1)),
                          (c, 192, (1, 1)), (192, 192, (1, 7)),
                          (192, 192, (7, 1)),
                          (192, 192, (3, 3), (2, 2), "VALID")], conv, norm)

    def forward(self, x, ctx):
        return torch.cat([self.chain(x, ctx, 1, 0),
                          self.chain(x, ctx, 2, 3, 4, 5),
                          max_pool(x, 3, 2)], dim=1)


class InceptionE(_Block):
    """Expanded-filter-bank block at 8x8."""

    def __init__(self, c, conv, norm):
        super().__init__([(c, 320, (1, 1)), (c, 384, (1, 1)),
                          (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (448, 384, (3, 3)), (c, 448, (1, 1)),
                          (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (c, 192, (1, 1))], conv, norm)

    def forward(self, x, ctx):
        b2 = self.chain(x, ctx, 1)
        b3 = self.chain(x, ctx, 5, 4)
        b4 = avg_pool(x, (3, 3), (1, 1), "SAME")
        return torch.cat([self.chain(x, ctx, 0), self.chain(b2, ctx, 2),
                          self.chain(b2, ctx, 3), self.chain(b3, ctx, 6),
                          self.chain(b3, ctx, 7), self.chain(b4, ctx, 8)],
                         dim=1)


class InceptionV3(ImageModel):
    """flax ``InceptionV3`` (a definition)."""

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16,
                 axis_name="data", channels: int = 3):
        super().__init__()
        self.axis_name = axis_name
        conv = functools.partial(Conv, use_bias=False, dtype=dtype)
        norm = functools.partial(BatchNorm, dtype=dtype, momentum=0.9,
                                 epsilon=1e-3)
        stem = [(channels, 32, (3, 3), (2, 2), "VALID"),
                (32, 32, (3, 3), (1, 1), "VALID"), (32, 64, (3, 3)),
                (64, 80, (1, 1), (1, 1), "VALID"),
                (80, 192, (3, 3), (1, 1), "VALID")]
        for i, spec in enumerate(stem):
            self.add_module(f"ConvBN_{i}", ConvBN(*spec, conv=conv,
                                                  norm=norm))
        blocks, c = [], 192
        for i, pool_features in enumerate((32, 64, 64)):
            blocks.append((f"InceptionA_{i}",
                           InceptionA(c, pool_features, conv, norm)))
            c = 224 + pool_features
        blocks.append(("InceptionB_0", InceptionB(c, conv, norm)))
        c = 480 + c
        for i, c7 in enumerate((128, 160, 160, 192)):
            blocks.append((f"InceptionC_{i}", InceptionC(c, c7, conv, norm)))
            c = 768
        blocks.append(("InceptionD_0", InceptionD(c, conv, norm)))
        c = 512 + c
        for i in range(2):
            blocks.append((f"InceptionE_{i}", InceptionE(c, conv, norm)))
            c = 2048
        for name, block in blocks:
            self.add_module(name, block)
        self.order = [name for name, _ in blocks]
        self.head = Dense(c, num_classes, dtype=torch.float32)

    def body(self, x, ctx, generator=None):
        for i in range(3):
            x = getattr(self, f"ConvBN_{i}")(x, ctx)
        x = max_pool(x, 3, 2)
        for i in range(3, 5):
            x = getattr(self, f"ConvBN_{i}")(x, ctx)
        x = max_pool(x, 3, 2)
        for name in self.order:
            x = getattr(self, name)(x, ctx)
        return self.head(x.mean((2, 3)))
