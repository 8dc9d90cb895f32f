"""VGG (VGG11/13/16/19) for ImageNet-style classification.

Counterpart of ``autodist_tpu/models/vgg.py``: 3x3 ``"SAME"`` convs with
bias (``conv{stage}_{i}``) and a 2x2 max pool after each stage, the
feature map flattened in flax's NHWC order, two ``Dense`` layers of
``hidden`` (``fc0``, ``fc1``) with optional dropout, and an fp32
``head``; bf16 activations by default.  No BatchNorm, so its trainable
has no extra state.  Dropout (``dropout_rate``, 0 by default) draws from
the step's generator, as BERT's does.
"""
from __future__ import annotations

import functools

import torch

from autodist_tpu_torch.models.layers import Conv, Dense, flatten_nhwc, max_pool
from autodist_tpu_torch.models.resnet import ImageModel
from autodist_tpu_torch.models.transformer import dropout

# Each entry: number of 3x3 conv layers per stage; maxpool between stages.
_CFG = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}
_STAGE_FILTERS = (64, 128, 256, 512, 512)


class VGG(ImageModel):
    """flax ``VGG`` (a definition).  ``image_size`` sets ``fc0``'s input
    (512 channels of ``image_size / 32`` squared), which flax infers from
    its init sample."""

    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 hidden: int = 4096, dropout_rate: float = 0.0,
                 dtype=torch.bfloat16, image_size: int = 224,
                 channels: int = 3):
        super().__init__()
        self.depth, self.dropout_rate = depth, dropout_rate
        features = channels
        for stage, n_layers in enumerate(_CFG[depth]):
            for i in range(n_layers):
                self.add_module(f"conv{stage}_{i}",
                                Conv(features, _STAGE_FILTERS[stage],
                                     (3, 3), dtype=dtype))
                features = _STAGE_FILTERS[stage]
            image_size //= 2
        features *= image_size * image_size
        for i in range(2):
            self.add_module(f"fc{i}", Dense(features, hidden, dtype=dtype))
            features = hidden
        self.head = Dense(hidden, num_classes, dtype=torch.float32)

    def body(self, x, ctx, generator=None):
        for stage, n_layers in enumerate(_CFG[self.depth]):
            for i in range(n_layers):
                x = torch.relu(getattr(self, f"conv{stage}_{i}")(x))
            x = max_pool(x, 2, 2)
        x = flatten_nhwc(x)
        for i in range(2):
            x = torch.relu(getattr(self, f"fc{i}")(x))
            if ctx.train:
                x = dropout(x, self.dropout_rate, generator)
        return self.head(x)


VGG11 = functools.partial(VGG, depth=11)
VGG13 = functools.partial(VGG, depth=13)
VGG16 = functools.partial(VGG, depth=16)
VGG19 = functools.partial(VGG, depth=19)
