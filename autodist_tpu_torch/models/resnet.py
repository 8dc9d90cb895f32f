"""ResNet v1.5 for ImageNet-style classification, and the trainable of
every image model in the zoo.

Counterpart of ``autodist_tpu/models/resnet.py``: ``ResNetBlock``,
``BottleneckBlock`` and ``ResNet`` (ResNet18/34/50/101/152) under
flax's names (``conv_init``, ``bn_init``, ``ResNetBlock_i/Conv_j``,
``BatchNorm_j``, ``conv_proj``, ``norm_proj``, ``head``), bf16
activations by default, fp32 BatchNorm statistics averaged over the
``"data"`` axis while training (cross-replica BatchNorm; the lowering
binds the axis) and an fp32 head.  A model is a definition
(:mod:`~autodist_tpu_torch.models.layers`); :func:`make_image_trainable`
draws its parameters and carries the ``batch_stats`` as the
trainable's extra state.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from autodist_tpu_torch import cuda_graph
from autodist_tpu_torch.capture import Trainable
from autodist_tpu_torch.kernel.common import unflatten
from autodist_tpu_torch.models.layers import (BatchNorm, Conv, Dense,
                                              NormContext, functional_tensors,
                                              init_params, max_pool,
                                              module_batch_stats,
                                              module_params, new_batch_stats)


class ImageModel(nn.Module):
    """What the image models share: ``forward(x [B, H, W, C], train,
    generator)`` returns ``(logits fp32, new batch_stats)``, the second
    flat by flax's names (empty in eval and for models without
    BatchNorm).  Subclasses define ``body(x NCHW, ctx, generator)``;
    ``axis_name`` is the axis BatchNorm averages over in training."""

    axis_name = None

    def forward(self, x, train: bool = True, generator=None):
        ctx = NormContext(train, self.axis_name if train else None)
        logits = self.body(x.permute(0, 3, 1, 2), ctx, generator)
        return logits.float(), new_batch_stats(self, ctx)


class ResNetBlock(nn.Module):
    def __init__(self, in_features, filters, conv, norm, strides=(1, 1)):
        super().__init__()
        self.Conv_0 = conv(in_features, filters, (3, 3), strides)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3))
        self.BatchNorm_1 = norm(filters, scale_init=0.0)
        if in_features != filters or strides != (1, 1):
            self.conv_proj = conv(in_features, filters, (1, 1), strides)
            self.norm_proj = norm(filters)

    def forward(self, x, ctx):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), ctx))
        y = self.BatchNorm_1(self.Conv_1(y), ctx)
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(x), ctx)
        return torch.relu(residual + y)


class BottleneckBlock(nn.Module):
    def __init__(self, in_features, filters, conv, norm, strides=(1, 1)):
        super().__init__()
        self.Conv_0 = conv(in_features, filters, (1, 1))
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3), strides)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, filters * 4, (1, 1))
        self.BatchNorm_2 = norm(filters * 4, scale_init=0.0)
        if in_features != filters * 4 or strides != (1, 1):
            self.conv_proj = conv(in_features, filters * 4, (1, 1), strides)
            self.norm_proj = norm(filters * 4)

    def forward(self, x, ctx):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), ctx))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y), ctx))
        y = self.BatchNorm_2(self.Conv_2(y), ctx)
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(x), ctx)
        return torch.relu(residual + y)


BLOCK_EXPANSION = {ResNetBlock: 1, BottleneckBlock: 4}


class ResNet(ImageModel):
    """flax ``ResNet`` (a definition; see
    :func:`~autodist_tpu_torch.models.layers.init_params`).  The input
    has ``channels`` channels (3 for ImageNet)."""

    def __init__(self, stage_sizes, block_cls, num_classes: int = 1000,
                 num_filters: int = 64, dtype=torch.bfloat16,
                 axis_name="data", channels: int = 3):
        super().__init__()
        self.axis_name = axis_name
        conv = functools.partial(Conv, use_bias=False, dtype=dtype)
        norm = functools.partial(BatchNorm, dtype=dtype, momentum=0.9,
                                 epsilon=1e-5)
        self.conv_init = conv(channels, num_filters, (7, 7), (2, 2),
                              padding=((3, 3), (3, 3)))
        self.bn_init = norm(num_filters)
        features, index = num_filters, 0
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                filters = num_filters * 2 ** i
                self.add_module(
                    f"{block_cls.__name__}_{index}",
                    block_cls(features, filters, conv, norm, strides))
                features = filters * BLOCK_EXPANSION[block_cls]
                index += 1
        self.num_blocks = index
        self.block_name = block_cls.__name__
        self.head = Dense(features, num_classes, dtype=torch.float32)

    def body(self, x, ctx, generator=None):
        x = torch.relu(self.bn_init(self.conv_init(x), ctx))
        x = max_pool(x, 3, 2, ((1, 1), (1, 1)))
        for i in range(self.num_blocks):
            x = getattr(self, f"{self.block_name}_{i}")(x, ctx)
        return self.head(x.mean((2, 3)))


ResNet18 = functools.partial(ResNet, [2, 2, 2, 2], ResNetBlock)
ResNet34 = functools.partial(ResNet, [3, 4, 6, 3], ResNetBlock)
ResNet50 = functools.partial(ResNet, [3, 4, 6, 3], BottleneckBlock)
ResNet101 = functools.partial(ResNet, [3, 4, 23, 3], BottleneckBlock)
ResNet152 = functools.partial(ResNet, [3, 8, 36, 3], BottleneckBlock)


def classification_loss_head(logits, batch):
    """Mean cross entropy of ``batch["y"]`` under fp32 ``logits`` and
    the argmax accuracy."""
    labels = batch["y"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -torch.gather(logp, -1, labels[:, None])[:, 0].mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": acc}


def make_image_trainable(model, optimizer, generator, *, image_size=224,
                         channels=3, batch_size=8, device=None):
    """A Trainable for any image model of the zoo on batches ``{"x":
    [B, H, W, C] float, "y": [B] int}``, its parameters drawn from
    ``generator`` with flax's default initializers and placed on
    ``device`` (``None``: the card).

    BatchNorm models (ResNet, DenseNet, Inception) carry their running
    statistics as the extra state ``{"batch_stats": ...}``: the train
    loss normalizes with the batch's statistics (averaged over the data
    axis the lowering binds) and returns the updated averages; the eval
    loss normalizes with the averages.  VGG has none (``extra`` is
    ``None``).  ``image_size``, ``channels`` and ``batch_size`` size the
    JAX package's init sample, which the port's definitions do not
    need beyond a check: the definition runs on a ``meta`` sample of
    that shape, as flax's init does on its sample.  Dropout draws from a
    generator seeded with the step's ``rng`` (or a captured window's
    ``GraphSeed``)."""
    sample = torch.empty(batch_size, image_size, image_size, channels,
                         device="meta")
    try:
        model(sample, train=False)
    except RuntimeError as e:
        raise ValueError(f"the model does not take {list(sample.shape)} "
                         f"images: {e}") from e
    model = init_params(model, generator, device)
    params = module_params(model)
    stats = module_batch_stats(model)
    extra = {"batch_stats": stats} if stats else None

    def loss(p, ex, batch, rng):
        gen = cuda_graph.dropout_generator(rng, batch["x"].device)
        logits, new_stats = torch.func.functional_call(
            model, functional_tensors(p, ex), (batch["x"],),
            {"train": True, "generator": gen})
        new_extra = ({"batch_stats": unflatten(new_stats)}
                     if extra is not None else ex)
        l, metrics = classification_loss_head(logits, batch)
        return l, new_extra, dict(metrics, loss=l)

    def eval_loss(p, ex, batch, rng):
        logits, _ = torch.func.functional_call(
            model, functional_tensors(p, ex), (batch["x"],),
            {"train": False})
        l, metrics = classification_loss_head(logits, batch)
        return l, ex, dict(metrics, loss=l)

    return Trainable(loss, params, optimizer, extra=extra,
                     eval_loss=eval_loss)


def make_resnet_trainable(model, optimizer, generator, *, image_size=224,
                          channels=3, batch_size=8, device=None):
    """A Trainable for a ResNet with synced BatchNorm extra state."""
    return make_image_trainable(model, optimizer, generator,
                                image_size=image_size, channels=channels,
                                batch_size=batch_size, device=device)
