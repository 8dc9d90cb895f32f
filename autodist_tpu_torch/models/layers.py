"""flax's convolutional-network layers: ``Conv``, ``Dense``, ``BatchNorm``
and the pools, for the image and recommendation models.

The JAX package's image models are flax modules defined apart from
their parameters (``ResNet50(num_classes=1000)``, then ``model.init(rng,
sample)``).  The port keeps that split: a model is built as a definition
whose parameters live on the ``meta`` device (shapes only), and
:func:`init_params` draws every parameter with flax's default
initializer from a ``torch.Generator`` and places the module on a
device.  Parameter names, nesting and layouts are flax's, so a JAX tree
converts leaf for leaf (:mod:`autodist_tpu_torch.interop`):

* ``Conv`` has kernel ``[kh, kw, in, out]`` (and bias ``[out]`` where
  flax's has one); the forward transposes it to torch's ``[out, in, kh,
  kw]``;
* ``Dense`` has kernel ``[in, out]``;
* ``BatchNorm`` has params ``scale``/``bias`` and the ``batch_stats``
  leaves ``mean``/``var``, held as the module's buffers.

Activations are NCHW tensors.  A batch arrives as flax's ``[B, H, W,
C]``, and ``x.permute(0, 3, 1, 2)`` is its NCHW view at no cost, laid out
channels-last in memory, which is the layout cuDNN's bf16 tensor-core
convolutions want; where flax flattens a feature map, the model permutes
back to NHWC first, so that a ``Dense`` reads the features in flax's
order.

Padding follows ``lax.padtype_to_pads``: ``"SAME"`` pads ``max((out - 1)
s + k - in, 0)`` in all, the odd pixel after (``F.pad`` where the two
sides differ, as a 3x3 stride-2 conv on an even input has them),
``"VALID"`` pads nothing, and explicit ``((lo, hi), (lo, hi))`` pads as
given.

:class:`BatchNorm` follows flax 0.12's ``_compute_stats`` and
``_normalize``: statistics in fp32 (or wider) ``mean`` and ``var = max(0,
E[x^2] - E[x]^2)``, the two averaged over the named axis in one differentiable
mean (:func:`~autodist_tpu_torch.parallel.axis.pmean`) when the model
trains with an ``axis_name``, the normalization ``(x - mean) *
(rsqrt(var + eps) * scale) + bias`` in fp32 cast to the module's dtype,
and the running statistics ``m ra + (1 - m) batch`` with the *biased*
variance (``torch.nn.BatchNorm2d`` keeps the unbiased one and reverses
the momentum).  In eval it normalizes with the running statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.models.transformer import lecun_normal
from autodist_tpu_torch.parallel.axis import bound_axis, pmean


def _meta(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device="meta"))


def init_params(model: nn.Module, generator, device=None) -> nn.Module:
    """Draw every parameter of ``model`` (a definition on ``meta``) with
    flax's default initializers from ``generator`` (on its device), and
    place the module on ``device`` (``None``: the card).  Returns the
    module."""
    dev = resolve_device(device)
    for module in model.modules():
        reset = getattr(module, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return model.to(dev)


def module_params(model: nn.Module) -> dict:
    """A module's parameters as flax's nested tree."""
    return unflatten({name.replace(".", "/"): p.detach()
                      for name, p in model.named_parameters()})


def module_batch_stats(model: nn.Module) -> dict:
    """A module's BatchNorm running statistics as flax's nested
    ``batch_stats`` tree (empty without BatchNorm)."""
    return unflatten({name.replace(".", "/"): b.detach()
                      for name, b in model.named_buffers()})


def functional_tensors(params, extra=None) -> dict:
    """``{module attribute path: tensor}`` of a params tree and, where
    given, the ``batch_stats`` of ``extra``, for
    ``torch.func.functional_call``."""
    flat = {name.replace("/", "."): p
            for name, p in flatten_with_names(params)}
    if extra:
        flat.update({name.replace("/", "."): b for name, b in
                     flatten_with_names(extra["batch_stats"])})
    return flat


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """``lax.padtype_to_pads`` for ``"SAME"`` along one dim: (before,
    after), the odd pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel ``[in, out]`` (lecun-normal), zero bias;
    inputs, kernel and bias cast to ``dtype`` before the product."""

    def __init__(self, in_features: int, features: int,
                 dtype=torch.float32, use_bias: bool = True):
        super().__init__()
        self.dtype, self.use_bias = dtype, use_bias
        self.kernel = _meta(in_features, features)
        self.bias = _meta(features) if use_bias else None

    def reset_parameters(self, generator):
        n_in, n_out = self.kernel.shape
        self.kernel = nn.Parameter(lecun_normal((n_in, n_out), n_in,
                                                generator))
        if self.use_bias:
            self.bias = nn.Parameter(torch.zeros(n_out,
                                                 device=generator.device))

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y + self.bias.to(self.dtype) if self.use_bias else y


class Conv(nn.Module):
    """flax ``nn.Conv`` on an NCHW tensor: kernel ``[kh, kw, in, out]``
    (lecun-normal over ``kh kw in``), optional zero bias, ``padding``
    ``"SAME"`` (flax's default), ``"VALID"`` or ``((lo, hi), (lo,
    hi))``; inputs, kernel and bias cast to ``dtype``."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=(1, 1), padding="SAME", use_bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.padding, self.use_bias, self.dtype = padding, use_bias, dtype
        self.kernel = _meta(*self.kernel_size, in_features, features)
        self.bias = _meta(features) if use_bias else None

    def reset_parameters(self, generator):
        kh, kw, n_in, n_out = self.kernel.shape
        self.kernel = nn.Parameter(lecun_normal((kh, kw, n_in, n_out),
                                                kh * kw * n_in, generator))
        if self.use_bias:
            self.bias = nn.Parameter(torch.zeros(n_out,
                                                 device=generator.device))

    def pads(self, spatial) -> tuple:
        """((top, bottom), (left, right)) for an input of ``spatial``
        (H, W)."""
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        if self.padding == "SAME":
            return tuple(same_pads(n, k, s) for n, k, s in
                         zip(spatial, self.kernel_size, self.strides))
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x):
        (top, bottom), (left, right) = self.pads(x.shape[2:])
        x = x.to(self.dtype)
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)
        b = self.bias.to(self.dtype) if self.use_bias else None
        if top == bottom and left == right:
            return F.conv2d(x, w, b, self.strides, (top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b,
                        self.strides)


@dataclasses.dataclass
class NormContext:
    """What a forward tells its BatchNorms: ``train`` (batch statistics
    and a running-average update, or the running averages),
    ``axis_name`` (the mesh axis the statistics are averaged over;
    ``None``: this replica's batch alone) and ``updates``, where each
    BatchNorm leaves its new ``(mean, var)`` keyed by the module."""

    train: bool
    axis_name: Optional[str] = None
    updates: dict = dataclasses.field(default_factory=dict)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel dim of an NCHW tensor (see
    the module docstring).  ``scale_init`` is 1, or 0 for a residual
    branch's last norm."""

    def __init__(self, features: int, dtype=torch.float32, *,
                 momentum: float = 0.9, epsilon: float = 1e-5,
                 scale_init: float = 1.0):
        super().__init__()
        self.dtype, self.momentum, self.epsilon = dtype, momentum, epsilon
        self.scale_init = scale_init
        self.scale = _meta(features)
        self.bias = _meta(features)
        self.register_buffer("mean", torch.empty(features, device="meta"))
        self.register_buffer("var", torch.empty(features, device="meta"))

    def reset_parameters(self, generator):
        n, dev = self.scale.shape[0], generator.device
        self.scale = nn.Parameter(torch.full((n,), self.scale_init,
                                             device=dev))
        self.bias = nn.Parameter(torch.zeros(n, device=dev))
        self.mean = torch.zeros(n, device=dev)
        self.var = torch.ones(n, device=dev)

    def forward(self, x, ctx: NormContext):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if ctx.train:
            dims = (0, 2, 3)
            stats = torch.stack([xf.mean(dims), xf.square().mean(dims)])
            if ctx.axis_name is not None:
                stats = pmean(stats, bound_axis(ctx.axis_name))
            mean, mean2 = stats.unbind(0)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            m = self.momentum
            ctx.updates[self] = (m * self.mean + (1 - m) * mean.detach(),
                                 m * self.var + (1 - m) * var.detach())
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


def new_batch_stats(model: nn.Module, ctx: NormContext) -> dict:
    """The ``batch_stats`` a train forward left in ``ctx``, flat by
    flax's ``/``-joined names (``.../mean``, ``.../var``)."""
    out = {}
    for name, module in model.named_modules():
        if module in ctx.updates:
            mean, var = ctx.updates[module]
            path = name.replace(".", "/")
            out[f"{path}/mean"], out[f"{path}/var"] = mean, var
    return out


def max_pool(x, window, strides, padding=((0, 0), (0, 0))):
    """flax ``nn.max_pool`` (``"VALID"`` by default; symmetric explicit
    pads, which take ``-inf``)."""
    (top, bottom), (left, right) = padding
    if top != bottom or left != right:
        raise ValueError(f"max_pool pads each side alike; got {padding}")
    return F.max_pool2d(x, window, strides, (top, left))


def avg_pool(x, window, strides, padding="VALID"):
    """flax ``nn.avg_pool`` with its default ``count_include_pad=True``:
    ``"VALID"``, or ``"SAME"`` at stride 1 and an odd window, whose
    border windows divide by the whole window as torch's
    ``count_include_pad=True`` does."""
    pad = (0, 0) if padding == "VALID" else tuple(k // 2 for k in window)
    return F.avg_pool2d(x, window, strides, pad, count_include_pad=True)


def flatten_nhwc(x):
    """An NCHW feature map flattened in flax's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
