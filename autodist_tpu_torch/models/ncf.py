"""NCF / NeuMF recommendation model.

Counterpart of ``autodist_tpu/models/ncf.py``: NeuMF is GMF (the product
of ``mf_user_embedding`` and ``mf_item_embedding`` rows) beside an MLP
tower (``mlp_user_embedding`` and ``mlp_item_embedding`` rows
concatenated, then ``mlp_i`` Dense + ReLU layers), concatenated into one
``prediction`` logit; binary cross entropy.  The four tables are
:class:`~autodist_tpu_torch.models.embedding.SparseEmbed`, declared
sparse, so a vocab-sharding strategy moves touched rows only.  fp32, as
the JAX model computes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.capture import Trainable
from autodist_tpu_torch.models.embedding import SparseEmbed
from autodist_tpu_torch.models.layers import (Dense, functional_tensors,
                                              init_params, module_params)

TABLES = ("mf_user_embedding", "mf_item_embedding", "mlp_user_embedding",
          "mlp_item_embedding")


class NeuMF(nn.Module):
    """flax ``NeuMF`` (a definition): ``forward(users, items)`` gives a
    logit a pair."""

    def __init__(self, num_users: int = 138_000, num_items: int = 27_000,
                 mf_dim: int = 64, mlp_dims=(256, 128, 64)):
        super().__init__()
        half = mlp_dims[0] // 2
        self.mf_user_embedding = SparseEmbed(num_users, mf_dim)
        self.mf_item_embedding = SparseEmbed(num_items, mf_dim)
        self.mlp_user_embedding = SparseEmbed(num_users, half)
        self.mlp_item_embedding = SparseEmbed(num_items, half)
        self.depth = len(mlp_dims) - 1
        for i in range(self.depth):
            self.add_module(f"mlp_{i}", Dense(2 * half if i == 0
                                              else mlp_dims[i], mlp_dims[i + 1]))
        self.prediction = Dense(mf_dim + mlp_dims[-1], 1)

    def forward(self, users, items):
        gmf = self.mf_user_embedding(users) * self.mf_item_embedding(items)
        mlp = torch.cat([self.mlp_user_embedding(users),
                         self.mlp_item_embedding(items)], dim=-1)
        for i in range(self.depth):
            mlp = torch.relu(getattr(self, f"mlp_{i}")(mlp))
        return self.prediction(torch.cat([gmf, mlp], dim=-1))[..., 0]


def optax_sigmoid_ce(logits, labels):
    """optax's ``sigmoid_binary_cross_entropy``, element by element."""
    return -labels * F.logsigmoid(logits) \
        - (1.0 - labels) * F.logsigmoid(-logits)


def make_ncf_trainable(optimizer, generator, *, num_users=1000,
                       num_items=500, mf_dim=8, mlp_dims=(32, 16, 8),
                       device=None):
    """A Trainable for :class:`NeuMF` on ``{"users": [B], "items": [B],
    "labels": [B] 0/1}``, its parameters drawn from ``generator`` and
    placed on ``device`` (``None``: the card); the four tables are its
    sparse parameters."""
    model = init_params(NeuMF(num_users, num_items, mf_dim, tuple(mlp_dims)),
                        generator, device)

    def loss(p, extra, batch, rng):
        logits = torch.func.functional_call(
            model, functional_tensors(p), (batch["users"], batch["items"]))
        labels = batch["labels"].float()
        l = optax_sigmoid_ce(logits, labels).mean()
        acc = ((logits > 0) == (labels > 0.5)).float().mean()
        return l, extra, {"loss": l, "accuracy": acc}

    return Trainable(loss, module_params(model), optimizer,
                     sparse_params=tuple(f"{t}/embedding" for t in TABLES))
