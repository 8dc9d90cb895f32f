"""Optimizers with optax's update rules: ``sgd``, ``adam`` and ``adamw``.

The port's counterpart of the optax transforms the training path uses.
The interface is optax's, functional: an optimizer is a
:class:`GradientTransformation` with ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, and
:func:`apply_updates` adds updates to params.  ``params``, ``grads`` and
``updates`` are ``{name: tensor}`` dicts (the lowering's flat view of a
parameter tree); nothing is updated in place.  ``torch.optim`` is not
used: ``AdamW`` there has no ``mu_dtype``, applies its decay before the
moments and defaults to a decay of ``1e-2`` where optax's is ``1e-4``.

The arithmetic follows optax step for step, with each transform run as
``torch._foreach_*`` multi-tensor ops over every variable at once:

* ``scale_by_adam``: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 +
  b2 nu`` (with ``mu`` held in ``mu_dtype``, ``b1 * mu`` is a product in
  that dtype, as JAX's weak-typed scalar makes it), ``count += 1``,
  bias corrections ``1 - b^count`` in fp32, ``mu_hat / (sqrt(nu_hat) +
  eps)`` (optax's ``eps_root = 0``), then ``mu`` cast to ``mu_dtype``;
* ``add_decayed_weights``: ``u + wd * p``;
* ``scale_by_learning_rate``: ``-lr * u``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable
    update: Callable


def apply_updates(params: dict, updates: dict) -> dict:
    """``p + u`` for every variable, in the parameter's dtype."""
    names = list(params)
    new = torch._foreach_add([params[n] for n in names],
                             [updates[n].to(params[n].dtype) for n in names])
    return dict(zip(names, new))


def _scale(updates: list, step_size: float) -> list:
    return torch._foreach_mul(updates, step_size)


def sgd(learning_rate: float) -> GradientTransformation:
    """optax ``sgd`` without momentum: ``updates = -lr * g``."""

    def init(params):
        return {}

    def update(grads, state, params=None):
        names = list(grads)
        return dict(zip(names, _scale([grads[n] for n in names],
                                       -learning_rate))), state

    return GradientTransformation(init, update)


def _adam(learning_rate, b1, b2, eps, mu_dtype, weight_decay):
    """scale_by_adam, then optionally add_decayed_weights, then
    scale_by_learning_rate."""

    def init(params):
        first = next(iter(params.values()))
        return {
            "count": torch.zeros((), dtype=torch.int32, device=first.device),
            "mu": {n: torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()},
        }

    def update(grads, state, params=None):
        names = list(grads)
        g = [grads[n] for n in names]
        mu_prev = [state["mu"][n] for n in names]
        nu_prev = [state["nu"][n] for n in names]
        # b1 * mu in mu's dtype, with b1 rounded to it (JAX's weak-typed
        # scalar takes the array's dtype); added to the fp32 term in fp32.
        b1_mu = float(torch.tensor(b1, dtype=mu_prev[0].dtype))
        decayed = [t.to(gi.dtype) for t, gi in
                   zip(torch._foreach_mul(mu_prev, b1_mu), g)]
        mu = torch._foreach_add(_scale(g, 1 - b1), decayed)
        nu = torch._foreach_add(_scale(torch._foreach_mul(g, g), 1 - b2),
                                _scale(nu_prev, b2))
        count = state["count"]
        count = torch.where(count < _INT32_MAX, count + 1, count)
        bc1 = 1 - b1 ** count.float()
        bc2 = 1 - b2 ** count.float()
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        u = torch._foreach_div(
            mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), eps))
        if weight_decay is not None:
            u = torch._foreach_add(
                u, _scale([params[n] for n in names], weight_decay))
        u = _scale(u, -learning_rate)
        if mu_dtype is not None:
            mu = [m.to(mu_dtype) for m in mu]
        return dict(zip(names, u)), {"count": count,
                                     "mu": dict(zip(names, mu)),
                                     "nu": dict(zip(names, nu))}

    return GradientTransformation(init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, mu_dtype=None) -> GradientTransformation:
    """optax ``adam``: scale_by_adam then scale_by_learning_rate."""
    return _adam(learning_rate, b1, b2, eps, mu_dtype, None)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, mu_dtype=None,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax ``adamw``: scale_by_adam, add_decayed_weights (on every
    variable: optax's ``mask=None``), scale_by_learning_rate."""
    return _adam(learning_rate, b1, b2, eps, mu_dtype, weight_decay)
