"""Distributed runner: owns the lowered step, the state and the feed contract.

Counterpart of ``autodist_tpu/runner.py``'s ``DistributedRunner``.  The
feed contract is the JAX package's: every leaf of a host batch with a
leading batch dimension is split across the replicas (this process
keeps its own contiguous shard), scalars go to every replica whole.
Metrics come back as device tensors; nothing in :meth:`step` or
:meth:`run_steps` waits for the device, so the host enqueues a whole
window ahead of the card.  Each step draws its dropout seed from a host
``numpy`` stream seeded at construction, so a runner replays the same
seeds whether it is driven by :meth:`step` or :meth:`run_steps`.

``run_steps`` is a plain loop of ``step``s on the card; capturing the
window as a CUDA graph is later work.  ``eval_step``, ``evaluate`` and
``run`` (with its per-step timing records) are among ROADMAP Queue 1's
slice 2 leftovers, and ``AsyncPSRunner`` belongs to item 8.
"""
from __future__ import annotations

import numpy as np
import torch

from autodist_tpu_torch.kernel import common


class _Placed(dict):
    """A batch or window already split and on the device."""


def stack_steps(batches):
    """Stack per-step batch dicts into the ``[k, ...]`` window
    :meth:`DistributedRunner.run_steps` consumes."""
    return {key: np.stack([np.asarray(b[key]) for b in batches])
            for key in batches[0]}


class DistributedRunner:
    """Owns (mesh, lowered step, state); the training session."""

    def __init__(self, trainable, lowered, *, seed: int = 0):
        self.trainable = trainable
        self.lowered = lowered
        self.mesh = lowered.mesh
        self.strategy = None       # set by AutoDist.build
        self.state = lowered.init_state(trainable)
        self._seeds = np.random.RandomState(seed)

    def _next_rng(self) -> int:
        return int(self._seeds.randint(0, 2 ** 31 - 1))

    # ---------------- feed ---------------------------------------------- #
    def _place(self, x, batch_axis: int):
        """One leaf on this replica: its shard along ``batch_axis`` (a
        leaf without that axis goes whole), on the runner's device.  The
        lowering says which mesh axes shard the batch (the data axis,
        or ``data x expert`` for ``ExpertParallel``)."""
        t = torch.as_tensor(x)
        n, rank = self.lowered.batch_axis.size, self.lowered.batch_axis.index
        if t.dim() > batch_axis and n > 1:
            size = t.shape[batch_axis]
            if size % n:
                raise ValueError(f"batch dimension {size} is not divisible "
                                 f"by the {n} replicas")
            t = t.narrow(batch_axis, rank * (size // n), size // n)
        return t.to(self.lowered.device)

    def _place_batch(self, batch, batch_axis: int = 0):
        if isinstance(batch, _Placed):
            return batch
        return _Placed({key: self._place(x, batch_axis)
                        for key, x in batch.items()})

    # ---------------- the hot loop -------------------------------------- #
    def step(self, batch, *, rng=None):
        """One optimizer step; returns the metrics dict."""
        batch = self._place_batch(batch)
        rng = self._next_rng() if rng is None else rng
        self.state, metrics = self.lowered.step_fn(self.state, batch, rng)
        return metrics

    def place_steps(self, batches):
        """A ``run_steps`` window on the device: every leaf ``[k, ...]``
        split across replicas along its batch axis (axis 1).  Placing a
        window once and passing it to several ``run_steps`` calls
        transfers nothing again."""
        return self._place_batch(batches, batch_axis=1)

    def run_steps(self, batches, *, rngs=None):
        """``k`` optimizer steps over a ``[k, ...]`` window, with no host
        synchronization between them; returns the metrics stacked
        ``[k]`` (step ``i``'s at index ``i``)."""
        batches = self.place_steps(batches)
        ks = {int(t.shape[0]) for t in batches.values() if t.dim()}
        if len(ks) != 1 or any(t.dim() == 0 for t in batches.values()):
            raise ValueError(
                "every run_steps leaf needs the same leading steps "
                f"dimension; got shapes "
                f"{[tuple(t.shape) for t in batches.values()]}")
        k = ks.pop()
        rngs = [self._next_rng() for _ in range(k)] if rngs is None else rngs
        out = []
        for i in range(k):
            self.state, metrics = self.lowered.step_fn(
                self.state, {key: t[i] for key, t in batches.items()},
                rngs[i])
            out.append(metrics)
        return {key: torch.stack([m[key] for m in out]) for key in out[0]}

    # ---------------- fetches ------------------------------------------- #
    @property
    def step_count(self) -> int:
        return int(self.state["step"])

    def get_params(self):
        """The full logical parameter tree (copies).  Where the strategy
        shards variables over the model or the expert axis this gathers
        them, a collective: every rank of that axis calls it."""
        full = self.lowered.full_params(self.state["params"])
        return common.unflatten({nm: p.detach().clone()
                                 for nm, p in full.items()})

    def close(self):
        """Release the state (safe to call more than once)."""
        self.state = None
        self.lowered = None
