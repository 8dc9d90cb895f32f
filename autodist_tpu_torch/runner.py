"""Distributed runner: owns the lowered step, the state and the feed contract.

Counterpart of ``autodist_tpu/runner.py``'s ``DistributedRunner``.  The
feed contract is the JAX package's: every leaf of a host batch with a
leading batch dimension is split across the replicas (this process
keeps its own contiguous shard), scalars go to every replica whole; a
lowering may cut a leaf along more dims (sequence parallelism splits
the token leaves along dim 1 over ``seq`` too).
Metrics come back as device tensors; nothing in :meth:`step` or
:meth:`run_steps` waits for the device, so the host enqueues a whole
window ahead of the card.  Each step draws its dropout seed from a host
``numpy`` stream seeded at construction, so a runner replays the same
seeds whether it is driven by :meth:`step` or :meth:`run_steps`.

Where the lowering is capturable (:attr:`~autodist_tpu_torch.kernel
.lowering.Lowered.capturable`: the card, and no collective staged
through host memory), one :meth:`run_steps` call is one CUDA-graph
replay, as one call of the JAX package's is one device dispatch of a
``lax.scan``.  The first call for a window's shapes (``k`` and every
leaf's shape and dtype, as ``jax.jit`` specializes) records ``k``
chained steps into a graph (:mod:`autodist_tpu_torch.cuda_graph`) that
reads the state from static buffers, the window from a static ``[k,
...]`` buffer and each step's dropout seed from a
:class:`~autodist_tpu_torch.cuda_graph.GraphSeed`, and ends by copying
the new state into the state buffers.  After a replay ``runner.state``
is those buffers, as JAX donates its state; after a :meth:`step` it
holds new tensors, which the next replay copies in.  Elsewhere (the
CPU, or a gloo group on the card) :meth:`run_steps` is a host loop of
steps.  :attr:`DistributedRunner.captures` and ``replays`` count the
graph route's work.

``eval_step``, ``evaluate`` and ``run`` (with its per-step timing
records) are among ROADMAP Queue 1's slice 2 leftovers, and
``AsyncPSRunner`` belongs to item 8.
"""
from __future__ import annotations

import numpy as np
import torch

from autodist_tpu_torch import cuda_graph
from autodist_tpu_torch.kernel import common


class _Placed(dict):
    """A batch or window already split and on the device."""


def _tensors(tree) -> list:
    """The tensor leaves of a nest of dicts (in sorted-key order), lists
    and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _tensors(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _tensors(item)]
    return []


def _clone(tree):
    """``tree`` with every tensor leaf cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {key: _clone(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(item) for item in tree)
    return tree


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
        # The graph route: one graph per window shape, and the static
        # state they share.
        self._graphs: dict = {}
        self._state_buf = None

    def _next_rng(self) -> int:
        return int(self._seeds.randint(0, 2 ** 31 - 1))

    # ---------------- feed ---------------------------------------------- #
    def _place(self, name, x, cuts, offset: int):
        """One leaf on this rank: cut along each ``(dim, axis)`` of
        ``cuts`` (dims shifted by ``offset``, 1 in a ``[k, ...]``
        window), this rank keeping its contiguous slice; a leaf without
        that dim goes whole.  On the runner's device."""
        t = torch.as_tensor(x)
        for dim, axis in cuts:
            dim += offset
            if t.dim() <= dim or axis.size == 1:
                continue
            size, n = t.shape[dim], axis.size
            if size % n:
                raise ValueError(
                    f"batch leaf {name!r}: dim {dim} of {size} does not "
                    f"divide by the {n}-way {axis.name!r} axis")
            t = t.narrow(dim, axis.index * (size // n), size // n)
        return t.to(self.lowered.device)

    def _place_batch(self, batch, offset: int = 0):
        """The lowering says how each leaf splits
        (:meth:`~autodist_tpu_torch.kernel.lowering.Lowered.placement_of`:
        dim 0 over the data axis, or ``data x expert``; token leaves
        also along dim 1 over ``seq``)."""
        if isinstance(batch, _Placed):
            return batch
        cuts = self.lowered.placement_of(batch)
        return _Placed({key: self._place(key, x, cuts[key], offset)
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
        split as a step's leaf is, each dim shifted by one.  Placing a
        window once and passing it to several ``run_steps`` calls
        transfers nothing again."""
        return self._place_batch(batches, offset=1)

    def run_steps(self, batches, *, rngs=None):
        """``k`` optimizer steps over a ``[k, ...]`` window, with no host
        synchronization between them; returns the metrics stacked
        ``[k]`` (step ``i``'s at index ``i``).  One CUDA-graph replay
        where the lowering is capturable, else a host loop of steps."""
        batches = self.place_steps(batches)
        ks = {int(t.shape[0]) for t in batches.values() if t.dim()}
        if len(ks) != 1 or any(t.dim() == 0 for t in batches.values()):
            raise ValueError(
                "every run_steps leaf needs the same leading steps "
                f"dimension; got shapes "
                f"{[tuple(t.shape) for t in batches.values()]}")
        k = ks.pop()
        rngs = [self._next_rng() for _ in range(k)] if rngs is None else rngs
        if self.lowered.capturable:
            return self._replay(batches, [int(rngs[i]) for i in range(k)])
        out = []
        for i in range(k):
            self.state, metrics = self.lowered.step_fn(
                self.state, {key: t[i] for key, t in batches.items()},
                rngs[i])
            out.append(metrics)
        return {key: torch.stack([m[key] for m in out]) for key in out[0]}

    def _replay(self, window, rngs):
        """The graph route of :meth:`run_steps`: capture at the first
        window of these shapes, then copy the window in, seed, replay."""
        key = tuple((name, tuple(t.shape), t.dtype)
                    for name, t in sorted(window.items()))
        with torch.cuda.device(self.lowered.device):
            if self._state_buf is None:
                self._state_buf = _clone(self.state)
            elif self.state is not self._state_buf:
                torch._foreach_copy_(_tensors(self._state_buf),
                                     _tensors(self.state))
            if key not in self._graphs:
                self._graphs[key] = self._capture(window)
            graph, buf, seeds = self._graphs[key]
            for name, t in window.items():
                buf[name].copy_(t)
            for seed, rng in zip(seeds, rngs):
                seed.set(rng)
            out = graph.replay()
        self.state = self._state_buf
        return {name: t.clone() for name, t in out.items()}

    def _capture(self, window):
        """One graph of ``k`` chained steps over static buffers: the
        state, the window and the ``k`` steps' seeds."""
        step_fn, state_buf = self.lowered.step_fn, self._state_buf
        buf = _Placed({name: t.clone() for name, t in window.items()})
        k = next(iter(buf.values())).shape[0]
        seeds = [cuda_graph.GraphSeed(self.lowered.device) for _ in range(k)]
        dst = _tensors(state_buf)

        def steps():
            state, out = state_buf, []
            for i in range(k):
                state, metrics = step_fn(
                    state, _Placed({n: t[i] for n, t in buf.items()}),
                    seeds[i])
                out.append(metrics)
            src = _tensors(state)
            if [(t.shape, t.dtype) for t in src] != \
                    [(t.shape, t.dtype) for t in dst]:
                raise ValueError("the step changed the state's layout; a "
                                 "captured window needs a fixed one")
            torch._foreach_copy_(dst, src)
            return {name: torch.stack([m[name] for m in out])
                    for name in out[0]}

        graph = cuda_graph.Graph(
            steps, lambda: step_fn(state_buf, _Placed(
                {n: t[0] for n, t in buf.items()}), seeds[0]),
            generators=[s.generator for s in seeds])
        return graph, buf, seeds

    @property
    def captures(self) -> int:
        """Window shapes captured as CUDA graphs (0 on the loop route)."""
        return len(self._graphs)

    @property
    def replays(self) -> int:
        """``run_steps`` calls that replayed a graph."""
        return sum(graph.replays for graph, _, _ in self._graphs.values())

    @property
    def capture_seconds(self) -> float:
        return sum(graph.seconds for graph, _, _ in self._graphs.values())

    # ---------------- fetches ------------------------------------------- #
    @property
    def step_count(self) -> int:
        return int(self.state["step"])

    def get_params(self):
        """The full logical parameter tree (copies).  Where the strategy
        shards variables over the pipe, model or expert axis this
        gathers them, a collective: every rank of that axis calls it."""
        full = self.lowered.full_params(self.state["params"])
        return common.unflatten({nm: p.detach().clone()
                                 for nm, p in full.items()})

    def close(self):
        """Release the state and the captured graphs (safe to call more
        than once)."""
        for graph, _, _ in self._graphs.values():
            graph.close()
        self._graphs = {}
        self._state_buf = None
        self.state = None
        self.lowered = None
