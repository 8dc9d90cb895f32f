"""CUDA-graph capture: one host call replays a whole window on the card.

The JAX package compiles a window into one program: ``run_steps`` is
one ``jax.jit`` of a ``lax.scan`` over the step, and the serving engine
decodes ``decode_steps`` tokens a host dispatch.  The port records the
same window once into a ``torch.cuda.CUDAGraph`` and replays it, so the
host launches one graph where it launched every kernel of every step.
:class:`~autodist_tpu_torch.runner.DistributedRunner` (``run_steps``)
and :class:`~autodist_tpu_torch.serving.engine.ServingEngine`
(``decode``) share this module:

* :class:`Graph` runs a warm-up on a side stream (PyTorch's lazy
  initializations, cuBLAS's workspaces and the kernels' one-time host
  calls must not happen under capture), then records the callable; the
  tensors it returns are the graph's static outputs, overwritten by
  every replay.  Inputs are the caller's static buffers: a graph keeps
  the addresses it recorded, and so do the TMA tensor maps that the
  Hopper kernels encode on the host at launch.
* Kernel wrappers count their launches in host integers
  (:func:`counted`).  A launch recorded into a graph runs at every
  replay and not when its wrapper ran, so :class:`Graph` takes the
  capture's movement of every counter back and adds it at each replay:
  a counter stays equal to the launches the device ran.
* :class:`GraphSeed` carries a step's dropout seed into a graph: a CUDA
  generator registered with the graph and seeded on the host before
  each replay, which draws the Philox stream that a fresh generator
  seeded alike draws in an eager step.

A capture that fails raises; nothing here falls back to eager launches.
"""
from __future__ import annotations

import time

import torch

# (owner, attribute) of every registered launch counter.
_COUNTERS: list = []


def counted(fn, *names):
    """Give the kernel wrapper ``fn`` the integer counters ``names``,
    each 0, and register them so that a graph's replays add to them."""
    for name in names:
        setattr(fn, name, 0)
        _COUNTERS.append((fn, name))


def _counts() -> dict:
    return {(owner, name): getattr(owner, name) for owner, name in _COUNTERS}


def _restore(counts: dict) -> None:
    for (owner, name), value in counts.items():
        setattr(owner, name, value)


class GraphSeed:
    """A dropout seed that a captured graph re-reads at every replay.

    A lowering folds a step's seed with the replica's index
    (:meth:`fold`, as it folds an integer seed); a model draws from
    :attr:`generator` (:func:`dropout_generator`).  :meth:`set` seeds
    the generator with the folded value before a replay."""

    def __init__(self, device):
        self.generator = torch.Generator(device=device)
        self._fold = (1, 0)

    def fold(self, n: int, index: int) -> "GraphSeed":
        self._fold = (int(n), int(index))
        return self

    def set(self, seed: int) -> None:
        n, index = self._fold
        self.generator.manual_seed(int(seed) * n + index)


def fold_seed(rng, n: int, index: int):
    """A step seed for replica ``index`` of ``n``: ``rng * n + index``
    for an integer, the folded :class:`GraphSeed` for one; ``None``
    stays ``None``."""
    if rng is None:
        return None
    if isinstance(rng, GraphSeed):
        return rng.fold(n, index)
    return int(rng) * n + index


def dropout_generator(rng, device):
    """The generator a step's dropout draws from: a fresh one seeded
    with an integer ``rng``, a :class:`GraphSeed`'s own, ``None`` for
    ``None``."""
    if rng is None:
        return None
    if isinstance(rng, GraphSeed):
        return rng.generator
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng))
    return gen


class Graph:
    """``fn`` recorded into one CUDA graph on the current device.

    ``warmup()`` runs first, eagerly, on a side stream; its launches
    leave the counters unless ``keep_warmup_counts`` (where the warm-up
    is the caller's own work, not a throw-away).  ``generators`` are
    registered with the graph before capture.  :attr:`seconds` is the
    time of the warm-up, the capture and the instantiation."""

    def __init__(self, fn, warmup, *, keep_warmup_counts: bool = False,
                 generators=()):
        t0 = time.perf_counter()
        before = _counts()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warmup()
        torch.cuda.current_stream().wait_stream(side)
        if not keep_warmup_counts:
            _restore(before)
        base = _counts()
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        try:
            with torch.cuda.graph(self.graph):
                self.out = fn()
            moved = _counts()
        finally:
            _restore(base)
        self._deltas = {key: value - base.get(key, 0)
                        for key, value in moved.items()
                        if value != base.get(key, 0)}
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - t0
        self.replays = 0

    def replay(self):
        """Run the graph once; returns its static outputs."""
        self.graph.replay()
        for (owner, name), delta in self._deltas.items():
            setattr(owner, name, getattr(owner, name) + delta)
        self.replays += 1
        return self.out

    def close(self) -> None:
        """Free the graph and its memory pool's outputs (safe to call
        more than once)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.out = None
