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

:meth:`~DistributedRunner.eval_step` runs the lowering's eval program
(the eval loss on the full parameters, no update, the metrics reduced
across replicas) and :meth:`~DistributedRunner.evaluate` averages it
over batches.  :meth:`~DistributedRunner.run` drives steps from an
iterable and waits for each step's metrics, so its per-step wall times
(:meth:`~DistributedRunner.summary`, and one telemetry record a step)
are the card's latency, at the price of host/device overlap;
:meth:`step` and :meth:`run_steps` never wait.  :attr:`step_count` reads
the device's step counter (a sync on the card), which is why
:func:`~autodist_tpu_torch.train.fit` keeps a host mirror of the step.

A strategy whose PS carries ``staleness > 0`` (``Lowered.ssp_staleness``)
gives the runner a stale-synchronous gate
(:class:`~autodist_tpu_torch.runtime.coordination.SSPController`) when a
coordination service is configured (``AUTODIST_TPU_COORD_SERVICE``):
:meth:`~DistributedRunner.step` waits until no worker of the job is more
than ``staleness`` steps behind, runs the step, waits for its work on
the card and reports it done; :meth:`~DistributedRunner.run_steps` is
then a host loop of ``step`` calls (a captured window would void the
bound).  With no service configured the runner warns and runs in
lockstep, as the JAX package's does.

:class:`AsyncPSRunner` is asynchronous PS training (``PS(sync=False)``):
each worker process pushes its local gradient to a parameter server over
the coordination service and goes on without waiting.
"""
from __future__ import annotations

import contextlib
import io
import logging
import math
import os
import struct
import threading
import time
from typing import Iterable, Optional

import numpy as np
import torch

from autodist_tpu_torch import const, cuda_graph, optim, telemetry
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel import common
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten

_DRIFT_ITEM = "ROADMAP Queue 1, item 11: telemetry and program lint"
_log = logging.getLogger(__name__)


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


def cut_leaf(name, x, cuts, offset: int = 0):
    """This rank's part of one batch leaf (a view where it can be): cut
    along each ``(dim, axis)`` of ``cuts`` (dims shifted by ``offset``,
    1 in a ``[k, ...]`` window), this rank keeping its contiguous slice;
    a leaf without that dim goes whole."""
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
    return t


def batch_size(batch) -> int:
    """The leading dim of a batch's first leaf that has one (0 if
    none)."""
    for leaf in _leaves(batch):
        if np.ndim(leaf) > 0:
            return int(np.shape(leaf)[0])
    return 0


def _leaves(tree) -> list:
    """The leaves of a nest of dicts (in sorted-key order), lists and
    tuples."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


class DistributedRunner:
    """Owns (mesh, lowered step, state); the training session."""

    def __init__(self, trainable, lowered, *, seed: int = 0,
                 ssp_worker: Optional[str] = None,
                 ssp_num_workers: Optional[int] = None):
        self.trainable = trainable
        self.lowered = lowered
        self.mesh = lowered.mesh
        self.strategy = None       # set by AutoDist.build
        self.state = lowered.init_state(trainable)
        self._seeds = np.random.RandomState(seed)
        self._host_step = 0
        # The graph route: one graph per window shape, and the static
        # state they share.
        self._graphs: dict = {}
        self._state_buf = None
        # run()'s timing sample and totals.
        self._step_times: list = []
        self._run_examples = 0
        self._run_steps_seen = 0
        self._run_seconds = 0.0
        self._ssp = self._make_ssp_gate(ssp_worker, ssp_num_workers)

    def _make_ssp_gate(self, worker: Optional[str],
                       num_workers: Optional[int]):
        """The host-side stale-synchronous gate (the reference's
        depth-``staleness`` token queues, ``ps_synchronizer.py:387-458``):
        active when the strategy carries ``staleness > 0`` and a
        coordination service is reachable.  Inside one process group the
        step is lockstep anyway; the gate bounds the skew between
        processes of the job."""
        staleness = self.lowered.ssp_staleness
        if staleness <= 0:
            return None
        from autodist_tpu_torch.runtime import coordination

        client = coordination.service_client()
        if client is None:
            _log.warning(
                "strategy requests staleness=%d but no coordination service "
                "is configured (AUTODIST_TPU_COORD_SERVICE); running in "
                "lockstep", staleness)
            return None
        return _ssp_gate(client, staleness, worker, num_workers)

    def _next_rng(self) -> int:
        return int(self._seeds.randint(0, 2 ** 31 - 1))

    # ---------------- feed ---------------------------------------------- #
    def _place(self, name, x, cuts, offset: int):
        """One leaf on this rank (:func:`cut_leaf`), on the runner's
        device."""
        return cut_leaf(name, x, cuts, offset).to(self.lowered.device)

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
        """One optimizer step; returns the metrics dict.  Under an SSP
        gate it waits at the gate first, and for the step's work on the
        card before it reports the step done."""
        _ssp_start(self._ssp, self._host_step)
        batch = self._place_batch(batch)
        rng = self._next_rng() if rng is None else rng
        self.state, metrics = self.lowered.step_fn(self.state, batch, rng)
        if self._ssp is not None:
            self._wait()
            self._ssp.finish_step(self._host_step)
        self._host_step += 1
        telemetry.counter("runner/steps").inc()
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
        where the lowering is capturable, else a host loop of steps.
        Under an active SSP gate, a host loop of :meth:`step` calls (the
        gate's bound is per step; a fused window would void it), each at
        its seed of ``rngs``."""
        batches = self.place_steps(batches)
        ks = {int(t.shape[0]) for t in batches.values() if t.dim()}
        if len(ks) != 1 or any(t.dim() == 0 for t in batches.values()):
            raise ValueError(
                "every run_steps leaf needs the same leading steps "
                f"dimension; got shapes "
                f"{[tuple(t.shape) for t in batches.values()]}")
        k = ks.pop()
        if self._ssp is not None:
            out = [self.step(_Placed({key: t[i] for key, t in
                                      batches.items()}),
                             rng=None if rngs is None else rngs[i])
                   for i in range(k)]
            return {key: torch.stack([m[key] for m in out])
                    for key in out[0]}
        rngs = [self._next_rng() for _ in range(k)] if rngs is None else rngs
        telemetry.counter("runner/steps").inc(k)
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

    # ---------------- the measured loop and eval ------------------------ #
    # The retained per-step times are capped (summary percentiles come
    # from this sample; the count keeps climbing), so a long run cannot
    # grow the host with timing data.
    MAX_STEP_TIMES = 100000

    def _wait(self):
        """Wait for the work queued so far on the runner's device."""
        if self.lowered.device.type == "cuda":
            torch.cuda.current_stream(self.lowered.device).synchronize()

    def run(self, data: Iterable, num_steps: Optional[int] = None,
            log_every: int = 0, drift_monitor=None):
        """Drive ``num_steps`` steps (all, by default) from an iterable
        of host batches; returns the last step's metrics.  Each step
        waits for its own metrics; its wall time goes to
        :meth:`summary` and to a telemetry step record.  Throughput
        loops use :meth:`run_steps` / ``fit(steps_per_loop=k)``, which
        never wait."""
        if drift_monitor is not None:
            raise NotImplementedError(
                f"run(drift_monitor=) is not ported yet ({_DRIFT_ITEM})")
        metrics = {}
        it = iter(data)
        i = 0
        while num_steps is None or i < num_steps:
            try:
                batch = next(it)
            except StopIteration:
                break
            t0 = time.perf_counter()
            metrics = self.step(batch)
            self._wait()
            dt = time.perf_counter() - t0
            if len(self._step_times) < self.MAX_STEP_TIMES:
                self._step_times.append(dt)
            self._run_steps_seen += 1
            self._run_seconds += dt
            bsz = batch_size(batch)
            self._run_examples += bsz
            telemetry.record_step(step=self._run_steps_seen - 1,
                                  duration_s=dt, examples=bsz or None)
            if log_every and (i + 1) % log_every == 0:
                _log.info("step %d %s (%.1f ms/step)", self.step_count,
                          {k: float(v) for k, v in metrics.items()},
                          dt * 1e3)
            i += 1
        return metrics

    def summary(self) -> dict:
        """Step-time percentiles over every :meth:`run` step so far (from
        the retained sample, capped at :attr:`MAX_STEP_TIMES`); ``steps``
        and the rate cover every step."""
        ts = np.asarray(self._step_times)
        n = len(ts)
        out = {
            "steps": self._run_steps_seen,
            "mean_ms": (self._run_seconds / self._run_steps_seen * 1e3
                        if self._run_steps_seen else None),
            "p50_ms": float(np.percentile(ts, 50) * 1e3) if n else None,
            "p99_ms": float(np.percentile(ts, 99) * 1e3) if n else None,
            "examples_per_sec": (self._run_examples / self._run_seconds
                                 if self._run_seconds > 0
                                 and self._run_examples else None),
        }
        if out["examples_per_sec"] is not None:
            telemetry.gauge("runner/examples_per_sec").set(
                out["examples_per_sec"])
        return out

    def eval_step(self, batch, *, rng=None):
        """Metrics without updating the state (the lowering's eval
        program); ``rng`` defaults to 0, as the JAX runner's to
        ``PRNGKey(0)``."""
        if self.lowered.eval_fn is None:
            raise NotImplementedError("this lowering has no eval path")
        batch = self._place_batch(batch)
        return self.lowered.eval_fn(self.state, batch,
                                    0 if rng is None else rng)

    def evaluate(self, data: Iterable, num_batches: Optional[int] = None):
        """Mean metrics over an eval dataset (host float64 arrays)."""
        sums, count = {}, 0
        for i, batch in enumerate(data):
            if num_batches is not None and i >= num_batches:
                break
            for k, v in self.eval_step(batch).items():
                v = torch.as_tensor(v).detach().to(torch.float64).cpu()
                sums[k] = sums.get(k, 0.0) + v.numpy()
            count += 1
        return {k: v / max(count, 1) for k, v in sums.items()}

    # ---------------- fetches ------------------------------------------- #
    @property
    def step_count(self) -> int:
        """The step counter of the state (a host read: on the card it
        waits for the queued steps)."""
        return int(self.state["step"])

    def get_params(self):
        """The full logical parameter tree (copies).  Where the strategy
        shards variables over the pipe, model or expert axis this
        gathers them, a collective: every rank of that axis calls it."""
        full = self.lowered.full_params(self.state["params"])
        return common.unflatten({nm: p.detach().clone()
                                 for nm, p in full.items()})

    def get_extra(self):
        return _clone(self.state["extra"])

    def close(self):
        """Release the state, the captured graphs and what the lowering
        holds (safe to call more than once)."""
        for graph, _, _ in self._graphs.values():
            graph.close()
        self._graphs = {}
        self._state_buf = None
        self.state = None
        if self.lowered is not None and self.lowered.release is not None:
            self.lowered.release()
        self.lowered = None


def _ssp_gate(client, staleness: int, worker: Optional[str],
              num_workers: Optional[int]):
    """One worker's SSP gate on ``client``: named ``worker``, else
    ``AUTODIST_TPU_WORKER``, else ``"chief"``; registering
    ``num_workers``, else ``AUTODIST_TPU_NUM_PROCESSES`` when above 1,
    else none."""
    from autodist_tpu_torch.runtime import coordination

    if num_workers is None:
        n = const.ENV.AUTODIST_TPU_NUM_PROCESSES.val
        num_workers = n if n > 1 else None
    return coordination.SSPController(
        client, worker or const.ENV.AUTODIST_TPU_WORKER.val or "chief",
        staleness, num_workers=num_workers)


def _ssp_start(ssp, step: int) -> None:
    """Wait at ``ssp`` (if any) before ``step``.  A timed-out bounded
    wait means a peer stalled or died; running on past it would void
    the staleness bound."""
    if ssp is not None and not ssp.start_step(step):
        raise TimeoutError(
            f"SSP wait at step {step} timed out: a worker is more than "
            f"staleness={ssp.staleness} steps behind")


# --------------------------------------------------------------------------- #
# Asynchronous PS (PS(sync=False))
# --------------------------------------------------------------------------- #
def _host_array(t: torch.Tensor) -> np.ndarray:
    """A leaf on the host as numpy (a bf16 leaf as its int16 bits: numpy
    has no bfloat16).  On the card the copy waits for the tensor's
    stream."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _pack_tree(version: int, tree) -> bytes:
    """The blob of the JAX package's ``_pack_tree``: ``version`` as a
    little-endian int64, then an ``np.savez`` of the leaves ``l0`` ...
    ``ln`` in the nested tree's sorted-key order (``tree`` a nested dict
    or a flat ``{name: tensor}`` one)."""
    leaves = [_host_array(t) for _, t in flatten_with_names(unflatten(tree))]
    buf = io.BytesIO()
    buf.write(struct.pack("<q", version))
    np.savez(buf, **{f"l{i}": a for i, a in enumerate(leaves)})
    return buf.getvalue()


def _unpack_tree(data: bytes, like, device):
    """``(version, tree)`` of a :func:`_pack_tree` blob: the leaves at
    ``like``'s structure and dtypes, on ``device``."""
    version = struct.unpack("<q", data[:8])[0]
    named = flatten_with_names(unflatten(like))
    buf = io.BytesIO(data)
    buf.seek(8)
    out = {}
    with np.load(buf) as z:
        for i, (name, ref) in enumerate(named):
            t = torch.from_numpy(z[f"l{i}"])
            if ref.dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            out[name] = t.to(device)
    return version, unflatten(out)


class AsyncPSRunner:
    """Asynchronous parameter-server training, ``PS(sync=False)``
    (reference ``synchronizers.proto:31``, ``ps_synchronizer.py:216-230``:
    workers push gradients and go on without waiting for each other);
    the port of the JAX package's ``AsyncPSRunner``.

    One synchronous program cannot express this, so the data plane goes
    through the host: each worker process computes the gradient of its
    whole local batch on its one device, then pushes it to a host-side
    PS loop over the coordination service (the gradient queue: the
    reference's conditional accumulators in their accumulate-1 async
    configuration; the parameters' KV entry: the workers' read ops).
    The optimizer runs only on the PS; a worker's parameters change only
    through pulls, and with a single worker that waits for each apply
    (:meth:`wait_applied`), pull-after-apply is synchronous training
    exactly.  ``staleness > 0`` adds the synchronous path's SSP gate.

    The chief (no ``AUTODIST_TPU_WORKER``, or ``is_chief=True``) runs
    the PS as a thread of its own process: its own coordination client,
    the trainable's optimizer on the runner's device, and on the card a
    CUDA stream of its own; a published blob is copied to the host only
    once that stream's work is done, so it holds the applied
    parameters.  Under a burst of queued gradients the PS serializes the
    parameters at most once every ``publish_max_lag`` applied updates
    (or ``publish_max_interval_s``), and always when the queue drains, so
    a pull after :meth:`wait_applied` sees every update.  A popped
    gradient is always applied.  With no service configured, the chief
    serves one in-process (:class:`~autodist_tpu_torch.runtime
    .coordination.CoordServer`) and a non-chief raises ``OSError``.

    The blobs are whole trees through the host (``np.savez`` of every
    leaf): a semantics-parity feature, not a large-model transport.
    Above :attr:`BLOB_WARN_BYTES` the runner warns; beyond that size a
    synchronous ZeRO/FSDP strategy is the one to use.

    There is no graph route (the JAX runner has no ``run_steps`` scan):
    :func:`~autodist_tpu_torch.train.fit` drives :meth:`step` a step.
    Capture no CUDA graph in this process while the chief's PS thread is
    alive: a capture in one thread while another launches work fails
    under torch's default capture mode.  ``device=None`` is the card
    (this process's current CUDA device); ``device="cpu"`` runs the
    plain path on the CPU.

    Telemetry: the counters ``asyncps/push``, ``pull``, ``pull_skip``,
    ``apply`` and ``publish``, and the spans ``asyncps/pull``, ``pack``,
    ``push``, ``apply`` and ``publish`` (host seconds)."""

    GRADS_QUEUE = "asyncps/grads"
    PARAMS_KEY = "asyncps/params"
    VERSION_KEY = "asyncps/version"  # tiny: polled without moving the blob

    # Host blob exchange is O(model size); warn above this.
    BLOB_WARN_BYTES = 256 << 20

    def __init__(self, trainable, *, staleness: int = 0, seed: int = 0,
                 device=None, ssp_worker: Optional[str] = None,
                 ssp_num_workers: Optional[int] = None,
                 is_chief: Optional[bool] = None,
                 publish_max_lag: int = 8,
                 publish_max_interval_s: float = 0.1):
        from autodist_tpu_torch.resource import Mesh
        from autodist_tpu_torch.runtime import coordination

        if trainable.extra is not None:
            raise NotImplementedError(
                "async PS does not support mutable extra state (batch "
                "stats); train those models synchronously")
        self.trainable = trainable
        self.strategy = None       # set by AutoDist.build
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        # One worker is one process on one device: no collective.
        self.mesh = Mesh(shape={const.DATA_AXIS: 1})
        self._publish_max_lag = max(int(publish_max_lag), 1)
        self._publish_max_interval_s = float(publish_max_interval_s)
        self.blob_bytes = sum(
            math.prod(v.shape) * torch.empty((), dtype=v.dtype).element_size()
            for v in trainable.var_infos())
        if self.blob_bytes > self.BLOB_WARN_BYTES:
            _log.warning(
                "async PS exchanges whole-tree host blobs: %.0f MB per "
                "push/publish. Expect seconds per update at this size — "
                "the async path is a semantics-parity feature, not a "
                "large-model transport; use a synchronous ZeRO/FSDP "
                "strategy beyond ~%d MB",
                self.blob_bytes / 1e6, self.BLOB_WARN_BYTES >> 20)
        self._seeds = np.random.RandomState(seed)
        self._host_step = 0
        self._closed = False

        self.is_chief = (is_chief if is_chief is not None
                         else not const.ENV.AUTODIST_TPU_WORKER.val)
        self._own_server = None
        client = coordination.service_client()
        if client is None:
            if not self.is_chief:
                # A private server would hold no published parameters:
                # the first pull would wait forever.
                raise OSError(
                    "async PS worker needs a reachable coordination "
                    "service (AUTODIST_TPU_COORD_SERVICE); none configured "
                    "or connection failed")
            # One-process convenience: the chief serves in-process.
            self._own_server = coordination.CoordServer()
            os.environ["AUTODIST_TPU_COORD_SERVICE"] = \
                f"127.0.0.1:{self._own_server.port}"
            client = coordination.service_client()
        self._client = client

        self.params = unflatten({name: t.detach().to(dev) for name, t in
                                 flatten_with_names(trainable.params)})
        self._params_version = 0
        self._ps_thread = None
        self._ps_error: Optional[BaseException] = None
        self._ps_stop_event = threading.Event()
        self.ps_publish_count = 0
        if self.is_chief:
            self._start_ps_loop()
        else:
            self._pull(block=True, force=True)   # the PS's initial params

        self._ssp = (_ssp_gate(self._client, staleness, ssp_worker,
                               ssp_num_workers) if staleness > 0 else None)

    # ------------------------------------------------------------------ #
    def _start_ps_loop(self):
        """The parameter server proper: one host thread owning (params,
        optimizer state), applying every pushed gradient as it arrives
        (the PS devices' apply ops, reference
        ``ps_synchronizer.py:216-230``)."""
        opt, dev = self.trainable.optimizer, self.device
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def on_stream():
            return (torch.cuda.stream(stream) if stream is not None
                    else contextlib.nullcontext())

        def done():
            """The PS stream's work so far has finished."""
            if stream is not None:
                stream.synchronize()

        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
        with on_stream():
            # Every tensor of the PS is allocated on its own stream.
            ps = {"params": {name: t.detach().to(dev).clone() for name, t
                             in flatten_with_names(self.trainable.params)}}
            ps["opt_state"] = opt.init(ps["params"])
        done()
        # Blob first, version second: a reader that sees version N
        # fetches a blob of version >= N.
        self._client.put(self.PARAMS_KEY, _pack_tree(0, ps["params"]))
        self._client.put(self.VERSION_KEY, struct.pack("<q", 0))
        addr = const.ENV.AUTODIST_TPU_COORD_SERVICE.val
        lag, interval = self._publish_max_lag, self._publish_max_interval_s
        stop = self._ps_stop_event

        def apply(msg):
            with telemetry.span("asyncps/apply"):
                _, grads = _unpack_tree(msg, ps["params"], dev)
                updates, ps["opt_state"] = opt.update(
                    dict(flatten_with_names(grads)), ps["opt_state"],
                    ps["params"])
                ps["params"] = optim.apply_updates(ps["params"], updates)
                done()
            telemetry.counter("asyncps/apply").inc()

        def loop(ps_client):
            version = published = 0
            last_pub = time.time()

            def publish() -> bool:
                """False when the service is gone (the loop then ends
                instead of dying on an OSError)."""
                nonlocal published, last_pub
                try:
                    with telemetry.span("asyncps/publish"):
                        ps_client.put(self.PARAMS_KEY,
                                      _pack_tree(version, ps["params"]))
                        ps_client.put(self.VERSION_KEY,
                                      struct.pack("<q", version))
                except OSError:
                    return False
                published, last_pub = version, time.time()
                self.ps_publish_count += 1
                telemetry.counter("asyncps/publish").inc()
                return True

            alive = True
            while alive and not stop.is_set():
                try:
                    msg = ps_client.queue_get(self.GRADS_QUEUE,
                                              timeout_ms=200)
                except OSError:
                    break                         # service shut down
                if msg is None:
                    if version > published and not publish():
                        break
                    continue
                # Drain the burst, publishing at most every `lag` applied
                # updates / `interval` seconds; one publish after the
                # drain keeps pull-after-wait_applied exact.  A popped
                # message is always applied (the pop is destructive); the
                # stop event only ends the drain.
                while msg is not None:
                    apply(msg)
                    version += 1
                    if (version - published >= lag
                            or time.time() - last_pub > interval):
                        if not publish():
                            alive = False
                            break
                    if stop.is_set():
                        break
                    try:
                        msg = ps_client.queue_get(self.GRADS_QUEUE,
                                                  timeout_ms=0)
                    except OSError:
                        alive = False
                        break
                if alive and version > published and not publish():
                    break

        def run():
            from autodist_tpu_torch.runtime.coordination import CoordClient

            host, _, port = addr.rpartition(":")
            ps_client = CoordClient(host or "127.0.0.1", int(port))
            try:
                if stream is not None:
                    torch.cuda.set_device(dev)
                with on_stream():
                    loop(ps_client)
            except BaseException as e:     # surfaced by wait_applied
                self._ps_error = e
                _log.exception("async PS loop failed")
            finally:
                ps_client.close()

        self._ps_thread = threading.Thread(target=run, daemon=True,
                                           name="asyncps-server")
        self._ps_thread.start()

    def _pull(self, block: bool = False, force: bool = False):
        ver_raw = self._client.get(self.VERSION_KEY,
                                   timeout_ms=-1 if block else 0)
        if ver_raw is None:
            return
        if not force and \
                struct.unpack("<q", ver_raw)[0] == self._params_version:
            # Nothing new: the blob does not move (publish gating elides
            # host serialization under bursts).
            telemetry.counter("asyncps/pull_skip").inc()
            return
        with telemetry.span("asyncps/pull"):
            data = self._client.get(self.PARAMS_KEY, timeout_ms=-1)
            self._params_version, self.params = _unpack_tree(
                data, self.params, self.device)
        telemetry.counter("asyncps/pull").inc()

    def _place(self, batch) -> dict:
        if isinstance(batch, _Placed):
            return batch
        return _Placed({key: torch.as_tensor(x).to(self.device)
                        for key, x in batch.items()})

    def local_grads(self, batch, rng: int):
        """``(grads, metrics)`` of the whole local batch at the current
        parameters: the loss's gradient of every variable (``{name:
        tensor}``) on the runner's device, and the detached metrics."""
        leaves = {name: p.detach().requires_grad_(True)
                  for name, p in flatten_with_names(self.params)}
        with torch.enable_grad():
            loss, _, metrics = self.trainable.loss(
                unflatten(leaves), None, self._place(batch),
                cuda_graph.fold_seed(rng, 1, 0))
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {name: torch.zeros_like(leaves[name]) if g is None else g
                 for name, g in zip(leaves, grads)}
        return grads, {k: torch.as_tensor(v).detach()
                       for k, v in metrics.items()}

    # ------------------------------------------------------------------ #
    def step(self, batch, *, rng=None):
        """Pull the latest parameters, compute the local gradient, push
        it; returns the local metrics."""
        if self._closed:
            raise RuntimeError("runner is closed")
        _ssp_start(self._ssp, self._host_step)
        self._pull()
        rng = int(self._seeds.randint(0, 2 ** 31 - 1)) if rng is None \
            else rng
        grads, metrics = self.local_grads(batch, rng)
        with telemetry.span("asyncps/pack"):
            blob = _pack_tree(self._host_step, grads)  # waits for the card
        with telemetry.span("asyncps/push"):
            self._client.queue_put(self.GRADS_QUEUE, blob)
        telemetry.counter("asyncps/push").inc()
        if self._ssp is not None:
            self._ssp.finish_step(self._host_step)
        self._host_step += 1
        return metrics

    def wait_applied(self, min_version: int, timeout_s: float = 30.0):
        """Block until the PS has applied (and published) at least
        ``min_version`` updates: the deterministic hand-off of tests and
        epoch boundaries."""
        deadline = time.time() + timeout_s
        while self._params_version < min_version:
            if self._ps_error is not None:
                raise RuntimeError("the async PS loop failed") \
                    from self._ps_error
            self._pull(block=False)
            if time.time() > deadline:
                raise TimeoutError(
                    f"PS applied {self._params_version} < {min_version} "
                    f"updates within {timeout_s}s")
            time.sleep(0.005)

    @property
    def step_count(self) -> int:
        return self._host_step

    def get_params(self):
        """The latest published parameters (copies, on the device)."""
        self._pull()
        return unflatten({name: t.clone() for name, t in
                          flatten_with_names(self.params)})

    def close(self):
        """Stop the PS thread and, when this runner serves the
        coordination service itself, the service (safe to call more than
        once)."""
        if self._closed:
            return
        self._closed = True
        self._ps_stop_event.set()
        if self._ps_thread is not None:
            # The drain's last publish may move a large blob.
            self._ps_thread.join(timeout=60)
        if self._own_server is not None:
            from autodist_tpu_torch.runtime import coordination

            addr = f"127.0.0.1:{self._own_server.port}"
            if os.environ.get("AUTODIST_TPU_COORD_SERVICE") == addr:
                del os.environ["AUTODIST_TPU_COORD_SERVICE"]
            coordination.reset_service_client()
            self._own_server.stop()
            self._own_server = None
