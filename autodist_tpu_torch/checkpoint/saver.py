"""Checkpointing: exact resume under one layout, portable restore under any.

Counterpart of ``autodist_tpu/checkpoint/saver.py``.  Two kinds of
checkpoint:

* **full**: every rank writes its own training state (the step, its
  stored parameters, optimizer and compressor state, the extra state and
  the runner's dropout-seed stream) as it lays them out, for an exact
  resume under the same strategy and mesh;
* **portable** (``portable=True``): the parameters at their logical
  names and unpadded shapes (``runner.get_params()``, a gather where the
  strategy shards them) and the extra state, written once, restorable
  under any strategy or mesh, or read as plain tensors with ``torch``
  alone.

The store is one ``torch.save`` file a writing rank and step, not
``torch.distributed.checkpoint``: DCP takes plain tensors that several
ranks save under one key for replicas and keeps one writer, and the
port's ZeRO, pipe, model and expert shards are such plain tensors; a
file a rank keeps every shard, needs no collective to write (so an async
write never issues one from its thread), and reads back bit for bit.
Layout: ``<directory>/<step>/`` holds ``rank<r>.pt`` (full) or
``portable.pt``, then one ``rank<r>.json`` marker a writer, written
last; a step is complete when every writer's marker is there, and only
complete steps count (:meth:`Saver.latest_step`).  The newest
:data:`MAX_TO_KEEP` (5) complete steps are kept.

An async save snapshots the state to host memory (pinned, on the card)
before :meth:`Saver.save` returns, and writes it in a thread: after a
CUDA-graph replay ``runner.state`` is the graph's static buffers, which
the next replay overwrites in place, so the copy cannot wait.  A
failed write is retried under a :class:`~autodist_tpu_torch.runtime
.retry.RetryPolicy`, then raises :class:`CheckpointSaveError` with its
step (an async one at the next join: ``save``, ``wait``,
``latest_step``, ``restore`` or ``close``), or with
``degrade_on_failure`` is counted and recorded as a ``kind="fault"``
event while training goes on from the last good checkpoint.

A full save also writes an **elastic sidecar**, ``elastic/<step>.json``
(``kind: "elastic_meta"``: the Strategy JSON, the mesh and the writing
lowering's state manifest), rank 0 writing it once every rank's files
are there; it is pruned with its checkpoint.  Every lowering family
records a manifest (collective, ``replicated_spmd``, ``simple`` and
``pipeline``: the interleave permutation, the padded vocab table, the
ZeRO-3 rows), so a ``Pipeline`` job's save writes its sidecar like any
other; a sidecar that still cannot be written only warns, as in the
JAX package, and the checkpoint then restores onto its own layout
alone.  :meth:`Saver.restore_elastic` restores a full checkpoint onto
another strategy, mesh and world size through the reshard engine's
staged route (:mod:`autodist_tpu_torch.elastic.reshard`), optimizer
state included; a checkpoint written before sidecars existed needs the
writer's ``strategy=``.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from autodist_tpu_torch import telemetry
from autodist_tpu_torch.resource import _world
from autodist_tpu_torch.runner import _tensors
from autodist_tpu_torch.runtime.faults import fault_target
from autodist_tpu_torch.runtime.retry import RetryPolicy

_log = logging.getLogger(__name__)
_FORMAT = 1
_SIDECAR_DIR = "elastic"
MAX_TO_KEEP = 5        # complete checkpoints kept (the JAX package's)


class CheckpointSaveError(RuntimeError):
    """A checkpoint write failed (a blocking one after its retries, or
    an async one at the next join); ``step`` is the step whose save
    failed."""

    def __init__(self, message: str, *, step: Optional[int] = None):
        super().__init__(message)
        self.step = step


def _barrier():
    """Every rank of the default group here (a no-op alone)."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _tree_map(fn, tree):
    """``fn`` on every tensor of a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _host_snapshot(tree, pinned: Optional[dict] = None):
    """A host copy of every tensor of ``tree``, finished when this
    returns.  Card tensors go through pinned buffers (reused from
    ``pinned``, keyed by leaf position, where shape and dtype match)
    with one synchronize at the end."""
    leaves = _tensors(tree)
    if not any(t.is_cuda for t in leaves):
        return _tree_map(lambda t: t.detach().clone(), tree)
    pinned = {} if pinned is None else pinned
    index = iter(range(len(leaves)))

    def copy(t):
        i = next(index)
        if not t.is_cuda:
            return t.detach().clone()
        buf = pinned.get(i)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = pinned[i] = torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True)
        buf.copy_(t.detach(), non_blocking=True)
        return buf

    out = _tree_map(copy, tree)
    torch.cuda.synchronize()
    return out


class _Store:
    """The files of one checkpoint directory, and the one write that
    may be in flight in a thread."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None
        self._error: list = []

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def write(self, step: int, name: str, payload, marker: dict) -> int:
        """``payload`` to ``<step>/<name>``, then this writer's marker;
        returns the bytes written.  Each file appears whole (written
        aside, then renamed)."""
        d = self.step_dir(step)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, name)
        mark = os.path.join(d, f"rank{marker['rank']}.json")
        if os.path.exists(mark):         # a replaced step is incomplete
            os.remove(mark)              # until its new marker is there
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        with open(mark + ".tmp", "w") as f:
            json.dump(marker, f)
        os.replace(mark + ".tmp", mark)
        if marker["rank"] == 0:
            self.prune()
        return os.path.getsize(path)

    def start(self, fn):
        """Run ``fn`` in a thread; its failure surfaces at :meth:`join`."""
        self._error = []

        def run():
            try:
                fn()
            except BaseException as e:   # noqa: BLE001 — surfaced at join
                self._error.append(e)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="autodist-torch-ckpt")
        self._thread.start()

    def join(self):
        """Wait for the write in flight; re-raise its failure."""
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        if self._error:
            err, self._error = self._error[0], []
            raise err

    def markers(self, step: int) -> dict:
        d = self.step_dir(step)
        out = {}
        for name in os.listdir(d):
            if name.startswith("rank") and name.endswith(".json"):
                with open(os.path.join(d, name)) as f:
                    m = json.load(f)
                out[m["rank"]] = m
        return out

    def complete(self, step: int) -> Optional[dict]:
        """Rank 0's marker where every writer of ``step`` has written
        (``None`` otherwise)."""
        try:
            marks = self.markers(step)
        except OSError:
            return None
        if not marks:
            return None
        writers = next(iter(marks.values()))["writers"]
        if set(marks) != set(range(writers)):
            return None
        return marks[0]

    def all_steps(self) -> list:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and self.complete(int(n)) is not None)

    def prune(self):
        """Remove the complete steps older than the newest
        :data:`MAX_TO_KEEP`, and their sidecars."""
        steps = self.all_steps()
        for step in steps[:max(len(steps) - MAX_TO_KEEP, 0)]:
            shutil.rmtree(self.step_dir(step), ignore_errors=True)
            self.remove_sidecar(step)

    def sidecar_path(self, step: int) -> str:
        return os.path.join(self.directory, _SIDECAR_DIR, f"{step}.json")

    def write_sidecar(self, step: int, record: dict) -> int:
        """The sidecar of ``step`` (written aside, then renamed); returns
        its bytes."""
        path = self.sidecar_path(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".tmp", "w") as f:
            json.dump(record, f)
        os.replace(path + ".tmp", path)
        return os.path.getsize(path)

    def remove_sidecar(self, step: int):
        try:
            os.remove(self.sidecar_path(step))
        except FileNotFoundError:
            pass


class Saver:
    """Save and restore a :class:`~autodist_tpu_torch.runner
    .DistributedRunner`'s state (see the module docstring).  Every rank
    of a job makes the same calls."""

    def __init__(self, directory: str, *, async_save: bool = False,
                 retry: Optional[RetryPolicy] = None,
                 degrade_on_failure: bool = False):
        """``async_save=True``: :meth:`save` returns once the state is
        on the host, and the write overlaps the next steps; :meth:`wait`
        (or the next save, restore or close) joins it.  ``retry`` bounds
        the re-attempts of a failed write (``None``: one attempt).
        ``degrade_on_failure=True`` turns a write that still fails into
        a counted, recorded degrade (``ckpt/save_failures``,
        ``ckpt/async_save_failures``, a ``kind="fault"`` event) instead
        of an exception: training continues on the last good
        checkpoint."""
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._async = async_save
        self._retry = retry
        self._degrade = degrade_on_failure
        self._inflight_step: Optional[int] = None
        self._store = _Store(self.directory)
        self._pinned: dict = {}
        self._sidecar: Optional[dict] = None    # awaiting its step's files
        self.last_save_bytes = 0
        self.last_sidecar_bytes = 0

    # ------------------------------------------------------------------ #
    def _fail(self, step, e, counter: str, what: str) -> None:
        """A failed write: raise with its step, or degrade."""
        telemetry.counter(counter).inc()
        if not self._degrade:
            raise CheckpointSaveError(
                f"{what} of step {step} failed: {type(e).__name__}: {e}",
                step=step) from e
        last_good = self._last_good_step()
        telemetry.record_event(
            "fault", fault="ckpt_write_fail", target=fault_target(),
            phase="degraded", step=step, action="continue_on_last_good",
            last_good_step=last_good)
        _log.error("%s of step %s failed (%s); training continues on the "
                   "last good checkpoint (step %s)", what, step, e,
                   last_good)

    def _join_inflight(self):
        """Join the async write in flight; a failure surfaces here,
        attributed to the step that staged it."""
        step, self._inflight_step = self._inflight_step, None
        if step is None:
            return
        try:
            self._store.join()
        except Exception as e:  # noqa: BLE001 — whatever the write raised
            self._sidecar = None
            self._fail(step, e, "ckpt/async_save_failures",
                       "async checkpoint save")
        finally:
            _barrier()
        self._write_sidecar()

    def _sidecar_record(self, runner, step: int) -> Optional[dict]:
        """The elastic sidecar of a full save at ``step``: the Strategy
        JSON, the mesh and the state manifest (``None`` where the
        manifest cannot be made: a warning, never a failed save)."""
        try:
            manifest = runner.lowered.state_manifest(runner.state)
        except Exception as e:   # noqa: BLE001 — best effort, as in JAX
            _log.warning("no elastic sidecar for step %d (%s: %s); this "
                         "checkpoint restores onto its own layout only",
                         step, type(e).__name__, e)
            return None
        strategy = getattr(runner, "strategy", None)
        return {"kind": "elastic_meta", "step": int(step),
                "strategy": (json.loads(strategy.to_json())
                             if strategy is not None else None),
                "mesh_axes": {a: int(n) for a, n in
                              runner.mesh.shape.items()},
                "manifest": manifest}

    def _write_sidecar(self):
        """Rank 0 writes the pending sidecar, once every rank's files of
        its step are there (best effort)."""
        record, self._sidecar = self._sidecar, None
        if record is None:
            return
        try:
            self.last_sidecar_bytes = self._store.write_sidecar(
                record["step"], record)
        except OSError as e:
            _log.warning("could not write the elastic sidecar of step %d "
                         "(%s); it restores onto its own layout only",
                         record["step"], e)

    def _last_good_step(self) -> Optional[int]:
        steps = self._store.all_steps()
        return steps[-1] if steps else None

    def save(self, runner, *, portable: bool = False, force: bool = False,
             blocking: Optional[bool] = None):
        """Write a checkpoint at the runner's current step; returns the
        step, or ``None`` where a failed write degraded.  A complete
        checkpoint of the same step is replaced only with ``force``.
        ``blocking`` overrides the constructor's ``async_save`` for
        this call (the preemption hook blocks)."""
        self._join_inflight()
        step = runner.step_count
        exists = self._store.complete(step) is not None
        _barrier()       # every rank has looked before any rank writes
        if exists and not force:
            raise ValueError(f"a checkpoint of step {step} exists in "
                             f"{self.directory}; pass force=True to "
                             "replace it")
        world, rank = _world()
        if portable:
            # get_params gathers (a collective): every rank calls it.
            payload = {"params": runner.get_params(),
                       "extra": runner.state["extra"], "step": step}
            name, writers = "portable.pt", 1
        else:
            payload = {"state": runner.state,
                       "seeds": runner._seeds.get_state(), "step": step}
            name, writers = f"rank{rank}.pt", world
        mesh = {a: int(s) for a, s in runner.mesh.shape.items()}
        marker = {"format": _FORMAT, "step": step, "rank": rank,
                  "world": world, "writers": writers,
                  "kind": "portable" if portable else "full",
                  "mesh": mesh}
        writes = rank < writers
        self._sidecar = None if portable or rank else self._sidecar_record(
            runner, step)
        if portable and rank == 0:
            self._store.remove_sidecar(step)     # a replaced full save's
        if writes:
            payload = _host_snapshot(payload, self._pinned)
        block = (not self._async) if blocking is None else blocking

        def write():
            self.last_save_bytes = self._store.write(step, name, payload,
                                                     marker)

        def attempt():
            if self._retry is not None:
                self._retry.call(write, describe=f"ckpt save step {step}")
            else:
                write()

        if not block:
            if writes:
                self._store.start(attempt)
            self._inflight_step = step
            _log.info("checkpoint step %d staged (async) for %s "
                      "(portable=%s)", step, self.directory, portable)
            return step
        try:
            if writes:
                attempt()
        except Exception as e:  # noqa: BLE001 — whatever the write raised
            self._sidecar = None
            self._fail(step, e, "ckpt/save_failures", "checkpoint save")
            return None
        finally:
            _barrier()
        self._write_sidecar()
        _log.info("checkpoint step %d saved to %s (portable=%s)", step,
                  self.directory, portable)
        return step

    def wait(self):
        """Join the async write in flight (a no-op when idle); its
        failure surfaces here as :class:`CheckpointSaveError` with its
        step (or degrades)."""
        self._join_inflight()

    def all_steps(self) -> list:
        self._join_inflight()
        return self._store.all_steps()

    def latest_step(self) -> Optional[int]:
        self._join_inflight()
        return self._last_good_step()

    def _resolve(self, step: Optional[int], kind: str) -> tuple:
        self._join_inflight()
        step = self._last_good_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        marker = self._store.complete(step)
        if marker is None:
            raise FileNotFoundError(
                f"no complete checkpoint of step {step} in {self.directory}")
        if marker["kind"] != kind:
            raise ValueError(
                f"checkpoint step {step} is a {marker['kind']} checkpoint; "
                + ("restore it with restore()" if kind == "portable" else
                   "restore it with restore_portable() (or restore_params)"))
        return step, marker

    def restore(self, runner, step: Optional[int] = None):
        """Restore a full checkpoint (the latest by default) into a runner
        of the same strategy and mesh: the exact resume, optimizer state
        and dropout-seed stream included.  The next CUDA-graph replay
        copies the restored state into the graph's buffers."""
        step, marker = self._resolve(step, "full")
        world, rank = _world()
        mesh = {a: int(s) for a, s in runner.mesh.shape.items()}
        if (marker["world"], marker["mesh"]) != (world, mesh):
            raise ValueError(
                f"checkpoint step {step} was written by {marker['world']} "
                f"rank(s) on mesh {marker['mesh']}; this job has {world} on "
                f"{mesh}: restore_elastic() restores it under another "
                f"layout")
        path = os.path.join(self._store.step_dir(step), f"rank{rank}.pt")
        payload = torch.load(path, map_location=runner.lowered.device,
                             weights_only=False)
        state = payload["state"]
        want = [(tuple(t.shape), t.dtype) for t in _tensors(runner.state)]
        got = [(tuple(t.shape), t.dtype) for t in _tensors(state)]
        if want != got:
            raise ValueError(
                f"checkpoint step {step} holds another state layout than "
                "this runner's (another strategy?): restore_portable() "
                "restores a portable checkpoint under any layout")
        runner.state = state
        runner._seeds.set_state(payload["seeds"])
        _log.info("restored checkpoint step %d", step)
        return runner

    def read_sidecar(self, step: int) -> Optional[dict]:
        """The elastic sidecar of ``step`` (``None`` for a checkpoint
        without one)."""
        path = self._store.sidecar_path(step)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore_elastic(self, runner, step: Optional[int] = None, *,
                        strategy=None):
        """Restore a full checkpoint (the latest by default), optimizer
        state included, into a runner whose strategy, mesh and world
        size may differ from the writers': the reshard engine's staged
        route, leaf by leaf from the writers' rank files
        (:func:`~autodist_tpu_torch.elastic.reshard.assemble_state`);
        the dropout-seed stream and the host step come back too.  The
        decode recipes come from the step's sidecar; a checkpoint
        without one is layout-unknown and needs ``strategy=`` (the
        Strategy its writers ran), whose source layout is rebuilt on the
        recorded mesh.  Compatibility is linted before any data moves
        (ADT070 raises :class:`~autodist_tpu_torch.elastic.reshard
        .ReshardError`).  Every rank of the target job calls it; each
        reads the parts it needs."""
        from autodist_tpu_torch.elastic import reshard

        t0 = time.perf_counter()
        step, marker = self._resolve(step, "full")
        sidecar = self.read_sidecar(step)
        step_dir = self._store.step_dir(step)
        if sidecar is not None:
            src_m, mesh = sidecar["manifest"], sidecar["mesh_axes"]
        elif strategy is not None:
            mesh = marker["mesh"]
            src_m = self._manifest_from_strategy(runner, strategy, step_dir,
                                                 mesh)
        else:
            raise ValueError(
                f"checkpoint step {step} in {self.directory} carries no "
                "elastic sidecar (written before elastic resharding "
                "existed): source layout-unknown — restoring under a "
                "guessed layout would silently corrupt sharded state. "
                "Pass strategy= (the Strategy IR the writer ran) to "
                "rebuild the layout, restore with restore() on the "
                "original strategy/mesh, or use restore_portable for a "
                "params-only portable checkpoint.")
        source = reshard.FileSource(step_dir, src_m, mesh)
        bad = source.unreadable()      # before the runner's state goes
        if bad:
            raise ValueError(
                f"checkpoint step {step} does not carry the training state "
                f"its layout declares ("
                + "; ".join(f"rank{r}.pt {what}" for r, what in bad)
                + "): restore_elastic needs every writer's full save of "
                "that layout")
        plan = reshard.plan_reshard(
            src_m, runner.lowered.state_manifest(runner.state)).require_ok()
        template = reshard.meta_template(runner.state)
        runner.state = None        # one target state on the device at once
        runner.state = reshard.assemble_state(
            runner.lowered, source, src_m, template, plan=plan, t0=t0)
        runner._seeds.set_state(source.payload0["seeds"])
        runner._host_step = step
        _log.info("restored checkpoint step %d elastically onto mesh %s",
                  step, dict(runner.mesh.shape))
        return runner

    def _manifest_from_strategy(self, runner, strategy, step_dir: str,
                                mesh: dict) -> dict:
        """A sidecar-less checkpoint's manifest: the writers' strategy
        lowered on a group-less layout of their recorded mesh (the plan
        reads sizes only), read against rank 0's stored shapes."""
        from autodist_tpu_torch.elastic.reshard import spec_for_layout
        from autodist_tpu_torch.kernel.lowering import lower
        from autodist_tpu_torch.resource import layout_mesh

        payload = torch.load(os.path.join(step_dir, "rank0.pt"),
                             map_location="cpu", mmap=True,
                             weights_only=False)
        layout = layout_mesh(spec_for_layout(
            mesh, strategy.graph_config.replicas))
        try:
            return lower(runner.trainable, strategy, layout,
                         "cpu").state_manifest(payload["state"])
        except (ValueError, RuntimeError, NotImplementedError) as e:
            raise ValueError(
                f"cannot rebuild the source layout of strategy "
                f"{strategy.id} on mesh {mesh}: {e}") from e

    def restore_params(self, step: Optional[int] = None) -> dict:
        """A portable checkpoint as host tensors: ``{"params": logical
        tree, "extra": ..., "step": int}``."""
        step, _ = self._resolve(step, "portable")
        return torch.load(os.path.join(self._store.step_dir(step),
                                       "portable.pt"),
                          map_location="cpu", weights_only=True)

    def restore_portable(self, runner, step: Optional[int] = None):
        """Restore a portable checkpoint into any strategy and mesh: the
        parameters laid out through the runner's init path, the optimizer
        state fresh."""
        payload = self.restore_params(step)
        runner.state = runner.lowered.init_state(params=payload["params"],
                                                 extra=payload["extra"])
        runner.state["step"] = torch.tensor(
            int(payload["step"]), dtype=torch.int32,
            device=runner.lowered.device)
        return runner

    def install_preemption_hook(self, runner, *, signals=None,
                                portable: bool = False,
                                exit_after: bool = True,
                                on_preempted=None):
        """Checkpoint on termination signals (a preempted machine gets
        SIGTERM) before the default handling proceeds.

        ``runner`` may be a zero-argument callable returning the current
        runner.  ``exit_after=False`` returns control to the process
        after the checkpoint instead of chaining to the previous
        handling; a failed save there is logged and reported through
        ``on_preempted(saved: bool)``, which runs after the save
        attempt.  Returns the previous handlers."""
        import signal as _signal

        signals = signals or (_signal.SIGTERM,)
        previous = {}
        get_runner = runner if callable(runner) else (lambda: runner)

        def handler(signum, frame):
            live = get_runner()
            _log.warning("signal %d: writing preemption checkpoint at "
                         "step %d", signum, live.step_count)
            try:
                saved = False
                try:
                    self.save(live, portable=portable, force=True,
                              blocking=True)
                    saved = True
                except Exception as e:
                    _log.error("preemption checkpoint at step %d FAILED "
                               "(%s); recovery falls back to the last good "
                               "checkpoint (step %s)", live.step_count, e,
                               self._last_good_step())
                    if exit_after:
                        raise
                if on_preempted is not None:
                    on_preempted(saved)
            finally:
                if exit_after:
                    prev = previous.get(signum)
                    if callable(prev):
                        prev(signum, frame)
                    elif prev != _signal.SIG_IGN:
                        # SIG_DFL, or a handler from C: the default
                        # termination, so the signal is never swallowed.
                        _signal.signal(signum, _signal.SIG_DFL)
                        _signal.raise_signal(signum)

        for sig in signals:
            previous[sig] = _signal.signal(sig, handler)
        return previous

    def close(self):
        """Join the write in flight (its failure surfaces here with its
        step)."""
        self._join_inflight()

