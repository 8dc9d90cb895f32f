"""The elastic controller: survive a preemption, swap strategies live.

The port's counterpart of ``autodist_tpu/elastic/controller.py``, the
loop on top of the reshard engine:

1. **preempt**: a termination signal (a preempted machine gets SIGTERM)
   writes a blocking full checkpoint through the ``Saver``'s
   preemption hook, minus the dying (:meth:`ElasticController.install`);
   every rank of a job must reach that save at the same step (a fault
   plan that targets every rank at one ``at_step``, as ``chip_smoke.py``
   phase 25 does), since the save's barriers pair up;
2. a rank that leaves calls :meth:`~ElasticController.depart` after the
   save (its fault record closed, its runner and process group gone);
3. **resume** (:meth:`~ElasticController.resume`, also ``shrink`` and
   ``grow``): the survivors close the old runner first (the two states
   are never resident together), leave the old process group, build the
   new runner on the new spec (a multihost spec bootstraps the re-formed
   job; ``{}`` runs alone) and restore the checkpoint elastically onto
   it, optimizer state included.

:meth:`~ElasticController.hot_swap` is the live variant on the same
ranks: a new strategy, the state moved by the reshard engine's fast
route, the seed stream and host step carried over so that a trajectory
with dropout continues unchanged.  :meth:`~ElasticController.elect`
(re-running the strategy search on the surviving topology) needs the
simulator, ROADMAP Queue 1, item 10; ``resume`` and ``hot_swap`` take a
pinned ``strategy=`` and ``spec=``.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch.distributed as dist

from autodist_tpu_torch import telemetry
from autodist_tpu_torch.runtime.faults import fault_target
from autodist_tpu_torch.utils import logging

_ELECT_ITEM = "ROADMAP Queue 1, item 10: simulator and plan lint"


class ElasticController:
    """Owns the preemption -> checkpoint -> resume loop of one
    (trainable, Saver) pair.  ``device`` is the runners' (``None``: the
    card)."""

    def __init__(self, trainable, saver, *, device=None):
        self.trainable = trainable
        self.saver = saver
        self.device = device
        self._preempted = threading.Event()
        self._runner = None        # the runner the hook saves

    @property
    def preempted(self) -> bool:
        """Set once a preemption signal was handled; the training loop
        checks it between steps and hands off to :meth:`resume` (or
        :meth:`depart`)."""
        return self._preempted.is_set()

    def install(self, runner, *, signals=None, exit_after: bool = False):
        """Install the preemption handler (the Saver's hook, pointed at
        the runner this controller owns at the time of the signal): a
        blocking full checkpoint, then :attr:`preempted`.
        ``exit_after=True`` chains to the previous handling (the process
        dies after the checkpoint).  Returns the previous handlers."""
        self._runner = runner

        def on_preempted(saved: bool):
            telemetry.counter("elastic/preemptions").inc()
            if not saved:
                # Hand off regardless: resume falls back to the last
                # good checkpoint (the saver logged the failure).
                telemetry.counter("elastic/preemption_save_failures").inc()
            self._preempted.set()

        return self.saver.install_preemption_hook(
            lambda: self._runner, signals=signals, exit_after=exit_after,
            on_preempted=on_preempted)

    def elect(self, topology):
        """The strategy search on the surviving topology."""
        raise NotImplementedError(
            f"ElasticController.elect re-runs the strategy search, which is "
            f"not ported yet ({_ELECT_ITEM}); pass strategy= and spec= to "
            "resume or hot_swap")

    def _build(self, spec, strategy, seed: int = 0):
        """A runner for ``strategy`` (a Strategy, a builder or a
        builder's name) on ``spec``."""
        from autodist_tpu_torch.autodist import AutoDist
        from autodist_tpu_torch.strategy.ir import Strategy

        if isinstance(strategy, Strategy):
            return AutoDist(spec, device=self.device).build(
                self.trainable, strategy, seed=seed)
        return AutoDist(spec, strategy, device=self.device).build(
            self.trainable, seed=seed)

    def resume(self, topology=None, *, step: Optional[int] = None,
               strategy=None, spec=None):
        """Build the runner of ``strategy`` on ``spec`` and restore the
        latest (or ``step``'s) checkpoint elastically onto it: the
        shrink and the grow path alike.  The old runner is closed and
        this process leaves the old process group first."""
        preempted = self._preempted.is_set()
        if strategy is None or spec is None:
            strategy, spec = self.elect(topology)
        if self._runner is not None:
            self._runner.close()
            self._runner = None
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        runner = self._build(spec, strategy)
        self.saver.restore_elastic(runner, step=step)
        self._runner = runner      # the preemption hook follows the swap
        telemetry.counter("elastic/resumes").inc()
        if preempted:
            telemetry.record_event(
                "fault", fault="preempt_signal", target=fault_target(),
                phase="recovered", action="shrink_resume",
                step=runner.step_count, mesh=dict(runner.mesh.shape))
        self._preempted.clear()
        logging.info("elastic resume at step %d on mesh %s (strategy %s)",
                     runner.step_count, dict(runner.mesh.shape),
                     runner.strategy.id)
        return runner

    shrink = resume
    grow = resume

    def depart(self):
        """A preempted rank leaving the job after its checkpoint: its
        fault record closed (the survivors resume from the save), its
        runner closed and its process group left."""
        if self._preempted.is_set():
            telemetry.record_event(
                "fault", fault="preempt_signal", target=fault_target(),
                phase="recovered", action="checkpointed_and_left")
        if self._runner is not None:
            self._runner.close()
            self._runner = None
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()

    def hot_swap(self, runner, topology=None, *, strategy=None, spec=None):
        """A new strategy on the same ranks: its runner built, the live
        state moved by the reshard engine's fast route, the seed stream
        and host step carried over.  Returns the new runner (the old one
        is closed)."""
        from autodist_tpu_torch.elastic.reshard import (meta_template,
                                                        reshard_state)

        if strategy is None or spec is None:
            strategy, spec = self.elect(topology)
        new = self._build(spec, strategy)
        template = meta_template(new.state)
        new.state = None           # the target state is built once
        new.state = reshard_state(runner.lowered, runner.state, new.lowered,
                                  template)
        new._seeds.set_state(runner._seeds.get_state())
        new._host_step = runner._host_step
        runner.close()
        if self._runner is runner:
            self._runner = new     # the hook must not save a closed runner
        telemetry.counter("elastic/hot_swaps").inc()
        return new
