"""High-level training loop: ``fit``.

Counterpart of ``autodist_tpu/train.py``: loader prefetch, periodic
eval, periodic and final checkpoints, throughput logging and resume from
the saver's latest step in one call, composed from the public pieces
(:class:`~autodist_tpu_torch.data.DataLoader`,
:class:`~autodist_tpu_torch.checkpoint.Saver`, ``runner.step`` /
``run_steps`` / ``evaluate``).

The source yields what ``runner.step`` takes, the global batch: every
rank of a job runs the same ``fit`` call on the same source, and the
loader keeps this rank's part.  The loop keeps a host mirror of the
step: reading ``runner.step_count`` would wait for the card every
iteration.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np

from autodist_tpu_torch import telemetry
from autodist_tpu_torch.runner import _leaves, batch_size, stack_steps

_log = logging.getLogger(__name__)


def fit(runner, source: Iterable | Callable[[int], Any], *,
        steps: int,
        eval_source: Optional[Iterable | Callable[[int], Any]] = None,
        eval_every: int = 0, eval_batches: int = 10,
        saver=None, save_every: int = 0,
        resume: bool = True,
        log_every: int = 100,
        prefetch: int = 2,
        steps_per_loop: int = 1) -> dict:
    """Train ``runner`` up to ``steps`` optimizer steps.

    Args:
      runner: a built runner (``AutoDist(...).build(trainable)``).
      source: host-batch source, an iterable or ``step -> batch``.
      eval_source / eval_every / eval_batches: ``runner.evaluate`` over
        ``eval_batches`` batches every ``eval_every`` steps (0: never).
        Pass a callable or a re-iterable (a list): a one-shot iterator
        is exhausted after the first eval.
      saver: a :class:`~autodist_tpu_torch.checkpoint.Saver`; when
        given, a final checkpoint is always written, plus one every
        ``save_every`` steps (0: final only).  With ``resume=True``
        training continues from the saver's latest step, and a callable
        source is shifted by it (a resumed job continues the data
        stream; an iterable is consumed where it stands).
      log_every: loss and throughput log cadence (0: silent).
      prefetch: the loader's depth (:class:`~autodist_tpu_torch.data
        .DataLoader`).
      steps_per_loop: up to this many steps a ``runner.run_steps``
        window (one CUDA-graph replay on the card; a runner without
        ``run_steps``, the ``AsyncPSRunner``, steps one at a time); a
        window never
        crosses a log, eval or save boundary, so every cadence fires at
        the steps of the per-step loop, and a batch of another shape
        (a ragged last one) becomes a window of its own.  Each distinct
        window shape is captured once.  1 (default): a ``step`` call a
        step over the prefetching loader.

    Returns ``{"steps", "loss", "eval", "examples_per_sec"}``: ``loss``
    and ``eval`` list ``(step, value)`` at the log and eval steps.
    """
    from autodist_tpu_torch.data import DataLoader

    if saver is not None and resume and saver.latest_step() is not None:
        saver.restore(runner)
        _log.info("fit: resumed at step %d", runner.step_count)
    start = runner.step_count
    remaining = steps - start
    history: dict = {"steps": steps, "loss": [], "eval": [],
                     "examples_per_sec": 0.0}
    if remaining <= 0:
        _log.info("fit: nothing to do (at step %d >= %d)", start, steps)
        return history
    if callable(source) and start:
        inner = source
        source = lambda i: inner(start + i)  # noqa: E731

    # A runner without run_steps (the AsyncPSRunner) takes the per-step
    # loop.
    fused = steps_per_loop > 1 and hasattr(runner, "run_steps")
    cadences = [every for every, on in (
        (log_every, True), (eval_every, eval_source is not None),
        (save_every, saver is not None)) if every and on]
    if fused:
        it = iter(_iter_source(source, remaining))
        pending: list = []        # lookahead for shape-change breaks

        def next_window_size(step: int) -> int:
            """The largest window ending at (not crossing) the next
            cadence boundary."""
            k = min(steps_per_loop, start + remaining - step)
            for every in cadences:
                k = min(k, every - step % every)
            return k

        def take_window(k: int) -> list:
            """Up to ``k`` consecutive batches of one shape."""
            while len(pending) < k:
                try:
                    pending.append(next(it))
                except StopIteration:
                    break
            if not pending:
                return []
            sig = _shape_sig(pending[0])
            w = []
            while pending and len(w) < k and _shape_sig(pending[0]) == sig:
                w.append(pending.pop(0))
            return w
    else:
        loader = iter(DataLoader(source, runner.mesh, buffer_size=prefetch,
                                 num_batches=remaining, global_batches=True,
                                 lowered=getattr(runner, "lowered", None),
                                 device=getattr(runner, "device", None)))

    t0 = time.perf_counter()
    examples = window_examples = 0
    t_window = t0
    step = start
    with telemetry.span("train/fit", steps=steps, start=start, fused=fused):
        while step < start + remaining:
            t_step = time.perf_counter()
            if fused:
                window = take_window(next_window_size(step))
                if not window:
                    break
                stacked = runner.run_steps(stack_steps(window))
                metrics = {k: v[-1] for k, v in stacked.items()}
                bsz = batch_size(window[0]) * len(window)
                step += len(window)
                telemetry.record_step(
                    step=step - 1, duration_s=time.perf_counter() - t_step,
                    examples=bsz, steps=len(window))
            else:
                try:
                    batch = next(loader)
                except StopIteration:
                    break
                metrics = runner.step(batch)
                bsz = batch.examples
                step += 1
                telemetry.record_step(
                    step=step - 1, duration_s=time.perf_counter() - t_step,
                    examples=bsz)
            examples += bsz
            window_examples += bsz
            if log_every and step % log_every == 0:
                loss = float(metrics["loss"]) if "loss" in metrics \
                    else float("nan")
                dt = time.perf_counter() - t_window
                rate = window_examples / dt if dt > 0 else float("nan")
                history["loss"].append((step, loss))
                _log.info("fit: step %d loss %.4f (%.1f examples/s)",
                          step, loss, rate)
                window_examples, t_window = 0, time.perf_counter()
            if eval_every and eval_source is not None \
                    and step % eval_every == 0:
                with telemetry.span("train/eval", step=step):
                    ev = runner.evaluate(
                        _iter_source(eval_source, eval_batches),
                        num_batches=eval_batches)
                if not ev:
                    _log.warning(
                        "fit: eval at step %d saw no batches; a one-shot "
                        "iterator eval_source is exhausted: pass a "
                        "callable or a re-iterable (list)", step)
                history["eval"].append((step, ev))
                _log.info("fit: step %d eval %s", step,
                          {k: np.round(v, 4).tolist() for k, v in ev.items()})
            if saver is not None and save_every and step % save_every == 0:
                with telemetry.span("train/checkpoint", step=step):
                    saver.save(runner)

        if saver is not None and saver.latest_step() != step:
            with telemetry.span("train/checkpoint", step=step):
                saver.save(runner, force=True)
    total = time.perf_counter() - t0
    history["examples_per_sec"] = examples / total if total > 0 else 0.0
    if history["examples_per_sec"]:
        telemetry.gauge("fit/examples_per_sec").set(
            history["examples_per_sec"])
    return history


def _shape_sig(batch) -> tuple:
    return tuple(np.shape(leaf) for leaf in _leaves(batch))


def _iter_source(source, n: int):
    if callable(source):
        return (source(i) for i in range(n))
    return source
