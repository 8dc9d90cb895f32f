"""Arbitrary-tensor fetch: tag intermediates inside a loss for retrieval.

Counterpart of ``autodist_tpu/fetches.py``.  A loss tags a value where it
exists::

    from autodist_tpu_torch import fetch

    def loss_fn(params, batch):
        h = encoder(params, batch["x"])
        fetch("encoder_norm", h.norm())      # tagged, not returned
        ...
        return loss

and the value surfaces in the step metrics as ``fetch/<name>``, through
every lowering, gradient accumulation and the cross-replica metric
reduction (floats averaged, integers summed, flags OR-ed, leaf by leaf
at any shape).  ``runner.step(...)["fetch/encoder_norm"]`` therefore
works under FSDP, ZeRO, compressed sync and the pipeline's loss head.

The JAX package refuses a tag traced inside a ``lax.scan`` body, whose
value cannot escape the scan.  Eager PyTorch has no such scope: the
contract that carries over is the pipeline's, where a tag inside a stage
function raises naming the tag (a stage runs once a tick and
microbatch, so one tag would mean ``M`` values), as does a tag used
twice in a step or one that collides with an explicit metric.

Fetched floats are *averaged* across replicas: fetch replica-invariant
values or statistics whose mean means something (norms, entropies);
per-sample tensors come back as the mean of the per-shard values, not a
gathered batch.
"""
from __future__ import annotations

import contextlib
import threading


class _Refused:
    """A collector that refuses every tag: the scope of a pipeline
    stage."""

    def __init__(self, where: str):
        self.where = where


class _Stack(threading.local):
    """Per-thread collector stack: training in one thread and evaluating
    in another must not mix their tags."""

    def __init__(self):
        self.items: list = []


_TLS = _Stack()


def fetch(name: str, value):
    """Tag ``value`` for retrieval as ``fetch/<name>`` in the step
    metrics.  A no-op (returns ``value``) outside a collecting context,
    so the same model code runs unchanged outside the runner.  Tag names
    must be unique within one step (a per-layer loop should suffix the
    index)."""
    if _TLS.items:
        d = _TLS.items[-1]
        key = str(name)
        if isinstance(d, _Refused):
            raise ValueError(
                f"fetch tag {key!r} is inside {d.where}, which runs once "
                "a tick and microbatch: its value cannot reach the step "
                "metrics; tag in the loss head, or compute the statistic "
                "there")
        if key in d:
            raise ValueError(
                f"fetch tag {key!r} already used in this step; silent "
                "overwrite would keep only the last value — use distinct "
                "names (e.g. suffix the layer index)")
        d[key] = value
    return value


@contextlib.contextmanager
def collecting():
    """Collector: values tagged by :func:`fetch` inside the block land
    in the yielded dict (used by the trainable's loss wrapper and the
    pipeline's loss head)."""
    d: dict = {}
    _TLS.items.append(d)
    try:
        yield d
    finally:
        _TLS.items.pop()


@contextlib.contextmanager
def refusing(where: str):
    """A scope in which every :func:`fetch` raises, naming the tag and
    ``where``."""
    _TLS.items.append(_Refused(where))
    try:
        yield
    finally:
        _TLS.items.pop()


def merge_into_metrics(metrics: dict, collected: dict) -> dict:
    """``fetch/<name>`` keys merged into a metrics dict; a collision with
    an explicit metric of the same name raises (a silent overwrite would
    corrupt whichever the user meant)."""
    if not collected:
        return metrics
    out = dict(metrics)
    for k, v in collected.items():
        key = f"fetch/{k}"
        if key in out:
            raise ValueError(
                f"fetch tag {k!r} collides with an existing metric {key!r}")
        out[key] = v
    return out
