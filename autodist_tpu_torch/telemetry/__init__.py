"""In-memory telemetry: what the continuous batcher and engine record.

A minimal copy of ``autodist_tpu/telemetry``'s surface — ``counter``,
``gauge`` and ``histogram`` (``.inc`` / ``.set`` / ``.observe``),
``span``, ``record_step``, ``get().record_event``, ``current_trace_id``
and ``mint_trace_id`` — kept in process memory.  Step records and events
share one bounded list (``get().step_records()``), as in the JAX
package.  Sinks, flushing,
aggregation windows and drift monitoring are not ported yet (ROADMAP
Queue 1: telemetry and program lint).
"""
from __future__ import annotations

import contextvars
import itertools
import os
import time
from collections import deque
from typing import Optional

# Bounded so that a long-lived server cannot grow the buffers forever.
_EVENT_LIMIT = 1 << 16


class Counter:
    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n


class Gauge:
    def __init__(self):
        self.value = None

    def set(self, value):
        self.value = value


class Histogram:
    def __init__(self):
        self.values: deque = deque(maxlen=_EVENT_LIMIT)

    def observe(self, value):
        self.values.append(float(value))


class _Span:
    def __init__(self, sink: deque, name: str, args: dict):
        self._sink, self.name, self.args = sink, name, args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sink.append({"name": self.name, "start_s": self._t0,
                           "dur_s": time.perf_counter() - self._t0,
                           "args": self.args})
        return False


class Telemetry:
    """One process's counters, gauges, histograms, spans and events."""

    def __init__(self):
        self.counters: dict = {}
        self.gauges: dict = {}
        self.histograms: dict = {}
        self.spans: deque = deque(maxlen=_EVENT_LIMIT)
        self.records: deque = deque(maxlen=_EVENT_LIMIT)

    @property
    def events(self) -> list:
        """The typed event records (every record but the steps')."""
        return [r for r in self.records if r["kind"] != "step"]

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self.histograms.setdefault(name, Histogram())

    def span(self, name: str, **args) -> _Span:
        return _Span(self.spans, name, args)

    def record_event(self, kind: str, **fields) -> bool:
        if kind == "step":
            raise ValueError("use record_step for step records")
        self.records.append({"kind": kind, **fields})
        return True

    def record_step(self, step: int, duration_s: float, *,
                    examples: Optional[int] = None, steps: int = 1,
                    **extra) -> bool:
        """One training step's (or, with ``steps=k``, one fused
        window's) record; the ``step/duration_s`` histogram gets the
        per-step time."""
        self.histogram("step/duration_s").observe(
            float(duration_s) / max(steps, 1))
        rec = {"kind": "step", "step": int(step),
               "duration_ms": float(duration_s) * 1e3}
        if steps != 1:
            rec["steps"] = int(steps)
        if examples is not None:
            rec["examples"] = int(examples)
        rec.update(extra)
        self.records.append(rec)
        return True

    def step_records(self) -> list:
        """The step records and events, in the order they came."""
        return list(self.records)


_telemetry = Telemetry()


def get() -> Telemetry:
    return _telemetry


def reset() -> Telemetry:
    """Start a fresh registry (tests)."""
    global _telemetry
    _telemetry = Telemetry()
    return _telemetry


def counter(name: str) -> Counter:
    return get().counter(name)


def gauge(name: str) -> Gauge:
    return get().gauge(name)


def histogram(name: str) -> Histogram:
    return get().histogram(name)


def span(name: str, **args) -> _Span:
    return get().span(name, **args)


def record_event(kind: str, **fields) -> bool:
    return get().record_event(kind, **fields)


def record_step(step: int, duration_s: float, **kw) -> bool:
    return get().record_step(step, duration_s, **kw)


_trace_ids = itertools.count()
_current_trace: contextvars.ContextVar = contextvars.ContextVar(
    "autodist_tpu_torch_trace_id", default=None)


def mint_trace_id() -> str:
    """A process-unique trace id: pid + a monotone counter."""
    return f"tr-{os.getpid():x}-{next(_trace_ids):04x}"


def current_trace_id() -> Optional[str]:
    """The ambient trace id (``None`` outside any trace context)."""
    return _current_trace.get()
