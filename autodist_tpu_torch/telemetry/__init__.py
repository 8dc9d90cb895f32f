"""In-memory telemetry: what the continuous batcher and engine record.

A minimal copy of ``autodist_tpu/telemetry``'s surface — ``counter``,
``gauge`` and ``histogram`` (``.inc`` / ``.set`` / ``.observe``),
``span``, ``get().record_event``, ``current_trace_id`` and
``mint_trace_id`` — kept in process memory.  Sinks, flushing,
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
        self.events: deque = deque(maxlen=_EVENT_LIMIT)

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self.histograms.setdefault(name, Histogram())

    def span(self, name: str, **args) -> _Span:
        return _Span(self.spans, name, args)

    def record_event(self, kind: str, **fields) -> bool:
        self.events.append({"kind": kind, **fields})
        return True


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


_trace_ids = itertools.count()
_current_trace: contextvars.ContextVar = contextvars.ContextVar(
    "autodist_tpu_torch_trace_id", default=None)


def mint_trace_id() -> str:
    """A process-unique trace id: pid + a monotone counter."""
    return f"tr-{os.getpid():x}-{next(_trace_ids):04x}"


def current_trace_id() -> Optional[str]:
    """The ambient trace id (``None`` outside any trace context)."""
    return _current_trace.get()
