"""Shared retry/backoff policy: "try again, a little later, but not
forever".

The port's copy of ``autodist_tpu/runtime/retry.py``'s
:class:`RetryPolicy` and :func:`backoff_delay`: capped exponential
backoff, seeded jitter (deterministic in tests, de-synchronized in
production), a hard deadline and a typed "gave up" error.
:meth:`~autodist_tpu_torch.checkpoint.saver.Saver.save` retries a failed
write under it.  The policy never fires on success: the first attempt is
a plain call with no added latency.
"""
from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, Optional

_log = logging.getLogger(__name__)


def backoff_delay(attempt: int, base_s: float = 0.5,
                  cap_s: float = 60.0) -> float:
    """Capped exponential backoff for 1-based ``attempt``:
    base, 2*base, 4*base, ... <= cap (no jitter)."""
    return min(base_s * (2 ** (max(attempt, 1) - 1)), cap_s)


class RetryError(RuntimeError):
    """Retries exhausted (attempt budget or deadline); ``last`` is the
    final underlying exception, ``attempts`` how many times the
    operation actually ran."""

    def __init__(self, message: str, *, attempts: int,
                 last: Optional[BaseException] = None):
        super().__init__(message)
        self.attempts = attempts
        self.last = last


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + seeded jitter + deadline + retryable-error
    classification.

    ``seed`` makes the jitter sequence deterministic (tests pin exact
    delays); ``seed=None`` draws from the process RNG (production
    de-synchronization).  ``retryable`` classifies which exceptions are
    worth another attempt — a tuple of exception types or a predicate;
    anything else propagates immediately (a genuine bug must never be
    retried into a different stack trace).
    """

    max_attempts: int = 3
    base_delay_s: float = 0.5
    cap_delay_s: float = 60.0
    deadline_s: Optional[float] = None     # total budget across attempts
    jitter: float = 0.5                    # +/- fraction of each delay
    seed: Optional[int] = None
    retryable: object = (OSError,)         # types tuple or predicate

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    # ------------------------------------------------------------------ #
    def is_retryable(self, exc: BaseException) -> bool:
        if callable(self.retryable) and not isinstance(self.retryable,
                                                       type):
            return bool(self.retryable(exc))
        types = self.retryable if isinstance(self.retryable, tuple) \
            else (self.retryable,)
        return isinstance(exc, types)

    def delay_s(self, attempt: int) -> float:
        """The un-jittered delay after 1-based ``attempt``."""
        return backoff_delay(attempt, self.base_delay_s, self.cap_delay_s)

    def max_total_delay_s(self) -> float:
        """Worst-case sleep across every retry (jitter at its
        maximum)."""
        return sum(self.delay_s(a) * (1.0 + self.jitter)
                   for a in range(1, self.max_attempts))

    def delays(self) -> list[float]:
        """The jittered delay schedule (one entry per retry, i.e.
        ``max_attempts - 1`` entries) — deterministic under a fixed
        ``seed``."""
        rng = random.Random(self.seed)
        return [self._jittered(a, rng)
                for a in range(1, self.max_attempts)]

    def _jittered(self, attempt: int, rng: random.Random) -> float:
        delay = self.delay_s(attempt)
        if self.jitter:
            delay *= 1.0 + self.jitter * (rng.random() * 2.0 - 1.0)
        return max(delay, 0.0)

    # ------------------------------------------------------------------ #
    def call(self, fn: Callable, *args,
             describe: str = "",
             on_retry: Optional[Callable] = None,
             sleep: Callable[[float], None] = time.sleep,
             clock: Callable[[], float] = time.monotonic,
             **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying retryable failures under
        this policy.  Success on the first attempt is a single plain
        call — no RNG draw, no sleep, no telemetry.  Gives up with
        :class:`RetryError` when the attempt budget or ``deadline_s`` is
        exhausted; non-retryable exceptions propagate unwrapped.
        ``on_retry(attempt, delay_s, exc)`` observes each scheduled
        retry (logging/telemetry hooks)."""
        name = describe or getattr(fn, "__name__", "operation")
        rng = None
        start = clock() if self.deadline_s is not None else None
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — classified below
                if not self.is_retryable(e):
                    raise
                if attempt >= self.max_attempts:
                    raise RetryError(
                        f"{name}: gave up after {attempt} attempt(s): "
                        f"{type(e).__name__}: {e}",
                        attempts=attempt, last=e) from e
                if rng is None:          # first failure: arm the jitter
                    rng = random.Random(self.seed)
                delay = self._jittered(attempt, rng)
                if self.deadline_s is not None \
                        and clock() - start + delay > self.deadline_s:
                    raise RetryError(
                        f"{name}: deadline of {self.deadline_s}s "
                        f"exhausted after {attempt} attempt(s): "
                        f"{type(e).__name__}: {e}",
                        attempts=attempt, last=e) from e
                _log.warning(
                    "%s failed (attempt %d/%d), retrying in %.3fs: %s",
                    name, attempt, self.max_attempts, delay, e)
                if on_retry is not None:
                    on_retry(attempt, delay, e)
                sleep(delay)
