"""Continuous batching: a request queue feeding the decode windows.

Counterpart of ``autodist_tpu/serving/batcher.py``, unchanged in
behaviour: requests of ragged lengths share one slot batch — slots that
are empty or whose request already finished ride along masked
(``active=False`` holds their state).  A request's life:

    submit() → queue → slot admission (batched prefill; TTFT stops
    here — the prefill emits the first token) → decode windows
    (``decode_steps`` tokens each) → eviction on EOS, token budget, or
    the cache's ``max_len`` → slot freed for the next admission.

Because every slot's computation depends only on its own cache lane and
token, a request decodes the exact same tokens whether it runs alone or
interleaved with arrivals and departures.

Telemetry goes to the port's in-memory sink
(:mod:`autodist_tpu_torch.telemetry`): ``serve/ttft_ms`` and
``serve/inter_token_ms`` histograms (a window attributes ``window/K``
to each of its tokens), the ``serve/queue_depth`` gauge,
``serve/requests``/``serve/tokens`` counters, and one ``kind="serve"``
event per completed request, carrying the engine's ``kv_layout``.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Optional

import numpy as np

from autodist_tpu_torch import telemetry


class OverloadedError(RuntimeError):
    """The admission queue is full: the request was *shed* (coded —
    ``serve/shed`` counter) instead of queued into unbounded latency.
    Callers back off and resubmit; a router routes to another replica."""

    code = "serve/overloaded"


# Every way a request can end.  The first three are the classic decode
# terminals; the rest are the graceful-degradation terminals (deadline
# pressure, overload shedding, engine drain, caller-side cancellation —
# the router's hedge loser) — absent entirely when no
# deadline/queue-bound/drain/cancel is in play.
FINISH_REASONS = ("eos", "max_tokens", "max_len", "deadline_exceeded",
                  "shed", "drained", "cancelled")


@dataclasses.dataclass
class Request:
    """One generation request (token ids in, token ids out)."""

    rid: str
    prompt: list
    max_new_tokens: int
    eos_id: Optional[int] = None
    submit_s: float = 0.0
    deadline_s: Optional[float] = None   # absolute (perf_counter) deadline
    # Sampling seed (engines with temperature > 0): the per-request key
    # the gumbel-max epilogue folds per emitted token, so a request
    # decodes the same stream wherever/whenever it runs (the
    # interleave-parity contract extended to sampling).  Ignored by
    # greedy engines.
    seed: int = 0
    # Distributed-trace id minted at the fleet edge (Router.submit) and
    # carried through every record/span this request touches — None for
    # untraced standalone use.
    trace_id: Optional[str] = None


@dataclasses.dataclass
class Completion:
    """A finished request's output + its latency facts."""

    rid: str
    tokens: list                 # generated ids (EOS included when hit)
    finish_reason: str           # one of FINISH_REASONS
    ttft_s: float                # submit -> first token available
    queue_wait_s: float          # submit -> slot admission
    decode_s: float              # first token -> last token
    inter_token_ms: list         # per-token latency (window/K attributed)
    # Throughput-ladder facts (all zero off the respective rungs):
    # pool blocks the request's prefix shared instead of allocating,
    # draft tokens proposed/accepted across its windows, and prefill
    # dispatches its prompt took (1 single-shot; ceil(len/C) chunked).
    prefix_hit_blocks: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    prefill_chunks: int = 1
    trace_id: Optional[str] = None

    @property
    def tokens_per_sec(self) -> Optional[float]:
        total = self.ttft_s + self.decode_s
        return len(self.tokens) / total if total > 0 and self.tokens \
            else None


@dataclasses.dataclass
class _Slot:
    req: Request
    tokens: list
    admitted_s: float
    first_tok_s: float
    inter_token_ms: list
    done: Optional[str] = None   # finish reason once terminal
    prefix_hit_blocks: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    prefill_chunks: int = 1


class ContinuousBatcher:
    """Drives a :class:`~autodist_tpu_torch.serving.engine.ServingEngine`
    from a request queue with slot allocation and eviction."""

    def __init__(self, engine, *, max_queue: Optional[int] = None):
        """``max_queue`` bounds the admission queue: a submit beyond it
        is shed with a coded :class:`OverloadedError` (+ ``serve/shed``
        counter) instead of queueing into unbounded latency.  ``None``
        (default) keeps today's unbounded queue byte-identically."""
        self.engine = engine
        self.max_queue = max_queue
        self._queue: deque[Request] = deque()
        self._slots: list[Optional[_Slot]] = [None] * engine.num_slots
        self._ids = itertools.count()
        self._draining = False
        self.completions: dict[str, Completion] = {}

    # ------------------------------------------------------------------ #
    def submit(self, prompt, *, max_new_tokens: int = 16,
               eos_id: Optional[int] = None, rid: Optional[str] = None,
               deadline_s: Optional[float] = None, seed: int = 0,
               trace_id: Optional[str] = None) -> str:
        """Queue one request; returns its id.  Prompts must fit the
        engine's prompt bucket; a budget exceeding the cache capacity
        is accepted but the request truncates at capacity
        (``finish_reason="max_len"``).

        ``deadline_s`` (seconds from now) bounds the request's total
        latency: a request still queued — or still decoding — past its
        deadline completes with ``finish_reason="deadline_exceeded"``
        and whatever tokens it has (queued requests get none), instead
        of silently burning slot time nobody is waiting for.

        ``seed`` keys this request's sampled stream on a
        temperature > 0 engine (greedy engines ignore it).

        ``trace_id`` tags the request's records and spans with a
        distributed-trace id (defaults to the ambient trace context
        when one is active)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        cap = self.engine.max_prompt_tokens
        if len(prompt) > cap:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the engine's "
                f"admissible {cap} (prefill_len="
                f"{self.engine.prefill_len}; chunked prefill lifts the "
                "bucket to the whole context)")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        if self._draining:
            telemetry.counter("serve/shed").inc()
            raise OverloadedError(
                f"[{OverloadedError.code}] batcher is draining; "
                "resubmit to another replica")
        if self.max_queue is not None \
                and len(self._queue) >= self.max_queue:
            telemetry.counter("serve/shed").inc()
            raise OverloadedError(
                f"[{OverloadedError.code}] admission queue full "
                f"({len(self._queue)}/{self.max_queue}); backing off "
                "and resubmitting is the caller's move")
        rid = rid if rid is not None else f"req-{next(self._ids)}"
        if trace_id is None:
            trace_id = telemetry.current_trace_id()
        now = time.perf_counter()
        self._queue.append(Request(
            rid=rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
            eos_id=eos_id, submit_s=now,
            deadline_s=now + deadline_s if deadline_s is not None
            else None, seed=int(seed), trace_id=trace_id))
        telemetry.gauge("serve/queue_depth").set(len(self._queue))
        return rid

    @property
    def active_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def queue_depth(self) -> int:
        """Queued-but-unadmitted requests — with :attr:`active_slots`,
        the load signal the fleet router dispatches on."""
        return len(self._queue)

    def cancel(self, rid: str) -> bool:
        """Withdraw a live request wherever it is: still queued — it
        completes ``"cancelled"`` with no tokens; in flight — its slot
        is evicted NOW (tokens decoded so far kept on the completion,
        paged blocks back on the free list immediately — a hedge
        loser's reservation must not outlive the race it lost).
        Returns False when ``rid`` is not live (already completed, or
        never submitted)."""
        for req in self._queue:
            if req.rid == rid:
                self._queue.remove(req)
                now = time.perf_counter()
                telemetry.counter("serve/cancelled").inc()
                self._finish(req, tokens=[], reason="cancelled",
                             ttft_s=now - req.submit_s,
                             queue_wait_s=now - req.submit_s,
                             decode_s=0.0, inter_token_ms=[])
                telemetry.gauge("serve/queue_depth").set(len(self._queue))
                return True
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.req.rid == rid:
                if slot.done is None:
                    slot.done = "cancelled"
                    telemetry.counter("serve/cancelled").inc()
                self._evict(i)
                return True
        return False

    # ------------------------------------------------------------------ #
    def _expire_queued(self):
        """Complete queued requests already past their deadline — a
        request nobody is waiting for anymore must not win a slot over
        one somebody is.  No-op when no request carries a deadline."""
        now = time.perf_counter()
        kept: deque[Request] = deque()
        expired = False
        for req in self._queue:
            if req.deadline_s is not None and now >= req.deadline_s:
                expired = True
                telemetry.counter("serve/deadline_exceeded").inc()
                self._finish(req, tokens=[], reason="deadline_exceeded",
                             ttft_s=now - req.submit_s,
                             queue_wait_s=now - req.submit_s,
                             decode_s=0.0, inter_token_ms=[])
            else:
                kept.append(req)
        if expired:
            self._queue = kept
            telemetry.gauge("serve/queue_depth").set(len(self._queue))

    def _expire_slots(self):
        """Mark in-flight slots past their deadline terminal (tokens
        decoded so far are kept — partial output beats none at the
        deadline)."""
        now = time.perf_counter()
        for slot in self._slots:
            if slot is not None and slot.done is None \
                    and slot.req.deadline_s is not None \
                    and now >= slot.req.deadline_s:
                telemetry.counter("serve/deadline_exceeded").inc()
                slot.done = "deadline_exceeded"

    def _admit(self):
        """Fill free slots from the queue with ONE batched prefill.

        Under the paged KV layout admission gates on **free blocks, not
        slots**: a request enters only when its ``prompt + budget``
        block reservation fits the free pool (FIFO, head-of-line — a
        big request at the head waits rather than being jumped, so the
        admission order, and with it the parity contract, stays
        deterministic).  Dense engines keep the slots-only predicate
        byte-identically (``blocks_needed`` is 0)."""
        self._expire_queued()
        free = [i for i, s in enumerate(self._slots) if s is None]
        if not free or not self._queue:
            return
        B = self.engine.num_slots
        S = self.engine.max_prompt_tokens
        prompts = np.zeros((B, S), np.int32)
        p_lens = np.ones((B,), np.int32)
        admit = np.zeros((B,), bool)
        seeds = np.zeros((B,), np.int32)
        taken: list[tuple[int, Request, int]] = []
        for i in free:
            if not self._queue:
                break
            head = self._queue[0]
            # Prefix caching prices the head's prompt at its NOVEL
            # suffix: shared leading blocks are free, so an engine
            # whose pool is full of popular prefixes still admits.
            needed = self.engine.blocks_needed(len(head.prompt),
                                               head.max_new_tokens,
                                               prompt=head.prompt)
            if needed > self.engine.free_blocks:
                break   # pool-bound: the head request waits its turn
            req = self._queue.popleft()
            hits = self.engine.reserve_slot(i, len(req.prompt),
                                            req.max_new_tokens,
                                            prompt=req.prompt)
            if hits:
                telemetry.counter("serve/prefix_hit_blocks").inc(hits)
            prompts[i, :len(req.prompt)] = req.prompt
            p_lens[i] = len(req.prompt)
            admit[i] = True
            seeds[i] = req.seed
            taken.append((i, req, hits))
        telemetry.gauge("serve/queue_depth").set(len(self._queue))
        if not taken:
            return
        now = time.perf_counter()
        tids = [req.trace_id for _, req, _ in taken if req.trace_id]
        try:
            with telemetry.span("serve/prefill", admitted=len(taken),
                                **({"trace_ids": tids} if tids else {})):
                toks = self.engine.prefill(prompts, p_lens, admit,
                                           seeds=seeds)
        except Exception:
            # The engine died mid-prefill (a crashed replica): the
            # reservations made above have no slot to be evicted from —
            # without this release they would strand pool blocks
            # forever in a batcher that outlives the error.  Requests
            # go back to the queue head (original order) so a
            # router-side drain/failover can re-dispatch them.
            for i, req, _hits in reversed(taken):
                self.engine.release_slot(i)
                self._queue.appendleft(req)
            telemetry.gauge("serve/queue_depth").set(len(self._queue))
            raise
        t_first = time.perf_counter()
        chunk = self.engine.prefill_chunk
        for i, req, hits in taken:
            slot = _Slot(req=req, tokens=[int(toks[i])], admitted_s=now,
                         first_tok_s=t_first, inter_token_ms=[],
                         prefix_hit_blocks=hits,
                         prefill_chunks=(-(-len(req.prompt) // chunk)
                                         if chunk else 1))
            ttft = t_first - req.submit_s
            telemetry.histogram("serve/ttft_ms").observe(ttft * 1e3)
            telemetry.counter("serve/tokens").inc()
            self._slots[i] = slot
            self._check_terminal(i)

    def _check_terminal(self, i: int):
        """Mark slot ``i`` done on EOS / token budget / cache capacity
        (truncating anything decoded past the terminal token).  Both
        caps apply BEFORE the EOS scan: an EOS landing beyond
        ``max_new_tokens`` — or beyond the cache capacity, where the
        window's clamped writes have already corrupted the last lane —
        within the same fused window must not stretch the request."""
        slot = self._slots[i]
        req = slot.req
        # tokens decoded while every prior token still fit a cache lane
        cap = max(1, self.engine.max_len - len(req.prompt))
        limit = min(req.max_new_tokens, cap)
        budgeted = slot.tokens[:limit]
        if req.eos_id is not None and req.eos_id in budgeted:
            slot.tokens = budgeted[:budgeted.index(req.eos_id) + 1]
            slot.done = "eos"
        elif len(slot.tokens) >= limit:
            slot.tokens = budgeted
            slot.done = ("max_tokens" if limit == req.max_new_tokens
                         else "max_len")

    def _finish(self, req: Request, *, tokens: list, reason: str,
                ttft_s: float, queue_wait_s: float, decode_s: float,
                inter_token_ms: list, prefix_hit_blocks: int = 0,
                spec_proposed: int = 0, spec_accepted: int = 0,
                prefill_chunks: int = 1) -> Completion:
        """The ONE completion path: record, count, and file the
        :class:`Completion` — used by slot eviction, queued-deadline
        expiry, and drain shedding alike, so every request that ever
        entered ``submit`` leaves exactly one completion + one
        ``kind="serve"`` record (no in-flight request is ever
        stranded)."""
        comp = Completion(
            rid=req.rid, tokens=list(tokens), finish_reason=reason,
            ttft_s=ttft_s, queue_wait_s=queue_wait_s, decode_s=decode_s,
            inter_token_ms=list(inter_token_ms),
            prefix_hit_blocks=int(prefix_hit_blocks),
            spec_proposed=int(spec_proposed),
            spec_accepted=int(spec_accepted),
            prefill_chunks=int(prefill_chunks),
            trace_id=req.trace_id)
        self.completions[req.rid] = comp
        telemetry.counter("serve/requests").inc()
        itl = np.asarray(comp.inter_token_ms) if comp.inter_token_ms \
            else None
        telemetry.get().record_event(
            "serve", request=req.rid,
            prompt_tokens=len(req.prompt), tokens=len(comp.tokens),
            kv_layout=self.engine.kv_layout,
            finish=comp.finish_reason,
            ttft_ms=comp.ttft_s * 1e3,
            queue_wait_ms=comp.queue_wait_s * 1e3,
            inter_token_p50_ms=(float(np.percentile(itl, 50))
                                if itl is not None else None),
            inter_token_p99_ms=(float(np.percentile(itl, 99))
                                if itl is not None else None),
            tokens_per_sec=comp.tokens_per_sec,
            prefix_hit_blocks=comp.prefix_hit_blocks,
            spec_proposed=comp.spec_proposed,
            spec_accepted=comp.spec_accepted,
            prefill_chunks=comp.prefill_chunks,
            **({"trace_id": req.trace_id} if req.trace_id else {}))
        return comp

    def _evict(self, i: int):
        slot = self._slots[i]
        req = slot.req
        t_end = time.perf_counter()
        self._slots[i] = None
        # Paged: the freed blocks go back on the free list immediately,
        # so the next admission round can hand them to a queued request
        # (the block-recycling edge the paged parity goldens pin).
        self.engine.release_slot(i)
        self._finish(req, tokens=slot.tokens, reason=slot.done,
                     ttft_s=slot.first_tok_s - req.submit_s,
                     queue_wait_s=slot.admitted_s - req.submit_s,
                     decode_s=t_end - slot.first_tok_s,
                     inter_token_ms=slot.inter_token_ms,
                     prefix_hit_blocks=slot.prefix_hit_blocks,
                     spec_proposed=slot.spec_proposed,
                     spec_accepted=slot.spec_accepted,
                     prefill_chunks=slot.prefill_chunks)

    def _decode_window(self):
        """One fused decode dispatch; distribute tokens, evict terminal
        slots."""
        active = np.array([s is not None and s.done is None
                           for s in self._slots], bool)
        if not active.any():
            return
        K = self.engine.decode_steps
        t0 = time.perf_counter()
        tids = [s.req.trace_id for s, a in zip(self._slots, active)
                if a and s is not None and s.req.trace_id]
        with telemetry.span("serve/decode", tokens=int(active.sum()) * K,
                            **({"trace_ids": tids} if tids else {})):
            w = self.engine.decode_window(active)
        toks, counts = w.tokens, w.counts
        proposed, accepted = w.spec_proposed, w.spec_accepted
        dt = time.perf_counter() - t0
        per_tok_ms = dt / max(int(np.max(counts)), 1) * 1e3
        for i, slot in enumerate(self._slots):
            if slot is None or not active[i]:
                continue
            before = len(slot.tokens)
            slot.tokens.extend(int(toks[k, i])
                               for k in range(int(counts[i])))
            slot.spec_proposed += int(proposed[i])
            slot.spec_accepted += int(accepted[i])
            if proposed[i]:
                telemetry.counter("serve/spec_proposed").inc(
                    int(proposed[i]))
                telemetry.counter("serve/spec_accepted").inc(
                    int(accepted[i]))
            self._check_terminal(i)
            # Only tokens the request actually keeps count: a window's
            # over-decode past EOS/budget is discarded above, and the
            # counters/histograms must agree with the per-request
            # serve records the report aggregates.
            kept = max(0, len(slot.tokens) - before)
            slot.inter_token_ms.extend([per_tok_ms] * kept)
            for _ in range(kept):
                telemetry.histogram("serve/inter_token_ms").observe(
                    per_tok_ms)
            telemetry.counter("serve/tokens").inc(kept)

    # ------------------------------------------------------------------ #
    def step(self):
        """One scheduler round: expire deadlines, evict finished,
        admit, decode."""
        self._expire_slots()
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.done is not None:
                self._evict(i)
        if not self._draining:
            self._admit()
        self._decode_window()

    def run(self) -> dict[str, Completion]:
        """Drain the queue and every in-flight request; returns
        ``{rid: Completion}`` for the requests finished DURING this
        call (a long-lived server loop calling ``run()`` per admission
        round must not re-receive old completions; the full history
        stays on :attr:`completions`)."""
        before = set(self.completions)
        while self._queue or self.active_slots:
            self.step()
        return {rid: c for rid, c in self.completions.items()
                if rid not in before}

    def drain(self, *, finish_in_flight: bool = True
              ) -> dict[str, Completion]:
        """Wind the batcher down without admitting new work — the
        explicit semantics for evicting an engine (a re-election, a
        preemption, a rolling restart): queued-but-unadmitted requests
        complete as ``"shed"`` (resubmittable elsewhere — no token was
        ever produced for them), in-flight slots either decode to their
        natural terminal (``finish_in_flight=True``) or are cut at
        their current token as ``"drained"``.  Either way NO in-flight
        slot is stranded: every submitted request ends in exactly one
        completion.  Subsequent ``submit`` calls shed with
        :class:`OverloadedError`.  Returns the completions this call
        produced."""
        before = set(self.completions)
        self._draining = True
        now = time.perf_counter()
        while self._queue:
            req = self._queue.popleft()
            telemetry.counter("serve/shed").inc()
            self._finish(req, tokens=[], reason="shed",
                         ttft_s=now - req.submit_s,
                         queue_wait_s=now - req.submit_s,
                         decode_s=0.0, inter_token_ms=[])
        telemetry.gauge("serve/queue_depth").set(0)
        if finish_in_flight:
            while self.active_slots:
                self.step()
        else:
            for i, slot in enumerate(self._slots):
                if slot is not None:
                    if slot.done is None:
                        slot.done = "drained"
                    self._evict(i)
        return {rid: c for rid, c in self.completions.items()
                if rid not in before}
