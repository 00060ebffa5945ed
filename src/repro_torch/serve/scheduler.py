"""Continuous-batching request scheduler for the serving engine
(vLLM/aphrodite-style).

``ServeScheduler`` holds a queue of in-flight generation requests and
advances ALL of them one token per :meth:`step` — requests join and
leave the shared decode loop mid-flight instead of one fixed batch
running to completion:

    waiting -> prefill -> decode -> { finished,
                                      preempted -> waiting -> ... }

Admission is gated twice: ``max_batch`` caps how many requests decode
concurrently, and a modeled KV-cache block budget (``kv_blocks`` blocks
of ``block_size`` token slots each, :func:`blocks_per_seq` per
sequence) caps how much cache the running set may occupy. When decode
growth exhausts the budget the most recently admitted request is
**preempted by recompute**: its device state is dropped, the request is
requeued at the head of the wait queue, and on re-admission its state
is rebuilt deterministically from the prompt and the tokens it already
produced — byte-identical continuation, never a duplicated or skipped
token (already-streamed chunks are tracked by ``Request.emitted``).

Every request's decode states live at the request's own batch size, so
the token stream of a request is bit-exact with a solo
``ServeEngine.generate`` run regardless of what else shares the loop
(per-row determinism of prefill/decode; the arrival-order hypothesis
suite asserts this).

Scheduler phases are recorded as tracer spans on the serving
endpoint's track (``waiting`` / ``prefill`` / ``decode`` /
``preempted``) when the scheduler is bound to an ``rpc.Server`` with a
tracer attached — ``serve --trace`` shows per-request timelines.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional

import numpy as np

#: admission-ordering policies a ServeScheduler understands
SCHED_POLICIES = ("fifo", "sjf")

#: request lifecycle states
WAITING = "waiting"
RUNNING = "running"
PREEMPTED = "preempted"
FINISHED = "finished"
CANCELLED = "cancelled"


def blocks_per_seq(prompt_len: int, generated: int, *,
                   block_size: int = 16) -> int:
    """KV-cache blocks one sequence occupies: the prompt plus every
    generated token, in ``block_size``-token blocks (the paged-KV
    accounting unit — a partially filled block still occupies a whole
    block)."""
    assert prompt_len >= 1 and generated >= 0 and block_size >= 1
    return -(-(prompt_len + generated) // block_size)


class Request:
    """One generation request in the scheduler: a (B, S) prompt block
    decoding ``max_new_tokens`` steps. ``tokens`` holds every produced
    (B,) step vector; ``emitted`` counts how many of them the consumer
    (the rpc stream pump, or ``run``) has taken — preemption never
    rewinds it, so re-derived tokens are not re-delivered."""

    __slots__ = ("id", "prompts", "max_new_tokens", "rows",
                 "prompt_len", "tokens", "emitted", "state", "runtime",
                 "pump", "_phase_t0")

    def __init__(self, rid: int, prompts: np.ndarray,
                 max_new_tokens: int):
        B, S = prompts.shape
        self.id = rid
        self.prompts = prompts
        self.max_new_tokens = int(max_new_tokens)
        self.rows, self.prompt_len = int(B), int(S)
        self.tokens: List[np.ndarray] = []
        self.emitted = 0
        self.state = WAITING
        self.runtime: Any = None      # engine-owned device state
        self.pump: Any = None         # rpc.StreamPump when rpc-routed
        self._phase_t0 = 0.0

    @property
    def generated(self) -> int:
        return len(self.tokens)

    @property
    def finished(self) -> bool:
        return self.state == FINISHED

    def blocks(self, *, block_size: int, extra: int = 0) -> int:
        """Blocks this request's ``rows`` sequences occupy with
        ``extra`` more generated tokens per row."""
        return self.rows * blocks_per_seq(self.prompt_len,
                                          self.generated + extra,
                                          block_size=block_size)


class ServeScheduler:
    """The per-endpoint continuous-batching loop. ``engine`` provides
    the model ops (``scheduler_prefill`` / ``scheduler_decode`` /
    ``scheduler_rebuild``); the scheduler owns admission, preemption,
    and per-request token delivery.

    ``kv_blocks=None`` disables the cache budget (admission is then
    capped by ``max_batch`` alone). The budget must fit at least one
    sequence: a lone over-budget request still runs — a scheduler that
    preempted its only request would livelock.

    ``policy`` orders admission from the wait queue: ``"fifo"``
    (arrival order, the default) or ``"sjf"`` — shortest-prompt-first
    with FIFO tiebreak, which cuts mean queueing delay under
    heavy-tailed prompt lengths at the cost of delaying long prompts.
    Two guards keep SJF safe: preempted requests always resume before
    fresh admissions (their recompute debt only grows while they
    wait), and a request whose wait exceeds ``starvation_age_s``
    regains strict FIFO priority (the starvation escape hatch — a
    stream of short prompts can otherwise park a long one forever)."""

    def __init__(self, engine, *, max_batch: int = 8,
                 kv_blocks: Optional[int] = None, block_size: int = 16,
                 policy: str = "fifo",
                 starvation_age_s: Optional[float] = None):
        assert max_batch >= 1, max_batch
        assert kv_blocks is None or kv_blocks >= 1, kv_blocks
        assert block_size >= 1, block_size
        if policy not in SCHED_POLICIES:
            raise ValueError(f"unknown scheduler policy {policy!r}; "
                             f"choose from {SCHED_POLICIES}")
        assert starvation_age_s is None or starvation_age_s >= 0.0
        self.engine = engine
        self.max_batch = max_batch
        self.kv_blocks = kv_blocks
        self.block_size = block_size
        self.policy = policy
        self.starvation_age_s = starvation_age_s
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        self.counters: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "finished": 0,
            "preempted": 0, "requeued": 0, "cancelled": 0, "steps": 0,
            "peak_running": 0, "peak_waiting": 0,
        }
        self._server = None          # rpc.Server this endpoint serves on
        self._next_id = 1

    # wiring -----------------------------------------------------------
    def bind(self, server) -> "ServeScheduler":
        """Adopt an ``rpc.Server``'s clock and tracer: phase spans land
        on its endpoint track, timestamps on the fabric clock."""
        self._server = server
        return self

    def _now(self) -> float:
        if self._server is not None:
            return self._server.clock()
        return time.perf_counter()

    def _span(self, req: Request, name: str, t0: float, t1: float,
              **attrs) -> None:
        srv = self._server
        if srv is None or req.pump is None or req.pump.frame is None:
            return
        tracer = srv.tracer
        if tracer is not None:
            tracer.server_span(req.pump.frame, srv.endpoint, name,
                               t0, t1, request=req.id, **attrs)

    def _enter_phase(self, req: Request, state: str) -> None:
        req.state = state
        req._phase_t0 = self._now()

    def _close_phase(self, req: Request, name: str, **attrs) -> None:
        self._span(req, name, req._phase_t0, self._now(), **attrs)

    # intake -----------------------------------------------------------
    def submit(self, prompts: np.ndarray,
               max_new_tokens: Optional[int] = None) -> Request:
        """Queue one (B, S) prompt block; it joins the decode loop at a
        later :meth:`step` when ``max_batch`` and the block budget
        admit it."""
        prompts = np.asarray(prompts)
        assert prompts.ndim == 2, prompts.shape
        mnt = max_new_tokens or self.engine.cfg.max_new_tokens
        S = prompts.shape[1]
        assert S + mnt <= self.engine.cfg.max_seq, \
            (S, mnt, self.engine.cfg.max_seq)
        req = Request(self._next_id, prompts, mnt)
        self._next_id += 1
        self._enter_phase(req, WAITING)
        self.waiting.append(req)
        self.counters["submitted"] += 1
        self.counters["peak_waiting"] = max(
            self.counters["peak_waiting"], len(self.waiting))
        return req

    def cancel(self, req: Request) -> None:
        """Evict a request whose consumer is gone (cancelled rpc call,
        expired deadline): drop device state, leave the loop."""
        if req.state in (FINISHED, CANCELLED):
            return
        self._close_phase(req,
                          "decode" if req.state == RUNNING else req.state)
        if req in self.running:
            self.running.remove(req)
        if req in self.waiting:
            self.waiting.remove(req)
        req.runtime = None
        req.state = CANCELLED
        self.counters["cancelled"] += 1

    # accounting -------------------------------------------------------
    def load(self) -> int:
        """Requests in the loop (running + waiting) — the load signal
        the ``scheduler_least_loaded`` dispatch policy reads via the
        metrics gauge."""
        return len(self.running) + len(self.waiting)

    def used_blocks(self, *, extra: int = 0) -> int:
        return sum(r.blocks(block_size=self.block_size, extra=extra)
                   for r in self.running)

    def _fits(self, req: Request) -> bool:
        if self.kv_blocks is None:
            return True
        if not self.running:
            return True          # a lone request always runs
        need = req.blocks(block_size=self.block_size, extra=1)
        return self.used_blocks(extra=1) + need <= self.kv_blocks

    def _next_index(self) -> int:
        """Index into ``waiting`` of the next request to admit.
        FIFO: the head. SJF: preempted requests first (resume debt),
        then any request past the starvation age (FIFO among those),
        then shortest prompt with FIFO (submit-id) tiebreak."""
        if self.policy == "fifo" or len(self.waiting) <= 1:
            return 0
        preempted = [i for i, r in enumerate(self.waiting)
                     if r.state == PREEMPTED]
        if preempted:
            return min(preempted,
                       key=lambda i: self.waiting[i].id)
        if self.starvation_age_s is not None:
            now = self._now()
            starved = [i for i, r in enumerate(self.waiting)
                       if now - r._phase_t0 >= self.starvation_age_s]
            if starved:
                return min(starved, key=lambda i: self.waiting[i].id)
        return min(range(len(self.waiting)),
                   key=lambda i: (self.waiting[i].prompt_len,
                                  self.waiting[i].id))

    # the shared decode step -------------------------------------------
    def step(self) -> int:
        """One tick of the continuous batch: admit/resume what fits,
        preempt on budget exhaustion, then advance every running
        request one token. Returns the number of tokens produced."""
        fresh: List[Request] = []
        # join: policy order, bounded by max_batch + kv budget (the
        # selected candidate not fitting blocks further admission —
        # no fill-around, so an almost-admitted request cannot starve)
        while self.waiting and len(self.running) < self.max_batch:
            idx = self._next_index()
            if not self._fits(self.waiting[idx]):
                break
            req = self.waiting[idx]
            del self.waiting[idx]
            resumed = req.state == PREEMPTED
            self._close_phase(req, WAITING if not resumed else PREEMPTED)
            t0 = self._now()
            if resumed:
                self.engine.scheduler_rebuild(req)
            else:
                tok = self.engine.scheduler_prefill(req)
                req.tokens.append(tok)
            self._span(req, "prefill", t0, self._now(),
                       resumed=resumed)
            self._enter_phase(req, RUNNING)
            self.running.append(req)
            self.counters["admitted"] += 1
            fresh.append(req)
        self.counters["peak_running"] = max(
            self.counters["peak_running"], len(self.running))
        # evict-by-recompute: decode growth is about to write one more
        # token per row; shed the most recent joiners until it fits
        while self.kv_blocks is not None and len(self.running) > 1 \
                and self.used_blocks(extra=1) > self.kv_blocks:
            victim = self.running.pop()
            self._close_phase(victim, "decode")
            victim.runtime = None
            if victim in fresh:
                fresh.remove(victim)
            self._enter_phase(victim, PREEMPTED)
            self.waiting.appendleft(victim)
            self.counters["preempted"] += 1
            self.counters["requeued"] += 1
        produced = 0
        for req in list(self.running):
            if req not in fresh:     # joiners produced theirs at prefill
                req.tokens.append(self.engine.scheduler_decode(req))
            produced += 1
            if req.generated >= req.max_new_tokens:
                self._close_phase(req, "decode")
                self.running.remove(req)
                req.runtime = None
                req.state = FINISHED
                self.counters["finished"] += 1
        if produced:
            self.counters["steps"] += 1
        return produced

    # consumers --------------------------------------------------------
    def stream_tokens(self, req: Request) -> Iterator[np.ndarray]:
        """Per-request token stream: yields each (B,) step vector in
        order, driving :meth:`step` when starved — the generator the
        rpc ``generate_stream`` pump wraps. Closing the generator
        early (cancelled call) evicts the request."""
        try:
            while True:
                if req.emitted < len(req.tokens):
                    tok = req.tokens[req.emitted]
                    req.emitted += 1
                    yield tok
                elif req.finished:
                    return
                elif req.state == CANCELLED:
                    return
                else:
                    self.step()
        finally:
            if not req.finished:
                self.cancel(req)

    def run(self, req: Request) -> np.ndarray:
        """Drive the loop until ``req`` finishes (other in-flight
        requests advance alongside); returns the (B, new) block."""
        while not req.finished:
            assert req.state != CANCELLED, "request was cancelled"
            self.step()
        req.emitted = req.generated
        return np.stack(req.tokens, axis=1)

    # reporting --------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        """Counters + live load, JSON-ready — surfaced in
        ``rpc_metrics`` via ``MetricsInterceptor.attach_gauges``."""
        out = dict(self.counters)
        out["running"] = len(self.running)
        out["waiting"] = len(self.waiting)
        out["used_blocks"] = self.used_blocks()
        out["policy"] = self.policy
        if self.kv_blocks is not None:
            out["kv_blocks"] = self.kv_blocks
        return out


__all__ = ["CANCELLED", "FINISHED", "PREEMPTED", "RUNNING", "Request",
           "SCHED_POLICIES", "ServeScheduler", "WAITING",
           "blocks_per_seq"]
