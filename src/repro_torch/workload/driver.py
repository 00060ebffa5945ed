"""Open-loop trace driver over the serve stack.

The paper's benchmarks are closed-loop: each client waits for its
reply before issuing the next request, so the offered load collapses
to whatever the server sustains and queueing never builds. This driver
is the opposite regime — it fires every :class:`TraceEvent` at its
scheduled arrival time on the modeled clock *without waiting for
completions*, which is the only way to observe tail latency, shedding,
admission rejection, and preemption under overload.

Pacing rides the fabric's bounded flush: for each event the driver
runs ``fabric.flush(until_s=t)`` (drive in-flight work up to the
arrival time, leave the rest pending), advances the modeled clock
across any idle gap, submits through the ordinary serve stubs
(:class:`ShardedServeStub` over a cluster transport — the same
dispatch, failover, retry, and admission path production calls take),
then moves on. One final unbounded flush drains the tail. On a
non-modeled transport there is no clock to pace against, so the driver
degrades to immediate mode: submit everything in arrival order, flush
once (arrival time := scheduled time still, so SLO numbers remain
comparable).

Serving is model-free: :class:`SyntheticEngine` implements the
scheduler's model ops (prefill/decode/rebuild) in pure numpy, with
token t of a request a deterministic function of its prompt — the same
recipe the scheduler's own test double uses, so replay identity can be
asserted to the byte without touching jax.

Per-request ground truth comes from :class:`WorkloadRecorder`, a
client interceptor installed *outermost* so it sees exactly one
terminal event per request (inner retry/failover interceptors consume
non-terminal failures first). Records are keyed through
``ctx.meta["workload_event"]``, which survives retries and shard
re-routes because the fabric reuses one ``CallContext`` across
attempts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.rpc.interceptors import ClientInterceptor

from .slo import SloReport, build_slo_report
from .trace import Trace, TraceEvent


class SyntheticEngine:
    """Numpy-only stand-in for ``ServeEngine``'s scheduler ops.

    Token ``t`` of a request is ``prompts.sum() % 997 + 7*t`` — a pure
    function of the prompt, so any two runs of the same trace must
    produce byte-identical token streams (the replay-identity check),
    and ``expected_tokens`` can verify a completed request without
    rerunning anything.
    """

    class _Cfg:
        def __init__(self, max_seq: int, max_new_tokens: int):
            self.max_seq = max_seq
            self.max_new_tokens = max_new_tokens

    def __init__(self, *, max_seq: int = 4096,
                 max_new_tokens: int = 4):
        self.cfg = self._Cfg(max_seq, max_new_tokens)
        self.prefills = self.decodes = self.rebuilds = 0

    def _tok(self, req, t: int) -> np.ndarray:
        base = int(req.prompts.sum()) % 997
        return np.full(req.rows, base + 7 * t, dtype=np.int32)

    def scheduler_prefill(self, req) -> np.ndarray:
        self.prefills += 1
        req.runtime = ("state", 0)
        return self._tok(req, 0)

    def scheduler_decode(self, req) -> np.ndarray:
        self.decodes += 1
        req.runtime = ("state", len(req.tokens))
        return self._tok(req, len(req.tokens))

    def scheduler_rebuild(self, req) -> None:
        self.rebuilds += 1
        req.runtime = ("state", len(req.tokens) - 1)

    @staticmethod
    def expected_tokens(prompts: np.ndarray, n: int) -> np.ndarray:
        """The (n,) per-step token values a request with this prompt
        block must stream (all rows carry the same value)."""
        base = int(prompts.sum()) % 997
        return base + 7 * np.arange(n, dtype=np.int64)


def materialize_prompts(seed: int, event: TraceEvent) -> np.ndarray:
    """The (rows, prompt_len) int32 prompt block for one event —
    seeded per-event off the trace seed, so replaying a trace presents
    byte-identical payloads without the trace storing them."""
    rng = np.random.default_rng([seed, event.id])
    return rng.integers(1, 997, size=(event.rows, event.prompt_len),
                        dtype=np.int32)


class WorkloadRecorder(ClientInterceptor):
    """Outermost client interceptor: one record per workload event,
    stamped on the fabric clock. Non-workload calls (anything without
    ``ctx.meta['workload_event']``) pass through untouched."""

    def __init__(self, fabric):
        self.fabric = fabric
        self.records: Dict[int, dict] = {}

    def expect(self, event: TraceEvent, submit_s: float) -> None:
        self.records[event.id] = {
            "id": event.id, "arrival_s": event.t_s,
            "submit_s": submit_s, "first_chunk_s": None,
            "end_s": None, "chunks": 0, "attempts": 1,
            "ok": None, "outcome": "pending",
        }

    def _rec(self, ctx) -> Optional[dict]:
        eid = ctx.meta.get("workload_event")
        return None if eid is None else self.records.get(eid)

    def on_event(self, ctx, event) -> None:
        rec = self._rec(ctx)
        if rec is None:
            return
        if event.kind == "stream_chunk":
            rec["chunks"] += 1
            if rec["first_chunk_s"] is None:
                rec["first_chunk_s"] = self.fabric.now()

    def on_complete(self, ctx, event):
        rec = self._rec(ctx)
        if rec is None:
            return None
        rec["end_s"] = ctx.end_s if ctx.end_s is not None \
            else self.fabric.now()
        rec["attempts"] = ctx.attempts
        rec["ok"] = bool(event.ok)
        rec["outcome"] = ("deadline_exceeded"
                          if event.kind == "deadline_exceeded"
                          else "ok" if event.ok else "error")
        return None


@dataclass
class WorkloadRun:
    """Everything a caller needs after a run: the per-request ground
    truth, the folded SLO report, and the live fabric (metrics,
    tracer, schedulers) for deeper digging."""
    trace: Trace
    records: List[dict]
    report: SloReport
    fabric: object
    metrics: object
    schedulers: Dict[str, object] = field(default_factory=dict)
    stubs: Dict[str, object] = field(default_factory=dict)

    def completion_times(self) -> Dict[int, Optional[float]]:
        """event id -> completion time on the modeled clock (None for
        requests that never completed) — the replay-identity probe."""
        return {r["id"]: r["end_s"] for r in self.records}


def _check_fits(trace: Trace, engine: SyntheticEngine) -> None:
    worst = max((e.prompt_len
                 + (e.max_new_tokens or engine.cfg.max_new_tokens)
                 for e in trace.events), default=0)
    if worst > engine.cfg.max_seq:
        raise ValueError(
            f"trace needs sequences up to {worst} tokens but the "
            f"synthetic engine caps at max_seq={engine.cfg.max_seq}; "
            f"regenerate with shorter lengths or raise max_seq")


def run_trace(trace: Trace, fabric, stubs: Dict[str, object], *,
              deadline_s: Optional[float] = None,
              stream: bool = True) -> WorkloadRecorder:
    """Fire the trace open-loop: ``stubs`` maps submitting worker
    names to serve stubs (``ShardedServeStub`` or a generated serve
    stub); ``event.worker`` picks the submitter (-1 = round-robin by
    event id). Returns the recorder holding per-event records."""
    recorder = WorkloadRecorder(fabric)
    fabric.client_interceptors.insert(0, recorder)
    workers = sorted(stubs)
    transport = fabric.transport
    modeled = bool(getattr(transport, "modeled", False)) \
        and hasattr(transport, "clock_s")
    try:
        for ev in trace.events:
            if modeled:
                fabric.flush(until_s=ev.t_s)
                if transport.clock_s < ev.t_s:
                    # idle gap: nothing in flight reaches the arrival,
                    # so jump the modeled clock to it
                    transport.clock_s = ev.t_s
            stub = stubs[workers[ev.worker if ev.worker >= 0
                                 else ev.id % len(workers)]]
            prompts = materialize_prompts(trace.seed, ev)
            method = (stub.generate_stream if stream
                      else stub.generate)
            handle = method(prompts, ev.max_new_tokens,
                            deadline_s=deadline_s)
            recorder.expect(ev, fabric.now())
            ctx = fabric.context(handle.call_id)
            assert ctx is not None, "submit must create a context"
            ctx.meta["workload_event"] = ev.id
        fabric.flush()           # drain the tail, unbounded
    finally:
        fabric.client_interceptors.remove(recorder)
    return recorder


def serve_workload(trace: Trace, *,
                   cluster=None, n_ps: int = 1, n_workers: int = 2,
                   dispatch_policy: str = "round_robin",
                   sched_policy: str = "fifo",
                   starvation_age_s: Optional[float] = None,
                   max_batch: int = 8,
                   kv_blocks: Optional[int] = None,
                   block_size: int = 16,
                   deadline_s: Optional[float] = None,
                   retry_attempts: int = 4,
                   stream: bool = True,
                   max_seq: int = 4096,
                   max_new_tokens: int = 4,
                   fault: Optional[dict] = None,
                   tracer=None) -> WorkloadRun:
    """One-call workload run: build a PS/worker cluster fabric serving
    a :class:`SyntheticEngine` through real per-endpoint
    ``ServeScheduler``\\ s, fire ``trace`` open-loop, and fold the SLO
    report.

    ``cluster`` is any ``rpc.ClusterSpec``-coercible (default: a
    ``ps_worker_cluster(n_ps, n_workers)``). ``fault`` passes
    ``FaultInjectionTransport`` kwargs; the trace's own
    ``fault_windows`` are merged in as correlated burst-loss windows,
    so a recorded trace replays its fault schedule too.
    """
    from repro_torch import rpc as rpclib
    from repro_torch.rpc.cluster import as_cluster_spec
    from repro_torch.serve.engine import ShardedServeStub, bind_scheduler
    from repro_torch.serve.scheduler import ServeScheduler

    spec = as_cluster_spec(cluster) if cluster is not None \
        else rpclib.ps_worker_cluster(n_ps, n_workers)
    ps = spec.job_endpoints("ps")
    workers = spec.job_endpoints("worker")
    if not ps or not workers:
        raise ValueError(
            f"workload serving needs >= 1 ps and >= 1 worker "
            f"endpoint; cluster jobs: "
            f"{ {j: len(e) for j, e in spec.jobs.items()} }")

    transport = rpclib.make_transport("cluster", cluster=spec)
    fault_kw = dict(fault or {})
    if trace.fault_windows:
        fault_kw.setdefault("burst_windows", [])
        fault_kw["burst_windows"] = (list(fault_kw["burst_windows"])
                                     + list(trace.fault_windows))
    if fault_kw:
        transport = rpclib.make_transport("fault", inner=transport,
                                          **fault_kw)

    metrics = rpclib.MetricsInterceptor(per_endpoint=True,
                                        endpoint_name=spec.name_of)
    fabric = rpclib.RpcFabric(
        transport,
        client_interceptors=[
            metrics,
            rpclib.RetryInterceptor(max_attempts=retry_attempts)],
        server_interceptors=[metrics],
        tracer=tracer)
    limits = spec.admission_limits()
    if limits:
        fabric.server_interceptors.append(
            rpclib.AdmissionInterceptor(limits=limits,
                                        metrics=metrics))

    engine = SyntheticEngine(max_seq=max_seq,
                             max_new_tokens=max_new_tokens)
    _check_fits(trace, engine)
    schedulers: Dict[str, ServeScheduler] = {}
    for name in ps:
        sched = ServeScheduler(engine, max_batch=max_batch,
                               kv_blocks=kv_blocks,
                               block_size=block_size,
                               policy=sched_policy,
                               starvation_age_s=starvation_age_s)
        schedulers[name] = bind_scheduler(fabric.add_server(name),
                                          sched)
    stubs = {w: ShardedServeStub(fabric, w, ps,
                                 policy=dispatch_policy)
             for w in workers}

    recorder = run_trace(trace, fabric, stubs,
                         deadline_s=deadline_s, stream=stream)
    records = [recorder.records[k]
               for k in sorted(recorder.records)]
    span = max(trace.duration_s, 1e-9)
    report = build_slo_report(
        records, span_s=span, deadline_s=deadline_s,
        metrics=metrics,
        scheduler_stats=[s.stats() for s in schedulers.values()])
    return WorkloadRun(trace=trace, records=records, report=report,
                       fabric=fabric, metrics=metrics,
                       schedulers=schedulers, stubs=stubs)


__all__ = ["SyntheticEngine", "WorkloadRecorder", "WorkloadRun",
           "materialize_prompts", "run_trace", "serve_workload"]
