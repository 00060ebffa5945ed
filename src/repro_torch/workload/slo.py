"""SLO reports over a workload run.

The paper's micro-benchmarks report closed-loop throughput; an SLO
report answers the question operators actually ask of a serving stack:
*under this offered load, what fraction of requests met their latency
target, and where did the rest go?* This module folds three telemetry
sources the fabric already produces — the driver's per-request records
(arrival/first-chunk/completion on the modeled clock), the
``MetricsInterceptor`` snapshot (retries, sheds, admission rejections,
per-endpoint queue peaks), and the serve schedulers' counters
(preemptions) — into one :class:`SloReport`.

Latency tails come from :class:`repro_torch.rpc.telemetry.BoundedHistogram`
(exact percentiles for benchmark-sized runs, conservative log-bucketed
folding past ``EXACT_CAP``), so p999 here has the same semantics as
everywhere else in the telemetry tier.

Definitions (all on the modeled clock, relative to the *scheduled*
arrival — open-loop latency includes the queueing a closed-loop
harness hides):

  TTFT        first streamed token minus arrival (unary: completion
              minus arrival — the whole block is the first "token").
  per-token   (completion - first token) / (chunks - 1); only defined
              for streams that delivered >= 2 chunks.
  e2e         completion minus arrival.
  goodput     completed-ok requests that also met ``deadline_s``
              end-to-end, per second of trace span.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.rpc.telemetry import BoundedHistogram

#: percentile set every latency block reports
_QS = (50.0, 99.0, 99.9)


def _tail(hist: BoundedHistogram) -> Dict[str, float]:
    if hist.count == 0:
        return {"n": 0}
    p50, p99, p999 = hist.percentiles(_QS)
    return {"n": hist.count, "mean": hist.mean, "p50": p50,
            "p99": p99, "p999": p999, "max": hist.max}


@dataclass
class SloReport:
    """One workload run, summarised. ``to_dict`` is the JSON shape the
    bench CLI embeds; ``format_slo_table`` renders it for terminals."""
    offered: int                 # events in the trace
    completed_ok: int
    errors: int
    deadline_exceeded: int
    span_s: float                # trace span the rates normalise over
    offered_rps: float
    goodput_rps: float
    slo_attainment: float        # ok-and-within-deadline / offered
    deadline_s: Optional[float]
    ttft: Dict[str, float]
    per_token: Dict[str, float]
    e2e: Dict[str, float]
    retries: int = 0
    shed: int = 0
    rejected: int = 0
    preempted: int = 0
    queue_peaks: Dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "offered": self.offered,
            "completed_ok": self.completed_ok,
            "errors": self.errors,
            "deadline_exceeded": self.deadline_exceeded,
            "span_s": self.span_s,
            "offered_rps": self.offered_rps,
            "goodput_rps": self.goodput_rps,
            "slo_attainment": self.slo_attainment,
            "deadline_s": self.deadline_s,
            "ttft_s": self.ttft,
            "per_token_s": self.per_token,
            "e2e_s": self.e2e,
            "retries": self.retries,
            "shed": self.shed,
            "rejected": self.rejected,
            "preempted": self.preempted,
            "queue_peaks": self.queue_peaks,
        }


def build_slo_report(records: List[dict], *,
                     span_s: float,
                     deadline_s: Optional[float] = None,
                     metrics=None,
                     scheduler_stats: Optional[List[dict]] = None
                     ) -> SloReport:
    """Fold per-request records (the driver recorder's dicts) plus the
    run's ``MetricsInterceptor`` and scheduler counters into a report.

    ``span_s`` is the window rates normalise over — the trace duration
    for open-loop runs (NOT the completion time of the last request,
    which would flatter an overloaded system by stretching its
    denominator).
    """
    assert span_s > 0, span_s
    ttft = BoundedHistogram()
    per_token = BoundedHistogram()
    e2e = BoundedHistogram()
    ok = errors = exceeded = good = 0
    for rec in records:
        if rec.get("outcome") == "deadline_exceeded":
            exceeded += 1
            continue
        if not rec.get("ok"):
            errors += 1
            continue
        ok += 1
        arrival, end = rec["arrival_s"], rec["end_s"]
        first = rec.get("first_chunk_s")
        ttft.record((first if first is not None else end) - arrival)
        e2e.record(end - arrival)
        chunks = rec.get("chunks", 0)
        if first is not None and chunks >= 2:
            per_token.record((end - first) / (chunks - 1))
        if deadline_s is None or end - arrival <= deadline_s:
            good += 1

    retries = shed = rejected = 0
    queue_peaks: Dict[str, int] = {}
    if metrics is not None:
        for key, rec in metrics.snapshot().items():
            if key.startswith("server:"):
                shed += rec.get("shed", 0)
                rejected += rec.get("rejected", 0)
                if "@" in key and "queue_peak" in rec:
                    ep = key.split("@", 1)[1]
                    queue_peaks[ep] = max(queue_peaks.get(ep, 0),
                                          rec["queue_peak"])
            else:
                retries += rec.get("retries", 0)

    preempted = sum(s.get("preempted", 0)
                    for s in (scheduler_stats or []))

    offered = len(records)
    return SloReport(
        offered=offered, completed_ok=ok, errors=errors,
        deadline_exceeded=exceeded, span_s=span_s,
        offered_rps=offered / span_s, goodput_rps=good / span_s,
        slo_attainment=(good / offered) if offered else 0.0,
        deadline_s=deadline_s, ttft=_tail(ttft),
        per_token=_tail(per_token), e2e=_tail(e2e),
        retries=retries, shed=shed, rejected=rejected,
        preempted=preempted, queue_peaks=queue_peaks)


def _fmt_tail(tail: Dict[str, float]) -> str:
    if not tail.get("n"):
        return "(no samples)"
    return (f"p50 {tail['p50'] * 1e3:8.3f}  "
            f"p99 {tail['p99'] * 1e3:8.3f}  "
            f"p999 {tail['p999'] * 1e3:8.3f}  "
            f"max {tail['max'] * 1e3:8.3f}")


def format_slo_table(report: SloReport) -> str:
    """Terminal rendering (latencies in ms)."""
    r = report
    lines = [
        "SLO summary "
        f"(deadline {r.deadline_s * 1e3:.1f} ms)" if r.deadline_s
        else "SLO summary (no deadline)",
        f"  offered   {r.offered:6d} req   "
        f"{r.offered_rps:8.2f} req/s over {r.span_s:.3f} s",
        f"  goodput   {r.goodput_rps:8.2f} req/s   "
        f"attainment {r.slo_attainment * 100:6.2f} %",
        f"  outcomes  ok {r.completed_ok}  errors {r.errors}  "
        f"deadline_exceeded {r.deadline_exceeded}",
        f"  pressure  retries {r.retries}  shed {r.shed}  "
        f"rejected {r.rejected}  preempted {r.preempted}",
        f"  ttft      [ms] {_fmt_tail(r.ttft)}",
        f"  per-token [ms] {_fmt_tail(r.per_token)}",
        f"  e2e       [ms] {_fmt_tail(r.e2e)}",
    ]
    if r.queue_peaks:
        peaks = "  ".join(f"{ep}={v}" for ep, v in
                          sorted(r.queue_peaks.items()))
        lines.append(f"  queue-peaks {peaks}")
    return "\n".join(lines)


__all__ = ["SloReport", "build_slo_report", "format_slo_table"]
