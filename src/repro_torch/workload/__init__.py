"""Trace-driven workload generation + SLO harness.

Open-loop companion to the closed-loop micro-benchmarks: seeded
arrival processes (``arrivals``), heavy-tailed request shapes
(``lengths``), replayable schema-versioned traces (``trace``), an
open-loop driver over the serve stack on the modeled clock
(``driver``), and SLO reports folding the run's telemetry (``slo``).
See ``docs/WORKLOAD.md``.
"""
from repro_torch.workload.arrivals import (ARRIVALS, bursty_arrivals,
                                     diurnal_arrivals, make_arrivals,
                                     poisson_arrivals)
from repro_torch.workload.driver import (SyntheticEngine, WorkloadRecorder,
                                   WorkloadRun, materialize_prompts,
                                   run_trace, serve_workload)
from repro_torch.workload.lengths import (LENGTHS, SIZE_CATEGORIES,
                                    fixed_lengths, lognormal_lengths,
                                    make_lengths,
                                    sample_request_shapes,
                                    zipf_lengths)
from repro_torch.workload.slo import (SloReport, build_slo_report,
                                format_slo_table)
from repro_torch.workload.trace import (TRACE_SCHEMA, Trace, TraceEvent,
                                  correlated_burst_windows,
                                  synthesize_trace)

__all__ = [
    "ARRIVALS", "LENGTHS", "SIZE_CATEGORIES", "SloReport",
    "SyntheticEngine", "TRACE_SCHEMA", "Trace", "TraceEvent",
    "WorkloadRecorder", "WorkloadRun", "build_slo_report",
    "bursty_arrivals", "correlated_burst_windows", "diurnal_arrivals",
    "fixed_lengths", "format_slo_table", "lognormal_lengths",
    "make_arrivals", "make_lengths", "materialize_prompts",
    "poisson_arrivals", "run_trace", "sample_request_shapes",
    "serve_workload", "synthesize_trace", "zipf_lengths",
]
