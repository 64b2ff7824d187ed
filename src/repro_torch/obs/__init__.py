"""Engine telemetry: metrics registry, superstep timeline tracing,
Perfetto/Chrome-trace export, load-imbalance metrics and run reports.

Copies of ``repro.obs``'s numpy-only modules, with the reference's
exports.  Import layering: this package must never import
``repro_torch.core.engine`` (the run loops import *us* for the
Observer/metrics hooks); ``export``/``report`` may use
``core.costmodel``/``core.netstats``.
"""
from .export import to_trace_events, trace_dict, write_trace
from .imbalance import (cascade_efficacy, gini, imbalance_report,
                        max_over_mean, run_load_matrix, step_metrics,
                        summarize)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)
from .report import run_report, to_markdown, write_report
from .timeline import ChunkSpan, Observer, RunMeta, TimelineRecorder

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "ChunkSpan", "Observer", "RunMeta", "TimelineRecorder",
    "to_trace_events", "trace_dict", "write_trace",
    "cascade_efficacy", "gini", "imbalance_report", "max_over_mean",
    "run_load_matrix", "step_metrics", "summarize",
    "run_report", "to_markdown", "write_report",
]
