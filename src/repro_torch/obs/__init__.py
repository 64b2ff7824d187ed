"""Engine telemetry.  This slice carries the metrics registry only (it
supplies the ``engine.host_syncs`` counter); the timeline, imbalance and
export modules are ROADMAP A.8."""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry"]
