"""Lightweight counter/gauge/histogram registry for engine telemetry.

A verbatim copy of ``repro.obs.metrics`` (numpy only): the port imports nothing of the
JAX package, whose package ``__init__`` pulls JAX in. ``tests/test_torch_base.py``
holds the copy against the original.

One process-wide :class:`MetricsRegistry` (``default_registry()``)
collects operational metrics from the run loops, the distributed driver,
the product search and the benchmark harness — host-side only, so
attaching metrics never adds a device sync and never perturbs the
engine's computation.

The registry is deliberately tiny (no labels, no exporters): metric
names are dotted strings (``"engine.host_syncs"``), values are floats,
and a snapshot is a plain dict that the run report serializes.  Tests
that assert "telemetry does not change execution" diff two snapshots
(``snapshot()`` / ``Counter.value``) around a run.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional


class Counter:
    """Monotonically increasing count (events, syncs, cache hits)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-written value (progress step count, pending work)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Streaming distribution: count/sum/min/max plus a bounded sample
    reservoir for percentile estimates (deterministic stride thinning —
    no RNG, so two identical runs record identical state)."""

    __slots__ = ("name", "count", "total", "min", "max", "_sample",
                 "_stride", "_seen", "_cap")

    def __init__(self, name: str, sample_cap: int = 1024):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._sample: List[float] = []
        self._stride = 1
        self._seen = 0
        self._cap = sample_cap

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._seen += 1
        if (self._seen - 1) % self._stride == 0:
            self._sample.append(v)
            if len(self._sample) >= self._cap:
                # thin deterministically: keep every other sample, double
                # the stride — the reservoir stays a uniform systematic
                # sample of the stream
                self._sample = self._sample[::2]
                self._stride *= 2

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        if not self._sample:
            return 0.0
        s = sorted(self._sample)
        idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        return s[idx]

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return dict(count=0, mean=0.0, min=0.0, max=0.0, p50=0.0,
                        p95=0.0)
        return dict(count=self.count, mean=self.mean, min=self.min,
                    max=self.max, p50=self.percentile(50),
                    p95=self.percentile(95))


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors.

    Thread-safe creation (benchmarks may time concurrently); observation
    itself is a plain float update — the engine hot path must not take a
    lock per superstep.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name))
        return h

    def snapshot(self) -> Dict[str, object]:
        """Plain-dict view of every metric (JSON-serializable)."""
        return dict(
            counters={k: c.value for k, c in sorted(self._counters.items())},
            gauges={k: g.value for k, g in sorted(self._gauges.items())},
            histograms={k: h.summary()
                        for k, h in sorted(self._histograms.items())},
        )

    def reset(self) -> None:
        """Drop every metric (tests isolate runs with this)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry the run loops emit into."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = MetricsRegistry()
    return _DEFAULT
