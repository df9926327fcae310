"""Structured per-stage metrics.

The reference's observability is stdout prints and ``clock()`` deltas
behind ``#if DEBUG`` (``api.c:500-536``).  Here every pipeline stage owns a
:class:`StageMetrics` (rate + latency percentiles over a sliding window),
and :class:`PipelineMetrics` aggregates them into one report: ingest rate,
drop count, heatmap fps, detector fps, end-to-end latency p50 — the
BASELINE metric set.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Dict, Optional


class StageMetrics:
    def __init__(self, name: str, window: int = 256):
        self.name = name
        self.count = 0
        self.dropped = 0
        self._lat = collections.deque(maxlen=window)
        self._stamps = collections.deque(maxlen=window)

    def tick(self, latency_s: Optional[float] = None) -> None:
        self.count += 1
        self._stamps.append(time.perf_counter())
        if latency_s is not None:
            self._lat.append(latency_s)

    def drop(self, n: int = 1) -> None:
        self.dropped += n

    @property
    def rate_hz(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        span = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / span if span > 0 else 0.0

    def latency_percentile(self, q: float) -> float:
        if not self._lat:
            return 0.0
        xs = sorted(self._lat)
        return xs[min(int(q / 100 * len(xs)), len(xs) - 1)]

    def report(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "dropped": self.dropped,
            "rate_hz": round(self.rate_hz, 2),
            "latency_p50_ms": round(self.latency_percentile(50) * 1e3, 3),
            "latency_p95_ms": round(self.latency_percentile(95) * 1e3, 3),
        }


class PipelineMetrics:
    def __init__(self):
        self.stages: Dict[str, StageMetrics] = {}

    def stage(self, name: str) -> StageMetrics:
        if name not in self.stages:
            self.stages[name] = StageMetrics(name)
        return self.stages[name]

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: v.report() for k, v in self.stages.items()}


class Timer:
    """``with metrics.stage('heatmap').time():`` convenience."""

    def __init__(self, stage: StageMetrics):
        self._stage = stage

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._stage.tick(time.perf_counter() - self._t0)
        return False


def timed(stage: StageMetrics) -> Timer:
    return Timer(stage)
