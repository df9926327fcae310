"""Device tracing — upgrade of the reference's ``clock()``-behind-#if-DEBUG
profiling (``api.c:500-536``).

``trace(logdir)`` wraps a region in a ``torch.profiler`` trace (CPU
activity, and CUDA activity when a card is present) and writes it into
``logdir`` as a Chrome trace (viewable in Perfetto or
``chrome://tracing``); ``annotate`` marks named sub-regions, on the
profiler's timeline and, on the card, as an NVTX range.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace around the with-block; on exit
    it is written to ``logdir`` (default: ``zrt_trace`` in the temporary
    directory) as ``trace_<pid>_<ns>.json``.  Yields ``logdir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "zrt_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region on the profiler's timeline (``record_function``) and,
    on the card, an NVTX range."""
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class Stopwatch:
    """Cheap wall-clock section timer for host-side stages."""

    def __init__(self):
        self.sections = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections.setdefault(name, []).append(
                time.perf_counter() - t0)

    def report(self):
        return {k: {"n": len(v), "total_s": round(sum(v), 4),
                    "mean_ms": round(1e3 * sum(v) / len(v), 3)}
                for k, v in self.sections.items()}
