"""Reduce a ``torch.profiler`` window to the device's busy time and gaps.

:class:`DeviceTrace` profiles a window (CPU and CUDA activity) marked by
a ``record_function`` range of its own, exports the trace to a temporary
file, reads it back and keeps only a summary:

* ``window_s``: the length of the marked window;
* ``busy_s``: the union of every device interval (kernels, copies,
  memsets) inside it; ``kernel_s``: the union of the kernels and memsets
  alone (the device's compute, without the transfers);
* ``device_ops``: the ten device operations that took most time;
* ``idle_gaps``: the device's idle time inside the window, summed by
  what the host was doing at the middle of each gap: the innermost
  profiled operation open on the thread that launched most device work,
  else the Python functions that a sampler (every millisecond) last saw
  that thread in, ``py: file:function < caller``, else
  ``"(no traced op)"``; the ten largest.

:class:`KernelClock` profiles the device's activity alone over a measured
window, so that the host runs as it would without it, and keeps the
union of its kernel intervals.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
import threading
import time
from collections import defaultdict

import numpy as np

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
MARK = "portbench.window"


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted (k, 2) intervals."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out)


def _clip(iv: np.ndarray, lo: float, hi: float) -> np.ndarray:
    iv = np.clip(iv, lo, hi)
    return iv[iv[:, 1] > iv[:, 0]] if len(iv) else iv.reshape(0, 2)


def _device_intervals(events):
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in _DEVICE_CATS]
    iv = np.asarray([[float(e["ts"]), float(e["ts"]) + float(e["dur"])]
                     for e in dev], np.float64).reshape(-1, 2)
    return dev, iv


def _export(prof) -> list:
    """The chrome-trace events of a finished ``torch.profiler`` run."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def kernel_seconds(events) -> float:
    """The union of the kernel and memset intervals of ``events``, s."""
    dev, iv = _device_intervals(events)
    kern = np.asarray([e.get("cat") != "gpu_memcpy" for e in dev], bool)
    u = _union(iv[kern]) if len(iv) else iv
    return float((u[:, 1] - u[:, 0]).sum()) * 1e-6


def summarize(events, samples=(), top: int = 10) -> dict:
    """Summary of chrome-trace ``events`` (times in microseconds);
    ``samples``: (time in the trace's microseconds, label) of the
    launching thread's Python stack, sorted."""
    mark = [e for e in events if e.get("name") == MARK and e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]
    if not mark:
        raise ValueError("the trace has no window mark")
    lo = float(mark[0]["ts"])
    hi = lo + float(mark[0]["dur"])
    dev, iv = _device_intervals(events)
    busy = _union(_clip(iv, lo, hi))
    kern = np.asarray([e.get("cat") != "gpu_memcpy" for e in dev], bool)
    comp = _union(_clip(iv[kern], lo, hi)) if len(iv) else iv
    by_name = defaultdict(float)
    for e, (a, b) in zip(dev, iv):
        d = min(b, hi) - max(a, lo)
        if d > 0:
            by_name[e.get("name", "?")[:160]] += d * 1e-6
    # host side: the launching thread's open operations
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in _HOST_CATS and e.get("name") != MARK]
    launches = defaultdict(int)
    for e in host:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launches[e.get("tid")] += 1
    tid = max(launches, key=launches.get) if launches else None
    mine = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("name", "?")[:160])
                   for e in host if e.get("tid") == tid), key=lambda x: x[0])
    starts = np.asarray([m[0] for m in mine])
    longest = max((e - s for s, e, _ in mine), default=0.0)
    sample_t = [t for t, _ in samples]
    gaps = defaultdict(float)
    edges = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2)
    for a, b in edges:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = "(no traced op)"
        best = None
        # innermost = the latest-starting operation still open at mid
        for j in range(int(np.searchsorted(starts, mid)) - 1, -1, -1):
            s, e, name = mine[j]
            if e >= mid:
                best = name
                break
            if mid - s > longest:    # no earlier operation reaches mid
                break
        if best is not None:
            label = best
        elif samples:
            k = bisect.bisect_right(sample_t, mid) - 1
            if k >= 0 and mid - sample_t[k] < 2e3:
                label = "py: " + samples[k][1]
        gaps[label] += (b - a) * 1e-6
    span = lambda x: float((x[:, 1] - x[:, 0]).sum()) * 1e-6  # noqa: E731
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": span(busy),
        "kernel_s": span(comp),
        "t0": lo, "t1": hi,
        "device_ops": sorted(([k, float(v)] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, float(v)] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:top],
    }


def _where(frame, depth: int = 2) -> str:
    out = []
    while frame is not None and len(out) < depth:
        co = frame.f_code
        out.append(f"{os.path.basename(co.co_filename)}:{co.co_name}")
        frame = frame.f_back
    return " < ".join(out)


class _Sampler(threading.Thread):
    """Every ``period`` seconds, where one thread's Python stack is."""

    def __init__(self, ident: int, period: float = 1e-3):
        super().__init__(name="portbench-sampler", daemon=True)
        self.target, self.period = ident, period
        self.samples = []
        self.stop = False

    def run(self):
        while not self.stop:
            frame = sys._current_frames().get(self.target)
            if frame is not None:
                self.samples.append((time.perf_counter(), _where(frame)))
            del frame
            time.sleep(self.period)


class DeviceTrace:
    """``with DeviceTrace(ident) as tr: tr.hold(seconds)`` profiles a
    window of ``seconds`` and leaves the summary in ``tr.summary``; the
    host clock (``time.perf_counter``) bounds of the window are
    ``tr.t0``/``tr.t1``.  ``ident``: the Python thread (``threading``
    ident) that launches the device work, whose stack is sampled."""

    def __init__(self, ident=None):
        self.ident = ident

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._sampler = _Sampler(self.ident) if self.ident else None
        self._prof.__enter__()
        if self._sampler is not None:
            self._sampler.start()
        self.summary = None
        return self

    def hold(self, seconds: float) -> None:
        with self._torch.profiler.record_function(MARK):
            self.t0 = time.perf_counter()
            time.sleep(seconds)
            self.t1 = time.perf_counter()

    def __exit__(self, *exc):
        if self._sampler is not None:
            self._sampler.stop = True
            self._sampler.join(timeout=5)
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = _export(self._prof)
        lo = [e for e in events if e.get("name") == MARK
              and e.get("cat") == "user_annotation"]
        samples = ()
        if lo and self._sampler is not None:
            off = float(lo[0]["ts"]) - self.t0 * 1e6
            samples = [(t * 1e6 + off, w) for t, w in self._sampler.samples]
        self.summary = summarize(events, samples)
        return False


class KernelClock:
    """``with KernelClock() as kc: ...`` profiles the device's activity
    alone (no host operations are recorded, so the host's work in the
    block is as without it) and leaves in ``kc.kernel_s`` the union of the
    kernel and memset intervals that ran from entry to exit, the work
    in flight at exit included; 0.0 where there is no card."""

    def __enter__(self):
        import torch

        self._torch = torch
        self.kernel_s = 0.0
        self._prof = None
        if torch.cuda.is_available():
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.kernel_s = kernel_seconds(_export(self._prof))
        return False
