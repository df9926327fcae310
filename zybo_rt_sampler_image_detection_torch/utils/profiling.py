"""Device tracing and the program's spans — upgrade of the reference's
``clock()``-behind-#if-DEBUG profiling (``api.c:500-536``).

``trace(logdir)`` wraps a region in a ``torch.profiler`` trace (CPU
activity of every thread where torch can record them, and CUDA activity
when a card is present) and writes it into ``logdir`` as a Chrome trace
(viewable in Perfetto or ``chrome://tracing``).

``annotate(name, id=None)`` is the program's span.  It is off unless a
``torch.profiler`` session records CPU activity (``trace`` here, or any
other ``torch.profiler.profile`` with ``ProfilerActivity.CPU``); a
session of CUDA activity alone leaves it off.  Off, it costs one flag
check and hands back a shared no-op context.  On, it reads the host's
clock (``time.perf_counter_ns``, CLOCK_MONOTONIC, the clock of the
ring's publish stamps), opens a ``record_function`` range with ``id`` as
its args where the session records the thread, and an NVTX range on the
card; it adds no device work.  A span without an ``id`` takes its
enclosing span's.  ``report()`` gives each name's count, total, self
time (less its child spans) and longest duration, over the spans that
ended without an exception while the newest session was on.

Sessions are followed through the two methods of
``torch.autograd.profiler.profile`` that every ``torch.profiler``
session passes through at its start and its end (``_start_trace`` and
``__exit__``), wrapped when this module is imported; the wrappers only
observe.  A session records the CPU activity of the thread that started
it alone unless it asks for every thread (``profile_all_threads``, as
``trace`` does); on the threads it does not record a span opens no
``record_function`` range (torch would keep nothing of it) and still
counts in ``report()``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import threading
import time
from typing import Iterator, Optional

import torch

_now = time.perf_counter_ns
_on = False                 # a session records CPU activity
_session = None             # that session's autograd profile
_gen = 0                    # sessions started so far
_nvtx = False               # ranges on the card too
_every = False              # the session records every thread's ranges
_starter = None             # else the thread that started it
_lock = threading.Lock()
_agg: dict = {}             # name -> [n, total ns, self ns, max ns]
_local = threading.local()


class _Off:
    """The shared span of a process that nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "gen", "t0", "child", "rf")

    def __init__(self, name: str, id):
        self.name = name
        self.id = id

    def __enter__(self):
        stack = _stack()
        if self.id is None and stack:
            self.id = stack[-1].id
        self.gen = _gen
        self.child = 0
        stack.append(self)
        self.t0 = _now()
        if _every or threading.get_ident() == _starter:
            self.rf = torch.autograd.profiler.record_function(
                self.name, None if self.id is None else str(self.id))
            self.rf.__enter__()
        else:
            self.rf = None
        if _nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        if _nvtx:
            torch.cuda.nvtx.range_pop()
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        dur = _now() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child += dur
        if exc_type is None and _on and self.gen == _gen:
            own = dur - self.child
            with _lock:
                a = _agg.get(self.name)
                if a is None:
                    _agg[self.name] = [1, dur, own, dur]
                else:
                    a[0] += 1
                    a[1] += dur
                    a[2] += own
                    if dur > a[3]:
                        a[3] = dur
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def annotate(name: str, id=None):
    """The span ``name`` around a with-block; ``id`` (the batch's first
    sequence number on the stages' paths) goes to the ``record_function``
    range as its args."""
    if not _on:
        return _OFF
    return _Span(name, id)


def report() -> dict:
    """``{name: {n, total_s, self_s, max_s}}`` of the spans that ended
    while the newest ``torch.profiler`` session of CPU activity was on."""
    with _lock:
        items = [(k, list(v)) for k, v in _agg.items()]
    return {k: {"n": n, "total_s": tot * 1e-9, "self_s": own * 1e-9,
                "max_s": mx * 1e-9} for k, (n, tot, own, mx) in items}


def _begin(prof) -> None:
    global _on, _session, _gen, _agg, _nvtx, _every, _starter
    with _lock:
        _agg = {}
        _gen += 1
        _session = prof
        _nvtx = torch.cuda.is_available()
        _every = _records_every_thread(prof)
        _starter = threading.get_ident()
        _on = True


def _end(prof) -> None:
    global _on, _session
    with _lock:
        if _session is prof:
            _on = False
            _session = None


def _every_thread():
    """The profiler option that records the CPU activity of every thread,
    where this torch has it (else None: the starting thread's alone)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def _every_thread_field():
    """Where that option sits in the state of torch's experimental
    profiler config, which has no attribute for it; None without it."""
    every = _every_thread()
    if every is None:
        return None
    on, off = every.__getstate__(), type(every)().__getstate__()
    found = [k for k, (a, b) in enumerate(zip(on, off)) if a != b]
    return found[0] if len(found) == 1 else None


_EVERY_FIELD = _every_thread_field()


def _records_every_thread(prof) -> bool:
    """Whether the session ``prof`` records every thread's ranges; True
    where that cannot be read (a range too many costs time, not data)."""
    if _EVERY_FIELD is None:
        return True
    try:
        return bool(prof.experimental_config.__getstate__()[_EVERY_FIELD])
    except (AttributeError, IndexError, TypeError):
        return True


def _follow_sessions() -> None:
    """Wrap the autograd profile's start and end (once a process) so that
    a session of CPU activity turns the spans on and its end off."""
    cls = getattr(torch.autograd.profiler, "profile", None)
    start = getattr(cls, "_start_trace", None)
    if start is None or getattr(start, "follows_spans", False):
        return
    stop = cls.__exit__

    @functools.wraps(start)
    def _start_trace(self, *a, **kw):
        out = start(self, *a, **kw)
        if getattr(self, "use_cpu", False):
            _begin(self)
        return out

    @functools.wraps(stop)
    def __exit__(self, *exc):
        _end(self)
        return stop(self, *exc)

    _start_trace.follows_spans = True
    cls._start_trace = _start_trace
    cls.__exit__ = __exit__


_follow_sessions()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace around the with-block; on exit
    it is written to ``logdir`` (default: ``zrt_trace`` in the temporary
    directory) as ``trace_<pid>_<ns>.json``.  Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "zrt_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    every = _every_thread()
    kw = {} if every is None else {"experimental_config": every}
    with profile(activities=activities, **kw) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
