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

Each such span also leaves one record on the session's timeline
(bounded at ``TIMELINE_CAP`` records, the rest counted as dropped), and
the offset from the spans' clock to the profiler's (the base of
``KinetoEvent.start_ns``, Unix-epoch nanoseconds) is calibrated by paired
clock reads when the session starts and when it ends;
``timeline()`` gives the records on the profiler's clock.  When a
session of CPU activity ends, its device activity is attributed to the
spans (:func:`attribute`): each kernel, memset and copy through its
correlation id to the runtime call that launched it, and from that
call's thread and time to the innermost span open there; each stretch
of device idle time to the innermost spans of the thread that launched
the most device work, by overlap.  ``report()`` then carries each
name's ``device_s``, ``device_self_s``, ``copy_s`` and ``idle_s``, and
``session()`` the session's totals; without a card they read 0.

Sessions are followed through the two methods of
``torch.autograd.profiler.profile`` that every ``torch.profiler``
session passes through at its start and its end (``_start_trace`` and
``__exit__``), wrapped when this module is imported; the wrappers only
observe, and the attribution runs after torch's own stop.  A session
records the CPU activity of the thread that started it alone unless it
asks for every thread (``profile_all_threads``, as ``trace`` does); on
the threads it does not record a span opens no ``record_function``
range (torch would keep nothing of it) and still counts in ``report()``
and on the timeline.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import os
import tempfile
import threading
import time
import traceback
import warnings
from collections import defaultdict
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
TIMELINE_CAP = 1 << 20      # records a session's timeline keeps
_timeline: list = []        # (name, id, native tid, t0 ns, t1 ns)
_dropped = 0                # records past the cap
_pairs: list = []           # (perf ns, profiler ns - perf ns) at start, end
_device: dict = {}          # name -> {device_s, device_self_s, copy_s, idle_s}
_totals: dict = {}          # the newest attributed session's totals
_alias: dict = {}           # a spanning thread's runtime-call id -> native


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
        if _every or threading.get_ident() == _starter:
            self.rf = torch.autograd.profiler.record_function(
                self.name, None if self.id is None else str(self.id))
            self.t0 = _now()
            self.rf.__enter__()
        else:
            self.rf = None
            self.t0 = _now()
        if _nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        global _dropped
        if _nvtx:
            torch.cuda.nvtx.range_pop()
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        t1 = _now()
        dur = t1 - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child += dur
        if exc_type is None and _on and self.gen == _gen:
            own = dur - self.child
            rec = (self.name, self.id, _local.tid, self.t0, t1)
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
                if len(_timeline) < TIMELINE_CAP:
                    _timeline.append(rec)
                else:
                    _dropped += 1
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.tid = threading.get_native_id()
        _alias[_cupti_tid(threading.get_ident())] = _local.tid
        _local.stack = []
        return _local.stack


def _cupti_tid(ident: int) -> int:
    """The id the profiler gives the runtime calls of a thread whose CPU
    activity the session does not record (the stage thread under a
    session that records its starting thread alone): its ``pthread_t``
    cut to a signed 32-bit integer, CUPTI's thread id.  A recorded
    thread's calls carry its native id.  (Both read from
    ``KinetoEvent.device_resource_id`` on an H100 with torch 2.11.)"""
    low = ident & 0xFFFFFFFF
    return low - (1 << 32) if low >= 1 << 31 else low


def annotate(name: str, id=None):
    """The span ``name`` around a with-block; ``id`` (the batch's first
    sequence number on the stages' paths) goes to the ``record_function``
    range as its args."""
    if not _on:
        return _OFF
    return _Span(name, id)


def report() -> dict:
    """``{name: {n, total_s, self_s, max_s}}`` of the spans that ended
    while the newest ``torch.profiler`` session of CPU activity was on;
    once that session has ended, also ``device_s`` (the kernels and
    memsets launched inside the name's spans, child spans included),
    ``device_self_s`` (those launched while it was the innermost span),
    ``copy_s`` (the copies launched inside it) and ``idle_s`` (the
    device's idle time while it was the innermost span of the thread
    that launched the most device work), s, summed over the name's
    spans."""
    with _lock:
        items = [(k, list(v)) for k, v in _agg.items()]
        device = {k: dict(v) for k, v in _device.items()}
    return {k: {"n": n, "total_s": tot * 1e-9, "self_s": own * 1e-9,
                "max_s": mx * 1e-9, **device.get(k, {})}
            for k, (n, tot, own, mx) in items}


def session() -> dict:
    """The newest ended session's totals (empty before one ends), s:
    ``device_s`` (kernels and memsets), ``copy_s``, ``idle_s`` (no
    kernel, copy or memset on the device), ``idle_outside_s`` (of it,
    while the launching thread had no span open), ``outside_device_s``
    (kernels and memsets launched outside every span); ``launch_tid``
    (the native id of the thread that launched the most device work),
    ``offset_ns`` (profiler clock less the spans' clock at the start),
    ``dropped`` (timeline records past the cap) and ``attribute_s`` (the
    host seconds the attribution took); only ``error`` where the
    attribution failed."""
    with _lock:
        return dict(_totals)


def _pair() -> tuple:
    """(spans' clock, profiler's clock less it), ns, from the tightest
    of a few reads of the profiler's clock between two of the spans'."""
    best = None
    for _ in range(16):
        a = _now()
        r = time.time_ns()
        b = _now()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, r)
    _, t, r = best
    return t, r - t


def _to_profiler(pairs):
    """The map of a span time (ns) onto the profiler's clock: the offsets
    of ``pairs`` (the session's start and end), linear between them."""
    (ta, oa), (tb, ob) = pairs[0], pairs[-1]
    if tb <= ta:
        return lambda t: t + oa
    slope = (ob - oa) / (tb - ta)
    return lambda t: t + oa + int(slope * (t - ta))


def timeline() -> list:
    """The newest session's spans, ``(name, id, native thread id, t0 ns,
    t1 ns)`` in the order they ended, times on the profiler's clock (that
    of ``KinetoEvent.start_ns`` and of a Chrome trace's ``ts`` plus its
    ``baseTimeNanoseconds``).  While the session is on, the offset of its
    start serves."""
    with _lock:
        recs, pairs = list(_timeline), list(_pairs)
    if not pairs:
        return []
    f = _to_profiler(pairs)
    return [(n, i, tid, f(a), f(b)) for n, i, tid, a, b in recs]


def _begin(prof) -> None:
    global _on, _session, _gen, _agg, _nvtx, _every, _starter
    global _timeline, _dropped, _pairs, _device, _totals
    with _lock:
        _agg = {}
        _timeline = []
        _dropped = 0
        _device = {}
        _totals = {}
        _gen += 1
        _session = prof
        _nvtx = torch.cuda.is_available()
        _every = _records_every_thread(prof)
        _starter = threading.get_ident()
        _pairs = [_pair()]
        _on = True


def _end(prof) -> bool:
    """Turn the spans off at the end of the session ``prof``; whether it
    was the session that had turned them on."""
    global _on, _session
    with _lock:
        if _session is not prof:
            return False
        _on = False
        _session = None
        _pairs.append(_pair())
        return True


class _Lane:
    """One thread's spans: sorted by start, each one's parent (-1: none
    recorded), and the stretches ``(a, b, k)`` in which span ``k`` is the
    innermost one open."""

    def __init__(self, recs):
        recs = sorted(recs, key=lambda r: (r[3], -r[4]))
        parent, stack, segs, cur = [], [], [], 0

        def close(until):
            nonlocal cur
            while stack and recs[stack[-1]][4] <= until:
                j = stack.pop()
                if recs[j][4] > cur:
                    segs.append((cur, recs[j][4], j))
                    cur = recs[j][4]

        for k, r in enumerate(recs):
            close(r[3])
            if stack and r[3] > cur:
                segs.append((cur, r[3], stack[-1]))
            parent.append(stack[-1] if stack else -1)
            stack.append(k)
            cur = r[3]
        close(float("inf"))
        self.recs, self.parent, self.segs = recs, parent, segs
        self.starts = [a for a, _, _ in segs]

    def innermost(self, t) -> int:
        """The span innermost at ``t``, -1 where none is open."""
        i = bisect.bisect_right(self.starts, t) - 1
        return self.segs[i][2] if i >= 0 and t < self.segs[i][1] else -1

    def names(self, k) -> list:
        """The names of span ``k`` and of the spans around it, once each."""
        out = []
        while k >= 0:
            if self.recs[k][0] not in out:
                out.append(self.recs[k][0])
            k = self.parent[k]
        return out


def _gaps(device, lo, hi) -> list:
    """The stretches of [lo, hi] that no interval of ``device`` covers."""
    iv = sorted((max(a, lo), min(b, hi)) for _, _, a, b in device
                if min(b, hi) > max(a, lo))
    out, cur = [], lo
    for a, b in iv:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def attribute(spans, launches: dict, device, window=None) -> tuple:
    """Device activity by span.

    ``spans``: timeline records ``(name, id, tid, t0, t1)`` on the
    profiler's clock (ns); ``launches``: ``{correlation id: (tid, t)}``,
    the runtime calls that launched device work; ``device``: ``(correlation
    id, kind, t0, t1)`` with kind ``"kernel"``, ``"memset"`` or
    ``"memcpy"``; ``window``: the session's (start, end), or None where it
    recorded no device activity (no idle time then).

    A device interval belongs to the innermost span open on its launching
    thread at the launch, and to the spans around that one; a launch from
    a thread that opened no span (autograd's device thread running a
    backward) to the innermost span open then where one thread alone has
    one open.  Idle time is split by overlap among the innermost spans of
    the thread that launched the most device work.  Returns
    ``({name: {device_s, device_self_s, copy_s, idle_s}}, totals)``."""
    by_tid = defaultdict(list)
    for r in spans:
        by_tid[r[2]].append(r)
    lanes = {tid: _Lane(recs) for tid, recs in by_tid.items()}
    acc = {r[0]: [0, 0, 0, 0] for r in spans}
    tot = defaultdict(int)
    launched = defaultdict(int)
    for corr, kind, a, b in device:
        d = b - a
        copy = kind == "memcpy"
        tot["copy" if copy else "device"] += d
        call = launches.get(corr)
        owner = None
        if call is not None:
            tid, t = call
            launched[tid] += d
            lane = lanes.get(tid)
            if lane is not None:
                k = lane.innermost(t)
                owner = (lane, k) if k >= 0 else None
            else:
                open_ = [(ln, ln.innermost(t)) for ln in lanes.values()]
                open_ = [(ln, k) for ln, k in open_ if k >= 0]
                owner = open_[0] if len(open_) == 1 else None
        if owner is None:
            if not copy:
                tot["outside_device"] += d
            continue
        lane, k = owner
        for n in lane.names(k):
            acc[n][2 if copy else 0] += d
        if not copy:
            acc[lane.recs[k][0]][1] += d
    main = max(launched, key=launched.get) if launched else None
    idle = split = 0
    if window is not None:
        gaps = _gaps(device, *window)
        idle = sum(b - a for a, b in gaps)
        lane = lanes.get(main)
        segs = lane.segs if lane is not None else []
        j = 0
        for a, b in gaps:
            while j < len(segs) and segs[j][1] <= a:
                j += 1
            i = j
            while i < len(segs) and segs[i][0] < b:
                o = min(b, segs[i][1]) - max(a, segs[i][0])
                if o > 0:
                    acc[lane.recs[segs[i][2]][0]][3] += o
                    split += o
                i += 1
    s = 1e-9
    by_name = {n: {"device_s": v[0] * s, "device_self_s": v[1] * s,
                   "copy_s": v[2] * s, "idle_s": v[3] * s}
               for n, v in acc.items()}
    totals = {"device_s": tot["device"] * s, "copy_s": tot["copy"] * s,
              "idle_s": idle * s, "idle_outside_s": (idle - split) * s,
              "outside_device_s": tot["outside_device"] * s,
              "launch_tid": main}
    return by_name, totals


def _device_activity(prof) -> tuple:
    """The runtime calls and device intervals of the ended session
    ``prof`` (its ``kineto_results``), in :func:`attribute`'s form."""
    from torch.autograd import DeviceType

    events = getattr(prof, "kineto_results", None)
    if events is None:
        return {}, []
    launches, device = {}, []
    for e in events.events():
        if e.device_type() == DeviceType.CUDA:
            # a range's span on the device
            if e.is_user_annotation():
                continue
            name = e.name()
            kind = ("memcpy" if name.startswith("Memcpy") else
                    "memset" if name.startswith("Memset") else "kernel")
            t0 = e.start_ns()
            device.append((e.correlation_id(), kind, t0,
                           t0 + e.duration_ns()))
        elif e.name().startswith("cu"):
            tid = e.device_resource_id()
            launches[e.correlation_id()] = (_alias.get(tid, tid),
                                            e.start_ns())
    return launches, device


def _records_cuda(prof) -> bool:
    return getattr(prof, "use_device", None) == "cuda" or \
        bool(getattr(prof, "use_cuda", False))


def _attribute_session(prof, gen: int) -> None:
    """Attribute the ended session ``prof``'s device activity to its
    spans (:func:`attribute`) for ``report()`` and ``session()``."""
    t_start = time.perf_counter()
    with _lock:
        recs, pairs, dropped = list(_timeline), list(_pairs), _dropped
        names = list(_agg)
    f = _to_profiler(pairs)
    spans = [(n, i, tid, f(a), f(b)) for n, i, tid, a, b in recs]
    cuda = _records_cuda(prof)
    launches, device = _device_activity(prof) if cuda else ({}, [])
    window = (f(pairs[0][0]), f(pairs[-1][0])) if cuda else None
    by_name, totals = attribute(spans, launches, device, window)
    zero = {"device_s": 0.0, "device_self_s": 0.0, "copy_s": 0.0,
            "idle_s": 0.0}
    totals.update(offset_ns=pairs[0][1], dropped=dropped,
                  attribute_s=time.perf_counter() - t_start)
    global _device, _totals
    with _lock:
        if gen == _gen:
            _device = {n: by_name.get(n, zero) for n in names}
            _totals = totals


def _attribution_failed(gen: int, trace: str) -> None:
    """Keep the spans' host times and say why the session's device
    activity could not be attributed (``session()["error"]``)."""
    global _totals
    warnings.warn(f"profiling: no device time by span: {trace}",
                  RuntimeWarning)
    with _lock:
        if gen == _gen:
            _totals = {"error": trace}


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
        gen = _gen
        mine = _end(self)
        out = stop(self, *exc)
        if mine:
            try:
                _attribute_session(self, gen)
            except Exception:       # the session's own result stands
                _attribution_failed(gen, traceback.format_exc())
        return out

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
