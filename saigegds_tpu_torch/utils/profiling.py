"""Device introspection and profiling hooks, the counterparts of
``saigegds_tpu/utils/profiling.py``.

The reference exposes a SIMD-dispatch introspection call (``SIMD()`` ->
``saige_simd_version``, R/saige_main.r:64, src/vectorization.cpp:33-94) and
brackets phases with wall-clock prints (R/saige_main.r:260-261).  Here: a
report of torch, CUDA and the card, a wall clock that waits for the card,
``torch.profiler`` traces in Chrome's format, and the port's own spans and
counters.

**Spans and counters.**  The port marks where its work happens: host
spans (:func:`span`), consecutive spans of the work queued on a device
between marks (:func:`device_parts`) and counters (:func:`count`).  A
device span is the time between two CUDA events: the device's own time
only while the host keeps it fed, since it also counts the device
waiting for launches.  They record only while a ``torch.profiler``
session runs: each public call (:func:`entry`) tests that once on its
calling thread and hands the answer to the threads it starts
(:func:`carry`, :func:`adopt`); with the profiler off a span site costs
one test of a flag.  A recorded host span also opens a host event of its
name on the profiler's timeline, so the profiler names the host work,
and keeps its start and end in ``time.time_ns()``, the clock of the
profiler's events.  The host event is the profiler's fast record
function (``_RecordFunctionFast``): unlike
``torch.profiler.record_function`` it draws no annotation on the
device's timeline, which a trace reading the device's intervals would
count as device work.  Spans of one public call share its id and name
the span that encloses them.  The recorder holds one profiler session:
the first public call that finds the profiler running after one that
found it off drops what was held.  :func:`spans`, :func:`device_spans`
and :func:`counts` read it; device times are resolved only there.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import subprocess
import threading
import time
from typing import Iterator, NamedTuple

import torch
from torch._C._profiler import _ExperimentalConfig, \
    _RecordFunctionFast as _HostEvent

from ..ops._cuda import check_device


def device_info() -> str:
    """Describe the compute backend (the ``SIMD()`` analog): the torch and
    CUDA versions, and each card's name and power limit (from
    ``nvidia-smi``) when there is one."""
    parts = [f"torch={torch.__version__}",
             f"cuda={torch.version.cuda}",
             f"cuda_available={torch.cuda.is_available()}"]
    if torch.cuda.is_available():
        parts.append(f"devices={torch.cuda.device_count()}")
        parts.append(f"kind={torch.cuda.get_device_name(0)}")
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60, check=True).stdout.strip().splitlines()
            parts.append(f"power_limit={smi[0].split(',')[-1].strip()}")
        except (OSError, subprocess.SubprocessError, IndexError):
            parts.append("power_limit=unknown")
    return " ".join(parts)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def phase_timer(label: str, verbose: bool = True, *,
                device) -> Iterator[dict]:
    """Wall-clock phase bracket (the reference's date() prints) that waits
    for the work queued on ``device`` at its start and end, so a card's
    asynchronous work counts in the phase that queued it.  Yields a dict
    that receives ``seconds``."""
    dev = check_device(device)
    out = {}
    _sync(dev)
    t0 = time.perf_counter()
    if verbose:
        print(f"[{label}] start")
    try:
        yield out
        _sync(dev)
    except BaseException:
        if verbose:
            print(f"[{label}] FAILED after {time.perf_counter() - t0:.2f}s")
        raise
    out["seconds"] = time.perf_counter() - t0
    if verbose:
        print(f"[{label}] done in {out['seconds']:.2f}s")


@contextlib.contextmanager
def profile_trace(logdir: str, *, device) -> Iterator[object]:
    """Trace the block with ``torch.profiler`` (the CPU of every thread,
    and the card when ``device`` is one) and write a Chrome trace,
    ``trace.json``, into ``logdir``.  Yields the profiler (its
    ``key_averages()`` give the time by kernel).

    The port's spans record inside the block (:func:`spans`) and appear
    in the trace by name.  The scan's: ``scan.call`` (the root),
    ``scan.prepare`` (GDS open, sample alignment, each model's scan
    state), ``scan.wait_block`` (the main thread waiting for the next
    uploaded block), ``scan.dispatch``, ``scan.drain``, ``scan.tables``,
    ``scan.spa`` (one model's phase 2) with ``scan.spa.sort``,
    ``scan.spa.wait_payload`` and ``scan.spa.refine``, and on the
    producer threads ``scan.decode``, ``scan.pack`` (with
    ``scan.gather``, and on the dense route ``scan.shrink``),
    ``scan.upload`` and ``scan.spa.payload``; on the dense route, each
    block's phase 1 is the device span ``scan.dense_score``.  The GRM
    product's: ``grm.product``.  The lane fitter's: ``fit.call``,
    ``fit.lane_groups``, ``fit.group``, ``fit.irls``, ``fit.ai_step``,
    ``fit.traces`` and ``fit.pcg``."""
    from torch.profiler import ProfilerActivity, profile

    dev = check_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        yield prof
        _sync(dev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ---------------------------------------------------------------------------
# spans and counters inside the port


class Span(NamedTuple):
    """Host work: ``call`` is the id of the public call it belongs to,
    ``parent`` the id of the span that encloses it (0: none), ``tid`` its
    thread's ident; stamps in ``time.time_ns()``."""

    id: int
    name: str
    call: int
    parent: int
    tid: int
    start_ns: int
    end_ns: int


class DeviceSpan(NamedTuple):
    """The work queued on a device between two marks, in ``seconds``
    (CUDA events; host clocks on the CPU)."""

    name: str
    call: int
    parent: int
    tid: int
    seconds: float


class _Ctx(NamedTuple):
    on: bool      # recording: the profiler ran at the call's entry
    call: int     # the public call's id; 0 outside any, -1 unrecorded
    parent: int   # the innermost open span's id


_OUTSIDE = _Ctx(False, 0, 0)
_UNRECORDED = _Ctx(False, -1, 0)


class _Local(threading.local):
    ctx = _OUTSIDE


class _Recorder:
    """The spans and counts of one profiler session."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.stale = False
        self.host, self.device, self.counts = [], [], {}

    def session(self, on: bool):
        """A public call's entry found the profiler ``on`` or off."""
        if not on:
            self.stale = True
        elif self.stale:
            with self.lock:
                self.host, self.device, self.counts = [], [], {}
                self.stale = False


_local = _Local()
_REC = _Recorder()


def _profiler_running() -> bool:
    """Whether a ``torch.profiler`` session runs: one of the calling
    thread's, or one of every thread's (``profile_all_threads``)."""
    return bool(torch.autograd.profiler._is_profiler_enabled
                or torch._C._autograd._profiler_enabled())


def _add(instrument: dict, key: str, v):
    """Add ``v`` to ``instrument[key]``: appended to a list, else summed."""
    cur = instrument.get(key)
    if isinstance(cur, list):
        cur.append(v)
    else:
        instrument[key] = (cur or 0) + v


class _Null:
    """A span that records nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def discard(self):
        pass


_NULL = _Null()


class _Timed(_Null):
    """Not recording, but timing into an ``instrument`` dict."""

    def __init__(self, instrument: dict, key: str):
        self.instrument, self.key, self.dropped = instrument, key, False

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.dropped:
            _add(self.instrument, self.key, time.perf_counter() - self.t0)
        return False

    def discard(self):
        self.dropped = True


class _Span(_Timed):
    """A recorded host span."""

    def __init__(self, name: str, ctx: _Ctx, instrument, key):
        super().__init__(instrument, key)
        self.name, self.ctx = name, ctx

    def __enter__(self):
        self.id = next(_REC.ids)
        self.rf = _HostEvent(self.name)
        self.rf.__enter__()
        _local.ctx = _Ctx(True, self.ctx.call, self.id)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _local.ctx = self.ctx
        self.rf.__exit__(*exc)
        if not self.dropped:
            _REC.host.append(Span(self.id, self.name, self.ctx.call,
                                  self.ctx.parent, threading.get_ident(),
                                  self.t0, t1))
            if self.instrument is not None:
                _add(self.instrument, self.key, (t1 - self.t0) / 1e9)
        return False


def span(name: str, instrument: dict = None, key: str = None):
    """A context manager around host work, recorded while the public call
    records (a span of its own when it is one).  With ``instrument``, its
    seconds also go to ``instrument[key]`` (appended to a list, or added),
    recorded or not.  ``discard()`` drops it."""
    ctx = _local.ctx
    if ctx.on:
        return _Span(name, ctx, instrument, key)
    if instrument is not None:
        return _Timed(instrument, key)
    return _NULL


def spanned(name: str):
    """Decorator: each call of the function is a :func:`span` ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return run

    return wrap


class _Marks:
    """Marks on a device's current stream: CUDA events (host clocks on the
    CPU); ``last`` is the latest part's end."""

    __slots__ = ("ctx", "stream", "last")

    def __init__(self, ctx: _Ctx, device: torch.device):
        self.ctx, self.last = ctx, None
        self.stream = torch.cuda.current_stream(device) \
            if device.type == "cuda" else None

    def mark(self):
        if self.stream is None:
            return time.time_ns()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def __call__(self, name: str):
        return _Part(self, name)


class _Part:
    __slots__ = ("marks", "name", "a")

    def __init__(self, marks: _Marks, name: str):
        self.marks, self.name = marks, name

    def __enter__(self):
        m = self.marks
        self.a = m.last if m.last is not None else m.mark()
        return self

    def __exit__(self, *exc):
        m = self.marks
        m.last = b = m.mark()
        _REC.device.append((self.name, m.ctx.call, m.ctx.parent,
                            threading.get_ident(), self.a, b))
        return False


def _no_part(name: str):
    return _NULL


def device_parts(device):
    """A maker of consecutive device spans on ``device``: ``part(name)``
    is a context manager around work queued there, between two CUDA
    events on its current stream (host clocks on the CPU) resolved only by
    :func:`device_spans`.  Each part starts where the part before it
    ended, so the parts split the work between the first and the last
    mark, one event a boundary.  Recorded while the public call
    records."""
    ctx = _local.ctx
    if not ctx.on:
        return _no_part
    return _Marks(ctx, torch.device(device))


def count(name: str, n: int = 1, instrument: dict = None,
          key: str = None):
    """Add ``n`` to the counter ``name`` while the public call records;
    with ``instrument``, to ``instrument[key]`` too."""
    if _local.ctx.on:
        with _REC.lock:
            _REC.counts[name] = _REC.counts.get(name, 0) + n
    if instrument is not None:
        _add(instrument, key, n)


def entry(root: str = ""):
    """Decorator of a public call: at its entry on a thread outside any
    public call, test once whether the profiler runs; if it does, the
    call's spans record under a new id, in a span ``root`` when one is
    named.  A public call made inside another belongs to the outer one
    and opens no root of its own."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _local.ctx.call:
                return fn(*args, **kwargs)
            on = _profiler_running()
            _REC.session(on)
            _local.ctx = _Ctx(True, next(_REC.ids), 0) if on \
                else _UNRECORDED
            try:
                if on and root:
                    with span(root):
                        return fn(*args, **kwargs)
                return fn(*args, **kwargs)
            finally:
                _local.ctx = _OUTSIDE

        return call

    return wrap


def carry() -> _Ctx:
    """The calling thread's recording state, for a thread it starts."""
    return _local.ctx


@contextlib.contextmanager
def adopt(ctx: _Ctx):
    """Record the block, on a thread a public call started, as part of
    that call (``ctx`` from :func:`carry`)."""
    prev = _local.ctx
    _local.ctx = ctx
    try:
        yield
    finally:
        _local.ctx = prev


def spans() -> list:
    """The host spans held (:class:`Span`), in the order they ended."""
    return list(_REC.host)


def device_spans() -> list:
    """The device spans held (:class:`DeviceSpan`), each device's events
    waited for."""
    out = []
    for name, call, parent, tid, a, b in list(_REC.device):
        if isinstance(a, int):
            s = (b - a) / 1e9
        else:
            b.synchronize()
            s = a.elapsed_time(b) / 1e3
        out.append(DeviceSpan(name, call, parent, tid, s))
    return out


def counts() -> dict:
    """The counters held, by name."""
    with _REC.lock:
        return dict(_REC.counts)
