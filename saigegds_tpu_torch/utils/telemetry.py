"""Structured convergence telemetry (the reference's verbose prints,
machine-readable).

The reference emits tau per outer iteration (src/saige_fitnull.cpp:
1027-1031), trace-CV escalation notices (:661-663) and per-marker variance
ratios (:1335-1339) as text when ``verbose``.  Here the same quantities are
collected as event dicts on a context collector — the fit attaches them to
``NullModel.fit_log`` so convergence behaviour is diff-able in tests and
log pipelines — and printed as JSON lines when verbose.
"""

from __future__ import annotations

import contextlib
import contextvars
import json

# a ContextVar so concurrent fits (threads/async) don't cross-attach
# events or clobber each other's collector on context exit
_current: contextvars.ContextVar = contextvars.ContextVar(
    "saigegds_telemetry", default=None)


class FitTelemetry:
    def __init__(self, verbose: bool = False):
        self.events = []
        self.verbose = verbose

    def emit(self, event: str, **kw):
        rec = {"event": event, **kw}
        self.events.append(rec)
        if self.verbose:
            print("    " + json.dumps(rec, default=_jsonable))

    def select(self, event: str):
        return [e for e in self.events if e["event"] == event]


def _jsonable(x):
    try:
        return x.tolist()
    except AttributeError:
        return float(x)


@contextlib.contextmanager
def collect(verbose: bool = False):
    """Collect fit telemetry for the duration of the context."""
    token = _current.set(FitTelemetry(verbose))
    try:
        yield _current.get()
    finally:
        _current.reset(token)


def emit(event: str, **kw):
    """Emit an event into the active collector (no-op outside one)."""
    t = _current.get()
    if t is not None:
        t.emit(event, **kw)
