"""The device trace of a run's window: ``torch.profiler`` (CPU and CUDA
activity) from just before the first call to just after the last, read
from the profiler's raw events (no per-op tables are built).

Reduced to: the union of the device's activity intervals (kernels,
copies, sets) inside the window (``busy_s``) against the window's length
(``window_s``); device seconds by kernel name; and the idle gaps,
each named by the innermost host event under way at its middle (an op,
a runtime call, or the benchmark's own span)."""

from __future__ import annotations

import time

import numpy as np


def kernel_name(name: str) -> str:
    """A device event's name without its namespace, arguments and the
    ``void`` of a kernel's signature."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0].strip()[:120]


class Tracer:
    """Started by the constructor; :meth:`stop` ends it after the device
    has finished and returns the reduction of ``[t0_ns, t1_ns]`` (host
    wall-clock nanoseconds, the profiler's own clock)."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self, t0_ns: int, t1_ns: int) -> dict:
        self.torch.cuda.synchronize()
        self.prof.stop()
        cuda = self.torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            s, d = e.start_ns(), e.duration_ns()
            (dev if e.device_type() == cuda else host).append(
                (s, s + d, e.name()))
        self.prof = None
        return reduce(dev, host, t0_ns, t1_ns)


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of sorted ``starts`` with their ``ends``."""
    if len(starts) == 0:
        return starts, ends
    reach = np.maximum.accumulate(ends)
    new = np.empty(len(starts), bool)
    new[0] = True
    new[1:] = starts[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(starts) - 1)
    return starts[first], reach[last]


def reduce(dev: list, host: list, t0: int, t1: int, top: int = 10) -> dict:
    """``dev``, ``host``: (start_ns, end_ns, name) of device and host
    events; the window [t0, t1] in the same clock."""
    d = [(max(s, t0), min(e, t1), n) for s, e, n in dev if e > t0 and s < t1]
    d.sort()
    ds = np.array([x[0] for x in d], np.int64)
    de = np.array([x[1] for x in d], np.int64)
    us, ue = _union(ds, de)
    busy = int((ue - us).sum())
    by_kernel = {}
    for s, e, n in d:
        k = kernel_name(n)
        by_kernel[k] = by_kernel.get(k, 0) + (e - s)
    # idle gaps: before the first interval, between, after the last
    gs = np.concatenate([[t0], ue])
    ge = np.concatenate([us, [t1]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    host.sort()
    hs = np.array([h[0] for h in host], np.int64)
    he = np.array([h[1] for h in host], np.int64)
    idle = {}
    mids = (gs + ge) // 2
    at = np.searchsorted(hs, mids, side="right") - 1
    for g0, g1, mid, i in zip(gs, ge, mids, at):
        label = "host: no event"
        for j in range(i, max(i - 400, -1), -1):
            if he[j] >= mid:
                label = host[j][2][:120]
                break
        idle[label] = idle.get(label, 0) + int(g1 - g0)
    ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy / 1e9, window_s=(t1 - t0) / 1e9,
                kernel_s={k: v / 1e9 for k, v in by_kernel.items()},
                device_ops=[[k, v / 1e9] for k, v in ops],
                idle_gaps=[[k, v / 1e9] for k, v in gaps],
                gaps=int(len(gs)), device_events=len(d))


def now_ns() -> int:
    """Host wall-clock nanoseconds, the clock of the profiler's events."""
    return time.time_ns()
