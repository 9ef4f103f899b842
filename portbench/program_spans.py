"""The program's own spans and counters of the traced window, as its
recorder holds them (``saigegds_tpu_torch/utils/profiling.py``: host
spans, device spans and counters, recorded while ``torch.profiler``
runs), for the per-layer metrics that read them.  A program without
that recorder gives nothing to read."""

from __future__ import annotations


class Recorded:
    """The recorder's spans and counts, read once."""

    def __init__(self, prof):
        self.host = prof.spans()
        self.device = prof.device_spans()
        self.counts = prof.counts()

    def n(self, name: str) -> int:
        """The host spans named ``name``."""
        return sum(1 for s in self.host if s.name == name)

    def host_s(self, name: str) -> float:
        """Seconds of the host spans named ``name``."""
        return sum(s.end_ns - s.start_ns for s in self.host
                   if s.name == name) / 1e9

    def device_s(self, *names: str) -> float:
        """Device seconds of the device spans of ``names``."""
        return sum(d.seconds for d in self.device if d.name in names)


def recorded(ctx):
    """The program's recording of a traced window, or None without a
    trace or where the program records no spans."""
    if ctx.get("trace") is None:
        return None
    try:
        from saigegds_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in
               ("spans", "device_spans", "counts")):
        return None
    return Recorded(profiling)
