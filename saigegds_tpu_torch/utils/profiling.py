"""Device introspection and profiling hooks, the counterparts of
``saigegds_tpu/utils/profiling.py``.

The reference exposes a SIMD-dispatch introspection call (``SIMD()`` ->
``saige_simd_version``, R/saige_main.r:64, src/vectorization.cpp:33-94) and
brackets phases with wall-clock prints (R/saige_main.r:260-261).  Here: a
report of torch, CUDA and the card, a wall clock that waits for the card,
and ``torch.profiler`` traces in Chrome's format.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Iterator

import torch

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
    """Trace the block with ``torch.profiler`` (the CPU, and the card when
    ``device`` is one) and write a Chrome trace, ``trace.json``, into
    ``logdir``.  Yields the profiler (its ``key_averages()`` give the
    time by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    dev = check_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        _sync(dev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
