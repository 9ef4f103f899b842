"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under this
package's ``_build/`` directory and loaded with ``ctypes``; a failed build
raises.  Nothing here runs at import time, so the package imports on a
machine without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs = {}
BUILD_LOG = {}          # name -> nvcc's output (registers, spills per kernel)
_lock = threading.Lock()
_name_locks = {}        # name -> lock: different sources build in parallel


def check_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (nothing
    falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.sep, "usr", "local", "cuda", "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load(name: str) -> ctypes.CDLL:
    """Build (if stale) and load ``csrc/<name>.cu``; raises on failure.

    Threads loading different sources run their ``nvcc`` concurrently."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        if not os.path.exists(so) or \
                os.path.getmtime(so) < os.path.getmtime(src):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            BUILD_LOG[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n"
                                   f"{BUILD_LOG[name]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _libs[name] = lib
        return lib
