"""ctypes loader for the native host kernels (``native/fastio.cpp``).

Builds ``_fastio.so`` on first use with g++ from this package's own copy
``saigegds_tpu_torch/native/fastio.cpp`` (byte-identical to the JAX
package's ``saigegds_tpu/native/fastio.cpp``) into this package's
``_build/`` directory; every entry point has a numpy fallback, so the
package works without a compiler — the native path just makes large-file
ingestion several times faster.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_PKG_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
_SRC = os.path.join(_PKG_DIR, "native", "fastio.cpp")
_SO = os.path.join(_PKG_DIR, "_build", "_fastio.so")

_lib = None
_tried = False


def _build() -> None:
    """Compile ``_SO`` when it is missing or older than its source (the
    flags of the JAX package's native/Makefile); written to a temporary name
    and renamed, so a concurrent loader never maps a half-written file."""
    if os.path.exists(_SO) and \
            os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    subprocess.run([os.environ.get("CXX", "g++"), "-O3", "-march=native",
                    "-fPIC", "-shared", "-std=c++17", "-pthread",
                    "-o", tmp, _SRC],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, _SO)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        _build()
    except (OSError, subprocess.SubprocessError):
        if not os.path.exists(_SO):
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.sg_unpack_bit2.argtypes = [u8p, ctypes.c_size_t, u8p]
    lib.sg_vstr8_offsets.argtypes = [u8p, ctypes.c_size_t, ctypes.c_size_t,
                                     i64p, i64p]
    lib.sg_vstr8_offsets.restype = ctypes.c_int64
    lib.sg_geno_fold.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, i8p]
    lib.sg_bit2_dosage.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, i8p]
    lib.sg_bit2_dosage_off.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int64, i8p]
    lib.sg_bit2_dosage_f64.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                       f64p]
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.sg_sparse_encode.argtypes = [i8p, ctypes.c_int64, ctypes.c_int64,
                                     u16p, i64p]
    lib.sg_sparse_encode.restype = ctypes.c_int64
    try:   # round-3 kernels; a stale .so degrades to the numpy fallbacks
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.sg_variant_moments.argtypes = [i8p, ctypes.c_int64,
                                           ctypes.c_int64, f64p, f64p, f64p,
                                           i64p]
        lib.sg_missing_pairs.argtypes = [i8p, ctypes.c_int64, ctypes.c_int64,
                                         i64p, i32p, i32p]
        lib.sg_pack2_zeroed.argtypes = [i8p, ctypes.c_int64, ctypes.c_int64,
                                        u8p]
    except AttributeError:
        pass
    try:   # round-5 kernel
        lib.sg_pack2_raw.argtypes = [i8p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, u8p]
    except AttributeError:
        pass
    _lib = lib
    return _lib


def variant_moments(codes: np.ndarray):
    """Threaded one-pass GRM-build moments (af, inv, diag, missing pairs)
    from int8 codes [M, N]; None when the library isn't available."""
    lib = _load()
    if lib is None or not hasattr(lib, "sg_variant_moments"):
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    M, N = codes.shape
    af = np.empty(M, np.float64)
    inv = np.empty(M, np.float64)
    diag = np.zeros(N, np.float64)
    mc = np.empty(M, np.int64)
    lib.sg_variant_moments(codes, M, N, af, inv, diag, mc)
    offs = np.zeros(M, np.int64)
    np.cumsum(mc[:-1], out=offs[1:])
    nnz = int(offs[-1] + mc[-1]) if M else 0
    mv = np.empty(nnz, np.int32)
    ms = np.empty(nnz, np.int32)
    if nnz:
        lib.sg_missing_pairs(codes, M, N, offs, mv, ms)
    return af, inv, diag, mv, ms


def pack2_zeroed(codes: np.ndarray):
    """Threaded planar 2-bit pack of int8 codes with missing zeroed
    (ops/packed_grm.pack_codes_2bit on np.where(codes < 3, codes, 0));
    None when the library isn't available."""
    lib = _load()
    if lib is None or not hasattr(lib, "sg_pack2_zeroed"):
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    M, N = codes.shape
    out = np.empty((M, -(-N // 4)), np.uint8)
    lib.sg_pack2_zeroed(codes, M, N, out)
    return out


def pack2_raw(codes: np.ndarray, pad_rows: int = 0):
    """Threaded planar 2-bit pack PRESERVING missing (code 3): the exact
    native twin of ops/packed_grm.pack_codes_2bit on
    ``_pad_block(codes, pad_rows, fill=3)``; None when unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "sg_pack2_raw"):
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    M, N = codes.shape
    R = max(M, pad_rows)
    out = np.empty((R, -(-N // 4)), np.uint8)
    lib.sg_pack2_raw(codes, M, N, R, out)
    return out


def bit2_dosage_into(src: np.ndarray, geno_offset: int, mn: int,
                     ploidy: int, out: np.ndarray) -> bool:
    """Fused 2-bit decode written INTO a caller-provided contiguous int8
    slice (no allocation, no source copy) — the streamed block iterator's
    per-chunk fold.  Returns False when the native library is missing."""
    lib = _load()
    if lib is None:
        return False
    assert out.dtype == np.int8 and out.flags.c_contiguous
    lib.sg_bit2_dosage_off(src, geno_offset, mn, ploidy, out)
    return True


def sparse_encode(codes: np.ndarray,
                  nnz: Optional[int] = None):
    """Gap-coded sparse transport encode (ops/sparse_codes semantics) via
    the SIMD C kernel; returns None when the library isn't available
    (callers fall back to the vectorized numpy encoder)."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    B, N = codes.shape
    if nnz is None:
        nnz = int(np.count_nonzero(codes))
    cap = nnz + B * (N // 16384 + 2)
    out = np.empty(max(cap, 1), np.uint16)
    row_ptr = np.empty(B + 1, np.int64)
    k = lib.sg_sparse_encode(codes, B, N, out, row_ptr)
    return out[:k], row_ptr.astype(np.int32)


def available() -> bool:
    return _load() is not None


_heap_reuse_done = False


def enable_heap_reuse() -> bool:
    """Keep freed large buffers in the process heap (glibc mallopt).

    By default glibc serves >128 KB allocations via mmap and returns them
    to the OS on free, so every per-block decode buffer re-faults its
    pages; on virtualized hosts first-touch can run at ~60 MB/s while
    warm memory moves at ~9 GB/s — page faults, not the decode kernels,
    dominate the data plane.  Disabling mmap'd allocations and heap trim
    makes the steady-state block loop reuse warm pages (the reference's
    C++ data plane gets this for free from its long-lived arenas).
    """
    global _heap_reuse_done
    if _heap_reuse_done:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_MAX, M_ARENA_MAX = -1, -4, -8
        libc.mallopt(M_MMAP_MAX, 0)
        libc.mallopt(M_TRIM_THRESHOLD, -1)
        # one shared arena: worker-thread allocations (parallel frame
        # inflate) reuse the same warm heap instead of per-thread mmaps
        libc.mallopt(M_ARENA_MAX, 1)
        _heap_reuse_done = True
    except OSError:
        return False
    return True


_prefault_done = 0


def prefault_heap(nbytes: int, background: bool = True) -> None:
    """Fault in ~nbytes of heap ahead of the first big decode pass.

    First-touch page faults are the data plane's real cold-start cost on
    virtualized hosts (~60 MB/s single-threaded); they parallelize ~3x
    across threads, and with enable_heap_reuse() the faulted pages stay
    in the heap for every later allocation.  Run in the background so the
    warmup overlaps setup work (e.g. XLA compilation)."""
    global _prefault_done
    import threading

    nbytes = int(nbytes)
    if nbytes <= _prefault_done or not enable_heap_reuse():
        return
    want = nbytes - _prefault_done
    _prefault_done = nbytes

    def work():
        global _prefault_done
        try:
            libc = ctypes.CDLL("libc.so.6")
            libc.memset.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_size_t]
            chunks = [np.empty(-(-want // 4), np.uint8) for _ in range(4)]
            ts = [threading.Thread(
                      target=lambda a: libc.memset(
                          a.ctypes.data_as(ctypes.c_void_p), 0, a.nbytes),
                      args=(c,), daemon=True) for c in chunks]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        except MemoryError:
            _prefault_done = 0      # didn't happen; let a later call retry

    runner = threading.Thread(target=work, daemon=True)
    runner.start()
    if not background:
        runner.join()


def unpack_bit2(data: bytes, n: int) -> np.ndarray:
    """Unpack a dBit2 byte stream into n uint8 codes."""
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8)
    if lib is not None:
        dst = np.empty(len(src) * 4, dtype=np.uint8)
        lib.sg_unpack_bit2(src, len(src), dst)
        return dst[:n]
    out = np.empty((len(src), 4), dtype=np.uint8)
    out[:, 0] = src & 3
    out[:, 1] = (src >> 2) & 3
    out[:, 2] = (src >> 4) & 3
    out[:, 3] = (src >> 6) & 3
    return out.reshape(-1)[:n]


def vstr8_strings(data: bytes, n: int) -> np.ndarray:
    """Decode n LEB128-length-prefixed strings into an object array."""
    lib = _load()
    arr = np.empty(n, dtype=object)
    if lib is not None and n:
        src = np.frombuffer(data, dtype=np.uint8)
        starts = np.empty(n, dtype=np.int64)
        ends = np.empty(n, dtype=np.int64)
        used = lib.sg_vstr8_offsets(src, len(src), n, starts, ends)
        if used >= 0:
            for i in range(n):
                arr[i] = data[starts[i]:ends[i]].decode("utf-8",
                                                        errors="replace")
            return arr
    p = 0
    for i in range(n):
        m = 0
        shift = 0
        while True:
            byte = data[p]
            p += 1
            m |= (byte & 0x7F) << shift
            if byte < 0x80:
                break
            shift += 7
        arr[i] = data[p:p + m].decode("utf-8", errors="replace")
        p += m
    return arr


def bit2_dosage_codes(data: bytes, mn: int, ploidy: int) -> np.ndarray:
    """Fused 2-bit stream -> [mn] int8 ALT dosage codes (3 = missing)."""
    lib = _load()
    if lib is not None:
        src = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(mn, dtype=np.int8)
        lib.sg_bit2_dosage(src, mn, ploidy, out)
        return out
    codes = unpack_bit2(data, mn * ploidy).reshape(mn, ploidy)
    miss = (codes == 3).any(axis=1)
    ds = codes.sum(axis=1, dtype=np.int16)
    return np.where(miss | (ds > 2), 3, ds).astype(np.int8)


def bit2_dosage_codes_off(data, geno_offset: int, mn: int,
                          ploidy: int) -> np.ndarray:
    """Fused 2-bit stream -> int8 codes, starting geno_offset codes in."""
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8) if isinstance(data, bytes) \
        else np.ascontiguousarray(data, dtype=np.uint8)
    if lib is not None:
        out = np.empty(mn, dtype=np.int8)
        lib.sg_bit2_dosage_off(src, geno_offset, mn, ploidy, out)
        return out
    codes = unpack_bit2(src.tobytes(), geno_offset + mn * ploidy)
    codes = codes[geno_offset:].reshape(mn, ploidy)
    miss = (codes == 3).any(axis=1)
    ds = codes.sum(axis=1, dtype=np.int16)
    return np.where(miss | (ds > 2), 3, ds).astype(np.int8)


def bit2_dosage_f64(data: bytes, mn: int, ploidy: int) -> np.ndarray:
    """Fused 2-bit stream -> [mn] float64 ALT dosages (NaN = missing)."""
    lib = _load()
    if lib is not None:
        src = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(mn, dtype=np.float64)
        lib.sg_bit2_dosage_f64(src, mn, ploidy, out)
        return out
    codes = bit2_dosage_codes(data, mn, ploidy).astype(np.float64)
    codes[codes == 3] = np.nan
    return codes
