"""Kernels B1 and B2, the two passes of the 2-bit GRM matvec.

``plane_dot_fwd`` (pass 1) and ``plane_dot_t`` (pass 2, the transpose) are
the counterparts of ``saigegds_tpu/ops/pallas_grm.py::plane_dot_fwd`` and
``::plane_dot_t``.  On a CUDA tensor each launches its hand-written Hopper
kernel in ``csrc/plane_dot.cu`` (which replaces the Pallas bodies
``_fwd_kernel`` and ``_t_kernel``); on a CPU tensor each runs its plain
PyTorch version.  Both return the same exact integers as f64: the kernels
accumulate in int32 (exact for N, M < 2^24), the plain versions in f64
(exact below 2^53).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

LAUNCHES = {"plane_dot_fwd": 0, "plane_dot_t": 0}   # kernel launches only
MAX_AXIS = 1 << 24      # int32 exactness bound: 128 * (N or M) < 2^31
_CHUNK_J = 8192         # byte columns per plain-version step
_CHUNK_M = 4096         # variants per plain-version step (f64 decode of one
#                         step: 4096 x 8192 x 8 B = 268 MB)


def _planes(pc: torch.Tensor):
    """int32 packed bytes -> the four planes' codes as f64."""
    return [((pc >> (2 * p)) & 3).to(torch.float64) for p in range(4)]


def plane_dot_fwd_plain(packed: torch.Tensor,
                        d4: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B1: decode chunks of rows and byte columns
    to f64 and contract with ``torch.matmul``.

    packed: uint8 [M, N4]; d4: int8 [4, N4, C] -> f64 [M, C]."""
    M, N4 = packed.shape
    out = torch.zeros(M, d4.shape[2], dtype=torch.float64,
                      device=packed.device)
    for j0 in range(0, N4, _CHUNK_J):
        v = d4[:, j0:j0 + _CHUNK_J].to(torch.float64)
        for m0 in range(0, M, _CHUNK_M):
            pc = packed[m0:m0 + _CHUNK_M, j0:j0 + _CHUNK_J].to(torch.int32)
            for p, t in enumerate(_planes(pc)):
                out[m0:m0 + _CHUNK_M] += t @ v[p]
    return out


def plane_dot_t_plain(packed: torch.Tensor, dm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B2: the same decode, contracted over
    variants.

    packed: uint8 [M, N4]; dm: int8 [M, C] -> f64 [4, N4, C]."""
    M, N4 = packed.shape
    out = torch.zeros(4, N4, dm.shape[1], dtype=torch.float64,
                      device=packed.device)
    for m0 in range(0, M, _CHUNK_M):
        dmf = dm[m0:m0 + _CHUNK_M].to(torch.float64)
        for j0 in range(0, N4, _CHUNK_J):
            pc = packed[m0:m0 + _CHUNK_M, j0:j0 + _CHUNK_J].to(torch.int32)
            for p, t in enumerate(_planes(pc)):
                out[p, j0:j0 + _CHUNK_J] += t.T @ dmf
    return out


def _check(packed: torch.Tensor, rhs: torch.Tensor, fwd: bool):
    name = "d4" if fwd else "dm"
    if packed.dtype != torch.uint8 or rhs.dtype != torch.int8:
        raise TypeError(f"expected uint8 packed and int8 {name}, got "
                        f"{packed.dtype} and {rhs.dtype}")
    if fwd:
        ok = rhs.dim() == 3 and rhs.shape[0] == 4 and \
            rhs.shape[1] == packed.shape[1]
        want = "[M, N4], [4, N4, C]"
    else:
        ok = rhs.dim() == 2 and rhs.shape[0] == packed.shape[0]
        want = "[M, N4], [M, C]"
    if packed.dim() != 2 or not ok:
        raise ValueError(f"shape mismatch: packed {tuple(packed.shape)}, "
                         f"{name} {tuple(rhs.shape)} (want {want})")
    if rhs.shape[-1] % 128:
        raise ValueError(f"C={rhs.shape[-1]} must be a multiple of 128 "
                         "(pad the slices)")
    M, N4 = packed.shape
    if 4 * N4 >= MAX_AXIS or M >= MAX_AXIS:
        raise ValueError(f"{M} variants x {4 * N4} samples exceed the int32 "
                         f"exactness bound of {MAX_AXIS}")
    if packed.device != rhs.device:
        raise ValueError(f"packed on {packed.device}, {name} on "
                         f"{rhs.device}")


_ENTRY = {}             # name -> the configured C entry point


def _kernel_fn(name: str):
    """The C entry point ``sg_<name>`` of ``csrc/plane_dot.cu`` (built at
    first use), with its ctypes signature; set up once per name."""
    fn = _ENTRY.get(name)
    if fn is None:
        fn = getattr(_cuda.load("plane_dot"), f"sg_{name}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY[name] = fn
    return fn


def _launch(name: str, packed: torch.Tensor, rhs: torch.Tensor,
            out_shape) -> torch.Tensor:
    """Launch one kernel on the current stream -> int32 ``out_shape``."""
    if not (packed.is_contiguous() and rhs.is_contiguous()):
        raise ValueError(f"{name} needs contiguous operands")
    if rhs.data_ptr() % 4:
        raise ValueError(f"the slices of {name} must be 4-byte aligned")
    fn = _kernel_fn(name)
    M, N4 = packed.shape
    out = torch.empty(out_shape, dtype=torch.int32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device)
    err = fn(packed.data_ptr(), rhs.data_ptr(), out.data_ptr(), M, N4,
             rhs.shape[-1],
             packed.device.index if packed.device.index is not None
             else torch.cuda.current_device(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def plane_dot_fwd(packed: torch.Tensor, d4: torch.Tensor) -> torch.Tensor:
    """GRM pass 1: [M, N4] planar 2-bit codes x [4, N4, C] int8 slices ->
    f64 [M, C].

    A CUDA tensor goes through kernel B1 (or raises); a CPU tensor through
    the plain version."""
    _check(packed, d4, fwd=True)
    if packed.device.type == "cuda":
        return _launch("plane_dot_fwd", packed, d4,
                       (packed.shape[0], d4.shape[2])).to(torch.float64)
    if packed.device.type == "cpu":
        return plane_dot_fwd_plain(packed, d4)
    raise ValueError(f"unsupported device {packed.device}")


def plane_dot_t(packed: torch.Tensor, dm: torch.Tensor) -> torch.Tensor:
    """GRM pass 2: per-plane [M, N4]' x [M, C] int8 slices -> f64
    [4, N4, C].

    A CUDA tensor goes through kernel B2 (or raises); a CPU tensor through
    the plain version."""
    _check(packed, dm, fwd=False)
    if packed.device.type == "cuda":
        return _launch("plane_dot_t", packed, dm,
                       (4, packed.shape[1], dm.shape[1])).to(torch.float64)
    if packed.device.type == "cpu":
        return plane_dot_t_plain(packed, dm)
    raise ValueError(f"unsupported device {packed.device}")
