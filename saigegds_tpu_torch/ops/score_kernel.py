"""Kernel B3, scan phase 1: fused 2-bit decode + exact indicator contraction.

``indicator_dot_2bit`` is the counterpart of
``saigegds_tpu/ops/pallas_score.py::indicator_dot_2bit``.  On a CUDA tensor
it launches the hand-written Hopper kernel ``csrc/indicator_dot_2bit.cu``
(which replaces the Pallas body ``_kernel2``); on a CPU tensor it runs the
plain PyTorch version, :func:`indicator_dot_2bit_plain`.  Both return the
same exact integers: the kernel accumulates in int32 (exact for N < 2^24),
the plain version in f64 (exact below 2^53).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

LAUNCHES = 0            # kernel launches (not plain-version calls)
MAX_SAMPLES = 1 << 24   # int32 exactness bound: 128 * N < 2^31
_CHUNK = 16384          # byte columns per plain-version step


def indicator_dot_2bit_plain(packed: torch.Tensor,
                             vs4: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: decode the planes of byte-column chunks into
    f64 indicators and contract them with ``torch.matmul``.

    packed: uint8 [B, N4]; vs4: int8 [4, N4, C] -> f64 [B, 3, C] (g0 with
    missing as 0, missing indicator, hom-ALT indicator)."""
    B, N4 = packed.shape
    C = vs4.shape[2]
    out = torch.zeros(B, 3, C, dtype=torch.float64, device=packed.device)
    for j0 in range(0, N4, _CHUNK):
        pc = packed[:, j0:j0 + _CHUNK].to(torch.int32)
        for p in range(4):
            t = (pc >> (2 * p)) & 3
            v = vs4[p, j0:j0 + _CHUNK].to(torch.float64)
            g0 = torch.where(t == 3, 0, t).to(torch.float64)
            out[:, 0] += g0 @ v
            out[:, 1] += (t == 3).to(torch.float64) @ v
            out[:, 2] += (t == 2).to(torch.float64) @ v
    return out


def _check(packed: torch.Tensor, vs4: torch.Tensor):
    if packed.dtype != torch.uint8 or vs4.dtype != torch.int8:
        raise TypeError(f"expected uint8 packed and int8 vs4, got "
                        f"{packed.dtype} and {vs4.dtype}")
    if packed.dim() != 2 or vs4.dim() != 3 or vs4.shape[0] != 4 or \
            vs4.shape[1] != packed.shape[1]:
        raise ValueError(f"shape mismatch: packed {tuple(packed.shape)}, "
                         f"vs4 {tuple(vs4.shape)} (want [B, N4], [4, N4, C])")
    if vs4.shape[2] % 128:
        raise ValueError(f"C={vs4.shape[2]} must be a multiple of 128 "
                         "(pad the slices)")
    if 4 * packed.shape[1] >= MAX_SAMPLES:
        raise ValueError(f"{4 * packed.shape[1]} samples exceed the int32 "
                         f"exactness bound of {MAX_SAMPLES}")
    if packed.device != vs4.device:
        raise ValueError(f"packed on {packed.device}, vs4 on {vs4.device}")


_ENTRY = []             # the configured C entry point, once loaded


def _kernel_fn():
    """The C entry point of ``csrc/indicator_dot_2bit.cu`` (built at first
    use), with its ctypes signature; set up once."""
    if not _ENTRY:
        fn = _cuda.load("indicator_dot_2bit").sg_indicator_dot_2bit
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def _launch(packed: torch.Tensor, vs4: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream -> int32 [B, 3, C]."""
    global LAUNCHES
    if not (packed.is_contiguous() and vs4.is_contiguous()):
        raise ValueError("indicator_dot_2bit needs contiguous operands")
    if vs4.data_ptr() % 4:
        raise ValueError("vs4 must be 4-byte aligned")
    fn = _kernel_fn()
    B, N4 = packed.shape
    C = vs4.shape[2]
    out = torch.empty(B, 3, C, dtype=torch.int32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device)
    err = fn(packed.data_ptr(), vs4.data_ptr(), out.data_ptr(), B, N4, C,
             packed.device.index if packed.device.index is not None
             else torch.cuda.current_device(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"indicator_dot_2bit launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def indicator_dot_2bit(packed: torch.Tensor,
                       vs4: torch.Tensor) -> torch.Tensor:
    """[B, N4] planar 2-bit packed codes x [4, N4, C] int8 plane-split
    slices -> f64 [B, 3, C] (g0 / missing / hom-ALT contractions).

    A CUDA tensor goes through the hand-written kernel (or raises); a CPU
    tensor through the plain version."""
    _check(packed, vs4)
    if packed.device.type == "cuda":
        return _launch(packed, vs4).to(torch.float64)
    if packed.device.type == "cpu":
        return indicator_dot_2bit_plain(packed, vs4)
    raise ValueError(f"unsupported device {packed.device}")
