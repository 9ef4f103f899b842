"""Kernels B3 and B4, scan phase 1: exact indicator contractions of
genotype codes with the sliced model vectors.

``indicator_dot_2bit`` (B3) is the counterpart of
``saigegds_tpu/ops/pallas_score.py::indicator_dot_2bit`` on planar 2-bit
blocks; ``indicator_dot`` (B4) is the counterpart of
``saigegds_tpu/ops/pallas_score.py::indicator_dot`` on int8 codes.  On a
CUDA tensor each launches its hand-written Hopper kernel
(``csrc/indicator_dot_2bit.cu`` replacing the Pallas body ``_kernel2``,
``csrc/indicator_dot.cu`` replacing ``_kernel``); on a CPU tensor it runs
its plain PyTorch version.  Both return the same exact integers: the
kernels contract on the int8 tensor cores (``mma.sync`` m16n8k32, s8 x s8
with s32 accumulators; exact for N < 2^24), the plain versions in f64
(exact below 2^53).  The kernels take codes whose rows start at any byte
(N or N4 not a multiple of 4, or a view into a buffer); the slices must be
4-byte aligned.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

# kernel launches (not plain-version calls)
LAUNCHES = {"indicator_dot_2bit": 0, "indicator_dot": 0}
MAX_SAMPLES = 1 << 24   # int32 exactness bound: 128 * N < 2^31
_CHUNK = 16384          # byte columns (or samples) per plain-version step


def indicator_dot_2bit_plain(packed: torch.Tensor,
                             vs4: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B3: decode the planes of byte-column
    chunks into f64 indicators and contract them with ``torch.matmul``.

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
            _accumulate(out, t, v)
    return out


def indicator_dot_plain(codes: torch.Tensor,
                        vs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B4: the same three contractions from int8
    codes [B, N] (3 = missing) against int8 slices vs [N, C], sample chunk
    by sample chunk -> f64 [B, 3, C]."""
    B, N = codes.shape
    out = torch.zeros(B, 3, vs.shape[1], dtype=torch.float64,
                      device=codes.device)
    for s0 in range(0, N, _CHUNK):
        _accumulate(out, codes[:, s0:s0 + _CHUNK],
                    vs[s0:s0 + _CHUNK].to(torch.float64))
    return out


def _accumulate(out: torch.Tensor, t: torch.Tensor, v: torch.Tensor):
    """out[:, 0/1/2] += (g0 / missing / hom-ALT indicators of codes t) @ v."""
    g0 = torch.where(t == 3, 0, t).to(torch.float64)
    out[:, 0] += g0 @ v
    out[:, 1] += (t == 3).to(torch.float64) @ v
    out[:, 2] += (t == 2).to(torch.float64) @ v


def _check(name: str, x: torch.Tensor, xdtype, v: torch.Tensor,
           n_samples: int, shapes_ok: bool, want: str):
    if x.dtype != xdtype or v.dtype != torch.int8:
        raise TypeError(f"{name}: expected {xdtype} codes and int8 slices, "
                        f"got {x.dtype} and {v.dtype}")
    if not shapes_ok:
        raise ValueError(f"{name}: shape mismatch {tuple(x.shape)}, "
                         f"{tuple(v.shape)} (want {want})")
    if v.shape[-1] % 128:
        raise ValueError(f"C={v.shape[-1]} must be a multiple of 128 "
                         "(pad the slices)")
    if n_samples >= MAX_SAMPLES:
        raise ValueError(f"{n_samples} samples exceed the int32 exactness "
                         f"bound of {MAX_SAMPLES}")
    if x.device != v.device:
        raise ValueError(f"{name}: codes on {x.device}, slices on {v.device}")


_ENTRY = {}             # name -> the configured C entry point, once loaded


def _kernel_fn(name: str):
    """The C entry point ``sg_<name>`` of ``csrc/<name>.cu`` (built at
    first use), with its ctypes signature; set up once."""
    if name not in _ENTRY:
        fn = getattr(_cuda.load(name), f"sg_{name}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY[name] = fn
    return _ENTRY[name]


def _launch(name: str, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch kernel ``name`` on the current stream with x [B, n] and
    slices v [..., C] -> int32 [B, 3, C]."""
    if not (x.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} needs contiguous operands")
    if v.data_ptr() % 4:
        raise ValueError(f"{name}: the slices must be 4-byte aligned")
    fn = _kernel_fn(name)
    B, n = x.shape
    C = v.shape[-1]
    out = torch.empty(B, 3, C, dtype=torch.int32, device=x.device)
    dev = x.device
    err = fn(x.data_ptr(), v.data_ptr(), out.data_ptr(), B, n, C,
             dev.index if dev.index is not None
             else torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def indicator_dot_2bit(packed: torch.Tensor,
                       vs4: torch.Tensor) -> torch.Tensor:
    """B3: [B, N4] planar 2-bit packed codes x [4, N4, C] int8 plane-split
    slices -> f64 [B, 3, C] (g0 / missing / hom-ALT contractions).

    A CUDA tensor goes through the hand-written kernel (or raises); a CPU
    tensor through the plain version."""
    _check("indicator_dot_2bit", packed, torch.uint8, vs4,
           4 * packed.shape[-1],
           packed.dim() == 2 and vs4.dim() == 3 and vs4.shape[0] == 4
           and vs4.shape[1] == packed.shape[1], "[B, N4], [4, N4, C]")
    if packed.device.type == "cuda":
        return _launch("indicator_dot_2bit", packed, vs4).to(torch.float64)
    if packed.device.type == "cpu":
        return indicator_dot_2bit_plain(packed, vs4)
    raise ValueError(f"unsupported device {packed.device}")


def indicator_dot(codes: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """B4: [B, N] int8 codes (3 = missing) x [N, C] int8 slices -> f64
    [B, 3, C] (g0 / missing / hom-ALT contractions).

    A CUDA tensor goes through the hand-written kernel (or raises); a CPU
    tensor through the plain version."""
    _check("indicator_dot", codes, torch.int8, vs, codes.shape[-1],
           codes.dim() == 2 and vs.dim() == 2
           and vs.shape[0] == codes.shape[1], "[B, N], [N, C]")
    if codes.device.type == "cuda":
        return _launch("indicator_dot", codes, vs).to(torch.float64)
    if codes.device.type == "cpu":
        return indicator_dot_plain(codes, vs)
    raise ValueError(f"unsupported device {codes.device}")
