"""The sample gather of planar 2-bit code blocks on the device.

A scan block ships 2-bit planar over all of its GDS samples
(``ops/packed_grm.pack_codes_2bit``) and is gathered here, after the
upload, to the models' samples: :func:`gather_2bit` returns byte for byte
``pack_codes_2bit(np.take(G, cols, axis=1))`` of the block's codes ``G``.
On a CUDA tensor it launches the hand-written kernel of
``csrc/gather_2bit.cu`` (which replaces no TPU kernel: the JAX package
gathers on the host); on a CPU tensor it runs the plain PyTorch version
:func:`gather_2bit_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

# kernel launches (not plain-version calls)
LAUNCHES = {"gather_2bit": 0}
_ENTRY = []             # the configured C entry point, once loaded


def gather_2bit_plain(packed: torch.Tensor,
                      cols: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unpack column ``cols[m]`` of each row (byte
    ``cols[m] % N4``, plane ``cols[m] // N4``) and pack the gathered codes
    again.  packed: uint8 [B, N4]; cols: int32 [n] -> uint8 [B,
    ceil(n / 4)].  A column outside the row raises IndexError."""
    B, n4 = packed.shape
    n = cols.shape[0]
    n4o = -(-n // 4)
    pos = cols.to(torch.int64)
    if n and (pos.min() < 0 or pos.max() >= 4 * n4):
        raise IndexError(f"gather_2bit: a column outside [0, {4 * n4})")
    shift = (2 * (pos // n4)).to(torch.uint8)
    codes = (packed[:, pos % n4] >> shift) & 3
    planes = torch.zeros(B, 4 * n4o, dtype=torch.uint8, device=packed.device)
    planes[:, :n] = codes
    planes = planes.view(B, 4, n4o)
    return planes[:, 0] | (planes[:, 1] << 2) | (planes[:, 2] << 4) | \
        (planes[:, 3] << 6)


def _entry():
    """The C entry point ``sg_gather_2bit`` (built at first use), with its
    ctypes signature; set up once."""
    if not _ENTRY:
        fn = _cuda.load("gather_2bit").sg_gather_2bit
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + \
            [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def gather_2bit(packed: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Gather planar 2-bit rows to the columns ``cols``: uint8 [B, N4] and
    int32 [n] column indices in [0, 4 N4) -> uint8 [B, ceil(n / 4)], byte
    ``k`` of a row holding columns ``k``, ``n4 + k``, ``2 n4 + k``, ``3 n4
    + k`` (n4 = ceil(n / 4)) in bit pairs 0/2/4/6, 0 past ``n``.

    A CUDA tensor goes through the hand-written kernel on the current
    stream (or raises); a CPU tensor through the plain version.  The
    kernel reads a column outside the row as 0, where the plain version
    raises: the indices are the caller's to check, once, on the host."""
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise TypeError(f"gather_2bit: expected uint8 [B, N4] codes, got "
                        f"{packed.dtype} {tuple(packed.shape)}")
    if cols.dtype != torch.int32 or cols.dim() != 1:
        raise TypeError(f"gather_2bit: expected int32 [n] columns, got "
                        f"{cols.dtype} {tuple(cols.shape)}")
    if cols.device != packed.device:
        raise ValueError(f"gather_2bit: codes on {packed.device}, columns "
                         f"on {cols.device}")
    if packed.device.type == "cpu":
        return gather_2bit_plain(packed, cols)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    if not (packed.is_contiguous() and cols.is_contiguous()):
        raise ValueError("gather_2bit needs contiguous operands")
    B, n4 = packed.shape
    n = cols.shape[0]
    out = torch.empty(B, -(-n // 4), dtype=torch.uint8, device=packed.device)
    if out.numel() == 0:
        return out
    dev = packed.device
    err = _entry()(packed.data_ptr(), cols.data_ptr(), out.data_ptr(), B, n4,
                   n, dev.index if dev.index is not None
                   else torch.cuda.current_device(),
                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_2bit launch failed: CUDA error {err}")
    LAUNCHES["gather_2bit"] += 1
    return out
