"""Kernels B1 and B2, the two passes of the 2-bit GRM matvec.

``plane_dot_fwd`` (pass 1) and ``plane_dot_t`` (pass 2, the transpose) are
the counterparts of ``saigegds_tpu/ops/pallas_grm.py::plane_dot_fwd`` and
``::plane_dot_t``.  On a CUDA tensor each launches its hand-written Hopper
kernel in ``csrc/plane_dot.cu`` (which replaces the Pallas bodies
``_fwd_kernel`` and ``_t_kernel``); on a CPU tensor each runs its plain
PyTorch version.  Both return the same exact integers as f64: the kernels
contract on the int8 tensor cores (``wgmma`` m64nNk32, s8 x s8 with s32
accumulators; exact for N, M < 2^24), the plain versions in f64 (exact
below 2^53).  The kernels read the store through a TMA tensor map, whose
rows must start 16-byte aligned, so on a CUDA tensor N4 must be a multiple
of 16 (the GRM store's width, ``packed_grm.store_width``); the plain
versions take any N4.  The slices' column count C is one the kernels run,
``padded_cols(C) == C``: one of the column tiles :data:`COLUMN_TILES` or,
beyond 256, a multiple of 128.

Before a launch the wrapper lays the right-hand operand out for the kernel
(:func:`fwd_rows_operand`, :func:`t_operand`): K-major, with the k order in
which the kernels build their A fragments from the packed bytes
(``csrc/plane_dot.cu``; B1's on the card by a layout kernel there, one
transpose through shared memory).  The GRM product's pass 1 hands over the
slices' sample rows as they are (:func:`plane_dot_fwd_rows`).

The slices themselves come, on a CUDA tensor, from the slice kernels of
the same file (:func:`slice_i8`: the column max, then the slices), whose
bytes equal the plain chain ``packed_grm._slice_i8_plain``'s.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from ..utils import profiling

LAUNCHES = {"plane_dot_fwd": 0, "plane_dot_t": 0,   # kernel launches only
            "slice_i8": 0}
N_SLICES = 8    # 7 bits/slice -> ~56-bit effective mantissa (full f64); the
                # slice kernels write an element's slices as one 8-byte word
MAX_AXIS = 1 << 24      # int32 exactness bound: 128 * (N or M) < 2^31
_CHUNK_J = 8192         # byte columns per plain-version step
_CHUNK_M = 4096         # variants per plain-version step (f64 decode of one
#                         step: 4096 x 8192 x 8 B = 268 MB)
COLUMN_TILES = (16, 32, 64, 128, 256)   # the kernels' tiles (wgmma's n)
FWD_GROUP = 32          # byte columns per 128-byte k group of B1's operand
ROW_ALIGN = 16          # bytes: a tensor map's row rule for the store
T_GROUP = 16            # variants per k group of B2's operand


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


def _check_common(packed: torch.Tensor, rhs: torch.Tensor, C: int,
                  name: str):
    if packed.dtype != torch.uint8 or rhs.dtype != torch.int8:
        raise TypeError(f"expected uint8 packed and int8 {name}, got "
                        f"{packed.dtype} and {rhs.dtype}")
    if padded_cols(C) != C:
        raise ValueError(f"C={C} must be one of {COLUMN_TILES} or a "
                         "multiple of 128 beyond them (pad the slices: "
                         "padded_cols)")
    M, N4 = packed.shape
    if 4 * N4 >= MAX_AXIS or M >= MAX_AXIS:
        raise ValueError(f"{M} variants x {4 * N4} samples exceed the int32 "
                         f"exactness bound of {MAX_AXIS}")


def _check(packed: torch.Tensor, rhs: torch.Tensor, fwd: bool):
    name = "d4" if fwd else "dm"
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
    if packed.device != rhs.device:
        raise ValueError(f"packed on {packed.device}, {name} on "
                         f"{rhs.device}")
    _check_common(packed, rhs, rhs.shape[-1], name)


def padded_cols(cols: int) -> int:
    """The column count C the kernels run for ``cols`` slice columns: the
    smallest tile of :data:`COLUMN_TILES` that holds them, or beyond 256
    the next multiple of 128 (the kernels loop over tiles of
    :func:`column_tile`)."""
    for width in COLUMN_TILES:
        if cols <= width:
            return width
    return -(-cols // 128) * 128


def column_tile(C: int) -> int:
    """The kernels' column tile (wgmma's n) for C slice columns: C itself up
    to 256, beyond it tiles of 256 where they divide C, else of 128."""
    if C <= 256:
        return C
    return 256 if C % 256 == 0 else 128


_FWD_SLOT = {}          # (N4, device) -> B1's k order, sample -> position


def _fwd_slot(N4: int, device) -> torch.Tensor:
    """B1's k order for a store of width N4, int64 [4 N4]: the position in
    a row of the operand of sample ``p N4 + j``, ``128 G + 32 s + 16 h +
    4 t + p`` with j = 32 G + 8 t + 2 s + h (the k of wgmma step s,
    fragment half h, quad thread t, plane p)."""
    key = (N4, str(device))
    slot = _FWD_SLOT.get(key)
    if slot is None:
        sample = torch.arange(4 * N4, device=device)
        p, j = sample // N4, sample % N4
        r = j % FWD_GROUP
        slot = 4 * FWD_GROUP * (j // FWD_GROUP) + 32 * ((r % 8) // 2) + \
            16 * (r % 2) + 4 * (r // 8) + p
        _FWD_SLOT[key] = slot
    return slot


def fwd_rows_operand(d_rows: torch.Tensor, N4: int, C: int,
                     device) -> torch.Tensor:
    """B1's slices in the order kernel B1 reads them, from their sample
    rows: d_rows int8 [n, RS] (row ``p N4 + j`` is byte column j of plane
    p; n <= 4 N4, RS <= C) -> int8 [C, 4 N4p] on ``device`` (N4p = N4
    rounded up to 32), byte ``_fwd_slot[s]`` of row c holding
    ``d_rows[s, c]``, zero at positions of no sample and at columns c >=
    RS.  On a CUDA device one pass of ``csrc/plane_dot.cu``'s layout
    kernel (a transpose through shared memory), else one zeroed allocation
    and one scatter."""
    n, rs = d_rows.shape
    width = 4 * -(-N4 // FWD_GROUP) * FWD_GROUP
    if torch.device(device).type == "cuda":
        rows = d_rows.to(device).contiguous()
        out = torch.empty(C, width, dtype=torch.int8, device=device)
        err = _kernel_fn("plane_dot_fwd_layout")(
            rows.data_ptr(), out.data_ptr(), n, rs, N4, C,
            _device_index(out.device), _stream(out.device))
        if err != 0:
            raise RuntimeError(f"B1's layout launch failed: CUDA error {err}")
        return out
    out = torch.zeros(C, width, dtype=torch.int8, device=device)
    out[:rs].index_copy_(1, _fwd_slot(N4, device)[:n],
                         d_rows.to(device).t())
    return out


def t_operand(dm: torch.Tensor) -> torch.Tensor:
    """B2's operand as kernel B2 reads it: int8 [M, C] -> [C, M16], M16 = M
    rounded up to a multiple of 16 (zero variants).  Byte ``16 G + 4 t + i``
    of row c is ``dm[16 G + 4 i + t, c]``: the fragment's k 4t + i holds the
    variant that quad thread t reads as its byte i."""
    M, C = dm.shape
    M16 = -(-M // T_GROUP) * T_GROUP
    if M16 != M:
        pad = dm.new_zeros(M16, C)
        pad[:M] = dm
        dm = pad
    return dm.view(M16 // T_GROUP, 4, 4, C).permute(3, 0, 2, 1).reshape(
        C, M16).contiguous()


_ENTRY = {}             # name -> the configured C entry point
_ARGS = {               # name -> the ctypes argument types of sg_<name>
    "plane_dot_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "plane_dot_t": [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "plane_dot_fwd_layout": [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4
    + [ctypes.c_int, ctypes.c_void_p],
    "slice_i8": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
    + [ctypes.c_int, ctypes.c_void_p],
}


def _kernel_fn(name: str):
    """The C entry point ``sg_<name>`` of ``csrc/plane_dot.cu`` (built at
    first use), with its ctypes signature; set up once per name."""
    fn = _ENTRY.get(name)
    if fn is None:
        fn = getattr(_cuda.load("plane_dot"), f"sg_{name}")
        fn.argtypes = _ARGS[name]
        fn.restype = ctypes.c_int
        _ENTRY[name] = fn
    return fn


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, packed: torch.Tensor, operand, C: int,
            out_shape) -> torch.Tensor:
    """Launch kernel ``name`` on the current stream over the right-hand
    operand that ``operand()`` lays out (``fwd_rows_operand``,
    ``t_operand``) once the store passed its checks -> int32
    ``out_shape``."""
    if not packed.is_contiguous():
        raise ValueError(f"{name} needs a contiguous store")
    if packed.shape[1] % ROW_ALIGN or packed.data_ptr() % ROW_ALIGN:
        raise ValueError(f"{name} needs packed rows that start 16-byte "
                         f"aligned, got N4={packed.shape[1]} (the GRM "
                         "store pads N4 to a multiple of 16: "
                         "packed_grm.store_width)")
    fn = _kernel_fn(name)
    M, N4 = packed.shape
    operand = operand()
    out = torch.empty(out_shape, dtype=torch.int32, device=packed.device)
    err = fn(packed.data_ptr(), operand.data_ptr(), out.data_ptr(), M, N4,
             C, column_tile(C), _device_index(packed.device),
             _stream(packed.device))
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
        N4, C = d4.shape[1:]
        return _launch("plane_dot_fwd", packed, lambda: fwd_rows_operand(
            d4.reshape(4 * N4, C), N4, C, packed.device), C,
            (packed.shape[0], C)).to(torch.float64)
    if packed.device.type == "cpu":
        return plane_dot_fwd_plain(packed, d4)
    raise ValueError(f"unsupported device {packed.device}")


def plane_dot_fwd_rows(packed: torch.Tensor, d_rows: torch.Tensor,
                       C: int) -> torch.Tensor:
    """GRM pass 1 from the slices' sample rows: ``plane_dot_fwd`` of d_rows
    int8 [n, RS] placed planar for the store's width (row ``p N4 + j`` is
    byte column j of plane p) and zero-padded to [4, N4, C]; d_rows may lie
    on another device than the store -> f64 [M, C] on the store's device.

    A CUDA store goes through kernel B1 with its operand written straight
    from the rows (``fwd_rows_operand``), or raises; a CPU store through
    the plain version."""
    M, N4 = packed.shape
    n, rs = d_rows.shape
    if n > 4 * N4 or rs > C:
        raise ValueError(f"d_rows {tuple(d_rows.shape)} exceed the store's "
                         f"{4 * N4} samples or C={C}")
    _check_common(packed, d_rows, C, "d_rows")
    if packed.device.type == "cuda":
        return _launch("plane_dot_fwd", packed,
                       lambda: fwd_rows_operand(d_rows, N4, C, packed.device),
                       C, (M, C)).to(torch.float64)
    if packed.device.type == "cpu":
        d4 = torch.zeros(4 * N4, C, dtype=torch.int8)
        d4[:n, :rs] = d_rows
        return plane_dot_fwd_plain(packed, d4.view(4, N4, C))
    raise ValueError(f"unsupported device {packed.device}")


def plane_dot_t(packed: torch.Tensor, dm: torch.Tensor) -> torch.Tensor:
    """GRM pass 2: per-plane [M, N4]' x [M, C] int8 slices -> f64
    [4, N4, C].

    A CUDA tensor goes through kernel B2 (or raises); a CPU tensor through
    the plain version."""
    _check(packed, dm, fwd=False)
    if packed.device.type == "cuda":
        return _launch("plane_dot_t", packed, lambda: t_operand(dm),
                       dm.shape[1], (4, packed.shape[1], dm.shape[1])).to(
                           torch.float64)
    if packed.device.type == "cpu":
        return plane_dot_t_plain(packed, dm)
    raise ValueError(f"unsupported device {packed.device}")


def slice_i8(x: torch.Tensor):
    """The slice decomposition of ``packed_grm._slice_i8`` on a CUDA
    tensor: f64 [n, R] of any strides -> int8 [n, R, N_SLICES] slices and
    f64 [R] scales, by ``csrc/plane_dot.cu``'s column max and slice kernels
    (both launches counted once here, and in the counter
    ``grm.slice_kernel``), bit for bit the plain chain
    ``packed_grm._slice_i8_plain``: the same IEEE steps per element."""
    if x.device.type != "cuda":
        raise ValueError(f"the slice kernels need a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float64 or x.dim() != 2:
        raise TypeError(f"expected f64 [n, R], got {x.dtype} "
                        f"{tuple(x.shape)}")
    n, R = x.shape
    d = torch.empty(n, R, N_SLICES, dtype=torch.int8, device=x.device)
    scale = torch.empty(R, dtype=torch.float64, device=x.device)
    amax = torch.empty(R, dtype=torch.int64, device=x.device)
    err = _kernel_fn("slice_i8")(
        x.data_ptr(), amax.data_ptr(), scale.data_ptr(), d.data_ptr(), n, R,
        *x.stride(), _device_index(x.device), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"slice_i8 launch failed: CUDA error {err}")
    LAUNCHES["slice_i8"] += 1
    profiling.count("grm.slice_kernel")
    return d, scale
