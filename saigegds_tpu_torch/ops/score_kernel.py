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
kernels contract on the int8 tensor cores (``wgmma`` m64nNk32, s8 x s8
with s32 accumulators; exact for N < 2^24), the plain versions in f64
(exact below 2^53).  The kernels take codes whose rows start at any byte
(N or N4 not a multiple of 4, or a view into a buffer).

The kernels read the slices K-major, in the k order in which they build
their A words from the codes (:func:`operand_2bit`, :func:`operand`).  The
slices are a model's, so the scan lays them out once per model
(``score_packed.pack_scan_model``) and hands the layout over; a caller
that passes none gets it made anew on each call.  The slices' column
count C is one the kernels run, ``padded_cols(C) == C``: a tile of
:data:`COLUMN_TILES` or several equal tiles of them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

# kernel launches (not plain-version calls)
LAUNCHES = {"indicator_dot_2bit": 0, "indicator_dot": 0}
MAX_SAMPLES = 1 << 24   # int32 exactness bound: 128 * N < 2^31
_CHUNK = 16384          # byte columns (or samples) per plain-version step
COLUMN_TILES = (32, 64, 96)   # the kernels' tiles (wgmma's n)
STAGE_K = 128           # k per stage of the kernels' slice tiles
GROUP_2BIT = 32         # B3: byte columns per stage


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


def padded_cols(cols: int) -> int:
    """The column count C the kernels run for ``cols`` slice columns: the
    fewest tiles of at most 96 columns that hold them, each as narrow as a
    tile of :data:`COLUMN_TILES` allows (88 -> 96, 56 -> 64, 104 -> 2 x 64,
    136 -> 2 x 96)."""
    tiles = -(-cols // COLUMN_TILES[-1])
    return tiles * 32 * -(-cols // (32 * tiles))


def column_tile(C: int) -> int:
    """The kernels' column tile (wgmma's n) for a C that
    :func:`padded_cols` accepts: C split into its fewest equal tiles."""
    return C // -(-C // COLUMN_TILES[-1])


def width_2bit(n4: int) -> int:
    """k of B3's layout for rows of n4 packed bytes: four planes of n4
    rounded up to a stage's 32 byte columns."""
    return 4 * -(-n4 // GROUP_2BIT) * GROUP_2BIT


def width_int8(n: int) -> int:
    """k of B4's layout for rows of n codes: n rounded up to a stage."""
    return -(-n // STAGE_K) * STAGE_K


def operand_2bit(vs4: torch.Tensor) -> torch.Tensor:
    """B3's slices as kernel B3 reads them: int8 [4, N4, C] -> [C, 4 N4p]
    (N4p = N4 rounded up to 32), byte ``128 G + 32 p + 16 w + 4 t + i`` of
    row c holding ``vs4[p, 32 G + 8 t + 4 w + i, c]`` (zero past N4): the
    A word of k-step p, half w that quad thread t builds from its packed
    bytes ``8 t + 4 w ..`` of stage G is plane p of them
    (``csrc/indicator_dot_2bit.cu``)."""
    _, n4, C = vs4.shape
    n4p = width_2bit(n4) // 4
    v = vs4
    if n4p != n4:
        v = vs4.new_zeros(4, n4p, C)
        v[:, :n4] = vs4
    #                [p, G, t, w, i, c] -> [c, G, p, w, t, i]
    return v.view(4, n4p // GROUP_2BIT, 4, 2, 4, C).permute(
        5, 1, 0, 3, 2, 4).reshape(C, 4 * n4p).contiguous()


def operand(vs: torch.Tensor) -> torch.Tensor:
    """B4's slices as kernel B4 reads them: int8 [N, C] -> [C, Np] (Np = N
    rounded up to 128), byte ``128 G + 32 s + 16 h + 4 t + i`` of row c
    holding ``vs[128 G + 32 t + 8 s + 4 h + i, c]`` (zero past N): quad
    thread t's code word j = 2 s + h of stage G, as it lies in memory, is
    the A word of k-step s, half h (``csrc/indicator_dot.cu``)."""
    n, C = vs.shape
    npad = width_int8(n)
    v = vs
    if npad != n:
        v = vs.new_zeros(npad, C)
        v[:n] = vs
    #                [G, t, s, h, i, c] -> [c, G, s, h, t, i]
    return v.view(npad // STAGE_K, 4, 4, 2, 4, C).permute(
        5, 0, 2, 3, 1, 4).reshape(C, npad).contiguous()


def _check(name: str, x: torch.Tensor, xdtype, v: torch.Tensor,
           n_samples: int, shapes_ok: bool, want: str):
    if x.dtype != xdtype or v.dtype != torch.int8:
        raise TypeError(f"{name}: expected {xdtype} codes and int8 slices, "
                        f"got {x.dtype} and {v.dtype}")
    if not shapes_ok:
        raise ValueError(f"{name}: shape mismatch {tuple(x.shape)}, "
                         f"{tuple(v.shape)} (want {want})")
    C = v.shape[-1]
    if C == 0 or padded_cols(C) != C:
        raise ValueError(f"C={C} must be a tile of {COLUMN_TILES} or "
                         "several equal ones (pad the slices: padded_cols)")
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
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + \
            [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY[name] = fn
    return _ENTRY[name]


def _launch(name: str, x: torch.Tensor, op: torch.Tensor,
            k: int) -> torch.Tensor:
    """Launch kernel ``name`` on the current stream with x [B, n] and the
    slices in the kernel's order, op int8 [C, k] -> int32 [B, 3, C]."""
    if not x.is_contiguous():
        raise ValueError(f"{name} needs contiguous codes")
    if op.dtype != torch.int8 or op.dim() != 2 or op.shape[1] != k \
            or op.device != x.device or not op.is_contiguous() \
            or op.data_ptr() % 16:
        raise ValueError(f"{name}: the slices' layout must be a contiguous "
                         f"16-byte aligned int8 [C, {k}] on {x.device}, "
                         f"got {op.dtype} {tuple(op.shape)} on {op.device}")
    fn = _kernel_fn(name)
    B, n = x.shape
    C = op.shape[0]
    out = torch.empty(B, 3, C, dtype=torch.int32, device=x.device)
    dev = x.device
    err = fn(x.data_ptr(), op.data_ptr(), out.data_ptr(), B, n, C,
             column_tile(C), dev.index if dev.index is not None
             else torch.cuda.current_device(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def indicator_dot_2bit(packed: torch.Tensor, vs4: torch.Tensor,
                       vs4k: torch.Tensor | None = None) -> torch.Tensor:
    """B3: [B, N4] planar 2-bit packed codes x [4, N4, C] int8 plane-split
    slices -> f64 [B, 3, C] (g0 / missing / hom-ALT contractions).

    A CUDA tensor goes through the hand-written kernel (or raises), over
    ``vs4k``, the slices in its order (:func:`operand_2bit` of ``vs4``,
    made here when not given); a CPU tensor through the plain version."""
    _check("indicator_dot_2bit", packed, torch.uint8, vs4,
           4 * packed.shape[-1],
           packed.dim() == 2 and vs4.dim() == 3 and vs4.shape[0] == 4
           and vs4.shape[1] == packed.shape[1], "[B, N4], [4, N4, C]")
    if packed.device.type == "cuda":
        if vs4k is None:
            vs4k = operand_2bit(vs4)
        if vs4k.shape[0] != vs4.shape[2]:
            raise ValueError(f"vs4k has {vs4k.shape[0]} columns, vs4 "
                             f"{vs4.shape[2]}")
        return _launch("indicator_dot_2bit", packed, vs4k,
                       width_2bit(packed.shape[1])).to(torch.float64)
    if packed.device.type == "cpu":
        return indicator_dot_2bit_plain(packed, vs4)
    raise ValueError(f"unsupported device {packed.device}")


def indicator_dot(codes: torch.Tensor, vs: torch.Tensor,
                  vsk: torch.Tensor | None = None) -> torch.Tensor:
    """B4: [B, N] int8 codes (3 = missing) x [N, C] int8 slices -> f64
    [B, 3, C] (g0 / missing / hom-ALT contractions).

    A CUDA tensor goes through the hand-written kernel (or raises), over
    ``vsk``, the slices in its order (:func:`operand` of ``vs``, made here
    when not given); a CPU tensor through the plain version."""
    _check("indicator_dot", codes, torch.int8, vs, codes.shape[-1],
           codes.dim() == 2 and vs.dim() == 2
           and vs.shape[0] == codes.shape[1], "[B, N], [N, C]")
    if codes.device.type == "cuda":
        if vsk is None:
            vsk = operand(vs)
        if vsk.shape[0] != vs.shape[1]:
            raise ValueError(f"vsk has {vsk.shape[0]} columns, vs "
                             f"{vs.shape[1]}")
        return _launch("indicator_dot", codes, vsk,
                       width_int8(codes.shape[1])).to(torch.float64)
    if codes.device.type == "cpu":
        return indicator_dot_plain(codes, vs)
    raise ValueError(f"unsupported device {codes.device}")
