"""The least time an NVIDIA H100 SXM could take for kernels B1 and B2 of
the GRM product (frozen from ``chip_smoke.py``'s ``bound`` and
``check_grm``): the larger of the bytes they must move at the memory
rate and the int8 operations they must do at the tensor cores' rate.

At M markers, N samples and C slice columns, with the store's
``4 * N4`` sample rows (``N4 = 16 * ceil(N / 64)``) of 2-bit codes,
``M * N4`` bytes:

* B1 (pass 1, store x slices): reads the store and the slices' sample
  rows (N * C int8), writes int32 [M, C];
* B2 (pass 2, store' x operand): reads the store and the operand
  (M * C int8), writes int32 [4 * N4, C];
* each does ``2 * M * 4 * N4 * C`` int8 operations."""

from __future__ import annotations

HBM_BYTES_S = 3.35e12       # H100 SXM memory rate (at 700 W)
INT8_OPS_S = 1.979e15       # H100 SXM dense int8 tensor-core rate (700 W)

# the kernels of B1 (with the layout of its slice rows) and of B2, as the
# device trace names them
B1_KERNELS = ("plane_dot_fwd_kernel", "fwd_rows_layout_kernel")
B2_KERNELS = ("plane_dot_t_kernel",)


def store_width(n: int) -> int:
    """Byte columns N4 of a store over ``n`` samples."""
    return 16 * -(-int(n) // 64)


def b1_bytes_ops(M: int, N: int, C: int):
    n4 = store_width(N)
    return M * n4 + N * C + 4 * M * C, 2 * M * 4 * n4 * C


def b2_bytes_ops(M: int, N: int, C: int):
    n4 = store_width(N)
    return M * n4 + M * C + 4 * 4 * n4 * C, 2 * M * 4 * n4 * C


def bound_s(nbytes: float, ops: float) -> float:
    """Seconds at the memory rate or the operation rate, the larger."""
    return max(nbytes / HBM_BYTES_S, ops / INT8_OPS_S)


def b1_bound_s(M: int, N: int, C: int) -> float:
    return bound_s(*b1_bytes_ops(M, N, C))


def b2_bound_s(M: int, N: int, C: int) -> float:
    return bound_s(*b2_bytes_ops(M, N, C))
