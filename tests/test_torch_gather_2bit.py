"""The sample gather of planar 2-bit blocks (``saigegds_tpu_torch/ops/
gather_2bit.py``): its plain version against the host route it replaces,
and its CUDA kernel against the plain version on the card.

Tolerance: none — byte-equal.  The gather of a block packed over all of
its GDS samples must be exactly ``_pack2_block(np.take(G, cols, axis=1))``,
the payload the scan's host gather ships, tail padding included, so that
kernel B3 sees the same bytes on both routes.

No JAX here, so that the card-only cases run where jax is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_gather_2bit.py``.
"""

import numpy as np
import pytest
import torch

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from saigegds_tpu_torch.assoc.single import _pack2_block
from saigegds_tpu_torch.ops import gather_2bit
from saigegds_tpu_torch.ops.packed_grm import pack_codes_2bit


def _case(rows: int, n_gds: int, n: int, seed: int):
    """Codes 0..3 (3 = missing) over ``n_gds`` GDS samples and ``n`` sorted
    columns that hold the first and the last GDS column (one column: the
    first when ``seed`` is even, the last when odd)."""
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 4, (rows, n_gds), dtype=np.int8)
    if n == 1:
        cols = np.array([0 if seed % 2 == 0 else n_gds - 1])
    else:
        inner = rng.choice(np.arange(1, n_gds - 1), n - 2, replace=False)
        cols = np.sort(np.concatenate([[0, n_gds - 1], inner]))
    return G, cols


# GDS and model widths of every residue mod 4, one column at either end
CASES = [(rows, n_gds, n) for rows in (1, 64) for n_gds in (40, 41, 42, 43)
         for n in (20, 21, 22, 23)] + \
        [(rows, n_gds, 1) for rows in (1, 64) for n_gds in (1, 6)]


@pytest.mark.parametrize("rows, n_gds, n", CASES,
                         ids=[f"B{r}-N{g}-n{n}" for r, g, n in CASES])
def test_plain_matches_host_gather(rows, n_gds, n):
    for seed in (rows + n_gds + n, rows + n_gds + n + 1):
        G, cols = _case(rows, n_gds, n, seed)
        want = _pack2_block(np.take(G, cols, axis=1))
        got = gather_2bit.gather_2bit(
            torch.from_numpy(_pack2_block(G)),
            torch.from_numpy(cols.astype(np.int32)))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


def test_plain_rejects_columns_outside_the_row():
    packed = torch.from_numpy(pack_codes_2bit(np.zeros((2, 10), np.int8)))
    with pytest.raises(IndexError):
        gather_2bit.gather_2bit(packed,
                                torch.tensor([0, 12], dtype=torch.int32))
    with pytest.raises(TypeError):
        gather_2bit.gather_2bit(packed, torch.tensor([0, 1]))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("rows, n_gds, n", [(1024, 488_000, 430_000),
                                            (37, 1031, 1022),
                                            (300, 65_537, 60_001)])
def test_kernel_matches_plain_on_card(rows, n_gds, n):
    """The kernel against its plain version on the card: the scan's block
    (1,024 x 488,000 GDS samples -> 430,000 sorted columns) and widths
    that are not multiples of 4; the launch is counted."""
    _need_card()
    G, cols = _case(rows, n_gds, n, seed=rows)
    packed = torch.from_numpy(pack_codes_2bit(G)).cuda()
    idx = torch.from_numpy(cols.astype(np.int32)).cuda()
    before = gather_2bit.LAUNCHES["gather_2bit"]
    got = gather_2bit.gather_2bit(packed, idx)
    torch.cuda.synchronize()
    assert gather_2bit.LAUNCHES["gather_2bit"] == before + 1
    want = gather_2bit.gather_2bit_plain(packed, idx)
    assert torch.equal(got, want)
