"""Kernels B1 and B2 of the PyTorch port (``saigegds_tpu_torch/ops/
grm_kernel``) against the JAX package's Pallas kernels and their XLA twins.

Tolerance: none -- bit-equal.  Every output is an exact integer (each
product is at most 3 * 64 = 192 and the sums stay far below 2^24 at these
sizes), so the Pallas kernels in interpret mode, the XLA twins
``_p1_tile``/``_p2_tile``, the port's plain versions and its CUDA kernels
must agree to the last bit.  The packed bytes are random, so code 3 occurs
too: every version decodes the raw bit pairs.

The JAX package is imported inside the tests that use it, so that the
card-only cases run where jax is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_grm_kernel.py``.
"""

import numpy as np
import pytest
import torch

from saigegds_tpu_torch.ops import grm_kernel

M_VARIANTS, N_SAMPLES = 300, 1111       # off every tile size; N % 4 != 0


def _jax():
    """The JAX package's side of the comparison."""
    import jax.numpy as jnp
    from saigegds_tpu.ops import packed_grm, pallas_grm
    return jnp, packed_grm, pallas_grm


def _operands(M: int, N: int, C: int, seed: int):
    """uint8 packed [M, N4], int8 d4 [4, N4, C] (zero rows at padded
    samples) and int8 dm [M, C], as numpy arrays."""
    rng = np.random.default_rng(seed)
    n4 = -(-N // 4)
    packed = rng.integers(0, 256, size=(M, n4), dtype=np.uint8)
    d4 = rng.integers(-64, 65, size=(4, n4, C), dtype=np.int8)
    d4.reshape(4 * n4, C)[N:] = 0
    dm = rng.integers(-64, 65, size=(M, C), dtype=np.int8)
    return packed, d4, dm


@pytest.fixture(scope="module", params=[128, 256])
def ops(request):
    return _operands(M_VARIANTS, N_SAMPLES, request.param, request.param)


def test_fwd_plain_matches_pallas_interpret(ops):
    jnp, _, jpk = _jax()
    packed, d4, _ = ops
    want = np.asarray(jpk.plane_dot_fwd(
        jnp.asarray(packed), jnp.asarray(d4).astype(jnp.bfloat16),
        interpret=True))
    got = grm_kernel.plane_dot_fwd(torch.from_numpy(packed),
                                   torch.from_numpy(d4))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_t_plain_matches_pallas_interpret(ops):
    jnp, _, jpk = _jax()
    packed, _, dm = ops
    want = np.asarray(jpk.plane_dot_t(
        jnp.asarray(packed), jnp.asarray(dm).astype(jnp.bfloat16),
        interpret=True))
    got = grm_kernel.plane_dot_t(torch.from_numpy(packed),
                                 torch.from_numpy(dm))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_fwd_plain_matches_xla_twin(ops):
    """``_p1_tile`` over the whole store as one tile."""
    jnp, jpg, _ = _jax()
    packed, d4, _ = ops
    n4, C = d4.shape[1], d4.shape[2]
    dmat = jnp.asarray(d4.reshape(4 * n4, C)).astype(jnp.bfloat16)
    want = np.asarray(jpg._p1_tile(jnp.asarray(packed), dmat, n4, 0))
    got = grm_kernel.plane_dot_fwd_plain(torch.from_numpy(packed),
                                         torch.from_numpy(d4))
    np.testing.assert_array_equal(got.numpy(), want)


def test_t_plain_matches_xla_twin(ops):
    """``_p2_tile`` accumulated from zero over the whole store."""
    jnp, jpg, _ = _jax()
    packed, _, dm = ops
    acc4 = jnp.zeros((4, packed.shape[1], dm.shape[1]), jnp.float64)
    want = np.asarray(jpg._p2_tile(acc4, jnp.asarray(packed),
                                   jnp.asarray(dm).astype(jnp.bfloat16)))
    got = grm_kernel.plane_dot_t_plain(torch.from_numpy(packed),
                                       torch.from_numpy(dm))
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_chunking_is_exact(monkeypatch):
    """Chunk edges inside the rows and byte columns change nothing (the
    partial sums are exact integers)."""
    packed, d4, dm = (torch.from_numpy(a) for a in
                      _operands(M_VARIANTS, N_SAMPLES, 128, 3))
    fwd = grm_kernel.plane_dot_fwd_plain(packed, d4)
    t = grm_kernel.plane_dot_t_plain(packed, dm)
    monkeypatch.setattr(grm_kernel, "_CHUNK_J", 37)
    monkeypatch.setattr(grm_kernel, "_CHUNK_M", 41)
    assert torch.equal(grm_kernel.plane_dot_fwd_plain(packed, d4), fwd)
    assert torch.equal(grm_kernel.plane_dot_t_plain(packed, dm), t)


def test_launch_counts_untouched_by_plain_versions():
    packed, d4, dm = (torch.from_numpy(a) for a in _operands(5, 41, 128, 4))
    before = dict(grm_kernel.LAUNCHES)
    grm_kernel.plane_dot_fwd(packed, d4)
    grm_kernel.plane_dot_t(packed, dm)
    assert grm_kernel.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["fwd", "t"])
@pytest.mark.parametrize("bad", ["dtype", "width", "shape", "samples",
                                 "variants", "device"])
def test_wrappers_reject(kernel, bad):
    """Dtype, shape, width, size and device checks run before any dispatch
    (meta tensors carry shapes without memory)."""
    packed, d4, dm = (torch.from_numpy(a) for a in _operands(3, 41, 128, 5))
    rhs = d4 if kernel == "fwd" else dm
    if bad == "dtype":
        rhs = rhs.to(torch.int16)
    elif bad == "width":
        rhs = rhs[..., :100]
    elif bad == "shape":
        rhs = rhs[1:]
    elif bad == "samples":
        n4 = grm_kernel.MAX_AXIS // 4
        packed = torch.empty(1, n4, dtype=torch.uint8, device="meta")
        rhs = torch.empty(4, n4, 128, dtype=torch.int8, device="meta") \
            if kernel == "fwd" else \
            torch.empty(1, 128, dtype=torch.int8, device="meta")
    elif bad == "variants":
        m = grm_kernel.MAX_AXIS
        packed = torch.empty(m, 2, dtype=torch.uint8, device="meta")
        rhs = torch.empty(4, 2, 128, dtype=torch.int8, device="meta") \
            if kernel == "fwd" else \
            torch.empty(m, 128, dtype=torch.int8, device="meta")
    else:
        packed = packed.to("meta")
        rhs = rhs.to("meta")
    fn = grm_kernel.plane_dot_fwd if kernel == "fwd" else \
        grm_kernel.plane_dot_t
    with pytest.raises((TypeError, ValueError)):
        fn(packed, rhs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 1031, 128), (300, 1111, 256),
                                   (4100, 65537, 128)])
def test_kernels_match_plain_on_card(shape):
    """The hand-written CUDA kernels against their plain versions, on the
    card (ragged shapes: M and N off every tile size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    packed, d4, dm = (torch.from_numpy(a).cuda()
                      for a in _operands(*shape, seed=shape[0]))
    before = dict(grm_kernel.LAUNCHES)
    fwd = grm_kernel.plane_dot_fwd(packed, d4)
    t = grm_kernel.plane_dot_t(packed, dm)
    torch.cuda.synchronize()
    assert grm_kernel.LAUNCHES["plane_dot_fwd"] == \
        before["plane_dot_fwd"] + 1
    assert grm_kernel.LAUNCHES["plane_dot_t"] == before["plane_dot_t"] + 1
    assert torch.equal(fwd, grm_kernel.plane_dot_fwd_plain(packed, d4))
    assert torch.equal(t, grm_kernel.plane_dot_t_plain(packed, dm))
