"""The PyTorch port's device mesh (``saigegds_tpu_torch/parallel/mesh.py``)
on the CPU, against the port's unsharded code and the JAX package's mesh.

A mesh of repeated CPU devices (``make_mesh(devices=["cpu"] * k)``)
stands in for the JAX package's virtual host devices.  Tolerances:

* the sharded 2-bit GRM product -- the unsharded ``Packed2GRM.matvec``
  bit for bit, for 1, 2, 3 and 5 shards (B1's and B2's integers do not
  depend on the split); the dense oracle's -- 1e-12 relative (its f64
  partials over samples reassociate);
* ``from_streamed_blocks`` -- wrapping the streamed build of the same
  blocks bit for bit (store, moments, pairs, products);
* ``fit_null_glmm(mesh=)`` -- the port's unsharded fit bit for bit, and
  the JAX package's ``mesh=`` fit within 1e-8 (``chip_smoke.py``'s
  ``RTOL_FIT``; they agree to ~1e-14);
* ``assoc_spa(mesh=)``/``assoc_spa_multi(mesh=)`` -- the one-device
  tables bit for bit, and the JAX package's ``mesh=`` scan within 1e-10.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import jax_null_model, jax_quant_null_model, synth_codes, \
    synth_pheno, synth_quant_pheno, var_ratio_table
import saigegds_tpu
import saigegds_tpu_torch as sgt
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch.ops.grm import build_grm
from saigegds_tpu_torch.ops.packed_grm import build_packed2_grm, \
    build_packed2_grm_streamed
from saigegds_tpu_torch.parallel.mesh import Mesh, ShardedGrmHandle, \
    make_mesh, replicate, shard_variant_batch

RTOL_DENSE = 1e-12
RTOL_FIT = 1e-8
RTOL_P = 1e-10
M_GRM, N_GRM = 120, 1003          # N divides none of the meshes
N_FIT, M_FIT = 800, 600
FORMULA, FORMULA_Q = "y ~ x1 + x2 + x3", "yq ~ x1 + x2 + x3"
N_SCAN, M_SCAN, BLOCK = 1031, 300, 64   # the last block holds 44 rows
ALL_HET_ID = 3


def cpu_mesh(k: int) -> Mesh:
    return make_mesh(devices=["cpu"] * k)


def _rel(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.fixture(scope="module")
def grm_codes():
    rng = np.random.default_rng(4)
    codes = rng.binomial(2, rng.uniform(0.02, 0.5, (M_GRM, 1)),
                         size=(M_GRM, N_GRM)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.02] = 3
    codes[0] = 0                       # monomorphic: inv = 0
    codes[1] = 3                       # all missing
    return codes


@pytest.fixture(scope="module")
def grms(grm_codes):
    return (build_packed2_grm(grm_codes, device="cpu"),
            build_grm(grm_codes, device="cpu"))


@pytest.mark.parametrize("R", [1, 30])
@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_sharded_product(grms, shards, R):
    packed, dense = grms
    b = torch.from_numpy(np.random.default_rng(shards * 100 + R).normal(
        size=(N_GRM, R) if R > 1 else N_GRM))
    h = ShardedGrmHandle(packed, cpu_mesh(shards))
    assert len(h.stores) == shards and h.ranges[-1][1] == N_GRM
    assert h.n_samples == N_GRM and h.n_variants == M_GRM
    assert h.device == torch.device("cpu") and h.diag is packed.diag
    got = h.matvec(b)
    assert torch.equal(got, packed.matvec(b))
    assert h.matvecs == 1 and sum(h.widths.values()) == 1
    hd = ShardedGrmHandle(dense, cpu_mesh(shards))
    got_d, want_d = hd.matvec(b).numpy(), dense.matvec(b).numpy()
    if R == 1:
        got_d, want_d = got_d[:, None], want_d[:, None]
    np.testing.assert_array_less(np.abs(got_d - want_d).max(axis=0),
                                 RTOL_DENSE * np.abs(want_d).max(axis=0))


def _whole_store_product(op, b: torch.Tensor) -> torch.Tensor:
    """The 2-bit product over one store written out step by step, as
    ``sharded_product`` computed it for one range before its lead's and
    ranks' parts were split apart: B1 over the whole store, the
    recombination, the corrections, B2 over the whole store."""
    from saigegds_tpu_torch.ops import grm_kernel
    from saigegds_tpu_torch.ops.packed_grm import N_SLICES, _pad_cols, \
        _slice_i8, _slice_weights, kernel_cols
    B = b[:, None] if b.dim() == 1 else b
    M, (N, R), S = op.n_variants, B.shape, N_SLICES
    RS, C, N4 = R * S, kernel_cols(R), op.packed.shape[1]
    d, scale = _slice_i8(B, S)
    d4 = torch.zeros(4 * N4, C, dtype=torch.int8)
    d4[:N, :RS] = d.reshape(N, RS)
    acc = grm_kernel.plane_dot_fwd(op.packed, d4.view(4, N4, C))
    cv = torch.sum(acc[:, :RS].reshape(M, R, S) * _slice_weights(scale, S),
                   dim=-1)
    mv = torch.sum(B, dim=0)[None, :] - op.miss.per_variant(B)
    gv = op.inv[:, None] * (cv - 2.0 * op.af[:, None] * mv)
    w1 = op.inv[:, None] * gv
    w2 = 2.0 * op.af[:, None] * op.inv[:, None] * gv
    d2, scale2 = _slice_i8(w1, S)
    out4 = grm_kernel.plane_dot_t(op.packed, _pad_cols(d2.reshape(M, RS), C))
    out = torch.sum(out4.view(-1, C)[:N, :RS].reshape(N, R, S)
                    * _slice_weights(scale2, S), dim=-1)
    out = (out - (torch.sum(w2, dim=0)[None, :] - op.miss.per_sample(w2))) \
        / M
    return out[:, 0] if b.dim() == 1 else out


@pytest.mark.parametrize("R", [1, 30])
@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_product_keeps_the_whole_store_algebra(grms, shards, R):
    """The products of one process, through ``sharded_product``'s lead
    part with no other rank, equal the one-store algebra written out
    (``_whole_store_product``) bit for bit: splitting the product into the
    lead's and the ranks' parts changed no bit."""
    packed = grms[0]
    b = torch.from_numpy(np.random.default_rng(shards * 10 + R).normal(
        size=(N_GRM, R) if R > 1 else N_GRM))
    want = _whole_store_product(packed, b)
    assert torch.equal(packed.matvec(b), want)
    assert torch.equal(ShardedGrmHandle(packed, cpu_mesh(shards)).matvec(b),
                       want)


def test_shard_stores_hold_their_ranges(grms, grm_codes):
    """Each shard's store is its sample range packed at its own width."""
    from saigegds_tpu_torch.ops.packed_grm import store_width, \
        unpack_codes_2bit
    h = ShardedGrmHandle(grms[0], cpu_mesh(3))
    for (lo, hi), store, nbytes in zip(h.ranges, h.stores, h.store_bytes):
        assert tuple(store.shape) == (M_GRM, store_width(hi - lo))
        assert nbytes == store.numel()
        np.testing.assert_array_equal(
            unpack_codes_2bit(store.numpy(), hi - lo),
            np.where(grm_codes[:, lo:hi] < 3, grm_codes[:, lo:hi], 0))


@pytest.mark.parametrize("block", [37, 50])
def test_streamed_build_equals_wrapped(grm_codes, block):
    def blocks():
        for s in range(0, M_GRM, block):
            yield np.arange(s, min(s + block, M_GRM)), grm_codes[s:s + block]

    mesh = cpu_mesh(3)
    got = ShardedGrmHandle.from_streamed_blocks(blocks(), N_GRM, M_GRM, mesh)
    ref = build_packed2_grm_streamed(blocks(), N_GRM, M_GRM, device="cpu")
    want = ShardedGrmHandle(ref, mesh)
    for a, b in zip(got.stores, want.stores):
        assert torch.equal(a, b)
    for f in ("af", "inv", "diag"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("samp", "var_start", "var", "samp_start"):
        assert torch.equal(getattr(got.miss, f), getattr(want.miss, f)), f
    b = torch.from_numpy(np.random.default_rng(1).normal(size=(N_GRM, 3)))
    assert torch.equal(got.matvec(b), want.matvec(b))
    assert torch.equal(got.matvec(b), build_packed2_grm(
        grm_codes, device="cpu").matvec(b))


def test_streamed_build_checks_row_count(grm_codes):
    with pytest.raises(ValueError):
        ShardedGrmHandle.from_streamed_blocks(
            iter([(None, grm_codes)]), N_GRM, M_GRM + 1, cpu_mesh(2))


# ---------------------------------------------------------------------------
# the fit


@pytest.fixture(scope="module")
def fit_data(tmp_path_factory):
    """``tests/test_torch_fit.py``'s data (seed 5), with a quantitative
    phenotype of the same genetic values beside the binary one."""
    rng = np.random.default_rng(5)
    af = rng.uniform(0.05, 0.5, size=(M_FIT, 1))
    codes = rng.binomial(2, af, size=(M_FIT, N_FIT)).astype(np.int8)
    beta = rng.normal(size=M_FIT) * np.sqrt(0.6 / M_FIT) \
        / np.sqrt(2 * af[:, 0] * (1 - af[:, 0]))
    X = rng.normal(size=(N_FIT, 3))
    g = codes.T @ beta
    eta = X @ np.array([0.3, -0.2, 0.1]) - 1.0 + g
    y = (rng.random(N_FIT) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    codes[rng.random(codes.shape) < 0.005] = 3
    gds = str(tmp_path_factory.mktemp("torch_mesh_fit") / "fit.gds")
    write_seqarray_gds(gds, codes)
    yq = 2.0 + X @ np.array([0.5, 0.1, -0.3]) + g \
        + rng.normal(size=N_FIT) * np.sqrt(0.8)
    cols = {"sample.id": np.arange(1, N_FIT + 1), "y": y, "yq": yq,
            "x1": X[:, 0], "x2": X[:, 1], "x3": X[:, 2]}
    return gds, cols


def _assert_fits_equal(a, b):
    for f in ("tau", "coefficients", "fitted_values", "linear_predictors"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    for k in b.var_ratio:
        np.testing.assert_array_equal(a.var_ratio[k], b.var_ratio[k], k)


@pytest.mark.parametrize("trait", ["binary", "quantitative"])
def test_mesh_fit(fit_data, trait):
    """Three CPU shards: the port's unsharded fit bit for bit, with the
    same products and iterations; the JAX package's three-device fit
    within 1e-8."""
    gds, cols = fit_data
    formula = FORMULA if trait == "binary" else FORMULA_Q
    cfg = sgt.NullModelConfig(trait_type=trait)
    inst, inst_m = {}, {}
    one = sgt.fit_null_glmm(formula, cols, gds, cfg, instrument=inst,
                            device="cpu")
    got = sgt.fit_null_glmm(formula, cols, gds, cfg, instrument=inst_m,
                            device="cpu", mesh=cpu_mesh(3))
    _assert_fits_equal(got, one)
    for k in ("outer_iterations", "matvecs", "pcg_iterations",
              "product_widths"):
        assert inst_m[k] == inst[k], k
    from saigegds_tpu.parallel.mesh import make_mesh as jax_mesh
    jm = saigegds_tpu.fit_null_glmm(
        formula, pd.DataFrame(cols), gds,
        saigegds_tpu.NullModelConfig(trait_type=trait, grm_impl="packed"),
        mesh=jax_mesh(3))
    assert _rel(got.tau[1], jm.tau[1]) < RTOL_FIT
    assert _rel(got.coefficients, jm.coefficients) < RTOL_FIT
    np.testing.assert_array_equal(got.var_ratio["id"], jm.var_ratio["id"])
    assert _rel(got.var_ratio["ratio"], jm.var_ratio["ratio"]) < RTOL_FIT


def test_mesh_fit_streamed(fit_data):
    """The streamed ingest builds each shard's store as the blocks arrive
    (``from_streamed_blocks``): the unsharded streamed fit bit for bit."""
    gds, cols = fit_data
    cfg = sgt.NullModelConfig(stream_geno=True)
    one = sgt.fit_null_glmm(FORMULA, cols, gds, cfg, device="cpu")
    got = sgt.fit_null_glmm(FORMULA, cols, gds, cfg, device="cpu",
                            mesh=cpu_mesh(2))
    _assert_fits_equal(got, one)


def test_mesh_fit_dense(fit_data):
    """The dense oracle sharded: its products reassociate, so the fit
    agrees with the unsharded dense fit to the solver's precision."""
    gds, cols = fit_data
    cfg = sgt.NullModelConfig(grm_impl="dense")
    one = sgt.fit_null_glmm(FORMULA, cols, gds, cfg, device="cpu")
    got = sgt.fit_null_glmm(FORMULA, cols, gds, cfg, device="cpu",
                            mesh=cpu_mesh(2))
    assert _rel(got.tau[1], one.tau[1]) < 1e-8
    assert _rel(got.coefficients, one.coefficients) < 1e-8


def test_lead_device_must_agree(fit_data):
    gds, cols = fit_data
    mesh = Mesh(["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="lead"):
        sgt.fit_null_glmm(FORMULA, cols, gds, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="lead"):
        sgt.assoc_spa(gds, object(), device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="lead"):
        sgt.assoc_spa_multi(gds, [object()], device="cpu", mesh=mesh)


def test_make_mesh(monkeypatch):
    mesh = make_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3 and mesh.lead == torch.device("cpu")
    assert mesh.distinct() == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(devices=["cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only"):
        make_mesh(2)
    with pytest.raises(ValueError, match="only"):
        make_mesh(devices=["cuda:1"])
    assert make_mesh(1).devices == (torch.device("cuda", 0),)


def test_shard_variant_batch_and_replicate():
    mesh = cpu_mesh(3)
    G = np.arange(7 * 4).reshape(7, 4)
    parts = shard_variant_batch(mesh, G)
    assert [len(r) for r, _ in parts] == [2, 2, 3]
    np.testing.assert_array_equal(np.concatenate([r for r, _ in parts]),
                                  np.arange(7))
    for rows, t in parts:
        np.testing.assert_array_equal(t.numpy(), G[rows])
    assert len(shard_variant_batch(mesh, G[:2])) == 2   # empty parts left out
    x = {"a": torch.ones(3), "b": (torch.zeros(2), 5)}
    rep = replicate(mesh, x)
    assert list(rep) == [torch.device("cpu")]
    assert torch.equal(rep[torch.device("cpu")]["a"], x["a"])


# ---------------------------------------------------------------------------
# the scan


@pytest.fixture(scope="module")
def scan_data(tmp_path_factory):
    rng = np.random.default_rng(43)
    X, y = synth_pheno(rng, N_SCAN)
    _, yq = synth_quant_pheno(rng, N_SCAN)
    codes = synth_codes(rng, M_SCAN, N_SCAN, y=y)
    gds = str(tmp_path_factory.mktemp("torch_mesh_scan") / "geno.gds")
    write_seqarray_gds(gds, codes)
    jms = [jax_null_model(X, y, var_ratio_table("pooled")),
           jax_quant_null_model(X, yq, var_ratio_table("cat"))]
    return gds, jms, [sgt.NullModel.from_arrays(vars(m)) for m in jms]


def _assert_bit_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for c in a:
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)


def _assert_close(got: dict, want):
    assert list(got) == list(want.columns)
    for c in ("id", "AF.alt", "mac", "num"):
        np.testing.assert_array_equal(got[c], want[c].to_numpy(), err_msg=c)
    ok = got["id"] != ALL_HET_ID     # round-off statistics in both packages
    for c in ("pval", "p.norm", "beta", "SE"):
        if c in got:
            w = want[c].to_numpy()
            np.testing.assert_array_equal(np.isnan(got[c]), np.isnan(w))
            np.testing.assert_allclose(got[c][ok], w[ok], rtol=RTOL_P,
                                       err_msg=c)


@pytest.mark.parametrize("route", ["2bit", "int8", "dense"])
def test_mesh_scan(scan_data, route):
    """Each block's rows over 3 CPU shards (64-row blocks and a 44-row
    trailing block: uneven parts): the one-device table bit for bit, for
    one model and for both in one pass; the binary model within 1e-10 of
    the JAX package's scan on a 4-device mesh."""
    gds, jms, tms = scan_data
    cfg = sgt.ScanConfig(block_size=BLOCK, packed_2bit=route != "int8",
                         use_packed=route != "dense")
    mesh = cpu_mesh(3)
    inst = {}
    got = sgt.assoc_spa(gds, tms[0], cfg, instrument=inst, device="cpu",
                        mesh=mesh)
    _assert_bit_equal(got, sgt.assoc_spa(gds, tms[0], cfg, device="cpu"))
    assert inst["spa_n"] > 0
    multi = sgt.assoc_spa_multi(gds, tms, cfg, device="cpu", mesh=mesh)
    for g, m in zip(multi, tms):
        _assert_bit_equal(g, sgt.assoc_spa(gds, m, cfg, device="cpu"))
    from saigegds_tpu.parallel.mesh import make_mesh as jax_mesh
    want = saigegds_tpu.assoc_spa(
        gds, jms[0], saigegds_tpu.ScanConfig(
            block_size=BLOCK, packed_2bit=route != "int8",
            use_packed=route != "dense", packed_sparse=False),
        mesh=jax_mesh(4))
    _assert_close(got, want)


def test_mesh_scan_sparse_route_off(scan_data, monkeypatch):
    """Under a mesh the sparse route is off (its entry streams do not
    split by variant): ``transport_policy="static"`` still ships 2-bit
    parts, and the table equals the one-device 2-bit table."""
    from saigegds_tpu_torch.assoc import single
    gds, _, tms = scan_data
    calls = []
    real = single._packed_parts
    monkeypatch.setattr(single, "_packed_parts",
                        lambda G: calls.append(1) or real(G))
    cfg = sgt.ScanConfig(block_size=BLOCK, transport_policy="static")
    got = sgt.assoc_spa(gds, tms[0], cfg, device="cpu", mesh=cpu_mesh(2))
    assert not calls
    _assert_bit_equal(got, sgt.assoc_spa(gds, tms[0],
                                         sgt.ScanConfig(block_size=BLOCK),
                                         device="cpu"))
