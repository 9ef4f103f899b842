"""The PyTorch port's PheWAS-mode scan (``assoc_spa_multi`` on the CPU)
against the JAX package's, and against the port's own ``assoc_spa``.

A binary and a quantitative JAX ``NullModel`` (``tests/_torch_synth.py``)
are carried across with ``NullModel.from_arrays`` and scanned in one pass
of the genotypes.  Tolerances: against the JAX package, the same rows,
the same SPA set and NaN pattern, p-values, beta and SE within 1e-10
relative (the all-het corner variant's statistics are round-off in both
packages and are compared for presence only, as in
``test_torch_scan.py``); against the port's ``assoc_spa`` of each model,
bit-equal -- the one-model scan is the same code with P = 1.  The routes:
2-bit (kernel B3's plain version), int8 (B4's) and, on a file of rare
variants, the sparse stream (B5's, then B4's).
"""

import numpy as np
import pytest

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import jax_null_model, jax_quant_null_model, synth_codes, \
    synth_pheno, synth_quant_pheno, var_ratio_table
import saigegds_tpu
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch import NullModel, ScanConfig, assoc_spa, \
    assoc_spa_multi, load_pval
from saigegds_tpu_torch.assoc.single import _packed_parts

RTOL_P = 1e-10
N_SAMPLES, N_VARIANTS, BLOCK, N_EXTRA = 1031, 300, 64, 9
ALL_HET_ID = 3


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A GDS over the models' samples, one with N_EXTRA more samples
    (the models cover a subset), and one of rare variants only."""
    tmp = tmp_path_factory.mktemp("torch_multi_scan")
    rng = np.random.default_rng(43)
    X, y = synth_pheno(rng, N_SAMPLES)
    _, yq = synth_quant_pheno(rng, N_SAMPLES)
    codes = synth_codes(rng, N_VARIANTS, N_SAMPLES, y=y)
    gds = str(tmp / "geno.gds")
    write_seqarray_gds(gds, codes)
    extra = rng.binomial(2, 0.3, (N_VARIANTS, N_EXTRA)).astype(np.int8)
    sid = np.arange(1, N_SAMPLES + N_EXTRA + 1, dtype=np.int32)
    perm = rng.permutation(N_SAMPLES + N_EXTRA)
    wide = np.concatenate([codes, extra], axis=1)[:, perm]
    sup = str(tmp / "superset.gds")
    write_seqarray_gds(sup, wide, sample_id=sid[perm])
    rare = rng.binomial(2, rng.uniform(0.002, 0.01, (N_VARIANTS, 1)),
                        size=(N_VARIANTS, N_SAMPLES)).astype(np.int8)
    rare[rng.random(rare.shape) < 0.01] = 3
    rare_gds = str(tmp / "rare.gds")
    write_seqarray_gds(rare_gds, rare)
    jms = [jax_null_model(X, y, var_ratio_table("pooled")),
           jax_quant_null_model(X, yq, var_ratio_table("cat"))]
    return dict(tmp=tmp, gds=gds, sup=sup, rare=rare_gds, rare_codes=rare,
                jms=jms, tms=[NullModel.from_arrays(vars(m)) for m in jms])


def _adjusted(pval, pnorm):
    """Rows whose SPA p-value moved off the unadjusted one (a row that SPA
    leaves at pval_noadj may differ from phase 1's in the last bits)."""
    return np.abs(pval - pnorm) > RTOL_P * pnorm


def _assert_matches_jax(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w.columns)
        for c in ("id", "AF.alt", "mac", "num"):
            np.testing.assert_array_equal(g[c], w[c].to_numpy(), err_msg=c)
        ok = g["id"] != ALL_HET_ID
        if "converged" in g:       # the binary model: the same SPA set
            np.testing.assert_array_equal(g["converged"],
                                          w["converged"].to_numpy())
            np.testing.assert_array_equal(
                _adjusted(g["pval"], g["p.norm"])[ok],
                _adjusted(w["pval"].to_numpy(), w["p.norm"].to_numpy())[ok])
        for c in ("pval", "p.norm", "beta", "SE"):
            if c in g:
                wc = w[c].to_numpy()
                np.testing.assert_array_equal(np.isnan(g[c]), np.isnan(wc))
                np.testing.assert_allclose(g[c][ok], wc[ok], rtol=RTOL_P,
                                           err_msg=c)


def _assert_bit_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for c in a:
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)


def _jax_multi(gds, jms, **cfg):
    return saigegds_tpu.assoc_spa_multi(
        gds, jms, saigegds_tpu.ScanConfig(packed_sparse=False,
                                          block_size=BLOCK, **cfg))


@pytest.mark.parametrize("packed_2bit", [True, False])
def test_multi_matches_jax_and_single(data, packed_2bit):
    """Both models in one pass, the 2-bit and the int8 route: the JAX
    package's tables within 1e-10, and each equal to the port's own
    one-model scan bit for bit."""
    cfg = ScanConfig(block_size=BLOCK, packed_2bit=packed_2bit)
    inst = {}
    got = assoc_spa_multi(data["gds"], data["tms"], cfg, instrument=inst,
                          device="cpu")
    _assert_matches_jax(got, _jax_multi(data["gds"], data["jms"]))
    # one decode per block for both models
    assert len(inst["decode_s"]) == -(-N_VARIANTS // BLOCK)
    assert _adjusted(got[0]["pval"], got[0]["p.norm"]).sum() >= 3
    assert "p.norm" not in got[1] and "converged" not in got[1]
    for g, m in zip(got, data["tms"]):
        _assert_bit_equal(g, assoc_spa(data["gds"], m, cfg, device="cpu"))


def test_sparse_route(data):
    """Rare variants with ``transport_policy="static"``: every block ships
    as the gap-coded stream (B5, then B4) and the tables equal the 2-bit
    route's and the JAX package's."""
    codes = data["rare_codes"][:BLOCK]
    assert isinstance(_packed_parts(codes)[0][1], tuple)
    cfg = ScanConfig(block_size=BLOCK, transport_policy="static", mac=1.0)
    got = assoc_spa_multi(data["rare"], data["tms"], cfg, device="cpu")
    two_bit = assoc_spa_multi(
        data["rare"], data["tms"], ScanConfig(block_size=BLOCK, mac=1.0),
        device="cpu")
    for g, t in zip(got, two_bit):
        _assert_bit_equal(g, t)
    assert len(got[0]["id"]) > 100
    _assert_matches_jax(got, _jax_multi(data["rare"], data["jms"], mac=1.0))


def test_sample_subset(data):
    """Models over part of the GDS samples: the port gathers each block to
    them on the packed route, where the JAX package takes its dense route;
    the tables agree within 1e-10."""
    cfg = ScanConfig(block_size=BLOCK)
    inst = {}
    got = assoc_spa_multi(data["sup"], data["tms"], cfg, instrument=inst,
                          device="cpu")
    assert len(inst["gather_s"]) == -(-N_VARIANTS // BLOCK)
    _assert_matches_jax(got, _jax_multi(data["sup"], data["jms"]))
    for g, m in zip(got, data["tms"]):
        _assert_bit_equal(g, assoc_spa(data["sup"], m, cfg, device="cpu"))


def test_sample_mismatch_raises(data):
    m0, m1 = data["tms"]
    sub = NullModel.from_arrays({**vars(data["jms"][1])})
    keep = np.arange(N_SAMPLES - 5)
    for f in ("y", "mu", "res", "V", "fitted_values", "linear_predictors",
              "residuals", "X1", "XXVX_inv", "sample_id"):
        setattr(sub, f, getattr(sub, f)[keep])
    sub.XV = sub.XV[:, keep]
    with pytest.raises(ValueError, match="same GDS sample columns"):
        assoc_spa_multi(data["gds"], [m0, sub], device="cpu")
    with pytest.raises(ValueError, match="empty"):
        assoc_spa_multi(data["gds"], [], device="cpu")
    with pytest.raises(TypeError):
        assoc_spa_multi(data["gds"], [m0, m1])


def test_res_savefn_and_model_batch(data):
    tmp = data["tmp"]
    cfg = ScanConfig(block_size=BLOCK)
    with pytest.raises(ValueError, match="'{}'"):
        assoc_spa_multi(data["gds"], data["tms"], cfg,
                        res_savefn=str(tmp / "out.tsv"), device="cpu")
    pat = str(tmp / "out_{}.tsv")
    got = assoc_spa_multi(data["gds"], data["tms"], cfg, res_savefn=pat,
                          device="cpu")
    batched = assoc_spa_multi(data["gds"], data["tms"] + data["tms"][:1],
                              cfg, res_savefn=str(tmp / "b_{}.gds"),
                              model_batch=2, device="cpu")
    assert len(batched) == 3
    for i, g in enumerate(got):
        _assert_bit_equal(batched[i], g)
        back = load_pval(pat.format(i))
        np.testing.assert_array_equal(back["id"], g["id"])
        np.testing.assert_allclose(back["pval"], g["pval"], rtol=1e-15)
    _assert_bit_equal(batched[2], got[0])
    back = load_pval(str(tmp / "b_2.gds"))
    np.testing.assert_array_equal(back["pval"], got[0]["pval"])


@pytest.fixture(scope="module")
def ordered_subset(tmp_path_factory):
    """Three binary models (two of one phenotype with different variance
    ratios, one of another phenotype), a GDS of exactly their samples in
    their order, and a superset GDS: N_EXTRA more samples at shuffled
    positions, among which the models' samples keep that order."""
    tmp = tmp_path_factory.mktemp("torch_card_gather")
    rng = np.random.default_rng(44)
    X, y = synth_pheno(rng, N_SAMPLES)
    codes = synth_codes(rng, N_VARIANTS, N_SAMPLES, y=y)
    own = str(tmp / "own.gds")
    write_seqarray_gds(own, codes)
    n_all = N_SAMPLES + N_EXTRA
    at = np.sort(rng.choice(n_all, N_SAMPLES, replace=False))
    wide = rng.binomial(2, 0.3, (N_VARIANTS, n_all)).astype(np.int8)
    wide[:, at] = codes
    sid = np.arange(10**6, 10**6 + n_all, dtype=np.int32)
    sid[at] = np.arange(1, N_SAMPLES + 1)
    sup = str(tmp / "superset.gds")
    write_seqarray_gds(sup, wide, sample_id=sid)
    X2, y2 = synth_pheno(rng, N_SAMPLES)
    models = [NullModel.from_arrays(vars(jax_null_model(
        Xm, ym, var_ratio_table(v)))) for Xm, ym, v in (
            (X, y, "pooled"), (X, y, "cat"), (X2, y2, "pooled"))]
    return own, sup, models


@pytest.mark.parametrize("route, on_card", [
    ("two_bit", True), ("int8", False), ("dense", False)])
def test_gather_routes_equal_own_samples(ordered_subset, route, on_card):
    """Models over a shuffled subset of a superset GDS: each route's
    tables equal, bit for bit, each model's one-model scan over a GDS that
    holds only their samples in the same order, SPA rows included.  The
    2-bit route gathers every block on the device (``scan.gather_card``
    once a block; the flagged rows on the host, ``scan.gather_flagged``),
    the int8 and dense routes on the host; ``gather_s`` has one entry a
    block either way.  No model flags every row that some model flags, so
    each takes its own rows out of the drain's union, where a one-model
    scan's union is its own set."""
    from torch.profiler import ProfilerActivity, profile
    from saigegds_tpu_torch.utils import profiling

    own, sup, models = ordered_subset
    cfg = ScanConfig(block_size=BLOCK, packed_2bit=route != "int8",
                     use_packed=route != "dense")
    n_blocks = -(-N_VARIANTS // BLOCK)
    inst = {}
    with profile(activities=[ProfilerActivity.CPU]):
        got = assoc_spa_multi(sup, models, cfg, instrument=inst,
                              device="cpu")
    counts = profiling.counts()
    names = {s.name for s in profiling.spans()}
    assert counts.get("scan.gather_card", 0) == (n_blocks if on_card else 0)
    assert ("scan.gather_flagged" in names) == on_card
    assert len(inst["gather_s"]) == n_blocks
    assert inst["spa_n"] > 0
    flagged = [g["p.norm"] <= cfg.spa_pval for g in got]
    union = np.logical_or.reduce(flagged)
    assert all(f.sum() < union.sum() for f in flagged)
    for g, m in zip(got, models):
        assert _adjusted(g["pval"], g["p.norm"]).sum() >= 3
        _assert_bit_equal(g, assoc_spa(own, m, cfg, device="cpu"))
