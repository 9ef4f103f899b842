"""The PyTorch port's command line (``python -m saigegds_tpu_torch``, run
in-process through ``main`` with ``--device cpu``) and its statistics
utilities.

Every subcommand writes what the port's API gives on the same inputs
(models and tables equal); ``fit`` and ``scan`` agree with the JAX CLI's
outputs on the same files within 1e-7 relative (the reference contract);
``merge`` equals the JAX package's ``load_pval`` of the same shards;
``vcf2gds`` reads back the VCF's calls; ``glmm_heritability`` equals the
JAX package's within 1e-12.
"""

import csv

import numpy as np
import pytest

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
import saigegds_tpu_torch as sgt
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch.__main__ import main
from saigegds_tpu_torch.io.seqarray import SeqData

RTOL_JAX = 1e-7
N_SAMPLES, N_VARIANTS = 500, 400


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(71)
    af = rng.uniform(0.01, 0.5, size=(N_VARIANTS, 1))
    codes = rng.binomial(2, af, size=(N_VARIANTS, N_SAMPLES)).astype(np.int8)
    beta = rng.normal(size=N_VARIANTS) * np.sqrt(1.0 / N_VARIANTS) \
        / np.sqrt(2 * af[:, 0] * (1 - af[:, 0]))
    g = codes.T @ beta
    codes[rng.random(codes.shape) < 0.004] = 3
    gds = str(tmp / "geno.gds")
    write_seqarray_gds(gds, codes, position=np.arange(1, N_VARIANTS + 1) * 50)
    x1, x2 = rng.normal(size=(2, N_SAMPLES))
    cols = {"sample.id": np.arange(1, N_SAMPLES + 1), "x1": x1, "x2": x2,
            "y": ((rng.random(N_SAMPLES) < 1 / (1 + np.exp(
                -(0.3 * x1 - 1.0 + g))))) * 1.0,
            "y2": ((rng.random(N_SAMPLES) < 1 / (1 + np.exp(
                -(-0.2 * x2 - 1.5 + g))))) * 1.0,
            "q": 10 + 0.5 * x1 + g + rng.normal(size=N_SAMPLES),
            "site": rng.choice(np.array(["east", "west"]), N_SAMPLES)}
    pheno = str(tmp / "pheno.tsv")
    with open(pheno, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(list(cols))
        for row in zip(*(v.tolist() for v in cols.values())):
            w.writerow([repr(x) if isinstance(x, float) else x
                        for x in row])
    cols["x1"][7] = np.nan          # a missing covariate, written as NA
    with open(pheno) as f:
        lines = f.read().splitlines()
    fields = lines[8].split("\t")
    fields[1] = "NA"
    lines[8] = "\t".join(fields)
    with open(pheno, "w") as f:
        f.write("\n".join(lines) + "\n")
    return tmp, gds, pheno, cols


def _run(*argv):
    assert main([*argv, "--device", "cpu"]) == 0


def _assert_models_equal(a, b):
    for f in ("tau", "coefficients", "fitted_values", "XV"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    np.testing.assert_array_equal(a.var_ratio["ratio"], b.var_ratio["ratio"])


def _text(a) -> np.ndarray:
    """A column as text; an empty string and NaN are one missing cell (a
    text file reads an empty field back as NaN, as pandas does)."""
    a = np.asarray(a).astype(str)
    return np.where(np.isin(a, ["", "nan"]), "", a)


def _assert_tables_equal(got: dict, want: dict, rtol=0.0):
    assert list(got) == list(want)
    for c, w in want.items():
        w = np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[c], w, rtol=rtol, err_msg=c)
        elif w.dtype == bool:     # a .gds column of flags reads back 0/1
            np.testing.assert_array_equal(np.asarray(got[c]).astype(int),
                                          w.astype(int), err_msg=c)
        else:
            np.testing.assert_array_equal(_text(got[c]), _text(w),
                                          err_msg=c)


FIT_FORMULA = "y ~ x1 + x2 + site"


@pytest.fixture(scope="module")
def fitted(data):
    tmp, gds, pheno, cols = data
    _run("fit", "--formula", FIT_FORMULA, "--pheno", pheno, "--gds", gds,
         "--out", str(tmp / "model.npz"))
    return sgt.NullModel.load(str(tmp / "model.npz"))


def test_pheno_columns(data):
    _, _, pheno, cols = data
    from saigegds_tpu_torch.__main__ import _read_pheno
    got = _read_pheno(pheno)
    assert got["sample.id"].dtype == np.int64 and got["y"].dtype.kind == "f"
    assert got["site"].dtype == object and np.isnan(got["x1"][7])
    for c in cols:
        _assert_tables_equal({c: got[c]}, {c: cols[c]})


def test_fit_equals_api_and_jax_cli(data, fitted):
    import saigegds_tpu
    from saigegds_tpu.__main__ import main as jax_main
    tmp, gds, pheno, cols = data
    api = sgt.fit_null_glmm(FIT_FORMULA, cols, gds, sgt.NullModelConfig(),
                            device="cpu")
    _assert_models_equal(fitted, api)
    assert fitted.coef_names == ["(Intercept)", "x1", "x2", "site_west"]
    assert jax_main(["fit", "--formula", FIT_FORMULA, "--pheno", pheno,
                     "--gds", gds, "--out", str(tmp / "jax_model.npz")]) == 0
    jm = saigegds_tpu.NullModel.load(str(tmp / "jax_model.npz"))
    np.testing.assert_allclose(fitted.tau, jm.tau, rtol=RTOL_JAX)
    np.testing.assert_allclose(fitted.coefficients, jm.coefficients,
                               rtol=RTOL_JAX)
    np.testing.assert_allclose(fitted.var_ratio["ratio"],
                               jm.var_ratio["ratio"], rtol=RTOL_JAX)


def test_fit_pheno_cols_equals_multi_api(data):
    tmp, gds, pheno, cols = data
    out = str(tmp / "multi_{}.npz")
    _run("fit", "--formula", "ignored ~ x1 + x2", "--pheno-cols", "y,y2",
         "--pheno", pheno, "--gds", gds, "--out", out)
    api = sgt.fit_null_glmm_multi(["y ~ x1 + x2", "y2 ~ x1 + x2"], cols,
                                  gds, device="cpu")
    for p in range(2):
        _assert_models_equal(sgt.NullModel.load(out.format(p)), api[p])


def test_fit_quantitative_and_heritability(data):
    import saigegds_tpu
    tmp, gds, pheno, cols = data
    out = str(tmp / "q.npz")
    _run("fit", "--formula", "q ~ x1", "--trait", "quantitative", "--pheno",
         pheno, "--gds", gds, "--out", out)
    m = sgt.NullModel.load(out)
    assert m.trait_type == "quantitative" and (m.tau > 0).all()
    want = saigegds_tpu.glmm_heritability(saigegds_tpu.NullModel.load(out))
    assert sgt.glmm_heritability(out) == pytest.approx(want, rel=1e-12)
    assert 0 < want < 1


def test_heritability_binary(fitted, data):
    import saigegds_tpu
    tmp = data[0]
    path = str(tmp / "model.npz")
    jm = saigegds_tpu.NullModel.load(path)
    for adjust in (True, False):
        want = saigegds_tpu.glmm_heritability(jm, adjust=adjust)
        assert sgt.glmm_heritability(fitted, adjust=adjust) == \
            pytest.approx(want, rel=1e-12)


def test_scan_equals_api_and_jax_cli(data, fitted):
    from saigegds_tpu.__main__ import main as jax_main
    tmp, gds, _, _ = data
    model = str(tmp / "model.npz")
    out = str(tmp / "scan.tsv")
    _run("scan", "--gds", gds, "--model", model, "--out", out,
         "--mac", "5")
    got = sgt.load_pval(out)
    api = sgt.assoc_spa(gds, fitted, sgt.ScanConfig(mac=5.0), device="cpu")
    _assert_tables_equal(got, api, rtol=1e-15)
    assert jax_main(["scan", "--gds", gds, "--model", model, "--out",
                     str(tmp / "jax_scan.tsv"), "--mac", "5"]) == 0
    want = sgt.load_pval(str(tmp / "jax_scan.tsv"))
    _assert_tables_equal(got, want, rtol=RTOL_JAX)


def test_scan_two_models_and_ranges(data, fitted):
    tmp, gds, _, _ = data
    model = str(tmp / "model.npz")
    out = str(tmp / "two_{}.gds")
    _run("scan", "--gds", gds, "--model", model, "--model", model, "--out",
         out, "--pos-range", "1000:15000")
    mask = SeqData(gds).variant_selection(position_range=(1000, 15000))
    api = sgt.assoc_spa_multi(gds, [fitted, fitted], variant_mask=mask,
                              device="cpu")
    for i in range(2):
        _assert_tables_equal(sgt.load_pval(out.format(i)), api[i])
    assert len(api[0]["id"]) < N_VARIANTS


def test_merge_equals_jax_load_pval(data, fitted):
    from saigegds_tpu.utils.stats import load_pval as jax_load_pval
    tmp, gds, _, _ = data
    model = str(tmp / "model.npz")
    for i in range(2):
        _run("scan", "--gds", gds, "--model", model, "--out",
             str(tmp / f"sh.part{i}.tsv"), "--shard", f"{i}/2")
    _run("merge", "--prefix", str(tmp / "sh"), "--out",
         str(tmp / "merged.tsv"))
    got = sgt.load_pval(str(tmp / "merged.tsv"))
    want = jax_load_pval([str(tmp / f"sh.part{i}.tsv") for i in range(2)])
    # pandas' default text parser is not exactly round-trip for floats
    _assert_tables_equal(got, {c: want[c].to_numpy() for c in want.columns},
                         rtol=1e-13)
    # the shards' blocks start elsewhere: phase 1's sums reassociate
    full = sgt.assoc_spa(gds, fitted, device="cpu")
    _assert_tables_equal(got, full, rtol=1e-12)


@pytest.mark.parametrize("cmd", ["burden", "acat-v", "acat-o"])
def test_aggregate_equals_api(data, fitted, cmd):
    tmp, gds, _, _ = data
    out = str(tmp / f"{cmd}.gds")
    _run(cmd, "--gds", gds, "--model", str(tmp / "model.npz"), "--out", out,
         "--win-size", "2000", "--win-shift", "1000", "--unit-shard", "1/2")
    units = sgt.shard_units(sgt.sliding_windows(SeqData(gds), 2000, 1000),
                            1, 2)
    fn = {"burden": sgt.assoc_burden, "acat-v": sgt.assoc_acat_v,
          "acat-o": sgt.assoc_acat_o}[cmd]
    api = fn(gds, fitted, units, sgt.AggregateConfig(), device="cpu")
    _assert_tables_equal(sgt.load_pval(out), api)


def test_gxg_equals_api(data):
    tmp, gds, pheno, cols = data
    pairs = str(tmp / "pairs.tsv")
    with open(pairs, "w") as f:
        f.write("a\tb\n30\t31\n60\t200\n")
    out = str(tmp / "gxg.tsv")
    _run("gxg", "--formula", "y ~ x1 + x2", "--pheno", pheno, "--gds", gds,
         "--pairs", pairs, "--out", out, "--use-approx-tau",
         "--pair-batch", "2")
    api = sgt.gxg_spa("y ~ x1 + x2", cols, gds,
                      {"a": [30, 60], "b": [31, 200]}, use_approx_tau=True,
                      pair_batch=2, device="cpu")
    _assert_tables_equal(sgt.load_pval(out), api, rtol=1e-15)


def test_vcf2gds_reads_back(tmp_path):
    vcf = tmp_path / "x.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\ts2\ts3\n"
        "1\t100\trs1\tA\tG\t.\t.\t.\tGT\t0/0\t0/1\t1/1\n"
        "1\t200\trs2\tC\tT\t.\t.\t.\tGT\t./.\t1|1\t0|1\n")
    out = str(tmp_path / "x.gds")
    _run("vcf2gds", "--vcf", str(vcf), "--out", out)
    seq = SeqData(out)
    np.testing.assert_array_equal(seq.sample_id.astype(str),
                                  ["s1", "s2", "s3"])
    np.testing.assert_array_equal(seq.position, [100, 200])
    ds = seq.dosage_block(0, 2)
    np.testing.assert_array_equal(ds[0], [0, 1, 2])
    assert np.isnan(ds[1, 0]) and list(ds[1, 1:]) == [2, 1]


def test_info_and_load_pval_errors(capsys, tmp_path):
    _run("info")
    assert "torch=" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="parquet"):
        sgt.load_pval(str(tmp_path / "x.parquet"))
    with pytest.raises(ValueError, match="index"):
        sgt.load_pval(["a.tsv", "b.tsv"], index=[0])
