"""R files in the PyTorch port: null models read and written as ``.rds``
and ``.rda`` (the reference's ``saveRDS`` / ``save(glmm, file=)``), and
scan tables saved as ``.rds`` / ``.rda``, against the JAX package.

``io/rds.py`` and ``io/rds_write.py`` are byte-identical copies of the JAX
package's (``test_torch_no_jax.py``), so both packages write the same
bytes; these tests hold the model structure on top of them: column-major
matrices, ``coef_names`` and ``tau`` names, ``converged`` as a logical,
the compact ``row.names`` of the variance-ratio data.frame and its
``mac.bins`` attribute.

Tolerance: none.  A model loaded from a file of the other package holds
the same arrays, and a scan from it equals the scan from the model it was
written from, bit for bit, in either package.
"""

import numpy as np
import pytest

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import jax_null_model, jax_quant_null_model, \
    synth_codes, synth_pheno, synth_quant_pheno, var_ratio_table
import saigegds_tpu
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu.io.rds import read_rds as jax_read_rds
from saigegds_tpu.io.rds import strip as jax_strip
from saigegds_tpu.models.nullmodel import NullModel as JaxNullModel
from saigegds_tpu.utils.stats import load_pval
import saigegds_tpu_torch as sg
from saigegds_tpu_torch.io.rds import read_rdata, read_rds
from saigegds_tpu_torch.io.rds import strip as port_strip

N_SAMPLES, N_VARIANTS, BLOCK = 613, 120, 64
FIELDS = ("coefficients", "tau", "linear_predictors", "fitted_values",
          "residuals", "cov", "y", "mu", "res", "V", "X1", "XV", "XXVX_inv",
          "sample_id", "variant_id")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_rds")
    rng = np.random.default_rng(23)
    X, y = synth_pheno(rng, N_SAMPLES)
    Xq, yq = synth_quant_pheno(rng, N_SAMPLES)
    codes = synth_codes(rng, N_VARIANTS, N_SAMPLES, y=y)
    gds = str(tmp / "geno.gds")
    write_seqarray_gds(gds, codes)
    sid = np.arange(1, N_SAMPLES + 1, dtype=np.int32)
    models = {
        "binary_cat": jax_null_model(X, y, var_ratio_table("cat")),
        "quant": jax_quant_null_model(Xq, yq, var_ratio_table("pooled")),
    }
    for jm in models.values():
        jm.sample_id = sid
        jm.variant_id = np.arange(1, 31, dtype=np.int32)
    return tmp, gds, models


def _assert_same_model(a, b):
    assert a.trait_type == b.trait_type
    assert list(a.coef_names) == list(b.coef_names)
    assert bool(a.converged) == bool(b.converged)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert sorted(a.var_ratio) == sorted(b.var_ratio)
    for k in a.var_ratio:
        np.testing.assert_array_equal(np.asarray(a.var_ratio[k]),
                                      np.asarray(b.var_ratio[k]), err_msg=k)


def _assert_same_table(got: dict, want: dict):
    assert list(got) == list(want)
    for c in want:
        np.testing.assert_array_equal(np.asarray(got[c]),
                                      np.asarray(want[c]), err_msg=c)


@pytest.mark.parametrize("ext", [".rds", ".rda", ".RData"])
@pytest.mark.parametrize("kind", ["binary_cat", "quant"])
def test_port_model_loads_in_jax(data, kind, ext):
    """A model the port writes loads in the JAX package with the same
    arrays, and the JAX scan from it equals the JAX scan from the model it
    came from."""
    tmp, gds, models = data
    jm = models[kind]
    tm = sg.NullModel.from_arrays(vars(jm))
    path = str(tmp / f"port_{kind}{ext}")
    tm.save(path)
    back = JaxNullModel.load(path)
    _assert_same_model(back, jm)
    cfg = saigegds_tpu.ScanConfig(block_size=BLOCK, packed_sparse=False)
    want = saigegds_tpu.assoc_spa(gds, jm, cfg)
    got = saigegds_tpu.assoc_spa(gds, back, cfg)
    _assert_same_table({c: got[c].to_numpy() for c in got},
                       {c: want[c].to_numpy() for c in want})


@pytest.mark.parametrize("ext", [".rds", ".rda"])
@pytest.mark.parametrize("kind", ["binary_cat", "quant"])
def test_jax_model_loads_in_port(data, kind, ext):
    """A model the JAX package writes loads in the port with the same
    arrays, and the port's scan from the file equals its scan from the
    model carried over by ``from_arrays``."""
    tmp, gds, models = data
    jm = models[kind]
    path = str(tmp / f"jax_{kind}{ext}")
    jm.save(path)
    back = sg.NullModel.load(path)
    tm = sg.NullModel.from_arrays(vars(jm))
    _assert_same_model(back, tm)
    cfg = sg.ScanConfig(block_size=BLOCK)
    _assert_same_table(sg.assoc_spa(gds, path, cfg, device="cpu"),
                       sg.assoc_spa(gds, tm, cfg, device="cpu"))


def test_r_object_layout(data):
    """The written structure: the class, named coefficients and tau, a
    logical ``converged``, column-major matrices, and the var.ratio
    data.frame with compact row names and its ``mac.bins`` attribute."""
    tmp, _, models = data
    tm = sg.NullModel.from_arrays(vars(models["binary_cat"]))
    path = str(tmp / "layout.rds")
    tm.save(path)
    for obj, strip in ((read_rds(path), port_strip),
                       (jax_read_rds(path), jax_strip)):
        assert list(strip(obj.attributes["class"])) == \
            ["ClassSAIGE_NullModel"]
        assert list(obj["coefficients"].names) == list(tm.coef_names)
        assert list(obj["tau"].names) == ["Sigma_E", "Sigma_G"]
        # a logical (the readers decode LGLSXP as int8, INTSXP as int32)
        assert strip(obj["converged"]).dtype == np.int8
        x1 = obj["obj.noK"]["X1"]
        K = tm.X1.shape[1]
        np.testing.assert_array_equal(strip(x1.attributes["dim"]),
                                      [N_SAMPLES, K])
        np.testing.assert_array_equal(strip(x1), tm.X1.ravel(order="F"))
        vr = obj["var.ratio"]
        np.testing.assert_array_equal(strip(vr.attributes["row.names"]),
                                      [-2**31, -len(tm.var_ratio["ratio"])])
        np.testing.assert_array_equal(strip(vr.attributes["mac.bins"]),
                                      [10.5, 20.5])
    tm.save(str(tmp / "layout.rda"))
    assert list(read_rdata(str(tmp / "layout.rda"))) == ["glmm"]


@pytest.mark.parametrize("compress", ["LZMA", "ZIP", "none"])
@pytest.mark.parametrize("ext", [".rds", ".rda"])
def test_saved_table_reads_back(data, ext, compress):
    """``save_assoc`` (and ``res_savefn``) to .rds / .rda: the JAX
    package's ``load_pval`` and the port's reader give the table back."""
    tmp, gds, models = data
    tm = sg.NullModel.from_arrays(vars(models["binary_cat"]))
    path = str(tmp / f"tab_{compress}{ext}")
    tab = sg.assoc_spa(gds, tm, sg.ScanConfig(block_size=BLOCK),
                       res_savefn=path, res_compress=compress, device="cpu")
    back = load_pval(path)
    assert list(back.columns) == list(tab)
    for c in tab:
        np.testing.assert_array_equal(back[c].to_numpy(),
                                      np.asarray(tab[c]), err_msg=c)
    if ext == ".rda":
        assert list(read_rdata(path)) == [".res"]
    else:
        obj = read_rds(path)
        assert list(port_strip(obj.attributes["class"])) == ["data.frame"]


def test_saved_set_table_reads_back(data):
    tmp, gds, models = data
    tm = sg.NullModel.from_arrays(vars(models["quant"]))
    units = sg.units_from_groups(sg.io.seqarray.SeqData(gds),
                                 {f"u{i}": list(range(i + 1, i + 11))
                                  for i in range(0, N_VARIANTS, 10)})
    path = str(tmp / "set.rds")
    tab = sg.assoc_burden(gds, tm, units, sg.AggregateConfig(),
                          res_savefn=path, device="cpu")
    back = load_pval(path)
    assert list(back.columns) == list(tab)
    for c in tab:
        np.testing.assert_array_equal(back[c].to_numpy(),
                                      np.asarray(tab[c]), err_msg=c)


def test_parquet_still_raises(data):
    tmp, gds, models = data
    tab = {"id": np.arange(3), "pval": np.ones(3)}
    with pytest.raises(NotImplementedError, match="pandas"):
        sg.save_assoc(tab, str(tmp / "t.parquet"))
