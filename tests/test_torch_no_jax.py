"""Guards of the PyTorch port's boundary with the JAX package.

* The port imports and scans with ``jax`` made unimportable, fits (a
  binary and a quantitative trait) and runs the aggregate tests (ACAT-O
  of a binary trait, the burden test of a quantitative one) with ``jax``
  and ``pandas`` made unimportable; likewise it scans a DS node and a
  ``$dosage_alt`` node, runs ``assoc_spa_user``, the burden test and
  ACAT-O over DS units, fits with ``checkpoint=`` and
  ``var_ratio_mac_cat=``, and reads and writes ``.rds``/``.rda`` models
  and tables; and it loads no
  ``saigegds_tpu`` module on the way (``saigegds_tpu/__init__.py`` imports
  jax, so the port copies the framework-free host layers instead).
* Those copies stay byte-identical to their originals, so a fix to one is
  not lost in the other.
"""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PORT = os.path.join(ROOT, "saigegds_tpu_torch")
VERBATIM = ["config.py", "io/gds.py", "io/seqarray.py", "io/gds_write.py",
            "io/rds.py", "io/rds_write.py", "models/glm.py",
            "utils/rrandom.py", "native/fastio.cpp"]

_SCAN_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None          # any import of jax now raises
import numpy as np
import saigegds_tpu_torch as sg
from saigegds_tpu_torch.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch.models.glm import obj_nok_binary

rng = np.random.default_rng(0)
N, M = 203, 40
codes = rng.binomial(2, 0.3, size=(M, N)).astype(np.int8)
codes[rng.random((M, N)) < 0.03] = 3
path = sys.argv[1]
write_seqarray_gds(path, codes)
X = np.column_stack([np.ones(N), rng.normal(size=(N, 2))])
y = (rng.random(N) < 0.3).astype(np.float64)
nok = obj_nok_binary(X, y)
K = nok.X1.shape[1]
model = sg.NullModel(
    trait_type="binary", coefficients=np.zeros(K), coef_names=list("abc"),
    tau=np.array([1.0, 0.0]), linear_predictors=np.zeros(N),
    fitted_values=nok.mu, residuals=nok.res, cov=np.eye(K), converged=True,
    y=nok.y, mu=nok.mu, res=nok.res, V=nok.V, X1=nok.X1, XV=nok.XV,
    XXVX_inv=nok.XXVX_inv, var_ratio={"ratio": [1.0]},
    sample_id=np.arange(1, N + 1, dtype=np.int32))
tab = sg.assoc_spa(path, model, sg.ScanConfig(block_size=16, mac=1.0),
                   device="cpu")
assert len(tab["pval"]) == M and np.all((tab["pval"] >= 0) & (tab["pval"] <= 1))
bad = [m for m in sys.modules
       if m == "saigegds_tpu" or m.startswith("saigegds_tpu.")
       or (m.startswith("jax") and sys.modules[m] is not None)]
assert not bad, bad
print("OK")
"""


_FIT_WITHOUT_JAX_OR_PANDAS = r"""
import sys
sys.modules["jax"] = None          # any import of jax or pandas now raises
sys.modules["pandas"] = None
import numpy as np
import saigegds_tpu_torch as sg
from saigegds_tpu_torch.io.gds_write import write_seqarray_gds

rng = np.random.default_rng(1)
N, M = 240, 120
af = rng.uniform(0.1, 0.5, size=(M, 1))
codes = rng.binomial(2, af, size=(M, N)).astype(np.int8)
codes[rng.random((M, N)) < 0.005] = 3
path = sys.argv[1]
write_seqarray_gds(path, codes)
data = {"sample.id": np.arange(1, N + 1), "y": (rng.random(N) < 0.3) * 1.0,
        "x1": rng.normal(size=N), "grp": rng.choice(["a", "b"], N)}
model = sg.fit_null_glmm("y ~ x1 + grp", data, path,
                         sg.NullModelConfig(num_marker=5), device="cpu")
assert model.coef_names == ["(Intercept)", "x1", "grp_b"], model.coef_names
assert np.isfinite(model.tau).all() and len(model.var_ratio["ratio"]) >= 5
bad = [m for m in sys.modules
       if m == "saigegds_tpu" or m.startswith("saigegds_tpu.")
       or (m.startswith(("jax", "pandas")) and sys.modules[m] is not None)]
assert not bad, bad
print("OK")
"""


_AGGREGATE_WITHOUT_JAX_OR_PANDAS = r"""
import sys
sys.modules["jax"] = None          # any import of jax or pandas now raises
sys.modules["pandas"] = None
import numpy as np
import saigegds_tpu_torch as sg
from saigegds_tpu_torch.io import native
from saigegds_tpu_torch.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch.io.seqarray import SeqData
from saigegds_tpu_torch.models.glm import obj_nok_binary

rng = np.random.default_rng(2)
N, M = 301, 90
codes = rng.binomial(2, rng.uniform(0.002, 0.05, (M, 1)), size=(M, N))
codes = codes.astype(np.int8)
codes[rng.random((M, N)) < 0.01] = 3
path = sys.argv[1]
write_seqarray_gds(path, codes, position=np.arange(1, M + 1) * 10)
X = np.column_stack([np.ones(N), rng.normal(size=N)])
y = (rng.random(N) < 0.3).astype(np.float64)
nok = obj_nok_binary(X, y)
model = sg.NullModel(
    trait_type="binary", coefficients=np.zeros(2), coef_names=["a", "b"],
    tau=np.array([1.0, 0.0]), linear_predictors=np.zeros(N),
    fitted_values=nok.mu, residuals=nok.res, cov=np.eye(2), converged=True,
    y=nok.y, mu=nok.mu, res=nok.res, V=nok.V, X1=nok.X1, XV=nok.XV,
    XXVX_inv=nok.XXVX_inv, var_ratio={"ratio": [1.0]},
    sample_id=np.arange(1, N + 1, dtype=np.int32))
units = sg.sliding_windows(SeqData(path), win_size=200, win_shift=100)
inst = {}
tab = sg.assoc_acat_o(path, model, units, sg.AggregateConfig(),
                      instrument=inst, device="cpu")
p = tab["pval"][np.isfinite(tab["pval"])]
assert len(tab["pval"]) == len(units) and len(p) and ((p >= 0) & (p <= 1)).all()
assert inst["payloads"]["burden_sparse"] >= 1 and native.available()
bad = [m for m in sys.modules
       if m == "saigegds_tpu" or m.startswith("saigegds_tpu.")
       or (m.startswith(("jax", "pandas")) and sys.modules[m] is not None)]
assert not bad, bad
print("OK")
"""


_QUANT_WITHOUT_JAX_OR_PANDAS = r"""
import sys
sys.modules["jax"] = None          # any import of jax or pandas now raises
sys.modules["pandas"] = None
import numpy as np
import saigegds_tpu_torch as sg
from saigegds_tpu_torch.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch.io.seqarray import SeqData

rng = np.random.default_rng(3)
N, M = 240, 120
af = rng.uniform(0.02, 0.5, size=(M, 1))
codes = rng.binomial(2, af, size=(M, N)).astype(np.int8)
codes[rng.random((M, N)) < 0.005] = 3
path = sys.argv[1]
write_seqarray_gds(path, codes, position=np.arange(1, M + 1) * 10)
g = np.where(codes == 3, 0, codes).T @ rng.normal(size=M) * 0.1
data = {"sample.id": np.arange(1, N + 1), "x1": rng.normal(size=N),
        "y": 20 + g + np.exp(rng.normal(size=N))}
model = sg.fit_null_glmm("y ~ x1", data, path,
                         sg.NullModelConfig(trait_type="quantitative",
                                            num_marker=5), device="cpu")
assert model.trait_type == "quantitative" and (model.tau > 0).all()
assert np.isfinite(model.var_ratio["ratio"]).all()
units = sg.sliding_windows(SeqData(path), win_size=200, win_shift=100)
tab = sg.assoc_burden(path, model, units, sg.AggregateConfig(), device="cpu")
p = tab["pval.b1_1"][np.isfinite(tab["pval.b1_1"])]
assert len(p) and ((p >= 0) & (p <= 1)).all() and "p.norm.b1_1" not in tab
bad = [m for m in sys.modules
       if m == "saigegds_tpu" or m.startswith("saigegds_tpu.")
       or (m.startswith(("jax", "pandas")) and sys.modules[m] is not None)]
assert not bad, bad
print("OK")
"""


_DOSAGES_AND_R_FILES_WITHOUT_JAX_OR_PANDAS = r"""
import os, sys
sys.modules["jax"] = None          # any import of jax or pandas now raises
sys.modules["pandas"] = None
import numpy as np
import saigegds_tpu_torch as sg
from saigegds_tpu_torch.io.gds_write import write_dosage_gds, \
    write_seqarray_gds
from saigegds_tpu_torch.io.rds import read_rdata, read_rds, strip
from saigegds_tpu_torch.io.seqarray import SeqData

rng = np.random.default_rng(4)
N, M = 240, 120
codes = rng.binomial(2, rng.uniform(0.02, 0.5, (M, 1)), size=(M, N))
codes = codes.astype(np.int8)
codes[rng.random((M, N)) < 0.005] = 3
geno = sys.argv[1]
write_seqarray_gds(geno, codes, position=np.arange(1, M + 1) * 10)
ds = np.round(np.clip(codes + rng.normal(size=(M, N)) * 0.1, 0, 2), 3)
ds[codes == 3] = np.nan
dsf = geno + ".ds.gds"
write_dosage_gds(dsf, ds, position=np.arange(1, M + 1) * 10)
data = {"sample.id": np.arange(1, N + 1), "y": (rng.random(N) < 0.3) * 1.0,
        "x1": rng.normal(size=N)}
ck = os.path.join(os.path.dirname(geno), "ck")
model = sg.fit_null_glmm("y ~ x1", data, geno, sg.NullModelConfig(
    num_marker=5, maf=0.0, var_ratio_mac_cat=(30.5,), checkpoint=ck),
    device="cpu")
assert "mac_bins" in model.var_ratio and not os.path.exists(ck + ".fit.npz")
for ext in (".rds", ".rda"):
    model.save(geno + ext)
    back = sg.NullModel.load(geno + ext)
    assert np.array_equal(back.X1, model.X1)
    assert np.array_equal(back.var_ratio["mac_bins"], [30.5])
cfg = sg.ScanConfig(block_size=32)
tab = sg.assoc_spa(dsf, geno + ".rds", cfg, res_savefn=geno + ".res.rds",
                   device="cpu")
alt = sg.assoc_spa(geno, model, sg.ScanConfig(block_size=32,
                                              dsnode="$dosage_alt"),
                   res_savefn=geno + ".res.rda", device="cpu")
user = sg.assoc_spa_user(lambda s, e: ds[s:e], M, model, cfg, device="cpu")
assert np.array_equal(user["pval"], tab["pval"])
assert len(alt["pval"]) and np.array_equal(
    strip(read_rds(geno + ".res.rds")["pval"]), tab["pval"])
assert list(read_rdata(geno + ".res.rda")) == [".res"]
units = sg.sliding_windows(SeqData(dsf), win_size=200, win_shift=100)
for fn in (sg.assoc_burden, sg.assoc_acat_o):
    t = fn(dsf, model, units, sg.AggregateConfig(), device="cpu")
    p = t[[c for c in t if c.startswith("pval")][0]]
    p = p[np.isfinite(p)]
    assert len(p) and ((p >= 0) & (p <= 1)).all()
bad = [m for m in sys.modules
       if m == "saigegds_tpu" or m.startswith("saigegds_tpu.")
       or (m.startswith(("jax", "pandas")) and sys.modules[m] is not None)]
assert not bad, bad
print("OK")
"""


def _run(code: str, tmp_path):
    # one intra-op thread: the scripts' tensors are small, and parallel
    # test workers share the cores
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "g.gds")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_scan_runs_without_jax(tmp_path):
    _run(_SCAN_WITHOUT_JAX, tmp_path)


def test_fit_runs_without_jax_or_pandas(tmp_path):
    _run(_FIT_WITHOUT_JAX_OR_PANDAS, tmp_path)


def test_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|saigegds_tpu\b(?!_torch))",
                     re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    hits = []
    for path in paths:
        with open(path) as fh:
            if pat.search(fh.read()):
                hits.append(os.path.relpath(path, ROOT))
    assert len(paths) > 15 and not hits


def test_aggregate_runs_without_jax_or_pandas(tmp_path):
    _run(_AGGREGATE_WITHOUT_JAX_OR_PANDAS, tmp_path)


def test_quantitative_runs_without_jax_or_pandas(tmp_path):
    _run(_QUANT_WITHOUT_JAX_OR_PANDAS, tmp_path)


def test_dosages_and_r_files_without_jax_or_pandas(tmp_path):
    _run(_DOSAGES_AND_R_FILES_WITHOUT_JAX_OR_PANDAS, tmp_path)


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_copy_is_verbatim(rel):
    with open(os.path.join(ROOT, "saigegds_tpu", rel), "rb") as f:
        want = f.read()
    with open(os.path.join(PORT, rel), "rb") as f:
        assert f.read() == want, f"saigegds_tpu_torch/{rel} drifted"
