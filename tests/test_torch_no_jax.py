"""Guards of the PyTorch port's boundary with the JAX package.

* The port imports and scans with ``jax`` made unimportable, fits with
  ``jax`` and ``pandas`` made unimportable, and loads no
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
            "models/glm.py", "utils/rrandom.py"]

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


def _run(code: str, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
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


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_copy_is_verbatim(rel):
    with open(os.path.join(ROOT, "saigegds_tpu", rel), "rb") as f:
        want = f.read()
    with open(os.path.join(PORT, rel), "rb") as f:
        assert f.read() == want, f"saigegds_tpu_torch/{rel} drifted"
