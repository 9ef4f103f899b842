"""Guards of the PyTorch port's boundary with the JAX package.

* The port imports and scans with ``jax`` made unimportable, fits (a
  binary and a quantitative trait) and runs the aggregate tests (ACAT-O
  of a binary trait, the burden test of a quantitative one) with ``jax``
  and ``pandas`` made unimportable; likewise it scans a DS node and a
  ``$dosage_alt`` node, runs ``assoc_spa_user``, the burden test and
  ACAT-O over DS units, fits with ``checkpoint=`` and
  ``var_ratio_mac_cat=``, and reads and writes ``.rds``/``.rda`` models
  and tables; it runs the PheWAS fit and scan, the four public device
  fitters, GxG and the command line's
  ``fit`` and ``scan`` (``python -m saigegds_tpu_torch``); it imports
  ``parallel/`` and fits and scans over a mesh of CPU shards and through
  the variant-range shard API, and takes a GRM product over a mesh that
  spans two processes of a gloo group; and it loads no
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
            "io/rds.py", "io/rds_write.py", "io/vcf.py", "models/glm.py",
            "utils/rrandom.py", "utils/telemetry.py", "native/fastio.cpp"]

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


_PHEWAS_GXG_CLI_WITHOUT_JAX_OR_PANDAS = r"""
import os, subprocess, sys
sys.modules["jax"] = None          # any import of jax or pandas now raises
sys.modules["pandas"] = None
import numpy as np
import saigegds_tpu_torch as sg
from saigegds_tpu_torch.io.gds_write import write_seqarray_gds

rng = np.random.default_rng(5)
N, M = 240, 120
codes = rng.binomial(2, rng.uniform(0.1, 0.5, (M, 1)), size=(M, N))
codes = codes.astype(np.int8)
codes[rng.random((M, N)) < 0.005] = 3
path = sys.argv[1]
write_seqarray_gds(path, codes, position=np.arange(1, M + 1) * 10)
g = np.where(codes == 3, 0, codes).T @ rng.normal(size=M) * 0.15
data = {"sample.id": np.arange(1, N + 1), "x1": rng.normal(size=N)}
for i in range(2):
    data[f"y{i}"] = (rng.random(N) < 1 / (1 + np.exp(1 + i - g))) * 1.0
models = sg.fit_null_glmm_multi(["y0 ~ x1", "y1 ~ x1"], data, path,
                                device="cpu")
assert all(np.isfinite(m.tau).all() for m in models)
# the public device fitters over an operator, one lane and several
import torch
from saigegds_tpu_torch.models.glm import glm_binomial
from saigegds_tpu_torch.ops.packed_grm import build_packed2_grm
t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
op = build_packed2_grm(codes, device="cpu")
Xd = np.column_stack([np.ones(N), data["x1"]])
U = t(rng.choice([-1.0, 1.0], size=(N, 40)))
Y = np.stack([data["y0"], data["y1"]])
E = t(np.stack([glm_binomial(Xd, y).linear_predictors for y in Y]))
fb = sg.fit_glmm_binary_device_multi(op, t(Y), t(Xd), t([[1.0, 0.5]] * 2),
                                     E, U, 0.02, 1e-5)
f1 = sg.fit_glmm_binary_device(op, t(Y[1]), t(Xd), t([1.0, 0.5]), E[1], U,
                               0.02, 1e-5)
assert torch.allclose(f1.tau, fb.tau[1], rtol=1e-10) and f1.tau.shape == (2,)
yq = t(np.stack([g + rng.normal(size=N) for _ in range(2)]))
tq = t([[0.5, 0.5]] * 2)
fq = sg.fit_glmm_quant_device_multi(op, yq, t(Xd), tq, U, 0.02, 1e-5)
f1q = sg.fit_glmm_quant_device(op, yq[0], t(Xd), tq[0], U, 0.02, 1e-5)
assert torch.allclose(f1q.tau, fq.tau[0], rtol=1e-10)
assert fb.lane_groups == fq.lane_groups == (2,)
tabs = sg.assoc_spa_multi(path, models, sg.ScanConfig(block_size=32),
                          device="cpu")
assert len(tabs) == 2 and np.array_equal(tabs[0]["id"], tabs[1]["id"])
gx = sg.gxg_spa("y0 ~ x1", data, path, [(3, 4), (10, 20)],
                use_approx_tau=True, pair_batch=2, device="cpu")
assert ((gx["pval"] >= 0) & (gx["pval"] <= 1)).all()
bad = [m for m in sys.modules
       if m == "saigegds_tpu" or m.startswith("saigegds_tpu.")
       or (m.startswith(("jax", "pandas")) and sys.modules[m] is not None)]
assert not bad, bad
pheno = os.path.join(os.path.dirname(path), "pheno.tsv")
with open(pheno, "w") as f:
    f.write("sample.id\tx1\ty0\ty1\n")
    for row in zip(*(data[c] for c in ("sample.id", "x1", "y0", "y1"))):
        f.write("\t".join(repr(float(v)) if i else str(v)
                           for i, v in enumerate(row)) + "\n")
# the command line in a process of its own that cannot import jax or
# pandas either
guard = ("import sys; sys.modules['jax'] = sys.modules['pandas'] = None; "
         "import runpy; sys.argv[0] = 'saigegds_tpu_torch'; "
         "runpy.run_module('saigegds_tpu_torch', run_name='__main__')")
out = os.path.join(os.path.dirname(path), "m_{}.npz")
for args in (["fit", "--formula", "y ~ x1", "--pheno-cols", "y0,y1",
              "--pheno", pheno, "--gds", path, "--out", out],
             ["scan", "--gds", path, "--model", out.format(0), "--model",
              out.format(1), "--out", out.replace(".npz", ".tsv")]):
    subprocess.run([sys.executable, "-c", guard, *args, "--device", "cpu"],
                   check=True, capture_output=True)
back = sg.load_pval(out.replace(".npz", ".tsv").format(1))
assert np.array_equal(back["pval"], tabs[1]["pval"])
print("OK")
"""


_MESH_WITHOUT_JAX_OR_PANDAS = r"""
import sys
sys.modules["jax"] = None          # any import of jax or pandas now raises
sys.modules["pandas"] = None
import numpy as np
import saigegds_tpu_torch as sg
from saigegds_tpu_torch.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch.parallel import distributed, mesh
from saigegds_tpu_torch.parallel.distributed import assoc_spa_sharded, \
    init_distributed, merge_shards

rng = np.random.default_rng(6)
N, M = 241, 90
codes = rng.binomial(2, rng.uniform(0.1, 0.5, (M, 1)), size=(M, N))
codes = codes.astype(np.int8)
codes[rng.random((M, N)) < 0.01] = 3
path = sys.argv[1]
write_seqarray_gds(path, codes)
g = np.where(codes == 3, 0, codes).T @ rng.normal(size=M) * 0.15
data = {"sample.id": np.arange(1, N + 1), "x1": rng.normal(size=N),
        "y": (rng.random(N) < 1 / (1 + np.exp(1 - g))) * 1.0}
shards = mesh.make_mesh(devices=["cpu"] * 3)
one = sg.fit_null_glmm("y ~ x1", data, path, device="cpu")
model = sg.fit_null_glmm("y ~ x1", data, path, device="cpu", mesh=shards)
assert np.array_equal(model.tau, one.tau)
cfg = sg.ScanConfig(block_size=32, mac=1.0)
tab = sg.assoc_spa(path, model, cfg, device="cpu", mesh=shards)
want = sg.assoc_spa(path, model, cfg, device="cpu")
assert all(np.array_equal(tab[c], want[c]) for c in want)
assert init_distributed() == (0, 1)
for pid in range(2):
    assoc_spa_sharded(path, model, path + "_s", cfg, process_id=pid,
                      process_count=2, device="cpu")
merged = merge_shards(path + "_s")
assert all(np.array_equal(merged[c], want[c]) for c in want)
bad = [m for m in sys.modules
       if m == "saigegds_tpu" or m.startswith("saigegds_tpu.")
       or (m.startswith(("jax", "pandas")) and sys.modules[m] is not None)]
assert not bad, bad
print("OK")
"""


_SPANNING_PRODUCT_RANK = r"""
import sys
sys.modules["jax"] = None          # any import of jax or pandas now raises
sys.modules["pandas"] = None
import numpy as np
import torch
from saigegds_tpu_torch.ops.packed_grm import build_packed2_grm
from saigegds_tpu_torch.parallel.distributed import init_distributed
from saigegds_tpu_torch.parallel.mesh import ShardedGrmHandle, make_mesh

rank, init, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
init_distributed(init, 2, rank, device="cpu", timeout_s=120)
rng = np.random.default_rng(7)
codes = rng.binomial(2, rng.uniform(0.1, 0.5, (70, 1)), size=(70, 333))
codes = codes.astype(np.int8)
codes[rng.random(codes.shape) < 0.02] = 3
b = torch.from_numpy(rng.normal(size=(333, 3)))
op = build_packed2_grm(codes, device="cpu")
h = ShardedGrmHandle(op, make_mesh(devices=["cpu"]))
if rank == 0:
    assert torch.equal(h.matvec(b), op.matvec(b))
    h.wire.stop()
else:
    assert h.serve() == 1
bad = [m for m in sys.modules
       if m == "saigegds_tpu" or m.startswith("saigegds_tpu.")
       or (m.startswith(("jax", "pandas")) and sys.modules[m] is not None)]
assert not bad, bad
print("OK")
"""

_SPANNING_PRODUCT_WITHOUT_JAX_OR_PANDAS = r"""
import os
import subprocess
import sys
work = os.path.dirname(sys.argv[1])
rank_code = sys.argv[2]
procs = [subprocess.Popen([sys.executable, "-c", rank_code, str(r),
                           f"file://{work}/rendezvous", work],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True) for r in range(2)]
for r, p in enumerate(procs):
    out, err = p.communicate(timeout=240)
    assert p.returncode == 0 and out.strip().endswith("OK"), (r, err[-3000:])
print("OK")
"""


def _run(code: str, tmp_path, *args):
    # one intra-op thread: the scripts' tensors are small, and parallel
    # test workers share the cores
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "g.gds"), *args],
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


def test_phewas_gxg_cli_without_jax_or_pandas(tmp_path):
    _run(_PHEWAS_GXG_CLI_WITHOUT_JAX_OR_PANDAS, tmp_path)


def test_mesh_and_shards_without_jax_or_pandas(tmp_path):
    _run(_MESH_WITHOUT_JAX_OR_PANDAS, tmp_path)


def test_spanning_product_without_jax_or_pandas(tmp_path):
    """Two processes of a gloo group, each unable to import jax or
    pandas: the product over a mesh that spans them equals the one-store
    product bit for bit."""
    _run(_SPANNING_PRODUCT_WITHOUT_JAX_OR_PANDAS, tmp_path,
         _SPANNING_PRODUCT_RANK)


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_copy_is_verbatim(rel):
    with open(os.path.join(ROOT, "saigegds_tpu", rel), "rb") as f:
        want = f.read()
    with open(os.path.join(PORT, rel), "rb") as f:
        assert f.read() == want, f"saigegds_tpu_torch/{rel} drifted"
