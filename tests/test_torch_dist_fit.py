"""The PyTorch port's sample-sharded fit across processes
(``fit_null_glmm(mesh=)`` over a mesh that spans a ``torch.distributed``
group, ``parallel/mesh.ShardedGrmHandle.serve``,
``parallel/distributed.Wire``) on the CPU: two and three gloo processes
with a ``file://`` rendezvous, every rank on ``devices=["cpu"]``, N = 1,031
samples (uneven ranges) x M = 600 variants.

Tolerances:

* the spanning GRM product at R = 1 and 30 -- ``Packed2GRM.matvec`` of
  the whole store bit for bit, for the streamed and the in-memory builds
  (only exact integers cross the wire);
* ``fit_null_glmm(mesh=)`` across processes -- the port's one-process fit
  bit for bit on every rank (tau, coefficients, fitted values, variance
  ratios, products, PCG iterations), and within ``test_torch_fit.py``'s
  1e-6 of the JAX package's one-process fit (``grm_impl="packed2"``);
* a lead that raises makes every process exit non-zero, long before the
  group's timeout;
* the dense oracle and the scan refuse a mesh that spans processes.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
import saigegds_tpu
import saigegds_tpu_torch as sgt
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch.ops.packed_grm import build_packed2_grm
from saigegds_tpu_torch.parallel.mesh import Mesh, ShardedGrmHandle, \
    check_lead, sample_ranges

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
RTOL_FIT = 1e-6
N_SAMPLES, N_VARIANTS = 1031, 600
FORMULA = {"binary": "y ~ x1 + x2 + x3",
           "quantitative": "yq ~ x1 + x2 + x3"}
GROUP_TIMEOUT_S = 600       # init_distributed's timeout_s in the children
RUN_TIMEOUT_S = 240         # every child must have exited by then


_CHILD = r"""
import json
import sys

import numpy as np
import torch

import saigegds_tpu_torch as sg
from saigegds_tpu_torch.models import fitnull
from saigegds_tpu_torch.ops.grm import build_grm
from saigegds_tpu_torch.ops.packed_grm import build_packed2_grm
from saigegds_tpu_torch.parallel.distributed import init_distributed
from saigegds_tpu_torch.parallel.mesh import ShardedGrmHandle, make_mesh

rank, world = int(sys.argv[1]), int(sys.argv[2])
init, work, mode = sys.argv[3], sys.argv[4], sys.argv[5]
torch.set_num_threads(1)
assert init_distributed(init, world, rank, device="cpu", backend="gloo",
                        timeout_s=float(sys.argv[6])) == (rank, world)
mesh = make_mesh(devices=["cpu"])
assert mesh.size == world and mesh.ranks == tuple(range(world))
assert mesh.rank == rank and mesh.is_lead == (rank == 0) and mesh.spans
out = {}

if mode == "product":
    codes = np.load(f"{work}/codes.npy")
    M, N = codes.shape
    bs = np.load(f"{work}/b.npz")

    def blocks():
        for s in range(0, M, 97):
            yield np.arange(s, min(s + 97, M)), codes[s:s + 97]

    for build in ("streamed", "memory"):
        if build == "streamed":
            h = ShardedGrmHandle.from_streamed_blocks(blocks(), N, M, mesh)
        else:
            h = ShardedGrmHandle(build_packed2_grm(codes, device="cpu"),
                                 mesh)
        lo, hi = h.ranges[rank]
        assert len(h.stores) == 1 and h.store_bytes[0] == \
            M * 16 * -(-(hi - lo) // 64)
        if rank == 0:
            for R in (1, 30):
                out[f"{build}_{R}"] = h.matvec(
                    torch.from_numpy(bs[f"b{R}"])).numpy()
            out[f"{build}_wire"] = np.array([h.wire.bytes])
            h.wire.stop()
        else:
            assert h.af is None and h.miss is None and h.diag is None
            out[f"{build}_served"] = np.array([h.serve()])
elif mode in ("fit", "abort"):
    data = dict(np.load(f"{work}/data.npz"))
    stream, trait = sys.argv[7] == "streamed", sys.argv[8]
    if mode == "abort" and rank == 0:
        real, calls = fitnull._fit_tau_binary, [0]

        def failing(*a, **k):
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("induced failure of the lead")
            return real(*a, **k)

        fitnull._fit_tau_binary = failing
    inst = {}
    model = sg.fit_null_glmm(
        ("y" if trait == "binary" else "yq") + " ~ x1 + x2 + x3", data,
        f"{work}/fit.gds",
        sg.NullModelConfig(trait_type=trait, stream_geno=stream,
                           checkpoint=f"{work}/ck_{world}_{rank}"),
        instrument=inst, device="cpu", mesh=mesh)
    for k in ("tau", "coefficients", "fitted_values", "linear_predictors"):
        out[k] = getattr(model, k)
    for k in ("id", "ratio"):
        out["vr_" + k] = model.var_ratio[k]
    with open(f"{work}/inst_{rank}.json", "w") as f:
        json.dump({k: v for k, v in inst.items()
                   if isinstance(v, (int, float))}
                  | {"widths": inst["product_widths"]}, f)
elif mode == "refuse":
    codes = np.load(f"{work}/codes.npy")
    try:
        ShardedGrmHandle(build_grm(codes, device="cpu"), mesh)
        raise AssertionError("the dense oracle spanned processes")
    except NotImplementedError:
        pass
    try:
        sg.fit_null_glmm("y ~ x1", dict(np.load(f"{work}/data.npz")),
                         f"{work}/fit.gds",
                         sg.NullModelConfig(grm_impl="dense"), device="cpu",
                         mesh=mesh)
        raise AssertionError("a dense fit spanned processes")
    except NotImplementedError:
        pass
    for fn, arg in ((sg.assoc_spa, object()), (sg.assoc_spa_multi,
                                               [object()])):
        try:
            fn(f"{work}/fit.gds", arg, device="cpu", mesh=mesh)
            raise AssertionError(f"{fn.__name__} took a spanning mesh")
        except ValueError as e:
            assert "assoc_spa_sharded" in str(e), e
np.savez(f"{work}/out_{rank}.npz", **out)
print("OK")
"""


def _run(tmp, world: int, mode: str, *extra) -> list:
    """Run the child script as ranks 0 .. world - 1 of one gloo group;
    returns ``(exit code, stdout, stderr)`` per rank."""
    script = tmp / "child.py"
    script.write_text(_CHILD)
    init = f"file://{tmp}/rendezvous_{mode}_{world}_{'_'.join(extra)}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), init, str(tmp),
         mode, str(GROUP_TIMEOUT_S), *extra], cwd=str(tmp), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    deadline = time.monotonic() + RUN_TIMEOUT_S
    out = []
    try:
        for p in procs:
            o, e = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _ok(results):
    for rank, (rc, o, e) in enumerate(results):
        assert rc == 0 and o.strip().endswith("OK"), \
            f"rank {rank} exited {rc}: {e[-3000:]}"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """``tests/test_torch_fit.py``'s polygenic binary phenotype (seed 5)
    at N = 1,031, so that the group's sample ranges are uneven, and a
    quantitative one of the same genetic values
    (``tests/test_torch_mesh.py``'s)."""
    tmp = tmp_path_factory.mktemp("torch_dist_fit")
    rng = np.random.default_rng(5)
    af = rng.uniform(0.05, 0.5, size=(N_VARIANTS, 1))
    codes = rng.binomial(2, af, size=(N_VARIANTS, N_SAMPLES)).astype(np.int8)
    beta = rng.normal(size=N_VARIANTS) * np.sqrt(0.6 / N_VARIANTS) \
        / np.sqrt(2 * af[:, 0] * (1 - af[:, 0]))
    X = rng.normal(size=(N_SAMPLES, 3))
    eta = X @ np.array([0.3, -0.2, 0.1]) - 1.0 + codes.T @ beta
    y = (rng.random(N_SAMPLES) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    yq = 2.0 + X @ np.array([0.5, 0.1, -0.3]) + codes.T @ beta \
        + rng.normal(size=N_SAMPLES) * np.sqrt(0.8)
    codes[rng.random(codes.shape) < 0.005] = 3
    codes[0] = 0                       # monomorphic: inv = 0
    write_seqarray_gds(str(tmp / "fit.gds"), codes)
    np.save(tmp / "codes.npy", codes)
    cols = {"sample.id": np.arange(1, N_SAMPLES + 1), "y": y, "yq": yq,
            "x1": X[:, 0], "x2": X[:, 1], "x3": X[:, 2]}
    np.savez(tmp / "data.npz", **cols)
    bs = {f"b{R}": rng.normal(size=(N_SAMPLES, R) if R > 1 else N_SAMPLES)
          for R in (1, 30)}
    np.savez(tmp / "b.npz", **bs)
    return dict(tmp=tmp, codes=codes, cols=cols, bs=bs)


@pytest.mark.parametrize("world", [2, 3])
def test_spanning_product(data, world):
    """Each rank keeps its range's store; the lead's products equal the
    one-store product bit for bit, both builds, R = 1 and 30; every other
    rank served the four products."""
    tmp = data["tmp"]
    _ok(_run(tmp, world, "product"))
    got = np.load(tmp / "out_0.npz")
    op = build_packed2_grm(data["codes"], device="cpu")
    for build in ("streamed", "memory"):
        for R in (1, 30):
            want = op.matvec(torch.from_numpy(data["bs"][f"b{R}"])).numpy()
            np.testing.assert_array_equal(got[f"{build}_{R}"], want,
                                          err_msg=f"{build} R={R}")
        # per product: header, slices and operand out, partials and rows in
        rs = [8, 240]
        n_remote = N_SAMPLES - sample_ranges(N_SAMPLES, world)[0][1]
        assert got[f"{build}_wire"][0] == sum(
            16 * (world - 1) + n_remote * c + N_VARIANTS * c * 4
            + N_VARIANTS * c * (world - 1) + n_remote * c * 4 for c in rs)
    for r in range(1, world):
        served = np.load(tmp / f"out_{r}.npz")
        assert served["streamed_served"][0] == served["memory_served"][0] == 2


_one_fits = {}


def _one_fit(data, trait: str):
    """The port's fit in one process, no mesh."""
    if trait not in _one_fits:
        inst = {}
        model = sgt.fit_null_glmm(
            FORMULA[trait], data["cols"], str(data["tmp"] / "fit.gds"),
            sgt.NullModelConfig(trait_type=trait), instrument=inst,
            device="cpu")
        _one_fits[trait] = model, inst
    return _one_fits[trait]


_fits = {}


def _spanning_fit(data, world: int, build: str, trait: str) -> list:
    key = (world, build, trait)
    if key not in _fits:
        tmp = data["tmp"]
        _ok(_run(tmp, world, "fit", build, trait))
        _fits[key] = [(dict(np.load(tmp / f"out_{r}.npz")),
                       json.loads((tmp / f"inst_{r}.json").read_text()))
                      for r in range(world)]
        assert not list(tmp.glob("ck_*")), "checkpoint files left behind"
    return _fits[key]


@pytest.mark.parametrize("world,build,trait", [
    (2, "memory", "binary"), (2, "streamed", "binary"),
    (3, "memory", "binary"), (3, "streamed", "binary"),
    (3, "streamed", "quantitative")])
def test_spanning_fit(data, world, build, trait):
    """Every rank returns the one-process fit bit for bit; each rank
    other than the lead served every product of the fit."""
    model, inst = _one_fit(data, trait)
    ranks = _spanning_fit(data, world, build, trait)
    for rank, (got, ginst) in enumerate(ranks):
        for k in ("tau", "coefficients", "fitted_values",
                  "linear_predictors"):
            np.testing.assert_array_equal(got[k], getattr(model, k),
                                          err_msg=f"rank {rank} {k}")
        for k in ("id", "ratio"):
            np.testing.assert_array_equal(got["vr_" + k],
                                          model.var_ratio[k])
        for k in ("matvecs", "pcg_iterations", "outer_iterations"):
            assert ginst[k] == inst[k], (rank, k)
        assert {int(c): n for c, n in ginst["widths"].items()} \
            == inst["product_widths"]
    lead = ranks[0][1]
    assert lead["wire_bytes"] > 0 and lead["wire_s"] > 0
    for _got, ginst in ranks[1:]:
        assert "wire_s" not in ginst and ginst["serve_s"] > 0


def test_spanning_fit_matches_jax(data):
    """The fit across two processes against the JAX package's fit of the
    same data in one process, as in ``tests/test_torch_fit.py``."""
    got = _spanning_fit(data, 2, "memory", "binary")[0][0]
    jm = saigegds_tpu.fit_null_glmm(
        FORMULA["binary"], pd.DataFrame(data["cols"]),
        str(data["tmp"] / "fit.gds"),
        saigegds_tpu.NullModelConfig(grm_impl="packed2"))
    rel = lambda a, b: float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                                    / np.abs(np.asarray(b))))
    assert rel(got["tau"][1], jm.tau[1]) < RTOL_FIT
    assert rel(got["coefficients"], jm.coefficients) < RTOL_FIT
    np.testing.assert_array_equal(got["vr_id"], jm.var_ratio["id"])
    assert rel(got["vr_ratio"], jm.var_ratio["ratio"]) < RTOL_FIT


@pytest.mark.parametrize("world", [2, 3])
def test_lead_failure_aborts_every_rank(data, world):
    """The lead raises in its second outer iteration: it sends the abort,
    and every process exits non-zero well inside the group's timeout."""
    t0 = time.monotonic()
    results = _run(data["tmp"], world, "abort", "memory", "binary")
    assert time.monotonic() - t0 < GROUP_TIMEOUT_S / 2
    for rank, (rc, _o, e) in enumerate(results):
        assert rc != 0, f"rank {rank} exited 0"
        want = "induced failure of the lead" if rank == 0 \
            else "the lead rank aborted the fit"
        assert want in e, e[-3000:]


def test_spanning_mesh_refuses(data):
    """The dense oracle does not span processes (NotImplementedError, from
    the handle and from a dense fit, on every rank before any message),
    and neither does the scan (ValueError naming ``assoc_spa_sharded``)."""
    _ok(_run(data["tmp"], 2, "refuse"))


def test_mesh_of_a_group():
    """A mesh that spans processes, seen from rank 1 of 3 (no group is
    needed to build one): its parts, its lead and this rank's device."""
    mesh = Mesh(["cpu", "cpu", "cpu", "cpu"], ranks=[0, 0, 1, 2], rank=1)
    assert mesh.spans and not mesh.is_lead and mesh.local() == [2]
    assert mesh.home == torch.device("cpu") and mesh.size == 4
    assert check_lead(mesh, "cpu") == torch.device("cpu")
    assert "ranks=[0, 0, 1, 2]" in repr(mesh)
    one = Mesh(["cpu"] * 2)
    assert not one.spans and one.is_lead and one.local() == [0, 1]
    with pytest.raises(ValueError, match="rank order"):
        Mesh(["cpu", "cpu"], ranks=[1, 0])
    with pytest.raises(ValueError, match="rank order"):
        Mesh(["cpu", "cpu"], ranks=[0, 1], rank=2)
    with pytest.raises(ValueError, match="rank order"):
        Mesh(["cpu", "cpu"], ranks=[1, 2], rank=1)
    other = Mesh(["cpu", "cuda:0"], ranks=[0, 1], rank=1)
    with pytest.raises(ValueError, match="rank 1's first device"):
        check_lead(other, "cpu")
    with pytest.raises(RuntimeError, match="lead"):
        h = ShardedGrmHandle.__new__(ShardedGrmHandle)
        h.mesh, h.dense = mesh, False
        h.matvec(torch.zeros(3))
