"""CPU tests of the benchmark harness: every mix at a tiny size against
its reference through the same comparison, the float32 control and the
planted faults coming out as not correct, the names of BENCHMARK.json
resolving to files, the frozen roofline reckoning, and the run's freedom
from JAX and the JAX package."""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import roofline, run
from portbench.spec import HERE, ROOT, Spec, reader
from portbench.tests.tiny import SEED, tiny

SPEC = Spec()
CELLS = sorted(SPEC.cells)
FIT_CELLS = [c for c in CELLS if SPEC.mix(SPEC.cell(c)["traffic"])["entry"]
             == "fit_lanes"]
SCAN_CELLS = [c for c in CELLS if c not in FIT_CELLS]


def _trait(cell: str) -> str:
    return SPEC.config(SPEC.cell(cell)["config"])["trait"]["type"]


def run_tiny(cell, seconds=0.0, seed=SEED, wrap=None, trace=False):
    cfg, mix, e2e, per_layer, limits = tiny(cell)
    return run.run_cell(cfg, mix, e2e, per_layer, limits, seed,
                        seconds, trace, "cpu", t_start=time.perf_counter(),
                        entry_wrap=wrap)


@pytest.mark.parametrize("cell", CELLS)
def test_mix_runs_tiny_and_agrees(cell):
    res = run_tiny(cell, seconds=1.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and len(res["calls"]) >= 1
    names = {m["name"] for m in SPEC.end_to_end(cell)}
    assert set(res["metrics"]) == names
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(cell):
    a, b = run_tiny(cell), run_tiny(cell)
    assert a["attempted"] == b["attempted"]
    assert {k: v["value"] for k, v in a["checks"].items()} == \
        {k: v["value"] for k, v in b["checks"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in float32 in the program's place fails a limit."""
    def wrap(state):
        real = state.readings
        state.readings = lambda prog, dtypes=(): (
            real(prog, (torch.float32,))[1][0], [])

    res = run_tiny(cell, wrap=wrap)
    assert not res["correct"], res["checks"]


def _fit_unchanged(state):
    """The fitter returns its starting state: tau_init and the start's
    eta for every lane."""
    real = state.entry

    def entry(op, Y, X, tau, *rest, **kw):
        fit = real(op, Y, X, tau, *rest, **kw)
        eta = rest[0] if isinstance(rest[0], torch.Tensor) and \
            rest[0].shape == Y.shape else Y
        return fit._replace(tau=tau.clone(), eta=eta.clone())
    state.entry = entry


def _fit_half_batch(state):
    """The GRM products over half of the markers, scaled up to all of
    them (the mean over the half that is left)."""
    from saigegds_tpu_torch.ops.packed_grm import build_packed2_grm
    codes = torch.cat([c for _s, c in state.markers.code_blocks()])
    half = codes.shape[0] // 2
    op_half = build_packed2_grm(codes[:half].numpy(), device="cpu")
    real = state.op.op

    class Half:
        diag, matvecs, widths = real.diag, 0, {}
        af, inv, miss = real.af, real.inv, real.miss

        def matvec(self, b):
            return op_half.matvec(b)

    state.op.op = Half()


def _fit_altered(state):
    """Every lane's tau[1] altered where the fitter produces it."""
    real = state.entry

    def entry(*args, **kw):
        fit = real(*args, **kw)
        tau = fit.tau.clone()
        tau[:, 1] *= 1.0 + 1e-6
        return fit._replace(tau=tau)
    state.entry = entry


def _scan_unchanged(state):
    """Phase 2 returns its input unchanged: every p-value stays the
    chi-square one."""
    real = state._scan

    def scan(models, variant_mask=None, instrument=None):
        tabs = real(models, variant_mask, instrument)
        for t in tabs:
            t["pval"] = np.array(t["p.norm"])
        return tabs
    state._scan = scan


def _scan_half_batch(state):
    """Half of each block's variants left out, their statistics the mean
    of the rest."""
    real = state._scan

    def scan(models, variant_mask=None, instrument=None):
        tabs = real(models, variant_mask, instrument)
        for t in tabs:
            for k in ("beta", "SE", "pval", "p.norm"):
                if k not in t:      # a quantitative table has no p.norm
                    continue
                v = np.array(t[k], np.float64)
                v[1::2] = v[0::2].mean()
                t[k] = v
        return tabs
    state._scan = scan


def _scan_altered(state):
    """Every p-value altered where the scan produces it."""
    real = state._scan

    def scan(models, variant_mask=None, instrument=None):
        tabs = real(models, variant_mask, instrument)
        for t in tabs:
            t["pval"] = np.array(t["pval"]) * (1.0 + 1e-6)
        return tabs
    state._scan = scan


def _scan_no_ratio(state):
    """Each model scanned with its variance-ratio table set to 1, where
    the reference keeps the model's."""
    real = state._scan

    def scan(models, variant_mask=None, instrument=None):
        ones = [dataclasses.replace(m, var_ratio=dict(
            m.var_ratio, ratio=np.ones_like(m.var_ratio["ratio"])))
            for m in models]
        return real(ones, variant_mask, instrument)
    state._scan = scan


# a quantitative model's phase 1 is final: nothing for SPA to leave
# unchanged, and its variance ratio is the part a binary fault misses
SCAN_FAULTS = {"binary": (_scan_unchanged, _scan_half_batch, _scan_altered),
               "quantitative": (_scan_half_batch, _scan_altered,
                                _scan_no_ratio)}
FAULTS = [(c, f) for c in FIT_CELLS for f in
          (_fit_unchanged, _fit_half_batch, _fit_altered)] + \
    [(c, f) for c in SCAN_CELLS for f in SCAN_FAULTS[_trait(c)]]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault):
    res = run_tiny(cell, wrap=fault)
    assert not res["correct"], res["checks"]


def test_names_resolve_to_files():
    b = SPEC.bench
    for c in b["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(HERE, "mixes",
                                           f"{w['traffic']}.json"))
        mix = SPEC.mix(w["traffic"])
        assert run.entry_class(mix["entry"]) is not None
        assert set(SPEC.limits(w["name"]))
        reported = {m["name"] for m in SPEC.end_to_end(w["name"])}
        assert "setup_s" in reported and mix["rate_metric"] in reported
        layer = SPEC.per_layer(w["name"])
        assert layer and all(m["moves"] in reported for m in layer)
    for m in b["per_layer"]:
        assert callable(reader(m["name"]))


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_shape():
    b = SPEC.bench
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert UNIT.match(m["unit"])
    assert len(json.dumps(b)) < 64 * 1024


def test_roofline_matches_the_table():
    """PERF.md's bounds of B1 and B2 at M = 16,384, N = 430,000."""
    M, N = 16384, 430000
    ms = lambda f, C: round(f(M, N, C) * 1e3, 3)
    assert ms(roofline.b1_bound_s, 16) == 0.528
    assert ms(roofline.b2_bound_s, 16) == 0.534
    for C, want in ((256, 1.823), (384, 2.734), (2048, 14.582)):
        assert ms(roofline.b1_bound_s, C) == want
        assert ms(roofline.b2_bound_s, C) == want


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert not tops & {"saigegds_tpu_torch", "saigegds_tpu", "jax",
                               "jaxlib", "flax"}, f


_BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "saigegds_tpu"):
            raise ImportError(name + " is blocked")
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
from portbench import run
from portbench.tests.tiny import tiny, SEED
import time
for cell in {cells!r}:
    cfg, mix, e2e, layer, limits = tiny(cell)
    res = run.run_cell(cfg, mix, e2e, layer, limits, SEED, 0.0, False,
                       "cpu", t_start=time.perf_counter())
    assert res["correct"], res["checks"]
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
print("FORBIDDEN", run.forbidden_modules())
"""


def test_run_loads_no_jax():
    code = _BLOCKER.format(root=ROOT, cells=CELLS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = eval(out.stdout.split("LOADED", 1)[1].splitlines()[0])
    assert not set(loaded) & {"jax", "jaxlib", "flax", "saigegds_tpu"}
    assert "FORBIDDEN []" in out.stdout


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints nothing on
    standard output."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                          "--workload", CELLS[0], "--seed", str(SEED),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
