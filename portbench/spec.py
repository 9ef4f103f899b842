"""``BENCHMARK.json`` and the files its names lead to: a cell's
configuration (``configs/<config>.json``), its traffic mix
(``mixes/<traffic>.json``), its limits (``limits/<cell>.json``) and each
per-layer metric's reader (``metrics/<name>.py``, a function
``read(ctx)`` that returns the metric's value or None where it has
nothing to read)."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    def __init__(self, root: str = ROOT):
        self.root = root
        self.bench = _json(os.path.join(root, "BENCHMARK.json"))
        self.cells = {w["name"]: w for w in self.bench["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise SystemExit(f"portbench: no workload {name!r} in "
                             f"BENCHMARK.json ({sorted(self.cells)})")
        return self.cells[name]

    def config(self, name: str) -> dict:
        entry = next(c for c in self.bench["configs"] if c["name"] == name)
        return _json(os.path.join(self.root, entry["file"]))

    @staticmethod
    def mix(name: str) -> dict:
        return _json(os.path.join(HERE, "mixes", f"{name}.json"))

    @staticmethod
    def limits(cell: str) -> dict:
        return _json(os.path.join(HERE, "limits", f"{cell}.json"))

    def _for(self, metric: dict, cell: str) -> bool:
        """Whether ``cell`` reports ``metric``: the cells of its
        ``workloads`` key, or without one every cell (an end-to-end
        metric) or every cell that reports the metric it moves."""
        if "workloads" in metric:
            return cell in metric["workloads"]
        if "moves" not in metric:
            return True
        moved = next(m for m in self.bench["end_to_end"]
                     if m["name"] == metric["moves"])
        return self._for(moved, cell)

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"] if self._for(m, cell)]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.bench["per_layer"] if self._for(m, cell)]


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
