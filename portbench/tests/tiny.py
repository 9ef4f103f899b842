"""Cells of ``BENCHMARK.json`` shrunk to a size the CPU runs in seconds:
the same entries, references and comparisons, fewer samples, markers,
variants and lanes."""

from __future__ import annotations

import copy

from portbench.spec import Spec

SEED = 2**31 + 12345      # larger than 32 signed bits hold


def tiny(cell: str, spec: Spec = None):
    """(cfg, mix, e2e, per_layer, limits) of ``cell`` at a CPU size."""
    spec = spec or Spec()
    c = spec.cell(cell)
    cfg = copy.deepcopy(spec.config(c["config"]))
    mix = copy.deepcopy(spec.mix(c["traffic"]))
    cfg.update(n_samples=1000, gds_samples=1200, grm_markers=300)
    if mix["entry"] == "fit_lanes":
        mix["phenotypes_per_call"] = 4
        mix["check"] = dict(mix["check"], early_products=3, late_products=10)
    else:
        mix.update(variants=300, block_size=128, causal_pool=8,
                   causal_effect=[0.3, 0.8])
    return (cfg, mix, spec.end_to_end(cell), spec.per_layer(cell),
            spec.limits(cell))
