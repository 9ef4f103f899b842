"""The PheWAS scan of imputed dosages: each call is one
``assoc_spa_multi`` of fresh binary null models (one per case share of
the mix) over ONE GDS file written in set-up whose only dosage source is
``annotation/format/DS`` (dFloat32), its tables on the host.

Set-up draws the scanned variants' imputed dosages on the device from
the seed (``data/dosages.py``: the GDS's samples, the model's and, at
shuffled positions, the cohort's others), writes them with the
benchmark's frozen DS writer under the run's work directory, keeps the
dosages of the model's samples for the check, draws the covariates and
a pool of causal variants (their true genotypes, which the imputation
reports as dosages), and runs the scan once over the first block.  A
call's models are :class:`ScanModels`'s: binary traits of a few causal
variants at the mix's case shares, the benchmark's own logistic GLM of
each on the covariates, SAIGE's projections, and a variance-ratio
table; no GRM fit runs."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.dosages import imputed_dosages, variant_infos
from ..data.gds_ds import write_dosage_gds
from ..data.genotypes import scan_variant_afs
from ..data.phenotypes import F64, covariates
from ..reference.scan_check import gaps
from ..reference.scan_dosage import reference_tables
from ..seeds import host_rng
from .scan_models import ScanModels


class ScanDsModels(ScanModels):
    """One run's state; :meth:`call` is one closed-loop call."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 timed: bool, log, workdir: str):
        from saigegds_tpu_torch import ScanConfig

        if cfg["trait"]["type"] != "binary":
            raise NotImplementedError(
                "scan_ds_models makes binary null models")
        if len(mix["models_case_pct"]) != cfg["phenotypes"]:
            raise ValueError(f"the mix makes {len(mix['models_case_pct'])} "
                             f"models a call; the configuration scans "
                             f"{cfg['phenotypes']}")
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.dev = torch.device(device)
        self.timed = timed
        imp = cfg["imputation"]
        n, n_gds, V = cfg["n_samples"], cfg["gds_samples"], mix["variants"]
        t0 = time.perf_counter()
        af = scan_variant_afs(V, mix["maf_classes"], mix["alt_major"], seed)
        info = variant_infos(V, imp["info_range"], seed)
        rng = host_rng(seed, "scan.samples")
        cols = np.sort(rng.choice(n_gds, n, replace=False))
        ids = np.arange(1, n_gds + 1, dtype=np.int32)
        self.sample_id = ids[cols]
        maf = np.minimum(af, 1.0 - af)
        pool = np.sort(rng.choice(np.flatnonzero(
            maf >= mix["causal_maf_min"]), mix["causal_pool"],
            replace=False))
        # the GDS holds every sample; the reference reads the model's
        ds, self.dosages, truth = imputed_dosages(
            af, info, n_gds, cols, imp["levels"], seed, self.dev,
            truth_rows=pool)
        log(f"dosages drawn: {time.perf_counter() - t0:.2f} s")
        self.path = os.path.join(workdir, "scan_ds.gds")
        self.gds_bytes = write_dosage_gds(self.path, ds, ids)
        del ds
        log(f"DS GDS written: {self.gds_bytes} B, "
            f"{time.perf_counter() - t0:.2f} s")
        self.X = covariates(n, cfg["covariates"], seed, self.dev,
                            cfg["binary_covariates"])
        g = torch.as_tensor(truth, device=self.dev).to(F64)
        g = g - g.mean(1, keepdim=True)
        self.causal = g / g.std(1, keepdim=True)
        self.config = ScanConfig(block_size=mix["block_size"],
                                 spa_pval=mix["spa_pval"], mac=mix["mac"],
                                 missing=mix["missing"])
        self.kept = []          # every model of each call, for the check
        self.instrument = {}
        self._warm()

    def readings(self, prog: dict, dtypes=()):
        """The numbers compared, against one float64 reference over the
        kept dosages: the program's, and for each of ``dtypes`` the
        reference's computed in that type in the program's place (the
        control).  The tables compared are every model's of
        ``check["calls"]`` calls drawn from the seed."""
        calls = sorted({k["call"] for k in prog["kept"]})
        rng = host_rng(self.seed, "check.calls")
        pick = set(rng.choice(calls, min(self.mix["check"]["calls"],
                                         len(calls)), replace=False))
        kept = [k for k in prog["kept"] if k["call"] in pick]
        ref = reference_tables(self.dosages, kept, self._params(), F64,
                               self.dev)
        got = gaps([k["table"] for k in kept], ref)
        return got, [gaps(reference_tables(self.dosages, kept,
                                           self._params(), d, self.dev),
                          ref) for d in dtypes]


Entry = ScanDsModels
