"""saigegds_tpu_torch: the PyTorch/CUDA port of saigegds_tpu.

The capabilities of the SAIGEgds R package, rebuilt for one NVIDIA H100:
PyTorch for the tensor code and hand-written CUDA kernels (``csrc/``) where
the JAX package had Pallas kernels.  The JAX package ``saigegds_tpu`` stays
beside it as the reference; this package imports ``torch`` and never
``jax``.  It fits the null GLMM of a binary or a quantitative trait
(:func:`fit_null_glmm`, resumable with ``checkpoint=``; several
phenotypes over one resident GRM with :func:`fit_null_glmm_multi`, in
groups sized to the card's free memory; the AI-REML fit alone over a GRM
operator with :func:`fit_glmm_binary_device`, :func:`fit_glmm_quant_device`
and their several-phenotype forms ``*_multi``), runs
the association scan (:func:`assoc_spa` over hard calls or imputed
dosages, :func:`assoc_spa_multi` for several models over one pass of the
genotypes, :func:`assoc_spa_user` over dosages the caller supplies), the
burden test (:func:`assoc_burden`) for both traits, ACAT-V and ACAT-O
(:func:`assoc_acat_v`, :func:`assoc_acat_o`) and the GxG interaction test
(:func:`gxg_spa`) for a binary trait, as the reference does; models and
tables read and write the reference's ``.rds``/``.rda`` files, and
``python -m saigegds_tpu_torch`` is the command line.

The reference contract is float64 throughout: every statistic is made as
a float64 tensor explicitly (the global default dtype is left alone), and
every public function that places data takes an explicit ``device``.
"""

from .config import AggregateConfig, NullModelConfig, ScanConfig
from .models.nullmodel import NullModel
from .models.fitnull import fit_null_glmm, fit_null_glmm_multi
from .models.fit_device import (fit_glmm_binary_device,
                                fit_glmm_binary_device_multi,
                                fit_glmm_quant_device,
                                fit_glmm_quant_device_multi)
from .assoc.single import assoc_spa, assoc_spa_multi, assoc_spa_user, \
    save_assoc
from .assoc.aggregate import (VariantUnits, assoc_acat_o, assoc_acat_v,
                              assoc_burden, shard_units, sliding_windows,
                              units_from_groups)
from .assoc.gxg import gxg_spa
from .utils.stats import acat_p, acat_p_maf, glmm_heritability, load_pval
from .utils.profiling import device_info, phase_timer, profile_trace

__version__ = "0.1.0"
