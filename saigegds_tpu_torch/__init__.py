"""saigegds_tpu_torch: the PyTorch/CUDA port of saigegds_tpu.

The capabilities of the SAIGEgds R package, rebuilt for one NVIDIA H100:
PyTorch for the tensor code and hand-written CUDA kernels (``csrc/``) where
the JAX package had Pallas kernels.  The JAX package ``saigegds_tpu`` stays
beside it as the reference; this package imports ``torch`` and never
``jax``.  It fits the null GLMM of a binary or a quantitative trait
(:func:`fit_null_glmm`, resumable with ``checkpoint=``), runs the
association scan (:func:`assoc_spa` over hard calls or imputed dosages,
:func:`assoc_spa_user` over dosages the caller supplies) and the burden
test (:func:`assoc_burden`) for both, and ACAT-V and ACAT-O
(:func:`assoc_acat_v`, :func:`assoc_acat_o`) for a binary trait, as the
reference does; models and tables read and write the reference's
``.rds``/``.rda`` files.  The other entry points are still to be ported
(ROADMAP Queue A).

The reference contract is float64 throughout: every statistic is made as
a float64 tensor explicitly (the global default dtype is left alone), and
every public function that places data takes an explicit ``device``.
"""

from .config import AggregateConfig, NullModelConfig, ScanConfig
from .models.nullmodel import NullModel
from .models.fitnull import fit_null_glmm
from .assoc.single import assoc_spa, assoc_spa_user, save_assoc
from .assoc.aggregate import (VariantUnits, assoc_acat_o, assoc_acat_v,
                              assoc_burden, shard_units, sliding_windows,
                              units_from_groups)
from .utils.stats import acat_p, acat_p_maf

__version__ = "0.1.0"
