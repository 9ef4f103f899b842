"""saigegds_tpu_torch: the PyTorch/CUDA port of saigegds_tpu.

The capabilities of the SAIGEgds R package, rebuilt for one NVIDIA H100:
PyTorch for the tensor code and hand-written CUDA kernels (``csrc/``) where
the JAX package had Pallas kernels.  The JAX package ``saigegds_tpu`` stays
beside it as the reference; this package imports ``torch`` and never
``jax``.  It fits the binary-trait null GLMM (:func:`fit_null_glmm`) and
runs the binary-trait association scan (:func:`assoc_spa`); quantitative
traits and the other tests are still to be ported (ROADMAP Queue A).

The reference contract is float64 throughout: every statistic is made as
a float64 tensor explicitly (the global default dtype is left alone), and
every public function that places data takes an explicit ``device``.
"""

from .config import NullModelConfig, ScanConfig
from .models.nullmodel import NullModel
from .models.fitnull import fit_null_glmm
from .assoc.single import assoc_spa, save_assoc

__version__ = "0.1.0"
