"""Utilities: metrics, checkpointing, profiling.

Port of portfoliooptgp_tpu/utils/. The JAX package's `compile_cache.py`
has no counterpart: it configures XLA's persistent compilation cache, and
the port's only compiled artifacts are its CUDA kernels, which
ops/cuda_build.py builds once into `build/kernels/` and reuses.
"""

from portfoliooptgp_tpu_torch.utils import checkpoint as checkpoint
from portfoliooptgp_tpu_torch.utils import metrics as metrics
from portfoliooptgp_tpu_torch.utils import profiling as profiling
from portfoliooptgp_tpu_torch.utils.metrics import MetricsLogger
