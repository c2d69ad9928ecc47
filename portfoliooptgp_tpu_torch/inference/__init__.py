"""Bayesian inference: NUTS / HMC over model hyperparameters.

Port of portfoliooptgp_tpu/inference/, with the same exports; random draws
come from a source (inference/source.py) instead of `jax.random` keys."""

from portfoliooptgp_tpu_torch.inference import hmc as hmc
from portfoliooptgp_tpu_torch.inference import nuts as nuts
from portfoliooptgp_tpu_torch.inference.fused_logdensity import (
    gpr_logdensity_pair,
    gpr_logdensity_vg,
)
from portfoliooptgp_tpu_torch.inference.sampler import (
    SampleStats,
    centered_normal_logprior,
    sample_nuts,
)
from portfoliooptgp_tpu_torch.inference.source import GeneratorSource
