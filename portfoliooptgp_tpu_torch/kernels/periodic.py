"""Periodic kernel wrapper (gpflow.kernels.Periodic semantics), batched.

Port of portfoliooptgp_tpu/kernels/periodic.py:

    k(x,x') = base.K_r(Σ_d |sin(π(x_d-x'_d)/p)| / ℓ_d)     for K_r bases
    k(x,x') = base.K_r2(Σ_d sin²(π(x_d-x'_d)/p) / ℓ_d²)    for K_r2 bases

The base kernel's variance and lengthscales stay its trainable amplitude
and smoothness; the wrapper adds the period. Leaves, in order:
[base.raw_variance, base.raw_lengthscales, raw_period], each (B,) (the
base lengthscale (B, D) when ARD).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE
from portfoliooptgp_tpu_torch.kernels.base import ActiveDims, Kernel, normalize_active_dims
from portfoliooptgp_tpu_torch.kernels.stationary import Stationary
from portfoliooptgp_tpu_torch.params import as_param, positive, positive_inv


@dataclasses.dataclass(frozen=True)
class Periodic(Kernel):
    base: Stationary
    raw_period: torch.Tensor
    active_dims: ActiveDims = None

    @classmethod
    def create(cls, base: Stationary, period=1.0, active_dims=None, *,
               device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
        return cls(
            base=base,
            raw_period=positive_inv(as_param(period, device, dtype)),
            active_dims=normalize_active_dims(active_dims),
        )

    @property
    def period(self):
        return positive(self.raw_period)

    def _K(self, X, X2):
        diff = X[:, None, :] - X2[None, :, :]  # (N, M, D)
        ls = self.base.lengthscales
        ls = ls[:, None, None, None] if ls.ndim == 1 else ls[:, None, None, :]
        sine = torch.sin(math.pi * diff[None] / self.period[:, None, None, None]) / ls
        if hasattr(self.base, "K_r2"):
            return self.base.K_r2(torch.sum(sine * sine, dim=-1))
        return self.base.K_r(torch.sum(torch.abs(sine), dim=-1))

    def _Kdiag(self, X):
        return self.base.variance[:, None] * torch.ones(
            X.shape[0], dtype=X.dtype, device=X.device)
