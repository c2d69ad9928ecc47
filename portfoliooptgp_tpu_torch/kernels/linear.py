"""Dot-product kernels (gpflow.kernels.Linear / Polynomial semantics),
batched. Port of portfoliooptgp_tpu/kernels/linear.py:

    Linear:     k(x,x') = σ² ⟨x, x'⟩          leaves [raw_variance (B,)]
    Polynomial: k(x,x') = (σ² ⟨x, x'⟩ + γ)^d  leaves [raw_variance (B,),
                                               raw_offset (B,)]; d is static
"""

from __future__ import annotations

import dataclasses

import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE
from portfoliooptgp_tpu_torch.kernels.base import ActiveDims, Kernel, normalize_active_dims
from portfoliooptgp_tpu_torch.params import as_param, positive, positive_inv


@dataclasses.dataclass(frozen=True)
class Linear(Kernel):
    raw_variance: torch.Tensor
    active_dims: ActiveDims = None

    @classmethod
    def create(cls, variance=1.0, active_dims=None, *, device=DEFAULT_DEVICE,
               dtype=DEFAULT_DTYPE):
        return cls(raw_variance=positive_inv(as_param(variance, device, dtype)),
                   active_dims=normalize_active_dims(active_dims))

    @property
    def variance(self):
        return positive(self.raw_variance)

    def _K(self, X, X2):
        return self.variance[:, None, None] * (X @ X2.T)

    def _Kdiag(self, X):
        return self.variance[:, None] * torch.sum(X * X, dim=-1)


@dataclasses.dataclass(frozen=True)
class Polynomial(Kernel):
    _meta = ("active_dims", "degree")

    raw_variance: torch.Tensor
    raw_offset: torch.Tensor
    degree: float = 3.0
    active_dims: ActiveDims = None

    @classmethod
    def create(cls, degree=3.0, variance=1.0, offset=1.0, active_dims=None, *,
               device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
        return cls(raw_variance=positive_inv(as_param(variance, device, dtype)),
                   raw_offset=positive_inv(as_param(offset, device, dtype)),
                   degree=float(degree),
                   active_dims=normalize_active_dims(active_dims))

    @property
    def variance(self):
        return positive(self.raw_variance)

    @property
    def offset(self):
        return positive(self.raw_offset)

    def _K(self, X, X2):
        return (self.variance[:, None, None] * (X @ X2.T)
                + self.offset[:, None, None]) ** self.degree

    def _Kdiag(self, X):
        return (self.variance[:, None] * torch.sum(X * X, dim=-1)
                + self.offset[:, None]) ** self.degree
