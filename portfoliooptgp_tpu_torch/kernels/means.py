"""Mean functions (gpflow.functions semantics), batched over models.

Port of portfoliooptgp_tpu/kernels/means.py. `Zero` returns (N, 1) and
broadcasts over the batch; the others carry a leading batch axis of B
models and return (B, N, 1). Leaves, in order:

    ConstantMean:   [c (B,)]
    LinearMean:     [A (B, D, 1), b (B,)]
    PolynomialMean: [w (B, degree+1)]; degree is static
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE
from portfoliooptgp_tpu_torch.params import as_param


class MeanFunction:
    _meta = ()

    def __call__(self, X):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Zero(MeanFunction):
    def __call__(self, X):
        return torch.zeros((X.shape[0], 1), dtype=X.dtype, device=X.device)


@dataclasses.dataclass(frozen=True)
class ConstantMean(MeanFunction):
    c: torch.Tensor

    @classmethod
    def create(cls, c=0.0, *, device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
        return cls(c=as_param(c, device, dtype))

    def __call__(self, X):
        ones = torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
        return self.c[:, None, None] * ones


@dataclasses.dataclass(frozen=True)
class LinearMean(MeanFunction):
    """f(X) = X A + b, A: (D, 1), b: scalar, per model."""

    A: torch.Tensor
    b: torch.Tensor

    @classmethod
    def create(cls, A=None, b=0.0, input_dim=1, *, device=DEFAULT_DEVICE,
               dtype=DEFAULT_DTYPE):
        A = np.ones((input_dim, 1)) if A is None else np.asarray(A, dtype=float)
        if A.ndim == 1:
            A = A[:, None]
        return cls(A=as_param(A, device, dtype), b=as_param(b, device, dtype))

    def __call__(self, X):
        return X @ self.A + self.b[:, None, None]


@dataclasses.dataclass(frozen=True)
class PolynomialMean(MeanFunction):
    """f(x) = Σ_{k=0}^{degree} w_k (Σ_d x_d)^k, a 1-D polynomial trend on
    the summed input."""

    _meta = ("degree",)

    w: torch.Tensor
    degree: int = 2

    @classmethod
    def create(cls, degree=2, w=None, *, device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
        if w is None:
            w = np.zeros((degree + 1,))
            w[0] = 1.0
        return cls(w=as_param(w, device, dtype), degree=int(degree))

    def __call__(self, X):
        s = torch.sum(X, dim=-1, keepdim=True)
        powers = torch.cat([s ** k for k in range(self.degree + 1)], dim=-1)
        return powers @ self.w[..., None]
