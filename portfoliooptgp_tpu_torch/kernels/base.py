"""Kernel base classes — frozen dataclasses of raw parameter tensors.

Port of portfoliooptgp_tpu/kernels/base.py. Every parameter has a leading
batch axis of B models, so `K(X)` returns (B, N, M) and `Kdiag(X)` (B, N):
the JAX package's `jax.vmap` over stacked restarts becomes that axis.
`active_dims` is static metadata (`_meta`), not a parameter.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE
from portfoliooptgp_tpu_torch.params import as_param, positive, positive_inv

ActiveDims = Optional[tuple]  # None | ("slice", start, stop) | ("idx", i0, i1, ...)


def normalize_active_dims(active_dims) -> ActiveDims:
    if active_dims is None:
        return None
    if isinstance(active_dims, slice):
        if active_dims.step not in (None, 1):
            raise ValueError("active_dims slices must have step 1")
        return ("slice", active_dims.start or 0, active_dims.stop)
    if isinstance(active_dims, tuple) and active_dims and active_dims[0] in ("slice", "idx"):
        return active_dims
    return ("idx",) + tuple(int(i) for i in active_dims)


class Kernel:
    """Base kernel. Subclasses implement `_K(X, X2)` and `_Kdiag(X)` over the
    already-sliced inputs; `K`/`Kdiag` apply active_dims slicing first."""

    _meta = ("active_dims",)
    active_dims: ActiveDims = None

    def K(self, X, X2=None):
        Xs = self.slice_x(X)
        X2s = Xs if X2 is None else self.slice_x(X2)
        return self._K(Xs, X2s)

    def Kdiag(self, X):
        return self._Kdiag(self.slice_x(X))

    def __call__(self, X, X2=None, *, diag=False):
        if diag:
            if X2 is not None:
                raise ValueError("diag=True requires X2=None")
            return self.Kdiag(X)
        return self.K(X, X2)

    def slice_x(self, X):
        ad = self.active_dims
        if ad is None:
            return X
        if ad[0] == "slice":
            return X[..., ad[1]: ad[2]]
        idx = torch.as_tensor(ad[1:], device=X.device)
        return torch.index_select(X, -1, idx)

    def __add__(self, other):
        return Sum(terms=_flatten_terms(Sum, (self, other)))

    def __mul__(self, other):
        return Product(terms=_flatten_terms(Product, (self, other)))

    def _K(self, X, X2):
        raise NotImplementedError

    def _Kdiag(self, X):
        raise NotImplementedError


def _flatten_terms(cls, kernels):
    out = []
    for k in kernels:
        if isinstance(k, cls) and k.active_dims is None:
            out.extend(k.terms)
        else:
            out.append(k)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sum(Kernel):
    """k(x,x') = Σ_i k_i(x,x')."""

    terms: tuple
    active_dims: ActiveDims = None

    def _K(self, X, X2):
        return sum(k.K(X, X2) for k in self.terms)

    def _Kdiag(self, X):
        return sum(k.Kdiag(X) for k in self.terms)


@dataclasses.dataclass(frozen=True)
class Product(Kernel):
    """k(x,x') = Π_i k_i(x,x') (the composite feature×time kernel)."""

    terms: tuple
    active_dims: ActiveDims = None

    def _K(self, X, X2):
        out = self.terms[0].K(X, X2)
        for k in self.terms[1:]:
            out = out * k.K(X, X2)
        return out

    def _Kdiag(self, X):
        out = self.terms[0].Kdiag(X)
        for k in self.terms[1:]:
            out = out * k.Kdiag(X)
        return out


@dataclasses.dataclass(frozen=True)
class Constant(Kernel):
    """k(x,x') = σ² (gpflow.kernels.Constant); leaves [raw_variance (B,)]."""

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
        ones = torch.ones((X.shape[0], X2.shape[0]), dtype=X.dtype, device=X.device)
        return self.variance[:, None, None] * ones

    def _Kdiag(self, X):
        return self.variance[:, None] * torch.ones(X.shape[0], dtype=X.dtype, device=X.device)


@dataclasses.dataclass(frozen=True)
class White(Kernel):
    """k(x,x') = σ² δ(x,x') (gpflow.kernels.White); leaves [raw_variance
    (B,)]. As in the JAX package, `K(X, X2)` is σ²I whenever X2 has as many
    rows as X, whether or not it is X, and zero otherwise."""

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
        v = self.variance[:, None, None]
        if X.shape[0] == X2.shape[0]:
            return v * torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
        return v * torch.zeros((X.shape[0], X2.shape[0]), dtype=X.dtype, device=X.device)

    def _Kdiag(self, X):
        return self.variance[:, None] * torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
