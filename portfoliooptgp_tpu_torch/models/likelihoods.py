"""Likelihoods. Port of portfoliooptgp_tpu/models/likelihoods.py.

Gaussian is the workhorse; StudentT goes with the VGP. Parameters carry
the port's leading batch axis (B,); for one model (B = 1) they broadcast
against (N, P) arrays. Variational expectations of a non-conjugate
likelihood use 20-point Gauss–Hermite quadrature, as GPflow's default.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE
from portfoliooptgp_tpu_torch.params import as_param, positive, positive_inv

GH_POINTS = 20
LOG2PI = math.log(2.0 * math.pi)


class Likelihood:
    """Base class of the likelihoods."""


@dataclasses.dataclass(frozen=True)
class Gaussian(Likelihood):
    raw_variance: torch.Tensor  # (B,)

    @classmethod
    def create(cls, variance=1.0, *, device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
        return cls(raw_variance=positive_inv(as_param(variance, device, dtype)))

    @property
    def variance(self):
        return positive(self.raw_variance)

    def log_prob(self, f, y):
        v = self.variance
        return -0.5 * (LOG2PI + torch.log(v) + (y - f) ** 2 / v)

    def variational_expectations(self, f_mean, f_var, y):
        """E_{q(f)=N(μ,s)}[log N(y|f,σ²)], closed form."""
        v = self.variance
        return -0.5 * (LOG2PI + torch.log(v) + ((y - f_mean) ** 2 + f_var) / v)

    def predict_mean_and_var(self, f_mean, f_var):
        """f_mean/f_var (B, ...) → (mean, var + σ²_b)."""
        v = self.variance.reshape((-1,) + (1,) * (f_var.ndim - 1))
        return f_mean, f_var + v


@dataclasses.dataclass(frozen=True)
class StudentT(Likelihood):
    """Student-t with fixed degrees of freedom (GPflow's default df = 3) and
    a trainable scale."""

    _meta = ("df",)

    raw_scale: torch.Tensor  # (B,)
    df: float = 3.0

    @classmethod
    def create(cls, scale=1.0, df=3.0, *, device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
        return cls(raw_scale=positive_inv(as_param(scale, device, dtype)), df=float(df))

    @property
    def scale(self):
        return positive(self.raw_scale)

    def log_prob(self, f, y):
        df, sc = self.df, self.scale
        z = (y - f) / sc
        const = math.lgamma((df + 1.0) / 2.0) - math.lgamma(df / 2.0) - 0.5 * math.log(df * math.pi)
        return const - torch.log(sc) - (df + 1.0) / 2.0 * torch.log1p(z * z / df)

    def variational_expectations(self, f_mean, f_var, y):
        return gauss_hermite_expectation(self.log_prob, f_mean, f_var, y)

    def predict_mean_and_var(self, f_mean, f_var):
        # Var[y] = Var[f] + scale² df/(df − 2) for df > 2
        lik_var = self.scale ** 2 * self.df / (self.df - 2.0)
        return f_mean, f_var + lik_var.reshape((-1,) + (1,) * (f_var.ndim - 1))


def gauss_hermite_expectation(log_prob, f_mean, f_var, y, n_points=GH_POINTS):
    """∫ N(f|μ,s) log p(y|f) df by Gauss–Hermite quadrature (probabilists')."""
    nodes, weights = np.polynomial.hermite_e.hermegauss(n_points)
    opts = dict(dtype=f_mean.dtype, device=f_mean.device)
    nodes = torch.as_tensor(nodes, **opts)
    weights = torch.as_tensor(weights / np.sqrt(2.0 * np.pi), **opts)
    f = f_mean[..., None] + torch.sqrt(torch.clamp_min(f_var, 0.0))[..., None] * nodes
    return torch.sum(log_prob(f, y[..., None]) * weights, dim=-1)
