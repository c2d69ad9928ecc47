"""SGPR: Titsias's collapsed sparse bound (gpflow.models.SGPR parity).

Port of portfoliooptgp_tpu/models/sgpr.py. With σ² the noise, M inducing
points and N rows:

    A = Luu⁻¹ Kuf / σ,  B = I + A Aᵀ = LB LBᵀ,  c = LB⁻¹ A (Y − μ) / σ
    ELBO = −NP/2 log 2π − P Σ log diag LB − NP/2 log σ² − ‖Y − μ‖²/(2σ²)
           + ‖c‖²/2 − P/2 (Σ Kdiag(X)/σ² − ‖A‖²)

q(u) is optimal in closed form, so the model holds only kernel, likelihood,
mean function and Z. Leaves: the kernel's, the likelihood's, the mean's,
then Z (M, D).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, as_tensor
from portfoliooptgp_tpu_torch.kernels.means import Zero
from portfoliooptgp_tpu_torch.models.likelihoods import Gaussian
from portfoliooptgp_tpu_torch.models.svgp import jittered_kuu, mean_of
from portfoliooptgp_tpu_torch.ops import linalg


@dataclasses.dataclass(frozen=True)
class SGPR:
    kernel: object
    likelihood: Gaussian
    mean_function: object
    Z: torch.Tensor  # (M, D)

    @classmethod
    def create(cls, kernel, inducing_points, noise_variance=1.0, mean_function=None, *,
               device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
        return cls(kernel=kernel,
                   likelihood=Gaussian.create(noise_variance, device=device, dtype=dtype),
                   mean_function=mean_function if mean_function is not None else Zero(),
                   Z=as_tensor(inducing_points, device, dtype))


def _common(model: SGPR, X, Y, chol_fn=linalg.cholesky_guarded):
    sigma2 = model.likelihood.variance[0]
    sigma = torch.sqrt(sigma2)
    err = Y - mean_of(model.mean_function, X)
    Luu, _ = chol_fn(jittered_kuu(model.kernel, model.Z))
    Kuf = model.kernel.K(model.Z, X)[0]
    A = linalg.solve_lower(Luu, Kuf) / sigma  # (M, N)
    LB = linalg.cholesky(linalg.add_diag(A @ A.T, 1.0))
    c = linalg.solve_lower(LB, A @ err) / sigma  # (M, P)
    return sigma2, err, Luu, A, LB, c


def elbo(model: SGPR, X, Y):
    sigma2, err, Luu, A, LB, c = _common(model, X, Y)
    n, p = err.shape
    bound = -0.5 * n * p * math.log(2.0 * math.pi)
    bound = bound - p * torch.sum(torch.log(torch.diagonal(LB)))
    bound = bound - 0.5 * n * p * torch.log(sigma2)
    bound = bound - 0.5 * torch.sum(err * err) / sigma2
    bound = bound + 0.5 * torch.sum(c * c)
    trace = torch.sum(model.kernel.Kdiag(X)[0]) / sigma2 - torch.sum(A * A)
    return bound - 0.5 * p * trace


def neg_elbo(model: SGPR, X, Y):
    return -elbo(model, X, Y)


def predict_f(model: SGPR, X, Y, Xnew, full_cov: bool = False):
    """q(f(Xnew)) under the optimal collapsed q(u); Kuu through the
    `safe_cholesky` ladder, as prediction is not per-step hot."""
    sigma2, err, Luu, A, LB, c = _common(model, X, Y, chol_fn=linalg.safe_cholesky)
    Kus = model.kernel.K(model.Z, Xnew)[0]
    tmp1 = linalg.solve_lower(Luu, Kus)
    tmp2 = linalg.solve_lower(LB, tmp1)
    mean = tmp2.T @ c + mean_of(model.mean_function, Xnew)
    if full_cov:
        cov = model.kernel.K(Xnew)[0] + tmp2.T @ tmp2 - tmp1.T @ tmp1
        return mean, cov
    var = (model.kernel.Kdiag(Xnew)[0] + torch.sum(tmp2 * tmp2, dim=0)
           - torch.sum(tmp1 * tmp1, dim=0))
    var = torch.clamp_min(var, 0.0)
    return mean, var[:, None].expand(mean.shape)


def predict_y(model: SGPR, X, Y, Xnew):
    mean, var = predict_f(model, X, Y, Xnew)
    return model.likelihood.predict_mean_and_var(mean, var)
