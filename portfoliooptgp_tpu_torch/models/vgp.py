"""VGP: a whitened variational GP over the training inputs, for
non-conjugate likelihoods (gpflow.models.VGP with StudentT,
test_scripts/SVGP.py:432-437).

Port of portfoliooptgp_tpu/models/vgp.py: an SVGP whose inducing inputs
are the training inputs (M = N):

    f = μ(X) + L v,  L = chol(K(X, X) + jitter),  q(v) = N(q_mu, q_sqrt q_sqrtᵀ)
    ELBO = Σ_n E_q[log p(y_n | f_n)] − KL(q(v) ‖ N(0, I))

Leaves: the kernel's, the likelihood's, the mean's, then q_mu (N, P),
q_sqrt (P, N, N).
"""

from __future__ import annotations

import dataclasses

import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, resolve_device
from portfoliooptgp_tpu_torch.kernels.means import Zero
from portfoliooptgp_tpu_torch.models.likelihoods import StudentT
from portfoliooptgp_tpu_torch.models.svgp import INDUCING_JITTER, mean_of
from portfoliooptgp_tpu_torch.ops import linalg


@dataclasses.dataclass(frozen=True)
class VGP:
    _meta = ("num_latent",)

    kernel: object
    likelihood: object
    mean_function: object
    q_mu: torch.Tensor  # (N, P)
    q_sqrt: torch.Tensor  # (P, N, N) lower-triangular
    num_latent: int = 1

    @classmethod
    def create(cls, num_data, kernel, likelihood=None, mean_function=None, num_latent=1, *,
               device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
        n = int(num_data)
        if likelihood is None:
            likelihood = StudentT.create(device=device, dtype=dtype)
        dev = resolve_device(device)
        eye = torch.eye(n, dtype=dtype, device=dev)
        return cls(kernel=kernel, likelihood=likelihood,
                   mean_function=mean_function if mean_function is not None else Zero(),
                   q_mu=torch.zeros((n, num_latent), dtype=dtype, device=dev),
                   q_sqrt=eye.expand(num_latent, n, n).clone(), num_latent=num_latent)


def _whitened_marginals(model: VGP, X):
    """Mean and variance of q(f(X)) at the training inputs: f = μ + L v."""
    L = linalg.cholesky(linalg.add_diag(model.kernel.K(X)[0], INDUCING_JITTER))
    LS = torch.tril(model.q_sqrt)
    mean = L @ model.q_mu + mean_of(model.mean_function, X)
    LLs = torch.einsum("nk,pkm->pnm", L, LS)
    return L, mean, torch.sum(LLs * LLs, dim=-1).T  # var (N, P)


def prior_kl(model: VGP):
    LS = torch.tril(model.q_sqrt)
    m = model.q_mu
    n, p = m.shape[0], model.q_sqrt.shape[0]
    trace = torch.sum(LS * LS)
    quad = torch.sum(m * m)
    logdet = 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(LS, dim1=-2, dim2=-1))))
    return 0.5 * (trace + quad - n * p - logdet)


def elbo(model: VGP, X, Y):
    _, mean, var = _whitened_marginals(model, X)
    return torch.sum(model.likelihood.variational_expectations(mean, var, Y)) - prior_kl(model)


def neg_elbo(model: VGP, X, Y):
    return -elbo(model, X, Y)


def predict_f(model: VGP, X, Xnew, full_cov: bool = False):
    """q(f(Xnew)) by the whitened conditional, A = L⁻¹ K(X, Xnew):
    mean Aᵀ q_mu + μ, variance K(Xnew) − AᵀA + Aᵀ S A."""
    L = linalg.cholesky(linalg.add_diag(model.kernel.K(X)[0], INDUCING_JITTER))
    A = linalg.solve_lower(L, model.kernel.K(X, Xnew)[0])
    mean = A.T @ model.q_mu + mean_of(model.mean_function, Xnew)
    SA = torch.einsum("pnk,ns->pks", torch.tril(model.q_sqrt), A)
    if full_cov:
        cov = (model.kernel.K(Xnew)[0][None] - (A.T @ A)[None]
               + torch.einsum("pks,pkt->pst", SA, SA))
        return mean, cov
    var = (model.kernel.Kdiag(Xnew)[0][None, :] - torch.sum(A * A, dim=0)[None, :]
           + torch.sum(SA * SA, dim=1))
    return mean, torch.clamp_min(var, 0.0).T


def predict_y(model: VGP, X, Xnew):
    mean, var = predict_f(model, X, Xnew)
    return model.likelihood.predict_mean_and_var(mean, var)
