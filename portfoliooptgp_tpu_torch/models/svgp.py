"""Sparse variational GP (SVGP) with whitened inducing variables.

Port of portfoliooptgp_tpu/models/svgp.py (gpflow.models.SVGP as the
reference's sparse experiments use it, test_scripts/SVGP.py:459-533):

    u = Luu v,  q(v) = N(q_mu, q_sqrt q_sqrtᵀ),  Kuu = k(Z, Z) + jitter·I
    f(x) | v  has mean A(x)ᵀ q_mu, cov K(x,x) − AᵀA + Aᵀ S A,  A = Luu⁻¹ K(Z,x)
    ELBO = (N/B) Σ_batch E_q[log p(y|f)] − KL(q(v) ‖ N(0, I))

An SVGP is one model: its kernel and likelihood keep the port's leading
batch axis of 1, while Z (M, D), q_mu (M, P) and q_sqrt (P, M, M) keep the
JAX package's shapes. Leaves, in `jax.tree.leaves` order: the kernel's,
the likelihood's, the mean function's, then Z, q_mu, q_sqrt.

For a Gaussian likelihood the batch enters the ELBO only through the
weighted Gram G = Kuf diag(w) Kufᵀ, Σ w (y − mean)², Σ w Kdiag and Σ w
(`gaussian_elbo_gram`). `gaussian_elbo_gram_fused` takes its M-phase on
`linalg.cholesky_inverse_pair`, and its batch phase either in torch
(`gram_partials`, the default and the trainer's route) or, with
`use_pallas=True` on an eligible model, through the hand-written kernels of
`ops/svgp_gram.py` (`gram_partials_fused`). The eligibility rule is the
JAX package's, thresholds included.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, as_tensor
from portfoliooptgp_tpu_torch.kernels.means import ConstantMean, Zero
from portfoliooptgp_tpu_torch.kernels.stationary import (
    Matern12,
    Matern32,
    Matern52,
    SquaredExponential,
)
from portfoliooptgp_tpu_torch.models.likelihoods import Gaussian
from portfoliooptgp_tpu_torch.ops import linalg, svgp_gram

INDUCING_JITTER = 1e-6  # GPflow's default_jitter on Kuu (float64)


def inducing_jitter(dtype):
    """float32 needs a larger jitter for a stable Kuu factor."""
    return 1e-4 if dtype == torch.float32 else INDUCING_JITTER


def jittered_kuu(kernel, Z):
    """Kuu = k(Z, Z) + jitter·I: 1e-6 in float64 (GPflow's), and in float32
    1e-3 of the mean prior variance plus 1e-12 (at M = 128 on a 44-year
    daily grid a float32 factor at 1e-4 fails)."""
    Kuu = kernel.K(Z)[0]
    if Z.dtype == torch.float32:
        scale = torch.mean(torch.diagonal(Kuu))
        return linalg.add_diag(Kuu, 1e-3 * scale + 1e-12)
    return linalg.add_diag(Kuu, INDUCING_JITTER)


@dataclasses.dataclass(frozen=True)
class SVGP:
    _meta = ("num_latent",)

    kernel: object
    likelihood: object
    mean_function: object
    Z: torch.Tensor  # (M, D) inducing inputs
    q_mu: torch.Tensor  # (M, P)
    q_sqrt: torch.Tensor  # (P, M, M), lower-triangular factor of q(v)'s covariance
    num_latent: int = 1

    @classmethod
    def create(cls, kernel, inducing_points, likelihood=None, mean_function=None,
               num_latent=1, *, device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
        Z = as_tensor(inducing_points, device, dtype)
        m = Z.shape[0]
        eye = torch.eye(m, dtype=dtype, device=Z.device)
        return cls(
            kernel=kernel,
            likelihood=(likelihood if likelihood is not None
                        else Gaussian.create(1.0, device=device, dtype=dtype)),
            mean_function=mean_function if mean_function is not None else Zero(),
            Z=Z,
            q_mu=torch.zeros((m, num_latent), dtype=dtype, device=Z.device),
            q_sqrt=eye.expand(num_latent, m, m).clone(),
            num_latent=num_latent,
        )

    @property
    def num_inducing(self):
        return self.Z.shape[0]


def mean_of(mean_function, X):
    """μ(X) as (N, 1) for one model (the port's means carry a batch axis)."""
    mu = mean_function(X)
    return mu[0] if mu.ndim == 3 else mu


def prior_kl(model: SVGP):
    """KL(q(v) ‖ N(0, I)) for whitened v, summed over latents:
    ½ Σ_p [tr(S_p) + ‖m_p‖² − M − log|S_p|]."""
    L = torch.tril(model.q_sqrt)
    m = model.q_mu
    trace = torch.sum(L * L)
    quad = torch.sum(m * m)
    logdet = 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(L, dim1=-2, dim2=-1))))
    P = model.q_sqrt.shape[0]
    return 0.5 * (trace + quad - model.num_inducing * P - logdet)


def _predict_f(model: SVGP, Xnew, full_cov, chol_fn):
    Kuu = jittered_kuu(model.kernel, model.Z)
    Luu, _ = chol_fn(Kuu)
    Kuf = model.kernel.K(model.Z, Xnew)[0]  # (M, N)
    A = linalg.solve_lower(Luu, Kuf)
    mean = A.T @ model.q_mu + mean_of(model.mean_function, Xnew)
    LS = torch.tril(model.q_sqrt)  # (P, M, M)
    SA = torch.einsum("pkm,kn->pmn", LS, A)  # Lᵀ A per latent
    if full_cov:
        Kff = model.kernel.K(Xnew)[0]
        cov = Kff[None] - (A.T @ A)[None] + torch.einsum("pmn,pmo->pno", SA, SA)
        return mean, cov
    Kdiag = model.kernel.Kdiag(Xnew)[0]
    var = Kdiag[None, :] - torch.sum(A * A, dim=0)[None, :] + torch.sum(SA * SA, dim=1)
    return mean, torch.clamp_min(var, 0.0).T  # (N, P)


def predict_f(model: SVGP, Xnew, full_cov: bool = False):
    """q(f(Xnew)) under the whitened posterior; Kuu through the
    `safe_cholesky` jitter ladder (prediction runs once per horizon)."""
    return _predict_f(model, Xnew, full_cov, linalg.safe_cholesky)


def predict_f_guarded(model: SVGP, Xnew, full_cov: bool = False):
    """The ELBO's posterior: one guarded factorization; a failure makes the
    loss NaN with zero gradients instead of running the ladder every step."""
    return _predict_f(model, Xnew, full_cov, linalg.cholesky_guarded)


def predict_y(model: SVGP, Xnew):
    mean, var = predict_f(model, Xnew)
    return model.likelihood.predict_mean_and_var(mean, var)


def elbo(model: SVGP, X, Y, num_data: Optional[int] = None):
    """Minibatch evidence lower bound; `num_data` rescales the likelihood
    term when (X, Y) is a minibatch."""
    mean, var = predict_f_guarded(model, X)
    ve = model.likelihood.variational_expectations(mean, var, Y)
    scale = 1.0 if num_data is None else num_data / X.shape[0]
    return torch.sum(ve) * scale - prior_kl(model)


def neg_elbo(model: SVGP, X, Y, num_data: Optional[int] = None):
    return -elbo(model, X, Y, num_data)


# -- the Gram form of the Gaussian ELBO --------------------------------------

def gaussian_elbo_gram(model: SVGP, X, Y, weights=None, num_data: Optional[int] = None):
    """The Gaussian-likelihood ELBO from the batch's Gram reductions:
    Σ_b w‖A_b‖² = tr(C) and Σ_b w‖SA_b‖² = Σ_p ⟨C, L_p L_pᵀ⟩ with
    C = Luu⁻¹ G Luu⁻ᵀ, so no M×B solve is needed. Equal to `elbo` up to
    rounding. `weights` (B,): 0 for padding rows."""
    Luu = gram_chol(model)
    return gram_finish(model, Luu, gram_partials(model, Luu, X, Y, weights), num_data)


_FAMILY_OF = ((SquaredExponential, "se"), (Matern12, "matern12"), (Matern32, "matern32"),
              (Matern52, "matern52"))


def _gram_family(kernel) -> Optional[str]:
    """The gram kernels' φ family of a bare stationary kernel, or None
    (composites, active_dims, RationalQuadratic, periodic)."""
    if getattr(kernel, "active_dims", None) is not None:
        return None
    for cls, fam in _FAMILY_OF:
        if type(kernel) is cls:
            return fam
    return None


def svgp_gram_fused_supported(model: SVGP, X) -> bool:
    """The JAX package's rule for the fused gram kernels: a bare stationary
    kernel, Gaussian likelihood, Zero or Constant mean, P = 1, float32,
    M % 8 == 0, D ≤ 128 and B ≤ 8192."""
    return (
        _gram_family(model.kernel) is not None
        and isinstance(model.likelihood, Gaussian)
        and isinstance(model.mean_function, (Zero, ConstantMean))
        and model.q_sqrt.shape[0] == 1
        and model.Z.shape[0] % 8 == 0
        and model.Z.shape[1] <= svgp_gram.LANES
        and X.shape[0] <= svgp_gram.MAX_FUSED_B
        and X.dtype == torch.float32
        and model.Z.dtype == torch.float32
    )


def gram_partials_fused(model: SVGP, Luu, X, Y, weights=None, t=None):
    """`gram_partials` through the gram kernels (same additive tuple);
    t = Luu⁻ᵀ q_mu (M,) may be given."""
    family = _gram_family(model.kernel)
    if t is None:
        t = linalg.solve_upper_t(Luu, model.q_mu)[:, 0]
    y_eff = (Y - mean_of(model.mean_function, X))[:, 0]
    B = X.shape[0]
    w = torch.ones((B,), dtype=X.dtype, device=X.device) if weights is None else weights
    v = model.kernel.variance
    ell = model.kernel.lengthscales
    s = 1.0 / (ell * ell)
    G, sq_err = svgp_gram.gram_reduce(model.Z, X, y_eff, w, t, v, s, family)
    W = torch.sum(w)
    kdiag_w = v[0] * W  # stationary families: Kdiag ≡ variance
    return G, sq_err, kdiag_w, W


def gaussian_elbo_gram_fused(model: SVGP, X, Y, weights=None, num_data: Optional[int] = None,
                             use_pallas: bool = False):
    """The fast Gaussian ELBO: Gram accumulation with the M-phase on
    `linalg.cholesky_inverse_pair` (one factorization whose explicit inverse
    makes every backward term a matmul). The batch phase is torch's
    (`gram_partials`) unless `use_pallas` is set and the model is eligible
    (`svgp_gram_fused_supported`), when the gram kernels run it. Same value
    and gradients as `gaussian_elbo_gram` either way."""
    Kuu = jittered_kuu(model.kernel, model.Z)
    Luu, Winv = linalg.cholesky_inverse_pair(Kuu)
    if use_pallas and svgp_gram_fused_supported(model, X):
        t = (Winv.T @ model.q_mu)[:, 0]
        partials = gram_partials_fused(model, Luu, X, Y, weights, t=t)
    else:
        partials = gram_partials(model, Luu, X, Y, weights, t=Winv.T @ model.q_mu)
    G, sq_err, kdiag_w, Wsum = partials
    C = (Winv @ G) @ Winv.T
    return _gram_tail(model, C, sq_err, kdiag_w, Wsum, num_data)


def gram_chol(model: SVGP):
    """Luu of the Gram path (one guarded factorization)."""
    Luu, _ = linalg.cholesky_guarded(jittered_kuu(model.kernel, model.Z))
    return Luu


def gram_partials(model: SVGP, Luu, X, Y, weights=None, t=None):
    """(G, sq_err, kdiag_w, W) of a batch, each additive across row shards.
    Kuf comes from `kernel.K`, as in the JAX package. t (= Luu⁻ᵀ q_mu,
    (M, P)) may be given."""
    Kuf = model.kernel.K(model.Z, X)[0]  # (M, B)
    B = X.shape[0]
    w = torch.ones((B,), dtype=Kuf.dtype, device=Kuf.device) if weights is None else weights
    G = (Kuf * w[None, :]) @ Kuf.T
    if t is None:
        t = linalg.solve_upper_t(Luu, model.q_mu)
    mean = Kuf.T @ t + mean_of(model.mean_function, X)
    err = Y - mean
    sq_err = torch.sum(err * err * w[:, None])
    kdiag_w = torch.sum(model.kernel.Kdiag(X)[0] * w)
    return G, sq_err, kdiag_w, torch.sum(w)


def _gram_tail(model: SVGP, C, sq_err, kdiag_w, W, num_data):
    """The ELBO from C = Luu⁻¹ G Luu⁻ᵀ and the scalar partials."""
    sigma2 = model.likelihood.variance[0]
    LS = torch.tril(model.q_sqrt)
    CL = torch.einsum("mn,pnk->pmk", C, LS)
    P = model.q_sqrt.shape[0]
    sum_var = P * (kdiag_w - torch.trace(C)) + torch.sum(CL * LS)
    ve_sum = -0.5 * W * P * torch.log(2.0 * math.pi * sigma2) - 0.5 * (sq_err + sum_var) / sigma2
    scale = 1.0 if num_data is None else num_data / torch.clamp_min(W, 1.0)
    return ve_sum * scale - prior_kl(model)


def gram_finish(model: SVGP, Luu, partials, num_data: Optional[int] = None):
    """The Gaussian ELBO from (summed) Gram partials: M×M work only."""
    G, sq_err, kdiag_w, W = partials
    HG = linalg.solve_lower(Luu, G)
    C = linalg.solve_lower(Luu, HG.T)
    return _gram_tail(model, C, sq_err, kdiag_w, W, num_data)
