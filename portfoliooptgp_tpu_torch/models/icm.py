"""Multi-output GP regression — the intrinsic coregionalization model (ICM).

Port of portfoliooptgp_tpu/models/icm.py. With every output observed on
the same grid the covariance is B ⊗ Kx,

    cov(Y[n, i], Y[m, j]) = B[i, j] · k(x_n, x_m),   B = W Wᵀ + diag(κ),

and the NLL and the posterior reduce to eigendecompositions of Kx and B
(`decompose`), or, in the `_chol` variants, to eigh(B) and one batched
(P, N, N) Cholesky of the P shifted problems λb_i·Kx + σ²I.

`ICMGPR` is one model. Like every model of the port its leaves carry a
leading batch axis of 1: W is (1, P, rank), raw_kappa (1, P). Its leaf
order (`params.tree_leaves`, the JAX package's `jax.tree.leaves`) is the
dataclass order — the kernel's leaves, the likelihood's, then W and
raw_kappa; for the frontier pipeline's SE kernel:

    [kernel.raw_variance, kernel.raw_lengthscales,
     likelihood.raw_variance, W, raw_kappa]

`ICMGPR.create` draws W from a `torch.Generator`, which cannot repeat the
JAX package's `jax.random.normal(PRNGKey(seed))`: runs held against the
JAX package start from its W, carried by `params.from_jax_leaves`.

The `_chol` NLLs record their tier in `gpr.DISPATCH_EVENTS` as
`icm.<tier>` (N, and the batch of shifted problems: P, or C·P), and their
host work up to the tier's call (B, eigh(B), the rotation of Y, the tier,
the fused tier's d2 or the others' Kx) is the span `icm.nll`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from portfoliooptgp_tpu_torch.kernels.base import Kernel
from portfoliooptgp_tpu_torch.models.gpr import _record_tier
from portfoliooptgp_tpu_torch.models.likelihoods import Gaussian
from portfoliooptgp_tpu_torch.ops import blocked_nll as blocked_mod
from portfoliooptgp_tpu_torch.ops import linalg
from portfoliooptgp_tpu_torch.ops import nll as nll_mod
from portfoliooptgp_tpu_torch.ops import stationary_nll as st_mod
from portfoliooptgp_tpu_torch.ops.linalg import safe_eigh
from portfoliooptgp_tpu_torch.params import positive, positive_inv, tree_leaves
from portfoliooptgp_tpu_torch.utils.profiling import span

EIG_JITTER = 1e-10
LOG2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class ICMGPR:
    kernel: Kernel
    likelihood: Gaussian
    W: torch.Tensor  # (1, P, rank) coregionalization factors
    raw_kappa: torch.Tensor  # (1, P) per-output diagonal of B

    num_outputs: int = 2
    rank: int = 1
    _meta = ("num_outputs", "rank")

    @classmethod
    def create(cls, kernel, num_outputs, rank=1, noise_variance=1.0, w_scale=0.1,
               generator: Optional[torch.Generator] = None):
        """W ~ w_scale·N(0, 1) from `generator` (torch's default when None),
        κ = 1, on the kernel's device and dtype."""
        leaf = tree_leaves(kernel)[0]
        W = w_scale * torch.randn((1, num_outputs, rank), generator=generator,
                                  dtype=leaf.dtype).to(leaf.device)
        return cls(
            kernel=kernel,
            likelihood=Gaussian.create(noise_variance, device=leaf.device, dtype=leaf.dtype),
            W=W,
            raw_kappa=positive_inv(torch.ones((1, num_outputs), dtype=leaf.dtype,
                                              device=leaf.device)),
            num_outputs=int(num_outputs),
            rank=int(rank),
        )

    @property
    def B(self):
        """(P, P) coregionalization matrix W Wᵀ + diag(κ)."""
        W = self.W[0]
        return W @ W.T + torch.diag(positive(self.raw_kappa[0]))

    @property
    def noise(self):
        """σ² as a 0-d tensor."""
        return self.likelihood.variance[0]


class ICMDecomposition(NamedTuple):
    Qx: torch.Tensor
    lam_x: torch.Tensor
    Qb: torch.Tensor
    lam_b: torch.Tensor
    Ytil: torch.Tensor  # Qxᵀ Y Qb
    weights: torch.Tensor  # (N, P): λx λb + σ²


def decompose(model: ICMGPR, X, Y) -> ICMDecomposition:
    Kx = model.kernel.K(X)[0]
    # safe_eigh: B has p − rank tied eigenvalues at the uniform-κ start and
    # Kx is near rank-deficient for long lengthscales (ops/linalg.safe_eigh)
    eye = torch.eye(Kx.shape[0], dtype=Kx.dtype, device=Kx.device)
    lam_x, Qx = safe_eigh(Kx + EIG_JITTER * eye)
    lam_b, Qb = safe_eigh(model.B)
    Ytil = Qx.T @ Y @ Qb
    weights = lam_x[:, None] * lam_b[None, :] + model.noise
    return ICMDecomposition(Qx, lam_x, Qb, lam_b, Ytil, weights)


def neg_log_marginal_likelihood(model: ICMGPR, X, Y):
    dec = decompose(model, X, Y)
    n, p = Y.shape
    quad = torch.sum(dec.Ytil ** 2 / dec.weights)
    logdet = torch.sum(torch.log(dec.weights))
    return 0.5 * quad + 0.5 * logdet + 0.5 * n * p * LOG2PI


def _plain_nll(Kb, err, noise):
    """(P,) NLLs of the shifted problems by a batched Cholesky (NaN on failure)."""
    n = Kb.shape[-1]
    L = linalg.cholesky(linalg.add_diag(Kb, noise))
    a = linalg.solve_lower(L, err[..., None])[..., 0]
    return (0.5 * torch.sum(a * a, dim=-1)
            + torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
            + 0.5 * n * LOG2PI)


def nll_chol_tier(model: ICMGPR, X, Y) -> str:
    """The branch `neg_log_marginal_likelihood_chol` takes: 'fused' |
    'dense' | 'blocked' | 'hinv' | 'plain', in the JAX package's order. The
    kernel tiers need float32 end to end (float64 is the CPU parity mode)."""
    from portfoliooptgp_tpu_torch.kernels import stationary as st_kernels

    n, p = Y.shape
    f32 = X.dtype == torch.float32 and all(
        leaf.dtype == torch.float32 for leaf in tree_leaves(model))
    if not f32:
        return "plain"
    # rq is left out as in the JAX package: the single-family kernel has no α slot
    fam = st_kernels.FUSED_FAMILY_OF.get(type(model.kernel))
    if (fam not in (None, "rq") and model.kernel.raw_lengthscales.ndim == 1
            and st_mod.fused_nll_supported(n)):
        return "fused"
    if nll_mod.pallas_nll_supported(n):
        return "dense"
    if blocked_mod.blocked_nll_preferred(n):
        return "blocked"
    if blocked_mod.hinv_nll_preferred(n, p):
        return "hinv"
    return "plain"


def neg_log_marginal_likelihood_chol(model: ICMGPR, X, Y):
    """The NLL without eigh(Kx): with B = E Λb Eᵀ the Gram block-diagonalizes
    over B's eigenbasis into P shifted GPR problems sharing one kernel,

        NLL = Σ_i ½ ỹ_iᵀ (λb_i Kx + σ²I)⁻¹ ỹ_i + ½ log|λb_i Kx + σ²I|
              + NP/2 log 2π,   Ỹ = Y E,

    routed like the JAX package: a bare isotropic stationary kernel in
    float32 at padded N ≤ 512 is one fused-kernel batch (variance λb_i·σ²_k);
    otherwise Kx is built once and the (P, N, N) batch goes to the dense
    tier (padded N ≤ 256, the dense kernel of ops/nll.py), the blocked tier,
    the hinv tier, or the plain batched Cholesky (`nll_chol_tier`)."""
    from portfoliooptgp_tpu_torch.kernels import stationary as st_kernels

    n, p = Y.shape
    with span("icm.nll"):
        lam_b, E = safe_eigh(model.B)
        err = (Y @ E).T  # (P, N): per-output residuals in B's eigenbasis
        noise = model.likelihood.variance.expand(p)
        tier = nll_chol_tier(model, X, Y)
        _record_tier("icm." + tier, n, p)
        if tier == "fused":
            Xs = model.kernel.slice_x(X)
            d2 = st_kernels.scaled_squared_distance(
                Xs, Xs, torch.ones((), dtype=Xs.dtype, device=Xs.device))
            v = lam_b * model.kernel.variance
            ell = model.kernel.lengthscales.expand(p)
            fam = st_kernels.FUSED_FAMILY_OF[type(model.kernel)]
        else:
            Kx = model.kernel.K(X)[0]  # built once, shared by all P outputs
            Kb = lam_b[:, None, None] * Kx[None]
            fn = {"dense": nll_mod.batched_nll, "blocked": blocked_mod.batched_nll_blocked,
                  "hinv": blocked_mod.batched_nll_hinv, "plain": _plain_nll}[tier]
    if tier == "fused":
        return torch.sum(st_mod.batched_nll_stationary(d2, err, v, ell, noise, fam))
    return torch.sum(fn(Kb, err, noise))


def batched_neg_log_marginal_likelihood_chol(stacked, X, Y):
    """(C,) `neg_log_marginal_likelihood_chol` of C stacked ICM models (leaves
    with a leading axis of C: W (C, P, rank), raw_kappa (C, P), ...), what
    the JAX package's chain vmap of that function computes. One batched
    safe_eigh of the C matrices B; then one call over the C·P shifted
    problems: a fused-kernel batch of C·P models on the fused tier, else one
    (C·P, N, N) batch to the dense, blocked, hinv or plain tier. The tier is
    chosen from (N, P) as for one model (`nll_chol_tier`): the JAX package
    decides it per chain."""
    from portfoliooptgp_tpu_torch.kernels import stationary as st_kernels

    n, p = Y.shape
    c = stacked.W.shape[0]
    with span("icm.nll"):
        W = stacked.W
        B = W @ W.transpose(-1, -2) + torch.diag_embed(positive(stacked.raw_kappa))
        lam_b, E = safe_eigh(B)  # (C, P), (C, P, P)
        err = (Y @ E).transpose(-1, -2).reshape(c * p, n)  # per chain, per eigenpair
        noise = stacked.likelihood.variance[:, None].expand(c, p).reshape(-1)
        tier = nll_chol_tier(stacked, X, Y)
        _record_tier("icm." + tier, n, c * p)
        if tier == "fused":
            Xs = stacked.kernel.slice_x(X)
            d2 = st_kernels.scaled_squared_distance(
                Xs, Xs, torch.ones((), dtype=Xs.dtype, device=Xs.device))
            v = (lam_b * stacked.kernel.variance[:, None]).reshape(-1)
            ell = stacked.kernel.lengthscales[:, None].expand(c, p).reshape(-1)
            fam = st_kernels.FUSED_FAMILY_OF[type(stacked.kernel)]
        else:
            Kx = stacked.kernel.K(X)  # (C, N, N), one per chain, shared by its P outputs
            Kb = (lam_b[:, :, None, None] * Kx[:, None]).reshape(c * p, n, n)
            fn = {"dense": nll_mod.batched_nll, "blocked": blocked_mod.batched_nll_blocked,
                  "hinv": blocked_mod.batched_nll_hinv, "plain": _plain_nll}[tier]
    if tier == "fused":
        losses = st_mod.batched_nll_stationary(d2, err, v, ell, noise, fam)
    else:
        losses = fn(Kb, err, noise)
    return torch.sum(losses.reshape(c, p), dim=-1)


def predict_f(model: ICMGPR, X, Y, Xnew):
    """Posterior mean (M, P) and per-output marginal variance (M, P) of the
    latent multi-output process at Xnew."""
    dec = decompose(model, X, Y)
    B = model.B
    Ks = model.kernel.K(X, Xnew)[0]  # (N, M)
    # mean: K*ₓ Ā B with Ā = Qx (Ỹ/W) Qbᵀ
    Abar = dec.Qx @ (dec.Ytil / dec.weights) @ dec.Qb.T  # (N, P)
    mean = Ks.T @ Abar @ B
    # var of output j at x*: B_jj k(x*,x*) − Σ_{n,i} (u_ij v_n*)² / W_ni,
    # u = Qbᵀ B[:, j], v = Qxᵀ k*
    V = dec.Qx.T @ Ks  # (N, M)
    U = dec.Qb.T @ B  # (P_eig, P_out)
    quad = torch.einsum("nm,ni,ij->mj", V ** 2, 1.0 / dec.weights, U ** 2)
    kdiag = model.kernel.Kdiag(Xnew)[0]  # (M,)
    var = torch.diagonal(B)[None, :] * kdiag[:, None] - quad
    return mean, torch.clamp_min(var, 0.0)


def predict_y(model: ICMGPR, X, Y, Xnew):
    mean, var = predict_f(model, X, Y, Xnew)
    return model.likelihood.predict_mean_and_var(mean, var)


def posterior_asset_moments(model: ICMGPR, X, Y, Xnew):
    """(μ (P,), Σ (P, P)) of the posterior predictive across outputs at the
    last row of Xnew, cross-asset covariance included."""
    dec = decompose(model, X, Y)
    B = model.B
    kstar = model.kernel.K(X, Xnew[-1:])[0]  # (N, 1)
    Abar = dec.Qx @ (dec.Ytil / dec.weights) @ dec.Qb.T
    mu = (kstar.T @ Abar @ B)[0]
    v = dec.Qx.T @ kstar  # (N, 1)
    U = dec.Qb.T @ B
    # cov[j, k] = B_jk k** − Σ_{n,i} v_n² u_ij u_ik / W_ni
    s = torch.einsum("ni,ij,ik->jk", (v ** 2) / dec.weights, U, U)
    kss = model.kernel.Kdiag(Xnew[-1:])[0, 0]
    eye = torch.eye(B.shape[0], dtype=B.dtype, device=B.device)
    return mu, B * kss - s + model.noise * eye


def posterior_asset_moments_chol(model: ICMGPR, X, Y, Xnew):
    """`posterior_asset_moments` without eigh(Kx): in B's eigenbasis each
    eigenpair i needs (λb_i Kx + σ²I)⁻¹ applied to [ỹ_i | k*], one batched
    (P, N, N) Cholesky (NaN on failure) with two right-hand sides."""
    n, p = Y.shape
    lam_b, E = safe_eigh(model.B)
    B = model.B
    Kx = model.kernel.K(X)[0]
    kstar = model.kernel.K(X, Xnew[-1:])[0]  # (N, 1)
    L = linalg.cholesky(linalg.add_diag(lam_b[:, None, None] * Kx[None], model.noise))
    rhs = torch.cat([(Y @ E).T[:, :, None], kstar.expand(p, n, 1)], dim=2)  # [ỹ_i | k*]
    sol = linalg.chol_solve(L, rhs)
    a = sol[:, :, 0]  # a_i = (λb_i Kx + σ²I)⁻¹ ỹ_i
    c = torch.einsum("n,pn->p", kstar[:, 0], sol[:, :, 1])
    # Ā = [a_1 … a_P] Eᵀ; mean = k*ᵀ Ā B
    mu = (kstar[:, 0] @ (a.T @ E.T)) @ B
    U = E.T @ B
    s = torch.einsum("i,ij,ik->jk", c, U, U)
    kss = model.kernel.Kdiag(Xnew[-1:])[0, 0]
    return mu, B * kss - s + model.noise * torch.eye(p, dtype=B.dtype, device=B.device)
