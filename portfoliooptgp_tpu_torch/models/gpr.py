"""Exact Gaussian-process regression, batched over models.

Port of portfoliooptgp_tpu/models/gpr.py. A `GPR` holds a kernel, a
Gaussian likelihood and a mean function, each with a leading batch axis
of B models; the functions below return one value per model (B,) — the
JAX package's `jax.vmap` over stacked restarts is that axis.

    L = chol(K(X,X) + σ² I)
    log p(Y|X,θ) = -½ Σ_p ‖L⁻¹(Y_p-μ)‖² - P Σ log diag(L) - NP/2 log 2π

`batched_neg_log_marginal_likelihood` routes by kernel structure and N
exactly as the JAX router does (`nll_tier` names the same tiers). On a
GPU the fused tiers launch the CUDA kernel of ops/stationary_nll.py, the
'pallas_dense' tier the dense kernel of ops/nll.py, the 'blocked' tier
the panel kernel of ops/blocked_nll.py and the 'blocked_hinv' tier the
triangular-inverse kernel of ops/nll.py.

A mean function returns (N, 1) (`Zero`) or (B, N, 1); `_err` brings the
residual Y − μ(X) to (B, N, P) either way.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
from typing import NamedTuple, Optional

import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, resolve_device
from portfoliooptgp_tpu_torch.kernels.base import Kernel, Product, Sum
from portfoliooptgp_tpu_torch.kernels.means import MeanFunction, Zero
from portfoliooptgp_tpu_torch.models.likelihoods import Gaussian
from portfoliooptgp_tpu_torch.ops import blocked_nll as blocked_mod
from portfoliooptgp_tpu_torch.ops import linalg
from portfoliooptgp_tpu_torch.ops import nll as nll_mod
from portfoliooptgp_tpu_torch.params import batch_size, tree_leaves, tree_to
from portfoliooptgp_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class GPR:
    """Exact GPR model: hyperparameters only; data goes to the functions."""

    kernel: Kernel
    likelihood: Gaussian
    mean_function: MeanFunction

    @classmethod
    def create(cls, kernel, noise_variance=1.0, mean_function=None):
        leaf = tree_leaves(kernel)[0]
        return cls(
            kernel=kernel,
            likelihood=Gaussian.create(noise_variance, device=leaf.device,
                                       dtype=leaf.dtype),
            mean_function=mean_function if mean_function is not None else Zero(),
        )


class GPRPosterior(NamedTuple):
    L: torch.Tensor  # chol(K + σ²I), (B, N, N)
    alpha: torch.Tensor  # (K+σ²I)⁻¹ (Y - μ(X)), (B, N, P)
    X: torch.Tensor
    err: torch.Tensor


def _noisy_kernel(model: GPR, X):
    return linalg.add_diag(model.kernel.K(X), model.likelihood.variance)


def _err(model: GPR, X, Y):
    """Y − μ(X) as (B, N, P)."""
    err = Y - model.mean_function(X)
    return err.expand(batch_size(model), *Y.shape)


def log_marginal_likelihood(model: GPR, X, Y):
    L = linalg.cholesky(_noisy_kernel(model, X))
    err = _err(model, X, Y)
    n, p = Y.shape
    quad = linalg.mahalanobis_from_chol(L, err)
    logdet = linalg.logdet_from_chol(L)
    return -0.5 * quad - 0.5 * p * logdet - 0.5 * n * p * math.log(2.0 * math.pi)


def neg_log_marginal_likelihood(model: GPR, X, Y):
    return -log_marginal_likelihood(model, X, Y)


def posterior(model: GPR, X, Y) -> GPRPosterior:
    L = linalg.cholesky(_noisy_kernel(model, X))
    err = _err(model, X, Y)
    alpha = linalg.chol_solve(L, err)
    return GPRPosterior(L=L, alpha=alpha, X=X, err=err)


def predict_f(model: GPR, X, Y, Xnew, full_cov: bool = False,
              cache: Optional[GPRPosterior] = None):
    """Posterior mean/variance of f at Xnew: (mean (B,M,P), var (B,M,P)),
    or (mean, cov (B,M,M)) with full_cov."""
    post = cache if cache is not None else posterior(model, X, Y)
    Kmn = model.kernel.K(post.X, Xnew)  # (B, N, M)
    mean = Kmn.transpose(-1, -2) @ post.alpha + model.mean_function(Xnew)
    A = linalg.solve_lower(post.L, Kmn)
    if full_cov:
        return mean, model.kernel.K(Xnew) - A.transpose(-1, -2) @ A
    var = torch.clamp_min(model.kernel.Kdiag(Xnew) - torch.sum(A * A, dim=-2), 0.0)
    return mean, var[..., None].expand(mean.shape)


def predict_y(model: GPR, X, Y, Xnew, cache: Optional[GPRPosterior] = None):
    mean, var = predict_f(model, X, Y, Xnew, full_cov=False, cache=cache)
    return model.likelihood.predict_mean_and_var(mean, var)


def neg_log_marginal_likelihood_cg(model: GPR, X, Y, generator=None, num_probes: int = 16,
                                   num_lanczos: int = 32, cg_tol: float = 1e-4,
                                   precond_rank: int = 0, *, probes=None):
    """Matrix-free NLL (1,) of one model (batch 1) for large N: the CG
    quad term and the SLQ log-det of ops/iterative.nll_cg, whose probes
    come from `generator` (a `torch.Generator`) or are given (`probes`).

    Its log-det and gradients are estimators, not values, so it stays out
    of `batched_neg_log_marginal_likelihood`'s tiers: the caller opts in,
    past the hinv window or with optimizers that average gradient noise.
    precond_rank > 0 adds the pivoted-Cholesky preconditioner and the
    exact split log-det (fewer CG iterations, a tighter estimate)."""
    from portfoliooptgp_tpu_torch.ops import iterative

    if batch_size(model) != 1:
        raise ValueError(f"the CG NLL takes one model, got a batch of {batch_size(model)}")
    return iterative.nll_cg(model.kernel.K(X)[0], _err(model, X, Y)[0],
                            model.likelihood.variance[0], generator, num_probes, num_lanczos,
                            cg_tol, precond_rank, probes=probes)[None]


# -- the fused tiers --------------------------------------------------------

class FusedSpec(NamedTuple):
    """Operands of the fused NLL paths: J atoms combined by `combine`
    ('prod'|'sum'); d2s/ls atom-major flat (Σ dims entries), vs/als per
    atom (see ops/stationary_nll.batched_nll_stationary_general)."""

    combine: str
    families: tuple
    dims: tuple
    d2s: tuple
    vs: tuple
    ls: tuple
    als: tuple


def fused_stationary_spec(stacked_model, X):
    """Eligibility + operands for the fused NLL paths, or None.

    Supported atoms: stationary kernels with a (B,) lengthscale (SE,
    Matern12/32/52, RationalQuadratic) on any active_dims slice, and ARD
    ones with (B, D) lengthscales, D ≤ 8; Periodic(SquaredExponential) on
    one column (the shared matrix is the squared distance, the ls slot
    carries the period, the als slot the base lengthscale); Linear (the
    shared matrix is the raw Gram ⟨x, x'⟩). Combinations: one atom, or a
    full-dim Sum or Product of atoms."""
    from portfoliooptgp_tpu_torch.kernels import stationary as st_kernels
    from portfoliooptgp_tpu_torch.kernels.linear import Linear
    from portfoliooptgp_tpu_torch.kernels.periodic import Periodic

    one = torch.ones((), dtype=X.dtype, device=X.device)

    def atom(t):
        fam = st_kernels.FUSED_FAMILY_OF.get(type(t))
        Xs = t.slice_x(X)
        if (isinstance(t, Periodic)
                and isinstance(t.base, st_kernels.SquaredExponential)
                and Xs.shape[1] == 1
                and t.base.raw_lengthscales.ndim == 1
                and t.raw_period.ndim == 1):
            # the exact pairwise form, not the expanded xx+yy-2xy: the kernel
            # recovers |x-x'| as √d2 inside sin(π√u), and the expansion's f32
            # cancellation (~|x|²ε) turns into O(1) gradient error through
            # the oscillating φ' at day-index inputs
            diff = Xs[:, 0][:, None] - Xs[:, 0][None, :]
            return ("periodic_se", [diff * diff], t.base.variance, [t.period],
                    t.base.lengthscales)
        if isinstance(t, Linear):
            v = t.variance
            on = torch.ones_like(v)
            return "linear", [Xs @ Xs.T], v, [on], on
        if fam is None:
            return None
        v = t.variance
        al = t.alpha if fam == "rq" else torch.ones_like(v)
        if t.raw_lengthscales.ndim == 1:
            d2 = st_kernels.scaled_squared_distance(Xs, Xs, one)
            return fam, [d2], v, [t.lengthscales], al
        if (t.raw_lengthscales.ndim == 2
                and t.raw_lengthscales.shape[1] == Xs.shape[1]
                and Xs.shape[1] <= 8):
            D = Xs.shape[1]
            ells = t.lengthscales
            d2s = [st_kernels.scaled_squared_distance(Xs[:, d:d + 1],
                                                      Xs[:, d:d + 1], one)
                   for d in range(D)]
            return fam, d2s, v, [ells[:, d] for d in range(D)], al
        return None

    kern = stacked_model.kernel
    a0 = atom(kern)
    if a0 is not None:
        atoms, combine = [a0], "prod"
    elif isinstance(kern, (Sum, Product)) and kern.active_dims is None:
        combine = "sum" if isinstance(kern, Sum) else "prod"
        atoms = []
        for t in kern.terms:
            aj = atom(t)
            if aj is None:
                return None
            atoms.append(aj)
    else:
        return None
    fams, d2_lists, vs, ell_lists, als = zip(*atoms)
    dims = tuple(len(ds) for ds in d2_lists)
    return FusedSpec(combine, tuple(fams), dims,
                     tuple(d for ds in d2_lists for d in ds), tuple(vs),
                     tuple(l for ls in ell_lists for l in ls), tuple(als))


_dispatch_logger = logging.getLogger("portfoliooptgp_tpu_torch.dispatch")

#: Record of NLL dispatch decisions (dicts with tier/N/B), one per call of
#: `batched_neg_log_marginal_likelihood` and of the walk-forward; the last 256.
DISPATCH_EVENTS: collections.deque = collections.deque(maxlen=256)


def _record_tier(tier: str, n: int, b: int) -> None:
    DISPATCH_EVENTS.append({"tier": tier, "n": int(n), "batch": int(b)})
    _dispatch_logger.info("batched NLL dispatch: tier=%s N=%d B=%d", tier, n, b)


def nll_tier(stacked_model, X, Y, fast: bool = True) -> str:
    """The tier `batched_neg_log_marginal_likelihood` takes:
    'fused_stationary' | 'fused_general_prod' | 'fused_general_sum' |
    'pallas_dense' | 'blocked' | 'blocked_hinv' | 'xla'. Metadata only."""
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st_mod

    n = X.shape[0]
    leaves = tree_leaves(stacked_model)
    b = int(leaves[0].shape[0])
    params_f32 = all(leaf.dtype == torch.float32 for leaf in leaves)
    if not (
        fast
        and X.dtype == torch.float32
        and params_f32
        and Y.shape[1] == 1
        and (st_mod.fused_nll_supported(n)
             or blocked_mod.blocked_nll_preferred(n)
             or blocked_mod.hinv_nll_preferred(n, b))
    ):
        return "xla"
    spec = fused_stationary_spec(stacked_model, X)
    if spec is not None and st_mod.fused_nll_supported(n):
        if (len(spec.families) == 1 and spec.families[0] in st_mod.FAMILIES
                and spec.dims == (1,)):
            return "fused_stationary"
        return f"fused_general_{spec.combine}"
    if nll_mod.pallas_nll_supported(n):
        return "pallas_dense"
    if blocked_mod.blocked_nll_preferred(n):
        return "blocked"
    return "blocked_hinv"


def batched_neg_log_marginal_likelihood(stacked_model, X, Y, fast: bool = True,
                                        *, device=DEFAULT_DEVICE,
                                        dtype=DEFAULT_DTYPE):
    """(B,) NLLs of a stacked batch of models sharing (X, Y), routed by
    kernel structure and N like the JAX router. Model, X and Y are moved
    to (device, dtype) first. 'xla' is the plain batched path (the JAX
    package's vmapped XLA path); every other tier runs its CUDA kernel on
    a GPU and its plain version on the CPU. The span `router.dispatch`
    covers the moves, the tier's choice and the fused tiers' operands."""
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st_mod

    with span("router.dispatch"):
        dev = resolve_device(device)
        stacked_model = tree_to(stacked_model, dev, dtype)
        X = torch.as_tensor(X).to(device=dev, dtype=dtype)
        Y = torch.as_tensor(Y).to(device=dev, dtype=dtype)
        n = X.shape[0]
        b = batch_size(stacked_model)
        tier = nll_tier(stacked_model, X, Y, fast=fast)
        _record_tier(tier, n, b)
        if tier != "xla":
            noise = stacked_model.likelihood.variance
            err = _err(stacked_model, X, Y)[:, :, 0]
        if tier.startswith("fused"):
            spec = fused_stationary_spec(stacked_model, X)
        if tier.startswith("fused_general"):
            mask = torch.ones((b, n), dtype=X.dtype, device=X.device)
    if tier == "xla":
        return neg_log_marginal_likelihood(stacked_model, X, Y)
    if tier == "pallas_dense":
        return nll_mod.batched_nll(stacked_model.kernel.K(X), err, noise)
    if tier == "blocked":
        return blocked_mod.batched_nll_blocked(stacked_model.kernel.K(X), err, noise)
    if tier == "blocked_hinv":
        return blocked_mod.batched_nll_hinv(stacked_model.kernel.K(X), err, noise)
    if tier == "fused_stationary":
        return st_mod.batched_nll_stationary(
            spec.d2s[0], err, spec.vs[0], spec.ls[0], noise, spec.families[0])
    fused = (st_mod.batched_nll_stationary_sum if tier == "fused_general_sum"
             else st_mod.batched_nll_stationary_general)
    return fused(spec.families, spec.d2s, err, spec.vs, spec.ls, spec.als,
                 noise, mask, dims=spec.dims)
