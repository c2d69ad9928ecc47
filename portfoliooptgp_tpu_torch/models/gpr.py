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
from portfoliooptgp_tpu_torch.kernels import stationary as st_kernels
from portfoliooptgp_tpu_torch.kernels.base import Kernel, Product, Sum
from portfoliooptgp_tpu_torch.kernels.linear import Linear
from portfoliooptgp_tpu_torch.kernels.means import MeanFunction, Zero
from portfoliooptgp_tpu_torch.kernels.periodic import Periodic
from portfoliooptgp_tpu_torch.models.likelihoods import Gaussian
from portfoliooptgp_tpu_torch.ops import blocked_nll as blocked_mod
from portfoliooptgp_tpu_torch.ops import linalg
from portfoliooptgp_tpu_torch.ops import nll as nll_mod
from portfoliooptgp_tpu_torch.ops import stationary_nll as st_mod
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
    atom (see ops/stationary_nll.batched_nll_stationary_general); d2_stack
    the d2s stacked (Σ dims, N, N), as the kernel takes them."""

    combine: str
    families: tuple
    dims: tuple
    d2s: tuple
    vs: tuple
    ls: tuple
    als: tuple
    d2_stack: torch.Tensor


class FusedStructure(NamedTuple):
    """What the fused paths' shared matrices depend on besides X, read
    from the kernel alone: `combine`, `families`, `dims` as in `FusedSpec`,
    and per atom (form, active_dims), form 'iso' | 'ard' | 'periodic' |
    'linear'. Equal structures on one X have equal operands."""

    combine: str
    families: tuple
    dims: tuple
    atoms: tuple


@dataclasses.dataclass(frozen=True, eq=False)
class FusedOperands:
    """The fused paths' tensors that depend on X alone: the atom-major
    (N, N) d2s, their stack, the structure they were built for (`key`),
    and all-ones (B, N) masks of the unmasked tiers, kept by B."""

    key: FusedStructure
    d2s: tuple
    d2_stack: torch.Tensor
    ones: dict = dataclasses.field(default_factory=dict)

    def ones_mask(self, b: int):
        mask = self.ones.get(b)
        if mask is None:
            s = self.d2_stack
            mask = self.ones[b] = torch.ones((b, s.shape[-1]), dtype=s.dtype, device=s.device)
        return mask


def _terms(kern):
    return kern.terms if isinstance(kern, (Sum, Product)) else (kern,)


def _atom_structure(t, d):
    """(family, form, dims) of the fused atom t on d input columns, or None."""
    ad = t.active_dims
    cols = (d if ad is None else len(range(d)[ad[1]:ad[2]]) if ad[0] == "slice"
            else len(ad) - 1)
    if (isinstance(t, Periodic)
            and isinstance(t.base, st_kernels.SquaredExponential)
            and cols == 1
            and t.base.raw_lengthscales.ndim == 1
            and t.raw_period.ndim == 1):
        return "periodic_se", "periodic", 1
    if isinstance(t, Linear):
        return "linear", "linear", 1
    fam = st_kernels.FUSED_FAMILY_OF.get(type(t))
    if fam is None:
        return None
    if t.raw_lengthscales.ndim == 1:
        return fam, "iso", 1
    if (t.raw_lengthscales.ndim == 2 and t.raw_lengthscales.shape[1] == cols
            and cols <= 8):
        return fam, "ard", cols
    return None


def fused_structure(kernel, d: int) -> Optional[FusedStructure]:
    """Eligibility for the fused NLL paths of `kernel` on inputs of d
    columns, from the kernel alone (no tensor is built), or None.

    Supported atoms: stationary kernels with a (B,) lengthscale (SE,
    Matern12/32/52, RationalQuadratic) on any active_dims slice, and ARD
    ones with (B, D) lengthscales, D ≤ 8; Periodic(SquaredExponential) on
    one column; Linear. Combinations: one atom, or a full-dim Sum or
    Product of atoms."""
    a0 = _atom_structure(kernel, d)
    if a0 is not None:
        atoms, combine = [(kernel, a0)], "prod"
    elif isinstance(kernel, (Sum, Product)) and kernel.active_dims is None:
        combine = "sum" if isinstance(kernel, Sum) else "prod"
        atoms = [(t, _atom_structure(t, d)) for t in kernel.terms]
        if any(a is None for _, a in atoms):
            return None
    else:
        return None
    return FusedStructure(combine, tuple(a[0] for _, a in atoms),
                          tuple(a[2] for _, a in atoms),
                          tuple((a[1], t.active_dims) for t, a in atoms))


def _build_operands(kern, X, structure) -> FusedOperands:
    """The shared matrices of `structure`'s atoms on X: the span
    `router.operands`."""
    with span("router.operands"):
        one = torch.ones((), dtype=X.dtype, device=X.device)
        d2s = []
        for t, (form, _) in zip(_terms(kern), structure.atoms):
            Xs = t.slice_x(X)
            if form == "periodic":
                # the exact pairwise form, not the expanded xx+yy-2xy: the
                # kernel recovers |x-x'| as √d2 inside sin(π√u), and the
                # expansion's f32 cancellation (~|x|²ε) turns into O(1)
                # gradient error through the oscillating φ' at day-index inputs
                diff = Xs[:, 0][:, None] - Xs[:, 0][None, :]
                d2s.append(diff * diff)
            elif form == "linear":
                d2s.append(Xs @ Xs.T)  # the raw Gram ⟨x, x'⟩
            elif form == "iso":
                d2s.append(st_kernels.scaled_squared_distance(Xs, Xs, one))
            else:
                d2s.extend(st_kernels.scaled_squared_distance(Xs[:, d:d + 1],
                                                              Xs[:, d:d + 1], one)
                           for d in range(Xs.shape[1]))
        d2s = tuple(d2s)
        return FusedOperands(structure, d2s, torch.stack(d2s))


def fused_operands(stacked_model, X) -> Optional[FusedOperands]:
    """The fused tiers' operands that depend on X alone, or None where no
    fused tier takes the model's kernel at X's N. A caller that holds X
    fixed builds them once and passes them to every evaluation
    (`fused_stationary_spec`, `batched_neg_log_marginal_likelihood`) whose
    model has the structure `key`."""
    structure = fused_structure(stacked_model.kernel, X.shape[1])
    if structure is None or not st_mod.fused_nll_supported(X.shape[0]):
        return None
    return _build_operands(stacked_model.kernel, X, structure)


def _fused_spec(kern, X, structure, operands):
    """(spec, operands): the given operands, or new ones, and the per-model
    scalars, which depend on the parameters."""
    if operands is None:
        operands = _build_operands(kern, X, structure)
    elif (operands.key != structure or operands.d2_stack.shape[-1] != X.shape[0]
          or operands.d2_stack.dtype != X.dtype or operands.d2_stack.device != X.device):
        raise ValueError("the fused operands were built for another kernel structure or X")
    vs, ls, als = [], [], []
    for t, fam, (form, _) in zip(_terms(kern), structure.families, structure.atoms):
        if form == "periodic":
            # the ls slot carries the period, the als slot the base lengthscale
            vs.append(t.base.variance)
            ls.append(t.period)
            als.append(t.base.lengthscales)
            continue
        v = t.variance
        vs.append(v)
        if form == "linear":
            on = torch.ones_like(v)
            ls.append(on)
            als.append(on)
            continue
        als.append(t.alpha if fam == "rq" else torch.ones_like(v))
        if form == "iso":
            ls.append(t.lengthscales)
        else:
            ells = t.lengthscales
            ls.extend(ells[:, d] for d in range(ells.shape[1]))
    spec = FusedSpec(structure.combine, structure.families, structure.dims, operands.d2s,
                     tuple(vs), tuple(ls), tuple(als), operands.d2_stack)
    return spec, operands


def fused_stationary_spec(stacked_model, X, operands: Optional[FusedOperands] = None):
    """Eligibility + operands for the fused NLL paths, or None: the
    structure of `fused_structure`, the shared matrices (the given
    `operands` of `fused_operands`, or new ones) and the per-model scalars.
    The shared matrix of Periodic(SE) is the squared distance, its ls slot
    carries the period and its als slot the base lengthscale; that of
    Linear is the raw Gram ⟨x, x'⟩. Operands built for another structure
    raise ValueError."""
    structure = fused_structure(stacked_model.kernel, X.shape[1])
    if structure is None:
        return None
    return _fused_spec(stacked_model.kernel, X, structure, operands)[0]


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
    'pallas_dense' | 'blocked' | 'blocked_hinv' | 'xla'. Metadata only: no
    tensor is built."""
    return _route(stacked_model, X, Y, fast)[0]


def _route(stacked_model, X, Y, fast):
    """(tier, the fused structure or None)."""
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
        return "xla", None
    structure = fused_structure(stacked_model.kernel, X.shape[1])
    if structure is not None and st_mod.fused_nll_supported(n):
        if (len(structure.families) == 1 and structure.families[0] in st_mod.FAMILIES
                and structure.dims == (1,)):
            return "fused_stationary", structure
        return f"fused_general_{structure.combine}", structure
    if nll_mod.pallas_nll_supported(n):
        return "pallas_dense", None
    if blocked_mod.blocked_nll_preferred(n):
        return "blocked", None
    return "blocked_hinv", None


def batched_neg_log_marginal_likelihood(stacked_model, X, Y, fast: bool = True,
                                        *, device=DEFAULT_DEVICE,
                                        dtype=DEFAULT_DTYPE,
                                        operands: Optional[FusedOperands] = None):
    """(B,) NLLs of a stacked batch of models sharing (X, Y), routed by
    kernel structure and N like the JAX router. Model, X and Y are moved
    to (device, dtype) first. 'xla' is the plain batched path (the JAX
    package's vmapped XLA path); every other tier runs its CUDA kernel on
    a GPU and its plain version on the CPU. The fused tiers take the given
    `operands` (`fused_operands` of the same X), or build their own. The
    span `router.dispatch` covers the moves, the tier's choice and the
    fused tiers' operands."""
    with span("router.dispatch"):
        dev = resolve_device(device)
        stacked_model = tree_to(stacked_model, dev, dtype)
        X = torch.as_tensor(X).to(device=dev, dtype=dtype)
        Y = torch.as_tensor(Y).to(device=dev, dtype=dtype)
        n = X.shape[0]
        b = batch_size(stacked_model)
        tier, structure = _route(stacked_model, X, Y, fast)
        _record_tier(tier, n, b)
        if tier != "xla":
            noise = stacked_model.likelihood.variance
            err = _err(stacked_model, X, Y)[:, :, 0]
        if tier.startswith("fused"):
            spec, operands = _fused_spec(stacked_model.kernel, X, structure, operands)
        if tier.startswith("fused_general"):
            mask = operands.ones_mask(b)
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
    return fused(spec.families, spec.d2_stack, err, spec.vs, spec.ls, spec.als,
                 noise, mask, dims=spec.dims)
