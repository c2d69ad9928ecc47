"""Dense linear algebra for GP inference, batched over leading axes.

Port of portfoliooptgp_tpu/ops/linalg.py. torch.linalg does the work
here, as XLA did in the reference. A failed factorization gives NaN, as
`jnp.linalg.cholesky` does, so callers see a non-finite loss instead of an
exception. `cholesky_guarded`, `safe_cholesky` and `cholesky_inverse_pair`
carry the JAX package's hand-written VJPs as `torch.autograd.Function`s:
a failed factor gives zero gradients instead of NaN ones. `safe_eigh`'s
forward is the span `linalg.eigh`, its backward `linalg.eigh_backward`.
"""

from __future__ import annotations

import torch

from portfoliooptgp_tpu_torch.utils.profiling import span

JITTER_LADDER = (0.0, 1e-8, 1e-6, 1e-4, 1e-2)


def add_diag(K, value):
    """K (..., N, N) + value·I; `value` a scalar or (...,) per matrix."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    if isinstance(value, torch.Tensor) and value.ndim:
        value = value[..., None, None]
    return K + value * eye


def cholesky(K, jitter=0.0):
    if not (isinstance(jitter, (int, float)) and jitter == 0.0):
        K = add_diag(K, jitter)
    L, info = torch.linalg.cholesky_ex(K)
    failed = (info != 0)[..., None, None]
    return torch.where(failed, torch.full_like(L, float("nan")), L)


def solve_lower(L, B):
    """Solve L X = B with L lower-triangular."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def solve_upper_t(L, B):
    """Solve Lᵀ X = B with L lower-triangular."""
    return torch.linalg.solve_triangular(L.transpose(-1, -2), B, upper=True)


def chol_solve(L, B):
    """Solve (L Lᵀ) X = B."""
    return solve_upper_t(L, solve_lower(L, B))


def logdet_from_chol(L):
    """log|K| = 2 Σ log diag(L), per matrix."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def mahalanobis_from_chol(L, y):
    """yᵀ K⁻¹ y via one triangular solve: ‖L⁻¹y‖², per matrix."""
    a = solve_lower(L, y)
    return torch.sum(a * a, dim=(-2, -1))


class _SafeEigh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A):
        # torch.linalg.eigh raises where jnp.linalg.eigh returns NaN: a
        # matrix with a non-finite entry is factored as I and given NaN
        # outputs (and NaN gradients), the others as they are
        with span("linalg.eigh"):
            ok = torch.isfinite(A).flatten(-2).all(-1)[..., None]
            eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
            lam, E = torch.linalg.eigh(torch.where(ok[..., None], A, eye))
            nan = torch.full((), float("nan"), dtype=A.dtype, device=A.device)
            lam, E = torch.where(ok, lam, nan), torch.where(ok[..., None], E, nan)
            ctx.save_for_backward(lam, E)
            return lam, E

    @staticmethod
    def backward(ctx, lam_bar, E_bar):
        with span("linalg.eigh_backward"):
            lam, E = ctx.saved_tensors
            if lam_bar is None:
                lam_bar = torch.zeros_like(lam)
            if E_bar is None:
                E_bar = torch.zeros_like(E)
            d = lam[..., None, :] - lam[..., :, None]  # d_ij = λ_j − λ_i
            scale = torch.clamp_min(torch.amax(torch.abs(lam), dim=-1), 1.0)[..., None, None]
            eps = 64.0 * torch.finfo(lam.dtype).eps * scale
            big = torch.abs(d) > eps
            F = torch.where(big, 1.0 / torch.where(big, d, torch.ones_like(d)),
                            torch.zeros_like(d))
            Et = E.transpose(-1, -2)
            M = F * (Et @ E_bar)
            Abar = E @ (torch.diag_embed(lam_bar) + 0.5 * (M + M.transpose(-1, -2))) @ Et
            # the input is constrained symmetric: symmetrize the cotangent
            return 0.5 * (Abar + Abar.transpose(-1, -2))


def safe_eigh(A):
    """(λ ascending, E) of symmetric A with a degeneracy-safe VJP.

    The standard eigh pullback holds F_ij = 1/(λ_j − λ_i), NaN for tied
    eigenvalues. For a function of A that does not depend on the basis
    inside a degenerate eigenspace (NLLs, log-determinants, solves), those
    terms cancel; this VJP zeroes F where |λ_j − λ_i| ≤ 64·eps·max(1,
    max|λ|), the JAX package's threshold. The ICM model needs it: its
    B = WWᵀ + diag(κ) has p − rank tied eigenvalues at the uniform-κ start.
    A matrix with a non-finite entry gives NaN λ and E, as in JAX (a NUTS
    trajectory that diverges reaches one), instead of an exception."""
    return _SafeEigh.apply(A)


# -- factorizations with hand-written VJPs ---------------------------------

def _tril_half_diag(P):
    """Φ(P): the lower triangle with its diagonal halved."""
    P = torch.tril(P)
    return P - 0.5 * torch.diag_embed(torch.diagonal(P, dim1=-2, dim2=-1))


def _sym(A):
    return 0.5 * (A + A.transpose(-1, -2))


def _all_finite(L):
    return torch.all(torch.isfinite(L))


class _CholeskyNanGuarded(torch.autograd.Function):
    """cholesky(K) whose VJP is zero, not NaN, when the factor failed."""

    @staticmethod
    def forward(ctx, K):
        L = cholesky(K)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        # Murray (2016): K̄ = L⁻ᵀ Φ(Lᵀ L̄) L⁻¹, symmetrized as jax's VJP is
        (L,) = ctx.saved_tensors
        ok = _all_finite(L)
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        Ls = torch.where(ok, L, eye)
        P = _tril_half_diag(Ls.transpose(-1, -2) @ Lbar)
        inner = torch.linalg.solve_triangular(
            Ls.transpose(-1, -2), P.transpose(-1, -2), upper=True).transpose(-1, -2)
        Kbar = _sym(torch.linalg.solve_triangular(Ls.transpose(-1, -2), inner, upper=True))
        return torch.where(ok, Kbar, torch.zeros_like(Kbar))


def cholesky_guarded(K):
    """(L, ok): one factorization of K with the NaN-guarded VJP. A failed
    factor gives NaN L, ok False and zero gradients; callers treat the
    non-finite loss as a masked step (no jitter ladder on the hot path)."""
    L = _CholeskyNanGuarded.apply(K)
    return L, _all_finite(torch.diagonal(L, dim1=-2, dim2=-1))


def safe_cholesky(K, ladder=JITTER_LADDER):
    """(L, ok) with deterministic jitter escalation: the first level of
    `ladder` at which a detached copy of K factors is chosen, then ONE
    guarded, differentiable factorization runs at it (the failed probes never
    enter the graph). If no level succeeds the last is used and ok is False."""
    Kp = K.detach()
    oks = [bool(_all_finite(cholesky(Kp, j))) for j in ladder]
    chosen = ladder[oks.index(True)] if any(oks) else ladder[-1]
    L = _CholeskyNanGuarded.apply(add_diag(K, float(chosen)))
    return L, any(oks)


class _CholeskyInversePair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K):
        L = cholesky(K)
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        W = torch.linalg.solve_triangular(L, eye, upper=False)
        ctx.save_for_backward(L, W)
        return L, W

    @staticmethod
    def backward(ctx, Lbar, Wbar):
        L, W = ctx.saved_tensors
        if Lbar is None:
            Lbar = torch.zeros_like(L)
        if Wbar is None:
            Wbar = torch.zeros_like(W)
        ok = _all_finite(L)
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        Ws = torch.where(ok, W, eye)
        Ls = torch.where(ok, L, eye)
        Wt = Ws.transpose(-1, -2)
        Lbar_tot = Lbar + torch.tril(-(Wt @ Wbar) @ Wt)
        P = _tril_half_diag(Ls.transpose(-1, -2) @ Lbar_tot)
        Kbar = _sym(Wt @ (P @ Ws))
        return torch.where(ok, Kbar, torch.zeros_like(Kbar))


def cholesky_inverse_pair(K):
    """(L, W) = (chol(K), L⁻¹) with an all-matmul backward:

        L̄ += tril(−Wᵀ W̄ Wᵀ),  P = Φ(Lᵀ L̄),  K̄ = sym(Wᵀ P W).

    A failed factor gives NaN outputs and zero gradients, as
    `cholesky_guarded`. The M-phase of `svgp.gaussian_elbo_gram_fused`."""
    return _CholeskyInversePair.apply(K)
