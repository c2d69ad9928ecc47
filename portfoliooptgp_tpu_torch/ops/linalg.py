"""Dense linear algebra for GP inference, batched over leading axes.

Port of portfoliooptgp_tpu/ops/linalg.py (the main path's part, and
`safe_eigh`; the jitter ladder and guarded VJPs are listed in ROADMAP.md).
torch.linalg does the work here, as XLA did in the reference. A failed
factorization gives NaN, as `jnp.linalg.cholesky` does, so callers see a
non-finite loss instead of an exception.
"""

from __future__ import annotations

import torch


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
        lam, E = torch.linalg.eigh(A)
        ctx.save_for_backward(lam, E)
        return lam, E

    @staticmethod
    def backward(ctx, lam_bar, E_bar):
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
    B = WWᵀ + diag(κ) has p − rank tied eigenvalues at the uniform-κ start."""
    return _SafeEigh.apply(A)
