"""Plain reference of the ICM frontier cell, in PyTorch.

It imports nothing of the program: from the inputs the benchmark made and
the flat raw (unconstrained) parameters the program returned, it works out
the rest itself. The flat order is the program's `params.ravel` order of an
ICM model with an isotropic SE kernel:

    [kernel raw variance, kernel raw lengthscale, likelihood raw variance,
     W (P × rank, row by row), raw κ (P)]

each positive value being softplus(raw) + 1e-6; B = WWᵀ + diag(κ); the
covariance of vec(Y) is B ⊗ Kx + σ²I with Kx = v·exp(−½ r²/ℓ²); the
log-density is −NLL under a standard-normal prior on every raw value, and
its gradient comes by autograd.

Two forms compute the NLL. `dense` factors the (NP, NP) Kronecker covariance
itself, for small sizes. `blocked`, the card's form, takes eigh(B) = E Λ Eᵀ,
rotates Y into B's eigenbasis, Ỹ = Y E, and factors the P shifted systems
λᵢKx + σ²I: B ⊗ Kx + σ²I = (E ⊗ I)(Λ ⊗ Kx + σ²I)(E ⊗ I)ᵀ. The tests hold
the two forms to each other.

`prec` is `gp.F64` (the reference) or `gp.TF32` (the control of a float32
configuration: every matrix product's operands rounded to TF32, eigh and
the factors in float32).
"""

from __future__ import annotations

import torch

from gpbench.reference.gp import F64, Precision, gauss_nll, positive, sq_dist

BLOCK = 128  # draws per evaluation of the blocked form


def dim(P: int, rank: int) -> int:
    """Raw parameters of one model."""
    return 3 + P * rank + P


def unpack(z, P: int, rank: int, prec: Precision):
    """(v, ℓ, σ², B) of the flat raw parameters z (M, dim): (M,) each and
    B (M, P, P)."""
    v, ell, s2 = (positive(z[:, i]) for i in range(3))
    W = z[:, 3:3 + P * rank].reshape(-1, P, rank)
    kappa = positive(z[:, 3 + P * rank:3 + P * rank + P])
    return v, ell, s2, prec.mm(W, W.transpose(-1, -2)) + torch.diag_embed(kappa)


def _kx(X, v, ell, prec):
    """(M, N, N) SE Gram matrices of the rows of X (N, 1)."""
    d2 = sq_dist(X, prec)
    return v[:, None, None] * torch.exp(-0.5 * d2 / (ell * ell)[:, None, None])


def nll_dense(X, Y, z, P, rank, prec: Precision = F64):
    """(M,) NLLs by a Cholesky of the whole (NP, NP) covariance."""
    v, ell, s2, B = unpack(z, P, rank, prec)
    Kx = _kx(X, v, ell, prec)
    M, N = Kx.shape[0], Kx.shape[-1]
    K = (B[:, :, None, :, None] * Kx[:, None, :, None, :]).reshape(M, P * N, P * N)
    K = K + s2[:, None, None] * torch.eye(P * N, dtype=K.dtype, device=K.device)
    return gauss_nll(K, Y.transpose(0, 1).reshape(-1), prec)


def nll_blocked(X, Y, z, P, rank, prec: Precision = F64):
    """(M,) NLLs by eigh(B) and the P shifted systems λᵢKx + σ²I."""
    v, ell, s2, B = unpack(z, P, rank, prec)
    lam, E = torch.linalg.eigh(B)  # (M, P), (M, P, P)
    Yt = prec.mm(Y.expand(E.shape[0], *Y.shape), E)  # (M, N, P)
    Kx = _kx(X, v, ell, prec)
    M, N = Kx.shape[0], Kx.shape[-1]
    eye = torch.eye(N, dtype=Kx.dtype, device=Kx.device)
    Kb = lam[:, :, None, None] * Kx[:, None] + s2[:, None, None, None] * eye
    nll = gauss_nll(Kb.reshape(M * P, N, N), Yt.transpose(-1, -2).reshape(M * P, N), prec)
    return nll.reshape(M, P).sum(-1)


def logp_and_grad(X, Y, z, P, rank, prec: Precision = F64, form: str = "blocked",
                  block: int = BLOCK):
    """log p (M,) and its gradient (M, dim) at the flat raw parameters
    z (M, dim), `block` draws an evaluation."""
    nll = {"dense": nll_dense, "blocked": nll_blocked}[form]
    X, Y = X.to(prec.dtype), Y.to(prec.dtype)
    out = []
    for i in range(0, z.shape[0], block):
        with torch.enable_grad():
            zz = z[i:i + block].to(prec.dtype).detach().requires_grad_(True)
            logp = -nll(X, Y, zz, P, rank, prec) - 0.5 * torch.sum(zz * zz, dim=-1)
            (g,) = torch.autograd.grad(logp.sum(), zz)
        out.append((logp.detach(), g))
    if not out:
        return z.new_zeros((0,), dtype=prec.dtype), z.new_zeros((0, z.shape[1]), dtype=prec.dtype)
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])
