"""Matrix-free GPR inference: conjugate gradients and stochastic Lanczos
quadrature (the BBMM recipe of Gardner et al. 2018, GPyTorch).

Port of portfoliooptgp_tpu/ops/iterative.py. For N beyond the direct
factorizations' budgets the NLL's two expensive terms become iterative
and matmul-bound:

    quad   = yᵀ Ks⁻¹ y                       by batched CG solves
    logdet ≈ (N/P) Σ_p ‖z_p‖² e₁ᵀ log(T_p) e₁  by m-step Lanczos on
             Rademacher probes z_p (SLQ)

and the gradient of the log-determinant is the stochastic trace estimate
tr(Ks⁻¹ dKs) ≈ mean_p (Ks⁻¹ z_p)ᵀ dKs z_p, whose solves are folded into
the forward's one batched CG over [y | probes]: nothing O(N³), no N×N
factor stored. The estimates are stochastic; (num_probes, num_lanczos,
cg_tol) set their accuracy. The caller opts in: the exact tiers of
models/gpr.py stay the default.

The matvec is a plain torch.matmul (TF32 is off, device.py), as the JAX
package leaves it to XLA at precision="highest": no kernel of its own.
JAX's `while_loop` and `scan` become Python loops. The CG convergence
test reads the residuals on the host once an iteration (one device sync
an iteration); Lanczos runs all P probes as one (N, P) matvec a step,
with the per-column arithmetic of the JAX package's vmap over probes, and
one batched `torch.linalg.eigh` over the (P, m, m) tridiagonals.

Randomness: the JAX package draws the Lanczos probes from `key` and the
CG probes from `fold_in(key, 1)`. Here both come from one `torch.Generator`,
the CG probes first; or the caller gives them as tensors (`probes=`), as
the tests give the JAX package's own.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from portfoliooptgp_tpu_torch.ops import linalg

LOG2PI = 1.8378770664093453


def rademacher(shape, generator: torch.Generator, dtype):
    """Rademacher signs (±1) of `shape` from `generator`, on its device."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return torch.where(u < 0.5, 1.0, -1.0).to(dtype)


def batched_cg(matvec: Callable, B_rhs, *, tol: float = 1e-8, maxiter: int = 256):
    """Solve A X = B for SPD A with several right-hand sides.

    matvec: (N, R) -> (N, R) applying A column-wise; B_rhs: (N, R).
    Plain CG is `batched_pcg` with the identity preconditioner. Returns
    (X, iterations)."""
    return batched_pcg(matvec, lambda V: V, B_rhs, tol=tol, maxiter=maxiter)


@torch.no_grad()
def pivoted_cholesky(K, rank: int, jitter: float = 1e-30):
    """Partial pivoted Cholesky K ≈ L Lᵀ with L (N, rank), greedy on the
    largest remaining diagonal. Past K's numerical rank the remaining
    diagonal is clamped to `jitter` and the column divided by its root, as
    in the JAX package (its split preconditioner drops such columns; the
    Woodbury one keeps them). Never differentiated."""
    n = K.shape[0]
    L = torch.zeros((n, rank), dtype=K.dtype, device=K.device)
    d = torch.diagonal(K).clone()
    for i in range(rank):
        piv = torch.argmax(d)
        val = torch.sqrt(torch.clamp_min(d[piv], jitter))
        col = (K[:, piv] - L @ L[piv]) / val
        L[:, i] = col
        d = torch.clamp_min(d - col * col, 0.0)
    return L


def woodbury_preconditioner(L, noise):
    """apply(V) ≈ (L Lᵀ + σ²I)⁻¹ V by Woodbury: one k×k Cholesky up front,
    then two skinny matmuls an application. L: (N, k), noise: σ²."""
    k = L.shape[1]
    M = noise * torch.eye(k, dtype=L.dtype, device=L.device) + L.T @ L
    Mc = linalg.cholesky(M)

    def apply(V):
        t = linalg.chol_solve(Mc, L.T @ V)
        return (V - L @ t) / noise

    return apply


def split_preconditioner(L, noise):
    """For P = L Lᵀ + σ²I: (apply, logdet_P) with apply(V) = P^(-1/2) V
    and log|P| exact.

    With (d, U) = eigh(LᵀL), W = L U diag(d^(-1/2)) has orthonormal
    columns spanning range(L), so

        P^(-1/2) v = v/σ + W (diag((σ²+d)^(-1/2)) − I/σ) Wᵀ v
        log|P|     = Σ_active log(σ²+d_i) + (N − k_active) log σ²

    Columns with d_i below 1e-6 of the largest are dropped from both. The
    split-SLQ log-det is log|Ks| = log|P| + log|P^(-1/2) Ks P^(-1/2)|."""
    n = L.shape[0]
    d, U = torch.linalg.eigh(L.T @ L)
    active = d > torch.clamp_min(torch.max(d), 1e-30) * 1e-6
    d_safe = torch.where(active, d, torch.ones_like(d))
    W = L @ ((U / torch.sqrt(d_safe)[None, :]) * active[None, :])
    inv_sigma = 1.0 / torch.sqrt(torch.as_tensor(noise, dtype=L.dtype, device=L.device))
    scale = torch.where(active, 1.0 / torch.sqrt(noise + d_safe) - inv_sigma,
                        torch.zeros_like(d))

    def apply(V):
        return inv_sigma * V + W @ (scale[:, None] * (W.T @ V))

    k_active = torch.sum(active)
    logdet_P = (torch.sum(torch.where(active, torch.log(noise + d_safe), torch.zeros_like(d)))
                + (n - k_active) * torch.log(torch.as_tensor(noise, dtype=L.dtype,
                                                             device=L.device)))
    return apply, logdet_P


def batched_pcg(matvec: Callable, prec: Callable, B_rhs, *, tol: float = 1e-8,
                maxiter: int = 256):
    """Preconditioned CG, the contract of `batched_cg`. A column stops
    updating once its UNpreconditioned residual is within tol·‖b‖, so tol
    means the same with and without a preconditioner. Returns (X,
    iterations); the loop stops when every column has converged (one host
    sync an iteration) or at `maxiter`."""
    stop2 = (tol * tol) * torch.clamp_min(torch.sum(B_rhs * B_rhs, dim=0), 1e-30)
    x = torch.zeros_like(B_rhs)
    r = B_rhs
    z = prec(B_rhs)
    p = z
    rz = torch.sum(B_rhs * z, dim=0)
    it = 0
    while it < maxiter:
        active = torch.sum(r * r, dim=0) > stop2
        if not bool(torch.any(active)):
            break
        Ap = matvec(p)
        pAp = torch.sum(p * Ap, dim=0)
        alpha = torch.where(active, rz / torch.where(pAp > 0, pAp, torch.ones_like(pAp)),
                            torch.zeros_like(pAp))
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * Ap
        z = prec(r)
        rz_new = torch.sum(r * z, dim=0)
        beta = torch.where(active, rz_new / torch.where(rz != 0, rz, torch.ones_like(rz)),
                           torch.zeros_like(rz))
        p = z + beta[None, :] * p
        rz = rz_new
        it += 1
    return x, it


def lanczos_logdet(matvec: Callable, n: int, generator=None, *, num_probes: int = 16,
                   num_lanczos: int = 32, dtype=torch.float32, device=None, probes=None):
    """SLQ estimate of log|A| for SPD A (size n) through `matvec` on
    (n, P): P = num_probes Rademacher probes drawn from `generator`, or the
    (n, P) `probes` given, moved to `device` when given. Every probe's
    m-step Lanczos runs in one (n, P) matvec a step."""
    if probes is None:
        probes = rademacher((n, num_probes), generator, dtype)
    Z = probes.to(dtype=dtype, device=device)
    num_probes = Z.shape[1]
    q = Z / torch.linalg.vector_norm(Z, dim=0)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros((num_probes,), dtype=dtype, device=Z.device)
    alphas, betas = [], []
    for _ in range(num_lanczos):
        Aq = matvec(q)
        alpha = torch.sum(q * Aq, dim=0)
        w = Aq - alpha * q - beta_prev * q_prev
        # one re-orthogonalization pass against the two stored vectors
        w = w - torch.sum(w * q, dim=0) * q - torch.sum(w * q_prev, dim=0) * q_prev
        beta = torch.linalg.vector_norm(w, dim=0)
        q_next = w / torch.where(beta > 1e-12, beta, torch.ones_like(beta))
        q_prev, q, beta_prev = q, q_next, beta
        alphas.append(alpha)
        betas.append(beta)
    a = torch.stack(alphas, dim=1)  # (P, m)
    b = torch.stack(betas[:-1], dim=1)  # (P, m - 1)
    T = torch.diag_embed(a) + torch.diag_embed(b, 1) + torch.diag_embed(b, -1)
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp_min(evals, 1e-12)
    weights = evecs[:, 0, :] ** 2
    estimates = torch.sum(weights * torch.log(evals), dim=-1) * torch.sum(Z * Z, dim=0)
    return torch.mean(estimates)


class CGNLLAux(NamedTuple):
    alpha: torch.Tensor  # (N, 1): Ks⁻¹ y by CG
    probes: torch.Tensor  # (N, P): the CG's Rademacher trace probes
    probe_solves: torch.Tensor  # (N, P): Ks⁻¹ probes
    cg_iters: int


def nll_cg_forward(K, y, noise, generator=None, num_probes: int = 16, num_lanczos: int = 32,
                   cg_tol: float = 1e-6, precond_rank: int = 0, *, probes=None):
    """(NLL, CGNLLAux) of `nll_cg`, without its gradient: the JAX package's
    `_nll_cg_fwd_impl`. The CG probes are drawn first, then the Lanczos
    probes, both from `generator`; or `probes` gives them, as the pair
    (CG probes, Lanczos probes) of (N, P) tensors."""
    n = K.shape[0]
    dtype = K.dtype
    if probes is None:
        if generator is None:
            raise ValueError("nll_cg needs a generator or the probes")
        probes = (rademacher((n, num_probes), generator, dtype),
                  rademacher((n, num_probes), generator, dtype))
    cg_probes, slq_probes = probes

    def matvec(V):
        return K @ V + noise * V

    # ONE batched solve for [y | probes]: a CG iteration reads K once
    # whatever the number of right-hand sides, so the backward's trace
    # probes ride along with the target solve
    cg_probes = cg_probes.to(dtype=dtype, device=K.device)
    rhs = torch.cat([y, cg_probes], dim=1)  # (N, 1 + P)
    if precond_rank and precond_rank > 0:
        Lpc = pivoted_cholesky(K, precond_rank)
        sol, iters = batched_pcg(matvec, woodbury_preconditioner(Lpc, noise), rhs,
                                 tol=cg_tol, maxiter=4 * n)
        # split-SLQ: the exact log|P| plus SLQ on the whitened operator,
        # whose spectrum clusters at 1
        phalf_inv, logdet_P = split_preconditioner(Lpc, noise)
        logdet = logdet_P + lanczos_logdet(
            lambda V: phalf_inv(matvec(phalf_inv(V))), n, num_lanczos=num_lanczos,
            dtype=dtype, device=K.device, probes=slq_probes)
    else:
        sol, iters = batched_cg(matvec, rhs, tol=cg_tol, maxiter=4 * n)
        logdet = lanczos_logdet(matvec, n, num_lanczos=num_lanczos, dtype=dtype,
                                device=K.device, probes=slq_probes)
    alpha, solves = sol[:, :1], sol[:, 1:]
    nll = 0.5 * torch.sum(y * alpha) + 0.5 * logdet + 0.5 * n * LOG2PI
    return nll, CGNLLAux(alpha=alpha, probes=cg_probes, probe_solves=solves, cg_iters=iters)


class _NLLCG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, y, noise, generator, num_probes, num_lanczos, cg_tol, precond_rank,
                probes):
        nll, aux = nll_cg_forward(K, y, noise, generator, num_probes, num_lanczos, cg_tol,
                                  precond_rank, probes=probes)
        ctx.save_for_backward(aux.alpha, aux.probes, aux.probe_solves)
        return nll, aux.cg_iters

    @staticmethod
    def backward(ctx, g, _iters):
        # d logdet/dK ≈ mean_p s_p z_pᵀ (symmetrized); d quad/dK = −α αᵀ
        alpha, Z, S = ctx.saved_tensors
        trace_est = 0.5 * (S @ Z.T + Z @ S.T) / Z.shape[1]
        dK = g * 0.5 * (trace_est - alpha @ alpha.T)
        dy = g * alpha
        dnoise = g * 0.5 * (torch.trace(trace_est) - torch.sum(alpha * alpha))
        return dK, dy, dnoise, None, None, None, None, None, None


def nll_cg(K, y, noise, generator=None, num_probes: int = 16, num_lanczos: int = 32,
           cg_tol: float = 1e-6, precond_rank: int = 0, *, probes=None,
           with_iters: bool = False):
    """Matrix-free GPR NLL, differentiable in K (N, N), y (N, 1) and noise
    (a scalar σ² or 0-d tensor). Stochastic in the log-det (SLQ); the quad
    term is CG-exact to cg_tol. precond_rank > 0 adds the rank-k pivoted-
    Cholesky Woodbury preconditioner to the CG solves (the same solution,
    fewer iterations) and the split-SLQ log-det. The probes come from
    `generator` (a `torch.Generator`) or are given as `probes` (see
    `nll_cg_forward`). with_iters: return (NLL, CG iterations) instead."""
    if not isinstance(noise, torch.Tensor):
        noise = torch.as_tensor(noise, dtype=K.dtype, device=K.device)
    nll, iters = _NLLCG.apply(K, y, noise, generator, num_probes, num_lanczos, cg_tol,
                              precond_rank, probes)
    return (nll, iters) if with_iters else nll
