"""Simplex-constrained minimization (the scipy-SLSQP replacement).

Port of portfoliooptgp_tpu/portfolio/solver.py: the simplex
{w ≥ 0, Σw = 1} is parameterized by softmax(z), and the one optional
inequality g(w) ≥ 0 is handled with an augmented Lagrangian — fixed outer
multiplier updates around an inner L-BFGS. Parity with the JAX package is
by tolerance on the optimum. `minimize_simplex_rows` solves R independent
problems at once, as the JAX package vmaps `minimize_simplex`: every
inner solve is one row-batched L-BFGS (train/lbfgs.fit_rows);
`minimize_simplex` is its one-row case.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, as_tensor
from portfoliooptgp_tpu_torch.train import lbfgs


class SolveResult(NamedTuple):
    weights: torch.Tensor
    objective: torch.Tensor
    constraint_violation: torch.Tensor


def simplex_project(w):
    """Euclidean projection of each row of `w` (..., n) onto the simplex
    (the sorting algorithm)."""
    n = w.shape[-1]
    u = torch.flip(torch.sort(w, dim=-1).values, dims=(-1,))
    css = torch.cumsum(u, dim=-1) - 1.0
    idx = torch.arange(1, n + 1, dtype=w.dtype, device=w.device)
    rho = torch.sum(u - css / idx > 0, dim=-1)
    theta = torch.gather(css, -1, (rho - 1)[..., None])[..., 0] / rho.to(w.dtype)
    return torch.clamp_min(w - theta[..., None], 0.0)


def minimize_simplex(
    objective: Callable,
    n_assets: int,
    ineq: Optional[Callable] = None,
    *,
    w0=None,
    inner_maxiter: int = 300,
    outer_iters: int = 10,
    penalty0: float = 50.0,
    penalty_growth: float = 2.0,
    device=DEFAULT_DEVICE,
    dtype=DEFAULT_DTYPE,
) -> SolveResult:
    """Minimize objective(w) over the simplex, with optional ineq(w) ≥ 0
    (a scalar or a vector of constraints), from the uniform start: one row
    of `minimize_simplex_rows`."""
    def objective_rows(W):
        return objective(W[0]).reshape(1)

    def ineq_rows(W):
        return torch.atleast_1d(ineq(W[0]))[None]

    res = minimize_simplex_rows(objective_rows, 1, n_assets,
                                None if ineq is None else ineq_rows, w0=w0,
                                inner_maxiter=inner_maxiter, outer_iters=outer_iters,
                                penalty0=penalty0, penalty_growth=penalty_growth,
                                device=device, dtype=dtype)
    return SolveResult(weights=res.weights[0], objective=res.objective[0],
                       constraint_violation=res.constraint_violation[0])


def minimize_simplex_rows(
    objective: Callable,
    n_rows: int,
    n_assets: int,
    ineq: Optional[Callable] = None,
    *,
    w0=None,
    inner_maxiter: int = 300,
    outer_iters: int = 10,
    penalty0: float = 50.0,
    penalty_growth: float = 2.0,
    device=DEFAULT_DEVICE,
    dtype=DEFAULT_DTYPE,
) -> SolveResult:
    """Minimize `n_rows` independent problems over the simplex at once, as
    the JAX package vmaps `minimize_simplex`, from the start `w0` (uniform
    by default). `objective` maps weights (R, n) to (R,) and `ineq` to (R,)
    or (R, m), row r depending on row r only: g_r(w_r) ≥ 0. Each row keeps
    its own multipliers λ_r; the penalty ρ, shared, grows by
    `penalty_growth` over the fixed `outer_iters`. Returns (R, n) weights
    and (R,) objectives and violations."""
    if w0 is None:
        w0 = torch.full((n_assets,), 1.0 / n_assets)
    w0 = as_tensor(w0, device, dtype)
    z0 = torch.log(torch.clamp_min(w0, 1e-8)).expand(n_rows, n_assets).clone()

    def weights_of(z):
        return torch.softmax(z, dim=-1)

    with torch.no_grad():
        if ineq is None:
            z = lbfgs.fit_rows(lambda z: objective(weights_of(z)), z0,
                               maxiter=inner_maxiter).params
            w = weights_of(z)
            return SolveResult(weights=w, objective=objective(w),
                               constraint_violation=torch.zeros(n_rows, dtype=dtype,
                                                                 device=w.device))

        def constraints(w):
            return ineq(w).reshape(n_rows, -1)

        lam = torch.zeros_like(constraints(weights_of(z0)))
        rho = torch.as_tensor(penalty0, dtype=dtype, device=z0.device)
        z = z0
        for _ in range(outer_iters):
            def al_obj(z, lam=lam, rho=rho):
                w = weights_of(z)
                # augmented Lagrangian for g(w) >= 0:
                #   (ρ/2)·max(0, λ/ρ − g)² − λ²/(2ρ)
                t = torch.clamp_min(lam / rho - constraints(w), 0.0)
                return (objective(w) + 0.5 * rho * torch.sum(t * t, dim=-1)
                        - torch.sum(lam * lam, dim=-1) / (2 * rho))

            z = lbfgs.fit_rows(al_obj, z, maxiter=inner_maxiter).params
            g = constraints(weights_of(z))
            lam = torch.clamp_min(lam - rho * g, 0.0)
            rho = rho * penalty_growth
        w = weights_of(z)
        viol = torch.sum(torch.clamp_min(-constraints(w), 0.0), dim=-1)
        return SolveResult(weights=w, objective=objective(w), constraint_violation=viol)
