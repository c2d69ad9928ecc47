"""Per-day portfolio evaluation of the static strategies over the horizon.

Port of portfoliooptgp_tpu/portfolio/batched_eval.py. Every day's moments
are precomputed as (D, A) arrays. `min_volatility` days are independent
(its objective has no transaction penalty), so they are one row-batched
solve (portfolio/solver.minimize_simplex_rows), as the JAX package vmaps
them; `sharpe`/`max_return` roll the previous weights forward day by day,
where the JAX package scans; `constant` is closed-form and `dynamic`
stays on the sequential path in `Portfolio.evaluate_portfolio`.
"""

from __future__ import annotations

import numpy as np
import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, as_tensor
from portfoliooptgp_tpu_torch.portfolio.optimizer import (
    l1_l2_penalty,
    sharpe_objective,
    transaction_penalty,
)
from portfoliooptgp_tpu_torch.portfolio.solver import minimize_simplex, minimize_simplex_rows

#: Strategies whose full horizon is solved here.
BATCHABLE_STRATEGIES = ("constant", "sharpe", "max_return", "min_volatility")


def day_moments(returns, variances, is_log_return: bool):
    """Per-day (mu, var) arrays, shape (D, A) each: running cumulative
    predictions (summed log-returns or compounded returns Π(1+r)−1) with
    summed variances; day 0 is the prefix of length 1."""
    R = np.concatenate([np.asarray(r, dtype=float).reshape(-1, 1) for r in returns], axis=1)
    V = np.concatenate([np.asarray(v, dtype=float).reshape(-1, 1) for v in variances], axis=1)
    mu = np.cumsum(R, axis=0) if is_log_return else np.cumprod(1.0 + R, axis=0) - 1.0
    return mu, np.cumsum(V, axis=0)


def solve_horizon(strategy: str, mu, var, prev0, r_f, lambda_l1, lambda_l2, lambda_tx,
                  max_volatility, min_return, if_tx: bool = True, *,
                  device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
    """Solve every day of the horizon. mu/var (D, A) per-day moments
    (diagonal covariances), prev0 the previous-weights seed of the
    transaction-penalty chain. Returns (weights (D, A), ret (D,), vol (D,))."""
    mu = as_tensor(mu, device, dtype)
    var = as_tensor(var, device, dtype)
    D, n = mu.shape
    opt = dict(device=device, dtype=dtype)

    if strategy == "constant":
        W = torch.full_like(mu, 1.0 / n)
    elif strategy == "min_volatility":
        def obj(W):
            return (torch.sqrt(torch.clamp_min(torch.sum(W * var * W, dim=-1), 1e-18))
                    + l1_l2_penalty(W, lambda_l1, lambda_l2))

        W = minimize_simplex_rows(obj, D, n, lambda W: torch.sum(mu * W, dim=-1) - min_return,
                                  **opt).weights
    elif strategy in ("sharpe", "max_return"):
        prev = as_tensor(prev0, device, dtype)
        rows = []
        for mu_d, var_d in zip(mu, var):
            Sigma = torch.diag(var_d)

            def pen(w, prev=prev):
                p = l1_l2_penalty(w, lambda_l1, lambda_l2)
                if if_tx:
                    p = p + transaction_penalty(w, prev, lambda_tx)
                return p

            if strategy == "sharpe":
                obj = lambda w, m=mu_d, S=Sigma: sharpe_objective(w, m, S, r_f) + pen(w)
                prev = minimize_simplex(obj, n, **opt).weights
            else:
                obj = lambda w, m=mu_d: -(m @ w) + pen(w)
                ineq = lambda w, S=Sigma: max_volatility - torch.sqrt(
                    torch.clamp_min(w @ S @ w, 1e-18))
                prev = minimize_simplex(obj, n, ineq, **opt).weights
            rows.append(prev)
        W = torch.stack(rows)
    else:
        raise ValueError(f"strategy {strategy!r} is not batchable")

    ret = torch.einsum("da,da->d", mu, W)
    vol = torch.sqrt(torch.clamp_min(torch.einsum("da,da->d", W * W, var), 0.0))
    return W, ret, vol
