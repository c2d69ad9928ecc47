"""Efficient frontier: long-only minimum-variance portfolios over a grid of
target returns, and the tangency (maximum-Sharpe) portfolio.

Port of portfoliooptgp_tpu/portfolio/frontier.py (`Frontier`,
`efficient_frontier`). Each point is one simplex solve with a return floor
(portfolio/solver.minimize_simplex). The JAX package vmaps the 32 solves;
here they are a Python loop, each solve independent of the others.
`plot_frontier` waits for the plotting module (ROADMAP.md queue 1:
shell).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, as_tensor
from portfoliooptgp_tpu_torch.portfolio.solver import minimize_simplex


class Frontier(NamedTuple):
    target_returns: np.ndarray
    returns: np.ndarray
    volatilities: np.ndarray
    weights: np.ndarray  # (n_points, P)
    tangency_weights: np.ndarray
    tangency_return: float
    tangency_volatility: float


def efficient_frontier(mu, Sigma, risk_free_rate=0.0, n_points: int = 32, *,
                       device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE) -> Frontier:
    """Long-only efficient frontier over the simplex, on (device, dtype)."""
    mu = as_tensor(np.asarray(mu, dtype=float), device, dtype)
    Sigma = as_tensor(np.asarray(Sigma, dtype=float), device, dtype)
    p = mu.shape[0]
    targets = torch.linspace(float(torch.min(mu)), float(torch.max(mu)), n_points,
                             dtype=dtype, device=mu.device)
    opt = dict(device=device, dtype=dtype)

    def vol(w):
        return torch.sqrt(torch.clamp_min(w @ Sigma @ w, 1e-18))

    weights = torch.stack([
        minimize_simplex(vol, p, ineq=lambda w, t=t: mu @ w - t, **opt).weights
        for t in targets])
    rets = weights @ mu
    vols = torch.sqrt(torch.clamp_min(torch.einsum("np,pq,nq->n", weights, Sigma, weights),
                                      0.0))
    tan = minimize_simplex(lambda w: -(mu @ w - risk_free_rate) / vol(w), p, **opt).weights
    return Frontier(
        target_returns=targets.cpu().numpy(),
        returns=rets.cpu().numpy(),
        volatilities=vols.cpu().numpy(),
        weights=weights.cpu().numpy(),
        tangency_weights=tan.cpu().numpy(),
        tangency_return=float(mu @ tan),
        tangency_volatility=float(torch.sqrt(torch.clamp_min(tan @ Sigma @ tan, 0.0))),
    )
