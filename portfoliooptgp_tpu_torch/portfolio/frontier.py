"""Efficient frontier: long-only minimum-variance portfolios over a grid of
target returns, and the tangency (maximum-Sharpe) portfolio.

Port of portfoliooptgp_tpu/portfolio/frontier.py (`Frontier`,
`efficient_frontier`, `plot_frontier`). Each point is a simplex solve
with a return floor; the sweep is one row-batched solve of all the
points (portfolio/solver.minimize_simplex_rows), as the JAX package vmaps
them. The tangency portfolio is one more solve.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, as_tensor
from portfoliooptgp_tpu_torch.portfolio.solver import minimize_simplex, minimize_simplex_rows


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

    def vol_rows(W):
        return torch.sqrt(torch.clamp_min(torch.sum((W @ Sigma) * W, dim=-1), 1e-18))

    weights = minimize_simplex_rows(vol_rows, n_points, p, ineq=lambda W: W @ mu - targets,
                                    **opt).weights
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


def plot_frontier(frontier: Frontier, risk_free_rate=0.0, filename=None):
    """Frontier + capital-allocation line + tangency point (the real version
    of efficient.py's illustration), matplotlib with the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(frontier.volatilities, frontier.returns, "-o", ms=3,
            color="#0065BD", label="efficient frontier")
    ax.scatter([frontier.tangency_volatility], [frontier.tangency_return],
               color="#E37222", zorder=5, label="tangency (max Sharpe)")
    xs = np.linspace(0, frontier.volatilities.max() * 1.1, 50)
    slope = (frontier.tangency_return - risk_free_rate) / max(
        frontier.tangency_volatility, 1e-12
    )
    ax.plot(xs, risk_free_rate + slope * xs, "--", color="#7F7F7F",
            label="capital allocation line")
    ax.set_xlabel("volatility")
    ax.set_ylabel("expected return")
    ax.legend()
    ax.grid(alpha=0.3)
    if filename:
        fig.savefig(filename, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
