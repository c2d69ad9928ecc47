"""Mean-variance portfolio optimizer.

Port of portfoliooptgp_tpu/portfolio/optimizer.py: Sharpe / max-return /
min-vol objectives with L1/L2 regularization and a transaction-cost
penalty keyed on the previous weights, n-asset general, solved with
`solver.minimize_simplex` on the optimizer's device. Reference quirks kept:
`uncertainty_objective` applies only L1/L2 (no transaction penalty);
cumulative predictions compound returns with summed variances (or sum
log-returns); previous_weights roll forward after every solve.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, as_tensor
from portfoliooptgp_tpu_torch.portfolio.solver import SolveResult, minimize_simplex


def sharpe_objective(w, mu, Sigma, r_f):
    ret = mu @ w
    vol = torch.sqrt(torch.clamp_min(w @ Sigma @ w, 1e-18))
    return -(ret - r_f) / vol


def l1_l2_penalty(w, lambda_l1, lambda_l2):
    """The penalty of weights (..., n), one a row."""
    return (lambda_l1 * torch.sum(torch.abs(w), dim=-1)
            + lambda_l2 * torch.sum(w * w, dim=-1))


def transaction_penalty(w, previous_weights, lambda_tx):
    return lambda_tx * torch.sum(torch.abs(w - previous_weights))


@dataclass
class PortfolioOptimizer:
    """Stateful wrapper: set_predictions → optimize → previous_weights
    roll-forward."""

    n_assets: int = 5
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    lambda_tx: float = 0.0005
    if_tx_penalty: bool = True
    mu: Optional[torch.Tensor] = None
    Sigma: Optional[torch.Tensor] = None
    r_f: Optional[float] = None
    previous_weights: Optional[np.ndarray] = None
    device: object = DEFAULT_DEVICE
    dtype: torch.dtype = DEFAULT_DTYPE

    def __post_init__(self):
        if self.previous_weights is None:
            self.previous_weights = np.full(self.n_assets, 1.0 / self.n_assets)

    def _t(self, x):
        return as_tensor(np.asarray(x, dtype=float), self.device, self.dtype)

    def set_predictions(self, predicted_means, predicted_variances, r_f):
        self.mu = self._t(predicted_means)
        self.Sigma = torch.diag(self._t(predicted_variances))
        self.r_f = float(r_f)

    def set_predictions_cml(self, predicted_means, predicted_variances, r_f):
        mu = [float(np.prod([1.0 + r for r in np.ravel(rs)]) - 1.0) for rs in predicted_means]
        var = [float(np.sum(np.ravel(vs))) for vs in predicted_variances]
        self.set_predictions(mu, var, r_f)

    def set_cml_log_return(self, predicted_log_returns, predicted_variances, r_f):
        mu = [float(np.sum(np.ravel(rs))) for rs in predicted_log_returns]
        var = [float(np.sum(np.ravel(vs))) for vs in predicted_variances]
        self.set_predictions(mu, var, r_f)

    def set_previous_weights(self, previous_weights):
        self.previous_weights = np.asarray(previous_weights, dtype=float)

    def regularization(self, w):
        return l1_l2_penalty(w, self.lambda_l1, self.lambda_l2)

    def total_penalty(self, w):
        pen = self.regularization(w)
        if self.if_tx_penalty:
            pen = pen + transaction_penalty(w, self._t(self.previous_weights), self.lambda_tx)
        return pen

    def _require_predictions(self):
        if self.mu is None or self.Sigma is None or self.r_f is None:
            raise ValueError("Predictions and covariance matrix must be set before optimization.")

    def objective(self, w):
        self._require_predictions()
        return sharpe_objective(w, self.mu, self.Sigma, self.r_f) + self.total_penalty(w)

    def returns_objective(self, w):
        return -(self.mu @ w) + self.total_penalty(w)

    def uncertainty_objective(self, w):
        vol = torch.sqrt(torch.clamp_min(w @ self.Sigma @ w, 1e-18))
        return vol + self.regularization(w)  # reference quirk: no tx penalty here

    def _solve(self, objective, ineq=None):
        return minimize_simplex(objective, self.n_assets, ineq, device=self.device,
                                dtype=self.dtype)

    def _finish(self, res: SolveResult):
        w = res.weights.cpu().numpy()
        self.set_previous_weights(w)
        return w

    def optimize_portfolio(self):
        self._require_predictions()
        return self._finish(self._solve(self.objective))

    def maximize_returns(self, max_volatility):
        self._require_predictions()
        ineq = lambda w: max_volatility - torch.sqrt(torch.clamp_min(w @ self.Sigma @ w, 1e-18))
        return self._finish(self._solve(self.returns_objective, ineq))

    def minimize_uncertainty(self, min_return):
        self._require_predictions()
        ineq = lambda w: self.mu @ w - min_return
        return self._finish(self._solve(self.uncertainty_objective, ineq))

    def calculate_portfolio_performance(self, weights):
        w = self._t(weights)
        ret = float(self.mu @ w)
        vol = float(torch.sqrt(torch.clamp_min(w @ self.Sigma @ w, 0.0)))
        return ret, vol
