"""Allocation strategies. Port of portfoliooptgp_tpu/portfolio/strategies.py.

- constant: uniform weights every day
- sharpe: maximize the Sharpe ratio
- max_return: maximize return under a volatility cap
- min_volatility: minimize volatility under a return floor
- dynamic: expected-return regime switch with a transaction-cost-aware
  revert, or (decision="prob_threshold") the Monte-Carlo variant
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

from portfoliooptgp_tpu_torch.portfolio.montecarlo import probability_a_greater_than_b_mvnorm
from portfoliooptgp_tpu_torch.portfolio.optimizer import PortfolioOptimizer


class Strategy(ABC):
    def __init__(self, broker_fee: float = 0.0, apply_broker_fee: bool = False):
        self.broker_fee = broker_fee
        self.apply_broker_fee_flag = apply_broker_fee

    def apply_broker_fee(self, weights):
        if self.apply_broker_fee_flag and self.broker_fee > 0:
            return weights * (1.0 - self.broker_fee)
        return weights

    @abstractmethod
    def optimize(self, optimizer: PortfolioOptimizer, max_volatility, min_return, **kw):
        ...


class ConstantStrategy(Strategy):
    def optimize(self, optimizer, max_volatility, min_return, **kw):
        n = optimizer.n_assets
        return np.full(n, 1.0 / n)


class SharpeRatioStrategy(Strategy):
    def optimize(self, optimizer, max_volatility, min_return, **kw):
        return optimizer.optimize_portfolio()


class MaxReturnStrategy(Strategy):
    def optimize(self, optimizer, max_volatility, min_return, **kw):
        return optimizer.maximize_returns(max_volatility=max_volatility)


class MinVolatilityStrategy(Strategy):
    def optimize(self, optimizer, max_volatility, min_return, **kw):
        return optimizer.minimize_uncertainty(min_return=min_return)


class DynamicStrategy(Strategy):
    """Regime switch on the expected return under the previous weights:

    - day 0 (mu_A is None): maximize returns under the volatility cap;
    - E[r_prev·w_prev] < E[r_pred·w_prev]: maximize returns;
    - else minimize uncertainty with floor E_B − E_A, then revert to the
      previous weights if transaction costs eat the (non-positive) gain
      (a reference quirk kept verbatim: the revert fires whenever tx > 0).

    decision="prob_threshold": estimate P(B > A) with 10k MC samples and
    chase returns when it clears `prob_threshold`, else hold."""

    def __init__(self, broker_fee: float = 0.0, apply_broker_fee: bool = False,
                 decision: str = "expected_return", mesh=None):
        super().__init__(broker_fee, apply_broker_fee)
        if decision not in ("expected_return", "prob_threshold"):
            raise ValueError(f"unknown dynamic decision rule: {decision!r}")
        if mesh is not None:
            raise NotImplementedError(
                "the mesh-sharded MC estimate is not ported yet: ROADMAP.md "
                "queue 1: parallel/")
        self.decision = decision

    def optimize(self, optimizer, max_volatility, min_return, mu_A=None, cov_A=None,
                 mu_B=None, cov_B=None, previous_weights=None, broker_fee: float = 0.001,
                 prob_threshold: float = 0.5, num_samples: int = 10_000, seed: int = 0,
                 **kw):
        if mu_A is None:
            return optimizer.maximize_returns(max_volatility)

        if self.decision == "prob_threshold":
            prob = probability_a_greater_than_b_mvnorm(
                mu_B, cov_B, mu_A, cov_A, num_samples=num_samples, seed=seed,
                device=optimizer.device, dtype=optimizer.dtype)
            if prob >= prob_threshold:
                return optimizer.maximize_returns(max_volatility)
            return np.asarray(previous_weights, dtype=float)

        mu_A = np.asarray(mu_A, dtype=float)
        mu_B = np.asarray(mu_B, dtype=float)
        prev = np.asarray(previous_weights, dtype=float)
        expected_A = float(mu_A @ prev)
        expected_B = float(mu_B @ prev)
        if expected_A < expected_B:
            return optimizer.maximize_returns(max_volatility)
        w = optimizer.minimize_uncertainty(expected_B - expected_A)
        tx = float(np.sum(broker_fee * np.abs(w - prev)))
        if expected_B - expected_A - tx > 0:
            return w
        optimizer.set_previous_weights(prev)
        return prev


STRATEGY_REGISTRY = {
    "constant": ConstantStrategy,
    "sharpe": SharpeRatioStrategy,
    "max_return": MaxReturnStrategy,
    "min_volatility": MinVolatilityStrategy,
    "dynamic": DynamicStrategy,
}
