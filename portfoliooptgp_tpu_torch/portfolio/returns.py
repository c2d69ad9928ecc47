"""Realized portfolio return / transaction-cost math (Portfolio/returns.py
parity), vectorized.

Semantics preserved exactly:
- asset_returns arrives as [asset][day] nested lists (possibly with trailing
  singleton dims) and is squeezed + transposed to (days, assets)
  (Portfolio/returns.py:18-19);
- day 0 transaction cost charges the full initial allocation from zero
  (:44-46), later days charge fee·Σ|Δw| (:48-50);
- cumulative return is Π(1+r)−1 (:85), cumulative costs are a plain sum (:98).
"""

from __future__ import annotations

import numpy as np


class Return:
    def __init__(self, asset_returns, weights, transaction_cost_rate: float = 0.0):
        asset_returns = np.squeeze(np.asarray(asset_returns, dtype=float)).T
        weights = np.asarray(weights, dtype=float)
        if asset_returns.shape != weights.shape:
            raise ValueError(
                "The shapes of asset_returns and weights must match "
                f"(got {asset_returns.shape} vs {weights.shape})."
            )
        self.asset_returns = asset_returns  # (days, assets)
        self.weights = weights
        self.transaction_cost_rate = transaction_cost_rate

    def calculate_portfolio_returns(self):
        w = self.weights
        gross = np.sum(w * self.asset_returns, axis=1)
        prev = np.vstack([np.zeros((1, w.shape[1])), w[:-1]])
        trx = self.transaction_cost_rate * np.sum(np.abs(w - prev), axis=1)
        net = gross - trx
        return list(net), list(trx)

    def calculate_cumulative_return(self, portfolio_returns=None):
        if portfolio_returns is None:
            portfolio_returns, _ = self.calculate_portfolio_returns()
        return float(np.prod(1.0 + np.asarray(portfolio_returns)) - 1.0)

    def calculate_cumulative_transaction_costs(self, transaction_costs=None):
        if transaction_costs is None:
            _, transaction_costs = self.calculate_portfolio_returns()
        return float(np.sum(transaction_costs))

    def get_daily_transaction_costs(self, transaction_costs=None):
        if transaction_costs is None:
            _, transaction_costs = self.calculate_portfolio_returns()
        return np.asarray(transaction_costs)

    def get_daily_portfolio_returns(self, portfolio_returns=None):
        if portfolio_returns is None:
            portfolio_returns, _ = self.calculate_portfolio_returns()
        return np.asarray(portfolio_returns)


class Volatility:
    """Portfolio volatility under independent assets: √Σ w²σ² per day."""

    def __init__(self, predicted_volatilities, weights):
        self.predicted_volatilities = np.asarray(predicted_volatilities, dtype=float)
        self.weights = np.asarray(weights, dtype=float)

    def calculate_portfolio_volatility(self):
        var = np.sum(self.weights**2 * self.predicted_volatilities**2, axis=1)
        return np.sqrt(var)
