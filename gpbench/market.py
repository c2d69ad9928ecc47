"""Input generators of the benchmark: the data each cell hands the program.

Both are frozen copies, kept here so that no later change to the program or
to the JAX package's benchmarks can move the yardstick:

- `walk_forward_universe`: the two-factor market of
  `benchmarks/bench_portfolio_e2e.make_market`, stretched to a longer
  business-day range and to any number of assets, returned as the arrays
  the multi-input walk-forward trains on (z-scored covariate returns plus
  the calendar-day index, z-scored; the asset's z-scored return as target).
- `nuts_posterior_data`: bench.py's NUTS posterior data, X uniform on
  [0, 60)^4 and Y a smooth function of three inputs plus 0.1·N(0, 1), from
  `np.random.default_rng(0)`.

Everything is float64 numpy; the cells cast to the program's dtype.
"""

from __future__ import annotations

import numpy as np

# (factor-1 loading, factor-2 loading, idiosyncratic volatility) of the
# covariates that make_market's |rho| > 0.30 gate keeps (its sixth, RNDX,
# is uncorrelated and dropped): Brent_Oil, XAU_USD, SP500, NasDaq100, MACR.
COVARIATES = ((1.0, 0.0, 0.003), (0.0, 1.0, 0.003), (0.8, 0.5, 0.002),
              (0.9, 0.3, 0.002), (0.5, 0.8, 0.003))


def _zscore(v):
    """(v − mean) / std with pandas' ddof=1, as the port's data handler."""
    return (v - v.mean()) / v.std(ddof=1)


def walk_forward_universe(seed: int, n_rows: int, n_assets: int):
    """X (n_rows, 6): five z-scored covariate return series and the
    z-scored calendar-day index of n_rows business days starting on a
    Monday; Y (n_assets, n_rows): each asset's z-scored daily return. Asset
    i loads (0.5 + 0.05 i, 0.9 − 0.05 i) on the two factors with
    idiosyncratic volatility 0.004, make_market's spread of loadings
    continued over the universe."""
    rng = np.random.default_rng(seed)
    n = n_rows + 1  # one more price than returns
    drv1 = np.cumsum(0.010 * rng.normal(size=n))
    drv2 = np.cumsum(0.008 * rng.normal(size=n))

    def returns(b1, b2, idio):
        price = 100.0 * np.exp(b1 * drv1 + b2 * drv2 + np.cumsum(idio * rng.normal(size=n)))
        return _zscore(price[1:] / price[:-1] - 1.0)

    k = np.arange(n_rows)
    days = k + 2 * (k // 5)  # calendar days since the first Monday
    X = np.column_stack([returns(*c) for c in COVARIATES] + [_zscore(days.astype(float))])
    Y = np.stack([returns(0.5 + 0.05 * i, 0.9 - 0.05 * i, 0.004) for i in range(n_assets)])
    return X, Y


def nuts_posterior_data(n: int = 512, d: int = 4):
    """bench.py's X (n, d) and Y (n, 1), computed in float32 as bench.py
    does and returned as float64."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 60, (n, d)).astype(np.float32)
    f = (np.sin(X[:, 0] / np.float32(8.0)) + np.float32(0.3) * np.cos(X[:, 1] / np.float32(5.0))
         + np.float32(0.05) * X[:, 2] / np.float32(10.0))
    Y = (f + np.float32(0.1) * rng.normal(size=(n,)).astype(np.float32))[:, None]
    return X.astype(np.float64), Y.astype(np.float64)
