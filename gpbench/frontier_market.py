"""The input generator of the ICM frontier cell: config 5's market.

`write_market` is a frozen copy of `benchmarks/bench_frontier.make_assets`
(kept here so that no later change to the JAX package's benchmarks can move
the yardstick): business days `first`..`last`, three shared random-walk
drivers and, for each of `n_assets` assets ASnn, a log close that loads on
them (loadings N(0, 0.6²) plus 0.8 on the first) plus an idiosyncratic walk,
written as end-of-day CSV files under `<root>/Stocks/ASnn/`.

`frontier_data` reads them back through the program's `DataHandler` and
`frontier_pipeline.frontier_inputs`, as `run_frontier_pipeline` does, in
float64 on the CPU: the cell casts them to the program's dtype and the
reference takes them as they are.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import pandas as pd


def write_market(root: str, first: str, last: str, seed: int = 11, n_assets: int = 20):
    """The market's CSV files under `root`; returns the asset names."""
    rng = np.random.default_rng(seed)
    days = pd.bdate_range(first, last)
    n = len(days)
    drivers = np.cumsum(0.01 * rng.normal(size=(n, 3)), axis=0)
    names = [f"AS{i:02d}" for i in range(n_assets)]
    for t in names:
        beta = rng.normal(scale=0.6, size=3) + np.array([0.8, 0.0, 0.0])
        close = 100 * np.exp(drivers @ beta + np.cumsum(0.004 * rng.normal(size=n)))
        d = os.path.join(root, "Stocks", t)
        os.makedirs(d, exist_ok=True)
        pd.DataFrame({
            "date": days.strftime("%Y-%m-%d"),
            "open": close * 0.998, "high": close * 1.01, "low": close * 0.99,
            "close": close, "adjusted_close": close, "volume": 1_000_000,
        }).to_csv(os.path.join(d, f"{t}_us_d.csv"), index=False)
    return names


def frontier_data(first: str, last: str, seed: int = 11, n_assets: int = 20):
    """(X (N, 1), Y (N, P)) float64 CPU tensors: the scaled day index and
    every asset's daily returns on the shared grid, as the program's
    `frontier_inputs` makes them from the market's files (written to a
    temporary directory and removed)."""
    import torch

    from portfoliooptgp_tpu_torch.data.handler import DataHandler
    from portfoliooptgp_tpu_torch.pipelines.frontier_pipeline import frontier_inputs

    with tempfile.TemporaryDirectory() as root:
        names = write_market(root, first, last, seed, n_assets)
        dh = DataHandler(train_start_date=first, train_end_date=last, test_start_date=last,
                         test_end_date=last, data_root=root, device="cpu", dtype=torch.float64)
        X, Y, _ = frontier_inputs(names, dh, device="cpu", dtype=torch.float64)
    return X, Y
