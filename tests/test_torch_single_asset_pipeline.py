"""The port's single-asset pipeline, `StockPredictor.run_ticker`, end to
end against the JAX package's, float64 on the CPU on both sides.

Tolerances: the L-BFGS runs round differently and stop at ftol, so α and β
agree to atol 1e-6 and the blended means and variances to rtol 1e-4 (as
tests/test_torch_walk_forward.py holds the walk-forward's means) with atol
1e-5 on these unit-scale (z-scored) values, where the horizon's means
decay toward zero.
"""

import numpy as np
import pytest
import torch

from chip_smoke import make_single_asset_market
from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.pipelines.single_asset import StockPredictor as JStockPredictor
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch.pipelines import StockPredictor as TStockPredictor

# one intra-op thread per test worker avoids oversubscribing the CPU when
# pytest-xdist runs several workers
torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64)
SHORT_DATES = dict(train_start_date="2024-02-01", train_end_date="2024-05-10",
                   test_start_date="2024-05-13", test_end_date="2024-05-17")


@pytest.fixture(scope="module")
def short_market(tmp_path_factory):
    return make_single_asset_market(str(tmp_path_factory.mktemp("sa")), seed=11,
                                    first="2024-02-01", last="2024-05-31")


def test_torch_run_ticker_matches_jax(short_market):
    """`StockPredictor.run_ticker` in float64 on the CPU against the JAX
    one on the market of tests/test_pipelines.py's window (72 daily rows),
    with weekly and monthly bars dated by their last trading day; the menu
    is entries 1 and 6 of the default menu (SE, and the Exponential +
    Periodic(SE) + Linear sum, which wins the daily and weekly timescales
    here). Each menu entry costs the JAX side a fresh trace and compile of
    its L-BFGS loop per timescale, which is why the menu is short."""
    picks = (0, 5)
    kw = dict(data_root=short_market, horizon_days=30, **SHORT_DATES)
    jres = JStockPredictor(["TGT"], kernel_menu=[jk.default_kernel_menu()[i] for i in picks],
                           **kw).run_ticker("TGT")
    tres = TStockPredictor(["TGT"], kernel_menu=[tk.default_kernel_menu(**CPU64)[i]
                                                 for i in picks], **kw, **CPU64).run_ticker("TGT")
    for tag in "dwm":
        assert tres.timeframes[tag].kernel_index == jres.timeframes[tag].kernel_index, tag
    assert tres.timeframes["d"].X.shape[0] == jres.timeframes["d"].X.shape[0] == 72
    np.testing.assert_allclose([tres.alpha, tres.beta], [jres.alpha, jres.beta], atol=1e-6)
    for got, want in ((tres.f_mean, jres.f_mean), (tres.f_var, jres.f_var),
                      (tres.X_combined_daily, jres.X_combined_daily)):
        assert got.shape == want.shape
        assert np.all(np.isfinite(got.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
