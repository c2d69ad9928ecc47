#!/usr/bin/env python3
"""Write tests/goldens_torch/single_asset_2021_2024.json: the JAX package's
single-asset pipeline (`StockPredictor.run_ticker`) in float64 on the CPU,
on the seeded market of `chip_smoke.make_single_asset_market`, with the
8-entry `default_kernel_menu()`, frozen σ² = 1e-5, maxiter 100,
predict_Y="return", the Zero mean and a 30-day horizon.

`chip_smoke.py` holds the PyTorch port's float32 run on the card against
this file. Run from the repository root (takes a few minutes):

    JAX_PLATFORMS=cpu python tools/make_torch_goldens.py

With `--float32` it runs the same pipeline with x64 off (the JAX package's
float32) and writes tests/goldens_torch/single_asset_2021_2024_f32.json in
the same format. `chip_smoke.compare_single_asset` holds a menu entry
against it only where JAX's own float32 run departs from its float64 run
(menu entry 6, Linear on the raw day index, is indefinite in float32).

It records, per timescale, N, the tier the JAX router would take for each
menu entry in float32 (`gpr.nll_tier` on float32 copies), every entry's
train MSE, final loss and loss before training, and the winner; then α,
β and the blended posterior (f_mean, f_var) over the training days and
the horizon.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
FLOAT32 = "--float32" in sys.argv[1:]
jax.config.update("jax_enable_x64", not FLOAT32)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from chip_smoke import (  # noqa: E402
    SINGLE_ASSET_DATES,
    SINGLE_ASSET_GOLDENS,
    SINGLE_ASSET_GOLDENS_F32,
    SINGLE_ASSET_TICKER,
    make_single_asset_market,
)
from portfoliooptgp_tpu.kernels import default_kernel_menu  # noqa: E402
from portfoliooptgp_tpu.models import gpr  # noqa: E402
from portfoliooptgp_tpu.pipelines import single_asset  # noqa: E402
from portfoliooptgp_tpu.train import trainer  # noqa: E402

SEED = 3


def main() -> int:
    menus = {}
    real = trainer.train_best_model

    def recording(X, Y, menu, **kw):
        res = real(X, Y, menu, **kw)
        f32 = [gpr.nll_tier(jax.tree.map(lambda x: jnp.asarray(x, jnp.float32)[None],
                                         gpr.GPR.create(k, kw["noise_variance"])),
                            X.astype(jnp.float32), Y.astype(jnp.float32), fast=True)
               for k in default_kernel_menu()]
        start = [float(gpr.neg_log_marginal_likelihood(
            gpr.GPR.create(k, kw["noise_variance"]), X, Y)) for k in default_kernel_menu()]
        menus[int(X.shape[0])] = dict(n=int(X.shape[0]), best_index=res.best_index,
                                      mses=res.mses, losses=res.losses, start_losses=start,
                                      tiers_f32=f32)
        return res

    single_asset.trainer.train_best_model = recording
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        make_single_asset_market(root, SEED)
        sp = single_asset.StockPredictor([SINGLE_ASSET_TICKER], data_root=root,
                                         horizon_days=30, **SINGLE_ASSET_DATES)
        res = sp.run_ticker(SINGLE_ASSET_TICKER)
    elapsed = time.perf_counter() - t0
    single_asset.trainer.train_best_model = real
    timescales = {tag: menus[int(r.X.shape[0])] for tag, r in res.timeframes.items()}
    n_daily = int(res.timeframes["d"].X.shape[0])
    out = dict(
        source=(f"JAX StockPredictor.run_ticker, {'float32' if FLOAT32 else 'float64'}, CPU "
                "(tools/make_torch_goldens.py)"),
        seed=SEED, ticker=SINGLE_ASSET_TICKER, dates=SINGLE_ASSET_DATES,
        maxiter=100, noise_variance=1e-5, horizon_days=30, seconds=elapsed,
        timescales=timescales, alpha=res.alpha, beta=res.beta, n_daily=n_daily,
        Y_daily=np.asarray(res.timeframes["d"].Y).reshape(-1).tolist(),
        f_mean=np.asarray(res.f_mean).reshape(-1).tolist(),
        f_var=np.asarray(res.f_var).reshape(-1).tolist(),
    )
    path = SINGLE_ASSET_GOLDENS_F32 if FLOAT32 else SINGLE_ASSET_GOLDENS
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    for tag, t in timescales.items():
        print(tag, t["n"], "winner", t["best_index"], "tiers", t["tiers_f32"])
        print("   mses", t["mses"])
        print("   losses", t["losses"])
    print("alpha", res.alpha, "beta", res.beta, f"{elapsed:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
