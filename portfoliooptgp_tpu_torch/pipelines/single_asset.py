"""Single-asset multi-timescale pipeline — the `StockPredictor.run`
workflow (GPR/main.py:22-86).

Port of portfoliooptgp_tpu/pipelines/single_asset.py. Per ticker: daily,
weekly and monthly data → kernel-menu training per timescale (each entry
with σ² = 1e-5 frozen, maxiter 100, winner by train MSE) → per-timescale
posterior predictions → weekly/monthly upsampled to the daily grid → (α, β)
blend weights → future-date grids → the blended prediction with 95% bands.

Everything runs on `device` in `dtype` (default "cuda", float32). With
`fast` (default: the device is CUDA) each menu entry trains through the
NLL router, so the daily history (512 < padded N ≤ 1024) runs the blocked
tier's panel kernel and the weekly and monthly ones the fused tiers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch

from portfoliooptgp_tpu_torch.data.handler import DataHandler
from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, resolve_device
from portfoliooptgp_tpu_torch.kernels import default_kernel_menu
from portfoliooptgp_tpu_torch.params import tree_to
from portfoliooptgp_tpu_torch.pipelines import blend as blend_mod
from portfoliooptgp_tpu_torch.train import trainer


@dataclass
class TimeframeResult:
    X: torch.Tensor
    Y: torch.Tensor
    dates: object
    y_stats: tuple
    model: object  # the winning GPR, batch axis 1
    kernel_index: int
    mse: float
    menu: trainer.MenuResult


@dataclass
class SingleAssetResult:
    ticker: str
    timeframes: Dict[str, TimeframeResult]
    alpha: float
    beta: float
    X_combined_daily: torch.Tensor
    f_mean: torch.Tensor
    f_var: torch.Tensor
    y_mean: torch.Tensor
    y_var: torch.Tensor

    def confidence_bands(self, which="f"):
        mean, var = (self.f_mean, self.f_var) if which == "f" else (self.y_mean, self.y_var)
        sd = torch.sqrt(torch.clamp_min(var, 0.0))
        return mean - 1.96 * sd, mean + 1.96 * sd


class StockPredictor:
    """GPR/main.py:12-86 orchestrator. `kernel_menu` is a list of kernels
    or None for `default_kernel_menu()`; `mean_function` is trained jointly
    (the script workloads' Polynomial(2) and Linear means)."""

    def __init__(
        self,
        tickers: Sequence[str],
        train_start_date: str,
        train_end_date: str,
        test_start_date: str,
        test_end_date: str,
        kernel_menu: Optional[Sequence] = None,
        lambda_: float = 0.01,
        predict_Y: str = "return",
        data_root: str = ".",
        maxiter: int = 100,
        noise_variance: float = 1e-5,
        horizon_days: int = 30,
        plot_fn: Optional[Callable] = None,
        mean_function=None,
        *,
        device=DEFAULT_DEVICE,
        dtype=DEFAULT_DTYPE,
        fast: Optional[bool] = None,
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.tickers = list(tickers)
        self.data_handler = DataHandler(
            train_start_date, train_end_date, test_start_date, test_end_date,
            data_root=data_root, device=self.device, dtype=dtype)
        o = dict(device=self.device, dtype=dtype)
        self.kernel_menu_fn = ((lambda: [tree_to(k, **o) for k in kernel_menu])
                               if kernel_menu is not None
                               else (lambda: default_kernel_menu(**o)))
        self.lambda_ = lambda_
        self.predict_Y = predict_Y
        self.maxiter = maxiter
        self.noise_variance = noise_variance
        self.horizon_days = horizon_days
        self.plot_fn = plot_fn
        self.mean_function = mean_function
        self.fast = fast

    def _train_timeframe(self, ticker: str, timeframe: str) -> TimeframeResult:
        X, Y, dates, y_stats, _ = self.data_handler.process_data(
            "Stocks", ticker, timeframe, predict_Y=self.predict_Y, normalize_x=False)
        res = trainer.train_best_model(
            X, Y, self.kernel_menu_fn(), noise_variance=self.noise_variance,
            maxiter=self.maxiter, mean_function=self.mean_function, fast=self.fast)
        return TimeframeResult(X=X, Y=Y, dates=dates, y_stats=y_stats,
                               model=res.best.model, kernel_index=res.best_index,
                               mse=float(res.best.mse), menu=res)

    def run_ticker(self, ticker: str, timeframes=("d", "w", "m")) -> SingleAssetResult:
        tf_results = {t: self._train_timeframe(ticker, t) for t in timeframes}
        d, w, m = (tf_results[t] for t in ("d", "w", "m"))

        # in-sample single predictions for the blend fit (GPR/main.py:47-56)
        f_d, *_ = blend_mod.predict_single(d.model, d.X, d.Y, d.X)
        f_w, *_ = blend_mod.predict_single(w.model, w.X, w.Y, w.X)
        f_m, *_ = blend_mod.predict_single(m.model, m.X, m.Y, m.X)
        f_w_up = blend_mod.upsample_predictions(d.X, w.X, f_w, period="w")
        f_m_up = blend_mod.upsample_predictions(d.X, m.X, f_m, period="m")
        weights = blend_mod.optimize_blend_weights(d.Y, f_d, f_w_up, f_m_up, lambda_=self.lambda_)

        # horizon grids per timescale (GPR/main.py:60-66)
        combined = {}
        for tag, r in (("d", d), ("w", w), ("m", m)):
            fut = self.data_handler.generate_future_dates(
                ticker, tag, self.horizon_days, file_type="Stocks")
            combined[tag] = torch.cat([r.X, fut], dim=0)

        f_mean, f_var, y_mean, y_var = blend_mod.predict_combined(
            weights.alpha, weights.beta, d.model, w.model, m.model,
            (d.X, d.Y), (w.X, w.Y), (m.X, m.Y),
            combined["d"], combined["w"], combined["m"])
        result = SingleAssetResult(
            ticker=ticker, timeframes=tf_results, alpha=weights.alpha, beta=weights.beta,
            X_combined_daily=combined["d"], f_mean=f_mean, f_var=f_var,
            y_mean=y_mean, y_var=y_var)
        if self.plot_fn is not None:
            self.plot_fn(result)
        return result

    def run(self, timeframes=("d", "w", "m")) -> Dict[str, SingleAssetResult]:
        return {t: self.run_ticker(t, timeframes) for t in self.tickers}
