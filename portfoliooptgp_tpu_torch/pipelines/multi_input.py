"""Multi-input GPR pipeline (Multi-Input_GPR/main.py).

Port of portfoliooptgp_tpu/pipelines/multi_input.py: correlation-gated
covariate selection, composite feature×time kernels and the four steps —

- step 1: in-sample fit on [covariates..., time];
- step 2: refit with `removal_percentage` rows removed, MSE on them;
- step 3: train+test horizon prediction, the last 5 days;
- step 4: walk-forward daily retraining, as one batched L-BFGS over the
  test days (`batched=True`, feeding the portfolio layer) or the literal
  day-by-day loop (`batched=False`) —

plus the ARIMA baseline. Each fit trains the model of every kernel pair
and keeps the last (the reference's last-wins quirk), with σ² frozen under
`isFixedLikelihood`, else by `trainer.train_likelihood`'s restarts.
Reference quirks kept: steps 1–2 gate covariates on close prices, steps
3–4 on `predict_Y`; step 3's MSE runs over train and test (main.py:340).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from portfoliooptgp_tpu_torch.data.handler import DataHandler
from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, as_tensor, resolve_device
from portfoliooptgp_tpu_torch.kernels import Exponential, composite_kernel
from portfoliooptgp_tpu_torch.models import arima as arima_mod
from portfoliooptgp_tpu_torch.models import gpr as gpr_mod
from portfoliooptgp_tpu_torch.models.gpr import GPR
from portfoliooptgp_tpu_torch.train import trainer

COMMODITY_FEATURES = {"Brent_Oil", "DXY", "XAU_USD"}
INDEX_FEATURES = {"SP500", "NasDaq100", "DJI", "RUT2000"}


def correlation(a, b) -> float:
    """Pearson correlation of two flattened series."""
    a = np.asarray(a, dtype=float).reshape(-1)
    b = np.asarray(b, dtype=float).reshape(-1)
    return float(np.corrcoef(np.stack([a, b]))[0, 1])


def full_correlations(X, Y=None) -> np.ndarray:
    """Full correlation matrix of [X columns (, Y)]."""
    X = np.asarray(X, dtype=float)
    if Y is not None:
        X = np.column_stack([X, np.asarray(Y, dtype=float).reshape(-1)])
    return np.corrcoef(X.T)


def remove_random_points(X, Y, removal_percentage: float, seed: int = 0):
    """(X_kept, Y_kept, X_removed, Y_removed, mask) of numpy arrays
    (Multi-Input_GPR/main.py:96-115)."""
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    k = int(n * removal_percentage)
    mask = np.ones(n, dtype=bool)
    mask[rng.choice(n, size=k, replace=False)] = False
    return X[mask], Y[mask], X[~mask], Y[~mask], mask


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclass
class StepPrediction:
    f_mean: np.ndarray
    f_var: np.ndarray
    actual: np.ndarray
    Y_train: np.ndarray


class MultiInputGPR:
    def __init__(
        self,
        ticker: str,
        features: Sequence[str],
        train_start_date: str,
        train_end_date: str,
        test_start_date: str,
        test_end_date: str,
        kernel_pairs: Optional[Sequence] = None,
        threshold: float = 0.30,
        removal_percentage: float = 0.1,
        window_size: int = 3,
        predict_Y: str = "return",
        isFixedLikelihood: bool = True,
        noise_variance: float = 1e-3,
        data_root: str = ".",
        maxiter: int = 1000,
        verbose: bool = False,
        seed: int = 0,
        *,
        device=DEFAULT_DEVICE,
        dtype=DEFAULT_DTYPE,
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.ticker = ticker
        self.features = list(features)
        self.kernel_pairs = list(kernel_pairs) if kernel_pairs else [(Exponential, Exponential)]
        self.threshold = threshold
        self.removal_percentage = removal_percentage
        self.predict_Y = predict_Y
        self.isFixed = isFixedLikelihood
        self.noise_variance = noise_variance
        self.maxiter = maxiter
        self.verbose = verbose
        self.seed = seed
        self.train_start_date = train_start_date
        self.train_end_date = train_end_date
        self.test_start_date = test_start_date
        self.test_end_date = test_end_date
        self.data_handler = DataHandler(
            train_start_date, train_end_date, test_start_date, test_end_date,
            window_size=window_size, data_root=data_root, device=self.device,
            dtype=dtype,
        )

    def _log(self, *a):
        if self.verbose:
            print(*a)

    def _file_type(self, feature: str) -> str:
        if feature in COMMODITY_FEATURES:
            return "Commodities"
        if feature in INDEX_FEATURES:
            return "Stocks/Index"
        return "Stocks"

    def _load_target(self, end_date: str, predict_Y: Optional[str] = None):
        return self.data_handler.process_data(
            "Stocks", self.ticker, "d", self.train_start_date, end_date,
            predict_Y=predict_Y or self.predict_Y,
        )

    def _gather_features(self, target_Y, target_stats, end_date: str,
                         predict_Y: str = "close"):
        """Correlation-gated covariate columns: keep a feature iff
        |corr(denormalized feature, denormalized target)| > threshold."""
        y_mean, y_std = target_stats
        cols, kept = [], []
        for feature in self.features:
            X_f, Y_f, _, (fm, fs), _ = self.data_handler.process_data(
                self._file_type(feature), feature, "d", self.train_start_date,
                end_date, predict_Y=predict_Y,
            )
            corr = correlation(_host(Y_f) * fs + fm, _host(target_Y) * y_std + y_mean)
            self._log(f"Correlation between {feature} and {self.ticker}: {corr:.4f}")
            if abs(corr) > self.threshold:
                cols.append(_host(Y_f))
                kept.append(feature)
        return cols, kept

    def _build_inputs(self, end_date: str, predict_Y_features: str = "close",
                      target_predict_Y: Optional[str] = None,
                      kept: Optional[Sequence[str]] = None):
        """X = [covariates..., time]. With `kept`, load exactly those
        features without re-gating (the gate runs once, on the train
        window)."""
        X_t, Y_t, dates, y_stats, x_stats = self._load_target(end_date, target_predict_Y)
        if kept is None:
            cols, kept = self._gather_features(Y_t, y_stats, end_date, predict_Y_features)
        else:
            cols = []
            for feature in kept:
                _, Y_f, *_ = self.data_handler.process_data(
                    self._file_type(feature), feature, "d",
                    self.train_start_date, end_date, predict_Y=predict_Y_features,
                )
                cols.append(_host(Y_f))
            kept = list(kept)
        cols.append(_host(X_t))
        X = self.data_handler.concatenate_X(cols)
        return as_tensor(X, self.device, self.dtype), Y_t, dates, y_stats, x_stats, kept

    def _train(self, X, Y) -> GPR:
        """Kernel-pair loop, the last model wins (main.py:419-430 quirk)."""
        model = None
        for k1, k2 in self.kernel_pairs:
            kern = composite_kernel(X.shape[1], k1, k2, device=self.device, dtype=self.dtype)
            if self.isFixed:
                m0 = GPR.create(kern, noise_variance=self.noise_variance)
                model = trainer.train_model(m0, X, Y, maxiter=self.maxiter).model
            else:
                model = trainer.train_likelihood(X, Y, kern, maxiter=self.maxiter).model
        return model

    def _predict(self, model, X, Y, Xnew):
        """Posterior (f_mean, f_var) of one model, each (M, 1)."""
        with torch.no_grad():
            f_mean, f_var = gpr_mod.predict_f(model, X, Y, Xnew)
        return f_mean[0], f_var[0]

    # -- step 1: in-sample fit (main.py:137-192) -------------------------
    def run_step_1(self):
        X, Y, _, y_stats, _, kept = self._build_inputs(self.train_end_date)
        model = self._train(X, Y)
        f_mean, f_var = self._predict(model, X, Y, X)
        mse = float(torch.mean((f_mean - Y) ** 2))
        self._log(f"Mean Squared Error: {mse:.4f}")
        return {
            "model": model, "X": X, "Y": Y, "f_mean": f_mean, "f_var": f_var,
            "mse": mse, "kept_features": kept, "y_stats": y_stats,
        }

    # -- step 2: robustness with removed points (main.py:194-263) --------
    def run_step_2(self):
        X, Y, _, _, _, _ = self._build_inputs(self.train_end_date)
        Xr, Yr, Xrm, Yrm, mask = remove_random_points(
            _host(X), _host(Y), self.removal_percentage, self.seed)
        Xr, Yr = as_tensor(Xr, self.device, self.dtype), as_tensor(Yr, self.device, self.dtype)
        model = self._train(Xr, Yr)
        f_mean, _ = self._predict(model, Xr, Yr, X)
        mse_all = float(torch.mean((f_mean - Y) ** 2))
        mse_removed = float(np.mean((_host(f_mean)[~mask] - Yrm) ** 2))
        self._log(f"MSE all: {mse_all:.4f}, MSE removed: {mse_removed:.4f}")
        return {
            "model": model, "mse_all": mse_all, "mse_removed": mse_removed,
            "X_removed": Xrm, "Y_removed": Yrm,
        }

    # -- step 3: horizon prediction (main.py:267-353) --------------------
    def run_step_3(self, horizon_tail: int = 5):
        # covariates over the train window with the target's predict_Y
        # (main.py:283-295), unlike steps 1-2, which use close prices
        X, Y, _, _, _, kept = self._build_inputs(
            self.train_end_date, predict_Y_features=self.predict_Y)
        Xf, Yf, _, yf_stats, _, _ = self._build_inputs(
            self.test_end_date, predict_Y_features=self.predict_Y,
            target_predict_Y=self.predict_Y, kept=kept)
        model = self._train(X, Y)
        f_mean, f_var = self._predict(model, X, Y, Xf)
        mse = float(torch.mean((f_mean - Yf) ** 2))
        self._log(f"MSE normalized (train+test, main.py:340 quirk): {mse:.4f}")
        yf_mean, yf_std = yf_stats
        return StepPrediction(
            f_mean=_host(f_mean[-horizon_tail:]) * yf_std + yf_mean,
            f_var=_host(f_var[-horizon_tail:]) * yf_std**2,
            actual=_host(Yf[-horizon_tail:]) * yf_std + yf_mean,
            Y_train=_host(Y),
        )

    # -- step 4: walk-forward retraining (main.py:356-459) ---------------
    def run_step_4(self, batched: bool = True):
        """Walk-forward daily retraining over the test window: every day's
        refit as one batched L-BFGS (`batched_walk_forward`), or with
        batched=False the literal day-by-day loop of `_train`."""
        X, Y, _, _, _, kept = self._build_inputs(
            self.train_end_date, predict_Y_features=self.predict_Y)
        # full-window loads use 'return' for target and covariates
        Xf, Yf, _, yf_stats, _, _ = self._build_inputs(
            self.test_end_date, predict_Y_features="return",
            target_predict_Y="return", kept=kept)
        n_train, n_full = Y.shape[0], Yf.shape[0]
        yf_mean, yf_std = yf_stats
        if batched:
            return self._step_4_batched(Xf, Yf, n_train, yf_mean, yf_std, _host(Y))
        f_means, f_vars, actuals = [], [], []
        for i in range(n_train, n_full):
            model = self._train(Xf[:i], Yf[:i])
            f_mean, f_var = self._predict(model, Xf[:i], Yf[:i], Xf[:i + 1])
            f_means.append(float(f_mean[-1, 0]) * yf_std + yf_mean)
            f_vars.append(float(f_var[-1, 0]) * yf_std**2)
            actuals.append(float(Yf[i, 0]) * yf_std + yf_mean)
            self._log(f"walk-forward day {i - n_train + 1}: f_mean={f_means[-1]:.5f}")
        return StepPrediction(
            f_mean=np.asarray(f_means), f_var=np.asarray(f_vars),
            actual=np.asarray(actuals), Y_train=_host(Y),
        )

    def _step_4_batched(self, Xf, Yf, n_train, yf_mean, yf_std, Y_train):
        """Only the LAST kernel pair is trained: the reference's sequential
        loop keeps the last model of the menu (last-wins quirk)."""
        from portfoliooptgp_tpu_torch.pipelines.walk_forward import batched_walk_forward

        k1, k2 = self.kernel_pairs[-1]

        def make_model(noise_variance):
            kern = composite_kernel(Xf.shape[1], k1, k2, device=self.device,
                                    dtype=self.dtype)
            return GPR.create(kern, noise_variance=noise_variance)

        noise_inits = (self.noise_variance,) if self.isFixed else trainer.STARTING_VARIANCES
        res = batched_walk_forward(
            Xf, Yf, n_train, make_model,
            restart_noise_inits=noise_inits,
            maxiter=self.maxiter,
            train_likelihood_variance=not self.isFixed,
            device=self.device, dtype=self.dtype,
        )
        f_mean, f_var = _host(res.f_mean), _host(res.f_var)
        for j in range(f_mean.shape[0]):
            self._log(f"walk-forward day {j + 1}: f_mean={f_mean[j] * yf_std + yf_mean:.5f}")
        return StepPrediction(
            f_mean=f_mean * yf_std + yf_mean,
            f_var=f_var * yf_std**2,
            actual=_host(Yf[n_train:, 0]) * yf_std + yf_mean,
            Y_train=Y_train,
        )

    def run_arima(self, steps: int = 5, order=(3, 1, 0)):
        df = self.data_handler.process_df(
            "Stocks", self.ticker, "d", self.train_start_date, self.train_end_date, "close")
        df_test = self.data_handler.process_df(
            "Stocks", self.ticker, "d", self.test_start_date, self.test_end_date, "close")
        fc = arima_mod.fit_forecast(df.to_numpy().reshape(-1), order, steps)
        actual = df_test.to_numpy().reshape(-1)[:steps]
        mse = float(np.mean((fc[: len(actual)] - actual) ** 2))
        self._log(f"ARIMA MSE: {mse:.4f}")
        return {"forecast": fc, "actual": actual, "mse": mse}
