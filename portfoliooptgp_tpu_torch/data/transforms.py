"""Feature engineering (GPR/data_handler.py + utils/data_handler.py parity).

Semantics preserved:
- `return` = close.pct_change() with the first NaN back-filled from the first
  real return (GPR/data_handler.py:35-38);
- `intraday_return` = (close − open)/open (:38);
- `daily_log_return` = log(close/close.shift(1)) with ±inf→0
  (utils/data_handler.py:90-91);
- z-score normalization in two flavors: Y-only (GPR/data_handler.py:55-65,
  X stays the raw day index) and X&Y (utils/data_handler.py:160-179);
- sliding-window denoise = centered rolling mean, min_periods=1 (:38-49);
- gaussian filter σ=1 (:102-103).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch
from scipy.ndimage import gaussian_filter


def add_return_columns(df: pd.DataFrame) -> pd.DataFrame:
    df = df.copy()
    df["return"] = df["close"].pct_change()
    if len(df) > 1:
        df.fillna({"return": df["return"].iloc[1]}, inplace=True)
    df["intraday_return"] = (df["close"] - df["open"]) / df["open"]
    df["daily_log_return"] = np.log(df["close"] / df["close"].shift(1))
    df["daily_log_return"] = df["daily_log_return"].replace([np.inf, -np.inf], 0.0)
    return df


def sliding_window_denoise(series: pd.Series, window_size: int, function=np.mean) -> pd.Series:
    denoised = series.rolling(window=window_size, center=True, min_periods=1).apply(function)
    return denoised.ffill().bfill()


def gaussian_smooth(values, sigma: float = 1.0):
    return gaussian_filter(np.asarray(values, dtype=float), sigma=sigma)


def zscore(values):
    """Returns (normalized, mean, std) using pandas' ddof=1 std for parity
    with df.std() (GPR/data_handler.py:56-57)."""
    v = np.asarray(values, dtype=float)
    mean = float(np.mean(v))
    std = float(np.std(v, ddof=1))
    return (v - mean) / std, mean, std


def denormalize(values, mean, std):
    """Undo `zscore`: a tensor stays a tensor on its device, anything else
    becomes a float64 numpy array."""
    if not isinstance(values, torch.Tensor):
        values = np.asarray(values, dtype=float)
    return values * std + mean


def denormalize_variance(var, std):
    """A variance of z-scored values in the original units."""
    if not isinstance(var, torch.Tensor):
        var = np.asarray(var, dtype=float)
    return var * std**2
