"""DataHandler — the data layer's public surface.

Port of portfoliooptgp_tpu/data/handler.py: `process_data(...)` ->
(X, Y, dates, (y_mean, y_std), (x_mean, x_std)) with X and Y z-scored,
returned as (N, 1) tensors on the handler's device and dtype (the JAX
package returns arrays of its default float type), for daily, weekly and
monthly files alike; `generate_future_dates` gives the horizon grid.
`fetch_and_save_data` downloads a series from EODHD, gated on the
API_TOKEN environment variable; `calculate_entropy` prints the six
ordinal-pattern diagnostics of ops/entropy.py.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import pandas as pd

from portfoliooptgp_tpu_torch.data import calendar as cal
from portfoliooptgp_tpu_torch.data import loader, transforms
from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, as_tensor
from portfoliooptgp_tpu_torch.ops import entropy as entropy_mod


class DataHandler:
    def __init__(self, train_start_date: str, train_end_date: str,
                 test_start_date: str, test_end_date: str, window_size: int = 3,
                 data_root: str = ".", *, device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
        self.train_start_date = train_start_date
        self.train_end_date = train_end_date
        self.test_start_date = test_start_date
        self.test_end_date = test_end_date
        self.window_size = window_size
        self.data_root = data_root
        self.device = device
        self.dtype = dtype

    def fetch_and_save_data(self, ticker: str, period: str, start_date: str, end_date: str):
        """Download `ticker`'s EODHD bars into `<data_root>/Stocks/<ticker>/`;
        needs the API_TOKEN environment variable and the `requests` package."""
        api_token = os.getenv("API_TOKEN")
        if not api_token:
            raise RuntimeError("API_TOKEN not set; run with isFetch=False against local CSVs")
        import requests

        symbol = "BTC-USD.CC" if ticker == "BTC" else f"{ticker}.US"
        url = (
            f"https://eodhd.com/api/eod/{symbol}?period={period}&api_token={api_token}"
            f"&fmt=json&from={start_date}&to={end_date}"
        )
        response = requests.get(url, timeout=30)
        response.raise_for_status()
        df = pd.DataFrame(response.json())
        path = os.path.join(self.data_root, "Stocks", ticker, f"{ticker}_us_{period}.csv")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        df.to_csv(path, index=False)

    def process_data(self, file_type: str, ticker: str, period: str = "d",
                     start_date: Optional[str] = None, end_date: Optional[str] = None,
                     predict_Y: str = "return", normalize: bool = True,
                     isFetch: bool = False, isDenoised: bool = False,
                     isFiltered: bool = False, normalize_x: bool = True,
                     compute_entropy: bool = False):
        start_date = start_date or self.train_start_date
        end_date = end_date or self.train_end_date
        if isFetch:
            self.fetch_and_save_data(ticker, period, start_date, end_date)
        df = loader.load_frame(self.data_root, file_type, ticker, period, start_date, end_date)
        df["day_of_year"] = cal.days_since(df["date"], self.train_start_date)
        df = transforms.add_return_columns(df)
        if isDenoised:
            df["denoised_close"] = transforms.sliding_window_denoise(df["close"], self.window_size)
        if isFiltered:
            df["filtered_close"] = transforms.gaussian_smooth(df["close"].to_numpy())
        if compute_entropy:
            self.calculate_entropy(df["close"].to_numpy())
        return self.normalize_and_reshape(df, y_column=predict_Y, x_column="day_of_year",
                                          normalize=normalize, normalize_x=normalize_x)

    def process_df(self, file_type, ticker, period, start_date, end_date, predict_Y="close"):
        """ARIMA-path frame: day_of_year-indexed single column."""
        df = loader.load_frame(self.data_root, file_type, ticker, period, start_date, end_date)
        df["day_of_year"] = cal.days_since(df["date"], self.train_start_date)
        df = transforms.add_return_columns(df)
        df = df.set_index("day_of_year")
        return df[[predict_Y]]

    def process_2D_X(self, ticker, start_date=None, end_date=None, predict_Y="close"):
        """Stock frame with return/intraday columns, normalized on the chosen
        target: the entry for a 2-D input of (features, time) rather than a
        concatenated multi-asset matrix."""
        start_date = start_date or self.train_start_date
        end_date = end_date or self.train_end_date
        df = loader.load_frame(self.data_root, "Stocks", ticker, "d", start_date, end_date)
        df["day_of_year"] = cal.days_since(df["date"], self.train_start_date)
        df = transforms.add_return_columns(df)
        return self.normalize_and_reshape(df, y_column=predict_Y)

    def normalize_and_reshape(self, df, y_column="return", x_column="day_of_year",
                              normalize=True, normalize_x=True):
        y = df[y_column].to_numpy(dtype=float)
        x = df[x_column].to_numpy(dtype=float)
        if normalize:
            y, y_mean, y_std = transforms.zscore(y)
        else:
            y_mean, y_std = 0.0, 1.0
        if normalize_x:
            x, x_mean, x_std = transforms.zscore(x)
        else:
            x_mean, x_std = 0.0, 1.0
        X = as_tensor(x.reshape(-1, 1), self.device, self.dtype)
        Y = as_tensor(y.reshape(-1, 1), self.device, self.dtype)
        return X, Y, df["date"], (y_mean, y_std), (x_mean, x_std)

    def concatenate_X(self, X: Sequence):
        if not isinstance(X, (list, tuple)):
            raise ValueError("Input X should be a list or tuple of arrays")
        if len(X) < 1:
            raise ValueError("Input X should contain at least one array")
        arrays = [np.asarray(x).reshape(-1, 1) for x in X]
        if not all(a.shape == arrays[0].shape for a in arrays):
            raise ValueError("All input arrays should have the same shape")
        return np.concatenate(arrays, axis=1)

    def calculate_entropy(self, series):
        """Print and return the six entropy diagnostics of `series`."""
        results = entropy_mod.all_measures(np.asarray(series, dtype=float))
        print("Entropy results:")
        for name, value in results.items():
            print(f"{name}: {value}")
        return results

    def generate_future_dates(self, ticker, period="d", total_days=90,
                              file_type="Stocks", x_stats=None):
        """(M, 1) day indices of the horizon grid after the file's last date
        (GPR/data_handler.py:67-90), z-scored by `x_stats` when given."""
        df = loader.load_frame(self.data_root, file_type, ticker, period)
        last = pd.to_datetime(df["date"]).max()
        fut = cal.future_dates(last, period, total_days)
        x = cal.days_since(pd.Series(fut), self.train_start_date).astype(float)
        if x_stats is not None:
            x_mean, x_std = x_stats
            x = (x - x_mean) / x_std
        return as_tensor(x.reshape(-1, 1), self.device, self.dtype)
