"""Date-index helpers (reference day_of_year convention + future-date grids).

Port of portfoliooptgp_tpu/data/calendar.py. The reference's "day_of_year"
is actually days-since-train-start (GPR/data_handler.py:42-44), and future
grids step daily / weekly (W) / month-end (ME) from the last observed date
(GPR/data_handler.py:67-90)."""

from __future__ import annotations

import numpy as np
import pandas as pd


def days_since(dates: pd.Series, start_date: str) -> np.ndarray:
    start = pd.Timestamp(start_date)
    return (pd.to_datetime(dates) - start).dt.days.to_numpy()


def future_dates(last_date, period: str = "d", total_days: int = 90) -> pd.DatetimeIndex:
    last_date = pd.Timestamp(last_date)
    if period == "d":
        return pd.date_range(start=last_date + pd.Timedelta(days=1), periods=total_days, freq="D")
    if period == "w":
        return pd.date_range(start=last_date + pd.DateOffset(weeks=1), periods=total_days // 7,
                             freq="W")
    if period == "m":
        return pd.date_range(start=last_date + pd.DateOffset(months=1),
                             periods=total_days // 30, freq="ME")
    raise ValueError("Period must be 'd', 'w', or 'm'")
