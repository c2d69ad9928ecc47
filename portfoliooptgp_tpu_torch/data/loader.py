"""CSV loaders for the two market-data schemas the reference ships.

Port of portfoliooptgp_tpu/data/loader.py, pandas path only (the threaded
C++ parser is listed in ROADMAP.md).

- EOD schema: `date,open,high,low,close,adjusted_close,volume`
- investing.com commodity schema: `"Date","Price","Open","High","Low",
  "Vol.","Change %"` with MM/DD/YYYY dates in reverse chronological order,
  remapped to the EOD schema (Price→close, ascending sort).
"""

from __future__ import annotations

import os
from typing import Optional

import pandas as pd


def read_eod_csv(path: str, start_date: Optional[str] = None,
                 end_date: Optional[str] = None, use_native: bool = False) -> pd.DataFrame:
    if use_native:
        raise NotImplementedError(
            "the native C++ CSV loader is not ported yet: ROADMAP.md queue 1: "
            "data, portfolio and kernel leftovers")
    df = pd.read_csv(path)
    df["date"] = pd.to_datetime(df["date"])
    if start_date is not None:
        df = df[df["date"] >= start_date]
    if end_date is not None:
        df = df[df["date"] <= end_date]
    return df.reset_index(drop=True)


def convert_investing_csv(path: str) -> pd.DataFrame:
    """Normalize the investing.com commodity format into the EOD schema."""
    df = pd.read_csv(path, encoding="utf-8-sig")
    out = pd.DataFrame(
        {
            "date": pd.to_datetime(df["Date"], format="%m/%d/%Y"),
            "open": pd.to_numeric(df["Open"].astype(str).str.replace(",", ""), errors="coerce"),
            "high": pd.to_numeric(df["High"].astype(str).str.replace(",", ""), errors="coerce"),
            "low": pd.to_numeric(df["Low"].astype(str).str.replace(",", ""), errors="coerce"),
            "close": pd.to_numeric(df["Price"].astype(str).str.replace(",", ""), errors="coerce"),
            "change": df["Change %"],
            "volume": df["Vol."].fillna("0").replace("", "0"),
        }
    )
    return out.sort_values("date").reset_index(drop=True)


def resolve_csv_path(data_root: str, file_type: str, ticker: str, period: str = "d") -> str:
    """`<root>/<file_type>/<ticker>/<ticker>_us_<period>.csv`, then the
    `<ticker>_EOD/` directory variant, then `<ticker>.csv`."""
    primary = os.path.join(data_root, file_type, ticker, f"{ticker}_us_{period}.csv")
    if os.path.exists(primary):
        return primary
    eod = os.path.join(data_root, file_type, f"{ticker}_EOD", f"{ticker}_us_{period}.csv")
    if os.path.exists(eod):
        return eod
    fallback = os.path.join(data_root, file_type, ticker, f"{ticker}.csv")
    if os.path.exists(fallback):
        return fallback
    return primary  # let the read fail with the canonical path in the error


def load_frame(data_root: str, file_type: str, ticker: str, period: str = "d",
               start_date: Optional[str] = None, end_date: Optional[str] = None) -> pd.DataFrame:
    path = resolve_csv_path(data_root, file_type, ticker, period)
    df = pd.read_csv(path, nrows=1)
    if "Price" in df.columns or "﻿Date" in df.columns or "Date" in df.columns:
        out = convert_investing_csv(path)
        if start_date is not None:
            out = out[out["date"] >= start_date]
        if end_date is not None:
            out = out[out["date"] <= end_date]
        return out.reset_index(drop=True)
    return read_eod_csv(path, start_date, end_date)
