"""One-off data-wrangling helpers.

Port of portfoliooptgp_tpu/data/wrangle.py: investing.com quote-format
conversion, index-CSV header remapping with a date sort, and two-series
date alignment.
"""

from __future__ import annotations

import pandas as pd

from portfoliooptgp_tpu_torch.data.loader import convert_investing_csv


def convert_quote_csv(input_path: str, output_path: str) -> pd.DataFrame:
    """investing.com quote format -> EOD schema CSV."""
    df = convert_investing_csv(input_path)
    df.to_csv(output_path, index=False)
    return df


def remap_index_csv(input_path: str, output_path: str,
                    column_map=None) -> pd.DataFrame:
    """Remap an index CSV's headers to the EOD schema and sort ascending by
    date."""
    df = pd.read_csv(input_path, encoding="utf-8-sig")
    default_map = {
        "Date": "date", "Price": "close", "Open": "open", "High": "high",
        "Low": "low", "Vol.": "volume", "Change %": "change",
        "Close": "close", "Adj Close": "adjusted_close", "Volume": "volume",
    }
    df = df.rename(columns=column_map or default_map)
    for col in ("open", "high", "low", "close"):
        if col in df and not pd.api.types.is_numeric_dtype(df[col]):
            df[col] = pd.to_numeric(df[col].astype(str).str.replace(",", ""), errors="coerce")
    df["date"] = pd.to_datetime(df["date"], format="mixed")
    df = df.sort_values("date").reset_index(drop=True)
    df.to_csv(output_path, index=False)
    return df


def align_by_dates(df_a: pd.DataFrame, df_b: pd.DataFrame,
                   date_column: str = "date"):
    """Restrict two frames to their common trading dates: crypto trades
    every day, equities do not, and a multi-input design needs one grid
    (`DataHandler.concatenate_X` checks the shapes)."""
    a = df_a.copy()
    b = df_b.copy()
    a[date_column] = pd.to_datetime(a[date_column])
    b[date_column] = pd.to_datetime(b[date_column])
    common = pd.Index(sorted(set(a[date_column]) & set(b[date_column])))
    a = a[a[date_column].isin(common)].sort_values(date_column).reset_index(drop=True)
    b = b[b[date_column].isin(common)].sort_values(date_column).reset_index(drop=True)
    return a, b
