"""Quality metrics and a structured metrics sink.

Port of portfoliooptgp_tpu/utils/metrics.py, numpy only (a logged value
may be a Python number, a numpy scalar or a one-element tensor). The
reference prints everything (MSE via sklearn at GPR/model_trainer.py:21,
Sharpe/backtest summaries at Portfolio/portfolio.py:196-217). Metric
*definitions* are kept identical for parity; recording goes to JSONL
instead of stdout."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def mse(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, dtype=float).reshape(-1)
    y_pred = np.asarray(y_pred, dtype=float).reshape(-1)
    return float(np.mean((y_true - y_pred) ** 2))


def cumulative_return(returns) -> float:
    """Π(1+r) − 1 (Portfolio/returns.py:85)."""
    return float(np.prod(1.0 + np.asarray(returns, dtype=float)) - 1.0)


def daily_sharpe(ret, risk_free_rate, variance) -> float:
    """(r − r_f)/var — the reference's (unusual) definition
    (Portfolio/portfolio.py:196)."""
    return float((ret - risk_free_rate) / variance)


def portfolio_sharpe(cml_return, risk_free_rate, cml_variance) -> float:
    """(R − r_f)/ΣVar (Portfolio/portfolio.py:216)."""
    return float((cml_return - risk_free_rate) / cml_variance)


@dataclass
class MetricsLogger:
    """Append-only JSONL metrics sink with wall-clock stamps."""

    path: Optional[str] = None
    _records: list = field(default_factory=list)

    def log(self, name: str, value, step: Optional[int] = None, **extra):
        rec = {"ts": time.time(), "metric": name, "value": _tofloat(value)}
        if step is not None:
            rec["step"] = int(step)
        rec.update({k: _tofloat(v) for k, v in extra.items()})
        self._records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    @property
    def records(self):
        return list(self._records)


def _tofloat(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
