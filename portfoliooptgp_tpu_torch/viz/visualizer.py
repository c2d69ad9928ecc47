"""Plotting surface (GPR/visualizer.py + Multi-Input_GPR/utils/visualizer.py
parity), headless by default.

Port of portfoliooptgp_tpu/viz/visualizer.py: matplotlib with the Agg
backend on host (numpy) arrays, the same plots, palette and file names.
Covers the reference's plot set: raw series, GP posterior with 95% bands,
posterior with removed points overlaid, combined f/y predictions, backtest
cumulative-return comparison, per-strategy returns, per-day allocation pies.
Reference quirks intentionally fixed: `plot_GP` bands use ±1.96·√var (the
reference forgot the sqrt at utils/visualizer.py:117-118); LaTeX text
rendering is off so no TeX toolchain is required.
"""

from __future__ import annotations

from typing import Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

# TUM-style palette from the reference's plot styling
# (Multi-Input_GPR/utils/visualizer.py:33-50)
PALETTE = ["#0065BD", "#E37222", "#A2AD00", "#98C6EA", "#7F7F7F", "#DAD7CB"]


def setup_plot_style():
    plt.rcParams.update(
        {
            "figure.figsize": (10, 5),
            "axes.prop_cycle": plt.cycler(color=PALETTE),
            "axes.grid": True,
            "grid.alpha": 0.3,
            "font.size": 11,
        }
    )


class Visualizer:
    def __init__(self):
        setup_plot_style()

    def _finish(self, fig, filename: Optional[str]):
        if filename:
            fig.savefig(filename, dpi=120, bbox_inches="tight")
            plt.close(fig)
        return fig

    def plot_data(self, X, Y, dates=None, title="", mean=0.0, std=1.0, filename=None):
        fig, ax = plt.subplots()
        x = np.asarray(X).reshape(-1)
        y = np.asarray(Y).reshape(-1) * std + mean
        ax.plot(x, y, "kx", markersize=4)
        ax.set_title(title)
        ax.set_xlabel("day index")
        return self._finish(fig, filename)

    def plot_gp(self, X, Y, f_mean, f_var, title="", filename=None):
        """Posterior with 95% bands = mean ± 1.96·√var."""
        fig, ax = plt.subplots()
        x = np.asarray(X).reshape(-1)
        ax.plot(x, np.asarray(Y).reshape(-1), "kx", markersize=4, label="data")
        m = np.asarray(f_mean).reshape(-1)
        sd = np.sqrt(np.maximum(np.asarray(f_var).reshape(-1), 0.0))
        ax.plot(x, m, color=PALETTE[0], label="posterior mean")
        ax.fill_between(x, m - 1.96 * sd, m + 1.96 * sd, color=PALETTE[0], alpha=0.2,
                        label="95% band")
        ax.legend()
        ax.set_title(title)
        return self._finish(fig, filename)

    # reference-compatible casing
    plot_GP = plot_gp

    def plot_gp_with_removed(self, X, Y, f_mean, f_var, X_removed, Y_removed,
                             title="", filename=None):
        fig = self.plot_gp(X, Y, f_mean, f_var, title=title, filename=None)
        ax = fig.axes[0]
        ax.plot(np.asarray(X_removed).reshape(-1), np.asarray(Y_removed).reshape(-1),
                "o", color=PALETTE[1], markersize=5, label="removed")
        ax.legend()
        return self._finish(fig, filename)

    plot_GP_with_removed = plot_gp_with_removed

    def plot_pred_data(self, X_train, Y_train, X_pred, f_mean, f_lower, f_upper,
                       y_mean=None, y_lower=None, y_upper=None, title="",
                       mean=0.0, std=1.0, filename=None):
        """Combined-prediction plot (GPR/visualizer.py:36-62): denormalized
        f (and optional y) bands over train + horizon."""
        fig, ax = plt.subplots()
        xt = np.asarray(X_train).reshape(-1)
        xp = np.asarray(X_pred).reshape(-1)
        ax.plot(xt, np.asarray(Y_train).reshape(-1) * std + mean, "kx", markersize=4)
        de = lambda v: np.asarray(v).reshape(-1) * std + mean
        ax.plot(xp, de(f_mean), color=PALETTE[0], label="f mean")
        ax.fill_between(xp, de(f_lower), de(f_upper), color=PALETTE[0], alpha=0.2)
        if y_mean is not None:
            ax.plot(xp, de(y_mean), color=PALETTE[1], label="y mean")
            ax.fill_between(xp, de(y_lower), de(y_upper), color=PALETTE[1], alpha=0.15)
        ax.legend()
        ax.set_title(title)
        return self._finish(fig, filename)

    def plot_backtest_cml(self, series_by_strategy: dict, ylabel="Cumulative Returns",
                          title="Portfolio Comparison", filename=None):
        """Multi-strategy cumulative comparison (utils/visualizer.py:192-211),
        generalized to any number of strategies."""
        fig, ax = plt.subplots()
        for name, series in series_by_strategy.items():
            ax.plot(np.asarray(series, dtype=float), marker="o", label=name)
        ax.set_xlabel("day")
        ax.set_ylabel(ylabel)
        ax.set_title(title)
        ax.legend()
        return self._finish(fig, filename)

    def plot_strategy_returns(self, returns, strategy_name="", filename=None):
        fig, ax = plt.subplots()
        ax.bar(range(1, len(returns) + 1), np.asarray(returns, dtype=float),
               color=PALETTE[0])
        ax.set_xlabel("day")
        ax.set_ylabel("net return")
        ax.set_title(strategy_name)
        return self._finish(fig, filename)

    def plot_arima_comparison(self, actual, gpr_predictions, arima_predictions,
                              days=None, ylabel="Close Price",
                              title="Comparison of Predicted Values from GPR and ARIMA Models",
                              filename=None):
        """GPR-vs-ARIMA overlay (utils/visualizer.py:289-307), generalized to
        take the actual series instead of the reference's hard-coded demo."""
        actual = np.asarray(actual, dtype=float)
        days = np.arange(1, len(actual) + 1) if days is None else np.asarray(days)
        fig, ax = plt.subplots()
        ax.plot(days, actual, marker="o", linestyle="-", label="Actual Values",
                color=PALETTE[0])
        ax.plot(days, np.asarray(gpr_predictions, dtype=float), marker="x",
                linestyle="--", label="GPR Predictions", color=PALETTE[1])
        ax.plot(days, np.asarray(arima_predictions, dtype=float), marker="^",
                linestyle="-.", label="ARIMA Predictions", color=PALETTE[2])
        ax.set_xlabel("Day")
        ax.set_ylabel(ylabel)
        ax.set_title(title)
        ax.legend()
        ax.grid(True)
        return self._finish(fig, filename)

    def plot_asset_allocations(self, weights_per_day, assets: Sequence[str],
                               time_points=None, strategy_name="", filename=None):
        """Per-day allocation pies (utils/visualizer.py:228-286)."""
        n = len(weights_per_day)
        fig, axes = plt.subplots(1, n, figsize=(3 * n, 3))
        if n == 1:
            axes = [axes]
        for i, (ax, w) in enumerate(zip(axes, weights_per_day)):
            w = np.maximum(np.asarray(w, dtype=float), 0)
            ax.pie(w, labels=assets, colors=PALETTE[: len(assets)],
                   autopct="%1.0f%%", textprops={"fontsize": 8})
            label = time_points[i] if time_points is not None else i + 1
            ax.set_title(f"day {label}", fontsize=10)
        fig.suptitle(strategy_name)
        return self._finish(fig, filename)
