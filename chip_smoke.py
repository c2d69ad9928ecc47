#!/usr/bin/env python3
"""On-chip smoke run of the PyTorch/CUDA port (portfoliooptgp_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every CUDA source of the port with nvcc (in parallel), and the
     native CSV loader (`csrc/csv_loader.cc`) with g++;
  2. hold the stationary NLL kernel against its plain PyTorch version on
     the card in float32 — values (rtol 3e-3) and gradients of err, v, ℓ,
     α, noise and the d2 matrices (normalized atol 2e-2), the tolerances of
     the matching checks in tools/smoke_tpu.py; the gradients twice, with
     the d2 matrices needing a gradient (the torch closed form) and without,
     as the main path calls it (the backward kernel, one launch) — for the
     7 families, prod and sum, an ARD atom, a partial mask, the
     walk-forward shape and the headline shape; then (2b) at the tile
     kernel's edges, N in {1, 31, 32, 33, 64, 65, 255, 256}, and past it
     on the cluster kernel, at both sides of every tile count and cluster
     size it changes at (STATIONARY_CLUSTER_NS, 257 to 512): with and without W, unmasked,
     masked (a mask that empties whole tiles and whole CTAs' rows) and
     indefinite (NaN where the plain version has it), each launch on the
     kernel its N routes to (`phase_stationary_edges`);
  3. headline: value+grad of `batched_neg_log_marginal_likelihood` at
     B=128 SE models, N=256, float32, through the `fused_stationary` tier on
     the tile kernel; the stationary kernel's times with and without W at
     the headline, the weekly and monthly menus' (1, 175) and (1, 40),
     and on the cluster kernel frontier grid A's (20, 262), the NUTS
     posterior's (8, 512) ARD, grid A's ICM under two NUTS chains
     (40, 262) and a two-year walk-forward's (5, 480) masked, beside its plain version, the torch.linalg chain and its
     bound, by CUDA-graph replay and eager (`stationary_times`), each
     shape's outputs first held against the plain version on the inputs
     it is timed on (`check_timed`); then the backward kernel
     (`stationary_nll_grad_kernel`) at GRAD_TIMED's shapes (these and the
     benchmark cells' (2560, 262), (128, 512) and (80, 504) masked): through
     `_SingleNLL` or `_GeneralNLL`, one launch, against its plain twin on
     the same W and a (`check_grad`), and timed beside the twin and the
     torch closed form (`grad_times`);
  4. end to end: the 5-asset portfolio workflow (walk-forward GP fit,
     ARIMA, correlations, 5 strategies, backtest) on the card in float32,
     cold then warm, checked against tests/goldens/portfolio_e2e_goldens.json,
     with the tile kernel's and the backward kernel's launches and the CSV
     files the native loader parsed; then the kernel's times at the walk-forward's (5, 77), masked;
  5. hold the blocked tier's panel kernel against its plain version in
     float32: the L panel and Σ log diag at every panel height of N = 875
     (B = 1 and 8), and the blocked NLL's values and gradients at N = 875
     and N = 896 against the same call on CPU copies (phase 2's
     tolerances);
  6. the single-asset pipeline (`StockPredictor.run_ticker`, 8-entry menu
     × daily/weekly/monthly on a 2021-2024 daily history) on the card in
     float32, cold then warm: the daily entries through the blocked tier,
     the weekly and monthly ones through the fused tiers, checked against
     tests/goldens_torch/single_asset_2021_2024.json (the JAX package's
     float64 run) and, where JAX's own float32 departs from it,
     single_asset_2021_2024_f32.json (its float32 run; both written by
     tools/make_torch_goldens.py): each menu entry's final loss and train
     MSE, the winners, α, β, the blended posterior in sample and over the
     horizon (`compare_single_asset`); a third pass under the
     profiler for the device's busy share; the panel kernel's time at each
     panel height of the path;
  7. hold the hinv tier's triangular-inverse kernel against its plain
     version in float32 at 220, 160, 40, 20 and 8 blocks (random,
     ill-conditioned and NaN-holding factors), and batched_nll_hinv's
     values and gradients at (B, N) = (20, 1304) and (8, 2048) against the
     same call on CPU copies (phase 2's tolerances); times of the kernel,
     its plain version, torch.linalg.solve_triangular and the hinv
     value+grad (`phase_hinv_checks`);
  8. the config-5 frontier pipeline (`run_frontier_pipeline`: ICM fit,
     posterior moments, efficient frontier) on the card in float32 from
     JAX's W₀, on a one-year grid (the fused stationary kernel) and a
     five-year grid (the hinv tier; cold, warm and under the profiler),
     against tests/goldens_torch/frontier_*.json (the JAX package's
     float64 and float32 runs, written by tools/make_torch_goldens.py
     --frontier) by `compare_frontier`, with the launch counts of each
     pipeline run; then the five-year frontier's sweep (32 return floors)
     on the warm run's (μ, Σ) as the old per-point loop of simplex solves
     and as the one row-batched solve, both timed, the weights held
     together (`time_frontier_sweep`);
  9. hold the dense NLL kernel (`csrc/dense_nll.cu`, with and without W)
     against its plain version in float32 at the multi-input shapes and
     tile edges (random, ill-conditioned and indefinite inputs, NaN where
     the plain version has it) and batched_nll's values and gradients
     against CPU copies; `Exponential + White` at (20, 77) and (5, 200)
     through the router, asserted on the dense tier, its launches counted,
     its value+grad against CPU copies and the kernel against its plain
     version on that K (`check_white_route`); time it by CUDA-graph replay
     beside its plain version, the torch.linalg chain and its bound, at
     (20, 77), (128, 256) and (5, 200) (`phase_dense`); then
     the multi-input flow on the card, cold then warm — steps 1–3 with
     the default pair and with (Polynomial, Exponential), fixed and
     trained likelihood, run_step_4(batched=False), and the 5-asset
     workflow with the Polynomial pair and trained likelihood — against
     tests/goldens_torch/multi_input_poly*.json (the JAX package's float64
     and float32 runs, written by tools/make_torch_goldens.py
     --multi-input) by `compare_multi_input`, with the launch counts of
     each run (`phase_multi_input`);
 10. the SVGP slice: hold both gram kernels (`csrc/svgp_gram.cu`) against
     their plain versions in float32 for four families, isotropic and ARD,
     at (M, B) up to (128, 8192) on the 16k-day scale with a weight-0 tail,
     and `gaussian_elbo_gram_fused(use_pallas=True)`'s value and gradients
     against `gaussian_elbo_gram` and against CPU copies; print each
     kernel's launch shape and time it beside its plain version, the
     PyTorch chain and its bound at (M, B, D) = (128, 2048, 1) and (128,
     8192, 1) (`phase_svgp_checks`); then the sparse-variational workflow at
     full-AAPL scale (bench.py's SVGP problem, N = 10,963, M = 128, batch
     2048) on the card, cold then warm, by the trainer's default route and
     by the kernel route, against tests/goldens_torch/svgp_full_aapl*.json
     (the JAX package's float64 and float32 runs, written by
     tools/make_torch_goldens.py --svgp) by `compare_svgp`, with the steps
     per second of each route and the device's busy share (`phase_svgp`);
 11. the NUTS slice (`phase_nuts`): the chain-batched GPR log-density
     (`gpr_logdensity_vg`) on the card against CPU float64 copies at
     tools/smoke_tpu.py's check (C = 8, N = 128, the tile kernel) and at
     bench.py's (8, 512) ARD posterior (one cluster-kernel launch, with W,
     per evaluation), each with one launch of the backward kernel; bench.py's NUTS workload (8 chains, N = 512, dense
     mass, depth 8, 100 + 200 transitions) cold under the profiler and
     warm, with nuts_draws_per_s, acceptance, leaves per transition,
     launches and host syncs, its posterior held against
     tests/goldens_torch/nuts_bench.json (`compare_nuts`); then the
     frontier pipeline with use_nuts=True on the one-year grid (2
     chains, depth 6, 50 + 50 transitions, from JAX's float64 fit with
     maxiter 0, where the golden runs start) against
     tests/goldens_torch/frontier_1y_nuts.json (`compare_frontier_nuts`),
     with its stationary-kernel launches at batch C·P = 40;
 12. the shell and the long windows (`phase_cli`): (a) `python -m
     portfoliooptgp_tpu_torch portfolio` (run as `python -m` runs it, in a
     child process, `CLI_CHILD`) on `make_long_market` with a three-year
     train window (760 rows, padded N = 768: the walk-forward's blocked
     tier, the panel kernel at B = 5), its `--metrics` JSONL held against
     tests/goldens_torch/cli_long_window*.json (the JAX CLI's float64 and
     float32 runs, written by tools/make_torch_goldens.py --cli) by
     `compare_cli`; (b) `multi-input --step 4` on one asset with a
     five-year window (1270 rows, padded N = 1280: the blocked_hinv tier,
     the triangular-inverse kernel), its printed next-day means held
     against the same goldens (`compare_cli_means`); each child's tier
     calls, launch counts and device busy share; the panel kernel (N =
     768) and the triangular-inverse kernel (padded N = 1280) on masked
     walk-forward systems and their factors (σ² = 1e-5 beside the identity
     rows, B = 5 and 20) against their plain versions, and both kernels
     timed at these shapes; (c) tools/smoke_tpu.py's two CG checks (`nll_cg` at N = 2048,
     128 probes and 48 Lanczos steps; the rank-256 PCG with split SLQ, 64
     probes and 8 steps) against the dense torch.linalg value+grad, with
     their CG iteration counts; (d) `print-config` and `--help` through
     `python -m portfoliooptgp_tpu_torch`;
 13. parallel/ across ranks (`phase_parallel`), in spawned processes (the
     script's own process joins no process group): world 1 on NCCL and
     world 2 on gloo with both ranks on the card. (a) `sharded_neg_elbo`
     on bench.py's first batch against the one-device
     `gaussian_elbo_gram_fused(use_pallas=True)` (one gram kernel pair per
     rank and value+grad), sharded Adam steps per second per rank, and at
     world 2 the trainer on the mesh (60 steps) against
     tests/goldens_torch/svgp_full_aapl*.json with the ranks' models equal;
     (b) `sharded_gpr_nll` at N = 8192, block 128, both layouts, against
     the dense torch.linalg value+grad on the card and on CPU float64
     copies, its forward and backward seconds; (c) at world 2 the
     restart-sharded walk-forward (5 days × 2 restarts, N = 77, the tile
     kernel) against the unsharded run (the start bit for bit); (d) NUTS with the
     adaptation pooled over the ranks (4 chains a rank, N = 128, 20 + 20
     transitions): equal adapted step sizes and metrics, and at world 1
     the draws of the run without a mesh; (e) at world 2 the sharded MC
     estimate; then `dryrun_multichip`'s six checks as the ranks' code.
Then it prints the card's name and power limit, one JSON line describing
every kernel, and the last line {"ok": true, "device": {...}}.

It exits non-zero without printing a result when no CUDA device is
present, or when the port's package is not beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3 bandwidth. Used only for the bound of each kernel.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

DEVICE = "cuda"
VALUE_RTOL = 3e-3
GRAD_ATOL = 2e-2


def run_workflow(data_root: str, device="cuda", dtype=torch.float32, maxiter: int = 200,
                 timings=None, kernel_pairs=None, train_likelihood=False, step4=None):
    """The port's twin of benchmarks/bench_portfolio_e2e.run_workflow:
    5 assets × walk-forward step 4, ARIMA(3,1,0), cross-asset
    correlations, then every strategy evaluated per day and backtested.
    Returns (elapsed_s, quality dict in compare_to_goldens' format); a
    `timings` dict receives the seconds of the step-4 and portfolio stages,
    a `step4` list each asset's next-day f_mean and f_var. `kernel_pairs`
    and `train_likelihood` go to MultiInputGPR (the benchmark's defaults:
    Exponential × Exponential, σ² fixed)."""
    from benchmarks.bench_portfolio_e2e import ASSETS, DATES, FEATURES, STRATEGIES
    from portfoliooptgp_tpu_torch.models import arima
    from portfoliooptgp_tpu_torch.pipelines import MultiInputGPR
    from portfoliooptgp_tpu_torch.pipelines.multi_input import full_correlations
    from portfoliooptgp_tpu_torch.portfolio import Portfolio, PortfolioOptimizer

    t0 = time.perf_counter()
    preds, pvars, actuals, trains = [], [], [], []
    for ticker in ASSETS:
        mi = MultiInputGPR(ticker=ticker, features=FEATURES, data_root=data_root,
                           threshold=0.30, removal_percentage=0.2, maxiter=maxiter,
                           kernel_pairs=kernel_pairs, isFixedLikelihood=not train_likelihood,
                           device=device, dtype=dtype, **DATES)
        p = mi.run_step_4()
        if step4 is not None:
            step4.append(dict(f_mean=_flat(p.f_mean), f_var=_flat(p.f_var)))
        preds.append(p.f_mean)
        pvars.append(p.f_var)
        actuals.append(p.actual)
        trains.append(p.Y_train)
        arima.fit_forecast(np.asarray(p.Y_train).reshape(-1), (3, 1, 0), 5)
    t_step4 = time.perf_counter()

    corr = full_correlations(np.column_stack([np.asarray(t).reshape(-1) for t in trains]))
    opt = PortfolioOptimizer(n_assets=len(ASSETS), lambda_l1=0.001, lambda_l2=0.001,
                             lambda_tx=1e-5, if_tx_penalty=True, device=device, dtype=dtype)
    port = Portfolio(ASSETS, preds, pvars, opt, risk_free_rate=0.01 / 252,
                     broker_fee=1e-5, device=device, dtype=dtype)
    quality = {}
    for strat in STRATEGIES:
        w, v = port.evaluate_portfolio(strategy_name=strat, max_volatility=0.02,
                                       min_return=0.001, prob_threshold=0.55,
                                       isLogReturn=False, cov=corr)
        cml, trx = port.backtest_portfolio(actuals, strat, w, v)
        quality[strat] = {
            "cumulative_return": float(np.asarray(cml)[-1]),
            "total_transaction_costs": float(np.asarray(trx)[-1]),
            "sharpe_ratio": float(port.last_summary["sharpe_ratio"]),
        }
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    if timings is not None:
        timings.update(step4_s=t_step4 - t0, portfolio_s=t_end - t_step4)
    return t_end - t0, quality


SINGLE_ASSET_TICKER = "TGT"
SINGLE_ASSET_DATES = dict(train_start_date="2021-01-04", train_end_date="2024-05-10",
                          test_start_date="2024-05-13", test_end_date="2024-05-17")
SINGLE_ASSET_GOLDENS = os.path.join(REPO, "tests", "goldens_torch",
                                    "single_asset_2021_2024.json")
SINGLE_ASSET_GOLDENS_F32 = os.path.join(REPO, "tests", "goldens_torch",
                                        "single_asset_2021_2024_f32.json")


def make_single_asset_market(root: str, seed: int = 3, first: str = "2021-01-04",
                             last: str = "2024-05-31") -> str:
    """The single-asset market: business days `first`..`last`, a
    daily close built as in benchmarks/bench_single_asset.make_market (a
    random-walk trend plus a small idiosyncratic walk), and its weekly (W)
    and monthly (ME) resamples, written as <root>/Stocks/TGT/TGT_us_{d,w,m}.csv.
    Each weekly and monthly bar is dated by the last trading day in it,
    not by the resample's Sunday or calendar month-end label: the blend
    (pipelines/blend.upsample_predictions) reindexes the coarse series on
    the daily day index, and with the labels no weekly date is a trading
    day, so the upsampled weekly prediction is NaN everywhere and the blend
    fit never leaves its start. Training on 2021-01-04..2024-05-10 gives
    875 daily, 175 weekly and 40 monthly rows."""
    import pandas as pd

    from benchmarks.bench_portfolio_e2e import _write_eod

    rng = np.random.default_rng(seed)
    days = pd.bdate_range(first, last)
    trend = np.cumsum(0.01 * rng.normal(size=len(days)))
    close = 100 * np.exp(trend + 0.001 * rng.normal(size=len(days)).cumsum())
    d = os.path.join(root, "Stocks", SINGLE_ASSET_TICKER)
    _write_eod(d, f"{SINGLE_ASSET_TICKER}_us_d.csv", days, close)
    df = pd.DataFrame({"day": days, "close": close}, index=days)
    for tag, rule in (("w", "W"), ("m", "ME")):
        res = df.resample(rule).last().dropna()
        _write_eod(d, f"{SINGLE_ASSET_TICKER}_us_{tag}.csv", pd.DatetimeIndex(res["day"]),
                   res["close"].to_numpy())
    return root


FRONTIER_ASSETS = 20
FRONTIER_GRIDS = {"1y": ("2023-06-01", "2024-05-31"), "5y": ("2019-06-03", "2024-05-31")}
FRONTIER_ARGS = dict(rank=3, maxiter=300, use_nuts=False, noise_variance=1e-2,
                     risk_free_rate=0.01 / 252, seed=0)


def frontier_goldens_path(grid: str, float32: bool = False) -> str:
    return os.path.join(REPO, "tests", "goldens_torch",
                        f"frontier_{grid}{'_f32' if float32 else ''}.json")


def make_frontier_market(root: str, first: str, last: str, seed: int = 11):
    """The config-5 market of benchmarks/bench_frontier.make_assets over the
    business days `first`..`last`: 20 assets AS00..AS19 whose log closes
    load on three shared random-walk drivers plus an idiosyncratic walk,
    written as <root>/Stocks/ASnn/ASnn_us_d.csv. Returns (names, days)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    days = pd.bdate_range(first, last)
    n = len(days)
    drivers = np.cumsum(0.01 * rng.normal(size=(n, 3)), axis=0)
    names = [f"AS{i:02d}" for i in range(FRONTIER_ASSETS)]
    for t in names:
        beta = rng.normal(scale=0.6, size=3) + np.array([0.8, 0.0, 0.0])
        close = 100 * np.exp(drivers @ beta + np.cumsum(0.004 * rng.normal(size=n)))
        d = os.path.join(root, "Stocks", t)
        os.makedirs(d, exist_ok=True)
        pd.DataFrame({
            "date": days.strftime("%Y-%m-%d"),
            "open": close * 0.998, "high": close * 1.01, "low": close * 0.99,
            "close": close, "adjusted_close": close, "volume": 1_000_000,
        }).to_csv(os.path.join(d, f"{t}_us_d.csv"), index=False)
    return names, days


def frontier_dates(grid: str) -> dict:
    """The DataHandler dates of bench_frontier.py on `grid`: train over every
    day (both ends of each grid are business days)."""
    first, last = FRONTIER_GRIDS[grid]
    return dict(train_start_date=first, train_end_date=last, test_start_date=last,
                test_end_date=last)


def _frontier_dict(f):
    return dict(target_returns=np.asarray(f.target_returns, float).tolist(),
                returns=np.asarray(f.returns, float).tolist(),
                volatilities=np.asarray(f.volatilities, float).tolist(),
                tangency_weights=np.asarray(f.tangency_weights, float).tolist(),
                tangency_return=float(f.tangency_return),
                tangency_volatility=float(f.tangency_volatility))


MULTI_INPUT_TICKER = "ALFA"
# case name → (step, kernel pair, isFixedLikelihood); step 4 is run_step_4(batched=False)
MULTI_INPUT_CASES = {f"step{step}/{pair}/{'fixed' if fixed else 'trained'}": (step, pair, fixed)
                     for step in (1, 2, 3) for pair in ("exp", "poly") for fixed in (True, False)}
MULTI_INPUT_CASES["step4/poly/fixed"] = (4, "poly", True)


MULTI_INPUT_MAXITER = 200


def multi_input_goldens_path(float32: bool = False) -> str:
    return os.path.join(REPO, "tests", "goldens_torch",
                        f"multi_input_poly{'_f32' if float32 else ''}.json")


CLI_MARKET = ("2019-07-01", "2024-05-31")  # business days of phase 12's market
# train_start_date of each window: 760 and 1270 training rows before the
# test week, so the walk-forward's padded N is 768 (blocked) and 1280 (hinv)
CLI_WINDOWS = {"3y": "2021-06-14", "5y": "2019-07-01"}
CLI_TICKER = "ALFA"  # the five-year multi-input run's asset


def make_long_market(root: str, seed: int = 7) -> str:
    """benchmarks/bench_portfolio_e2e.make_market over CLI_MARKET instead of
    2024-02-01..2024-05-31: the same assets, covariates, loadings and draw
    order on the longer business-day range."""
    import pandas as pd

    from benchmarks.bench_portfolio_e2e import ASSETS, _write_eod

    rng = np.random.default_rng(seed)
    days = pd.bdate_range(*CLI_MARKET)
    n = len(days)
    drv1 = np.cumsum(0.010 * rng.normal(size=n))
    drv2 = np.cumsum(0.008 * rng.normal(size=n))

    def series(b1, b2, idio):
        return 100 * np.exp(b1 * drv1 + b2 * drv2 + np.cumsum(idio * rng.normal(size=n)))

    for i, t in enumerate(ASSETS):
        _write_eod(os.path.join(root, "Stocks", t), f"{t}_us_d.csv", days,
                   series(0.9 + 0.05 * i, 0.4 - 0.05 * i, 0.004))
    for sub, name, b1, b2, idio in (("Commodities", "Brent_Oil", 1.0, 0.0, 0.003),
                                    ("Commodities", "XAU_USD", 0.0, 1.0, 0.003),
                                    ("Stocks/Index", "SP500", 0.8, 0.5, 0.002),
                                    ("Stocks/Index", "NasDaq100", 0.9, 0.3, 0.002),
                                    ("Stocks", "MACR", 0.5, 0.8, 0.003)):
        _write_eod(os.path.join(root, *sub.split("/"), name), f"{name}_us_d.csv", days,
                   series(b1, b2, idio))
    _write_eod(os.path.join(root, "Stocks", "RNDX"), "RNDX_us_d.csv", days,
               100 * np.exp(np.cumsum(0.01 * rng.normal(size=n))))
    return root


def cli_config(window: str) -> dict:
    """The RunConfig JSON of phase 12's CLI runs: the defaults but for the
    train window, which starts at CLI_WINDOWS[window]."""
    return {"data": {"train_start_date": CLI_WINDOWS[window], "train_end_date": "2024-05-10",
                     "test_start_date": "2024-05-13", "test_end_date": "2024-05-17"}}


# The walk-forward's float32 large-N branches at test size, held against
# the JAX package's float64 and float32 runs (tests/goldens_torch/
# walk_forward_long.json, tools/make_torch_goldens.py --walk-forward):
# case → (N, series seed, time span, kernel); padded N 384 and 640 run the
# blocked tier (the first only because its kernel is not fusable), 1152 the
# blocked_hinv tier. Three days, one restart, 30 iterations (WALK_LONG_KW).
WALK_LONG_CASES = {
    "blocked_unfusable_288": (288, 6, 10.0, "unfusable"),
    "blocked_composite_560": (560, 6, 20.0, "composite"),
    "hinv_composite_1100": (1100, 7, 40.0, "composite"),
}
WALK_LONG_KW = dict(n_days=3, maxiter=30)
WALK_LONG_GOLDENS = os.path.join(REPO, "tests", "goldens_torch", "walk_forward_long.json")


def long_series(n, seed, span):
    """(X (n, 2), Y (n, 1)): a noisy sine of t on [0, span] and t z-scored,
    as the data layer scales the day index. (A raw index up to 40 would
    lose ~1e-2 of each nearby distance to the float32 expansion ‖x‖² +
    ‖x'‖² − 2xx' that the stationary kernels build K from, in either
    package.)"""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, span, n)
    X = np.column_stack([np.sin(t) + 0.1 * rng.normal(size=n), (t - t.mean()) / t.std()])
    Y = (np.sin(t) + 0.08 * rng.normal(size=n))[:, None]
    return X, Y


def walk_long_kernel(pkg, name, **o):
    """WALK_LONG_CASES' kernels in either package (`pkg` its `kernels`):
    'unfusable' is (SE + Matern12) × Matern32, which no fused tier takes;
    'composite' is composite_kernel(2), Matern12 × Matern12."""
    if name == "unfusable":
        return ((pkg.SquaredExponential.create(**o) + pkg.Matern12.create(**o))
                * pkg.Matern32.create(**o))
    return pkg.composite_kernel(2, **o)


def cli_goldens_path(float32: bool = False) -> str:
    return os.path.join(REPO, "tests", "goldens_torch",
                        f"cli_long_window{'_f32' if float32 else ''}.json")


def multi_input_pairs():
    from portfoliooptgp_tpu_torch import kernels as tk

    return {"exp": [(tk.Exponential, tk.Exponential)], "poly": [(tk.Polynomial, tk.Exponential)]}


@contextlib.contextmanager
def recording_fits(fits):
    """Record every fit of the port's trainer (`train_model`,
    `train_likelihood`) into `fits`: N, D, the final loss, σ², the restarts'
    final losses and the winner (likelihood training), train MSE,
    iterations, the leaves without their batch axis and the NLL tiers the
    router took."""
    from portfoliooptgp_tpu_torch.models import gpr
    from portfoliooptgp_tpu_torch.params import tree_leaves
    from portfoliooptgp_tpu_torch.train import batched_lbfgs, lbfgs, trainer

    real_model, real_lik = trainer.train_model, trainer.train_likelihood
    real_fused, real_batched = batched_lbfgs.fit_batched_fused, lbfgs.fit_batched

    def record(t, X, restarts=None):
        losses = None
        if restarts is not None:
            r = restarts.detach().double().cpu().numpy()
            losses = np.where(np.isfinite(r), r, np.inf)
        fits.append(dict(
            n=int(X.shape[0]), d=int(X.shape[1]), loss=float(t.loss),
            noise_variance=float(t.model.likelihood.variance[0]), mse=float(t.mse),
            iters=np.asarray(torch.as_tensor(t.iters).cpu()).tolist(),
            tiers=sorted({e["tier"] for e in gpr.DISPATCH_EVENTS}),
            restart_losses=None if losses is None else losses.tolist(),
            winner=None if losses is None else int(np.argmin(losses)),
            leaves=[x[0].detach().double().cpu().numpy().tolist() for x in tree_leaves(t.model)]))
        return t

    def train_model(model, X, Y, **kw):
        gpr.DISPATCH_EVENTS.clear()
        return record(real_model(model, X, Y, **kw), X)

    def train_likelihood(X, Y, kernel, **kw):
        seen = []

        def fused(*a, **k):
            out = real_fused(*a, **k)
            seen.append(out[1].loss)
            return out

        def batched(*a, **k):
            out = real_batched(*a, **k)
            seen.append(out.loss)
            return out

        gpr.DISPATCH_EVENTS.clear()
        batched_lbfgs.fit_batched_fused, lbfgs.fit_batched = fused, batched
        try:
            t = real_lik(X, Y, kernel, **kw)
        finally:
            batched_lbfgs.fit_batched_fused, lbfgs.fit_batched = real_fused, real_batched
        return record(t, X, restarts=seen[0])

    trainer.train_model, trainer.train_likelihood = train_model, train_likelihood
    try:
        yield fits
    finally:
        trainer.train_model, trainer.train_likelihood = real_model, real_lik


def _flat(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().double().cpu().numpy()
    return np.asarray(x, dtype=float).reshape(-1).tolist()


def _step_outputs(step, out):
    """A step's result in the goldens' format."""
    if step == 1:
        return dict(kept=out["kept_features"], f_mean=_flat(out["f_mean"]),
                    f_var=_flat(out["f_var"]), mse=out["mse"])
    if step == 2:
        return dict(mse_all=out["mse_all"], mse_removed=out["mse_removed"])
    return dict(f_mean=_flat(out.f_mean), f_var=_flat(out.f_var), actual=_flat(out.actual))


def _run_step(mi, step):
    return mi.run_step_4(batched=False) if step == 4 else getattr(mi, f"run_step_{step}")()


def run_multi_input(data_root: str, names=None, goldens=None, goldens32=None, device="cuda",
                    dtype=torch.float32):
    """The port's MultiInputGPR on `chip_smoke.MULTI_INPUT_TICKER` for the
    cases `names` of MULTI_INPUT_CASES (default all) on the make_market
    market in data_root, maxiter MULTI_INPUT_MAXITER. Returns (elapsed_s,
    quality): per case its seconds, the kernel launches, every fit
    (`recording_fits`) and the step's outputs in the
    goldens' format; then, with `goldens` and `goldens32`, under "replay",
    each step run again with every fit replaced by the golden's fitted
    model: the routed NLL of each at its fit's data, and the outputs."""
    from benchmarks.bench_portfolio_e2e import DATES, FEATURES
    from portfoliooptgp_tpu_torch.kernels import composite_kernel
    from portfoliooptgp_tpu_torch.models import gpr
    from portfoliooptgp_tpu_torch.params import from_jax_leaves
    from portfoliooptgp_tpu_torch.pipelines import MultiInputGPR

    def sync():
        if str(device).startswith("cuda"):
            torch.cuda.synchronize()

    pairs = multi_input_pairs()
    q = dict(dtype=str(dtype).replace("torch.", ""), cases={})
    t0 = time.perf_counter()
    for name in names or MULTI_INPUT_CASES:
        step, pair, fixed = MULTI_INPUT_CASES[name]

        def make():
            return MultiInputGPR(
                ticker=MULTI_INPUT_TICKER, features=FEATURES, data_root=data_root,
                threshold=0.30, removal_percentage=0.2, maxiter=MULTI_INPUT_MAXITER,
                kernel_pairs=pairs[pair], isFixedLikelihood=fixed, device=device, dtype=dtype,
                **DATES)

        fits = []
        _reset_launch_counts()
        t = time.perf_counter()
        with recording_fits(fits):
            out = _run_step(make(), step)
        sync()
        case = dict(step=step, pair=pair, fixed=fixed, seconds=time.perf_counter() - t,
                    launches=_launch_counts(),
                    fits=fits,
                    **_step_outputs(step, out), replay={})
        for tag, g in (("f64", goldens), ("f32", goldens32)):
            if g is None:
                continue
            gfits, nlls = iter(g["cases"][name]["fits"]), []

            def golden_model(X, Y):
                k1, k2 = pairs[pair][-1]
                template = gpr.GPR.create(composite_kernel(X.shape[1], k1, k2, device=device,
                                                           dtype=dtype))
                model = from_jax_leaves(template, [np.asarray(x) for x in next(gfits)["leaves"]])
                with torch.no_grad():
                    nlls.append(float(gpr.batched_neg_log_marginal_likelihood(
                        model, X, Y, device=device, dtype=dtype)[0]))
                return model

            mi = make()
            mi._train = golden_model
            case["replay"][tag] = dict(nll=nlls, **_step_outputs(step, _run_step(mi, step)))
        q["cases"][name] = case
    sync()
    return time.perf_counter() - t0, q


# Tolerances of the multi-input run against the JAX goldens (PERF.md, the
# multi-input slice). The NLL at a golden's fitted leaves is held against
# JAX's float32 NLL at the same leaves (the float32 golden's final loss, or
# its `loss_at_f64_leaves`): a float32 NLL of these fits moves by up to
# 2.7e-3 from its float64 value, so only the same precision is a tight
# check. Where even that is rounding-bound, the limit widens by MI_SPREAD
# times JAX's own float32 error at the float64 leaves: the default pair's
# step 3 ends at σ² = 1e-6 with trained likelihood, where JAX's float32 NLL
# lies 1.4e-3 from the float64 value and the port's plain float32 one 4e-3
# from JAX's; with σ² fixed, JAX's float32 NLL lies 2.4e-4 from the float64
# value and the fused kernel on an H100 1.25e-4 from JAX's. On the dense
# tier JAX's float32 error is below 1e-5 and the check stays at
# MI_NLL_RTOL. Measured with the port's
# float32 plain versions on the CPU, the outputs at a golden's leaves lie
# within 2.2e-4 (means, of max |mean|) and 5.6e-4 (variances, relative) of
# the golden's.
# The fits' outcomes are float32 L-BFGS runs that stop elsewhere: the final
# loss within 1e-5 and the outputs within 6.4e-4 (means) and 3.5e-3
# (variances) of the float64 golden where JAX's float32 run agrees with it.
# Where it does not — a restart tie broken the other way (step 1's trained
# Polynomial fit: means 86% apart), or the trained walk-forward's per-day
# fits (next-day variances up to 7.5% apart in JAX, 16.5% in the port's
# plain float32 run, on other days) — the limit widens by MI_SPREAD times
# JAX's own float32-to-float64 spread, as compare_frontier's does. The
# winning restart is held only to the restarts whose losses tie within
# MI_TIE_RTOL in the goldens.
MI_NLL_RTOL = 1e-4          # an NLL at a golden's leaves, against JAX's float32 one there
MI_SPREAD = 4.0             # ... plus this many times JAX's float32 error at the float64 leaves
MI_REPLAY_MEAN_ATOL = 1e-3  # outputs at a golden's leaves: means, of max |mean|
MI_REPLAY_VAR_RTOL = 2e-3   # ... variances and MSEs, relative
MI_FIT_RTOL = 1e-4          # the fit's final loss
MI_FIT_MEAN_ATOL = 5e-3     # the fit's output means, of max |mean|
MI_FIT_VAR_RTOL = 2e-2      # the fit's output variances and MSEs, relative
MI_TIE_RTOL = 1e-4          # restarts whose final losses lie this close to the best tie


def _mi_outputs(c):
    """{name: (values, 'mean' | 'var')} of a case's outputs."""
    out = {}
    for key, kind in (("f_mean", "mean"), ("f_var", "var"), ("mse", "var"), ("mse_all", "var"),
                      ("mse_removed", "var")):
        if key in c:
            out[key] = (np.atleast_1d(np.asarray(c[key], float)), kind)
    return out


def _mi_err(x, ref, kind, mean_atol, var_rtol):
    """(err, limit) of x against ref."""
    if x.shape != ref.shape or not np.all(np.isfinite(x)):
        return np.inf, 0.0
    if kind == "mean":
        return np.abs(x - ref).max(), mean_atol * max(np.abs(ref).max(), 1e-12)
    return np.abs(x / ref - 1.0).max(), var_rtol


def _tie_set(fit):
    losses = np.asarray(fit["restart_losses"], float)
    best = losses.min()
    return set(np.flatnonzero(losses <= best + MI_TIE_RTOL * abs(best)).tolist())


def compare_multi_input(q, goldens, goldens32):
    """(ok, list of failures) of a run_multi_input quality dict against the
    JAX float64 goldens and JAX's float32 run (tests/goldens_torch/
    multi_input_poly*.json), case by case:
    - the kept features, the fits' N and, in float32, the NLL tier each fit
      took (the float32 golden's);
    - tightly, at each golden's fitted leaves: the routed NLL against JAX's
      float32 NLL at the same leaves (MI_NLL_RTOL, plus MI_SPREAD times
      JAX's own float32 error at the float64 leaves), and the step's outputs
      against that golden's (MI_REPLAY_MEAN_ATOL, MI_REPLAY_VAR_RTOL);
    - the fit's outcome: each final loss within MI_FIT_RTOL, and the
      outputs within MI_FIT_MEAN_ATOL / MI_FIT_VAR_RTOL, of the float64
      golden's, each limit widened by MI_SPREAD times JAX's own
      float32-to-float64 spread (a restart tie broken the other way, a
      day's fit that ends elsewhere);
    - the winning restart among the goldens' tied best restarts;
    and the 5-asset workflow, when q has one: each asset's next-day means
    and variances as the outputs above, the strategies as compare_to_goldens
    holds them (atol 0.02, Sharpe 1.0)."""
    bad = []
    f32 = q.get("dtype") == "float32"
    for name, c in q["cases"].items():
        g, g32 = goldens["cases"][name], goldens32["cases"][name]
        if "kept" in c and c["kept"] != g["kept"]:
            bad.append(f"{name}: kept {c['kept']} != {g['kept']}")
        if [f["n"] for f in c["fits"]] != [f["n"] for f in g["fits"]]:
            bad.append(f"{name}: fits on N {[f['n'] for f in c['fits']]} != "
                       f"{[f['n'] for f in g['fits']]}")
            continue
        for i, (f, gf, gf32) in enumerate(zip(c["fits"], g["fits"], g32["fits"])):
            if f32 and f["tiers"] != [gf32["tier_f32"]]:
                bad.append(f"{name} fit {i}: tiers {f['tiers']} != [{gf32['tier_f32']}]")
            # JAX's own float32 rounding of the NLL near this fit
            spread = abs(gf32["loss_at_f64_leaves"] - gf["loss"])
            for tag, want in (("f64", gf32["loss_at_f64_leaves"]), ("f32", gf32["loss"])):
                x = c["replay"][tag]["nll"][i]
                if not abs(x - want) <= MI_NLL_RTOL * abs(want) + MI_SPREAD * spread:
                    bad.append(f"{name} fit {i}: NLL at the {tag} golden's leaves {x:.8g} vs "
                               f"JAX float32 {want:.8g}")
            lim = MI_FIT_RTOL * abs(gf["loss"]) + MI_SPREAD * abs(gf32["loss"] - gf["loss"])
            if not abs(f["loss"] - gf["loss"]) <= lim:
                bad.append(f"{name} fit {i}: final loss {f['loss']:.8g}, goldens "
                           f"{gf['loss']:.8g} / {gf32['loss']:.8g}")
            if gf["restart_losses"] is not None:
                ties = _tie_set(gf) | _tie_set(gf32)
                if f["winner"] not in ties:
                    bad.append(f"{name} fit {i}: winner {f['winner']} not among the goldens' "
                               f"tied best restarts {sorted(ties)}")
        for tag, ref in (("f64", g), ("f32", g32)):
            rep = c["replay"][tag]
            for key, (x, kind) in _mi_outputs(rep).items():
                err, lim = _mi_err(x, _mi_outputs(ref)[key][0], kind, MI_REPLAY_MEAN_ATOL,
                                   MI_REPLAY_VAR_RTOL)
                if not err <= lim:
                    bad.append(f"{name}: {key} at the {tag} golden's leaves: err {err:.3g} > "
                               f"{lim:.3g}")
        bad += _fit_outputs(name, _mi_outputs(c), _mi_outputs(g), _mi_outputs(g32))
    if "workflow" in q:
        w, gw, gw32 = q["workflow"], goldens["workflow"], goldens32["workflow"]
        for a, (x, r, r32) in enumerate(zip(w["step4"], gw["step4"], gw32["step4"])):
            bad += _fit_outputs(f"workflow asset {a}", _mi_outputs(x), _mi_outputs(r),
                                _mi_outputs(r32))
        for strat, gq in gw["strategies"].items():
            for k, tol in (("cumulative_return", 0.02), ("total_transaction_costs", 0.02),
                           ("sharpe_ratio", 1.0)):
                d = abs(w["strategies"][strat][k] - gq[k])
                if not d <= tol:
                    bad.append(f"workflow {strat}.{k}: |diff| {d:.4g} > {tol}")
    return not bad, bad


def _fit_outputs(name, outs, g64, g32):
    """Failures of a fit's outputs: each within the fit tolerances of the
    float64 golden's, widened by MI_SPREAD times JAX's own float32 spread."""
    bad = []
    for key, (x, kind) in outs.items():
        err, lim = _mi_err(x, g64[key][0], kind, MI_FIT_MEAN_ATOL, MI_FIT_VAR_RTOL)
        spread, _ = _mi_err(g32[key][0], g64[key][0], kind, MI_FIT_MEAN_ATOL, MI_FIT_VAR_RTOL)
        if not err <= lim + MI_SPREAD * spread:
            bad.append(f"{name}: {key} err {err:.3g} against the float64 golden > "
                       f"{lim:.3g} + {MI_SPREAD} x JAX's float32 spread {spread:.3g}")
    return bad


def _launch_counts():
    from portfoliooptgp_tpu_torch.ops import blocked_nll, nll, stationary_nll, svgp_gram

    return {**stationary_nll.LAUNCHES, **blocked_nll.LAUNCHES, **nll.LAUNCHES,
            **svgp_gram.LAUNCHES}


def _reset_launch_counts():
    from portfoliooptgp_tpu_torch.ops import blocked_nll, nll, stationary_nll, svgp_gram

    for counts in (stationary_nll.LAUNCHES, blocked_nll.LAUNCHES, nll.LAUNCHES,
                   svgp_gram.LAUNCHES):
        for k in counts:
            counts[k] = 0


def run_frontier(data_root: str, grid: str, goldens, goldens32, device="cuda",
                 dtype=torch.float32, replay=True):
    """The port's `run_frontier_pipeline` on the config-5 market of `grid`
    (made by make_frontier_market in data_root) with FRONTIER_ARGS, starting
    from JAX's W₀ (the float32 golden's in float32, the float64 one's
    otherwise). Returns (elapsed_s, quality): N, the ICM NLL's tier, the
    kernel launches of the pipeline run, the NLL before and after the fit,
    the iterations, the fitted hyperparameters (kernel variance × B, the
    identifiable product, and B itself), μ, Σ and the frontier; then, after
    the counts are read and when `replay`, `replay`: the NLL and (μ, Σ) at
    each golden's final leaves, and the frontier of the float64 golden's
    (μ, Σ), with its time."""
    from portfoliooptgp_tpu_torch import kernels as tk
    from portfoliooptgp_tpu_torch.data.handler import DataHandler
    from portfoliooptgp_tpu_torch.models import icm
    from portfoliooptgp_tpu_torch.params import from_jax_leaves
    from portfoliooptgp_tpu_torch.pipelines import run_frontier_pipeline
    from portfoliooptgp_tpu_torch.pipelines.frontier_pipeline import frontier_inputs
    from portfoliooptgp_tpu_torch.portfolio.frontier import efficient_frontier

    def sync():
        if str(device).startswith("cuda"):
            torch.cuda.synchronize()

    init = goldens32 if dtype == torch.float32 else goldens
    names = init["assets"]
    dh = DataHandler(data_root=data_root, device=device, dtype=dtype, **frontier_dates(grid))
    template = icm.ICMGPR.create(tk.SquaredExponential.create(device=device, dtype=dtype),
                                 len(names), rank=FRONTIER_ARGS["rank"])

    def model_of(leaves):
        return from_jax_leaves(template, [np.asarray(x) for x in leaves])

    _reset_launch_counts()
    t0 = time.perf_counter()
    res = run_frontier_pipeline(names, dh, model0=model_of(init["init_leaves"]), device=device,
                                dtype=dtype, **FRONTIER_ARGS)
    sync()
    elapsed = time.perf_counter() - t0
    launches = _launch_counts()
    m = res.model
    with torch.no_grad():
        Xs, Y, Xnew = frontier_inputs(names, dh, device=device, dtype=dtype)
        m0 = model_of(init["init_leaves"])
        q = dict(grid=grid, n=int(Xs.shape[0]), tier=icm.nll_chol_tier(m0, Xs, Y),
                 launches=launches, seconds=elapsed,
                 start_nll=float(icm.neg_log_marginal_likelihood_chol(m0, Xs, Y)),
                 final_nll=float(res.fit.loss), iters=int(res.fit.iters),
                 kernel_variance=float(m.kernel.variance), B=m.B.double().cpu().tolist(),
                 kvB=(m.kernel.variance * m.B).double().cpu().tolist(),
                 kernel_lengthscale=float(m.kernel.lengthscales),
                 noise_variance=float(m.likelihood.variance),
                 mu=np.asarray(res.mu, float).tolist(), Sigma=np.asarray(res.Sigma, float).tolist(),
                 frontier=_frontier_dict(res.frontier), replay={})
        if not replay:
            return elapsed, q
        for tag, g in (("f64", goldens), ("f32", goldens32)):
            mg = model_of(g["final_leaves"])
            mu, S = icm.posterior_asset_moments_chol(mg, Xs, Y, Xnew)
            q["replay"][tag] = dict(nll=float(icm.neg_log_marginal_likelihood_chol(mg, Xs, Y)),
                                    mu=mu.double().cpu().tolist(),
                                    Sigma=S.double().cpu().tolist())
        t = time.perf_counter()
        fr = efficient_frontier(goldens["mu"], goldens["Sigma"],
                                risk_free_rate=FRONTIER_ARGS["risk_free_rate"], device=device,
                                dtype=dtype)
        q["replay"]["f64"]["frontier"] = _frontier_dict(fr)
        q["replay"]["frontier_seconds"] = time.perf_counter() - t
    return elapsed, q


# Tolerances of the frontier run against the JAX goldens (PERF.md, the
# frontier slice).
# The ICM fit's outcome is not a float32-stable quantity: the first L-BFGS
# step from W₀ meets B = WWᵀ + I with 17 tied eigenvalues, where safe_eigh's
# VJP depends on the basis eigh picks (JAX and torch pick differently), and
# the NLL is flat along the kernel variance × B trade-off and the
# lengthscale. JAX's own float32 run ends in another basin than its float64
# run on the one-year grid (NLL −19842.6 against −15005.1, lengthscale
# 0.00036 against 143) and near it on the five-year grid (−73839.7 against
# −73868.1). So the fit is held where it must agree — the NLL at W₀ and at
# each golden's final leaves, (μ, Σ) at those leaves and the frontier of
# the golden's (μ, Σ), all at the same inputs as JAX (float32 rounding
# only) — and its outcome within JAX's own float32-to-float64 spread. That
# spread is one sample of where a float32 fit lands, and the port's fit is
# another: on an H100 the five-year fit ended at NLL −73848.8, between JAX's
# two, with a tangency return 6.5e-5 from the float64 golden's where JAX's
# float32 run lies 1.8e-5 from it. Hence four times the spread.
FRONTIER_NLL_RTOL = 1e-4   # an NLL at the same leaves as JAX
FRONTIER_FIT_RTOL = 1e-3   # the final NLL, beyond the two goldens' range
FRONTIER_MU_ATOL = 1e-3    # replayed μ, of max |μ| (or of 1e-6 where μ is 0)
FRONTIER_SIGMA_RTOL = 1e-4  # replayed Σ, of max |Σ|
FRONTIER_CURVE_RTOL = 2e-2  # replayed frontier returns and volatilities, of their max
FRONTIER_WEIGHT_ATOL = 0.05  # replayed tangency weights
FRONTIER_SPREAD = 4.0      # the fit's outcome: this many times JAX's float32 spread
FRONTIER_SPREAD_FLOOR = 2e-2  # ... plus this much of the quantity's largest value


def _fit_quantities(q):
    f = q["frontier"]
    return {"kernel variance × B": np.asarray(q.get("kvB", q["B"]), float),
            "lengthscale": np.asarray([q["kernel_lengthscale"]]),
            "noise variance": np.asarray([q["noise_variance"]]),
            "mu": np.asarray(q["mu"]), "Sigma": np.asarray(q["Sigma"]),
            "tangency weights": np.asarray(f["tangency_weights"]),
            "tangency return": np.asarray([f["tangency_return"]]),
            "tangency volatility": np.asarray([f["tangency_volatility"]]),
            "frontier returns": np.asarray(f["returns"]),
            "frontier volatilities": np.asarray(f["volatilities"])}


def frontier_structure(mu, Sigma, frontier):
    """bench_frontier.py's gates: finite μ and Σ, Σ symmetric and PSD, the
    tangency weights on the simplex, volatility monotone in return."""
    bad = []
    mu, Sigma = np.asarray(mu), np.asarray(Sigma)
    if not (np.all(np.isfinite(mu)) and np.all(np.isfinite(Sigma))):
        return ["non-finite mu or Sigma"]
    if np.abs(Sigma - Sigma.T).max() > 1e-6 * np.abs(Sigma).max():
        bad.append("Sigma not symmetric")
    if np.linalg.eigvalsh(0.5 * (Sigma + Sigma.T)).min() < -1e-8:
        bad.append("Sigma not PSD")
    w = np.asarray(frontier["tangency_weights"])
    if not (abs(w.sum() - 1.0) < 1e-4 and np.all(w >= -1e-6)):
        bad.append(f"tangency weights off the simplex (sum {w.sum():.6g}, min {w.min():.3g})")
    rets, vols = np.asarray(frontier["returns"]), np.asarray(frontier["volatilities"])
    if not np.all(np.diff(vols[np.argsort(rets)]) > -1e-6):
        bad.append("frontier volatility not monotone in sorted return")
    return bad


def compare_frontier(q, goldens, goldens32):
    """(ok, list of failures) of a run_frontier quality dict against the JAX
    float64 goldens and JAX's float32 run of the same pipeline:
    - N and the ICM NLL's tier (the float32 golden's);
    - the NLL at W₀ against JAX float32's, and the replayed NLLs at each
      golden's final leaves against that golden's final NLL
      (FRONTIER_NLL_RTOL);
    - the replayed (μ, Σ) at each golden's leaves (FRONTIER_MU_ATOL,
      FRONTIER_SIGMA_RTOL) and the frontier of the float64 golden's (μ, Σ)
      (FRONTIER_CURVE_RTOL, FRONTIER_WEIGHT_ATOL);
    - the final NLL within the range of the two goldens' final NLLs, ±
      FRONTIER_FIT_RTOL (a stalled fit stays near its start, 36% to 64%
      above that range);
    - the fit's hyperparameters (kernel variance × B, lengthscale, noise
      variance), μ, Σ, tangency portfolio and frontier curve within
      FRONTIER_SPREAD times JAX's own float32-to-float64 spread plus
      FRONTIER_SPREAD_FLOOR of the largest value;
    - `frontier_structure` on the fit's μ, Σ and frontier."""
    bad = []
    if q["n"] != goldens["n"]:
        return False, [f"N {q['n']} != {goldens['n']}"]
    if q["tier"] != goldens32["tier_f32"]:
        bad.append(f"tier {q['tier']} != {goldens32['tier_f32']}")

    def nll_near(name, x, want):
        if not abs(x - want) <= FRONTIER_NLL_RTOL * abs(want):
            bad.append(f"{name} {x:.8g} vs {want:.8g}")

    nll_near("NLL at W0", q["start_nll"], goldens32["start_nll"])
    for tag, g in (("f64", goldens), ("f32", goldens32)):
        r = q["replay"][tag]
        nll_near(f"NLL at the {tag} golden's leaves", r["nll"], g["final_nll"])
        scale = max(np.abs(g["mu"]).max(), 1e-6)
        err = np.abs(np.asarray(r["mu"]) - g["mu"]).max()
        if not err <= FRONTIER_MU_ATOL * scale:
            bad.append(f"mu at the {tag} golden's leaves: |err| {err:.3g} > "
                       f"{FRONTIER_MU_ATOL} x {scale:.3g}")
        scale = np.abs(g["Sigma"]).max()
        err = np.abs(np.asarray(r["Sigma"]) - g["Sigma"]).max()
        if not err <= FRONTIER_SIGMA_RTOL * scale:
            bad.append(f"Sigma at the {tag} golden's leaves: |err| {err:.3g} > "
                       f"{FRONTIER_SIGMA_RTOL} x {scale:.3g}")
    rf, gf = q["replay"]["f64"]["frontier"], goldens["frontier"]
    for key in ("returns", "volatilities"):
        scale = np.abs(gf[key]).max()
        err = np.abs(np.asarray(rf[key]) - gf[key]).max()
        if not err <= FRONTIER_CURVE_RTOL * scale:
            bad.append(f"frontier {key} of the golden's (mu, Sigma): |err| {err:.3g} > "
                       f"{FRONTIER_CURVE_RTOL} x {scale:.3g}")
    err = np.abs(np.asarray(rf["tangency_weights"]) - gf["tangency_weights"]).max()
    if not err <= FRONTIER_WEIGHT_ATOL:
        bad.append(f"tangency weights of the golden's (mu, Sigma): |err| {err:.3g}")
    for key in ("tangency_return", "tangency_volatility"):
        if not abs(rf[key] - gf[key]) <= FRONTIER_CURVE_RTOL * abs(gf[key]):
            bad.append(f"{key} of the golden's (mu, Sigma): {rf[key]:.6g} vs {gf[key]:.6g}")

    lo = min(goldens["final_nll"], goldens32["final_nll"])
    hi = max(goldens["final_nll"], goldens32["final_nll"])
    tol = FRONTIER_FIT_RTOL * abs(goldens["final_nll"])
    if not (np.isfinite(q["final_nll"]) and lo - tol <= q["final_nll"] <= hi + tol):
        bad.append(f"final NLL {q['final_nll']:.8g} outside [{lo:.8g}, {hi:.8g}] ± {tol:.3g}")
    g64, g32 = (_fit_quantities(dict(g, kvB=(np.asarray(g["B"]) * g["kernel_variance"])))
                for g in (goldens, goldens32))
    for name, x in _fit_quantities(q).items():
        if x.shape != g64[name].shape or not np.all(np.isfinite(x)):
            bad.append(f"{name}: shape {x.shape} or non-finite values")
            continue
        spread = np.abs(g32[name] - g64[name]).max()
        lim = FRONTIER_SPREAD * spread + FRONTIER_SPREAD_FLOOR * np.abs(g64[name]).max()
        err = np.abs(x - g64[name]).max()
        if not err <= lim:
            bad.append(f"{name}: |err| {err:.3g} against the float64 golden > {lim:.3g} "
                       f"(JAX float32 spread {spread:.3g})")
    bad += frontier_structure(q["mu"], q["Sigma"], q["frontier"])
    return not bad, bad


def run_single_asset(data_root: str, device="cuda", dtype=torch.float32, fast=None):
    """The port's `StockPredictor.run_ticker` on the single-asset market with
    the 8-entry default menu, σ² = 1e-5 frozen, maxiter 100, the Zero mean
    and a 30-day horizon. Returns (elapsed_s, quality): per timescale N,
    the menu's tiers, winner, train MSEs and losses, the (tier, N) pairs the
    router recorded, the seconds; α, β and the blended f_mean/f_var."""
    from portfoliooptgp_tpu_torch.models import gpr
    from portfoliooptgp_tpu_torch.pipelines import StockPredictor

    def sync():
        if str(device).startswith("cuda"):
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    sp = StockPredictor([SINGLE_ASSET_TICKER], data_root=data_root, horizon_days=30,
                        device=device, dtype=dtype, fast=fast, **SINGLE_ASSET_DATES)
    train_timeframe = sp._train_timeframe
    seconds, dispatched = {}, {}

    def timed(ticker, tag):
        gpr.DISPATCH_EVENTS.clear()
        t = time.perf_counter()
        out = train_timeframe(ticker, tag)
        sync()
        seconds[tag] = time.perf_counter() - t
        dispatched[tag] = sorted({(e["tier"], e["n"]) for e in gpr.DISPATCH_EVENTS})
        return out

    sp._train_timeframe = timed
    res = sp.run_ticker(SINGLE_ASSET_TICKER)
    sync()
    elapsed = time.perf_counter() - t0
    timescales = {tag: dict(n=int(r.X.shape[0]), tiers=r.menu.tiers, best_index=r.kernel_index,
                            mses=r.menu.mses, losses=r.menu.losses, seconds=seconds[tag],
                            dispatched=dispatched[tag])
                  for tag, r in res.timeframes.items()}
    return elapsed, dict(timescales=timescales, alpha=res.alpha, beta=res.beta,
                         n_daily=int(res.timeframes["d"].X.shape[0]),
                         f_mean=res.f_mean.double().cpu().reshape(-1).tolist(),
                         f_var=res.f_var.double().cpu().reshape(-1).tolist())


# -- the NUTS slice ------------------------------------------------------------
# bench.py's NUTS workload (bench.py:225-270): 8 chains over the hyperposterior
# of a GPR with an ARD SquaredExponential over D = 4 inputs on N = 512 points
# (6 raw hyperparameters), centered_normal_logprior(m0), a dense mass, max_depth
# 8, 100 warmup and 200 sampling transitions, float32; every leapfrog one
# chain-batched value+grad (`gpr_logdensity_vg`).
NUTS_N, NUTS_D = 512, 4
NUTS_BENCH = dict(num_chains=8, num_warmup=100, num_samples=200, max_depth=8,
                  dense_mass=True)
NUTS_GOLDENS = os.path.join(REPO, "tests", "goldens_torch", "nuts_bench.json")
# The frontier's NUTS on grid A as phase 11c runs it: 2 chains (the library's
# default), the CLI's depth 6, 50 + 50 transitions.
FRONTIER_NUTS = dict(nuts_chains=2, nuts_warmup=50, nuts_samples=50, nuts_max_depth=6)
FRONTIER_NUTS_GOLDENS = os.path.join(REPO, "tests", "goldens_torch", "frontier_1y_nuts.json")
NUTS_SEEDS = (0, 1, 2)  # the golden runs' keys
# The frontier's golden NUTS runs: 50 + 50 transitions from the maximum
# likelihood fit, whose raw kernel variance (−252) the N(0, 1) prior pulls
# towards 0, leave the chains in transit, so a run's outcome varies widely
# with its key; eight keys estimate that spread.
FRONTIER_NUTS_SEEDS = tuple(range(8))
NUTS_SPREAD = 4.0  # a port run within this many times JAX's seed-to-seed spread, or MC error


def nuts_bench_data():
    """bench.py's posterior data, float32 as bench.py makes it: X (512, 4)
    uniform on [0, 60), Y (512, 1) a smooth function of three inputs plus
    0.1·N(0, 1), from np.random.default_rng(0)."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 60, (NUTS_N, NUTS_D)).astype(np.float32)
    f = (np.sin(X[:, 0] / np.float32(8.0)) + np.float32(0.3) * np.cos(X[:, 1] / np.float32(5.0))
         + np.float32(0.05) * X[:, 2] / np.float32(10.0))
    Y = (f + np.float32(0.1) * rng.normal(size=(NUTS_N,)).astype(np.float32))[:, None]
    return X, Y


def nuts_summary(draws, accept_prob, num_leaves, diverging, inv_mass, step_size):
    """What compare_nuts holds of a run: draws (C, S, d) of the raw
    hyperparameters in ravel order; the posterior mean and standard
    deviation of each, their Monte Carlo standard errors from the spread of
    the C chains' own means and deviations, the adapted inverse metric's
    diagonal, the step size, the mean acceptance and leaves per transition,
    and the divergences."""
    draws = np.asarray(draws, float)
    accept_prob, num_leaves, diverging, step_size = (
        np.asarray(x, float) for x in (accept_prob, num_leaves, diverging, step_size))
    C, _, d = draws.shape
    flat = draws.reshape(-1, d)
    im = np.asarray(inv_mass, float)[0]
    root_c = np.sqrt(C)
    return dict(mean=flat.mean(0).tolist(), sd=flat.std(0, ddof=1).tolist(),
                mcse_mean=(draws.mean(1).std(0, ddof=1) / root_c).tolist(),
                mcse_sd=(draws.std(1, ddof=1).std(0, ddof=1) / root_c).tolist(),
                inv_mass_diag=(np.diagonal(im) if im.ndim == 2 else im).tolist(),
                step_size=float(np.mean(step_size)),
                accept=float(np.mean(accept_prob)), leaves=float(np.mean(num_leaves)),
                divergences=int(np.sum(diverging)))


def compare_nuts(q, goldens):
    """Failures (empty when the run passes) of a run's `nuts_summary` against
    the JAX float64 runs of `goldens["runs"]`: each raw hyperparameter's
    posterior mean and standard deviation within the runs' mean ± max(4 ×
    their seed-to-seed spread, 4 × the Monte Carlo standard error of a run
    of this workload), the log of the adapted metric's diagonal within 4 ×
    the runs' spread of it (or log 2, the least that a 75-draw variance
    estimate can promise), the mean acceptance in (0.5, 1.0) as bench.py
    asserts. A run's standard error is estimated from its 8 chains' spread,
    itself uncertain by ~25%, so the largest of the four estimates (this
    run's and the goldens') is taken: JAX's own float32 run lies 5.9 of its
    own estimates from the float64 runs in one standard deviation (the
    fourth lengthscale's, a prior-dominated tail), 0.72 of the limit."""
    runs = goldens["runs"]
    bad = []
    for key, err in (("mean", "mcse_mean"), ("sd", "mcse_sd")):
        ref = np.array([r[key] for r in runs])
        center, spread = ref.mean(0), np.ptp(ref, axis=0)
        mcse = np.max([q[err]] + [r[err] for r in runs], axis=0)
        lim = np.maximum(NUTS_SPREAD * spread, NUTS_SPREAD * mcse)
        dev = np.abs(np.asarray(q[key]) - center)
        for i in np.flatnonzero(~(dev <= lim)):
            bad.append(f"posterior {key} of dim {i}: {q[key][i]:.6g}, JAX {center[i]:.6g} "
                       f"± {lim[i]:.3g}")
    ref = np.log(np.array([r["inv_mass_diag"] for r in runs]))
    lim = np.maximum(NUTS_SPREAD * np.ptp(ref, axis=0), np.log(2.0))
    dev = np.abs(np.log(np.asarray(q["inv_mass_diag"])) - ref.mean(0))
    for i in np.flatnonzero(~(dev <= lim)):
        bad.append(f"adapted inverse metric of dim {i}: {q['inv_mass_diag'][i]:.4g}, JAX "
                   f"{np.exp(ref.mean(0)[i]):.4g} (log ± {lim[i]:.3g})")
    if not 0.5 < q["accept"] < 1.0:
        bad.append(f"mean acceptance {q['accept']:.4f} outside (0.5, 1.0)")
    return bad


def frontier_nuts_distances(q, runs):
    """How far a frontier NUTS outcome lies from the JAX runs `runs`: the
    root mean square over entries of (q − mean) / sd of μ and of Σ's upper
    triangle (mean and sd over the runs), and the L1 distance of the
    tangency weights from the runs' mean weights."""
    out = {}
    for key in ("mu", "Sigma"):
        ref = np.array([r[key] for r in runs])
        x = np.asarray(q[key], float)
        if key == "Sigma":
            iu = np.triu_indices(ref.shape[1])
            ref, x = ref[:, iu[0], iu[1]], x[iu]
        z = (x - ref.mean(0)) / ref.std(0, ddof=1)
        out[key] = float(np.sqrt(np.mean(z * z)))
    w = np.array([r["tangency_weights"] for r in runs])
    out["tangency_weights"] = float(np.abs(np.asarray(q["tangency_weights"]) - w.mean(0)).sum())
    return out


def frontier_nuts_limits(goldens):
    """NUTS_SPREAD × the largest `frontier_nuts_distances` of a JAX run from
    the other runs (leave one out): JAX's own spread of the outcome."""
    runs = goldens["runs"]
    loo = [frontier_nuts_distances(r, runs[:i] + runs[i + 1:]) for i, r in enumerate(runs)]
    return {k: NUTS_SPREAD * max(d[k] for d in loo) for k in loo[0]}


def compare_frontier_nuts(q, goldens):
    """Failures of the frontier's NUTS-averaged μ, Σ and tangency weights
    against the JAX float64 runs of `goldens["runs"]` (eight keys).

    50 + 50 transitions from the maximum-likelihood fit leave the chains in
    transit (JAX's acceptance 0.12–0.42), so a run's outcome varies widely
    and with heavy tails across keys: holding each entry within 4 × the
    spread of three runs fails JAX's own runs against each other in 99% of
    the ways to pick them. The rule: μ's and Σ's root-mean-square
    standardized distance from the runs (`frontier_nuts_distances`) within
    4 × the largest such distance of a JAX run from the others
    (`frontier_nuts_limits`). The tangency portfolio of such an average is
    a corner solution that JAX's own runs do not agree on (L1 distances up
    to 1.69 of a possible 2), so the weights are held to the simplex only
    and their distance is reported."""
    bad = []
    dist, lim = frontier_nuts_distances(q, goldens["runs"]), frontier_nuts_limits(goldens)
    for key in ("mu", "Sigma"):
        if not dist[key] <= lim[key]:
            bad.append(f"frontier NUTS {key}: standardized RMS distance {dist[key]:.3g} from the "
                       f"JAX runs > {lim[key]:.3g}")
    w = np.asarray(q["tangency_weights"], float)
    if not (np.all(w >= -1e-6) and abs(w.sum() - 1.0) <= 1e-4):
        bad.append(f"frontier NUTS tangency weights off the simplex: sum {w.sum():.6g}, "
                   f"min {w.min():.3g}")
    for key in ("mu", "Sigma"):
        if not np.all(np.isfinite(q[key])):
            bad.append(f"frontier NUTS {key} not finite")
    return bad


def flat_draws(samples):
    """(C, S, d) raw draws of a `sample_nuts` result, in ravel order."""
    from portfoliooptgp_tpu_torch.params import tree_leaves

    leaves = tree_leaves(samples)
    return torch.cat([x.reshape(x.shape[0], x.shape[1], -1) for x in leaves], dim=-1)


def nuts_bench_model(device=DEVICE, dtype=torch.float32):
    """bench.py's m0: GPR(SE(1.0, [8.0] * 4), noise 0.1)."""
    from portfoliooptgp_tpu_torch import kernels as tk
    from portfoliooptgp_tpu_torch.models import gpr

    return gpr.GPR.create(tk.SquaredExponential.create(1.0, np.full(NUTS_D, 8.0), device=device,
                                                       dtype=dtype), noise_variance=0.1)


def run_nuts_bench(seed: int, device=DEVICE, dtype=torch.float32, n: int = NUTS_N, **config):
    """bench.py's NUTS workload through the port's `sample_nuts` (NUTS_BENCH,
    overridden by `config`; the first `n` data rows), drawing from a
    `torch.Generator` seeded `seed`. Returns its `nuts_summary` with the
    seconds, the log-density evaluations (`vg`: value+grad, the leaves and
    the start; `logp`: value only, the initial step-size search), the
    stationary kernel's launches and the host syncs of the NUTS loops."""
    from portfoliooptgp_tpu_torch.inference import (centered_normal_logprior,
                                                    gpr_logdensity_pair, gpr_logdensity_vg,
                                                    nuts, sample_nuts)

    X, Y = (torch.as_tensor(a[:n], device=device, dtype=dtype) for a in nuts_bench_data())
    m0 = nuts_bench_model(device, dtype)
    prior = centered_normal_logprior(m0)
    logp, _ = gpr_logdensity_pair(X, Y, prior)
    vg = gpr_logdensity_vg(X, Y, prior)
    evals = {"vg": 0, "logp": 0}

    def counted(name, fn):
        def call(m):
            evals[name] += 1
            return fn(m)
        return call

    cuda = torch.device(device).type == "cuda"
    _reset_launch_counts()
    syncs = dict(nuts.SYNCS)
    t0 = time.perf_counter()
    samples, stats = sample_nuts(counted("logp", logp), m0,
                                 torch.Generator(device=device).manual_seed(seed),
                                 vg_fn=counted("vg", vg), device=device,
                                 **dict(NUTS_BENCH, **config))
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    cfg = dict(NUTS_BENCH, **config)
    q = nuts_summary(flat_draws(samples).cpu(), stats.accept_prob.cpu(), stats.num_leaves.cpu(),
                     stats.diverging.cpu(), stats.inv_mass.cpu(), stats.step_size.cpu())
    q.update(seconds=elapsed, evals=evals, launches=_launch_counts(),
             syncs={k: nuts.SYNCS[k] - syncs[k] for k in syncs},
             draws_per_s=cfg["num_chains"] * (cfg["num_warmup"] + cfg["num_samples"]) / elapsed)
    return q


def run_frontier_nuts(data_root: str, goldens, device=DEVICE, dtype=torch.float32):
    """`run_frontier_pipeline(use_nuts=True)` on grid 1y (made by
    make_frontier_market in data_root) with FRONTIER_ARGS and FRONTIER_NUTS,
    from the JAX float64 fit's leaves (`goldens`: frontier_1y.json) with
    maxiter 0, where the golden NUTS runs start: a float32 fit from W₀ ends
    in a basin that moves with rounding (PERF.md, PR 5; phase 8 holds it),
    and NUTS over 50 + 50 transitions does not leave it. Returns the
    seconds, nuts_draws, the kernel launches, the batch sizes the
    stationary kernel was launched at (a count per batch), μ, Σ and the
    tangency portfolio."""
    from collections import Counter

    from portfoliooptgp_tpu_torch import kernels as tk
    from portfoliooptgp_tpu_torch.data.handler import DataHandler
    from portfoliooptgp_tpu_torch.models import icm
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st
    from portfoliooptgp_tpu_torch.params import from_jax_leaves
    from portfoliooptgp_tpu_torch.pipelines import run_frontier_pipeline

    names = goldens["assets"]
    dh = DataHandler(data_root=data_root, device=device, dtype=dtype, **frontier_dates("1y"))
    template = icm.ICMGPR.create(tk.SquaredExponential.create(device=device, dtype=dtype),
                                 len(names), rank=FRONTIER_ARGS["rank"])
    model0 = from_jax_leaves(template, [np.asarray(x) for x in goldens["final_leaves"]])
    batches = Counter()
    launch = st.stationary_nll_forward_cuda

    def observed(*args):
        batches[int(args[4].shape[0])] += 1  # err (B, N)
        return launch(*args)

    _reset_launch_counts()
    st.stationary_nll_forward_cuda = observed
    try:
        t0 = time.perf_counter()
        res = run_frontier_pipeline(names, dh, model0=model0, device=device, dtype=dtype,
                                    **dict(FRONTIER_ARGS, maxiter=0, use_nuts=True,
                                           **FRONTIER_NUTS))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        st.stationary_nll_forward_cuda = launch
    return dict(seconds=elapsed, nuts_draws=res.nuts_draws, launches=_launch_counts(),
                batches=dict(batches), mu=np.asarray(res.mu, float).tolist(),
                Sigma=np.asarray(res.Sigma, float).tolist(),
                tangency_weights=np.asarray(res.frontier.tangency_weights, float).tolist(),
                tangency_return=float(res.frontier.tangency_return))


# -- helpers ----------------------------------------------------------------

def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 50, stream=None, calls: int = 1) -> float:
    """Mean device time of fn()'s kernels in ms: fn is captured once in a
    CUDA graph on `stream` (a new side stream by default, after 3 warm-up
    calls there) and the graph replayed `reps` times between CUDA events.
    No host work is timed: no allocation, argument check or launch call.
    With `calls` > 1 the graph holds that many calls back to back and the
    time is per call, less the replay's own launch latency (about 1 µs on
    the H100: PERF.md, PR 13)."""
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def nll_bound_ms(B, N, J, JD, masked, with_inverse):
    """Least time for the fused NLL on an H100: the larger of the bytes it
    must move (inputs read once, outputs written once) over HBM bandwidth
    and its fp32 operations over the fp32 peak. Only the lower triangle of
    each shared d2 matrix is read, N(N+1)/2 entries. Operations per model:
    factor N³/3, inverse N³/3 (when W is formed), the forward solve N²,
    ‖a‖² 2N, and the build of the lower triangle, N(N+1)/2 × (2·JD + 2·J)."""
    flops = B * (N ** 3 / 3 + (N ** 3 / 3 if with_inverse else 0) + N * N + 2 * N
                 + N * (N + 1) / 2 * (2 * JD + 2 * J))
    nbytes = 4 * (JD * N * (N + 1) / 2 + B * N * (2 if masked else 1) + B * (2 * J + JD + 1)
                  + B + B * N + (B * N * N if with_inverse else 0))
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _max_err(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float(torch.max(torch.abs(got - want)))


def _check_values(name, got, want):
    if not torch.all(torch.isfinite(got)):
        raise AssertionError(f"{name}: non-finite kernel value")
    rel = float(torch.max(torch.abs(got - want) / torch.abs(want)))
    if rel > VALUE_RTOL:
        raise AssertionError(f"{name}: value rel err {rel:.3e} > {VALUE_RTOL}")
    return rel


def _check_grads(name, got, want):
    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if not torch.all(torch.isfinite(g)):
            raise AssertionError(f"{name}: non-finite kernel gradient {k}")
        scale = max(float(torch.max(torch.abs(w))), 1.0)
        err = _max_err(g, w) / scale
        worst = max(worst, err)
        if err > GRAD_ATOL:
            raise AssertionError(f"{name}: gradient {k} normalized err {err:.3e} > {GRAD_ATOL}")
    return worst


def general_operands(families, dims, B, N, masked, seed):
    """Random float32 operands for the general NLL on the card
    (`general_operands_np`'s, rounded to float32)."""
    d2s, err, vs, ls, als, noise, mask = general_operands_np(families, dims, B, N, masked, seed)

    def t(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=DEVICE)

    return ([t(d) for d in d2s], t(err), [t(v) for v in vs], [t(l) for l in ls],
            [t(a) for a in als], t(noise), t(mask))


def general_operands_np(families, dims, B, N, masked, seed):
    """Random float64 operands for the general NLL, as numpy arrays: per-dim
    squared distances of sorted inputs (a scaled Gram matrix for 'linear'),
    prefix masks when `masked`."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 30, (N, max(dims))), axis=0)
    d2s = []
    for fam, dj in zip(families, dims):
        for d in range(dj):
            x = X[:, d]
            d2s.append(np.outer(x, x) / 900.0 if fam == "linear"
                       else (x[:, None] - x[None, :]) ** 2)
    keep = N - (np.arange(B) * N) // (4 * B) if masked else np.full(B, N)
    mask = (np.arange(N)[None, :] < keep[:, None]).astype(np.float64)
    err = rng.normal(size=(B, N)) * mask
    J, JD = len(families), len(d2s)
    vs = [rng.uniform(0.5, 2.0, B) for _ in range(J)]
    ls = [rng.uniform(3.0, 8.0, B) for _ in range(JD)]
    for j, fam in enumerate(families):  # the linear atom's ls slot is pinned to 1
        if fam == "linear":
            ls[sum(dims[:j])] = np.ones(B)
    als = [rng.uniform(1.0, 3.0, B) for _ in range(J)]
    noise = rng.uniform(0.05, 0.3, B)
    return d2s, err, vs, ls, als, noise, mask


def check_general(name, families, dims, combine, B, N, masked, seed):
    """Kernel vs plain, values and gradients of every operand: once with the
    d2 matrices needing a gradient (the torch closed form's backward) and
    once without, as the main path calls it (the backward kernel, one
    launch), its gradients against the plain version's of the same
    operands."""
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    d2s, err, vs, ls, als, noise, mask = general_operands(families, dims, B, N, masked, seed)
    fns = {"prod": (st.batched_nll_stationary_general, st.batched_nll_stationary_general_plain),
           "sum": (st.batched_nll_stationary_sum, st.batched_nll_stationary_sum_plain)}[combine]
    J, JD = len(vs), len(d2s)

    def run(fn, d2_grad):
        leaves = [x.clone().requires_grad_(True) for x in [err, noise] + vs + ls + als]
        d = [x.clone().requires_grad_(d2_grad) for x in d2s]
        e, nz = leaves[:2]
        v, l, a = leaves[2:2 + J], leaves[2 + J:2 + J + JD], leaves[2 + J + JD:]
        nll = fn(families, d, e, v, l, a, nz, mask, dims=dims)
        return nll.detach(), torch.autograd.grad(nll.sum(), leaves + (d if d2_grad else []))

    want, got = run(fns[1], True), run(fns[0], True)
    before = st.kernel_launches()["grad"]
    fused = run(fns[0], False)
    torch.cuda.synchronize()
    if st.kernel_launches()["grad"] != before + 1:
        raise AssertionError(f"{name}: the backward kernel did not run once")
    verr = _check_values(name, got[0], want[0])
    gerr = max(_check_grads(name, got[1], want[1]),
               _check_grads(f"{name} (backward kernel)", fused[1], want[1][:len(fused[1])]))
    print(f"check {name}: B={B} N={N} value rel err {verr:.3e}, "
          f"grad normalized err {gerr:.3e} (both backwards)", flush=True)
    return _max_err(got[0], want[0])


def check_single(name, family, B, N, seed):
    """check_general for the single-family path (`batched_nll_stationary`)."""
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    d2s, err, vs, ls, _, noise, _ = general_operands((family,), (1,), B, N, False, seed)

    def run(fn, d2_grad):
        d2 = d2s[0].clone().requires_grad_(d2_grad)
        leaves = [x.clone().requires_grad_(True) for x in (err, vs[0], ls[0], noise)]
        nll = fn(d2, *leaves, family)
        return nll.detach(), torch.autograd.grad(nll.sum(), leaves + ([d2] if d2_grad else []))

    want, got = run(st.batched_nll_stationary_plain, True), run(st.batched_nll_stationary, True)
    before = st.kernel_launches()["grad"]
    fused = run(st.batched_nll_stationary, False)
    torch.cuda.synchronize()
    if st.kernel_launches()["grad"] != before + 1:
        raise AssertionError(f"{name}: the backward kernel did not run once")
    verr = _check_values(name, got[0], want[0])
    gerr = max(_check_grads(name, got[1], want[1]),
               _check_grads(f"{name} (backward kernel)", fused[1], want[1][:4]))
    print(f"check {name}: B={B} N={N} value rel err {verr:.3e}, "
          f"grad normalized err {gerr:.3e} (both backwards)", flush=True)
    return _max_err(got[0], want[0])


# The tile kernel's edges (N = 32 T and one row either side); past them the
# cluster kernel's: the first N, grid A's 262, both sides of T = 9 .. 10 and
# 10 .. 11, of the smallest cluster size's steps (C = 2 up to 352, 4 up to
# 448, 8 up to 512) and of T = 13 .. 14, 300 and 400, and the window's top.
STATIONARY_EDGES = (1, 31, 32, 33, 64, 65, 255, 256)
STATIONARY_CLUSTER_NS = (257, 262, 288, 289, 300, 320, 321, 352, 353, 400, 416, 417, 448, 449,
                         512)
# The shapes timed (`stationary_times`): label → (families, dims, B, N, masked).
STATIONARY_TIMED = {
    "walk-forward": (("matern12", "matern12"), (1, 1), 5, 77, True),
    "headline": (("se",), (1,), 128, 256, False),
    "weekly menu": (("se",), (1,), 1, 175, False),
    "monthly menu": (("se",), (1,), 1, 40, False),
    "frontier grid A": (("se",), (1,), 20, 262, False),  # the cluster kernel from here on
    "NUTS bench": (("se",), (4,), 8, 512, False),  # bench.py's posterior: 8 chains, ARD D = 4
    "frontier NUTS": (("se",), (1,), 40, 262, False),  # grid A's ICM under 2 chains: C·P = 40
    "two-year walk-forward": (("matern12", "matern12"), (1, 1), 5, 480, True),
}


def stationary_route(N):
    """The stationary source's kernel that runs at N: 'tile' or 'cluster'."""
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    return "tile" if N <= st.MAX_TILE_N else "cluster"


def launches_since(before):
    """Launches of the stationary source's tile and cluster kernels since
    `before` (an earlier `stationary_nll.kernel_launches()`)."""
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    now = st.kernel_launches()
    return {k: now[k] - before[k] for k in now}


def check_stationary(label, families, dims, combine, N, keeps, seed, indefinite=False):
    """Both variants of the stationary kernel (with and without W) against
    the plain version on general_operands' inputs, model b keeping its first
    keeps[b] rows (mask None when every model keeps all N). Models the plain
    version factors: the NLL, a and W within VALUE_RTOL of their largest
    value, or within four times the plain version's own float32 error
    against its float64 run where that is larger. Models whose factor fails
    (the plain version's NLL is NaN): the kernel's NLL is NaN, and a and W
    are NaN exactly where the column loop (ops.nll's plain dense version, on
    the same K, at any N) has NaN. With `indefinite` the last model is made so (its
    linear atom's variance -3, and at N = 1 its noise -10) and must fail.
    Each launch must run the kernel that N routes to. Returns the largest
    absolute error over both variants."""
    from portfoliooptgp_tpu_torch.ops import nll
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    B = len(keeps)
    d2s, err, vs, ls, als, noise, _ = general_operands(families, dims, B, N, False, seed)
    mask = (torch.arange(N, device=DEVICE)[None, :]
            < torch.tensor(keeps, device=DEVICE)[:, None]).float()
    err = err * mask
    m = None if min(keeps) == N else mask
    if indefinite:
        vs[families.index("linear")][-1] = -3.0
        if N == 1:
            noise[-1] = -10.0
    D2, V, S, A = torch.stack(d2s), torch.stack(vs), 1.0 / torch.stack(ls) ** 2, torch.stack(als)
    args = (families, combine, dims, D2, err, V, S, A, noise, m)
    with torch.no_grad():
        want = st.stationary_nll_forward_plain(*args, True)
        want64 = st.stationary_nll_forward_plain(
            families, combine, dims, *(x.double() for x in (D2, err, V, S, A, noise)),
            None if m is None else m.double(), True)
        K = st.build_general_plain(families, combine, dims, D2, V, S, A, noise, m)
        loop = nll.factor_solve_inv_plain(K, err, torch.zeros_like(noise))
    bad = torch.isnan(want[0])
    if indefinite and not bool(bad[-1]):
        raise AssertionError(f"{label}: the indefinite model factors in the plain version")
    route = stationary_route(N)
    worst = 0.0
    for with_w in (True, False):
        before = st.kernel_launches()
        with torch.no_grad():
            got = st.stationary_nll_forward_cuda(*args, with_w, "stationary_nll_general")
        torch.cuda.synchronize()
        ran = launches_since(before)
        if ran[route] != 1 or sum(ran.values()) != 1:
            raise AssertionError(f"{label}: launched {ran}, not the {route} kernel once")
        if (got[1] is not None) != with_w:
            raise AssertionError(f"{label}: W returned {got[1] is not None}, asked {with_w}")
        if not torch.equal(torch.isnan(got[0]), bad):
            raise AssertionError(f"{label}: NLL NaN pattern {torch.isnan(got[0]).tolist()}, "
                                 f"plain {bad.tolist()}")
        for name, g, ref, ref64, lp in zip(("nll", "W", "a"), got, want, want64,
                                           (None, loop[2], loop[0])):
            if g is None:
                continue
            if bool(bad.any()) and lp is not None and not torch.equal(torch.isnan(g[bad]),
                                                                      torch.isnan(lp[bad])):
                raise AssertionError(f"{label} {name}: NaN pattern of the failed models differs "
                                     "from the column loop's")
            ok = ~bad
            if not bool(ok.any()):
                continue
            g, ref, ref64 = g[ok], ref[ok], ref64[ok]
            scale = max(float(ref.abs().max()), 1e-30)
            own = _max_err(ref, ref64) / scale
            e = _max_err(g, ref) / scale
            if not (torch.all(torch.isfinite(g)) and e <= max(VALUE_RTOL, 4 * own)):
                raise AssertionError(f"{label} {name}: normalized err {e:.3e} > "
                                     f"max({VALUE_RTOL}, 4 x {own:.3e})")
            worst = max(worst, _max_err(g, ref))
    return worst


def edge_keeps(N, B, masked):
    """Rows each of B models keeps at an edge check: all N, or with
    `masked` the last two models 2N // 3 and N // 8 (from N = 64 every tile
    past the first empty; above 256 every row of whole ranks of the
    cluster at N <= 263 and from 353 on at the smallest C)."""
    return (N,) * B if not masked else (N,) * (B - 2) + ((2 * N) // 3, N // 8)


def phase_stationary_edges():
    """Phase 2b. The stationary kernels at the tile kernel's edges
    (STATIONARY_EDGES) and past it (STATIONARY_CLUSTER_NS; the cluster size
    depends on N alone): both variants against the plain version
    (`check_stationary`) unmasked, masked (`edge_keeps`) and with an
    indefinite last model; values and gradients through autograd
    (`check_general`), masked and unmasked; all at B = 3. Returns the
    largest absolute error."""
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    worst = 0.0
    for i, N in enumerate(STATIONARY_EDGES + STATIONARY_CLUSTER_NS):
        seed = 40 + i
        worst = max(
            worst,
            check_stationary(f"edge N={N} unmasked se*matern32", ("se", "matern32"), (1, 1),
                             "prod", N, edge_keeps(N, 3, False), seed),
            check_stationary(f"edge N={N} masked matern12*matern12", ("matern12", "matern12"),
                             (1, 1), "prod", N, edge_keeps(N, 3, True), seed),
            check_stationary(f"edge N={N} indefinite se+linear", ("se", "linear"), (1, 1), "sum",
                             N, edge_keeps(N, 3, False), seed, indefinite=True),
            check_general(f"edge N={N} grad se", ("se",), (1,), "prod", 3, N, False, seed),
            check_general(f"edge N={N} grad masked matern12*matern12", ("matern12", "matern12"),
                          (1, 1), "prod", 3, N, True, seed))
        shape = "" if N <= st.MAX_TILE_N else f", C={st.cluster_shape(N)['C']}"
        print(f"check stationary N={N} ({stationary_route(N)} kernel{shape}): both variants "
              "match plain unmasked, masked and indefinite (NaN patterns equal)", flush=True)
    return worst


def check_timed(label, seed=31):
    """One shape of STATIONARY_TIMED on the inputs stationary_times times
    (general_operands(..., seed)): both variants' NLL, a and W against the
    plain version (`check_stationary`) and, past the tile kernel, values and
    gradients (`check_general`). Returns the largest absolute error."""
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    families, dims, B, N, masked = STATIONARY_TIMED[label]
    keeps = tuple(int(k) for k in N - (np.arange(B) * N) // (4 * B)) if masked else (N,) * B
    worst = check_stationary(f"timed {label}", families, dims, "prod", N, keeps, seed)
    print(f"check timed {label} B={B} N={N}: both variants match plain (NLL, a, W)", flush=True)
    if N > st.MAX_TILE_N:
        worst = max(worst, check_general(f"timed {label} grad", families, dims, "prod", B, N,
                                         masked, seed))
    return worst


def stationary_times(st, families, dims, B, N, masked, seed=31):
    """The stationary kernel's times on general_operands(..., seed) at one
    shape, with and without W: the kernel, the plain version and the
    torch.linalg chain (K built by build_general_plain, cholesky_ex,
    solve_triangular(L, err), with W solve_triangular(L, [err, I])) by
    CUDA-graph replay (`graph_ms`); the kernel and the chain (with
    `cholesky`) eager (`cuda_ms`); and the bound. `st` is the port's
    ops.stationary_nll module: tools/stationary_compare.py passes that of
    another checkout."""
    d2s, err, vs, ls, als, noise, mask = general_operands(families, dims, B, N, masked, seed)
    D2, V, S, A = torch.stack(d2s), torch.stack(vs), 1.0 / torch.stack(ls) ** 2, torch.stack(als)
    m = mask if masked else None
    eye = torch.eye(N, device=DEVICE).expand(B, N, N)
    single = len(families) == 1 and dims == (1,) and not masked
    counter = "stationary_nll" if single else "stationary_nll_general"

    def chain(with_w, factor):
        K = st.build_general_plain(families, "prod", dims, D2, V, S, A, noise, m)
        L = factor(K)
        rhs = torch.cat([err[:, :, None], eye], dim=-1) if with_w else err[:, :, None]
        return torch.linalg.solve_triangular(L, rhs, upper=False)

    row = {}
    with torch.no_grad():
        for with_w in (True, False):
            tag = "inv" if with_w else "value"
            args = (families, "prod", dims, D2, err, V, S, A, noise, m, with_w)
            row[f"ms_{tag}"] = graph_ms(lambda: st.stationary_nll_forward_cuda(*args, counter))
            row[f"eager_ms_{tag}"] = cuda_ms(
                lambda: st.stationary_nll_forward_cuda(*args, counter))
            row[f"plain_ms_{tag}"] = graph_ms(lambda: st.stationary_nll_forward_plain(*args),
                                              reps=5)
            row[f"library_ms_{tag}"] = graph_ms(
                lambda: chain(with_w, lambda K: torch.linalg.cholesky_ex(K)[0]))
            row[f"library_eager_ms_{tag}"] = cuda_ms(lambda: chain(with_w, torch.linalg.cholesky))
            row[f"bound_{tag}"] = nll_bound_ms(B, N, len(families), len(d2s), masked, with_w)
    return row


def report_stationary_times(phase, label, row):
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    families, dims, B, N, masked = STATIONARY_TIMED[label]
    print(f"  {phase} stationary {label} B={B} N={N} {'*'.join(families)}"
          f"{' masked' if masked else ''} ({stationary_route(N)} kernel, graph replay): kernel "
          f"with W {row['ms_inv']:.4f} ms, value only {row['ms_value']:.4f} ms; plain "
          f"{row['plain_ms_inv']:.4f} / {row['plain_ms_value']:.4f} ms; torch.linalg chain "
          f"{row['library_ms_inv']:.4f} / {row['library_ms_value']:.4f} ms; bound "
          f"{row['bound_inv'][0]:.6f} ({row['bound_inv'][1]}) / {row['bound_value'][0]:.6f} ms "
          f"({row['bound_value'][1]}); eager (CUDA events around back-to-back calls): kernel "
          f"{row['eager_ms_inv']:.4f} / {row['eager_ms_value']:.4f} ms, chain "
          f"{row['library_eager_ms_inv']:.4f} / {row['library_eager_ms_value']:.4f} ms; "
          f"occupancy {st.ctas_per_sm(N, True)} / {st.ctas_per_sm(N, False)} CTAs per SM"
          + ("" if N <= st.MAX_TILE_N else f"; cluster {json.dumps(st.cluster_shape(N))}"),
          flush=True)


def stationary_entry(row, tag):
    """One variant of a stationary_times row for the kernels JSON line."""
    return dict(ms=row[f"ms_{tag}"], eager_ms=row[f"eager_ms_{tag}"],
                plain_ms=row[f"plain_ms_{tag}"], library_ms=row[f"library_ms_{tag}"],
                bound_ms=row[f"bound_{tag}"][0], bound_by=row[f"bound_{tag}"][1])


# -- the stationary NLL backward (stationary_nll_grad_kernel) ---------------

# The shapes the backward kernel is checked and timed at (`check_grad`,
# `grad_times`): label → (families, dims, combine, B, N, masked). The main
# path's, the headline's and the cluster kernel's shapes of
# STATIONARY_TIMED, then the benchmark cells' (gpbench): the ICM model's
# 2560 single-SE models at N = 262, the NUTS cell's 128 chains of ARD SE
# over D = 4 at N = 512 and the two-year walk-forward's 80 masked rows.
GRAD_TIMED = {
    "walk-forward": (("matern12", "matern12"), (1, 1), "prod", 5, 77, True),
    "headline": (("se",), (1,), "prod", 128, 256, False),
    "frontier grid A": (("se",), (1,), "prod", 20, 262, False),
    "frontier NUTS": (("se",), (1,), "prod", 40, 262, False),
    "NUTS bench": (("se",), (4,), "prod", 8, 512, False),
    "ICM cell": (("se",), (1,), "prod", 2560, 262, False),
    "NUTS cell": (("se",), (4,), "prod", 128, 512, False),
    "two-year walk-forward cell": (("matern12", "matern12"), (1, 1), "prod", 80, 504, True),
}


def grad_bound_ms(B, N, JD):
    """Least time for the backward on an H100: the larger of N³/3 operations
    a model (the triangular product K⁻¹ = WᵀW) over the fp32 peak and W's
    lower triangle and the shared d2s' read once over HBM bandwidth."""
    flops = B * N ** 3 / 3
    nbytes = 4 * (B + JD) * N * (N + 1) / 2
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _grad_operands(st, families, dims, combine, B, N, masked, seed):
    """general_operands at one GRAD_TIMED shape, stacked as the backward
    takes them, with W and a from one forward of the kernel: (single, D2,
    err, V, L, A, noise, mask, W, a). `single` is the single-family path's
    case (one isotropic family, no mask), whose backward sees α and the
    mask as None."""
    d2s, err, vs, ls, als, noise, mask = general_operands(families, dims, B, N, masked, seed)
    D2, V, L, A = (torch.stack(x) for x in (d2s, vs, ls, als))
    single = len(families) == 1 and dims == (1,) and not masked
    if single:
        A = torch.ones_like(V)
    with torch.no_grad():
        _, W, a = st.stationary_nll_forward_cuda(
            families, combine, dims, D2, err, V, 1.0 / (L * L), A, noise,
            None if single else mask, True,
            "stationary_nll" if single else "stationary_nll_general")
    return single, D2, err, V, L, A, noise, mask, W, a


def check_grad(label, seed=41):
    """The backward kernel at one GRAD_TIMED shape as the main path calls
    it: value+grad through `batched_nll_stationary` (one unmasked isotropic
    family: `_SingleNLL`) or `batched_nll_stationary_general`
    (`_GeneralNLL`), the d2s needing no gradient, one launch of the kernel
    counted by the wrapper and by the C entry point; its gradients against
    the plain twin (`stationary_nll_grad_plain`) on the same forward's W and
    a at phase 2's tolerance. Prints each one's normalized gap, and the
    float32 torch closed form's, to the float64 closed form on that W and a.
    Returns the largest absolute error against the twin."""
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    families, dims, combine, B, N, masked = GRAD_TIMED[label]
    single, D2, err, V, L, A, noise, mask, W, a = _grad_operands(st, families, dims, combine, B,
                                                                 N, masked, seed)
    leaves = [x.clone().requires_grad_(True) for x in (err, noise, V, L, A)[:4 if single else 5]]
    before = st.LAUNCHES["stationary_nll_grad"], st.kernel_launches()["grad"]
    if single:
        nll = st.batched_nll_stationary(D2[0], leaves[0], leaves[2][0], leaves[3][0], leaves[1],
                                        families[0])
    else:
        e, nz, v, l, al = leaves
        nll = st.batched_nll_stationary_general(families, D2, e, list(v), list(l), list(al), nz,
                                                mask, dims=dims)
    got = torch.autograd.grad(nll.sum(), leaves)
    torch.cuda.synchronize()
    after = st.LAUNCHES["stationary_nll_grad"], st.kernel_launches()["grad"]
    if after != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"grad {label}: backward launches {before} -> {after}, not one")
    g = torch.ones(B, device=DEVICE)
    with torch.no_grad():
        dv, dl, dal, dnoise, derr = st.stationary_nll_grad_plain(
            families, combine, dims, D2, W, a, g, V, L, None if single else A,
            None if single else mask)
        want = [derr, dnoise, dv, dl, dal][:4 if single else 5]
        closed = st.stationary_nll_grad_torch(families, combine, dims, D2, W, a, g, V, L, A, mask,
                                              False)
        truth = st.stationary_nll_grad_torch(
            families, combine, dims, *(x.double() for x in (D2, W, a, g, V, L, A, mask)), False)
    gerr = _check_grads(f"grad {label}", got, want)
    gap64 = [max(_max_err(x, t) / max(float(t.abs().max()), 1.0)
                 for x, t in zip(xs, (truth[1], truth[5], truth[2], truth[3], truth[4])))
             for xs in (got, [closed[1], closed[5], closed[2], closed[3], closed[4]])]
    print(f"check grad {label} B={B} N={N} ({'_SingleNLL' if single else '_GeneralNLL'}, one "
          f"backward kernel launch): against the plain twin, normalized err {gerr:.3e}; to the "
          f"float64 closed form, kernel {gap64[0]:.3e}, float32 closed form {gap64[1]:.3e}",
          flush=True)
    return max(_max_err(x, w) for x, w in zip(got, want))


def grad_times(st, families, dims, combine, B, N, masked, seed=41):
    """The backward's times at one GRAD_TIMED shape on the W and a of one
    forward of the kernel: the backward kernel (`stationary_nll_grad_cuda`,
    its two launches), its plain twin and the torch closed form
    (`stationary_nll_grad_torch`) by CUDA-graph replay (`graph_ms`); the
    kernel eager (`cuda_ms`); the bound (`grad_bound_ms`). `st` is the
    port's ops.stationary_nll module: tools/grad_compare.py passes that of
    another checkout."""
    single, D2, err, V, L, A, noise, mask, W, a = _grad_operands(st, families, dims, combine, B,
                                                                 N, masked, seed)
    g = torch.linspace(-1.0, 1.5, B, device=DEVICE)
    args = (families, combine, dims, D2, W, a, g, V, L)
    fused = args + ((None, None) if single else (A, mask))
    row = {}
    with torch.no_grad():
        row["ms"] = graph_ms(lambda: st.stationary_nll_grad_cuda(*fused))
        row["eager_ms"] = cuda_ms(lambda: st.stationary_nll_grad_cuda(*fused))
        row["plain_ms"] = graph_ms(lambda: st.stationary_nll_grad_plain(*fused), reps=5)
        row["library_ms"] = graph_ms(lambda: st.stationary_nll_grad_torch(*args, A, mask, False),
                                     reps=10)
    row["bound_ms"], row["bound_by"] = grad_bound_ms(B, N, D2.shape[0])
    row["units"] = st.grad_units(N)
    return row


def report_grad_times(phase, label, row):
    families, dims, combine, B, N, masked = GRAD_TIMED[label]
    print(f"  {phase} backward {label} B={B} N={N} {'*'.join(families)}"
          f"{'' if dims == (1,) * len(dims) else f' dims {dims}'}{' masked' if masked else ''} "
          f"(graph replay): kernel {row['ms']:.4f} ms ({row['units']} CTAs a model), plain twin "
          f"{row['plain_ms']:.4f} ms, torch closed form {row['library_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']}); eager {row['eager_ms']:.4f} ms",
          flush=True)


def grad_entry(row):
    """A grad_times row for the kernels JSON line."""
    return {k: row[k] for k in ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")}


# The backward held against the JAX package's gradient: label → (families,
# dims, combine, B, N, masked, single). tests/goldens_torch/stationary_grad.json
# (tools/make_torch_goldens.py --stationary-grad) holds jax.grad of the JAX
# package's `batched_nll_stationary` (`single`) or
# `batched_nll_stationary_{general,sum}` in float64 for GRAD_GOLDEN_MODELS
# models of each case (`grad_golden_operands`); the card test
# (tests/test_torch_cuda.py) repeats them to B models.
GRAD_GOLDEN_MODELS = 4
GRAD_GOLDEN_CASES = {
    "ICM cell (2560, 262) single se": (("se",), (1,), "prod", 2560, 262, False, True),
    "headline (128, 256) single se": (("se",), (1,), "prod", 128, 256, False, True),
    "NUTS cell (128, 512) ARD se D=4": (("se",), (4,), "prod", 128, 512, False, False),
    "wf2y cell (80, 504) m12 x m12 masked": (("matern12", "matern12"), (1, 1), "prod", 80, 504,
                                             True, False),
    "5-asset (5, 77) m12 x m12 masked": (("matern12", "matern12"), (1, 1), "prod", 5, 77, True,
                                         False),
    **{f"grid A (20, 262) single {f}": ((f,), (1,), "prod", 20, 262, False, True)
       for f in ("matern12", "matern32", "matern52")},
    **{f"{f} {c} se masked (6, 300)": ((f, "se"), (1, 1), c, 6, 300, True, False)
       for f in ("se", "matern12", "matern32", "matern52", "rq", "periodic_se", "linear")
       for c in ("prod", "sum")},
}
GRAD_GOLDENS = os.path.join(REPO, "tests", "goldens_torch", "stationary_grad.json")


def grad_golden_operands(label):
    """One GRAD_GOLDEN_CASES case's operands for GRAD_GOLDEN_MODELS models,
    as float64 numpy arrays holding float32 values (what the card takes,
    exactly): `general_operands_np`'s (d2s, err, vs, ls, als, noise, mask)
    and the NLLs' cotangent g."""
    families, dims, _, _, N, masked, _ = GRAD_GOLDEN_CASES[label]
    seed = 2600 + list(GRAD_GOLDEN_CASES).index(label)
    d2s, err, vs, ls, als, noise, mask = general_operands_np(families, dims, GRAD_GOLDEN_MODELS,
                                                             N, masked, seed)

    def f32(x):
        return np.asarray(x, np.float32).astype(np.float64)

    return ([f32(d) for d in d2s], f32(err), [f32(v) for v in vs], [f32(x) for x in ls],
            [f32(x) for x in als], f32(noise), mask,
            np.linspace(-1.0, 1.5, GRAD_GOLDEN_MODELS))


def grad_golden_checksum(operands):
    """The sum of every entry of grad_golden_operands' arrays: the golden
    records it, so a numpy whose generator draws other numbers fails loudly."""
    d2s, err, vs, ls, als, noise, mask, g = operands
    return float(sum(np.sum(x) for x in [*d2s, err, *vs, *ls, *als, noise, mask, g]))


def device_busy(fn, report_name, kernel="stationary_nll"):
    """Run fn() under torch.profiler, tracing the device only: wall
    seconds, device seconds summed over CUDA kernels and copies, and the
    share of the kernels whose name holds `kernel`. The raw events are
    summed directly (`key_averages()` over the ~3·10^5 small kernels of the
    workflow takes minutes); device time by name goes to
    chiprun_out/<report_name>."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            total, count = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (total + e.duration_ns(), count + 1)
    device_ns = sum(t for t, _ in by_name.values())
    kernel_ns = sum(t for name, (t, _) in by_name.items() if kernel in name)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", report_name), "w") as fh:
        fh.write("device_ms\tcalls\tname\n")
        for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:40]:
            fh.write(f"{t / 1e6:.3f}\t{n}\t{name[:160]}\n")
    return dict(wall_s=wall, device_s=device_ns / 1e9, kernel_s=kernel_ns / 1e9)


# The sparse-variational workflow at full-AAPL scale: bench.py's SVGP problem
# (`bench.py:_svgp_problem`, copied; tests/test_torch_svgp_goldens.py holds the
# copy equal to it) trained as `train_svgp_minibatched` trains it.
SVGP_N, SVGP_M, SVGP_BATCH = 10_963, 128, 2048
SVGP_TRAIN = dict(batch_size=SVGP_BATCH, num_epochs=10, seed=0, inner_steps=8)
SVGP_GRID = 64  # predict_f points on [0, max X]
SVGP_ROUTES = ("xla", "kernel")  # the trainer's default batch phase; use_pallas=True


def svgp_problem():
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 44 * 365, size=(SVGP_N, 1))).astype(np.float32)
    Y = (np.sin(X / 200.0) + 0.1 * rng.normal(size=(SVGP_N, 1))).astype(np.float32)
    Z = np.linspace(0, X.max(), SVGP_M)[:, None].astype(np.float32)
    return X, Y, Z


def svgp_goldens_path(float32: bool = False) -> str:
    return os.path.join(REPO, "tests", "goldens_torch",
                        f"svgp_full_aapl{'_f32' if float32 else ''}.json")


def svgp_model(leaves, device=DEVICE, dtype=torch.float32):
    """The port's SVGP of the problem (SE, Gaussian, Zero mean, M = 128)
    with the given leaves (flat lists in `jax.tree.leaves` order)."""
    from portfoliooptgp_tpu_torch import kernels as tk
    from portfoliooptgp_tpu_torch.models.svgp import SVGP
    from portfoliooptgp_tpu_torch.params import tree_leaves, tree_replace

    o = dict(device=device, dtype=dtype)
    template = SVGP.create(tk.SquaredExponential.create(1.0, 300.0, **o),
                           np.zeros((SVGP_M, 1)), **o)
    return tree_replace(template, [torch.tensor(np.reshape(x, t.shape), **o)
                                   for x, t in zip(leaves, tree_leaves(template))])


def _svgp_flat(model):
    from portfoliooptgp_tpu_torch.params import tree_leaves

    return [x.detach().double().cpu().reshape(-1).tolist() for x in tree_leaves(model)]


def make_kernel_route_step(model, num_data, freeze_likelihood=True):
    """Route (ii)'s Adam step: `make_elbo_train_step`'s one-batch step with
    the loss on `gaussian_elbo_gram_fused(..., use_pallas=True)` (the trainer
    has no such switch, as the JAX trainer has none). Returns (state, step)."""
    from portfoliooptgp_tpu_torch.models import svgp as svgp_mod
    from portfoliooptgp_tpu_torch.parallel.elbo_sharded import TrainState
    from portfoliooptgp_tpu_torch.train.lbfgs import freeze_leaves
    from portfoliooptgp_tpu_torch.train.optim import Adam, make_step

    def loss(m, Xb, Yb, wb):
        return -svgp_mod.gaussian_elbo_gram_fused(m, Xb, Yb, weights=wb, num_data=num_data,
                                                  use_pallas=True)

    opt = Adam(1e-2)
    frozen = freeze_leaves(model, likelihood=True) if freeze_likelihood else None
    return TrainState(model, opt.init(model)), make_step(loss, opt, frozen)


def train_kernel_route(model0, X, Y, device=DEVICE, dtype=torch.float32):
    """Route (ii) over `MinibatchIterator(**SVGP_TRAIN)` in groups, skipping
    the all-zero batches as the trainer does: (model, real steps, last loss)."""
    from portfoliooptgp_tpu_torch.data.iterator import MinibatchIterator
    from portfoliooptgp_tpu_torch.parallel.elbo_sharded import group_step

    state, step = make_kernel_route_step(model0, X.shape[0])
    step = group_step(step)
    with MinibatchIterator(X, Y, **SVGP_TRAIN, device=device, dtype=dtype) as it:
        iters = SVGP_TRAIN["num_epochs"] * it.steps_per_epoch()
        for Xs, Ys, ws in it:
            state, loss = step(state, Xs, Ys, ws)
    return state.model, iters, loss


def run_svgp(goldens32, device=DEVICE, dtype=torch.float32):
    """Both batch-phase routes of the SVGP workflow on bench.py's problem:
    (i) `train_svgp_minibatched(**SVGP_TRAIN)`, the trainer's default
    (torch batch phase); (ii) the same iterator stream, Adam and frozen
    likelihood through `gaussian_elbo_gram_fused(use_pallas=True)`, with its
    all-zero tail batches skipped likewise. Returns the quality dict of
    `compare_svgp`: per route the seconds, real steps, the gram kernels'
    launches, the full-data ELBO at the start and at the end, the route's
    ELBO on the first batch at the start (and, route (ii), its gradient),
    the final leaves, `predict_f` on SVGP_GRID points, and the ELBOs
    replayed at JAX float32's final leaves of the same route."""
    from portfoliooptgp_tpu_torch.train import svgp_trainer

    Xn, Yn, _ = svgp_problem()
    model0 = svgp_model(goldens32["leaves_start"], device, dtype)
    q = dict(device=torch.device(device).type, routes={})
    for route in SVGP_ROUTES:
        _reset_launch_counts()
        t0 = time.perf_counter()
        if route == "xla":
            res = svgp_trainer.train_svgp_minibatched(model0, Xn, Yn, **SVGP_TRAIN)
            model, iters, train_elbo = res.model, res.iters, res.elbo
        else:
            model, iters, loss = train_kernel_route(model0, Xn, Yn, device, dtype)
            train_elbo = -float(loss)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in _launch_counts().items() if k.startswith("svgp_gram")}
        q["routes"][route] = svgp_route_quality(route, model0, model, iters, train_elbo,
                                                launches, seconds, goldens32, device, dtype)
    return q


def svgp_route_quality(route, model0, model, iters, train_elbo, launches, seconds, goldens32,
                       device=DEVICE, dtype=torch.float32):
    """One route's entry of `run_svgp`'s quality dict for a run that trained
    `model0` into `model` (on bench.py's problem, `iters` real steps)."""
    from portfoliooptgp_tpu_torch.models import svgp as svgp_mod
    from portfoliooptgp_tpu_torch.params import tree_leaves, tree_replace

    o = dict(device=device, dtype=dtype)
    Xn, Yn, _ = svgp_problem()
    X, Y = torch.tensor(Xn, **o), torch.tensor(Yn, **o)
    Xb, Yb = X[:SVGP_BATCH], Y[:SVGP_BATCH]
    wb = torch.ones((SVGP_BATCH,), **o)
    grid = torch.tensor(np.linspace(0, Xn.max(), SVGP_GRID)[:, None], **o)

    def full_elbo(m):
        with torch.no_grad():
            return float(svgp_mod.gaussian_elbo_gram(m, X, Y))

    def batch_elbo(m, grad=False):
        leaves = [x.detach().requires_grad_(grad) for x in tree_leaves(m)]
        with torch.enable_grad():
            v = svgp_mod.gaussian_elbo_gram_fused(tree_replace(m, leaves), Xb, Yb, weights=wb,
                                                  num_data=SVGP_N,
                                                  use_pallas=route == "kernel")
            g = torch.autograd.grad(v, leaves) if grad else None
        return float(v.detach()), g

    g32 = goldens32["routes"][route]
    v0, g0 = batch_elbo(model0, grad=route == "kernel")
    at32 = svgp_model(g32["leaves_final"], device, dtype)
    with torch.no_grad():
        mean, var = svgp_mod.predict_f(model, grid)
        mean32, var32 = svgp_mod.predict_f(at32, grid)
    return dict(
        seconds=seconds, iters=int(iters), launches=launches, train_elbo=float(train_elbo),
        use_pallas=route == "kernel", eligible=svgp_mod.svgp_gram_fused_supported(model0, Xb),
        elbo_start=full_elbo(model0), elbo_final=full_elbo(model),
        batch_elbo_start=v0,
        batch_grads_start=None if g0 is None else [
            x.double().cpu().reshape(-1).tolist() for x in g0],
        leaves_final=_svgp_flat(model),
        f_mean=mean.double().cpu().reshape(-1).tolist(),
        f_var=var.double().cpu().reshape(-1).tolist(),
        replay=dict(elbo_final=full_elbo(at32),
                    batch_elbo_final=batch_elbo(at32)[0],
                    f_mean=mean32.double().cpu().reshape(-1).tolist(),
                    f_var=var32.double().cpu().reshape(-1).tolist()))


SVGP_ELBO_RTOL = 1e-4  # an ELBO at the same leaves as JAX float32's, same route
SVGP_GRAD_ATOL = 2e-2  # route (ii)'s gradient at the start, of its largest entry
SVGP_REPLAY_MEAN_ATOL = 1e-3  # predict_f at JAX float32's leaves: means, of max |mean|
SVGP_REPLAY_VAR_ATOL = 2e-3   # ... variances, of max variance
SVGP_SPREAD = 4.0  # the trained outcome against float64: this many times JAX's float32 spread
# The trained outcome against JAX float32's run of the same route: this many
# times JAX's own float32 route-to-route difference (its two routes differ
# only in how the batch phase rounds, ~1e-4), and never less than one float32
# rounding of the quantity's largest value (a frozen leaf does not move).
# The port's runs of either route reach at most 0.34 of this limit on the
# CPU and on an H100 (PERF.md, PR 7); a kernel route trained on a Z̄ that is
# 0.9 of the right one reaches 7 times it on Z
# (tests/test_torch_svgp_goldens.py).
SVGP_ROUTE_SPREAD = 4.0


def _svgp_outcome(r):
    """The trained outcome of a run (quality dict or golden route): a list
    of (quantity, float64 array), each final leaf, `predict_f`'s mean and
    variance and the final full-data ELBO."""
    return ([(f"leaf {k}", x) for k, x in enumerate(r["leaves_final"])]
            + [("f_mean", r["f_mean"]), ("f_var", r["f_var"]),
               ("final full ELBO", [r["elbo_final"]])])


def svgp_route_limits(goldens32):
    """Per quantity of `_svgp_outcome`, the limit on a float32 run's
    distance from JAX float32's run of the same route: SVGP_ROUTE_SPREAD
    times the larger of JAX's two float32 routes' difference and one
    float32 rounding (2⁻²³ of the largest value)."""
    a, b = (_svgp_outcome(goldens32["routes"][r]) for r in SVGP_ROUTES)
    eps = float(np.finfo(np.float32).eps)
    lims = []
    for (_, x), (_, y) in zip(a, b):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        lims.append(SVGP_ROUTE_SPREAD * max(np.abs(x - y).max(), eps * np.abs(y).max()))
    return lims


def svgp_route_distances(q, goldens32):
    """{route: [(quantity, max |run − JAX float32's run of the route|,
    limit)]} for a run_svgp quality dict; a quantity of the wrong shape or
    with non-finite values, or a missing one, gets an infinite distance."""
    return {route: _route_distances(route, q["routes"][route], goldens32)
            for route in SVGP_ROUTES}


def _route_distances(route, r, goldens32):
    lims = svgp_route_limits(goldens32)
    mine = dict(_svgp_outcome(r))
    rows = []
    for (name, ref), lim in zip(_svgp_outcome(goldens32["routes"][route]), lims):
        x, ref = np.asarray(mine.get(name, []), np.float64), np.asarray(ref, np.float64)
        ok = x.shape == ref.shape and np.all(np.isfinite(x))
        rows.append((name, float(np.abs(x - ref).max()) if ok else float("inf"), lim))
    return rows


def compare_svgp(q, goldens, goldens32):
    """(ok, list of failures) of a run_svgp quality dict against the JAX
    float64 goldens (route (i), the only route in float64) and JAX's float32
    run of each route (`compare_svgp_route`)."""
    bad = [b for route in SVGP_ROUTES
           for b in compare_svgp_route(route, q["routes"][route], q["device"], goldens,
                                       goldens32)]
    return not bad, bad


def compare_svgp_route(route, r, device, goldens, goldens32):
    """The failures of one route's run (`svgp_route_quality`; `device` the
    type it ran on) against the goldens:
    - the route: the model eligible for the gram kernels, route (ii) asking
      for them (use_pallas) and route (i) not, and on the card the kernels
      launched once per real step in route (ii) (the 4 all-zero tail batches
      none) and never in route (i);
    - the real steps (60);
    - the route's ELBO on the first batch and the full-data ELBO at the
      start, and both replayed at JAX float32's final leaves of the route,
      within SVGP_ELBO_RTOL of JAX float32's; route (ii)'s gradient at the
      start within SVGP_GRAD_ATOL; `predict_f` at those leaves within
      SVGP_REPLAY_MEAN_ATOL / SVGP_REPLAY_VAR_ATOL of JAX float32's;
    - the trained outcome (each final leaf, `predict_f`'s mean and
      variance, the final full-data ELBO) within SVGP_SPREAD times JAX's
      own float32-to-float64 spread of the float64 golden, and within
      `svgp_route_limits` of JAX float32's run of the same route (the same
      batches and Adam)."""
    bad = []
    g64 = goldens["routes"]["xla"]
    g32 = goldens32["routes"][route]
    tag = f"route {route}"
    for name, err, lim in _route_distances(route, r, goldens32):
        if not err <= lim:
            bad.append(f"{tag}: {name}: |err| {err:.3g} from JAX float32's run of the route "
                       f"> {lim:.3g}")
    if not r["eligible"] or r["use_pallas"] != (route == "kernel"):
        bad.append(f"{tag}: eligible {r['eligible']}, use_pallas {r['use_pallas']}")
    fwd, bwd = r["launches"]["svgp_gram_fwd"], r["launches"]["svgp_gram_bwd"]
    want = r["iters"] if (route == "kernel" and device == "cuda") else 0
    if fwd != want or bwd != want:
        bad.append(f"{tag}: gram launches fwd {fwd}, bwd {bwd}, expected {want} each")
    if r["iters"] != g32["iters"]:
        bad.append(f"{tag}: {r['iters']} steps != {g32['iters']}")
    for name, x, ref in (
            ("full ELBO at the start", r["elbo_start"], g32["elbo_start"]),
            ("batch ELBO at the start", r["batch_elbo_start"], g32["batch_elbo_start"]),
            ("full ELBO at JAX's final leaves", r["replay"]["elbo_final"], g32["elbo_final"]),
            ("batch ELBO at JAX's final leaves", r["replay"]["batch_elbo_final"],
             g32["batch_elbo_final"])):
        if not abs(x - ref) <= SVGP_ELBO_RTOL * abs(ref):
            bad.append(f"{tag}: {name} {x:.8g} vs {ref:.8g}")
    for key, tol in (("f_mean", SVGP_REPLAY_MEAN_ATOL), ("f_var", SVGP_REPLAY_VAR_ATOL)):
        ref = np.asarray(g32[key])
        err = np.abs(np.asarray(r["replay"][key]) - ref).max() / np.abs(ref).max()
        if not err <= tol:
            bad.append(f"{tag}: {key} at JAX's final leaves, err {err:.3g} of max > {tol}")
    if g32["batch_grads_start"] is not None:
        for k, (g, ref) in enumerate(zip(r["batch_grads_start"], g32["batch_grads_start"])):
            ref = np.asarray(ref)
            err = np.abs(np.asarray(g) - ref).max() / max(np.abs(ref).max(), 1.0)
            if not err <= SVGP_GRAD_ATOL:
                bad.append(f"{tag}: gradient leaf {k} at the start, normalized err {err:.3g}")
    mine = dict(_svgp_outcome(r))
    for (name, ref32), (_, ref64) in zip(_svgp_outcome(g32), _svgp_outcome(g64)):
        x, ref32, ref64 = (np.asarray(a, np.float64) for a in (mine.get(name, []), ref32, ref64))
        if x.shape != ref64.shape or not np.all(np.isfinite(x)):
            bad.append(f"{tag}: {name}: shape {x.shape} or non-finite values")
            continue
        spread = np.abs(ref32 - ref64).max()
        lim = SVGP_SPREAD * spread
        err = np.abs(x - ref64).max()
        if not err <= lim:
            bad.append(f"{tag}: {name}: |err| {err:.3g} against the float64 golden > "
                       f"{lim:.3g} (JAX float32 spread {spread:.3g})")
    return bad


GRAM_SHAPES = ((16, 96), (64, 512), (128, 2048), (128, 8192))  # (M, B) of phase 10a
GRAM_VALUE_RTOL = 2e-4  # G and sq, of their largest entry (tests/test_svgp_gram_fused.py)
GRAM_GRAD_ATOL = 3e-3   # each gradient, of its largest entry
GRAM_GRAD_ATOL_ARD_MATERN = 5e-3


def gram_operands(M, B, D, seed, device=DEVICE, dtype=torch.float32):
    """Operands of the gram kernels at the benchmark's scale: X on [0, 16060]
    days, Z spread over the same range, ℓ from 200 to 500 days, a weight-0
    tail of the same share as the benchmark's last batch (1,325 of 2,048
    rows), random t, y, Ḡ and s̄q. Returns (Z, X, y, w, t, v, s, Ḡ, s̄q) with
    s (1,) when D = 1 (one shared scale) and (1, D) otherwise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 16060, (B, D))
    Z = np.sort(rng.uniform(0, 16060, (M, D)), axis=0)
    w = np.ones(B)
    w[B - (B * 1325) // 2048:] = 0.0
    ell = np.linspace(200.0, 500.0, D) if D > 1 else np.array([300.0])
    s = (1.0 / ell ** 2).reshape((1,) if D == 1 else (1, D))
    arrays = (Z, X, rng.normal(size=B), w, rng.normal(size=M) * 0.5, np.array([1.3]), s,
              rng.normal(size=(M, M)), np.array(rng.normal()))
    return tuple(torch.tensor(a, dtype=dtype, device=device) for a in arrays)


# -- phases -----------------------------------------------------------------

def phase_build():
    from portfoliooptgp_tpu_torch import native
    from portfoliooptgp_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    per_source = cuda_build.build(verbose=True)
    elapsed = time.perf_counter() - t0
    t1 = time.perf_counter()
    native.build()  # raises with g++'s output if it fails
    if not native.available():
        raise AssertionError("the native CSV loader built but does not load")
    print(f"phase 1 build: {elapsed:.2f} s "
          + json.dumps({k: round(v, 2) for k, v in per_source.items()})
          + f"; the CSV loader (g++) {time.perf_counter() - t1:.2f} s", flush=True)


def phase_checks():
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    errs = {}
    for i, fam in enumerate(st.GENERAL_FAMILIES):
        check_general(f"family {fam}", (fam,), (1,), "prod", 8, 100, False, 10 + i)
    errs["stationary_nll_general"] = max(
        check_general("prod se*matern32*rq", ("se", "matern32", "rq"), (1, 1, 1), "prod",
                      8, 90, True, 20),
        check_general("sum matern12+periodic_se+linear", ("matern12", "periodic_se", "linear"),
                      (1, 1, 1), "sum", 8, 90, True, 21),
        check_general("ARD se dims=4 x matern52", ("se", "matern52"), (4, 1), "prod",
                      8, 96, True, 22),
        check_general("partial mask matern32", ("matern32",), (1,), "prod", 6, 120, True, 23),
        check_general("walk-forward shape matern12*matern12", ("matern12", "matern12"),
                      (1, 1), "prod", 5, 77, True, 24),
    )
    for fam in st.FAMILIES:
        check_single(f"single {fam}", fam, 16, 128, 30)
    errs["stationary_nll"] = check_single("headline shape se", "se", 128, 256, 31)
    return errs


def _headline_problem():
    from portfoliooptgp_tpu_torch import kernels as tk
    from portfoliooptgp_tpu_torch.models import gpr
    from portfoliooptgp_tpu_torch.train import lbfgs

    rng = np.random.default_rng(0)
    B, N = 128, 256
    X = np.sort(rng.uniform(0, 30, (N, 1)), axis=0).astype(np.float32)
    Y = rng.normal(size=(N, 1)).astype(np.float32)
    vs = np.geomspace(0.5, 2.0, B)
    models = [gpr.GPR.create(tk.SquaredExponential.create(float(v), 3.0, device=DEVICE),
                             noise_variance=0.1) for v in vs]
    stacked = lbfgs.stack_pytrees(models)
    return stacked, torch.as_tensor(X, device=DEVICE), torch.as_tensor(Y, device=DEVICE)


def phase_headline():
    from portfoliooptgp_tpu_torch.models import gpr
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st
    from portfoliooptgp_tpu_torch.params import tree_leaves, tree_map

    stacked, X, Y = _headline_problem()
    stacked = tree_map(lambda x: x.requires_grad_(True), stacked)
    leaves = tree_leaves(stacked)
    tier = gpr.nll_tier(stacked, X, Y)
    if tier != "fused_stationary":
        raise AssertionError(f"headline tier is {tier}, not fused_stationary")

    def value_and_grad():
        nll = gpr.batched_neg_log_marginal_likelihood(stacked, X, Y, device=DEVICE)
        return nll, torch.autograd.grad(nll.sum(), leaves)

    for k in st.LAUNCHES:
        st.LAUNCHES[k] = 0
    before = st.kernel_launches()
    nll, grads = value_and_grad()
    torch.cuda.synchronize()
    launches = st.LAUNCHES["stationary_nll"]
    ran = launches_since(before)
    if launches < 1 or ran["tile"] < 1 or ran["cluster"]:
        raise AssertionError(f"the headline value+grad launched {launches} stationary_nll "
                             f"kernels ({ran}), not the tile kernel")
    if not (torch.all(torch.isfinite(nll)) and all(torch.all(torch.isfinite(g)) for g in grads)):
        raise AssertionError("non-finite headline value or gradient")
    vg_ms = cuda_ms(value_and_grad, reps=10)
    vg_device = value_grad_device_ms(value_and_grad)
    print(f"phase 3 headline B=128 N=256 se f32: tier {tier}, launches {launches} (tile kernel "
          f"{ran['tile']}, cluster kernel {ran['cluster']}), value+grad {vg_ms:.4f} ms "
          f"({1e3 / vg_ms * 128:.1f} evals/s); profiled, a value+grad keeps the device busy "
          f"{vg_device['device_ms']:.4f} ms, the stationary kernel {vg_device['kernel_ms']:.4f} "
          f"ms of it", flush=True)
    rows, errs = {}, {"stationary_nll": 0.0, "stationary_nll_general": 0.0}
    for label in ("headline", "weekly menu", "monthly menu", "frontier grid A", "NUTS bench",
                  "frontier NUTS", "two-year walk-forward"):
        families, dims, B, N, masked = STATIONARY_TIMED[label]
        single = len(families) == 1 and dims == (1,) and not masked
        name = "stationary_nll" if single else "stationary_nll_general"
        errs[name] = max(errs[name], check_timed(label))
        rows[label] = stationary_times(st, families, dims, B, N, masked)
        report_stationary_times("phase 3", label, rows[label])
    grad_rows, errs["stationary_nll_grad"] = {}, 0.0
    for label, shape in GRAD_TIMED.items():
        errs["stationary_nll_grad"] = max(errs["stationary_nll_grad"], check_grad(label))
        grad_rows[label] = grad_times(st, *shape)
        report_grad_times("phase 3", label, grad_rows[label])
    return dict(launches=launches, rows=rows, grad_rows=grad_rows, errs=errs,
                value_grad_ms=vg_ms, value_grad_device_ms=vg_device["device_ms"])


def value_grad_device_ms(value_and_grad, calls=10):
    """Device time of one value+grad call, and the stationary kernel's part
    of it, in ms: the device events of `calls` calls under torch.profiler
    (`device_busy`; by name in chiprun_out/headline_profile.txt) over
    `calls`. The eager call is host-bound, so its time does not show what
    the device spends."""
    busy = device_busy(lambda: [value_and_grad() for _ in range(calls)], "headline_profile.txt")
    return dict(device_ms=1e3 * busy["device_s"] / calls, kernel_ms=1e3 * busy["kernel_s"] / calls)


@contextlib.contextmanager
def counting_native_parses():
    """[n]: how many files `native.load_eod` parsed inside the block."""
    from portfoliooptgp_tpu_torch import native

    count, real = [0], native.load_eod

    def load_eod(path):
        count[0] += 1
        return real(path)

    native.load_eod = load_eod
    try:
        yield count
    finally:
        native.load_eod = real


def phase_end_to_end():
    from benchmarks.bench_portfolio_e2e import GOLDENS_PATH, compare_to_goldens, make_market
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    with open(GOLDENS_PATH) as fh:
        goldens = json.load(fh)
    with tempfile.TemporaryDirectory() as root:
        make_market(root)
        for k in st.LAUNCHES:
            st.LAUNCHES[k] = 0
        before = st.kernel_launches()
        with counting_native_parses() as parses:
            cold, quality = run_workflow(root, DEVICE)
        launches = st.LAUNCHES["stationary_nll_general"]
        grad_launches = st.LAUNCHES["stationary_nll_grad"]
        ran = launches_since(before)
        stages = {}
        warm, quality_warm = run_workflow(root, DEVICE, timings=stages)
        busy = device_busy(lambda: run_workflow(root, DEVICE), "e2e_profile.txt")
    if launches < 1 or ran["tile"] < 1 or ran["cluster"]:
        raise AssertionError(f"the end-to-end run launched {launches} stationary_nll_general "
                             f"kernels ({ran}), not the tile kernel")
    if grad_launches < 1 or ran["grad"] != grad_launches:
        raise AssertionError(f"the end-to-end run launched the backward kernel {ran['grad']} "
                             f"times, its wrapper counted {grad_launches}")
    if parses[0] < 1:
        raise AssertionError("the end-to-end run parsed no CSV through the native loader")
    results = []
    for label, q in (("cold", quality), ("warm", quality_warm)):
        ok, worst = compare_to_goldens(q, goldens)
        results.append(worst)
        if not ok:
            raise AssertionError(f"{label} run does not match the goldens: {worst}")
    print(f"phase 4 end to end f32: cold {cold:.2f} s, warm {warm:.2f} s (step 4 "
          f"{stages['step4_s']:.2f} s, portfolio {stages['portfolio_s']:.2f} s), kernel "
          f"launches {launches} (tile kernel {ran['tile']}, cluster kernel {ran['cluster']}), "
          f"backward kernel {grad_launches}; {parses[0]} CSV files parsed by the native loader; "
          f"goldens MATCH (worst {results[0]['metric']}: {results[0]['diff']:.4g})", flush=True)
    if busy["device_s"] > 0:
        print(f"  profiled warm pass: {busy['wall_s']:.2f} s wall, device busy "
              f"{busy['device_s']:.3f} s ({100 * busy['device_s'] / warm:.1f}% of the "
              f"unprofiled warm pass), stationary_nll kernel {busy['kernel_s']:.3f} s",
              flush=True)
    else:
        print("  profiled warm pass: the profiler recorded no device events; device busy "
              "share not measured", flush=True)
    print(json.dumps(quality, sort_keys=True), flush=True)
    families, dims, B, N, masked = STATIONARY_TIMED["walk-forward"]
    row = stationary_times(st, families, dims, B, N, masked)
    report_stationary_times("phase 4", "walk-forward", row)
    return dict(launches=launches, grad_launches=grad_launches, row=row)


def panel_bound_ms(nt, B=1):
    """Least time for one panel factor on an H100: the larger of its bytes
    over HBM bandwidth and its fp32 operations (pw³/3 for the diagonal
    block, pw² (nt − pw) for the row solve, pw = min(128, nt)) over the fp32
    peak. The bytes are the lower triangle of A11 and the rows of A21 read
    once, and the same entries of L written once: the zeros above L11's
    diagonal are not work the factor needs (the blocked factor's L buffer
    starts as zeros)."""
    pw = min(128, nt)
    nbytes = B * 2 * 4 * (pw * (pw + 1) // 2 + pw * (nt - pw))
    flops = B * (pw ** 3 / 3 + pw * pw * (nt - pw))
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _spd(B, N, seed, device=DEVICE):
    """(B, N, N) float32 SPD matrices: AAᵀ/N + ½I from a seed."""
    rng = np.random.default_rng(seed)
    A = torch.tensor(rng.normal(size=(B, N, N)), dtype=torch.float64, device=device)
    return (A @ A.mT / N + 0.5 * torch.eye(N, dtype=torch.float64, device=device)).float()


PANEL_HEIGHTS = (875, 747, 619, 491, 363, 235, 107)  # the 7 panels of N = 875


def se_daily_gram(N, jitter, device=DEVICE):
    """(1, N, N) float32: an SE Gram matrix on a daily grid (the day index
    scaled to unit std, lengthscale 0.05) plus jitter·I, the conditioning of
    the daily menu's Ks at σ² = 1e-5."""
    x = torch.arange(N, dtype=torch.float64, device=device)
    x = (x - x.mean()) / x.std()
    K = torch.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.05 ** 2)
    return (K + jitter * torch.eye(N, dtype=torch.float64, device=device))[None].float()


def panel_residual(Lp, panel):
    """max |L11 L11ᵀ − A11| (lower triangle) and |L21 L11ᵀ − A21| in float64,
    over max |A|: the backward error of a panel factor, which stays at
    rounding level however ill-conditioned A is (two float32 factors of the
    same ill-conditioned panel may differ far more than that)."""
    Lp, A = Lp.double(), panel.double()
    pw = A.shape[2]
    L11 = Lp[:, :pw]
    r11 = torch.tril(L11 @ L11.mT - A[:, :pw]).abs().max()
    r21 = (Lp[:, pw:] @ L11.mT - A[:, pw:]).abs().max() if A.shape[1] > pw else r11 * 0
    return float(torch.maximum(r11, r21) / A.abs().max())


PANEL_ILL_RESIDUAL = 4.0     # the kernel's backward error, at most this times the plain version's
PANEL_ILL_RESIDUAL_FLOOR = 2e-6  # ... or this much of max |A|


def indefinite_at(Ks, pivot):
    """Ks with its diagonal entry `pivot` lowered so that the Cholesky pivot
    there is −1: the factor is exact up to column pivot − 1 and fails there."""
    K = Ks.double()
    L = torch.linalg.cholesky(K[:, :pivot + 1, :pivot + 1])
    K[:, pivot, pivot] -= L[:, pivot, pivot] ** 2 + 1.0
    return K.float()


PANEL_PIVOTS = (32, 64, 100)  # indefinite pivots: sub-panel boundaries and inside one


def check_panel_indefinite(pivot, device=DEVICE):
    """The panel kernel on a (2, 300) panel whose pivot `pivot` is −1: NaN in
    the log sum and in every entry on and below the diagonal from column
    `pivot` on; the earlier columns finite and within VALUE_RTOL of max |L|
    of the plain factor of the same columns (the diagonal lifted from
    `pivot` on, which changes none of them); zeros above L11's diagonal.
    Returns the largest |Δ| of the earlier columns."""
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn

    Ks = indefinite_at(_spd(2, 300, 5, device), pivot)
    Lk, ldk = bn.factor_panel(Ks[:, :, :128])
    lifted = Ks.clone()
    lifted.diagonal(dim1=-2, dim2=-1)[:, pivot:] += 100.0
    Lp, _ = bn.factor_panel_plain(lifted[:, :, :128])
    rows = torch.arange(300, device=device)[:, None]
    cols = torch.arange(128, device=device)[None, :]
    failed = (cols >= pivot) & (rows >= cols)
    good, want = Lk[:, :, :pivot], Lp[:, :, :pivot]
    err = _max_err(good, want)
    if not (torch.all(torch.isnan(ldk)) and torch.all(torch.isnan(Lk[:, failed]))
            and torch.all(torch.isfinite(good)) and err <= VALUE_RTOL * float(want.abs().max())
            and torch.all(torch.triu(Lk[:, :128], 1) == 0)):
        raise AssertionError(f"panel with an indefinite pivot at {pivot}: log sum {ldk.tolist()}, "
                             f"earlier columns err {err:.3e}")
    return err


def check_panel_ill_conditioned(device=DEVICE):
    """The first panel of se_daily_gram(875, 1e-5): finite, backward error
    at most PANEL_ILL_RESIDUAL × the plain version's (or the floor), log sum
    within VALUE_RTOL of the plain version's. Returns both residuals."""
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn

    panel = se_daily_gram(875, 1e-5, device)[:, :, :128]
    Lk, ldk = bn.factor_panel(panel)
    Lp, ldp = bn.factor_panel_plain(panel)
    rk, rp = panel_residual(Lk, panel), panel_residual(Lp, panel)
    if not (torch.all(torch.isfinite(Lk)) and torch.all(torch.isfinite(Lp))
            and rk <= max(PANEL_ILL_RESIDUAL * rp, PANEL_ILL_RESIDUAL_FLOOR)
            and float(torch.max(torch.abs(ldk / ldp - 1))) <= VALUE_RTOL):
        raise AssertionError(f"ill-conditioned panel: residual {rk:.3e} (plain {rp:.3e}), "
                             f"log sum {ldk.tolist()} (plain {ldp.tolist()})")
    return rk, rp


def phase_blocked_checks():
    """The panel kernel against factor_panel_plain at every panel height of
    the N = 875 path (as strided views of the trailing matrix, B ∈ {1, 8}):
    the L panel within 3e-3 of max |L| and Σ log diag within rtol 3e-3; then
    batched_nll_blocked on the card (the kernel) against the same call on
    CPU copies of the float32 inputs (the plain panel factor), values (rtol
    3e-3) and gradients of K, y and noise (normalized 2e-2) at N = 875 and
    at the JAX package's padded N = 896; then an ill-conditioned panel
    (check_panel_ill_conditioned), indefinite pivots at PANEL_PIVOTS
    (check_panel_indefinite) and the kernel writing into a view of L.
    Returns the largest |Δ| of L and NLLs."""
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn

    worst = 0.0
    for B in (1, 8):
        for nt in PANEL_HEIGHTS:
            Ks = _spd(B, nt, nt + B)
            panel = Ks[:, :, :min(128, nt)]
            Lk, ldk = bn.factor_panel_cuda(panel)
            Lp, ldp = bn.factor_panel_plain(panel)
            torch.cuda.synchronize()
            err = _max_err(Lk, Lp)
            scale = float(Lp.abs().max())
            if not (torch.all(torch.isfinite(Lk)) and err <= VALUE_RTOL * scale):
                raise AssertionError(f"panel B={B} nt={nt}: L err {err:.3e} > "
                                     f"{VALUE_RTOL} x {scale:.3e}")
            _check_values(f"panel B={B} nt={nt} logdet", ldk, ldp)
            worst = max(worst, err)
        print(f"check panel B={B}: nt {PANEL_HEIGHTS} L max |err| {worst:.3e}", flush=True)
    for B, N in ((1, 875), (8, 875), (8, 896)):
        rng = np.random.default_rng(N + B)
        K = _spd(B, N, B)
        y = torch.tensor(rng.normal(size=(B, N)), dtype=torch.float32, device=DEVICE)
        noise = torch.tensor(rng.uniform(0.1, 0.5, B), dtype=torch.float32, device=DEVICE)
        outs = []
        for dev in (DEVICE, "cpu"):
            leaves = [x.detach().to(dev).requires_grad_(True) for x in (K, y, noise)]
            nll = bn.batched_nll_blocked(*leaves)
            grads = torch.autograd.grad(nll.sum(), leaves)
            outs.append((nll.detach().to(DEVICE), [g.to(DEVICE) for g in grads]))
        torch.cuda.synchronize()
        verr = _check_values(f"blocked nll B={B} N={N}", outs[0][0], outs[1][0])
        gerr = _check_grads(f"blocked nll B={B} N={N}", outs[0][1], outs[1][1])
        worst = max(worst, _max_err(outs[0][0], outs[1][0]))
        print(f"check blocked nll B={B} N={N}: value rel err {verr:.3e}, grad normalized "
              f"err {gerr:.3e}", flush=True)
    rk, rp = check_panel_ill_conditioned()
    print(f"check panel ill-conditioned (SE daily grid + 1e-5 I, nt=875): backward error "
          f"{rk:.3e} of max |A| (plain {rp:.3e}; limit max({PANEL_ILL_RESIDUAL} x plain, "
          f"{PANEL_ILL_RESIDUAL_FLOOR}))", flush=True)
    for pivot in PANEL_PIVOTS:
        err = check_panel_indefinite(pivot)
        worst = max(worst, err)
        print(f"check panel indefinite pivot {pivot}: NaN log sum and columns >= {pivot}, "
              f"earlier columns max |err| {err:.3e}", flush=True)
    Ks = _spd(3, 619, 4)
    buf = torch.full((3, 875, 875), 7.0, device=DEVICE)
    view = buf[:, 256:, 256:384]
    Lk, ldk = bn.factor_panel_cuda(Ks[:, :, :128])
    Lo, ldo = bn.factor_panel_cuda(Ks[:, :, :128], out=view)
    rest = torch.ones_like(buf, dtype=torch.bool)
    rest[:, 256:, 256:384] = False
    if not (Lo.data_ptr() == view.data_ptr() and torch.equal(view, Lk) and torch.equal(ldo, ldk)
            and bool(torch.all(buf[rest] == 7.0))):
        raise AssertionError("the panel kernel did not write exactly its panel into `out`")
    print("check panel out=: the L panel written into a view of a (3, 875, 875) factor, bit "
          "for bit, nothing else touched", flush=True)
    return worst


# Tolerances of the single-asset run against the JAX goldens (PERF.md,
# PR 4). Every healthy menu entry ends near white noise on the z-scored
# returns (loss ≈ ½yᵀy + ½N log 2π, train MSE ≈ σ⁴ = 1e-10), and float32
# moves where L-BFGS stops: JAX's own float32 run departs from its float64
# run by up to 1.20 in a daily final loss and 0.30 in a weekly one, and by
# up to 2.3% in a train MSE, on the entries it trains well. A stalled or
# wrongly driven entry stays near its start, ≥ 18.6 (daily), 17.6 (weekly)
# and 4.1 (monthly) above the golden loss for every entry whose start is
# not already at the optimum. Two menu entries are float32-unstable in JAX
# itself: index 5 (Exp + Periodic(SE) + Linear, Linear on the raw day
# index: NaN or a stall at N = 875 and 175, a poor fit at N = 40) and
# index 6 (Exp + Periodic(SE), whose period gradient at the start is
# float32 rounding of sin(πd) on integer days: it stops anywhere between
# the optimum and its start — 1245.8 daily in JAX, 1250.8 in the port on
# the CPU, 1270.1 on the card). Where they end is rounding, so their loss
# is only held between the optimum and the start, and their MSE not at all.
SA_LOSS_ATOL = {"d": 2.0, "w": 0.5, "m": 0.5}  # final loss of each menu entry
SA_MSE_RTOL = 0.05     # train MSE of each menu entry; also the winner's margin
SA_BLEND_ATOL = 0.02   # α and β
SA_FMEAN_RMS = 0.05    # in-sample blended f_mean, on the z-scored returns
SA_HORIZON_ATOL = 1e-3  # horizon blended f_mean, on the z-scored returns
SA_FVAR_RTOL = 0.02    # blended f_var, in sample and over the horizon


def _stable(g64, g32, tol, rel):
    """Whether JAX's float32 value g32 lies within tol of its float64 g64."""
    return bool(np.isfinite(g32)) and abs(g32 - g64) <= tol * (abs(g64) if rel else 1.0)


def _loss_ok(x, g64, g32, start, tol):
    """The port's float32 final loss x of one menu entry: within tol of the
    float64 golden g64 where JAX's float32 g32 is too; elsewhere (the entry
    is float32-unstable in JAX itself) non-finite, or between the lowest
    and the highest of g64, g32 and the loss before training, ± tol."""
    if _stable(g64, g32, tol, rel=False):
        return abs(x - g64) <= tol
    if not np.isfinite(x):
        return True
    ends = [v for v in (g64, g32, start) if np.isfinite(v)]
    return min(ends) - tol <= x <= max(ends) + tol


def _mse_ok(x, g64, g32, tol):
    """The port's float32 train MSE x: within rtol tol of g64 where JAX's
    float32 is; not compared where JAX's own float32 departs."""
    return not _stable(g64, g32, tol, rel=True) or abs(x - g64) <= tol * abs(g64)


def compare_single_asset(q, goldens, goldens32):
    """(ok, list of failures) of a run_single_asset quality dict against
    the JAX float64 goldens and JAX's float32 run of the same pipeline.
    Per timescale: N; the tiers (daily: every entry 'blocked'; weekly and
    monthly: what the JAX router names in float32), and only those tiers in
    the router's record; each menu entry's final loss (SA_LOSS_ATOL,
    `_loss_ok`) and train MSE (SA_MSE_RTOL, `_mse_ok`); the winner: the float32
    golden winner where its MSE beats every other entry's by more than
    SA_MSE_RTOL there, else an entry whose float32 golden MSE lies within
    SA_MSE_RTOL of the winner's (the float64 winner, index 5 on the daily
    and monthly timescales, is float32-unstable). Then α, β, the in-sample
    blended f_mean (RMS against float64) and f_var (against float64, within
    SA_FVAR_RTOL plus JAX's own float32 departure: the posterior variance
    at a training point, ≈ σ², is a float32 difference of O(1) numbers),
    and the horizon's f_mean and f_var against float32 (the horizon mean
    is the winners' extrapolation, and the float64 daily winner's Linear
    trend has no float32 counterpart)."""
    bad = []
    for tag, g in goldens["timescales"].items():
        t, g32 = q["timescales"][tag], goldens32["timescales"][tag]
        if t["n"] != g["n"]:
            bad.append(f"{tag}: N {t['n']} != {g['n']}")
            continue
        if t["tiers"] != g["tiers_f32"] or (tag == "d" and set(t["tiers"]) != {"blocked"}):
            bad.append(f"{tag}: tiers {t['tiers']} != {g['tiers_f32']}")
        seen = {tier for tier, _ in t["dispatched"]}
        if not seen or not seen <= set(g["tiers_f32"]):
            bad.append(f"{tag}: router recorded {t['dispatched']}")
        for i in range(len(g["losses"])):
            if not _loss_ok(t["losses"][i], g["losses"][i], g32["losses"][i],
                            g["start_losses"][i], SA_LOSS_ATOL[tag]):
                bad.append(f"{tag}: index {i} loss {t['losses'][i]:.6g} vs {g['losses'][i]:.6g} "
                           f"(float32 {g32['losses'][i]:.6g})")
            if not _mse_ok(t["mses"][i], g["mses"][i], g32["mses"][i], SA_MSE_RTOL):
                bad.append(f"{tag}: index {i} MSE {t['mses'][i]:.6g} vs {g['mses'][i]:.6g} "
                           f"(float32 {g32['mses'][i]:.6g})")
        m32 = np.where(np.isfinite(g32["mses"]), g32["mses"], np.inf)
        w, gw = t["best_index"], g32["best_index"]
        clear = all(m32[i] > (1 + SA_MSE_RTOL) * m32[gw] for i in range(len(m32)) if i != gw)
        if w != gw and (clear or not m32[w] <= (1 + SA_MSE_RTOL) * m32[gw]):
            bad.append(f"{tag}: winner {w} (float32 golden MSE {m32[w]:.6g}) vs {gw} "
                       f"({m32[gw]:.6g})")
    for key in ("alpha", "beta"):
        if not abs(q[key] - goldens[key]) <= SA_BLEND_ATOL:
            bad.append(f"{key} {q[key]:.6g} vs {goldens[key]:.6g}")
    n = goldens["n_daily"]
    fm, fv = np.asarray(q["f_mean"]), np.asarray(q["f_var"])
    gm, gv = np.asarray(goldens["f_mean"]), np.asarray(goldens["f_var"])
    hm, hv = np.asarray(goldens32["f_mean"])[n:], np.asarray(goldens32["f_var"])
    if fm.shape != gm.shape or fv.shape != gv.shape or not np.all(np.isfinite(fm) & np.isfinite(fv)):
        bad.append(f"f_mean {fm.shape} / f_var {fv.shape} shapes or non-finite values")
        return False, bad
    rms = float(np.sqrt(np.mean((fm[:n] - gm[:n]) ** 2)))
    if not rms <= SA_FMEAN_RMS:
        bad.append(f"in-sample f_mean RMS {rms:.4g} > {SA_FMEAN_RMS}")
    own = float(np.max(np.abs(hv[:n] / gv[:n] - 1)))
    errs = {"horizon f_mean |err|": (float(np.max(np.abs(fm[n:] - hm))), SA_HORIZON_ATOL),
            "in-sample f_var rel err": (float(np.max(np.abs(fv[:n] / gv[:n] - 1))),
                                        own + SA_FVAR_RTOL),
            "horizon f_var rel err": (float(np.max(np.abs(fv[n:] / hv[n:] - 1))),
                                      SA_FVAR_RTOL)}
    for name, (err, lim) in errs.items():
        if not err <= lim:
            bad.append(f"{name} {err:.4g} > {lim:.4g}")
    return not bad, bad


def _single_asset_report(label, elapsed, q):
    print(f"phase 6 single asset f32 {label}: {elapsed:.2f} s", flush=True)
    for tag, t in q["timescales"].items():
        print(f"  {tag}: N={t['n']} {t['seconds']:.2f} s winner {t['best_index']} tiers "
              f"{t['tiers']} router {t['dispatched']}", flush=True)
    print(f"  alpha {q['alpha']:.6f} beta {q['beta']:.6f}", flush=True)


def phase_single_asset():
    """The single-asset pipeline on the card in float32, cold then warm,
    against the JAX float64 goldens, then once more under the profiler; the
    panel kernel's launches in the cold run; the kernel's time at every
    panel height of N = 875 and at B = 8, and at nt = 875 beside its plain
    version, its bound and torch.linalg.cholesky_ex on the same matrix, by
    CUDA-graph replay and eager; the whole blocked factor both ways."""
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    with open(SINGLE_ASSET_GOLDENS) as fh:
        goldens = json.load(fh)
    with open(SINGLE_ASSET_GOLDENS_F32) as fh:
        goldens32 = json.load(fh)
    with tempfile.TemporaryDirectory() as root:
        make_single_asset_market(root, goldens["seed"])
        for counts in (bn.LAUNCHES, st.LAUNCHES):
            for k in counts:
                counts[k] = 0
        before = st.kernel_launches()
        cold, q = run_single_asset(root, DEVICE)
        launches = bn.LAUNCHES["blocked_panel"]
        fused = st.LAUNCHES["stationary_nll"] + st.LAUNCHES["stationary_nll_general"]
        ran = launches_since(before)
        _single_asset_report("cold", cold, q)
        warm, q_warm = run_single_asset(root, DEVICE)
        _single_asset_report("warm", warm, q_warm)
        busy = device_busy(lambda: run_single_asset(root, DEVICE), "single_asset_profile.txt",
                           kernel="blocked_panel")
    if launches < 1:
        raise AssertionError("the single-asset run launched no blocked_panel kernel")
    if fused < 1:
        raise AssertionError("the single-asset run launched no stationary NLL kernel")
    n = goldens["n_daily"]
    for label, qq in (("cold", q), ("warm", q_warm)):
        print(f"  {label} " + json.dumps({tag: dict(best_index=t["best_index"],
                                                    losses=t["losses"], mses=t["mses"])
                                          for tag, t in qq["timescales"].items()}), flush=True)
        fm, fv, hm, hv = (np.asarray(x)[n:] for x in (qq["f_mean"], qq["f_var"],
                                                       goldens32["f_mean"], goldens32["f_var"]))
        print(f"  {label} horizon against JAX float32: f_mean max |err| "
              f"{np.max(np.abs(fm - hm)):.4g}, f_var max rel err "
              f"{np.max(np.abs(fv / hv - 1)):.4g}", flush=True)
    for label, qq in (("cold", q), ("warm", q_warm)):
        ok, bad = compare_single_asset(qq, goldens, goldens32)
        if not ok:
            raise AssertionError(f"{label} single-asset run does not match the goldens: {bad}")
    rms = float(np.sqrt(np.mean((np.asarray(q["f_mean"][:n]) - goldens["f_mean"][:n]) ** 2)))
    print(f"  goldens MATCH: alpha {q['alpha']:.6f} ({goldens['alpha']:.6f}), beta "
          f"{q['beta']:.3g} ({goldens['beta']:.3g}), in-sample f_mean RMS {rms:.4g}; "
          f"blocked_panel launches {launches}, stationary NLL launches {fused} (tile kernel "
          f"{ran['tile']}, cluster kernel {ran['cluster']})", flush=True)
    if busy["device_s"] > 0:
        print(f"  profiled warm pass: {busy['wall_s']:.2f} s wall, device busy "
              f"{busy['device_s']:.3f} s ({100 * busy['device_s'] / warm:.1f}% of the "
              f"unprofiled warm pass), blocked_panel kernel {busy['kernel_s']:.3f} s",
              flush=True)
    else:
        print("  profiled warm pass: the profiler recorded no device events; device busy "
              "share not measured", flush=True)

    Ks = _spd(1, 875, 875)
    Ks8 = _spd(8, 875, 876)

    def view(K, nt):
        return K[:, 875 - nt:, 875 - nt:875 - nt + min(128, nt)]

    with torch.no_grad():
        graph = {nt: graph_ms(lambda nt=nt: bn.factor_panel_cuda(view(Ks, nt)))
                 for nt in PANEL_HEIGHTS}
        eager = {nt: cuda_ms(lambda nt=nt: bn.factor_panel_cuda(view(Ks, nt)), reps=50)
                 for nt in PANEL_HEIGHTS}
        k8, k8_eager = (graph_ms(lambda: bn.factor_panel_cuda(Ks8[:, :, :128])),
                        cuda_ms(lambda: bn.factor_panel_cuda(Ks8[:, :, :128]), reps=50))
        p, p_eager = (graph_ms(lambda: bn.factor_panel_plain(Ks[:, :, :128])),
                      cuda_ms(lambda: bn.factor_panel_plain(Ks[:, :, :128]), reps=50))
        lib, lib_eager = (graph_ms(lambda: torch.linalg.cholesky_ex(Ks)),
                          cuda_ms(lambda: torch.linalg.cholesky(Ks), reps=50))
        whole, whole_eager = (graph_ms(lambda: bn.blocked_cholesky(Ks), reps=20),
                              cuda_ms(lambda: bn.blocked_cholesky(Ks), reps=20))
    k = graph[875]
    bound, bound_by = panel_bound_ms(875)
    total_bound = sum(panel_bound_ms(nt)[0] for nt in PANEL_HEIGHTS)
    print(f"  panel nt=875 B=1 (graph replay): kernel {k:.4f} ms, plain {p:.4f} ms, bound "
          f"{bound:.6f} ms ({bound_by}); torch.linalg.cholesky_ex (1, 875, 875) {lib:.4f} ms; "
          f"kernel summed over the 7 panel heights {sum(graph.values()):.4f} ms, panel bounds "
          f"summed {total_bound:.6f} ms; the whole blocked factor (7 panels + trailing "
          f"matmuls) {whole:.4f} ms", flush=True)
    print(f"  panel nt=875 B=8 (graph replay): kernel {k8:.4f} ms, bound "
          f"{panel_bound_ms(875, 8)[0]:.6f} ms; eager (CUDA events around back-to-back calls): "
          f"kernel {eager[875]:.4f} ms (B=8 {k8_eager:.4f}), plain {p_eager:.4f} ms, "
          f"torch.linalg.cholesky {lib_eager:.4f} ms, whole blocked factor {whole_eager:.4f} ms",
          flush=True)
    print("  kernel ms by panel height, graph replay: " + json.dumps(
        {nt: round(ms, 4) for nt, ms in graph.items()}) + "; eager: " + json.dumps(
        {nt: round(ms, 4) for nt, ms in eager.items()}), flush=True)
    return dict(launches=launches, ms=k, plain_ms=p, library_ms=lib, bound_ms=bound,
                bound_by=bound_by, eager_ms=eager[875], cold_s=cold, warm_s=warm)


def trinv_bound_ms(nblocks):
    """Least time for the triangular inverse of `nblocks` 128×128 blocks on
    an H100: the larger of the bytes (each block's lower triangle read once,
    the same entries of W written once) over HBM bandwidth and n³/3 fp32
    operations per block over the fp32 peak."""
    nbytes = nblocks * 2 * 4 * (128 * 129 // 2)
    flops = nblocks * 128 ** 3 / 3
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _chol_factors(kind, B, Np, seed):
    """(B, Np, Np) float32 lower factors on the card: 'random' from AAᵀ/Np +
    ½I; 'ill' from an SE Gram matrix on a daily grid (lengthscale 0.05 of a
    unit-std index) + 1e-3·I, the conditioning of the frontier's Kb; 'nan'
    the random ones with one NaN below the diagonal of block (B-1, P-1)."""
    if kind == "ill":
        x = torch.linspace(-1.7, 1.7, Np, dtype=torch.float64, device=DEVICE)
        K = torch.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.05 ** 2)
        scale = torch.linspace(0.5, 2.0, B, dtype=torch.float64, device=DEVICE)
        Ks = scale[:, None, None] * K + 1e-3 * torch.eye(Np, dtype=torch.float64, device=DEVICE)
        return torch.linalg.cholesky(Ks).float()
    L = torch.linalg.cholesky(_spd(B, Np, seed).double()).float()
    if kind == "nan":
        L[B - 1, Np - 60, Np - 100] = float("nan")
    return L


TRINV_SHAPES = ((20, 1408), (20, 1024), (20, 256), (20, 128), (8, 128))  # 220, 160, 40, 20, 8 blocks
UNEVEN_VIEWS = ((0, 1024), (1024, 1280), (1280, 1408))  # the 8 + 2 + 1 split of 11 panels
# (row, column, value) set inside a 128-block: a NaN inside a diagonal
# 32-block, a NaN inside an off-diagonal 32-block, a zero pivot
TRINV_CORRUPTIONS = {"nan_diagonal_block": (40, 35, float("nan")),
                     "nan_offdiagonal_block": (100, 10, float("nan")),
                     "zero_pivot": (50, 50, 0.0)}


def check_trinv_equal(name, Wk, Wp):
    """NaN and inf of the kernel's W exactly where the plain version has
    them; the finite entries within VALUE_RTOL of the largest. Returns the
    largest |Δ| of the finite entries."""
    if not (torch.equal(torch.isnan(Wk), torch.isnan(Wp))
            and torch.equal(torch.isinf(Wk), torch.isinf(Wp))):
        raise AssertionError(f"{name}: NaN/inf pattern differs from plain (NaN "
                             f"{int(torch.isnan(Wk).sum())} vs {int(torch.isnan(Wp).sum())}, inf "
                             f"{int(torch.isinf(Wk).sum())} vs {int(torch.isinf(Wp).sum())})")
    fin = torch.isfinite(Wp)
    err = _max_err(Wk[fin], Wp[fin])
    if err > VALUE_RTOL * float(Wp[fin].abs().max()):
        raise AssertionError(f"{name}: W err {err:.3e}")
    return err


def check_trinv_pattern(kind, layout, device=DEVICE):
    """The triangular inverse of a (4, 512) batch with TRINV_CORRUPTIONS[kind]
    in blocks (1, 2) and (3, 0), column-major (as torch.linalg.cholesky
    returns it) or row-major: NaN and inf exactly where the plain version
    has them, and only in those blocks. Returns the counts of NaN and inf."""
    from portfoliooptgp_tpu_torch.ops import nll

    L = torch.linalg.cholesky(_spd(4, 512, 11, device).double()).float()
    if layout == "row-major":
        L = L.contiguous()
    r, c, value = TRINV_CORRUPTIONS[kind]
    for b, p in ((1, 2), (3, 0)):
        L[b, 128 * p + r, 128 * p + c] = value
    Wk = nll.triangular_inverse(L)
    Wp = nll.triangular_inverse_plain(L)
    bad = ~torch.isfinite(Wp)
    if not (bool(bad[1, 2].any()) and bool(bad[3, 0].any()) and not bool(bad[0].any())):
        raise AssertionError(f"trinv {kind}: the corruption did not reach W as planted")
    check_trinv_equal(f"trinv {kind} {layout}", Wk, Wp)
    return int(torch.isnan(Wp).sum()), int(torch.isinf(Wp).sum())


def _hinv_problem(B, N, kind):
    """(K, y, noise) float32 on the card: 'icm', λ_i·Kx of the five-year
    grid's shape (SE on a unit-std day index, lengthscale 0.5, λ geometric
    in 1e-5..1e-3, noise 2e-4, returns-sized y); 'bench',
    benchmarks/bench_hinv4096.make_problem's SE batch."""
    rng = np.random.default_rng(N + B)
    if kind == "icm":
        x = np.linspace(-1.73, 1.73, N)
        K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.25)[None] * np.geomspace(
            1e-5, 1e-3, B)[:, None, None]
        y = 0.01 * rng.normal(size=(B, N))
        noise = np.full(B, 2e-4)
    else:
        X = np.sort(rng.uniform(0, 40 * N / 1024, size=N))
        v, ell = np.geomspace(0.5, 2.0, B), np.geomspace(2, 16, B)
        K = v[:, None, None] * np.exp(-0.5 * (X[:, None] - X[None, :]) ** 2 / ell[:, None, None] ** 2)
        y = np.broadcast_to(np.sin(X / 3.0) + 0.1 * rng.normal(size=N), (B, N))
        noise = np.full(B, 1e-2)
    return tuple(torch.tensor(np.asarray(a), dtype=torch.float32, device=DEVICE)
                 for a in (K, y, noise))


def phase_hinv_checks():
    """Phase 7. The triangular-inverse kernel against triangular_inverse_plain
    on the card at 220, 160, 40, 20 and 8 blocks (the five-year grid's
    20 × 1408 factors and the uneven split's 20 × 1024, 20 × 256, 20 × 128,
    and 8 × 128): random, ill-conditioned and NaN-holding factors; W within
    VALUE_RTOL of max |W| and NaN exactly where the plain version has it;
    NaN inside a diagonal and an off-diagonal 32-block and a zero pivot in
    column- and row-major factors (check_trinv_pattern), and the uneven
    split's views of a factor, NaN and inf exactly where the plain version
    has them. Then batched_nll_hinv's values and gradients on the card
    against the same call on CPU copies (phase 2's tolerances) at (B, N) =
    (20, 1304), ICM-like, and (8, 2048), bench_hinv4096's. Then the times,
    by CUDA-graph replay and eager: the kernel at 220, 160, 40 and 20
    blocks, its plain version and torch.linalg.solve_triangular(L_blocks,
    I) at 220 blocks, the whole triangular_inverse_uneven at (20, 1408);
    the hinv value+grad at (20, 1304); and torch.linalg.cholesky +
    torch.cholesky_inverse on the same Ks as a yardstick."""
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn
    from portfoliooptgp_tpu_torch.ops import linalg
    from portfoliooptgp_tpu_torch.ops import nll

    worst, worst_abs = 0.0, 0.0
    for B, Np in TRINV_SHAPES:
        for kind in ("random", "ill", "nan"):
            L = _chol_factors(kind, B, Np, Np + B)
            Wk = nll.triangular_inverse_cuda(L)
            Wp = nll.triangular_inverse_plain(L)
            torch.cuda.synchronize()
            nan_k, nan_p = torch.isnan(Wk), torch.isnan(Wp)
            if not torch.equal(nan_k, nan_p):
                raise AssertionError(f"trinv {kind} {B}x{Np}: NaN pattern differs from plain "
                                     f"({int(nan_k.sum())} vs {int(nan_p.sum())})")
            if kind == "nan" and not bool(nan_k[B - 1, -1].any()):
                raise AssertionError(f"trinv {kind} {B}x{Np}: the NaN did not reach W")
            fin = ~nan_p
            err = _max_err(Wk[fin], Wp[fin])
            scale = float(Wp[fin].abs().max())
            if not (torch.all(torch.isfinite(Wk[fin])) and err <= VALUE_RTOL * scale):
                raise AssertionError(f"trinv {kind} {B}x{Np}: W err {err:.3e} > {VALUE_RTOL} x "
                                     f"{scale:.3e}")
            worst, worst_abs = max(worst, err / scale), max(worst_abs, err)
        print(f"check trinv B={B} Np={Np} ({B * Np // 128} blocks): random, ill-conditioned "
              f"and NaN factors match plain; worst normalized err so far {worst:.3e}", flush=True)
    for kind in TRINV_CORRUPTIONS:
        for layout in ("column-major", "row-major"):
            n_nan, n_inf = check_trinv_pattern(kind, layout)
            print(f"check trinv {kind} ({layout}): NaN {n_nan} and inf {n_inf} entries, exactly "
                  "where the plain version has them", flush=True)
    L = _chol_factors("random", 20, 1408, 13)
    L[7, 1024 + 200, 1024 + 150] = float("nan")
    for lo, hi in UNEVEN_VIEWS:
        Wk = nll.triangular_inverse_cuda(L[:, lo:hi, lo:hi])
        Wp = nll.triangular_inverse_plain(L[:, lo:hi, lo:hi])
        check_trinv_equal(f"trinv uneven view [{lo}:{hi}]", Wk, Wp)
    print(f"check trinv on the uneven split's views {UNEVEN_VIEWS} of a (20, 1408) factor, one "
          "with a NaN: match plain, NaN and inf exactly where it has them", flush=True)
    for B, N, kind in ((20, 1304, "icm"), (8, 2048, "bench")):
        if not bn.hinv_nll_preferred(N, B):
            raise AssertionError(f"({B}, {N}) is not in the hinv window")
        K, y, noise = _hinv_problem(B, N, kind)
        outs = []
        for dev in (DEVICE, "cpu"):
            leaves = [x.detach().to(dev).requires_grad_(True) for x in (K, y, noise)]
            value = bn.batched_nll_hinv(*leaves)
            grads = torch.autograd.grad(value.sum(), leaves)
            outs.append((value.detach().to(DEVICE), [g.to(DEVICE) for g in grads]))
        torch.cuda.synchronize()
        verr = _check_values(f"hinv nll B={B} N={N}", outs[0][0], outs[1][0])
        gerr = _check_grads(f"hinv nll B={B} N={N}", outs[0][1], outs[1][1])
        print(f"check hinv nll B={B} N={N} ({kind}): value rel err {verr:.3e}, grad normalized "
              f"err {gerr:.3e}", flush=True)

    L = _chol_factors("random", 20, 1408, 7)  # column-major, as on the path
    blocks = torch.stack([L[:, p * 128:(p + 1) * 128, p * 128:(p + 1) * 128]
                          for p in range(11)], dim=1).reshape(220, 128, 128).contiguous()
    eye = torch.eye(128, device=DEVICE).expand(220, 128, 128)
    K, y, noise = _hinv_problem(20, 1304, "icm")
    leaves = [x.clone().requires_grad_(True) for x in (K, y, noise)]

    def value_and_grad():
        value = bn.batched_nll_hinv(*leaves)
        return torch.autograd.grad(value.sum(), leaves)

    Ks = linalg.add_diag(K, noise)
    sizes = ((220, L), (160, L[:, :1024, :1024]), (40, L[:, 1024:1280, 1024:1280]),
             (20, L[:, 1280:, 1280:]))
    with torch.no_grad():
        graph = {nb: graph_ms(lambda s=s: nll.triangular_inverse_cuda(s)) for nb, s in sizes}
        eager = {nb: cuda_ms(lambda s=s: nll.triangular_inverse_cuda(s), reps=50)
                 for nb, s in sizes}
        p = graph_ms(lambda: nll.triangular_inverse_plain(L), reps=5)
        p_eager = cuda_ms(lambda: nll.triangular_inverse_plain(L), reps=5, warmup=1)
        lib = graph_ms(lambda: torch.linalg.solve_triangular(blocks, eye, upper=False))
        lib_eager = cuda_ms(lambda: torch.linalg.solve_triangular(blocks, eye, upper=False),
                            reps=50)
        whole = graph_ms(lambda: bn.triangular_inverse_uneven(L), reps=20)
        whole_eager = cuda_ms(lambda: bn.triangular_inverse_uneven(L), reps=20)
        chol_inv = cuda_ms(lambda: torch.cholesky_inverse(torch.linalg.cholesky(Ks)), reps=10)
    vg = cuda_ms(value_and_grad, reps=10)
    k = graph[220]
    bound, bound_by = trinv_bound_ms(220)
    print(f"phase 7 trinv 220 blocks (graph replay): kernel {k:.4f} ms, plain {p:.4f} ms, "
          f"torch.linalg.solve_triangular(L_blocks, I) {lib:.4f} ms, bound {bound:.6f} ms "
          f"({bound_by}); kernel at the uneven split's sizes " + json.dumps(
              {nb: round(ms, 4) for nb, ms in graph.items()}) + "; eager (CUDA events around "
          "back-to-back calls) " + json.dumps({nb: round(ms, 4) for nb, ms in eager.items()})
          + f", plain {p_eager:.4f} ms, solve_triangular {lib_eager:.4f} ms", flush=True)
    print(f"  occupancy: trinv {nll._lib().trinv_ctas_per_sm()} CTAs per SM, blocked_panel "
          f"{bn._lib().blocked_panel_ctas_per_sm()}; whole hierarchical inverse (20, 1408) "
          f"{whole:.4f} ms graph, {whole_eager:.4f} ms eager; hinv value+grad (20, 1304) "
          f"{vg:.4f} ms; torch.linalg.cholesky + torch.cholesky_inverse on the same Ks "
          f"{chol_inv:.4f} ms", flush=True)
    return dict(ms=k, plain_ms=p, library_ms=lib, bound_ms=bound, bound_by=bound_by,
                max_abs_err=worst_abs, value_grad_ms=vg, eager_ms=eager[220])


def _frontier_report(label, elapsed, q):
    print(f"phase 8 frontier {q['grid']} {label}: {elapsed:.2f} s, N={q['n']} tier {q['tier']}, "
          f"NLL {q['start_nll']:.7g} -> {q['final_nll']:.7g} in {q['iters']} iterations, "
          f"launches {json.dumps({k: v for k, v in q['launches'].items() if v})}", flush=True)
    if "frontier_seconds" in q["replay"]:
        print(f"  the frontier sweep alone (32 points + tangency): "
              f"{q['replay']['frontier_seconds']:.2f} s", flush=True)


# The row-batched sweep against the per-point loop it replaced, in float32,
# on grid B's warm (μ, Σ): the two round differently (a batched reduction
# against a vector's), so the augmented Lagrangian's L-BFGS stops a rounding
# apart. An H100 gave 5.4e-4 at most there, the CPU 8.6e-4 on the goldens'
# grid-B (μ, Σ) (time_frontier_sweep(..., device="cpu")); about 3.5 times
# the larger.
SWEEP_WEIGHT_ATOL = 3e-3


def time_frontier_sweep(mu, Sigma, n_points=32, device=DEVICE, dtype=torch.float32):
    """The efficient frontier's sweep (n_points return floors from min μ to
    max μ, √(wᵀΣw) minimized over the simplex) twice on the same inputs:
    as the loop of one `minimize_simplex` a point that the port ran before
    the sweep was batched, then as the one `minimize_simplex_rows` solve
    `efficient_frontier` runs. Raises unless every weight agrees within
    SWEEP_WEIGHT_ATOL. Returns both times and the largest |ΔW|."""
    from portfoliooptgp_tpu_torch.portfolio.solver import (
        minimize_simplex,
        minimize_simplex_rows,
    )

    mu = torch.as_tensor(np.asarray(mu), dtype=dtype, device=device)
    Sigma = torch.as_tensor(np.asarray(Sigma), dtype=dtype, device=device)
    p = mu.shape[0]
    targets = torch.linspace(float(mu.min()), float(mu.max()), n_points, dtype=dtype,
                             device=device)
    opt = dict(device=device, dtype=dtype)

    def sync():
        if str(device).startswith("cuda"):
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    W_loop = torch.stack([minimize_simplex(
        lambda w: torch.sqrt(torch.clamp_min(w @ Sigma @ w, 1e-18)), p,
        ineq=lambda w, t=t: mu @ w - t, **opt).weights for t in targets])
    sync()
    t1 = time.perf_counter()
    W_rows = minimize_simplex_rows(
        lambda W: torch.sqrt(torch.clamp_min(torch.sum((W @ Sigma) * W, dim=-1), 1e-18)),
        n_points, p, ineq=lambda W: W @ mu - targets, **opt).weights
    sync()
    t2 = time.perf_counter()
    err = float(torch.max(torch.abs(W_rows - W_loop)))
    if not err <= SWEEP_WEIGHT_ATOL:
        raise AssertionError(f"the batched sweep's weights lie {err:.3g} from the loop's "
                             f"(limit {SWEEP_WEIGHT_ATOL})")
    return dict(loop_s=t1 - t0, rows_s=t2 - t1, max_abs_dw=err)


def phase_frontier():
    """Phase 8. The frontier pipeline on the card in float32 from JAX's W₀:
    the one-year grid once, the five-year grid cold, warm and under the
    profiler; each run against the goldens by compare_frontier, the launch
    counts of the pipeline run read after it (the one-year grid on the
    stationary kernel and no triangular inverse, the five-year grid's fit
    on the triangular inverse)."""
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    t_phase = time.perf_counter()
    results = {}
    for grid in ("1y", "5y"):
        with open(frontier_goldens_path(grid)) as fh:
            g = json.load(fh)
        with open(frontier_goldens_path(grid, True)) as fh:
            g32 = json.load(fh)
        with tempfile.TemporaryDirectory() as root:
            make_frontier_market(root, *FRONTIER_GRIDS[grid], seed=g["market_seed"])
            before = st.kernel_launches()
            runs = [("cold", *run_frontier(root, grid, g, g32, DEVICE))]
            ran = launches_since(before)
            if grid == "5y":
                # the replays do not depend on the fit: the warm run reuses the cold run's
                runs.append(("warm", *run_frontier(root, grid, g, g32, DEVICE, replay=False)))
                runs[1][2]["replay"] = runs[0][2]["replay"]
                from portfoliooptgp_tpu_torch.ops import nll

                busy = device_busy(lambda: run_frontier(root, grid, g, g32, DEVICE, replay=False),
                                   "frontier_profile.txt", kernel="trinv")
                # run_frontier zeroes the counts as it starts: all of them are this run's
                profiled_launches = nll.LAUNCHES["triangular_inverse"]
        for label, elapsed, q in runs:
            _frontier_report(label, elapsed, q)
            ok, bad = compare_frontier(q, g, g32)
            if not ok:
                raise AssertionError(f"frontier {grid} {label} does not match the goldens: {bad}")
            print(f"  {label} " + json.dumps(dict(
                kernel_lengthscale=q["kernel_lengthscale"], noise_variance=q["noise_variance"],
                tangency_return=q["frontier"]["tangency_return"],
                tangency_volatility=q["frontier"]["tangency_volatility"],
                replay_nll={t: q["replay"][t]["nll"] for t in ("f64", "f32")})), flush=True)
        counts = runs[0][2]["launches"]
        stationary = counts["stationary_nll"] + counts["stationary_nll_general"]
        if grid == "1y" and (stationary < 1 or counts["triangular_inverse"] or ran["cluster"] < 1):
            raise AssertionError(f"the one-year frontier run launched {counts} ({ran})")
        print(f"  {grid} cold run: stationary tile kernel {ran['tile']}, cluster kernel "
              f"{ran['cluster']} launches", flush=True)
        if grid == "5y" and counts["triangular_inverse"] < 1:
            raise AssertionError(f"the five-year frontier run launched {counts}")
        print(f"  goldens MATCH on {grid} (JAX float64 NLL {g['final_nll']:.7g}, float32 "
              f"{g32['final_nll']:.7g})", flush=True)
        results[grid] = runs
    warm = results["5y"][1][1]
    q = results["5y"][1][2]
    sweep = time_frontier_sweep(q["mu"], q["Sigma"])
    print(f"phase 8 frontier 5y sweep, 32 points on the warm run's (μ, Σ): the per-point loop "
          f"{sweep['loop_s']:.3f} s, one row-batched solve {sweep['rows_s']:.3f} s; weights "
          f"within {sweep['max_abs_dw']:.3g} of the loop's (limit {SWEEP_WEIGHT_ATOL})",
          flush=True)
    if busy["device_s"] > 0:
        n = profiled_launches
        print(f"  profiled five-year run: {busy['wall_s']:.2f} s wall, device busy "
              f"{busy['device_s']:.3f} s ({100 * busy['device_s'] / warm:.1f}% of the "
              f"unprofiled warm run), trinv kernel {busy['kernel_s']:.4f} s "
              f"over its {n} launches, {1e3 * busy['kernel_s'] / max(n, 1):.4f} ms a launch)",
              flush=True)
    else:
        print("  profiled five-year run: the profiler recorded no device events; device busy "
              "share not measured", flush=True)
    print(f"phase 8 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=results["5y"][0][2]["launches"]["triangular_inverse"], sweep=sweep)


# The multi-input shapes, the window's top, tile edges (N = 33: one entry
# past a 32-column tile; B = 1, N = 256: eight whole tiles) and partial tiles.
DENSE_SHAPES = ((1, 72), (4, 72), (20, 77), (5, 77), (8, 224), (128, 256), (3, 131), (1, 33),
                (1, 256))
DENSE_TIMED = ((20, 77), (128, 256), (5, 200))  # (5, 200): the `+ White` route's


def dense_bound_ms(B, N, with_inverse):
    """Least time for the dense NLL kernel on an H100: the larger of the
    bytes it must move (the lower triangle of K, y and σ² read once; a, the
    NLL, Σ log diag L and, with W, all N² entries of W written once) over
    HBM bandwidth and its fp32 operations, B·(N³/3 [+ N³/3] + N²), over the
    fp32 peak."""
    tri = N * (N + 1) / 2
    nbytes = 4 * B * (tri + N + 1 + N + 2 + (N * N if with_inverse else 0))
    flops = B * (N ** 3 / 3 + (N ** 3 / 3 if with_inverse else 0) + N * N)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _dense_problem(kind, B, N, seed):
    """(K, y, σ²) float32 on the card: 'random', AAᵀ/N + an SE Gram matrix,
    σ² in [0.05, 0.3]; 'ill', QΛQᵀ with Λ geometric from 1 to 1e-6 and
    σ² = 0 (condition number 1e6); 'indefinite', the random ones with the
    last model's trailing half shifted by −5·I (NaN from its middle column)."""
    rng = np.random.default_rng(seed)
    if kind == "ill":
        Q, _ = np.linalg.qr(rng.normal(size=(B, N, N)))
        K = np.einsum("bij,j,bkj->bik", Q, np.geomspace(1.0, 1e-6, N), Q)
        noise = np.zeros(B)
    else:
        A = rng.normal(size=(B, N, N))
        x = np.sort(rng.uniform(0, 10, N))
        K = np.einsum("bij,bkj->bik", A, A) / N + np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2)
        noise = rng.uniform(0.05, 0.3, B)
        if kind == "indefinite":
            K[-1, N // 2:, N // 2:] -= 5.0 * np.eye(N - N // 2)
    return tuple(torch.tensor(np.asarray(a), dtype=torch.float32, device=DEVICE)
                 for a in (K, rng.normal(size=(B, N)), noise))


def check_dense(label, K, y, noise, indefinite):
    """Both variants of the dense kernel on (K, y, σ²) against the plain
    version: a, Σ log diag L and W within VALUE_RTOL of their largest value,
    or within four times the plain version's own float32 error against its
    float64 run where that is larger, and NaN exactly where the plain
    version has it (somewhere in the last model when `indefinite`). Returns
    each variant's largest absolute error, {with_w: err}."""
    from portfoliooptgp_tpu_torch.ops import nll

    want64 = nll.factor_solve_inv_plain(K.double(), y.double(), noise.double())
    want = nll.factor_solve_inv_plain(K, y, noise)
    worst = {}
    for with_w in (True, False):
        _, a, logdet, W = nll.factor_solve_cuda(K, y, noise, with_w)
        torch.cuda.synchronize()
        worst[with_w] = 0.0
        for name, got, ref, ref64 in zip(("a", "logdet", "W"), (a, logdet, W), want, want64):
            if got is None:
                continue
            nan_k, nan_p = torch.isnan(got), torch.isnan(ref)
            if not torch.equal(nan_k, nan_p):
                raise AssertionError(f"{label} {name}: NaN pattern differs "
                                     f"({int(nan_k.sum())} vs {int(nan_p.sum())})")
            if indefinite and not bool(nan_k[-1].any()):
                raise AssertionError(f"{label} {name}: no NaN")
            fin = ~nan_p
            if not bool(fin.any()):  # B = 1 indefinite: the log-det is NaN
                continue
            scale = float(ref[fin].abs().max())
            own = _max_err(ref[fin], ref64[fin]) / scale
            err = _max_err(got[fin], ref[fin]) / scale
            if not (torch.all(torch.isfinite(got[fin])) and err <= max(VALUE_RTOL, 4 * own)):
                raise AssertionError(f"{label} {name}: normalized err {err:.3e} > "
                                     f"max({VALUE_RTOL}, 4 x {own:.3e})")
            worst[with_w] = max(worst[with_w], _max_err(got[fin], ref[fin]))
    return worst


# `Exponential + White`: White is no fused atom, so at padded N ≤ 256 in
# float32 the router sends the sum to the dense kernel on a K built in torch.
WHITE_SHAPES = ((20, 77), (5, 200))


def check_white_route(B, N, seed):
    """B `GPR(Exponential + White)` models on N day indices through
    `batched_neg_log_marginal_likelihood` on the card: the tier must be
    `pallas_dense`; its value and gradients are held against the same call
    on CPU copies (phase 2's tolerances), and the dense kernel, both
    variants, against its plain version on the K the router builds
    (`check_dense`: White's σ²I inside K, the likelihood's σ² added by the
    kernel). Returns the launches of the value+grad call and each
    variant's largest absolute error."""
    from portfoliooptgp_tpu_torch import kernels as tk
    from portfoliooptgp_tpu_torch import params
    from portfoliooptgp_tpu_torch.models import gpr
    from portfoliooptgp_tpu_torch.ops import nll
    from portfoliooptgp_tpu_torch.train import lbfgs

    rng = np.random.default_rng(seed)
    o = dict(device=DEVICE, dtype=torch.float32)
    model = lbfgs.stack_pytrees([
        gpr.GPR.create(tk.Exponential.create(variance=v, lengthscales=ell, **o)
                       + tk.White.create(variance=w, **o), noise)
        for v, ell, w, noise in zip(rng.uniform(0.5, 2.0, B), rng.uniform(0.3, 3.0, B),
                                    rng.uniform(1e-3, 0.1, B), rng.uniform(1e-3, 0.1, B))])
    t = np.linspace(-1.7, 1.7, N)
    X = torch.tensor(t[:, None], **o)
    Y = torch.tensor(np.sin(3 * t)[:, None] + 0.1 * rng.normal(size=(N, 1)), **o)
    tier = gpr.nll_tier(model, X, Y)
    if tier != "pallas_dense":
        raise AssertionError(f"Exponential + White at (B, N) = ({B}, {N}) routes to {tier}")
    outs, launches = [], None
    for dev in (DEVICE, "cpu"):
        leaves = [x.detach().to(dev).requires_grad_(True) for x in params.tree_leaves(model)]
        before = dict(nll.LAUNCHES)
        value = gpr.batched_neg_log_marginal_likelihood(
            params.tree_replace(model, leaves), X.to(dev), Y.to(dev), device=dev,
            dtype=torch.float32)
        grads = torch.autograd.grad(value.sum(), leaves)
        if dev == DEVICE:
            torch.cuda.synchronize()
            launches = {k: nll.LAUNCHES[k] - before[k] for k in ("dense_nll", "dense_nll_inv")}
        outs.append((value.detach().to(DEVICE), [g.to(DEVICE) for g in grads]))
    if launches["dense_nll_inv"] < 1:
        raise AssertionError(f"Exponential + White ({B}, {N}): the dense kernel did not "
                             f"launch ({launches})")
    verr = _check_values(f"white route B={B} N={N}", outs[0][0], outs[1][0])
    gerr = _check_grads(f"white route B={B} N={N}", outs[0][1], outs[1][1])
    with torch.no_grad():
        K = model.kernel.K(X)
        y = Y[:, 0].expand(B, N).contiguous()
        errs = check_dense(f"white route B={B} N={N}", K, y, model.likelihood.variance, False)
    print(f"check Exponential + White B={B} N={N}: tier {tier}, launches {launches}; "
          f"value+grad against CPU copies: value rel err {verr:.3e}, grad normalized err "
          f"{gerr:.3e}; the dense kernel on its K against plain: max abs err with W "
          f"{errs[True]:.3e}, value only {errs[False]:.3e}", flush=True)
    return dict(launches=launches, max_abs_err=errs)


def phase_dense():
    """Phase 9a–b. The dense NLL kernel (both variants) against its plain
    version on the card at DENSE_SHAPES: random, ill-conditioned and
    indefinite inputs; a, Σ log diag L and W within VALUE_RTOL of their
    largest value, or within four times the plain version's own float32
    error against its float64 run where that is larger (the ill-conditioned
    inputs), and NaN exactly where the plain version has it (`check_dense`),
    then on a transposed and a sliced view of K. Then batched_nll's values
    and gradients against the same call on CPU copies (phase 2's
    tolerances). Then the times at DENSE_TIMED (`dense_times`:
    graph replay, eager beside) and the kernel's occupancy."""
    from portfoliooptgp_tpu_torch.ops import nll

    worst = {True: 0.0, False: 0.0}
    for B, N in DENSE_SHAPES:
        for kind in ("random", "ill", "indefinite"):
            errs = check_dense(f"dense {kind} B={B} N={N}",
                               *_dense_problem(kind, B, N, B * 1000 + N), kind == "indefinite")
            if kind == "random":
                worst = {w: max(worst[w], errs[w]) for w in worst}
        print(f"check dense B={B} N={N}: both variants match plain on random, ill-conditioned "
              f"and indefinite inputs", flush=True)
    K, y, noise = _dense_problem("indefinite", 3, 77, 77)
    check_dense("dense transposed view", K.transpose(1, 2), y, noise, True)
    big = _dense_problem("indefinite", 3, 81, 81)[0]  # row stride 81
    check_dense("dense sliced view", big[:, 2:79, 2:79], y, noise, True)
    print("check dense on a transposed and a sliced view of K (read in place): both variants "
          "match plain", flush=True)
    for B, N in ((20, 77), (128, 256), (3, 131)):
        K, y, noise = _dense_problem("random", B, N, 7 + N)
        outs = []
        for dev in (DEVICE, "cpu"):
            leaves = [x.detach().to(dev).requires_grad_(True) for x in (K, y, noise)]
            value = nll.batched_nll(*leaves)
            grads = torch.autograd.grad(value.sum(), leaves)
            outs.append((value.detach().to(DEVICE), [g.to(DEVICE) for g in grads]))
        torch.cuda.synchronize()
        verr = _check_values(f"dense nll B={B} N={N}", outs[0][0], outs[1][0])
        gerr = _check_grads(f"dense nll B={B} N={N}", outs[0][1], outs[1][1])
        print(f"check dense nll B={B} N={N}: value rel err {verr:.3e}, grad normalized err "
              f"{gerr:.3e}", flush=True)

    white = {(B, N): check_white_route(B, N, B + N) for B, N in WHITE_SHAPES}
    for shape in white.values():
        worst = {w: max(worst[w], shape["max_abs_err"][w]) for w in worst}

    times = {}
    for B, N in DENSE_TIMED:
        row = times[(B, N)] = dense_times(nll, B, N)
        print(f"phase 9 dense B={B} N={N} (graph replay): kernel with W {row['ms_inv']:.4f} ms, "
              f"value only {row['ms_value']:.4f} ms; plain {row['plain_ms_inv']:.4f} / "
              f"{row['plain_ms_value']:.4f} ms; torch.linalg chain {row['library_ms_inv']:.4f} / "
              f"{row['library_ms_value']:.4f} ms; bound {row['bound_inv'][0]:.6f} "
              f"({row['bound_inv'][1]}) / {row['bound_value'][0]:.6f} ms "
              f"({row['bound_value'][1]}); eager (CUDA events around back-to-back calls): "
              f"kernel {row['eager_ms_inv']:.4f} / {row['eager_ms_value']:.4f} ms, chain "
              f"{row['library_eager_ms_inv']:.4f} / {row['library_eager_ms_value']:.4f} ms; "
              f"occupancy {nll._dense_lib().dense_nll_ctas_per_sm(N, 1)} / "
              f"{nll._dense_lib().dense_nll_ctas_per_sm(N, 0)} CTAs per SM", flush=True)
    return dict(max_abs_err=worst, times=times, white=white)


def dense_times(nll, B, N):
    """The dense kernel's times at (B, N) on `_dense_problem("random", B, N,
    11)`, with and without W: the kernel, the plain version and the
    torch.linalg chain (cholesky_ex + solve_triangular(L, y), with W
    solve_triangular(L, [y, I])) by CUDA-graph replay (`graph_ms`); the
    kernel and the chain (with `cholesky`) eager (`cuda_ms`); and the bound.
    `nll` is the port's ops.nll module: tools/dense_compare.py passes that of
    another checkout."""
    K, y, noise = _dense_problem("random", B, N, 11)
    Ks = K + torch.diag_embed(noise[:, None].expand(B, N))
    eye = torch.eye(N, device=DEVICE).expand(B, N, N)

    def chain(with_w, factor):
        L = factor(Ks)
        rhs = torch.cat([y[:, :, None], eye], dim=-1) if with_w else y[:, :, None]
        return torch.linalg.solve_triangular(L, rhs, upper=False)

    row = {}
    with torch.no_grad():
        for with_w in (True, False):
            tag = "inv" if with_w else "value"
            plain = nll.factor_solve_inv_plain if with_w else nll.factor_solve_plain
            row[f"ms_{tag}"] = graph_ms(lambda: nll.factor_solve_cuda(K, y, noise, with_w))
            row[f"eager_ms_{tag}"] = cuda_ms(lambda: nll.factor_solve_cuda(K, y, noise, with_w))
            row[f"plain_ms_{tag}"] = graph_ms(lambda: plain(K, y, noise), reps=5)
            row[f"library_ms_{tag}"] = graph_ms(
                lambda: chain(with_w, lambda A: torch.linalg.cholesky_ex(A)[0]))
            row[f"library_eager_ms_{tag}"] = cuda_ms(lambda: chain(with_w, torch.linalg.cholesky))
            row[f"bound_{tag}"] = dense_bound_ms(B, N, with_w)
    return row


def _multi_input_report(label, elapsed, q):
    print(f"phase 9 multi-input f32 {label}: {elapsed:.2f} s", flush=True)
    for name, c in q["cases"].items():
        counts = {k: v for k, v in c["launches"].items() if v}
        print(f"  {name}: {c['seconds']:.2f} s, tiers {[f['tiers'] for f in c['fits']]}, "
              f"losses {[round(f['loss'], 6) for f in c['fits']]}, winners "
              f"{[f['winner'] for f in c['fits']]}, launches {json.dumps(counts)}", flush=True)
    if "workflow" in q:
        w = q["workflow"]
        print(f"  workflow (Polynomial pair, trained likelihood): {w['seconds']:.2f} s, "
              f"launches {json.dumps({k: v for k, v in w['launches'].items() if v})}", flush=True)


MULTI_INPUT_CHIP_CASES = [name for name, (step, pair, fixed) in MULTI_INPUT_CASES.items()
                          if pair == "poly" or fixed]


def phase_multi_input():
    """Phase 9c. The multi-input flow on the card in float32, cold then
    warm: steps 1–3 for MULTI_INPUT_TICKER with the default pair (σ²
    fixed, the CLI path, on the fused kernel) and with (Polynomial,
    Exponential), fixed and trained likelihood (the dense kernel at B = 1
    and 4), run_step_4(batched=False) with the Polynomial pair, and the
    5-asset workflow with the Polynomial pair and trained likelihood (step 4
    at B = 5 days × 4 restarts, N = 77), each against the JAX goldens by
    compare_multi_input, with the launch counts of each run: the dense
    kernels above 0 on every Polynomial run, the stationary kernels 0 on its
    step-4 runs. Then step 1 with the trained Polynomial pair once more
    under the profiler, for the device's busy share."""
    from benchmarks.bench_portfolio_e2e import make_market
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    with open(multi_input_goldens_path()) as fh:
        goldens = json.load(fh)
    with open(multi_input_goldens_path(True)) as fh:
        goldens32 = json.load(fh)
    pairs = multi_input_pairs()
    runs = []
    with tempfile.TemporaryDirectory() as root:
        make_market(root)
        for label in ("cold", "warm"):
            before = st.kernel_launches()
            elapsed, q = run_multi_input(root, MULTI_INPUT_CHIP_CASES, goldens, goldens32, DEVICE)
            ran = launches_since(before)
            print(f"  multi-input {label} steps: stationary tile kernel {ran['tile']}, cluster "
                  f"kernel {ran['cluster']} launches", flush=True)
            step4 = []
            _reset_launch_counts()
            wf_s, quality = run_workflow(root, DEVICE, kernel_pairs=pairs["poly"],
                                         train_likelihood=True, step4=step4)
            q["workflow"] = dict(seconds=wf_s, launches=_launch_counts(), step4=step4,
                                 strategies=quality)
            _multi_input_report(label, elapsed + wf_s, q)
            runs.append((label, elapsed + wf_s, q))
        case = "step1/poly/trained"
        busy = device_busy(lambda: run_multi_input(root, [case], device=DEVICE),
                           "multi_input_profile.txt", kernel="dense_nll")
    for label, _, q in runs:
        for name, c in [*q["cases"].items(), ("workflow", q["workflow"])]:
            dense = c["launches"]["dense_nll"] + c["launches"]["dense_nll_inv"]
            stationary = (c["launches"]["stationary_nll"]
                          + c["launches"]["stationary_nll_general"])
            poly = name == "workflow" or c["pair"] == "poly"
            if poly and dense < 1:
                raise AssertionError(f"{label} {name} launched no dense NLL kernel")
            if poly and name.startswith(("step4", "workflow")) and stationary:
                raise AssertionError(f"{label} {name} launched {stationary} stationary kernels")
            if not poly and stationary < 1:
                raise AssertionError(f"{label} {name} launched no stationary NLL kernel")
        ok, bad = compare_multi_input(q, goldens, goldens32)
        if not ok:
            raise AssertionError(f"{label} multi-input run does not match the goldens: {bad}")
    print("  goldens MATCH, cold and warm", flush=True)
    if busy["device_s"] > 0:
        print(f"  profiled {case}: {busy['wall_s']:.2f} s wall, device busy "
              f"{busy['device_s']:.3f} s ({100 * busy['device_s'] / busy['wall_s']:.1f}% of the "
              f"profiled run), dense_nll kernels {busy['kernel_s']:.4f} s", flush=True)
    else:
        print("  profiled run: the profiler recorded no device events; device busy share "
              "not measured", flush=True)
    cold = runs[0][2]
    poly_runs = [c for name, c in cold["cases"].items() if c["pair"] == "poly"] + [
        cold["workflow"]]
    return dict(launches={k: sum(c["launches"][k] for c in poly_runs)
                          for k in ("dense_nll", "dense_nll_inv")},
                cold_s=runs[0][1], warm_s=runs[1][1])


def gram_bound_ms(M, B, D, backward):
    """Least time for one gram kernel call on an H100: the larger of the
    bytes it must move over HBM bandwidth and its fp32 operations over the
    fp32 peak. Bytes: Z (M·D), X (B·D), y, w (B each), t (M), v, s (D) read
    once, G (M²) and sq written once; the backward also reads Ḡ (M²) and
    s̄q and writes Z̄ (M·D), ȳ (B), t̄ (M), v̄, s̄ (D). Operations per (m, b):
    3D + 2 to build v φ(u) and 2 for m = tᵀKuf. The forward adds G, which
    is symmetric, so only its lower triangle: M(M + 1)/2 entries of 2B
    operations, M(M + 1)B in all, and MB to apply w. The backward adds
    (Ḡ + Ḡᵀ)Kuf, a full product of 2M²B, with M² to form Ḡ + Ḡᵀ, and per
    (m, b) 4 for K̄uf's epilogue, 3 for W2, 2 each for v̄ and t̄ and 5D for Z̄
    and s̄."""
    inputs = M * D + B * D + 2 * B + M + 1 + D
    flops = (3 * D + 2 + 2) * M * B
    if backward:
        nbytes = 4 * (inputs + M * M + 1 + M * D + B + M + 1 + D)
        flops += 2 * M * M * B + M * M + (4 + 3 + 2 + 2 + 5 * D) * M * B
    else:
        nbytes = 4 * (inputs + M * M + 1)
        flops += M * (M + 1) * B + M * B
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


GRAM_TIMED = ((128, 2048, 1), (128, 8192, 1))  # the SVGP path's batch; the TPU kernel's largest
GRAM_GRAPH_CALLS = 16  # kernel calls a CUDA graph holds for `ms16`


def gram_geometry(sg, M, B, D):
    """One line: the gram kernels' launch shape at (M, B, D) and how many of
    its CTAs an SM holds at once."""
    parts = []
    for name, launch, bwd in zip(("forward", "backward"), sg.launch_shape(M, B, D),
                                 (False, True)):
        parts.append(f"{name} {launch.units} units × C = {launch.ranks}: "
                     f"{launch.units * launch.ranks} CTAs, {launch.chunk} columns a rank"
                     f"{f', {launch.kc} rows of Kuf a pass' if bwd else ''}, {launch.smem} B "
                     f"of shared memory, {sg.blocks_per_sm(bwd, launch, D)} CTAs an SM at most")
    return f"gram launch shape at (M, B, D) = ({M}, {B}, {D}): " + "; ".join(parts)


def gram_times(sg, M, B, D):
    """Times of module `sg`'s gram kernels (this checkout's or another's
    `ops/svgp_gram.py`) at (M, B, D) on `gram_operands(seed=77)`, SE: each
    kernel as the device time of a CUDA-graph replay (`graph_ms`: one call a
    replay, `ms`, and GRAM_GRAPH_CALLS calls a replay, `ms16`), its eager
    wrapper call (`cuda_ms`: allocation, checks and the ctypes launch
    included), its plain version and the PyTorch chain (broadcast
    differences, exp, torch.matmul; its autograd for the backward) by graph
    replay, and the bound. Keys end in _fwd or _bwd."""
    Z, X, y, w, t, v, s, Gbar, sqbar = gram_operands(M, B, D, seed=77)

    def chain(Z, y, t, v, s):
        diff = Z[:, None, :] - X[None, :, :]
        K = v * torch.exp(-0.5 * torch.sum(diff * diff * s.reshape(-1), dim=-1))
        e = y - t @ K
        return (K * w) @ K.T, torch.sum(w * e * e)

    def fwd():
        return sg.gram_fwd_cuda(Z, X, y, w, t, v, s, "se")

    def bwd():
        return sg.gram_bwd_cuda(Z, X, y, w, t, v, s, "se", Gbar, sqbar)

    leaves = [a.clone().requires_grad_(True) for a in (Z, y, t, v, s)]
    side = torch.cuda.Stream()  # the chain's forward runs there, so its backward is captured
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = chain(*leaves)
    times = {}
    with torch.no_grad():
        for tag, fn in (("fwd", fwd), ("bwd", bwd)):
            times[f"ms_{tag}"] = graph_ms(fn)
            times[f"ms16_{tag}"] = graph_ms(fn, calls=GRAM_GRAPH_CALLS)
            times[f"eager_ms_{tag}"] = cuda_ms(fn)
        times["plain_ms_fwd"] = graph_ms(lambda: sg.gram_fwd_plain(Z, X, y, w, t, v, s, "se"))
        times["plain_ms_bwd"] = graph_ms(lambda: sg.gram_bwd_plain(Z, X, y, w, t, v, s, "se",
                                                                   Gbar, sqbar))
        times["library_ms_fwd"] = graph_ms(lambda: chain(Z, y, t, v, s))
    times["library_ms_bwd"] = graph_ms(lambda: torch.autograd.grad(
        out, leaves, (Gbar, sqbar), retain_graph=True), stream=side)
    times["bound_fwd"] = gram_bound_ms(M, B, D, False)
    times["bound_bwd"] = gram_bound_ms(M, B, D, True)
    return times


def report_gram_times(M, B, D, row):
    print(f"phase 10 gram (M, B, D) = ({M}, {B}, {D}), device times of CUDA-graph replays "
          f"(one call a replay; {GRAM_GRAPH_CALLS} calls a replay): forward kernel "
          f"{row['ms_fwd']:.4f} ms; {row['ms16_fwd']:.4f} ms (eager wrapper call "
          f"{row['eager_ms_fwd']:.4f} ms), plain {row['plain_ms_fwd']:.4f} ms, torch chain "
          f"{row['library_ms_fwd']:.4f} ms, bound {row['bound_fwd'][0]:.6f} ms "
          f"({row['bound_fwd'][1]}); backward kernel {row['ms_bwd']:.4f} ms; "
          f"{row['ms16_bwd']:.4f} ms (eager wrapper call {row['eager_ms_bwd']:.4f} ms), plain "
          f"{row['plain_ms_bwd']:.4f} ms, autograd {row['library_ms_bwd']:.4f} ms, bound "
          f"{row['bound_bwd'][0]:.6f} ms ({row['bound_bwd'][1]})", flush=True)


def gram_entry(row, tag):
    """A gram kernel's timing keys of the `kernels` line from a gram_times row."""
    return dict(ms=row[f"ms_{tag}"], ms16=row[f"ms16_{tag}"], plain_ms=row[f"plain_ms_{tag}"],
                bound_ms=row[f"bound_{tag}"][0], bound_by=row[f"bound_{tag}"][1],
                library_ms=row[f"library_ms_{tag}"], eager_ms=row[f"eager_ms_{tag}"])


def _rel_err(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def phase_svgp_checks():
    """Phase 10a–c. (a) Both gram kernels against their plain versions on the
    card in float32, four families × {isotropic D = 1, ARD D = 3} × (M, B) in
    GRAM_SHAPES, X on [0, 16060] days with a weight-0 tail and random Ḡ, s̄q:
    G and sq within GRAM_VALUE_RTOL, Z̄, ȳ, t̄, v̄, s̄ within GRAM_GRAD_ATOL
    (GRAM_GRAD_ATOL_ARD_MATERN for ARD Matern), each of its largest entry.
    (b) Value and gradient of `gaussian_elbo_gram_fused(use_pallas=True)`
    against `gaussian_elbo_gram` on the card and against the same call on
    CPU copies (phase 2's tolerances, tools/smoke_tpu.py's), on smoke_tpu's
    problem and on the benchmark's first batch at JAX float32's trained
    leaves. (c) The launch shape at each of GRAM_TIMED, (128, 2048, 1) and
    (128, 8192, 1) (`gram_geometry`), and the times there (`gram_times`:
    each kernel, its plain version and the PyTorch chain by CUDA-graph
    replay, the kernels eager as well, the bound); one eager value+grad of
    each route at the path's batch."""
    from portfoliooptgp_tpu_torch import kernels as tk
    from portfoliooptgp_tpu_torch.models import svgp as svgp_mod
    from portfoliooptgp_tpu_torch.models.likelihoods import Gaussian
    from portfoliooptgp_tpu_torch.ops import svgp_gram as sg
    from portfoliooptgp_tpu_torch.params import tree_leaves, tree_replace

    worst = {"fwd": 0.0, "bwd": 0.0}
    for i, family in enumerate(sg.FAMILIES):
        for D in (1, 3):
            errs = [0.0, 0.0]
            for M, B in GRAM_SHAPES:
                ops = gram_operands(M, B, D, seed=100 * i + 10 * D + M + B)
                G, sq = sg.gram_fwd_cuda(*ops[:7], family)
                bars = sg.gram_bwd_cuda(*ops[:7], family, *ops[7:])
                torch.cuda.synchronize()
                Gp, sqp = sg.gram_fwd_plain(*ops[:7], family)
                barsp = sg.gram_bwd_plain(*ops[:7], family, *ops[7:])
                gtol = GRAM_GRAD_ATOL_ARD_MATERN if (D > 1 and family != "se") else GRAM_GRAD_ATOL
                for name, a, b, tol, slot in (
                        ("G", G, Gp, GRAM_VALUE_RTOL, 0), ("sq", sq, sqp, GRAM_VALUE_RTOL, 0),
                        *[(n, a, b, gtol, 1) for n, a, b in
                          zip(("Zbar", "ybar", "tbar", "vbar", "sbar"), bars, barsp)]):
                    err = _rel_err(a, b)
                    if not (torch.all(torch.isfinite(a)) and err <= tol):
                        raise AssertionError(f"gram {family} D={D} M={M} B={B} {name}: "
                                             f"err {err:.3e} > {tol}")
                    errs[slot] = max(errs[slot], err)
                    key = "fwd" if slot == 0 else "bwd"
                    worst[key] = max(worst[key], _max_err(a, b))
                if not torch.all(bars[1][int(ops[3].sum()):] == 0):
                    raise AssertionError(f"gram {family} D={D}: weight-0 rows got a ȳ")
            print(f"check gram {family} D={D}: kernels match plain at (M, B) in {GRAM_SHAPES}; "
                  f"worst forward err {errs[0]:.3e}, backward {errs[1]:.3e}", flush=True)

    rng = np.random.default_rng(12)
    o = dict(device=DEVICE, dtype=torch.float32)
    n, m = 512, 64
    Xs = np.sort(rng.uniform(0, 30, (n, 1)), axis=0)
    smoke = svgp_mod.SVGP.create(
        tk.SquaredExponential.create(1.3, 4.0, **o), np.linspace(0, 30, m)[:, None],
        likelihood=Gaussian.create(0.05, **o), **o)
    smoke = tree_replace(smoke, tree_leaves(smoke)[:4] + [
        torch.tensor(rng.normal(size=(m, 1)), **o),
        torch.tensor(np.tril(rng.normal(size=(1, m, m)) * 0.2) + np.eye(m), **o)])
    g32 = json.load(open(svgp_goldens_path(True)))["routes"]["kernel"]
    Xn, Yn, _ = svgp_problem()
    problems = {
        "smoke_tpu N=512 M=64": (smoke, torch.tensor(Xs, **o),
                                 torch.tensor(np.sin(Xs) + 0.1 * rng.normal(size=(n, 1)), **o),
                                 n),
        "full-AAPL first batch": (svgp_model(g32["leaves_final"]),
                                  torch.tensor(Xn[:SVGP_BATCH], **o),
                                  torch.tensor(Yn[:SVGP_BATCH], **o), SVGP_N)}
    for name, (model, X, Y, num_data) in problems.items():
        outs = []
        for dev, use_pallas in ((DEVICE, True), (DEVICE, None), ("cpu", True)):
            leaves = [x.detach().to(dev).requires_grad_(True) for x in tree_leaves(model)]
            mm = tree_replace(model, leaves)
            Xd, Yd = X.to(dev), Y.to(dev)
            if use_pallas is None:
                value = svgp_mod.gaussian_elbo_gram(mm, Xd, Yd, num_data=num_data)
            else:
                before = dict(sg.LAUNCHES)
                value = svgp_mod.gaussian_elbo_gram_fused(mm, Xd, Yd, num_data=num_data,
                                                          use_pallas=True)
            grads = torch.autograd.grad(value, leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
            if dev == DEVICE and use_pallas and sg.LAUNCHES["svgp_gram_bwd"] != \
                    before["svgp_gram_bwd"] + 1:
                raise AssertionError(f"{name}: use_pallas=True launched no gram kernel pair")
            outs.append((value.detach().reshape(1).to(DEVICE), [g.to(DEVICE) for g in grads]))
        torch.cuda.synchronize()
        for other, label in ((outs[1], "gaussian_elbo_gram on the card"),
                             (outs[2], "the same call on CPU copies")):
            verr = _check_values(f"{name} vs {label}", outs[0][0], other[0])
            gerr = _check_grads(f"{name} vs {label}", outs[0][1], other[1])
            print(f"check svgp use_pallas {name} vs {label}: value rel err {verr:.3e}, "
                  f"grad normalized err {gerr:.3e}", flush=True)

    for M, B, D in GRAM_TIMED:
        print(gram_geometry(sg, M, B, D), flush=True)
    times = {(M, B): gram_times(sg, M, B, D) for M, B, D in GRAM_TIMED}
    for M, B, D in GRAM_TIMED:
        report_gram_times(M, B, D, times[(M, B)])
    model = svgp_model(g32["leaves_final"])
    B = SVGP_BATCH
    Xb, Yb = torch.tensor(Xn[:B], **o), torch.tensor(Yn[:B], **o)
    value_grad = {}
    for route in SVGP_ROUTES:
        def value_grad_call():
            ls = [x.detach().requires_grad_(True) for x in tree_leaves(model)]
            val = svgp_mod.gaussian_elbo_gram_fused(tree_replace(model, ls), Xb, Yb,
                                                    num_data=SVGP_N, use_pallas=route == "kernel")
            return torch.autograd.grad(val, ls, allow_unused=True)
        value_grad[route] = cuda_ms(value_grad_call)
    print(f"phase 10 value+grad of the ELBO at batch {B} (eager): route (i) torch "
          f"{value_grad['xla']:.4f} ms, route (ii) kernels {value_grad['kernel']:.4f} ms",
          flush=True)
    return dict(max_abs_err=worst, times=times, value_grad_ms=value_grad)


def _svgp_report(label, q):
    for route, r in q["routes"].items():
        print(f"phase 10 svgp f32 {label} route {route}: {r['seconds']:.2f} s for {r['iters']} "
              f"steps, ELBO {r['elbo_start']:.6g} -> {r['elbo_final']:.6g} (full data), "
              f"launches {json.dumps(r['launches'])}", flush=True)


def steps_per_s(route, model, steps=200):
    """Adam train steps per second on the fixed first batch (bench.py's
    `svgp_elbo_train_steps_per_s` unit: weights 1, nothing frozen), route
    (i) through `make_elbo_train_step`, route (ii) through the gram kernels;
    10 warm-up steps, then `steps` timed ones ending in a synchronize."""
    from portfoliooptgp_tpu_torch.parallel import elbo_sharded

    Xn, Yn, _ = svgp_problem()
    o = dict(device=DEVICE, dtype=torch.float32)
    Xb, Yb = torch.tensor(Xn[:SVGP_BATCH], **o), torch.tensor(Yn[:SVGP_BATCH], **o)
    wb = torch.ones((SVGP_BATCH,), **o)
    if route == "xla":
        init_fn, step = elbo_sharded.make_elbo_train_step(num_data=SVGP_N)
        state = init_fn(model)
    else:
        state, step = make_kernel_route_step(model, SVGP_N, freeze_likelihood=False)
    for _ in range(10):
        state, _ = step(state, Xb, Yb, wb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, Xb, Yb, wb)
    torch.cuda.synchronize()
    rate = steps / (time.perf_counter() - t0)
    if not np.isfinite(float(loss)):
        raise AssertionError(f"route {route}: non-finite loss after the timed steps")
    return rate


def phase_svgp():
    """Phase 10d. The SVGP workflow at full-AAPL scale on the card in
    float32, cold then warm, both routes (`run_svgp`), each against JAX's
    runs of the same route in tests/goldens_torch/svgp_full_aapl*.json by
    `compare_svgp` (launch counts included: 60 of each gram kernel in route
    (ii), none in route (i)); then the steps per second of each route over
    200 warm steps on the first batch, and route (ii)'s training once more
    under the profiler for the device's busy share."""
    with open(svgp_goldens_path()) as fh:
        goldens = json.load(fh)
    with open(svgp_goldens_path(True)) as fh:
        goldens32 = json.load(fh)
    runs = []
    for label in ("cold", "warm"):
        q = run_svgp(goldens32, DEVICE)
        _svgp_report(label, q)
        ok, bad = compare_svgp(q, goldens, goldens32)
        if not ok:
            raise AssertionError(f"{label} SVGP run does not match the goldens: {bad}")
        runs.append(q)
        for route, rows in svgp_route_distances(q, goldens32).items():
            print(f"  {label} route {route}, trained outcome from JAX float32's run of the "
                  "route, |err| / limit: " + ", ".join(
                      f"{name} {err:.3g} / {lim:.3g}" for name, err, lim in rows), flush=True)
    print("  goldens MATCH, cold and warm, both routes", flush=True)
    model0 = svgp_model(goldens32["leaves_start"])
    rates = {route: steps_per_s(route, model0) for route in SVGP_ROUTES}
    print(f"  svgp_elbo_train_steps_per_s (200 warm steps, batch {SVGP_BATCH}): route (i) torch "
          f"{rates['xla']:.2f}, route (ii) kernels {rates['kernel']:.2f}", flush=True)
    Xn, Yn, _ = svgp_problem()
    busy = device_busy(lambda: train_kernel_route(model0, Xn, Yn), "svgp_profile.txt",
                       kernel="gram_")
    if busy["device_s"] > 0:
        print(f"  profiled route (ii) training: {busy['wall_s']:.2f} s wall, device busy "
              f"{busy['device_s']:.3f} s ({100 * busy['device_s'] / busy['wall_s']:.1f}% of the "
              f"profiled run), gram kernels {busy['kernel_s']:.4f} s", flush=True)
    else:
        print("  profiled run: the profiler recorded no device events; device busy share "
              "not measured", flush=True)
    return dict(launches=runs[0]["routes"]["kernel"]["launches"], rates=rates,
                seconds={label: {r: q["routes"][r]["seconds"] for r in SVGP_ROUTES}
                         for label, q in zip(("cold", "warm"), runs)})


def nuts_vg_check(label, X, Y, stacked, prior_of=None):
    """`gpr_logdensity_vg` on the card in float32 against the same call on
    CPU float64 copies (VALUE_RTOL, GRAD_ATOL normalized); the stationary
    kernel's launches and route per evaluation. Returns (max abs value err,
    launches, {"tile": n, "cluster": n, "grad": n})."""
    from portfoliooptgp_tpu_torch.inference import gpr_logdensity_vg
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st
    from portfoliooptgp_tpu_torch.params import tree_leaves, tree_to

    outs = []
    for dev, dt in ((DEVICE, torch.float32), ("cpu", torch.float64)):
        m = tree_to(stacked, dev, dt)
        vg = gpr_logdensity_vg(torch.as_tensor(X, device=dev, dtype=dt),
                               torch.as_tensor(Y, device=dev, dtype=dt),
                               None if prior_of is None else prior_of(dev, dt))
        if dev == DEVICE:
            before, ran = dict(st.LAUNCHES), st.kernel_launches()
        v, g = vg(m)
        if dev == DEVICE:
            torch.cuda.synchronize()
            launches = {k: st.LAUNCHES[k] - before[k] for k in before}
            ran = launches_since(ran)
        outs.append((v.to(DEVICE, torch.float64), [x.to(DEVICE, torch.float64)
                                                    for x in tree_leaves(g)]))
    verr = _check_values(f"NUTS vg {label}", outs[0][0], outs[1][0])
    gerr = _check_grads(f"NUTS vg {label}", outs[0][1], outs[1][1])
    print(f"check NUTS vg {label}: value rel err {verr:.3e}, grad normalized err {gerr:.3e}; "
          f"launches {launches}, tile kernel {ran['tile']}, cluster kernel {ran['cluster']}, "
          f"backward kernel {ran['grad']}", flush=True)
    return _max_err(outs[0][0], outs[1][0]), launches, ran


def _report_nuts(label, q):
    ev = q["evals"]
    leaves = ev["vg"] - 1  # the start's value+grad is no leaf
    print(f"phase 11 NUTS bench f32 {label}: {q['seconds']:.2f} s, nuts_draws_per_s "
          f"{q['draws_per_s']:.2f}; acceptance {q['accept']:.4f}, leaves per transition "
          f"{q['leaves']:.2f} (sampling), divergences {q['divergences']}, step {q['step_size']:.4g}; "
          f"value+grad evaluations {ev['vg']}, value-only {ev['logp']}, stationary_nll_general "
          f"launches {q['launches']['stationary_nll_general']} "
          f"({q['launches']['stationary_nll_general'] / (ev['vg'] + ev['logp']):.3f} per "
          f"evaluation); host syncs {q['syncs']} ({sum(q['syncs'].values()) / leaves:.3f} per "
          f"leaf); host {1e3 * q['seconds'] / leaves:.4f} ms per leaf", flush=True)


def phase_nuts():
    """Phase 11, the NUTS slice: (a) the chain-batched log-density on the
    card against CPU float64 copies, at tools/smoke_tpu.py's check (C = 8,
    N = 128, the tile kernel) and at bench.py's (8, 512) ARD posterior (the
    cluster kernel, one launch per evaluation); (b) bench.py's NUTS
    workload cold and warm, its draws per second, acceptance, tree sizes,
    launches and host syncs, a profiled run for the device's busy share,
    and the posterior against tests/goldens_torch/nuts_bench.json
    (`compare_nuts`); (c) the frontier pipeline with use_nuts=True on grid
    A against tests/goldens_torch/frontier_1y_nuts.json
    (`compare_frontier_nuts`), with its launches at (C·P, N) = (40, 262)."""
    from portfoliooptgp_tpu_torch import kernels as tk
    from portfoliooptgp_tpu_torch.inference import centered_normal_logprior
    from portfoliooptgp_tpu_torch.models import gpr
    from portfoliooptgp_tpu_torch.params import ravel, unravel

    # (a) smoke_tpu's fused NUTS log-density check, then bench.py's shape
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 30, (128, 1)), axis=0).astype(np.float32)
    Y = rng.normal(size=(128, 1)).astype(np.float32)
    m = gpr.GPR.create(tk.SquaredExponential.create(1.0, 5.0, device="cpu", dtype=torch.float64),
                       noise_variance=0.1)
    stack = unravel(m, ravel(m) * torch.linspace(0.9, 1.1, 8, dtype=torch.float64)[:, None])
    err, _, ran = nuts_vg_check("C=8 N=128 se", X, Y, stack)
    if ran != {"tile": 1, "cluster": 0, "grad": 1}:
        raise AssertionError(f"the C=8 N=128 evaluation ran {ran}, not one tile kernel and one "
                             "backward kernel")
    Xb, Yb = nuts_bench_data()
    m0 = nuts_bench_model("cpu", torch.float64)
    jitter = 0.1 * np.random.default_rng(1).normal(size=(8, 6))
    stack = unravel(m0, ravel(m0) + torch.tensor(jitter))
    err2, launches, ran = nuts_vg_check(
        "bench (8, 512) ARD se D=4", Xb, Yb, stack,
        lambda dev, dt: centered_normal_logprior(nuts_bench_model(dev, dt)))
    if (launches["stationary_nll_general"] != 1 or launches["stationary_nll_grad"] != 1
            or ran != {"tile": 0, "cluster": 1, "grad": 1}):
        raise AssertionError(f"a value+grad at (8, 512) launched {launches} ({ran}), not one "
                             "cluster kernel and one backward kernel")

    # (b) bench.py's workload: cold (seed 0, under the profiler) and warm (seed 1)
    with open(NUTS_GOLDENS) as fh:
        goldens = json.load(fh)
    runs = {}
    busy = device_busy(lambda: runs.update(cold=run_nuts_bench(0)), "nuts_profile.txt",
                       kernel="stationary_nll")
    runs["warm"] = run_nuts_bench(1)
    for label, q in runs.items():
        _report_nuts(label, q)
        launches, ev = q["launches"]["stationary_nll_general"], q["evals"]
        if launches != ev["vg"] + ev["logp"]:
            raise AssertionError(f"{label}: {launches} kernel launches for "
                                 f"{ev['vg'] + ev['logp']} evaluations")
        bad = compare_nuts(q, goldens)
        if bad:
            raise AssertionError(f"{label} NUTS posterior does not match the goldens: {bad}")
    warm = runs["warm"]
    print("  posterior MATCHes the JAX goldens, cold and warm: mean "
          + ", ".join(f"{x:.4f}" for x in warm["mean"]) + "; sd "
          + ", ".join(f"{x:.4f}" for x in warm["sd"]), flush=True)
    if busy["device_s"] > 0:
        leaves = runs["cold"]["evals"]["vg"] - 1
        print(f"  profiled cold run: {busy['wall_s']:.2f} s wall, device busy "
              f"{busy['device_s']:.3f} s ({100 * busy['device_s'] / busy['wall_s']:.1f}% of it), "
              f"the stationary kernel {busy['kernel_s']:.3f} s; per leaf: device "
              f"{1e3 * busy['device_s'] / leaves:.4f} ms (the kernel "
              f"{1e3 * busy['kernel_s'] / leaves:.4f}), host {1e3 * busy['wall_s'] / leaves:.4f} "
              "ms", flush=True)
    else:
        print("  profiled run: the profiler recorded no device events; device busy share not "
              "measured", flush=True)

    # (c) the frontier's NUTS on grid A
    with open(frontier_goldens_path("1y")) as fh:
        goldens64 = json.load(fh)
    with open(FRONTIER_NUTS_GOLDENS) as fh:
        fgoldens = json.load(fh)
    with tempfile.TemporaryDirectory() as root:
        make_frontier_market(root, *FRONTIER_GRIDS["1y"])
        fq = run_frontier_nuts(root, goldens64)
    nuts_batch = FRONTIER_NUTS["nuts_chains"] * FRONTIER_ASSETS
    print(f"phase 11 frontier 1y use_nuts f32 cold: {fq['seconds']:.2f} s, nuts_draws "
          f"{fq['nuts_draws']}, launches {json.dumps(fq['launches'])}, stationary kernel "
          f"launches by batch {json.dumps(fq['batches'])} ({nuts_batch}: the NUTS "
          "evaluations)", flush=True)
    if fq["nuts_draws"] != FRONTIER_NUTS["nuts_chains"] * FRONTIER_NUTS["nuts_samples"]:
        raise AssertionError(f"nuts_draws {fq['nuts_draws']}")
    if fq["batches"].get(nuts_batch, 0) < 1:
        raise AssertionError(f"no stationary kernel launch at batch {nuts_batch}")
    bad = compare_frontier_nuts(fq, fgoldens)
    if bad:
        raise AssertionError(f"frontier NUTS does not match the goldens: {bad}")
    dist, lim = frontier_nuts_distances(fq, fgoldens["runs"]), frontier_nuts_limits(fgoldens)
    print("  frontier NUTS MATCHes the JAX goldens: distance / limit " + ", ".join(
        f"{k} {dist[k]:.3f} / {lim[k]:.3f}" for k in dist) + " (tangency weights not gated)",
        flush=True)
    return dict(launches=warm["launches"]["stationary_nll_general"],
                frontier_launches=fq["batches"].get(nuts_batch, 0),
                max_abs_err=err2, max_abs_err_single=err, runs=runs)


# The CLI as `python -m portfoliooptgp_tpu_torch` runs it (runpy.run_module
# with run_name="__main__"), in a child process on the card: its launch
# counters start at 0 there and are read at its end, its calls of the two
# large-N tier functions are recorded with their shapes, and its CUDA
# activity is profiled for the device's busy share. The report goes to the
# JSON file named by argv[1]; argv[2:] are the command's arguments.
CLI_CHILD = r"""
import json, runpy, sys, time
import torch
from torch.profiler import ProfilerActivity, profile
from portfoliooptgp_tpu_torch.ops import blocked_nll, nll, stationary_nll, svgp_gram

out, sys.argv = sys.argv[1], ["portfoliooptgp_tpu_torch"] + sys.argv[2:]
tiers = []
for name in ("batched_nll_blocked", "batched_nll_hinv"):
    def spy(K, y, noise, real=getattr(blocked_nll, name), name=name):
        tiers.append([name, list(K.shape)])
        return real(K, y, noise)
    setattr(blocked_nll, name, spy)
code, t0 = 0, time.perf_counter()
try:
    with profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available()
                             else ProfilerActivity.CPU]) as prof:
        try:
            runpy.run_module("portfoliooptgp_tpu_torch", run_name="__main__", alter_sys=True)
        except SystemExit as e:
            code = e.code or 0
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
finally:
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
    launches = {**stationary_nll.LAUNCHES, **blocked_nll.LAUNCHES, **nll.LAUNCHES,
                **svgp_gram.LAUNCHES}
    with open(out, "w") as fh:
        json.dump(dict(code=code, wall_s=wall, launches=launches, tiers=tiers,
                       device_s=sum(by_name.values()) / 1e9,
                       panel_s=sum(t for n, t in by_name.items() if "blocked_panel" in n) / 1e9,
                       trinv_s=sum(t for n, t in by_name.items() if "trinv" in n) / 1e9), fh)
"""
# about 11× and 6× the largest distances seen on the card (1.7e-4 and 0.016),
# a tenth and a twentieth of compare_to_goldens' own 0.02 and 1.0 ...
CLI_LIMITS = {"cumulative_return": 2e-3, "sharpe_ratio": 0.1}
CLI_SPREAD = 4.0  # ... widened to this many times JAX's own float32 spread
CLI_TIMEOUT_S = 300


def run_cli(args, timeout=CLI_TIMEOUT_S):
    """(report, stdout) of one CLI command in a child process (CLI_CHILD);
    raises if it fails."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "report.json")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CLI_CHILD, out, *args], cwd=REPO,
                              capture_output=True, text=True, timeout=timeout)
        elapsed = time.perf_counter() - t0
        if proc.returncode != 0 or not os.path.exists(out):
            raise RuntimeError(f"CLI {args[0]} failed (exit {proc.returncode}):\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(out) as fh:
            report = json.load(fh)
    report["process_s"] = elapsed
    return report, proc.stdout


def read_metrics(path) -> dict:
    """{strategy: {metric: value}} of a `--metrics` JSONL file."""
    out = {}
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            out.setdefault(rec["strategy"], {})[rec["metric"]] = rec["value"]
    return out


def compare_cli(strategies, goldens, goldens32):
    """Failures of the `portfolio` command's strategies against the JAX
    CLI's float64 run: each metric within its CLI_LIMITS entry, or within
    CLI_SPREAD times JAX's own float32-to-float64 distance where that is
    larger. Returns (failures, {strategy.metric: (distance, limit)})."""
    bad, seen = [], {}
    for strat, g in goldens.items():
        for metric, limit in CLI_LIMITS.items():
            d = abs(strategies[strat][metric] - g[metric])
            lim = max(limit, CLI_SPREAD * abs(goldens32[strat][metric] - g[metric]))
            seen[f"{strat}.{metric}"] = (d, lim)
            if not d <= lim:
                bad.append(f"{strat}.{metric}: {strategies[strat][metric]:.6g} vs "
                           f"{g[metric]:.6g} (limit {lim:.3g})")
    return bad, seen


def parse_tail(stdout, label):
    """The array printed after `label` by the multi-input command."""
    import re

    m = re.search(re.escape(label) + r"\s*\[([^\]]*)\]", stdout)
    if m is None:
        raise AssertionError(f"no '{label}' line in the CLI's output")
    return np.array([float(x) for x in m.group(1).split()])


def compare_cli_means(f_mean, golden, golden32):
    """(distance, limit) of next-day means against the JAX CLI's float64
    ones, as fractions of their largest |value|: the limit is
    MI_FIT_MEAN_ATOL, or CLI_SPREAD times JAX's own float32 distance where
    that is larger."""
    g, g32 = np.asarray(golden), np.asarray(golden32)
    scale = np.max(np.abs(g))
    dist = float(np.max(np.abs(np.asarray(f_mean) - g)) / scale)
    return dist, max(MI_FIT_MEAN_ATOL, CLI_SPREAD * float(np.max(np.abs(g32 - g)) / scale))


def masked_walk_system(B, N, noise=1e-5, days=5, seed=0, device=DEVICE):
    """(B, N, N) float32 masked walk-forward systems, as
    pipelines/walk_forward.masked_system builds them: a product of two
    Matern12 kernels (a covariate walk and time) on N rows, B/days restarts
    of `days` days (day d keeps the first N − days + d rows), σ² = `noise`
    on the kept diagonal and identity rows and columns outside it."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(np.cumsum(rng.normal(size=N)) / np.sqrt(N), dtype=torch.float64)
    t = torch.linspace(-1.7, 1.7, N, dtype=torch.float64)
    K = (torch.exp(-torch.abs(x[:, None] - x[None, :]))
         * torch.exp(-torch.abs(t[:, None] - t[None, :]) / 0.5))
    keep = torch.arange(N)[None, :] < (N - days + torch.arange(days))[:, None]
    m = keep.repeat_interleave(B // days, dim=0).to(torch.float64)
    Ks = K * (m[:, :, None] * m[:, None, :]) + torch.diag_embed(m * noise + (1.0 - m))
    return Ks.to(device=device, dtype=torch.float32)


def check_walk_panel(B, N=768):
    """The panel kernel against its plain version at every panel height of
    masked walk-forward systems (B, N) with σ² = 1e-5: L within 3e-3 of max
    |L|, Σ log diag at rtol 3e-3 (tests/test_torch_cuda.py's panel
    tolerances). Returns the largest |L| difference."""
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn

    Ks = masked_walk_system(B, N)
    worst = 0.0
    for nt in range(N, 0, -128):
        panel = Ks[:, N - nt:, N - nt:N - nt + min(128, nt)]
        Lk, ldk = bn.factor_panel_cuda(panel)
        Lp, ldp = bn.factor_panel_plain(panel)
        scale = float(Lp.abs().max())
        err = float((Lk - Lp).abs().max())
        lerr = float(((ldk - ldp).abs() / ldp.abs()).max())
        if not (err <= 3e-3 * scale and lerr <= 3e-3):
            raise AssertionError(f"panel B={B} nt={nt} masked: L err {err:.3e} (max |L| "
                                 f"{scale:.3g}), logdet rel err {lerr:.3e}")
        worst = max(worst, err)
    print(f"check panel masked walk-forward B={B} N={N} sigma2=1e-5: max |dL| {worst:.3e} over "
          f"{len(range(N, 0, -128))} heights", flush=True)
    return worst


def check_walk_trinv(B, Np=1280):
    """The triangular-inverse kernel against its plain version on the
    factors of masked walk-forward systems (B, Np) with σ² = 1e-5, factored
    by linalg.cholesky as batched_nll_hinv factors them: B·Np/128 blocks,
    identity blocks and blocks across the mask's edge among them, held by
    check_trinv_equal. Returns the largest |W| difference."""
    from portfoliooptgp_tpu_torch.ops import linalg, nll

    L = linalg.cholesky(masked_walk_system(B, Np))
    Wk = nll.triangular_inverse_cuda(L)
    Wp = nll.triangular_inverse_plain(L)
    err = check_trinv_equal(f"trinv masked walk-forward B={B} Np={Np}", Wk, Wp)
    print(f"check trinv masked walk-forward B={B} Np={Np} sigma2=1e-5 ({B * Np // 128} "
          f"blocks): max |dW| {err:.3e} (max |W| {float(Wp.abs().max()):.3g})", flush=True)
    return err


def walk_panel_times(B=5, N=768):
    """The panel kernel on a masked walk-forward system at (B, N), at each
    panel height of the blocked factor, by graph replay, with its plain
    version at the same heights, torch.linalg.cholesky_ex of the whole
    system and the bounds, each summed over the panels."""
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn

    Ks = masked_walk_system(B, N, noise=1e-3)
    heights = list(range(N, 0, -128))

    def panel(nt):
        return Ks[:, N - nt:, N - nt:N - nt + min(128, nt)]

    with torch.no_grad():
        ms = {nt: graph_ms(lambda nt=nt: bn.factor_panel_cuda(panel(nt))) for nt in heights}
        plain = sum(graph_ms(lambda nt=nt: bn.factor_panel_plain(panel(nt))) for nt in heights)
        lib = graph_ms(lambda: torch.linalg.cholesky_ex(Ks))
        whole = graph_ms(lambda: bn.blocked_cholesky(Ks), reps=20)
    bound = sum(panel_bound_ms(nt, B)[0] for nt in heights)
    return dict(ms=sum(ms.values()), plain_ms=plain, library_ms=lib, bound_ms=bound,
                bound_by=panel_bound_ms(N, B)[1], by_height=ms, whole_ms=whole,
                first_ms=ms[N], first_bound_ms=panel_bound_ms(N, B)[0])


def walk_trinv_times(B=5, Np=1280):
    """The triangular-inverse kernel on the diagonal blocks of B factors of
    masked walk-forward systems at padded N = Np, by graph replay, with its
    plain version, solve_triangular(L_blocks, I) and its bound."""
    from portfoliooptgp_tpu_torch.ops import nll

    L = torch.linalg.cholesky(masked_walk_system(B, Np, noise=1e-3))
    P = Np // 128
    blocks = torch.stack([L[:, p * 128:(p + 1) * 128, p * 128:(p + 1) * 128] for p in range(P)],
                         dim=1).reshape(B * P, 128, 128).contiguous()
    eye = torch.eye(128, device=DEVICE).expand(B * P, 128, 128)
    with torch.no_grad():
        k = graph_ms(lambda: nll.triangular_inverse_cuda(L))
        plain = graph_ms(lambda: nll.triangular_inverse_plain(L), reps=5)
        lib = graph_ms(lambda: torch.linalg.solve_triangular(blocks, eye, upper=False))
    bound, bound_by = trinv_bound_ms(B * P)
    return dict(ms=k, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=bound_by,
                blocks=B * P)


CG_N = 2048
CG_VALUE_RTOL = 2e-3  # tools/smoke_tpu.py's CG checks
CG_CHECKS = {  # name → (num_probes, num_lanczos, precond_rank, gradient tolerance)
    "cg_slq": (128, 48, 0, 1e-1),
    "pcg_split_slq_rank256": (64, 8, 256, 2e-1),
}


def cg_problem(device=DEVICE, dtype=torch.float32):
    """tools/smoke_tpu.py's CG problem: N = 2048 day indices, SE with
    (variance, lengthscale, noise) = (1.3, 30.0, 0.1), Y ~ N(0, 1)."""
    x = torch.arange(CG_N, dtype=dtype, device=device)
    d2 = (x[:, None] - x[None, :]) ** 2
    Y = torch.tensor(np.random.default_rng(0).normal(size=(CG_N, 1)), dtype=dtype, device=device)
    return d2, Y, (1.3, 30.0, 0.1)


def cg_value_grad(check, d2, Y, p0, seed=7):
    """(value, gradient in (variance, lengthscale, noise), CG iterations) of
    nll_cg on smoke_tpu's problem, probes from a generator seeded `seed`;
    check None gives the dense torch.linalg NLL instead."""
    from portfoliooptgp_tpu_torch.ops import iterative

    p = [torch.tensor(v, dtype=Y.dtype, device=Y.device, requires_grad=True) for v in p0]
    K = p[0] * torch.exp(-0.5 * d2 / (p[1] * p[1]))
    iters = None
    if check is None:
        L = torch.linalg.cholesky(K + p[2] * torch.eye(CG_N, dtype=Y.dtype, device=Y.device))
        a = torch.linalg.solve_triangular(L, Y, upper=False)
        value = (0.5 * torch.sum(a * a) + torch.sum(torch.log(torch.diagonal(L)))
                 + 0.5 * CG_N * float(np.log(2 * np.pi)))
    else:
        probes, steps, rank, _ = CG_CHECKS[check]
        gen = torch.Generator(device=Y.device).manual_seed(seed)
        value, iters = iterative.nll_cg(K, Y, p[2], gen, probes, steps, 1e-6, rank,
                                        with_iters=True)
    grads = torch.autograd.grad(value, p)
    return float(value.detach()), np.array([float(g) for g in grads]), iters


def phase_cli():
    """Phase 12, the shell and the long windows: (a) the CLI's `portfolio`
    command on the three-year window (padded N = 768: the walk-forward's
    blocked tier, the panel kernel at B = 5) against the JAX CLI's goldens;
    (b) `multi-input --step 4` on the five-year window (padded N = 1280:
    the blocked_hinv tier, the triangular-inverse kernel); (c)
    tools/smoke_tpu.py's two CG checks at N = 2048 against the dense
    value+grad; (d) `print-config` and `--help` through `python -m`."""
    from benchmarks.bench_portfolio_e2e import ASSETS, FEATURES

    with open(cli_goldens_path()) as fh:
        g64 = json.load(fh)["runs"]
    with open(cli_goldens_path(True)) as fh:
        g32 = json.load(fh)["runs"]
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        make_long_market(root)
        for window in CLI_WINDOWS:
            with open(os.path.join(root, f"{window}.json"), "w") as fh:
                json.dump(cli_config(window), fh)
        common = ["--data-root", root, "--features", *FEATURES]

        # (a) portfolio, three-year window
        metrics = os.path.join(root, "metrics.jsonl")
        rep, _ = run_cli(["portfolio", "--config", os.path.join(root, "3y.json"),
                          "--assets", *ASSETS, *common, "--metrics", metrics])
        n = g64["3y"]["walks"][0]["n"]
        blocked = [s for name, s in rep["tiers"] if name == "batched_nll_blocked"]
        if (len(blocked) == 0 or any(s[0] != 5 for s in blocked)
                or any(name != "batched_nll_blocked" for name, _ in rep["tiers"])):
            raise AssertionError(f"portfolio 3y: tier calls {rep['tiers'][:5]}..., not the "
                                 "blocked tier at B = 5")
        if rep["launches"]["blocked_panel"] == 0:
            raise AssertionError("portfolio 3y: the panel kernel never launched")
        bad, seen = compare_cli(read_metrics(metrics), g64["3y"]["strategies"],
                                g32["3y"]["strategies"])
        print(f"phase 12a CLI portfolio 3y f32: {rep['process_s']:.2f} s (the command "
              f"{rep['wall_s']:.2f} s), N={n} (padded {n + (-n) % 128}), blocked tier calls "
              f"{len(blocked)} at {blocked[0]}, launches "
              f"{json.dumps({k: v for k, v in rep['launches'].items() if v})}; device busy "
              f"{rep['device_s']:.3f} s ({100 * rep['device_s'] / rep['wall_s']:.1f}%), the "
              f"panel kernel {rep['panel_s']:.4f} s", flush=True)
        print("  distance / limit: " + ", ".join(f"{k} {d:.4g} / {lim:.4g}"
                                                  for k, (d, lim) in seen.items()), flush=True)
        if bad:
            raise AssertionError(f"portfolio 3y does not match the JAX CLI: {bad}")
        out["3y"] = rep

        # (b) multi-input step 4, five-year window
        rep, stdout = run_cli(["multi-input", "--config", os.path.join(root, "5y.json"),
                               "--ticker", CLI_TICKER, "--step", "4", *common])
        n = g64["5y"]["walks"][0]["n"]
        hinv = [s for name, s in rep["tiers"] if name == "batched_nll_hinv"]
        if not hinv or any(name != "batched_nll_hinv" for name, _ in rep["tiers"]):
            raise AssertionError(f"multi-input 5y: tier calls {rep['tiers'][:5]}..., not the "
                                 "blocked_hinv tier")
        if rep["launches"]["triangular_inverse"] == 0:
            raise AssertionError("multi-input 5y: the triangular-inverse kernel never launched")
        f_mean = parse_tail(stdout, "f_mean tail:")
        dist, lim = compare_cli_means(f_mean, g64["5y"]["walks"][0]["f_mean_tail"],
                                      g32["5y"]["walks"][0]["f_mean_tail"])
        print(f"phase 12b CLI multi-input --step 4 5y f32: {rep['process_s']:.2f} s (the command "
              f"{rep['wall_s']:.2f} s), N={n} (padded {n + (-n) % 128}), blocked_hinv calls "
              f"{len(hinv)} at {hinv[0]}, launches "
              f"{json.dumps({k: v for k, v in rep['launches'].items() if v})}; device busy "
              f"{rep['device_s']:.3f} s ({100 * rep['device_s'] / rep['wall_s']:.1f}%), trinv "
              f"{rep['trinv_s']:.4f} s; next-day means {np.round(f_mean, 6).tolist()}, distance "
              f"{dist:.4g} of max |mean| (limit {lim:.4g})", flush=True)
        if not dist <= lim:
            raise AssertionError(f"multi-input 5y means do not match the JAX CLI: {dist} > {lim}")
        out["5y"] = rep

    # the two kernels on masked walk-forward systems: held against their
    # plain versions (σ² = 1e-5 beside the identity rows, B = 5 and 20),
    # then timed at the shapes of (a) and (b)
    out["panel_err"] = max(check_walk_panel(B) for B in (5, 20))
    out["trinv_err"] = max(check_walk_trinv(B) for B in (5, 20))
    out["panel"], out["trinv"] = walk_panel_times(), walk_trinv_times()
    pt, tt = out["panel"], out["trinv"]
    print(f"phase 12 panel kernel (5, 768) masked, 6 panels (graph replay): {pt['ms']:.4f} ms "
          f"(first panel {pt['first_ms']:.4f}, bound {pt['first_bound_ms']:.6f}), bounds summed "
          f"{pt['bound_ms']:.6f} ms ({pt['bound_by']}); plain, the 6 panels {pt['plain_ms']:.4f} "
          f"ms; torch.linalg.cholesky_ex (5, 768, 768) {pt['library_ms']:.4f} ms; the whole "
          f"blocked factor {pt['whole_ms']:.4f} ms; by height " + json.dumps(
              {nt: round(ms, 4) for nt, ms in pt["by_height"].items()}), flush=True)
    print(f"phase 12 trinv {tt['blocks']} blocks (B = 5, padded N = 1280; graph replay): "
          f"{tt['ms']:.4f} ms, plain {tt['plain_ms']:.4f} ms, solve_triangular(L_blocks, I) "
          f"{tt['library_ms']:.4f} ms, bound {tt['bound_ms']:.6f} ms ({tt['bound_by']})",
          flush=True)

    # (c) CG on the card: smoke_tpu's two checks against the dense value+grad
    d2, Y, p0 = cg_problem()
    vd, gd, _ = cg_value_grad(None, d2, Y, p0)
    out["cg"] = {}
    for check, (_, _, _, gtol) in CG_CHECKS.items():
        for _ in range(2):  # the first call warms the library kernels; the second is timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vc, gc, iters = cg_value_grad(check, d2, Y, p0)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        verr = abs(vc - vd) / abs(vd)
        gerr = float(np.max(np.abs(gc - gd) / np.maximum(np.abs(gd), 1.0)))
        print(f"phase 12c {check} N={CG_N} f32: value {vc:.6g} (dense {vd:.6g}, rel err "
              f"{verr:.3e}, limit {CG_VALUE_RTOL}), gradient {np.round(gc, 5).tolist()} (dense "
              f"{np.round(gd, 5).tolist()}, normalized err {gerr:.3e}, limit {gtol}); "
              f"{iters} CG iterations; {ms:.1f} ms for the value+grad (its second call)",
              flush=True)
        if not (np.isfinite(vc) and verr <= CG_VALUE_RTOL and gerr <= gtol):
            raise AssertionError(f"{check}: value err {verr}, gradient err {gerr}")
        out["cg"][check] = dict(iters=iters, value_err=verr, grad_err=gerr, ms=ms)

    # (d) the entry point resolves on the machine
    printed = {}
    for args in (["print-config"], ["--help"]):
        proc = subprocess.run([sys.executable, "-m", "portfoliooptgp_tpu_torch", *args],
                              cwd=REPO, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise AssertionError(f"python -m portfoliooptgp_tpu_torch {args[0]} failed: "
                                 f"{proc.stderr[-2000:]}")
        printed[args[0]] = proc.stdout
    if json.loads(printed["print-config"])["train"]["maxiter"] != 100 or not all(
            cmd in printed["--help"] for cmd in ("print-config", "single-asset", "multi-input",
                                                 "portfolio", "svgp", "frontier", "nuts")):
        raise AssertionError("print-config or --help does not print what the JAX CLI does")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 12d python -m portfoliooptgp_tpu_torch print-config and --help: exit 0; "
          f"phase 12 {out['seconds']:.1f} s", flush=True)
    return out


# Phase 13: parallel/ across ranks. Each world runs `parallel_rank` in
# spawned processes (parallel/distributed.spawn); this process joins no
# process group (phase 12's CLI children run beside it). World 1 is NCCL,
# the deployment's backend; world 2 puts both ranks on the one card, which
# NCCL cannot, so it asks for gloo by name (gloo's all-reduce, all-gather
# and broadcast take CUDA tensors).
PARALLEL_WORLDS = ((1, "nccl"), (2, "gloo"))
DIST_N, DIST_NB = 8192, 128  # sharded_gpr_nll's check: a well-conditioned K
PARALLEL_STEPS = 100  # timed sharded Adam steps on the first batch
PARALLEL_WALK = dict(n=77, n_train=72, n_days=5, restarts=(1e-3, 1e-1), maxiter=100)
# The trained walk-forward against the unsharded run: float32 per-row
# results on the card depend on the batch's row count (PyTorch's CUDA
# reductions and batched matmuls split their work by it), so L-BFGS
# trajectories part after the first gradient (on an H100, 7e-7 relative
# after one iteration and 3e-4 in the losses after 100). The means and
# variances are held at tests/test_torch_walk_forward.py's float32
# tolerance (rtol 2e-2, atol 2e-3), the losses at rtol 1e-3; the
# evaluation at the start (maxiter 0) is held bit for bit.
PARALLEL_WALK_LIMITS = dict(losses=(1e-3, 0.0), f_mean=(2e-2, 2e-3), f_var=(2e-2, 2e-3))
PARALLEL_NUTS = dict(num_chains=4, num_warmup=20, num_samples=20, max_depth=6)
PARALLEL_MC = dict(mu_a=[0.01, 0.012, 0.008], mu_b=[0.008, 0.009, 0.007], n=40_000,
                   atol=0.02)  # tests/test_parallel.py's MC tolerance


def _timed(fn, device):
    """(fn(), seconds), synchronized with `device` when it is a card."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _gathered_equal(x, mesh):
    """True when every rank of the data axis holds the same `x`."""
    from portfoliooptgp_tpu_torch.parallel.mesh import all_gather

    g = all_gather(x.detach().reshape(1, -1), mesh)
    return bool(torch.all(g == g[:1]))


def _parallel_elbo(mesh, world, goldens, goldens32, out):
    """(a) sharded_neg_elbo on bench.py's first batch against the one-device
    kernel route; at world 2, the trainer on the mesh against the goldens."""
    from portfoliooptgp_tpu_torch.models import svgp as svgp_mod
    from portfoliooptgp_tpu_torch.ops import svgp_gram as sg
    from portfoliooptgp_tpu_torch.parallel import elbo_sharded
    from portfoliooptgp_tpu_torch.parallel.mesh import shard_batch
    from portfoliooptgp_tpu_torch.params import ravel, tree_leaves, tree_replace
    from portfoliooptgp_tpu_torch.train import svgp_trainer
    from portfoliooptgp_tpu_torch.train.optim import Adam, make_step

    dev = mesh.device
    o = dict(device=dev, dtype=torch.float32)
    Xn, Yn, _ = svgp_problem()
    model0 = svgp_model(goldens32["leaves_start"], dev)
    Xb, Yb = torch.tensor(Xn[:SVGP_BATCH], **o), torch.tensor(Yn[:SVGP_BATCH], **o)
    wb = torch.ones((SVGP_BATCH,), **o)
    Xs, Ys, ws = shard_batch(mesh, Xb, Yb, wb)

    def value_grad(fn):
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(model0)]
        v = fn(tree_replace(model0, leaves))
        return v.detach().reshape(1), torch.autograd.grad(v, leaves)

    want = value_grad(lambda m: -svgp_mod.gaussian_elbo_gram_fused(
        m, Xb, Yb, weights=wb, num_data=SVGP_N, use_pallas=True))
    before = dict(sg.LAUNCHES)
    got = value_grad(lambda m: elbo_sharded.sharded_neg_elbo(m, Xs, Ys, ws, SVGP_N, mesh))
    launches = {k: sg.LAUNCHES[k] - before[k] for k in before}
    cuda = dev.type == "cuda"
    if launches != {"svgp_gram_fwd": int(cuda), "svgp_gram_bwd": int(cuda)}:
        raise AssertionError(f"a sharded value+grad launched {launches}, not one gram pair")
    out["elbo"] = dict(value_err=_check_values("sharded ELBO", got[0], want[0]),
                       grad_err=_check_grads("sharded ELBO", got[1], want[1]),
                       launches=launches, local_batch=int(Xs.shape[0]))

    step = make_step(lambda m, X, Y, w: elbo_sharded.sharded_neg_elbo(m, X, Y, w, SVGP_N, mesh),
                     Adam(1e-2))
    state = elbo_sharded.TrainState(model0, Adam(1e-2).init(model0))

    def steps(state, n):
        for _ in range(n):
            state, loss = step(state, Xs, Ys, ws)
        return state, loss

    state, _ = steps(state, 10)
    (_, loss), secs = _timed(lambda: steps(state, PARALLEL_STEPS), dev)
    if not torch.isfinite(loss):
        raise AssertionError("non-finite loss after the timed sharded steps")
    out["elbo"]["steps_per_s"] = PARALLEL_STEPS / secs

    if world > 1:
        _reset_launch_counts()
        res, secs = _timed(lambda: svgp_trainer.train_svgp_minibatched(
            model0, Xn, Yn, mesh=mesh, **SVGP_TRAIN), dev)
        launches = {k: v for k, v in _launch_counts().items() if k.startswith("svgp_gram")}
        q = svgp_route_quality("kernel", model0, res.model, res.iters, res.elbo, launches, secs,
                               goldens32, dev)
        bad = compare_svgp_route("kernel", q, dev.type, goldens, goldens32)
        if bad:
            raise AssertionError(f"the SVGP trained on the mesh does not match the goldens: {bad}")
        if not _gathered_equal(ravel(res.model), mesh):
            raise AssertionError("the ranks' models differ after the sharded training")
        out["train"] = dict(seconds=secs, iters=q["iters"], launches=launches,
                            elbo_final=q["elbo_final"],
                            distances=_route_distances("kernel", q, goldens32))


def dense_nll_value_grad(K, y, noise):
    """The GPR NLL of (K + σ²I, y) and its closed-form gradients (dK, dy,
    dσ²) through torch.linalg on K's device and dtype: the dense reference
    of `sharded_gpr_nll`."""
    n = K.shape[0]
    L = torch.linalg.cholesky(K + noise * torch.eye(n, dtype=K.dtype, device=K.device))
    a = torch.linalg.solve_triangular(L, y, upper=False)
    value = (0.5 * torch.sum(a * a) + torch.sum(torch.log(torch.diagonal(L)))
             + 0.5 * n * float(np.log(2 * np.pi)))
    W = torch.cholesky_inverse(L)
    alpha = W @ y
    return (value.reshape(1), 0.5 * (W - alpha @ alpha.T), alpha,
            (0.5 * (torch.trace(W) - torch.sum(alpha * alpha))).reshape(1))


def _parallel_dist_cholesky(mesh, world, refs, out):
    """(b) sharded_gpr_nll at N = DIST_N, both layouts, against the dense
    torch.linalg value+grad on the card and CPU float64 copies (computed at
    world 1; world 2 gets their value, dy and dσ² in `refs`)."""
    from portfoliooptgp_tpu_torch.parallel import dist_cholesky as dc

    N, nb, dev = DIST_N, DIST_NB, mesh.device
    g = torch.Generator(device=dev).manual_seed(5)
    A = torch.randn(N, N, generator=g, device=dev)
    K = A @ A.T / N + 0.5 * torch.eye(N, device=dev)
    y = torch.randn(N, 1, generator=g, device=dev)
    del A
    noise = 0.1
    dense = dense_nll_value_grad(K, y, noise)
    if world == 1:
        t0 = time.perf_counter()
        value, dK, dy, dnoise = dense_nll_value_grad(K.double().cpu(), y.double().cpu(), noise)
        out["cpu64_seconds"] = time.perf_counter() - t0
        refs = dict(value=value, dK=dK, dy=dy, dnoise=dnoise)
    out["dist"] = {}
    for layout in dc.LAYOUTS:
        def rows(x):
            return dc.shard_rows(x, mesh, nb, layout)

        Kl, yl = rows(K).requires_grad_(True), rows(y).requires_grad_(True)
        nz = torch.tensor(noise, device=dev, requires_grad=True)
        nll, fwd_s = _timed(lambda: dc.sharded_gpr_nll(Kl, yl, nz, mesh, nb, layout), dev)
        (dK, dy, dn), bwd_s = _timed(lambda: torch.autograd.grad(nll, (Kl, yl, nz)), dev)
        got = [nll.detach().reshape(1), dK, dy, dn.reshape(1)]
        name = f"sharded_gpr_nll {layout} world {world}"
        errs = dict(value=_check_values(name, got[0], dense[0]),
                    grads=_check_grads(name, got[1:], [rows(dense[1]), rows(dense[2]), dense[3]]))
        cpu = [x.detach().double().cpu() for x in got]
        errs["value64"] = _check_values(name + " vs CPU float64", cpu[0], refs["value"])
        pairs = [(cpu[2], rows(refs["dy"])), (cpu[3], refs["dnoise"])]
        if "dK" in refs:
            pairs.insert(0, (cpu[1], rows(refs["dK"])))
        errs["grads64"] = _check_grads(name + " vs CPU float64", *zip(*pairs))
        out["dist"][layout] = dict(forward_s=fwd_s, backward_s=bwd_s, **errs)
    return refs


def _parallel_walk(mesh, out):
    """(c) the restart-sharded walk-forward against the unsharded run."""
    from portfoliooptgp_tpu_torch import kernels as tk
    from portfoliooptgp_tpu_torch.models import gpr
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st
    from portfoliooptgp_tpu_torch.parallel.mesh import make_mesh
    from portfoliooptgp_tpu_torch.params import tree_leaves
    from portfoliooptgp_tpu_torch.pipelines import walk_forward as wf

    c = PARALLEL_WALK
    rng = np.random.default_rng(0)
    t = np.linspace(0, 8, c["n"])
    X = np.column_stack([np.sin(t) + 0.1 * rng.normal(size=c["n"]), t])
    Y = (np.sin(t) + 0.08 * rng.normal(size=c["n"]))[:, None]
    rmesh = make_mesh(data=1, restart=mesh.size, device=mesh.device)

    def run(m, maxiter=c["maxiter"]):
        return wf.batched_walk_forward(
            X, Y, c["n_train"], lambda v: gpr.GPR.create(tk.composite_kernel(2, device=mesh.device),
                                                          v),
            n_days=c["n_days"], restart_noise_inits=c["restarts"], maxiter=maxiter,
            mesh=m, device=mesh.device)

    start, whole_start = run(rmesh, 0), run(None, 0)
    for a, b in zip((start.losses, start.f_mean, start.f_var, *tree_leaves(start.models)),
                    (whole_start.losses, whole_start.f_mean, whole_start.f_var,
                     *tree_leaves(whole_start.models))):
        if not torch.equal(a, b):
            raise AssertionError("the restart-sharded walk-forward's start differs from the "
                                 "unsharded one")
    before = dict(st.LAUNCHES)
    sharded, secs = _timed(lambda: run(rmesh), mesh.device)
    launches = {k: st.LAUNCHES[k] - before[k] for k in before}
    whole = run(None)
    dist = {}
    for name, (rtol, atol) in PARALLEL_WALK_LIMITS.items():
        a, b = getattr(sharded, name), getattr(whole, name)
        dist[name] = float(torch.max(torch.abs(a - b) / (atol + rtol * torch.abs(b))))
        if not dist[name] <= 1.0:
            raise AssertionError(f"restart-sharded walk-forward {name} {a.tolist()} against "
                                 f"the unsharded {b.tolist()}")
    if mesh.device.type == "cuda" and launches["stationary_nll_general"] == 0:
        raise AssertionError("the restart-sharded walk-forward launched no stationary kernel")
    out["walk"] = dict(seconds=secs, launches=launches, rows=c["n_days"] * len(c["restarts"]),
                       rows_per_rank=c["n_days"] * len(c["restarts"]) // mesh.size,
                       distance=dist)


def _parallel_nuts(mesh, world, out):
    """(d) NUTS with the adaptation pooled over the data axis."""
    from portfoliooptgp_tpu_torch import kernels as tk
    from portfoliooptgp_tpu_torch.inference import (centered_normal_logprior,
                                                    gpr_logdensity_pair, gpr_logdensity_vg,
                                                    sample_nuts)
    from portfoliooptgp_tpu_torch.models import gpr
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st
    from portfoliooptgp_tpu_torch.parallel.mesh import DATA_AXIS, stream_seed
    from portfoliooptgp_tpu_torch.params import tree_leaves

    dev = mesh.device
    o = dict(device=dev, dtype=torch.float32)
    rng = np.random.default_rng(0)
    X = torch.tensor(np.sort(rng.uniform(0, 30, (128, 1)), axis=0), **o)
    Y = torch.tensor(rng.normal(size=(128, 1)), **o)
    m0 = gpr.GPR.create(tk.SquaredExponential.create(1.0, 5.0, **o), noise_variance=0.1)
    prior = centered_normal_logprior(m0)
    logp, _ = gpr_logdensity_pair(X, Y, prior)
    vg = gpr_logdensity_vg(X, Y, prior)
    seed = stream_seed(0, mesh.index(DATA_AXIS))

    def run(**kw):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return sample_nuts(logp, m0, gen, vg_fn=vg, device=dev, **PARALLEL_NUTS, **kw)

    before = dict(st.LAUNCHES)
    (samples, stats), secs = _timed(lambda: run(axis_name=DATA_AXIS, mesh=mesh), dev)
    launches = {k: st.LAUNCHES[k] - before[k] for k in before}
    draws = torch.cat([x.reshape(x.shape[0], x.shape[1], -1) for x in tree_leaves(samples)], -1)
    if not torch.all(torch.isfinite(draws)):
        raise AssertionError("cross-rank NUTS drew non-finite values")
    if not (_gathered_equal(stats.step_size, mesh) and _gathered_equal(stats.inv_mass, mesh)):
        raise AssertionError("the ranks adapted different step sizes or metrics")
    if world == 1:
        alone, _ = run()
        if not all(torch.equal(a, b) for a, b in zip(tree_leaves(samples), tree_leaves(alone))):
            raise AssertionError("NUTS on a one-rank mesh drew other numbers than without one")
    out["nuts"] = dict(seconds=secs, launches=launches,
                       draws_per_s=PARALLEL_NUTS["num_chains"] * (
                           PARALLEL_NUTS["num_warmup"] + PARALLEL_NUTS["num_samples"]) / secs,
                       step_size=float(stats.step_size[0]),
                       mean_accept=float(stats.accept_prob.mean()))


def _parallel_mc(mesh, out):
    """(e) the sharded MC estimate against the one-device estimate."""
    from portfoliooptgp_tpu_torch.portfolio import montecarlo as mc

    c = PARALLEL_MC
    cov = 1e-4 * (0.5 * np.eye(3) + 0.5)
    p1 = mc.probability_a_greater_than_b_mvnorm(c["mu_a"], cov, c["mu_b"], cov, c["n"],
                                                device=mesh.device)
    p2 = mc.probability_a_greater_than_b_mvnorm_sharded(c["mu_a"], cov, c["mu_b"], cov, mesh,
                                                        c["n"])
    if not (abs(p1 - p2) < c["atol"] and 0.0 < p2 < 1.0):
        raise AssertionError(f"sharded MC {p2} vs one-device {p1}")
    out["mc"] = dict(one_device=p1, sharded=p2)


def parallel_rank(rank, world, out_dir, refs, device="cuda"):
    """Phase 13's checks on one rank (a world of `world` ranks) on `device`
    ("cpu" for a rehearsal)."""
    from portfoliooptgp_tpu_torch.parallel import dryrun
    from portfoliooptgp_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device=device)
    with open(svgp_goldens_path()) as fh:
        goldens = json.load(fh)
    with open(svgp_goldens_path(True)) as fh:
        goldens32 = json.load(fh)
    out = dict(device=str(mesh.device), backend=torch.distributed.get_backend())
    t0 = time.perf_counter()
    _parallel_elbo(mesh, world, goldens, goldens32, out)
    out["seconds_elbo"] = time.perf_counter() - t0
    refs = _parallel_dist_cholesky(mesh, world, refs, out)
    if world > 1:
        _parallel_walk(mesh, out)
    _parallel_nuts(mesh, world, out)
    if world > 1:
        _parallel_mc(mesh, out)
    t1 = time.perf_counter()
    out["dryrun"] = dryrun.checks(rank, world, device=device)
    out["dryrun"]["seconds"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    torch.save(dict(out=out, refs={k: v for k, v in refs.items() if k != "dK"}),
               os.path.join(out_dir, f"rank{rank}.pt"))


def phase_parallel():
    """Phase 13, parallel/ across ranks (`parallel_rank` in spawned
    processes, world 1 on NCCL and world 2 on gloo with both ranks on the
    card): (a) `sharded_neg_elbo` on bench.py's first batch (2048 rows, a
    rank's share) against the one-device `gaussian_elbo_gram_fused(
    use_pallas=True)` at phase 10's tolerances, one gram kernel pair per
    rank and value+grad, sharded Adam steps per second; at world 2 the
    trainer on the mesh (60 steps) against the goldens (`compare_svgp_route`,
    route (ii)) with the ranks' models equal; (b) `sharded_gpr_nll` at N =
    8192, block 128, both layouts, against the dense torch.linalg value+grad
    on the card and CPU float64 copies, forward and backward seconds; (c) at
    world 2 the restart-sharded walk-forward (5 days × 2 restarts, N = 77,
    the tile kernel) against the unsharded run (PARALLEL_WALK_LIMITS; its
    start bit for bit); (d) NUTS, 4 chains a rank,
    20 + 20 transitions on smoke_tpu's C = 8, N = 128 posterior shape, the
    ranks' adapted step size and metric equal, and at world 1 the draws of
    the run without a mesh; (e) at world 2 the sharded MC estimate within
    MC error of the one-device one; then `dryrun_multichip`'s six checks
    (parallel/dryrun.checks) as the ranks' code, on NCCL at world 1 and on
    gloo at world 2."""
    from portfoliooptgp_tpu_torch.parallel.distributed import spawn

    t0 = time.perf_counter()
    results, refs = {}, {}
    for world, backend in PARALLEL_WORLDS:
        out_dir = tempfile.mkdtemp(prefix="phase13-")
        t1 = time.perf_counter()
        spawn(parallel_rank, world, out_dir, refs, device="cuda", backend=backend,
              timeout_s=300)
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
        refs = ranks[0]["refs"]
        results[world] = [r["out"] for r in ranks]
        print(f"phase 13 world {world} ({backend}): {time.perf_counter() - t1:.2f} s", flush=True)
        for r, o in enumerate(results[world]):
            e = o["elbo"]
            print(f"  rank {r} on {o['device']} ({o['backend']}): sharded ELBO value rel err "
                  f"{e['value_err']:.3e}, grad normalized err {e['grad_err']:.3e} against the "
                  f"one-device kernel route; gram launches per value+grad {e['launches']}; "
                  f"{e['steps_per_s']:.2f} sharded Adam steps/s at local batch "
                  f"{e['local_batch']}", flush=True)
            for layout, d in o["dist"].items():
                print(f"  rank {r} sharded_gpr_nll N={DIST_N} nb={DIST_NB} {layout}: forward "
                      f"{d['forward_s']:.3f} s, backward {d['backward_s']:.3f} s; value rel err "
                      f"{d['value']:.3e} (card f32 dense), {d['value64']:.3e} (CPU f64); grads "
                      f"{d['grads']:.3e}, {d['grads64']:.3e}", flush=True)
            if "train" in o:
                t = o["train"]
                print(f"  rank {r} trainer on the mesh: {t['iters']} steps in "
                      f"{t['seconds']:.2f} s, launches {t['launches']}, ELBO "
                      f"{t['elbo_final']:.6g}; goldens MATCH", flush=True)
            if "walk" in o:
                w = o["walk"]
                print(f"  rank {r} restart-sharded walk-forward: {w['rows_per_rank']} of "
                      f"{w['rows']} rows, {w['seconds']:.2f} s, launches {w['launches']}; the "
                      "start equals the unsharded run's bit for bit, the trained rows at "
                      "|err| / limit " + ", ".join(f"{k} {v:.3g}" for k, v in
                                                  w["distance"].items()), flush=True)
            n = o["nuts"]
            print(f"  rank {r} NUTS: {n['seconds']:.2f} s, {n['draws_per_s']:.1f} draws/s, "
                  f"launches {n['launches']}, step size {n['step_size']:.4g}, accept "
                  f"{n['mean_accept']:.3f}", flush=True)
            if "mc" in o:
                print(f"  rank {r} sharded MC {o['mc']['sharded']:.4f} vs one-device "
                      f"{o['mc']['one_device']:.4f}", flush=True)
            d = o["dryrun"]
            print(f"  rank {r} dryrun_multichip checks on {backend}: mesh {d['mesh']}, ELBO "
                  f"step loss {d['elbo_step_loss']:.4f}, dist_chol NLL "
                  f"{d['dist_chol_nll']:.4f}, NUTS accept {d['mean_accept']:.2f}, "
                  f"{d['seconds']:.2f} s", flush=True)
        if world == 1:
            print(f"  CPU float64 dense reference: {results[1][0]['cpu64_seconds']:.2f} s",
                  flush=True)
    seconds = time.perf_counter() - t0
    print(f"phase 13 parallel: {seconds:.2f} s", flush=True)
    return dict(results=results, seconds=seconds)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() != 1:
        # Every phase runs on device 0, so the result line may claim one card only.
        print(f"chip_smoke: {torch.cuda.device_count()} CUDA devices visible; run it on one "
              "(CUDA_VISIBLE_DEVICES=0)", file=sys.stderr)
        return 1
    import portfoliooptgp_tpu_torch  # noqa: F401  (fails outside the repository)

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    phase_build()
    errs = phase_checks()
    errs["stationary_nll_general"] = max(errs["stationary_nll_general"],
                                         phase_stationary_edges())
    head = phase_headline()
    for name, err in head["errs"].items():
        errs[name] = max(errs.get(name, 0.0), err)
    e2e = phase_end_to_end()
    errs["blocked_panel"] = phase_blocked_checks()
    sa = phase_single_asset()
    hinv = phase_hinv_checks()
    front = phase_frontier()
    dense = phase_dense()
    mi = phase_multi_input()
    gram = phase_svgp_checks()
    svgp = phase_svgp()
    nuts = phase_nuts()
    cli = phase_cli()
    par = phase_parallel()
    errs["blocked_panel"] = max(errs["blocked_panel"], cli["panel_err"])
    errs["stationary_nll_general"] = max(errs["stationary_nll_general"], nuts["max_abs_err"])
    errs["stationary_nll"] = max(errs["stationary_nll"], nuts["max_abs_err_single"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    src = "portfoliooptgp_tpu_torch/csrc/stationary_nll.cu"
    kernels = [
        dict(name="stationary_nll_general", route="cuda", source=src,
             replaces="portfoliooptgp_tpu/ops/pallas/stationary_nll.py:343",
             launches=e2e["launches"], max_abs_err=errs["stationary_nll_general"],
             **stationary_entry(e2e["row"], "inv"),
             value_only=stationary_entry(e2e["row"], "value"),
             at_128x256=stationary_entry(head["rows"]["headline"], "inv"),
             at_5x480=stationary_entry(head["rows"]["two-year walk-forward"], "inv"),
             at_8x512=stationary_entry(head["rows"]["NUTS bench"], "inv"),
             launches_nuts_bench=nuts["launches"]),
        dict(name="stationary_nll", route="cuda", source=src,
             replaces="portfoliooptgp_tpu/ops/pallas/stationary_nll.py:197",
             launches=head["launches"], max_abs_err=errs["stationary_nll"],
             **stationary_entry(head["rows"]["headline"], "inv"),
             value_only=stationary_entry(head["rows"]["headline"], "value"),
             at_5x77=stationary_entry(e2e["row"], "inv"),
             headline_value_grad_ms=head["value_grad_ms"],
             headline_value_grad_device_ms=head["value_grad_device_ms"],
             **{f"at_{B}x{N}": stationary_entry(head["rows"][label], "inv")
                for label, (_, _, B, N, _) in STATIONARY_TIMED.items()
                if label in ("weekly menu", "monthly menu", "frontier grid A", "frontier NUTS")},
             launches_frontier_nuts=nuts["frontier_launches"]),
        dict(name="stationary_nll_grad", route="cuda", source=src,
             replaces="portfoliooptgp_tpu/ops/pallas/stationary_nll.py:509",
             launches=e2e["grad_launches"], max_abs_err=errs["stationary_nll_grad"],
             **grad_entry(head["grad_rows"]["walk-forward"]),
             **{f"at_{B}x{N}": grad_entry(head["grad_rows"][label])
                for label, (_, _, _, B, N, _) in GRAD_TIMED.items() if label != "walk-forward"}),
        dict(name="blocked_panel", route="cuda",
             source="portfoliooptgp_tpu_torch/csrc/blocked_panel.cu",
             replaces="portfoliooptgp_tpu/ops/pallas/blocked_nll.py:70",
             launches=sa["launches"], max_abs_err=errs["blocked_panel"],
             ms=sa["ms"], plain_ms=sa["plain_ms"], bound_ms=sa["bound_ms"],
             bound_by=sa["bound_by"], library_ms=sa["library_ms"], eager_ms=sa["eager_ms"],
             launches_cli_3y=cli["3y"]["launches"]["blocked_panel"],
             at_5x768={k: cli["panel"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms")}),
        dict(name="triangular_inverse", route="cuda",
             source="portfoliooptgp_tpu_torch/csrc/trinv.cu",
             replaces="portfoliooptgp_tpu/ops/pallas/nll.py:357",
             launches=front["launches"], max_abs_err=max(hinv["max_abs_err"], cli["trinv_err"]),
             ms=hinv["ms"], plain_ms=hinv["plain_ms"], bound_ms=hinv["bound_ms"],
             bound_by=hinv["bound_by"], library_ms=hinv["library_ms"], eager_ms=hinv["eager_ms"],
             launches_cli_5y=cli["5y"]["launches"]["triangular_inverse"],
             at_50_blocks={k: cli["trinv"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                       "bound_by", "library_ms")}),
    ]
    for name, with_w, line in (("dense_nll", False, 135), ("dense_nll_inv", True, 151)):
        tag = "inv" if with_w else "value"
        at = {shape: dict(ms=row[f"ms_{tag}"], eager_ms=row[f"eager_ms_{tag}"],
                          plain_ms=row[f"plain_ms_{tag}"], library_ms=row[f"library_ms_{tag}"],
                          bound_ms=row[f"bound_{tag}"][0], bound_by=row[f"bound_{tag}"][1])
              for shape, row in dense["times"].items()}
        kernels.append(dict(
            name=name, route="cuda", source="portfoliooptgp_tpu_torch/csrc/dense_nll.cu",
            replaces=f"portfoliooptgp_tpu/ops/pallas/nll.py:{line}",
            launches=mi["launches"][name], max_abs_err=dense["max_abs_err"][with_w],
            **at[(20, 77)], at_128x256=at[(128, 256)], at_5x200=at[(5, 200)],
            launches_white_route={f"{B}x{N}": w["launches"][name]
                                  for (B, N), w in dense["white"].items()}))
    for name, tag, line in (("svgp_gram_fwd", "fwd", 77), ("svgp_gram_bwd", "bwd", 94)):
        tm = gram["times"]
        kernels.append(dict(
            name=name, route="cuda", source="portfoliooptgp_tpu_torch/csrc/svgp_gram.cu",
            replaces=f"portfoliooptgp_tpu/ops/pallas/svgp_gram.py:{line}",
            launches=svgp["launches"][name], max_abs_err=gram["max_abs_err"][tag],
            **gram_entry(tm[(SVGP_M, SVGP_BATCH)], tag),
            at_128x8192=gram_entry(tm[(128, 8192)], tag),
            launches_sharded_value_grad={f"world{w}": [o["elbo"]["launches"][name] for o in rs]
                                         for w, rs in par["results"].items()},
            launches_sharded_trainer=[o["train"]["launches"][name]
                                      for o in par["results"][2]]))
    kernels[0]["launches_sharded_walk_forward"] = [
        o["walk"]["launches"]["stationary_nll_general"] for o in par["results"][2]]
    kernels[1]["launches_sharded_nuts"] = {
        f"world{w}": [o["nuts"]["launches"]["stationary_nll"] for o in rs]
        for w, rs in par["results"].items()}
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
