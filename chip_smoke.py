#!/usr/bin/env python3
"""On-chip smoke run of the PyTorch/CUDA port (portfoliooptgp_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every CUDA source of the port with nvcc (in parallel);
  2. hold the stationary NLL kernel against its plain PyTorch version on
     the card in float32 — values (rtol 3e-3) and gradients of err, v, ℓ,
     α, noise and the d2 matrices (normalized atol 2e-2), the tolerances of
     the matching checks in tools/smoke_tpu.py — for the 7 families, prod
     and sum, an ARD atom, a partial mask, the walk-forward shape and the
     headline shape;
  3. headline: value+grad of `batched_neg_log_marginal_likelihood` at
     B=128 SE models, N=256, float32, through the `fused_stationary` tier;
     times of the kernel, its plain version and a torch.linalg yardstick;
  4. end to end: the 5-asset portfolio workflow (walk-forward GP fit,
     ARIMA, correlations, 5 strategies, backtest) on the card in float32,
     cold then warm, checked against tests/goldens/portfolio_e2e_goldens.json;
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
     panel height of the path.
Then it prints the card's name and power limit, one JSON line describing
every kernel, and the last line {"ok": true, "device": {...}}.

It exits non-zero without printing a result when no CUDA device is
present, or when the port's package is not beside it.
"""

from __future__ import annotations

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
                 timings=None):
    """The port's twin of benchmarks/bench_portfolio_e2e.run_workflow:
    5 assets × walk-forward step 4, ARIMA(3,1,0), cross-asset
    correlations, then every strategy evaluated per day and backtested.
    Returns (elapsed_s, quality dict in compare_to_goldens' format); a
    `timings` dict receives the seconds of the step-4 and portfolio stages."""
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
                           isFixedLikelihood=True, device=device, dtype=dtype, **DATES)
        p = mi.run_step_4()
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
    """Random float32 operands for the general NLL on `device`: per-dim
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

    def t(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=DEVICE)

    return ([t(d) for d in d2s], t(err), [t(v) for v in vs], [t(l) for l in ls],
            [t(a) for a in als], t(noise), t(mask))


def check_general(name, families, dims, combine, B, N, masked, seed):
    """Kernel vs plain, values and gradients of every operand."""
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    d2s, err, vs, ls, als, noise, mask = general_operands(families, dims, B, N, masked, seed)
    fns = {"prod": (st.batched_nll_stationary_general, st.batched_nll_stationary_general_plain),
           "sum": (st.batched_nll_stationary_sum, st.batched_nll_stationary_sum_plain)}[combine]
    outs = []
    for fn in fns:
        leaves = [x.clone().requires_grad_(True) for x in [err, noise] + vs + ls + als + d2s]
        e, nz = leaves[:2]
        J, JD = len(vs), len(d2s)
        v, l, a, d = (leaves[2:2 + J], leaves[2 + J:2 + J + JD],
                      leaves[2 + J + JD:2 + 2 * J + JD], leaves[2 + 2 * J + JD:])
        nll = fn(families, d, e, v, l, a, nz, mask, dims=dims)
        outs.append((nll.detach(), torch.autograd.grad(nll.sum(), leaves)))
    torch.cuda.synchronize()
    verr = _check_values(name, outs[0][0], outs[1][0])
    gerr = _check_grads(name, outs[0][1], outs[1][1])
    print(f"check {name}: B={B} N={N} value rel err {verr:.3e}, "
          f"grad normalized err {gerr:.3e}", flush=True)
    return _max_err(outs[0][0], outs[1][0])


def check_single(name, family, B, N, seed):
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    d2s, err, vs, ls, _, noise, _ = general_operands((family,), (1,), B, N, False, seed)
    outs = []
    for fn in (st.batched_nll_stationary, st.batched_nll_stationary_plain):
        args = [x.clone().requires_grad_(True) for x in (d2s[0], err, vs[0], ls[0], noise)]
        nll = fn(*args, family)
        outs.append((nll.detach(), torch.autograd.grad(nll.sum(), args)))
    torch.cuda.synchronize()
    verr = _check_values(name, outs[0][0], outs[1][0])
    gerr = _check_grads(name, outs[0][1], outs[1][1])
    print(f"check {name}: B={B} N={N} value rel err {verr:.3e}, "
          f"grad normalized err {gerr:.3e}", flush=True)
    return _max_err(outs[0][0], outs[1][0])


def time_forward(families, dims, B, N, masked, seed, counter, with_inverse=True):
    """(kernel ms, plain ms, torch.linalg yardstick ms) of the forward at
    one shape, with W when `with_inverse` (as the value+grad step runs it)."""
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    d2s, err, vs, ls, als, noise, mask = general_operands(families, dims, B, N, masked, seed)
    combine = "prod"
    D2, V, S, A = (torch.stack(d2s), torch.stack(vs), 1.0 / torch.stack(ls) ** 2,
                   torch.stack(als))
    m = mask if masked else None
    args = (families, combine, dims, D2, err, V, S, A, noise, m, with_inverse)
    eye = torch.eye(N, device=DEVICE)

    def library():
        K = st.build_general_plain(families, combine, dims, D2, V, S, A, noise, m)
        L = torch.linalg.cholesky(K)
        rhs = torch.cat([err[:, :, None], eye.expand(B, N, N)], dim=-1)
        return torch.linalg.solve_triangular(L, rhs, upper=False)

    with torch.no_grad():
        k = cuda_ms(lambda: st.stationary_nll_forward_cuda(*args, counter))
        p = cuda_ms(lambda: st.stationary_nll_forward_plain(*args))
        lib = cuda_ms(library)
    return k, p, lib


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


# -- phases -----------------------------------------------------------------

def phase_build():
    from portfoliooptgp_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    per_source = cuda_build.build(verbose=True)
    elapsed = time.perf_counter() - t0
    print(f"phase 1 build: {elapsed:.2f} s "
          + json.dumps({k: round(v, 2) for k, v in per_source.items()}), flush=True)


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
    nll, grads = value_and_grad()
    torch.cuda.synchronize()
    launches = st.LAUNCHES["stationary_nll"]
    if launches < 1:
        raise AssertionError("the headline value+grad launched no stationary_nll kernel")
    if not (torch.all(torch.isfinite(nll)) and all(torch.all(torch.isfinite(g)) for g in grads)):
        raise AssertionError("non-finite headline value or gradient")
    vg_ms = cuda_ms(value_and_grad, reps=10)
    k, p, lib = time_forward(("se",), (1,), 128, 256, False, 31, "stationary_nll")
    kv, pv, _ = time_forward(("se",), (1,), 128, 256, False, 31, "stationary_nll",
                             with_inverse=False)
    bound, bound_by = nll_bound_ms(128, 256, 1, 1, False, True)
    print(f"phase 3 headline B=128 N=256 se f32: tier {tier}, launches {launches}, "
          f"value+grad {vg_ms:.4f} ms ({1e3 / vg_ms * 128:.1f} evals/s)", flush=True)
    print(f"  kernel with W {k:.4f} ms, plain with W {p:.4f} ms, torch.linalg yardstick "
          f"{lib:.4f} ms; kernel value only {kv:.4f} ms, plain value only {pv:.4f} ms; "
          f"bound {bound:.4f} ms ({bound_by})", flush=True)
    return dict(launches=launches, ms=k, plain_ms=p, library_ms=lib, bound_ms=bound,
                bound_by=bound_by, value_grad_ms=vg_ms)


def phase_end_to_end():
    from benchmarks.bench_portfolio_e2e import GOLDENS_PATH, compare_to_goldens, make_market
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    with open(GOLDENS_PATH) as fh:
        goldens = json.load(fh)
    with tempfile.TemporaryDirectory() as root:
        make_market(root)
        for k in st.LAUNCHES:
            st.LAUNCHES[k] = 0
        cold, quality = run_workflow(root, DEVICE)
        launches = st.LAUNCHES["stationary_nll_general"]
        stages = {}
        warm, quality_warm = run_workflow(root, DEVICE, timings=stages)
        busy = device_busy(lambda: run_workflow(root, DEVICE), "e2e_profile.txt")
    if launches < 1:
        raise AssertionError("the end-to-end run launched no stationary_nll_general kernel")
    results = []
    for label, q in (("cold", quality), ("warm", quality_warm)):
        ok, worst = compare_to_goldens(q, goldens)
        results.append(worst)
        if not ok:
            raise AssertionError(f"{label} run does not match the goldens: {worst}")
    print(f"phase 4 end to end f32: cold {cold:.2f} s, warm {warm:.2f} s (step 4 "
          f"{stages['step4_s']:.2f} s, portfolio {stages['portfolio_s']:.2f} s), kernel "
          f"launches {launches}; goldens MATCH (worst {results[0]['metric']}: "
          f"{results[0]['diff']:.4g})", flush=True)
    if busy["device_s"] > 0:
        print(f"  profiled warm pass: {busy['wall_s']:.2f} s wall, device busy "
              f"{busy['device_s']:.3f} s ({100 * busy['device_s'] / warm:.1f}% of the "
              f"unprofiled warm pass), stationary_nll kernel {busy['kernel_s']:.3f} s",
              flush=True)
    else:
        print("  profiled warm pass: the profiler recorded no device events; device busy "
              "share not measured", flush=True)
    print(json.dumps(quality, sort_keys=True), flush=True)
    k, p, lib = time_forward(("matern12", "matern12"), (1, 1), 5, 77, True, 24,
                             "stationary_nll_general")
    bound, bound_by = nll_bound_ms(5, 77, 2, 2, True, True)
    print(f"  walk-forward shape B=5 N=77 J=2: kernel with W {k:.4f} ms, plain {p:.4f} ms, "
          f"torch.linalg yardstick {lib:.4f} ms, bound {bound:.6f} ms ({bound_by})", flush=True)
    return dict(launches=launches, ms=k, plain_ms=p, library_ms=lib, bound_ms=bound,
                bound_by=bound_by)


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


def _spd(B, N, seed):
    """(B, N, N) float32 SPD matrices on the card: AAᵀ/N + ½I from a seed."""
    rng = np.random.default_rng(seed)
    A = torch.tensor(rng.normal(size=(B, N, N)), dtype=torch.float64, device=DEVICE)
    return (A @ A.mT / N + 0.5 * torch.eye(N, dtype=torch.float64, device=DEVICE)).float()


PANEL_HEIGHTS = (875, 747, 619, 491, 363, 235, 107)  # the 7 panels of N = 875


def phase_blocked_checks():
    """The panel kernel against factor_panel_plain at every panel height of
    the N = 875 path (as strided views of the trailing matrix, B ∈ {1, 8}):
    the L panel within 3e-3 of max |L| and Σ log diag within rtol 3e-3; then
    batched_nll_blocked on the card (the kernel) against the same call on
    CPU copies of the float32 inputs (the plain panel factor), values (rtol
    3e-3) and gradients of K, y and noise (normalized 2e-2) at N = 875 and
    at the JAX package's padded N = 896. Returns the largest |Δ| of L and
    NLLs."""
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
    panel height of N = 875, and at nt = 875 beside its plain version, its
    bound and torch.linalg.cholesky on the same matrix."""
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
        cold, q = run_single_asset(root, DEVICE)
        launches = bn.LAUNCHES["blocked_panel"]
        fused = st.LAUNCHES["stationary_nll"] + st.LAUNCHES["stationary_nll_general"]
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
          f"blocked_panel launches {launches}, stationary NLL launches {fused}", flush=True)
    if busy["device_s"] > 0:
        print(f"  profiled warm pass: {busy['wall_s']:.2f} s wall, device busy "
              f"{busy['device_s']:.3f} s ({100 * busy['device_s'] / warm:.1f}% of the "
              f"unprofiled warm pass), blocked_panel kernel {busy['kernel_s']:.3f} s",
              flush=True)
    else:
        print("  profiled warm pass: the profiler recorded no device events; device busy "
              "share not measured", flush=True)

    Ks = _spd(1, 875, 875)
    with torch.no_grad():
        per_height = {nt: cuda_ms(lambda nt=nt: bn.factor_panel_cuda(
            Ks[:, 875 - nt:, 875 - nt:875 - nt + min(128, nt)]), reps=50)
            for nt in PANEL_HEIGHTS}
        p = cuda_ms(lambda: bn.factor_panel_plain(Ks[:, :, :128]), reps=50)
        lib = cuda_ms(lambda: torch.linalg.cholesky(Ks), reps=50)
        whole = cuda_ms(lambda: bn.blocked_cholesky(Ks), reps=20)
    k = per_height[875]
    bound, bound_by = panel_bound_ms(875)
    total_bound = sum(panel_bound_ms(nt)[0] for nt in PANEL_HEIGHTS)
    print(f"  panel nt=875 B=1: kernel {k:.4f} ms, plain {p:.4f} ms, bound {bound:.6f} ms "
          f"({bound_by}); torch.linalg.cholesky (1, 875, 875) {lib:.4f} ms; the whole "
          f"blocked factor (7 panels + trailing matmuls) {whole:.4f} ms, kernel summed over "
          f"the 7 panel heights {sum(per_height.values()):.4f} ms, panel bounds summed "
          f"{total_bound:.6f} ms", flush=True)
    print("  kernel ms by panel height: " + json.dumps(
        {nt: round(ms, 4) for nt, ms in per_height.items()}), flush=True)
    return dict(launches=launches, ms=k, plain_ms=p, library_ms=lib, bound_ms=bound,
                bound_by=bound_by, cold_s=cold, warm_s=warm)


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
    head = phase_headline()
    e2e = phase_end_to_end()
    errs["blocked_panel"] = phase_blocked_checks()
    sa = phase_single_asset()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    src = "portfoliooptgp_tpu_torch/csrc/stationary_nll.cu"
    kernels = [
        dict(name="stationary_nll_general", route="cuda", source=src,
             replaces="portfoliooptgp_tpu/ops/pallas/stationary_nll.py:343",
             launches=e2e["launches"], max_abs_err=errs["stationary_nll_general"],
             ms=e2e["ms"], plain_ms=e2e["plain_ms"], bound_ms=e2e["bound_ms"],
             bound_by=e2e["bound_by"], library_ms=e2e["library_ms"]),
        dict(name="stationary_nll", route="cuda", source=src,
             replaces="portfoliooptgp_tpu/ops/pallas/stationary_nll.py:197",
             launches=head["launches"], max_abs_err=errs["stationary_nll"],
             ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
             bound_by=head["bound_by"], library_ms=head["library_ms"]),
        dict(name="blocked_panel", route="cuda",
             source="portfoliooptgp_tpu_torch/csrc/blocked_panel.cu",
             replaces="portfoliooptgp_tpu/ops/pallas/blocked_nll.py:70",
             launches=sa["launches"], max_abs_err=errs["blocked_panel"],
             ms=sa["ms"], plain_ms=sa["plain_ms"], bound_ms=sa["bound_ms"],
             bound_by=sa["bound_by"], library_ms=sa["library_ms"]),
    ]
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
