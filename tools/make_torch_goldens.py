#!/usr/bin/env python3
"""Write tests/goldens_torch/single_asset_2021_2024.json: the JAX package's
single-asset pipeline (`StockPredictor.run_ticker`) in float64 on the CPU,
on the seeded market of `chip_smoke.make_single_asset_market`, with the
8-entry `default_kernel_menu()`, frozen σ² = 1e-5, maxiter 100,
predict_Y="return", the Zero mean and a 30-day horizon.

`chip_smoke.py` holds the PyTorch port's float32 run on the card against
this file. Run from the repository root (takes a few minutes):

    JAX_PLATFORMS=cpu python tools/make_torch_goldens.py

With `--float32` it runs the same pipeline with x64 off (the JAX package's
float32) and writes tests/goldens_torch/single_asset_2021_2024_f32.json in
the same format. `chip_smoke.compare_single_asset` holds a menu entry
against it only where JAX's own float32 run departs from its float64 run
(menu entry 6, Linear on the raw day index, is indefinite in float32).

It records, per timescale, N, the tier the JAX router would take for each
menu entry in float32 (`gpr.nll_tier` on float32 copies), every entry's
train MSE, final loss and loss before training, and the winner; then α,
β and the blended posterior (f_mean, f_var) over the training days and
the horizon.

With `--frontier 1y` or `--frontier 5y` it runs the JAX package's config-5
frontier pipeline (`run_frontier_pipeline`: ICM GP fit by L-BFGS, then the
efficient frontier) instead, on `chip_smoke.make_frontier_market` over the
grid `chip_smoke.FRONTIER_GRIDS[grid]` with `chip_smoke.FRONTIER_ARGS`, and
writes tests/goldens_torch/frontier_<grid>.json (float64) or, with
`--float32`, frontier_<grid>_f32.json (the trinv Pallas kernel of the 5y
grid's hinv tier runs in interpret mode). Each file holds the ICM model's
leaves before and after the fit (W₀ from PRNGKey(0)), the NLL before and
after, the iteration count, B, the kernel hyperparameters, μ, Σ and the
frontier. On the CPU the 1y grid takes about 1 min in float64 and 4.5 min
in float32 on one core, the 5y grid about 18 min in float64 and 2 min in
float32 on three:

    JAX_PLATFORMS=cpu python tools/make_torch_goldens.py --frontier 5y --float32

With `--multi-input` it runs the JAX package's multi-input pipeline on
`benchmarks.bench_portfolio_e2e.make_market` instead and writes
tests/goldens_torch/multi_input_poly.json (float64) or, with `--float32`,
multi_input_poly_f32.json. `trainer._fast_default` is patched to True, so
JAX on the CPU takes the branch a GPU takes: the routed batched NLL (the
dense Pallas kernel in interpret mode in float32 for the Polynomial pair)
and `fit_batched_fused` for the likelihood restarts. It records, for one
asset (`chip_smoke.MULTI_INPUT_TICKER`), steps 1, 2 and 3 with the default
pair and with `(Polynomial, Exponential)`, fixed and trained likelihood,
and `run_step_4(batched=False)` with the Polynomial pair and fixed
likelihood: per case the kept features, N, the float32 tier, every fit's
final loss, σ², restart losses and winner, train MSE and final leaves, and
the step's outputs; the float32 run also records, per fit, its routed NLL
at the float64 golden's leaves (so the float64 run goes first). Then the
5-asset workflow with the Polynomial pair and
trained likelihood (step 4 batched over 5 days × 4 restarts): each asset's
next-day means, variances and per-day losses, and the portfolio quality
in `compare_to_goldens`' format. About 3 min in float64 and 5.5 min in
float32 on one core:

    JAX_PLATFORMS=cpu python tools/make_torch_goldens.py --multi-input --float32
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
FLOAT32 = "--float32" in sys.argv[1:]
jax.config.update("jax_enable_x64", not FLOAT32)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from chip_smoke import (  # noqa: E402
    SINGLE_ASSET_DATES,
    SINGLE_ASSET_GOLDENS,
    SINGLE_ASSET_GOLDENS_F32,
    SINGLE_ASSET_TICKER,
    make_single_asset_market,
)
from portfoliooptgp_tpu.kernels import default_kernel_menu  # noqa: E402
from portfoliooptgp_tpu.models import gpr  # noqa: E402
from portfoliooptgp_tpu.pipelines import single_asset  # noqa: E402
from portfoliooptgp_tpu.train import trainer  # noqa: E402

SEED = 3


def frontier(grid: str) -> int:
    from chip_smoke import (FRONTIER_ARGS, FRONTIER_GRIDS, frontier_dates,
                            frontier_goldens_path, make_frontier_market)
    from portfoliooptgp_tpu.data.handler import DataHandler
    from portfoliooptgp_tpu.ops.pallas import blocked_nll, nll
    from portfoliooptgp_tpu.pipelines import frontier_pipeline
    from portfoliooptgp_tpu.train import lbfgs

    fits = []
    real = lbfgs.fit

    def recording(loss_fn, params, **kw):
        if fits:  # the frontier's simplex solves, traced inside a scan
            return real(loss_fn, params, **kw)
        res = real(loss_fn, params, **kw)
        fits.append(dict(start_nll=float(loss_fn(params)), init=params, res=res))
        return res

    def leaves(model):
        return [np.asarray(x).tolist() for x in jax.tree.leaves(model)]

    first, last = FRONTIER_GRIDS[grid]
    t0 = time.perf_counter()
    frontier_pipeline.lbfgs.fit = recording
    with tempfile.TemporaryDirectory() as root:
        names, _ = make_frontier_market(root, first, last)
        dh = DataHandler(data_root=root, **frontier_dates(grid))
        res = frontier_pipeline.run_frontier_pipeline(names, dh, **FRONTIER_ARGS)
        n = int(dh.process_data("Stocks", names[0], "d", normalize=False,
                                normalize_x=False)[0].shape[0])
    elapsed = time.perf_counter() - t0
    frontier_pipeline.lbfgs.fit = real
    fit = fits[0]
    m, p = res.model, len(names)
    n_pad = n + (-n) % 128
    tier = ("fused" if n_pad <= 512 else "dense" if nll.pallas_nll_supported(n)
            else "blocked" if blocked_nll.blocked_nll_preferred(n)
            else "hinv" if blocked_nll.hinv_nll_preferred(n, p) else "plain")
    f = res.frontier
    out = dict(
        source=(f"JAX run_frontier_pipeline, {'float32' if FLOAT32 else 'float64'}, CPU "
                "(tools/make_torch_goldens.py --frontier)"),
        grid=grid, first=first, last=last, market_seed=11, assets=names, n=n,
        tier_f32=tier, args=FRONTIER_ARGS, seconds=elapsed,
        init_leaves=leaves(fit["init"]), start_nll=fit["start_nll"],
        final_leaves=leaves(m), final_nll=float(fit["res"].loss),
        iters=int(fit["res"].iters), converged=bool(fit["res"].converged),
        B=np.asarray(m.B).tolist(), kernel_variance=float(m.kernel.variance),
        kernel_lengthscale=float(m.kernel.lengthscales),
        noise_variance=float(m.likelihood.variance),
        mu=np.asarray(res.mu).tolist(), Sigma=np.asarray(res.Sigma).tolist(),
        frontier=dict(target_returns=np.asarray(f.target_returns).tolist(),
                      returns=np.asarray(f.returns).tolist(),
                      volatilities=np.asarray(f.volatilities).tolist(),
                      tangency_weights=np.asarray(f.tangency_weights).tolist(),
                      tangency_return=float(f.tangency_return),
                      tangency_volatility=float(f.tangency_volatility)),
    )
    path = frontier_goldens_path(grid, FLOAT32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(grid, "N", n, "tier", tier, "nll", fit["start_nll"], "->", out["final_nll"],
          "iters", out["iters"], f"{elapsed:.1f} s")
    return 0


def multi_input() -> int:
    from benchmarks import bench_portfolio_e2e as e2e
    from chip_smoke import MULTI_INPUT_CASES, MULTI_INPUT_TICKER, multi_input_goldens_path
    from portfoliooptgp_tpu import kernels as jk
    from portfoliooptgp_tpu import pipelines
    from portfoliooptgp_tpu.pipelines import walk_forward
    from portfoliooptgp_tpu.train import batched_lbfgs

    pairs = {"exp": [(jk.Exponential, jk.Exponential)], "poly": [(jk.Polynomial, jk.Exponential)]}
    fits = []
    real_model, real_lik = trainer.train_model, trainer.train_likelihood
    real_fused, real_fast = batched_lbfgs.fit_batched_fused, trainer._fast_default

    def leaves(model):
        return [np.asarray(x).tolist() for x in jax.tree.leaves(model)]

    def tier_f32(model, X, Y):
        stacked = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32)[None], model)
        return gpr.nll_tier(stacked, X.astype(jnp.float32), Y.astype(jnp.float32), fast=True)

    def at_f64_leaves(model, X, Y):
        """The routed float32 NLL at the float64 golden's leaves of this fit."""
        f64 = next(ref_fits)
        m = jax.tree.unflatten(jax.tree.structure(model),
                               [jnp.asarray(x, jnp.float32) for x in f64["leaves"]])
        stacked = jax.tree.map(lambda x: x[None], m)
        return float(gpr.batched_neg_log_marginal_likelihood(stacked, X, Y)[0])

    def record(t, X, Y, restarts=None):
        losses = None if restarts is None else np.where(
            np.isfinite(restarts.loss), restarts.loss, np.inf)
        extra = dict(loss_at_f64_leaves=at_f64_leaves(t.model, X, Y)) if FLOAT32 else {}
        fits.append(dict(n=int(X.shape[0]), d=int(X.shape[1]), loss=float(t.loss), **extra,
                         noise_variance=float(t.model.likelihood.variance), mse=float(t.mse),
                         iters=np.asarray(t.iters).tolist(), tier_f32=tier_f32(t.model, X, Y),
                         restart_losses=None if losses is None else losses.tolist(),
                         winner=None if losses is None else int(np.argmin(losses)),
                         leaves=leaves(t.model)))
        return t

    def train_model(model, X, Y, **kw):
        return record(real_model(model, X, Y, **kw), X, Y)

    def train_likelihood(X, Y, kernel, **kw):
        seen = []

        def fused(*a, **k):
            out = real_fused(*a, **k)
            seen.append(out[1])
            return out

        batched_lbfgs.fit_batched_fused = fused
        try:
            t = real_lik(X, Y, kernel, **kw)
        finally:
            batched_lbfgs.fit_batched_fused = real_fused
        return record(t, X, Y, restarts=seen[0])

    def host(x):
        return np.asarray(x, dtype=float).reshape(-1).tolist()

    if FLOAT32:
        with open(multi_input_goldens_path()) as fh:
            goldens64 = json.load(fh)
    trainer._fast_default = lambda: True
    trainer.train_model, trainer.train_likelihood = train_model, train_likelihood
    cases = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        e2e.make_market(root)
        base = dict(ticker=MULTI_INPUT_TICKER, features=e2e.FEATURES, data_root=root,
                    threshold=0.30, removal_percentage=0.2, maxiter=200, **e2e.DATES)
        for name, (step, pair, fixed) in MULTI_INPUT_CASES.items():
            del fits[:]
            ref_fits = iter(goldens64["cases"][name]["fits"]) if FLOAT32 else None
            t = time.perf_counter()
            mi = pipelines.MultiInputGPR(kernel_pairs=pairs[pair], isFixedLikelihood=fixed,
                                         **base)
            out = mi.run_step_4(batched=False) if step == 4 else getattr(
                mi, f"run_step_{step}")()
            case = dict(step=step, pair=pair, fixed=fixed, fits=list(fits),
                        seconds=time.perf_counter() - t)
            if step == 1:
                case.update(kept=out["kept_features"], f_mean=host(out["f_mean"]),
                            f_var=host(out["f_var"]), mse=out["mse"])
            elif step == 2:
                case.update(mse_all=out["mse_all"], mse_removed=out["mse_removed"])
            else:
                case.update(f_mean=host(out.f_mean), f_var=host(out.f_var),
                            actual=host(out.actual))
            cases[name] = case
            print(name, f"{case['seconds']:.1f} s", [
                (f["n"], f["tier_f32"], round(f["loss"], 6), f["winner"]) for f in fits],
                flush=True)

        # the 5-asset workflow, step 4 with the Polynomial pair and trained likelihood
        walks = []
        real_walk = walk_forward.batched_walk_forward

        def walk(*a, **k):
            res = real_walk(*a, **k)
            walks.append(dict(losses=host(res.losses)))
            return res

        class PolyTrained(pipelines.MultiInputGPR):
            def __init__(self, **kw):
                kw.update(kernel_pairs=pairs["poly"], isFixedLikelihood=False)
                super().__init__(**kw)

            def run_step_4(self, batched=True):
                p = super().run_step_4(batched)
                walks[-1].update(f_mean=host(p.f_mean), f_var=host(p.f_var))
                return p

        real_cls = pipelines.MultiInputGPR
        walk_forward.batched_walk_forward, pipelines.MultiInputGPR = walk, PolyTrained
        try:
            wf_seconds, quality = e2e.run_workflow(root)
        finally:
            walk_forward.batched_walk_forward, pipelines.MultiInputGPR = real_walk, real_cls
    trainer.train_model, trainer.train_likelihood = real_model, real_lik
    trainer._fast_default = real_fast
    out = dict(
        source=(f"JAX MultiInputGPR, {'float32' if FLOAT32 else 'float64'}, CPU, "
                "trainer._fast_default patched to True (tools/make_torch_goldens.py "
                "--multi-input)"),
        ticker=MULTI_INPUT_TICKER, market_seed=7, dates=e2e.DATES, maxiter=200,
        seconds=time.perf_counter() - t0, cases=cases,
        workflow=dict(assets=e2e.ASSETS, seconds=wf_seconds, step4=walks,
                      strategies=quality))
    path = multi_input_goldens_path(FLOAT32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print("workflow", f"{wf_seconds:.1f} s", json.dumps(quality), flush=True)
    return 0


def main() -> int:
    if "--multi-input" in sys.argv[1:]:
        return multi_input()
    if "--frontier" in sys.argv[1:]:
        return frontier(sys.argv[sys.argv.index("--frontier") + 1])
    menus = {}
    real = trainer.train_best_model

    def recording(X, Y, menu, **kw):
        res = real(X, Y, menu, **kw)
        f32 = [gpr.nll_tier(jax.tree.map(lambda x: jnp.asarray(x, jnp.float32)[None],
                                         gpr.GPR.create(k, kw["noise_variance"])),
                            X.astype(jnp.float32), Y.astype(jnp.float32), fast=True)
               for k in default_kernel_menu()]
        start = [float(gpr.neg_log_marginal_likelihood(
            gpr.GPR.create(k, kw["noise_variance"]), X, Y)) for k in default_kernel_menu()]
        menus[int(X.shape[0])] = dict(n=int(X.shape[0]), best_index=res.best_index,
                                      mses=res.mses, losses=res.losses, start_losses=start,
                                      tiers_f32=f32)
        return res

    single_asset.trainer.train_best_model = recording
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        make_single_asset_market(root, SEED)
        sp = single_asset.StockPredictor([SINGLE_ASSET_TICKER], data_root=root,
                                         horizon_days=30, **SINGLE_ASSET_DATES)
        res = sp.run_ticker(SINGLE_ASSET_TICKER)
    elapsed = time.perf_counter() - t0
    single_asset.trainer.train_best_model = real
    timescales = {tag: menus[int(r.X.shape[0])] for tag, r in res.timeframes.items()}
    n_daily = int(res.timeframes["d"].X.shape[0])
    out = dict(
        source=(f"JAX StockPredictor.run_ticker, {'float32' if FLOAT32 else 'float64'}, CPU "
                "(tools/make_torch_goldens.py)"),
        seed=SEED, ticker=SINGLE_ASSET_TICKER, dates=SINGLE_ASSET_DATES,
        maxiter=100, noise_variance=1e-5, horizon_days=30, seconds=elapsed,
        timescales=timescales, alpha=res.alpha, beta=res.beta, n_daily=n_daily,
        Y_daily=np.asarray(res.timeframes["d"].Y).reshape(-1).tolist(),
        f_mean=np.asarray(res.f_mean).reshape(-1).tolist(),
        f_var=np.asarray(res.f_var).reshape(-1).tolist(),
    )
    path = SINGLE_ASSET_GOLDENS_F32 if FLOAT32 else SINGLE_ASSET_GOLDENS
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    for tag, t in timescales.items():
        print(tag, t["n"], "winner", t["best_index"], "tiers", t["tiers_f32"])
        print("   mses", t["mses"])
        print("   losses", t["losses"])
    print("alpha", res.alpha, "beta", res.beta, f"{elapsed:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
