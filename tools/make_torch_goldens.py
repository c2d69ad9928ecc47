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
With `--svgp` it runs the JAX package's sparse-variational workflow at
full-AAPL scale instead: bench.py's SVGP problem (`chip_smoke.svgp_problem`:
N = 10,963 daily points, M = 128 inducing points on a linspace, SE(1.0,
300.0), Gaussian(1.0) frozen) trained by `train_svgp_minibatched` with
`chip_smoke.SVGP_TRAIN` (batch 2048, 10 epochs, seed 0, groups of 8), and
writes tests/goldens_torch/svgp_full_aapl.json (float64) or, with
`--float32`, svgp_full_aapl_f32.json. The float32 file also holds the kernel
route: the same iterator stream, Adam and frozen likelihood through
`gaussian_elbo_gram_fused(..., use_pallas=True)`, the Pallas gram kernels in
interpret mode. Per route: the full-data ELBO at the start and at the end,
the route's ELBO on the first batch at the start and at the end (with its
gradient at the start for the kernel route), the final leaves, `predict_f`
on `chip_smoke.SVGP_GRID` points and the iteration count; the initial
leaves once. About 1 min in float64 and 2 min in float32 on one core:

    JAX_PLATFORMS=cpu python tools/make_torch_goldens.py --svgp --float32

With `--nuts` it runs bench.py's NUTS workload in the JAX package
(`bench.py:225-270`: 8 chains, `chip_smoke.nuts_bench_data`, ARD SE over
D = 4, `centered_normal_logprior`, `chip_smoke.NUTS_BENCH`) in float64 with
the keys `jax.random.key(s)` for s in `chip_smoke.NUTS_SEEDS`, each seed in
its own process (the log-density's gradient in closed form, held equal to
`gpr_logdensity_vg` first), and once in float32 with key 0 through the
dense XLA path per chain (the router's Pallas path would run in interpret
mode on the CPU); it writes tests/goldens_torch/nuts_bench.json: the
configuration, and per run `chip_smoke.nuts_summary` and its seconds.
About 40 min on four cores. With `--frontier 1y --nuts` it runs the JAX
frontier pipeline's NUTS block (`frontier_pipeline.py:99-129`) in float64
from the float64 fit of tests/goldens_torch/frontier_1y.json, with
`chip_smoke.FRONTIER_NUTS` and `PRNGKey(s)` for each seed of
`chip_smoke.FRONTIER_NUTS_SEEDS` (eight, in parallel processes: about 40 min
on eight cores), and writes
tests/goldens_torch/frontier_1y_nuts.json: per seed μ, Σ, the tangency
weights, return and volatility:

    JAX_PLATFORMS=cpu python tools/make_torch_goldens.py --nuts
"""

from __future__ import annotations

import json
import os
import subprocess
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


def svgp() -> int:
    import optax

    from chip_smoke import (SVGP_BATCH, SVGP_GRID, SVGP_N, SVGP_TRAIN, svgp_goldens_path,
                            svgp_problem)
    from portfoliooptgp_tpu import kernels as jk
    from portfoliooptgp_tpu.data.iterator import MinibatchIterator
    from portfoliooptgp_tpu.models import svgp as svgp_mod
    from portfoliooptgp_tpu.train import lbfgs, svgp_trainer

    dtype = jnp.float32 if FLOAT32 else jnp.float64
    digits = 9 if FLOAT32 else 17  # 9 significant digits round-trip a float32

    def flat(x):
        return [float(f"{v:.{digits}g}") for v in np.asarray(x, np.float64).reshape(-1)]

    def leaves(tree):
        return [flat(x) for x in jax.tree.leaves(tree)]

    X, Y, Z = (a.astype(dtype) for a in svgp_problem())
    model0 = svgp_mod.SVGP.create(jk.SquaredExponential.create(variance=1.0, lengthscales=300.0),
                                  inducing_points=jnp.asarray(Z))
    model0 = jax.tree.map(lambda x: jnp.asarray(x, dtype), model0)
    Xb, Yb = jnp.asarray(X[:SVGP_BATCH]), jnp.asarray(Y[:SVGP_BATCH])
    wb = jnp.ones((SVGP_BATCH,), dtype)
    grid = jnp.asarray(np.linspace(0, X.max(), SVGP_GRID)[:, None].astype(dtype))
    full = jax.jit(lambda m: svgp_mod.gaussian_elbo_gram(m, jnp.asarray(X), jnp.asarray(Y)))

    def batch_elbo(use_pallas):
        return jax.jit(jax.value_and_grad(lambda m: svgp_mod.gaussian_elbo_gram_fused(
            m, Xb, Yb, weights=wb, num_data=SVGP_N, use_pallas=use_pallas)))

    def kernel_route():
        """train_svgp_minibatched's loop with the loss on use_pallas=True."""
        frozen = lbfgs.freeze_leaves(model0, likelihood=True)
        opt = optax.adam(1e-2)

        @jax.jit
        def step(model, state, Xs, Ys, ws):
            loss, g = jax.value_and_grad(lambda m: -svgp_mod.gaussian_elbo_gram_fused(
                m, Xs, Ys, weights=ws, num_data=SVGP_N, use_pallas=True))(model)
            g = jax.tree.map(lambda a, f: jnp.zeros_like(a) if f else a, g, frozen)
            updates, state = opt.update(g, state, model)
            return optax.apply_updates(model, updates), state, loss

        assert svgp_mod.svgp_gram_fused_supported(model0, Xb)
        model, state, loss, steps = model0, opt.init(model0), jnp.inf, 0
        with MinibatchIterator(X, Y, **SVGP_TRAIN) as it:
            for Xs, Ys, ws in it:
                for k in range(Xs.shape[0]):
                    if float(jnp.sum(ws[k])) > 0.0:
                        model, state, loss = step(model, state, Xs[k], Ys[k], ws[k])
                        steps += 1
        return svgp_trainer.SVGPTrainResult(model=model, elbo=-loss, iters=steps)

    routes = {}
    for route in ("xla", "kernel") if FLOAT32 else ("xla",):
        t0 = time.perf_counter()
        if route == "xla":
            res = svgp_trainer.train_svgp_minibatched(model0, X, Y, **SVGP_TRAIN)
        else:
            res = kernel_route()
        jax.block_until_ready(res.model)
        seconds = time.perf_counter() - t0
        vg = batch_elbo(route == "kernel")
        v0, g0 = vg(model0)
        v1, _ = vg(res.model)
        mean, var = svgp_mod.predict_f(res.model, grid)
        routes[route] = dict(
            seconds=seconds, iters=int(res.iters), train_elbo=float(res.elbo),
            elbo_start=float(full(model0)), elbo_final=float(full(res.model)),
            batch_elbo_start=float(v0), batch_elbo_final=float(v1),
            batch_grads_start=leaves(g0) if route == "kernel" else None,
            leaves_final=leaves(res.model), f_mean=flat(mean), f_var=flat(var))
        print(route, "elbo", routes[route]["elbo_start"], "->", routes[route]["elbo_final"],
              "iters", int(res.iters), f"{seconds:.1f} s")
    out = dict(
        source=(f"JAX train_svgp_minibatched on bench.py's SVGP problem, "
                f"{'float32' if FLOAT32 else 'float64'}, CPU (tools/make_torch_goldens.py --svgp)"),
        n=SVGP_N, train=SVGP_TRAIN, grid=SVGP_GRID, leaves_start=leaves(model0), routes=routes)
    path = svgp_goldens_path(FLOAT32)
    with open(path, "w") as fh:
        json.dump(out, fh)
    return 0


def nuts_part(seed: int) -> dict:
    """One JAX run of bench.py's NUTS workload (float32 with --float32)."""
    import jax.flatten_util

    from chip_smoke import NUTS_BENCH, NUTS_D, nuts_bench_data, nuts_summary
    from portfoliooptgp_tpu import kernels as km
    from portfoliooptgp_tpu.inference.fused_logdensity import (gpr_logdensity_pair,
                                                               gpr_logdensity_vg)
    from portfoliooptgp_tpu.inference.sampler import centered_normal_logprior, sample_nuts

    from jax.scipy.linalg import solve_triangular

    dt = jnp.float32 if FLOAT32 else jnp.float64
    X, Y = (jnp.asarray(a, dt) for a in nuts_bench_data())
    m0 = gpr.GPR.create(km.SquaredExponential.create(1.0, np.full(NUTS_D, 8.0)),
                        noise_variance=0.1)
    m0 = jax.tree.map(lambda x: jnp.asarray(x, dt), m0)
    logprior = centered_normal_logprior(m0)
    if FLOAT32:
        def logp(m):
            return gpr.log_marginal_likelihood(m, X, Y) + logprior(m)
        vg = jax.value_and_grad(logp)
    else:
        # The same log-density as gpr_logdensity_vg with the NLL's gradient
        # with respect to K in closed form, ½(K⁻¹ − ααᵀ), instead of
        # differentiating the Cholesky factor (1.5x faster on the CPU);
        # held equal to gpr_logdensity_vg below before the run.
        @jax.custom_vjp
        def nll_k(K, y):
            return nll_fwd(K, y)[0]

        def nll_fwd(K, y):
            L = jnp.linalg.cholesky(K)
            a = solve_triangular(L, y, lower=True)
            W = solve_triangular(L, jnp.eye(y.shape[0], dtype=y.dtype), lower=True)
            value = (0.5 * a @ a + jnp.sum(jnp.log(jnp.diagonal(L)))
                     + 0.5 * y.shape[0] * jnp.log(2 * jnp.pi))
            return value, (W.T @ W, W.T @ a)

        def nll_bwd(res, g):
            Kinv, alpha = res
            return g * 0.5 * (Kinv - jnp.outer(alpha, alpha)), g * alpha

        nll_k.defvjp(nll_fwd, nll_bwd)

        def closed(m):
            K = m.kernel.K(X) + m.likelihood.variance * jnp.eye(X.shape[0], dtype=dt)
            return -nll_k(K, (Y - m.mean_function(X))[:, 0]) + logprior(m)

        logp, _ = gpr_logdensity_pair(X, Y, logprior_fn=logprior)
        vg = jax.value_and_grad(closed)
        ms = jax.tree.map(lambda x: jnp.stack([x] * 8) * jnp.linspace(
            0.9, 1.1, 8).reshape((8,) + (1,) * jnp.ndim(x)), m0)
        got, want = jax.vmap(vg)(ms), jax.vmap(gpr_logdensity_vg(X, Y, logprior))(ms)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10)
    run = jax.jit(lambda key: sample_nuts(logp, m0, key, vg_fn=vg, **NUTS_BENCH))
    t0 = time.perf_counter()
    samples, stats = jax.block_until_ready(run(jax.random.key(seed)))
    elapsed = time.perf_counter() - t0
    draws = jax.vmap(jax.vmap(lambda m: jax.flatten_util.ravel_pytree(m)[0]))(samples)
    return dict(seed=seed, seconds=elapsed,
                **nuts_summary(draws, stats.accept_prob, stats.num_leaves, stats.diverging,
                               stats.inv_mass, stats.step_size))


def frontier_nuts_part(seed: int) -> dict:
    """The JAX frontier pipeline's NUTS block on grid 1y, float64, from the
    fit of frontier_1y.json, with PRNGKey(seed)."""
    import jax.flatten_util

    from chip_smoke import (FRONTIER_ARGS, FRONTIER_GRIDS, FRONTIER_NUTS, frontier_dates,
                            frontier_goldens_path, make_frontier_market)
    from portfoliooptgp_tpu import kernels as km
    from portfoliooptgp_tpu.data.handler import DataHandler
    from portfoliooptgp_tpu.inference import sample_nuts
    from portfoliooptgp_tpu.models import icm
    from portfoliooptgp_tpu.portfolio.frontier import efficient_frontier

    with open(frontier_goldens_path("1y")) as fh:
        fit = json.load(fh)
    with tempfile.TemporaryDirectory() as root:
        names, _ = make_frontier_market(root, *FRONTIER_GRIDS["1y"])
        dh = DataHandler(data_root=root, **frontier_dates("1y"))
        columns, X_ref = [], None
        for asset in names:
            X, Y, *_ = dh.process_data("Stocks", asset, "d", predict_Y="return",
                                       normalize=False, normalize_x=False)
            X_ref = X if X_ref is None else X_ref
            columns.append(np.asarray(Y).reshape(-1))
    Ymat = jnp.asarray(np.column_stack(columns))
    Xs = (X_ref - X_ref.mean()) / (X_ref.std() + 1e-12)
    Xnew = Xs[-1:] + float(Xs[-1, 0] - Xs[-2, 0])
    template = icm.ICMGPR.create(km.SquaredExponential.create(), num_outputs=len(names),
                                 rank=FRONTIER_ARGS["rank"], noise_variance=1e-2)
    model = jax.tree.unflatten(jax.tree.structure(template),
                               [jnp.asarray(x) for x in fit["final_leaves"]])

    def logdensity(m):
        flat, _ = jax.flatten_util.ravel_pytree(m)
        return -icm.neg_log_marginal_likelihood_chol(m, Xs, Ymat) - 0.5 * jnp.sum(flat**2)

    t0 = time.perf_counter()
    samples, stats = sample_nuts(
        logdensity, model, jax.random.PRNGKey(seed),
        num_warmup=FRONTIER_NUTS["nuts_warmup"], num_samples=FRONTIER_NUTS["nuts_samples"],
        num_chains=FRONTIER_NUTS["nuts_chains"], max_depth=FRONTIER_NUTS["nuts_max_depth"])
    flat_samples = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), samples)
    draws = int(jax.tree.leaves(flat_samples)[0].shape[0])
    thin = max(draws // 64, 1)
    thinned = jax.tree.map(lambda x: x[::thin], flat_samples)
    mus, Sigmas = jax.vmap(
        lambda m: icm.posterior_asset_moments_chol(m, Xs, Ymat, Xnew))(thinned)
    mu = jnp.mean(mus, axis=0)
    mu_dev = mus - mu
    Sigma = jnp.mean(Sigmas, axis=0) + mu_dev.T @ mu_dev / mus.shape[0]
    elapsed = time.perf_counter() - t0
    f = efficient_frontier(np.asarray(mu), np.asarray(Sigma),
                           risk_free_rate=FRONTIER_ARGS["risk_free_rate"])
    return dict(seed=seed, seconds=elapsed, draws=draws,
                accept=float(np.mean(stats.accept_prob)),
                leaves=float(np.mean(stats.num_leaves)),
                mu=np.asarray(mu).tolist(), Sigma=np.asarray(Sigma).tolist(),
                tangency_weights=np.asarray(f.tangency_weights).tolist(),
                tangency_return=float(f.tangency_return),
                tangency_volatility=float(f.tangency_volatility))


def run_parts(flag: str, jobs) -> list:
    """Run `jobs` ([(seed, float32)]) of `flag` as parallel child processes
    of this script; return their results in order."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for seed, f32 in jobs:
            out = os.path.join(tmp, f"{seed}_{int(f32)}.json")
            cmd = [sys.executable, os.path.abspath(__file__), flag, str(seed), out]
            # one core a child: XLA's CPU factorizations run on one thread,
            # and idle thread pools in parallel children only contend
            env = dict(os.environ, OMP_NUM_THREADS="1", XLA_FLAGS=(
                "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"))
            procs.append((subprocess.Popen(cmd + (["--float32"] if f32 else []), env=env), out))
        for proc, _ in procs:
            if proc.wait() != 0:
                raise RuntimeError(f"{flag} child failed: {proc.args}")
        results = []
        for _, out in procs:
            with open(out) as fh:
                results.append(json.load(fh))
    return results


def nuts() -> int:
    from chip_smoke import NUTS_BENCH, NUTS_D, NUTS_GOLDENS, NUTS_N, NUTS_SEEDS

    t0 = time.perf_counter()
    *runs, f32 = run_parts("--nuts-part", [(s, False) for s in NUTS_SEEDS] + [(0, True)])
    out = dict(
        source=("JAX sample_nuts on bench.py's workload (bench.py:225-270), float64 per "
                "seed and float32 (dense XLA path) with key 0, CPU "
                "(tools/make_torch_goldens.py --nuts)"),
        n=NUTS_N, d=NUTS_D, config=NUTS_BENCH, data="chip_smoke.nuts_bench_data",
        model="GPR(SquaredExponential(1.0, [8.0] * 4), noise 0.1), "
              "centered_normal_logprior(m0)",
        seeds=list(NUTS_SEEDS), keys="jax.random.key(seed)", runs=runs, f32=f32,
        seconds=time.perf_counter() - t0)
    with open(NUTS_GOLDENS, "w") as fh:
        json.dump(out, fh, indent=1)
    for r in runs + [f32]:
        print(r["seed"], f"{r['seconds']:.1f} s", "accept", r["accept"], "leaves",
              r["leaves"], "mean", np.round(r["mean"], 4))
    return 0


def frontier_nuts() -> int:
    from chip_smoke import FRONTIER_NUTS, FRONTIER_NUTS_GOLDENS, FRONTIER_NUTS_SEEDS

    t0 = time.perf_counter()
    runs = run_parts("--frontier-nuts-part", [(s, False) for s in FRONTIER_NUTS_SEEDS])
    out = dict(
        source=("JAX run_frontier_pipeline's NUTS block (frontier_pipeline.py:99-129), "
                "float64, CPU, from the fit of frontier_1y.json "
                "(tools/make_torch_goldens.py --frontier 1y --nuts)"),
        grid="1y", config=FRONTIER_NUTS, seeds=list(FRONTIER_NUTS_SEEDS),
        keys="jax.random.PRNGKey(seed)", runs=runs, seconds=time.perf_counter() - t0)
    with open(FRONTIER_NUTS_GOLDENS, "w") as fh:
        json.dump(out, fh, indent=1)
    for r in runs:
        print(r["seed"], f"{r['seconds']:.1f} s", "accept", r["accept"], "leaves",
              r["leaves"], "tangency", np.round(r["tangency_weights"], 3))
    return 0


def main() -> int:
    for flag, part in (("--nuts-part", nuts_part), ("--frontier-nuts-part", frontier_nuts_part)):
        if flag in sys.argv[1:]:
            i = sys.argv.index(flag)
            with open(sys.argv[i + 2], "w") as fh:
                json.dump(part(int(sys.argv[i + 1])), fh)
            return 0
    if "--nuts" in sys.argv[1:]:
        return frontier_nuts() if "--frontier" in sys.argv[1:] else nuts()
    if "--svgp" in sys.argv[1:]:
        return svgp()
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
