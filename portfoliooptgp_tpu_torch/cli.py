"""Command-line entry points: `python -m portfoliooptgp_tpu_torch <command>
[--config cfg.json] [flags]`.

Port of portfoliooptgp_tpu/cli.py: the same seven commands, arguments,
printed lines, metrics records and plots.

  single-asset   multi-timescale GPR with blended predictions (P1)
  multi-input    multi-input GPR steps 1-4 (P2)
  portfolio      full flagship workflow: walk-forward GP -> 5 strategies ->
                 backtest comparison
  svgp           sparse variational GP training on one series
  frontier       multi-output GP posterior -> efficient frontier (config 5)
  nuts           fully-Bayesian hyperparameter sampling
  print-config   dump the default RunConfig JSON schema

Where the two packages differ:
- the commands run on `--device` (default `cuda`, the counterpart of
  JAX's platform choice; `cpu` on a machine without a GPU: there is no
  silent fallback), in float64 with `--x64`, else float32;
- `--debug-nans` turns on `torch.autograd.set_detect_anomaly`, the nearest
  torch mechanism to `jax_debug_nans`: it checks the outputs of backward
  functions only, not every forward operation;
- `--profile LOGDIR` writes a `torch.profiler` Chrome trace
  (utils/profiling.py) instead of an XPlane trace, and beside it
  `spans.json`: each of the program's spans (`lbfgs.iteration`,
  `router.dispatch`, `nuts.leaf`, ...) with its count and its total and
  self milliseconds;
- `svgp --mesh` splits the rows over the ranks of the process group
  (parallel/distributed.py reads its rendezvous from the environment, as
  `torchrun --nproc-per-node=N -m portfoliooptgp_tpu_torch svgp --mesh`
  sets it: NCCL on the card, one card a rank, gloo with `--device cpu`),
  or over this one process when no group is given; only rank 0 prints
  and writes `--metrics`;
- there is no compile cache to enable: the CUDA kernels are built once
  into `build/kernels/`;
- `nuts` draws from a `torch.Generator` seeded by the config's seed
  (inference/source.py), not from `jax.random.PRNGKey(seed)`.
"""

from __future__ import annotations

import argparse
import sys


def _add_common(p):
    p.add_argument("--config", help="RunConfig JSON file")
    p.add_argument("--data-root", default=None, help="directory with Stocks/ Commodities/")
    p.add_argument("--x64", action="store_true", help="float64 parity mode")
    p.add_argument("--device", default="cuda",
                   help="torch device the command runs on (cuda or cpu)")
    p.add_argument("--metrics", default=None, help="JSONL metrics output path")
    p.add_argument("--plots", default=None, help="directory for PNG outputs")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="capture a torch.profiler Chrome trace to LOGDIR")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise on the first NaN produced by a backward computation")


def _load_config(args):
    from portfoliooptgp_tpu_torch import config as cfg_mod

    cfg = cfg_mod.load(args.config) if args.config else cfg_mod.RunConfig()
    if args.data_root:
        cfg.data.data_root = args.data_root
    return cfg


def _placement(args) -> dict:
    """device and dtype of the command: float64 with --x64, else float32."""
    import torch

    from portfoliooptgp_tpu_torch.device import resolve_device

    return dict(device=resolve_device(args.device),
                dtype=torch.float64 if args.x64 else torch.float32)


def _host(x):
    import numpy as np

    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def cmd_print_config(args):
    from portfoliooptgp_tpu_torch import config as cfg_mod

    print(cfg_mod.RunConfig().to_json())


def cmd_single_asset(args):
    from portfoliooptgp_tpu_torch.pipelines import StockPredictor
    from portfoliooptgp_tpu_torch.utils.metrics import MetricsLogger

    cfg = _load_config(args)
    log = MetricsLogger(path=args.metrics)
    sp = StockPredictor(
        args.tickers,
        cfg.data.train_start_date, cfg.data.train_end_date,
        cfg.data.test_start_date, cfg.data.test_end_date,
        lambda_=args.blend_lambda, predict_Y=cfg.data.predict_y,
        data_root=cfg.data.data_root, maxiter=cfg.train.maxiter,
        noise_variance=cfg.train.noise_variance, horizon_days=args.horizon,
        **_placement(args),
    )
    import time as _time

    for ticker in args.tickers:
        t0 = _time.perf_counter()
        res = sp.run_ticker(ticker)
        d = res.timeframes["d"]
        if getattr(args, "profile", None):
            log.log("ticker_train_time_s", _time.perf_counter() - t0,
                    ticker=ticker)
        log.log("train_mse", d.mse, ticker=ticker)
        log.log("blend_alpha", res.alpha, ticker=ticker)
        log.log("blend_beta", res.beta, ticker=ticker)
        print(f"{ticker}: best kernel #{d.kernel_index} train-MSE={d.mse:.6f} "
              f"alpha={res.alpha:.3f} beta={res.beta:.3f}")
        if args.plots:
            from portfoliooptgp_tpu_torch.viz import Visualizer

            lo, hi = res.confidence_bands("f")
            ylo, yhi = res.confidence_bands("y")
            Visualizer().plot_pred_data(
                _host(d.X), _host(d.Y), _host(res.X_combined_daily), _host(res.f_mean),
                _host(lo), _host(hi), _host(res.y_mean), _host(ylo), _host(yhi),
                title=ticker, mean=d.y_stats[0], std=d.y_stats[1],
                filename=f"{args.plots}/{ticker}_GPR_predict_combined.png",
            )


def cmd_multi_input(args):
    from portfoliooptgp_tpu_torch.pipelines import MultiInputGPR

    cfg = _load_config(args)
    mi = MultiInputGPR(
        ticker=args.ticker, features=args.features,
        train_start_date=cfg.data.train_start_date,
        train_end_date=cfg.data.train_end_date,
        test_start_date=cfg.data.test_start_date,
        test_end_date=cfg.data.test_end_date,
        threshold=cfg.portfolio.correlation_threshold,
        removal_percentage=cfg.portfolio.removal_percentage,
        predict_Y=cfg.data.predict_y,
        isFixedLikelihood=not cfg.train.train_likelihood,
        data_root=cfg.data.data_root, verbose=True, **_placement(args),
    )
    step_fn = {1: mi.run_step_1, 2: mi.run_step_2, 3: mi.run_step_3, 4: mi.run_step_4}
    out = step_fn[args.step]()
    if args.step in (3, 4):
        print("f_mean tail:", out.f_mean.reshape(-1))
        print("actual tail:", out.actual.reshape(-1))


def cmd_portfolio(args):
    import numpy as np

    from portfoliooptgp_tpu_torch.pipelines import MultiInputGPR
    from portfoliooptgp_tpu_torch.pipelines.multi_input import full_correlations
    from portfoliooptgp_tpu_torch.portfolio import Portfolio, PortfolioOptimizer
    from portfoliooptgp_tpu_torch.utils.metrics import MetricsLogger

    cfg = _load_config(args)
    place = _placement(args)
    log = MetricsLogger(path=args.metrics)
    preds, pvars, actuals, trains = [], [], [], []
    for ticker in args.assets:
        print(f"Predicting {ticker}")
        mi = MultiInputGPR(
            ticker=ticker, features=args.features,
            train_start_date=cfg.data.train_start_date,
            train_end_date=cfg.data.train_end_date,
            test_start_date=cfg.data.test_start_date,
            test_end_date=cfg.data.test_end_date,
            threshold=cfg.portfolio.correlation_threshold,
            removal_percentage=cfg.portfolio.removal_percentage,
            predict_Y=cfg.data.predict_y,
            isFixedLikelihood=not cfg.train.train_likelihood,
            data_root=cfg.data.data_root, **place,
        )
        p = mi.run_step_4()
        preds.append(p.f_mean)
        pvars.append(p.f_var)
        actuals.append(p.actual)
        trains.append(p.Y_train)

    corr = full_correlations(np.column_stack([t.reshape(-1) for t in trains]))
    opt = PortfolioOptimizer(
        n_assets=len(args.assets),
        lambda_l1=cfg.portfolio.lambda_l1, lambda_l2=cfg.portfolio.lambda_l2,
        lambda_tx=cfg.portfolio.broker_fee, if_tx_penalty=cfg.portfolio.tx_penalty, **place,
    )
    port = Portfolio(args.assets, preds, pvars, opt,
                     risk_free_rate=cfg.portfolio.risk_free_rate,
                     broker_fee=cfg.portfolio.broker_fee, verbose=True, **place)
    cml_by_strategy, trx_by_strategy = {}, {}
    for strat in ["constant", "sharpe", "max_return", "min_volatility", "dynamic"]:
        w, v = port.evaluate_portfolio(
            strategy_name=strat,
            max_volatility=cfg.portfolio.max_volatility,
            min_return=cfg.portfolio.min_return,
            prob_threshold=cfg.portfolio.prob_threshold,
            isLogReturn=cfg.portfolio.is_log_return, cov=corr,
        )
        cml, trx = port.backtest_portfolio(actuals, strat, w, v)
        cml_by_strategy[strat] = cml
        trx_by_strategy[strat] = trx
        log.log("cumulative_return", cml[-1], strategy=strat)
        log.log("sharpe_ratio", port.last_summary["sharpe_ratio"], strategy=strat)
        if args.plots:
            from portfoliooptgp_tpu_torch.viz import Visualizer

            Visualizer().plot_asset_allocations(
                w, args.assets, strategy_name=strat,
                filename=f"{args.plots}/asset_allocations_{strat}.png",
            )
    if args.plots:
        from portfoliooptgp_tpu_torch.viz import Visualizer

        Visualizer().plot_backtest_cml(
            cml_by_strategy, filename=f"{args.plots}/portfolio_comparison.png"
        )
        Visualizer().plot_backtest_cml(
            trx_by_strategy, ylabel="Cumulative Transaction Costs",
            title="Transaction Costs Comparison",
            filename=f"{args.plots}/trx_costs_comparison.png",
        )


def cmd_svgp(args):
    import numpy as np
    import torch

    from portfoliooptgp_tpu_torch import kernels as km
    from portfoliooptgp_tpu_torch.data.handler import DataHandler
    from portfoliooptgp_tpu_torch.models import svgp
    from portfoliooptgp_tpu_torch.models.likelihoods import Gaussian
    from portfoliooptgp_tpu_torch.parallel import distributed, elbo_sharded
    from portfoliooptgp_tpu_torch.parallel import mesh as mesh_mod
    from portfoliooptgp_tpu_torch.train.optim import Adam
    from portfoliooptgp_tpu_torch.utils.metrics import MetricsLogger

    cfg = _load_config(args)
    place = _placement(args)
    mesh = None
    if args.mesh:
        place["device"] = distributed.initialize(device=place["device"])
        mesh = mesh_mod.make_mesh(device=place["device"])
    primary = distributed.is_primary()
    log = MetricsLogger(path=args.metrics if primary else None)
    dh = DataHandler(cfg.data.train_start_date, cfg.data.train_end_date,
                     cfg.data.test_start_date, cfg.data.test_end_date,
                     data_root=cfg.data.data_root, **place)
    X, Y, *_ = dh.process_data("Stocks", args.ticker, "d",
                               cfg.data.train_start_date, cfg.data.test_end_date,
                               predict_Y=cfg.data.predict_y)
    Z = np.linspace(float(X.min()), float(X.max()), args.inducing)[:, None]
    model = svgp.SVGP.create(
        km.SquaredExponential.create(**place), inducing_points=Z,
        likelihood=Gaussian.create(1e-4, **place), **place,
    )
    if mesh is not None:
        Xs, Ys, w = elbo_sharded.prepare_global_batch(mesh, X, Y)
    else:
        Xs, Ys, w = X, Y, torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)
    init_fn, step_fn = elbo_sharded.make_elbo_train_step(
        num_data=X.shape[0], mesh=mesh, optimizer=Adam(args.lr)
    )
    state = init_fn(model)
    profiling = bool(getattr(args, "profile", None))
    import time as _time

    for step in range(args.steps):
        t0 = _time.perf_counter()
        state, loss = step_fn(state, Xs, Ys, w)
        if profiling:
            # per-step ELBO timing into the metrics JSONL; float() waits for
            # the device result, so the time is real
            log.log("elbo_step_time_s", _time.perf_counter() - t0, step=step,
                    neg_elbo=float(loss))
        if step % 50 == 0:
            log.log("neg_elbo", float(loss), step=step)
            if primary:
                print(f"step {step}: neg-ELBO {float(loss):.4f}")
    if primary:
        print(f"final neg-ELBO {float(loss):.4f}")


def cmd_frontier(args):
    import numpy as np

    from portfoliooptgp_tpu_torch.data.handler import DataHandler
    from portfoliooptgp_tpu_torch.pipelines.frontier_pipeline import run_frontier_pipeline
    from portfoliooptgp_tpu_torch.portfolio.frontier import plot_frontier

    cfg = _load_config(args)
    place = _placement(args)
    dh = DataHandler(cfg.data.train_start_date, cfg.data.train_end_date,
                     cfg.data.test_start_date, cfg.data.test_end_date,
                     data_root=cfg.data.data_root, **place)
    res = run_frontier_pipeline(
        args.assets, dh, predict_y=cfg.data.predict_y, rank=args.rank,
        use_nuts=args.nuts, nuts_max_depth=args.nuts_depth,
        risk_free_rate=cfg.portfolio.risk_free_rate,
        maxiter=cfg.train.maxiter * 3, **place,
    )
    print("posterior mu:", np.round(res.mu, 5))
    print("posterior vol:", np.round(np.sqrt(np.diag(res.Sigma)), 5))
    print("tangency weights:", dict(zip(res.assets, np.round(res.frontier.tangency_weights, 4))))
    print(f"tangency return={res.frontier.tangency_return:.5f} "
          f"vol={res.frontier.tangency_volatility:.5f}")
    if args.plots:
        plot_frontier(res.frontier, cfg.portfolio.risk_free_rate,
                      filename=f"{args.plots}/efficient_frontier.png")


def cmd_nuts(args):
    import numpy as np
    import torch

    from portfoliooptgp_tpu_torch import inference
    from portfoliooptgp_tpu_torch import kernels as km
    from portfoliooptgp_tpu_torch.data.handler import DataHandler
    from portfoliooptgp_tpu_torch.inference.sampler import centered_normal_logprior
    from portfoliooptgp_tpu_torch.models import gpr

    cfg = _load_config(args)
    place = _placement(args)
    dh = DataHandler(cfg.data.train_start_date, cfg.data.train_end_date,
                     cfg.data.test_start_date, cfg.data.test_end_date,
                     data_root=cfg.data.data_root, **place)
    X, Y, *_ = dh.process_data("Stocks", args.ticker, "d",
                               predict_Y=cfg.data.predict_y)
    # init noise at a sampling-friendly 1e-2, NOT the MLE parity pin of
    # 1e-5 (cfg.train.noise_variance): at sigma^2=1e-5 the posterior
    # geometry is near-singular (curvature ~1/lambda_min of K) and NUTS
    # needs 1e-7 step sizes. The posterior over noise is what this command
    # infers, so the init only needs to be in a sane basin.
    nuts_init_noise = 1e-2
    if cfg.train.noise_variance != nuts_init_noise:
        print(f"note: nuts initializes noise_variance={nuts_init_noise:g} for "
              f"sampling geometry; cfg.train.noise_variance="
              f"{cfg.train.noise_variance:g} is an MLE pin and is not used here")
    model = gpr.GPR.create(km.SquaredExponential.create(**place),
                           noise_variance=nuts_init_noise)

    # weak prior CENTERED AT THE INIT: an N(0,1) prior on raw params fights
    # a 1e-5 noise init (raw ~ -11.5) and makes the posterior near-singular
    # (see sampler.centered_normal_logprior)
    logprior = centered_normal_logprior(model)

    def logdensity(m):
        return gpr.log_marginal_likelihood(m, X, Y) + logprior(m)

    source = torch.Generator(device=place["device"]).manual_seed(cfg.seed)
    samples, stats = inference.sample_nuts(
        logdensity, model, source,
        num_warmup=args.warmup, num_samples=args.samples, num_chains=args.chains,
        device=place["device"],
    )
    from portfoliooptgp_tpu_torch.params import positive

    noise = _host(positive(samples.likelihood.raw_variance)).reshape(-1)
    print(f"accept={float(stats.accept_prob.mean()):.3f} "
          f"divergences={int(stats.diverging.sum())}")
    print(f"posterior noise variance: median={np.median(noise):.5f} "
          f"CI90=({np.quantile(noise, 0.05):.5f}, {np.quantile(noise, 0.95):.5f})")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="portfoliooptgp_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("print-config", help="dump default config JSON")
    p.set_defaults(fn=cmd_print_config)

    p = sub.add_parser("single-asset", help="multi-timescale GPR pipeline")
    _add_common(p)
    p.add_argument("--tickers", nargs="+", default=["AAPL", "MSFT"])
    p.add_argument("--horizon", type=int, default=30)
    p.add_argument("--blend-lambda", type=float, default=0.1)
    p.set_defaults(fn=cmd_single_asset)

    p = sub.add_parser("multi-input", help="multi-input GPR steps 1-4")
    _add_common(p)
    p.add_argument("--ticker", default="JPM")
    p.add_argument("--features", nargs="+",
                   default=["Brent_Oil", "DXY", "SP500", "NasDaq100", "BTC", "XAU_USD"])
    p.add_argument("--step", type=int, choices=[1, 2, 3, 4], default=4)
    p.set_defaults(fn=cmd_multi_input)

    p = sub.add_parser("portfolio", help="full 5-strategy portfolio workflow")
    _add_common(p)
    p.add_argument("--assets", nargs="+", default=["JPM", "MSFT", "COST", "HLT", "JNJ"])
    p.add_argument("--features", nargs="+",
                   default=["Brent_Oil", "DXY", "SP500", "NasDaq100", "BTC", "XAU_USD"])
    p.set_defaults(fn=cmd_portfolio)

    p = sub.add_parser("svgp", help="sparse variational GP training")
    _add_common(p)
    p.add_argument("--ticker", default="AAPL")
    p.add_argument("--inducing", type=int, default=20)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--mesh", action="store_true",
                   help="split the rows over the ranks of the process group")
    p.set_defaults(fn=cmd_svgp)

    p = sub.add_parser("frontier", help="multi-output GP posterior -> efficient frontier")
    _add_common(p)
    p.add_argument("--assets", nargs="+", default=["JPM", "MSFT", "COST", "HLT", "JNJ"])
    p.add_argument("--rank", type=int, default=2)
    p.add_argument("--nuts", action="store_true", help="Bayesian-average moments over NUTS draws")
    # 6, as the JAX CLI's default, where run_frontier_pipeline's is 8
    p.add_argument("--nuts-depth", type=int, default=6, help="NUTS max tree depth")
    p.set_defaults(fn=cmd_frontier)

    p = sub.add_parser("nuts", help="Bayesian hyperparameter sampling")
    _add_common(p)
    p.add_argument("--ticker", default="AAPL")
    p.add_argument("--warmup", type=int, default=300)
    p.add_argument("--samples", type=int, default=500)
    p.add_argument("--chains", type=int, default=4)
    p.set_defaults(fn=cmd_nuts)

    args = parser.parse_args(argv)
    if getattr(args, "debug_nans", False):
        import torch

        torch.autograd.set_detect_anomaly(True)
    if getattr(args, "profile", None):
        from portfoliooptgp_tpu_torch.utils.profiling import trace

        with trace(args.profile):
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
