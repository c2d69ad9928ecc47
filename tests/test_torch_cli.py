"""Port parity: the shell (config.py, utils/, viz/, portfolio.frontier's
plot, cli.py and `python -m portfoliooptgp_tpu_torch`) against the JAX
package's, on the CPU.

The commands run in float64 (`--x64 --device cpu`) on
`benchmarks.bench_portfolio_e2e.make_market` beside the JAX CLI's own
commands, in-process. Neither CLI passes a maxiter to `MultiInputGPR`
(whatever the config says, its default of 1000 holds), so here both
packages' `MultiInputGPR` are patched to `MI_MAXITER`; the outputs are held
at the flow tests' tolerances (tests/test_torch_walk_forward.py,
tests/test_torch_e2e.py). `nuts` replays the JAX CLI's keys
(tests/jax_replay.JaxKeys)."""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_replay import JaxKeys

import portfoliooptgp_tpu.inference as jinference
import portfoliooptgp_tpu.pipelines as jpipelines
import portfoliooptgp_tpu.pipelines.walk_forward as jwalk_forward
import portfoliooptgp_tpu_torch.inference as tinference
import portfoliooptgp_tpu_torch.pipelines as tpipelines
import portfoliooptgp_tpu_torch.pipelines.walk_forward as twalk_forward
from benchmarks.bench_portfolio_e2e import ASSETS, DATES, FEATURES, make_market
from portfoliooptgp_tpu import cli as jcli
from portfoliooptgp_tpu import config as jconfig
from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.models import gpr as jgpr
from portfoliooptgp_tpu.utils import checkpoint as jcheckpoint
from portfoliooptgp_tpu.utils import metrics as jmetrics
from portfoliooptgp_tpu_torch import cli as tcli
from portfoliooptgp_tpu_torch import config as tconfig
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.models import gpr as tgpr
from portfoliooptgp_tpu_torch.utils import checkpoint as tcheckpoint
from portfoliooptgp_tpu_torch.utils import metrics as tmetrics
from portfoliooptgp_tpu_torch.utils import profiling as tprofiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMANDS = ("print-config", "single-asset", "multi-input", "portfolio", "svgp", "frontier",
            "nuts")
MI_MAXITER = 200
# `multi-input --step 4` trains five days' walk-forward in one batched
# L-BFGS whose float64 runs in the two packages part from rounding alone
# between iterations 15 and 20 (max |Δ mean| 2e-10 at 5, 1e-8 at 10 and 15,
# 3e-7 at 20). Converged (maxiter MI_MAXITER), both stop where the loss no
# longer falls, at gradient norms 1e-5 to 9e-4 and at losses within 1.7e-6
# of each other, but at next-day means up to 6.5e-7 apart on one of 3.2e-4
# (tools/trace_step4_divergence.py). So that test holds the means to JAX's
# at MI_STEP4_MAXITER, before the runs part; the converged run's losses to
# JAX's at MI_STEP4_LOSS_RTOL; and its means to what JAX predicts from the
# port's converged fit.
MI_STEP4_MAXITER = 10
MI_STEP4_LOSS_RTOL = 1e-5
PORT = ["--x64", "--device", "cpu"]


@pytest.fixture(autouse=True)
def no_jax_cache(monkeypatch):
    # the JAX CLI turns on its persistent compile cache; keep it out of the tree
    monkeypatch.setenv("PORTFOLIOOPTGP_JAX_CACHE", "0")


@pytest.fixture(scope="module")
def market(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("market"))
    make_market(root)
    cfg = os.path.join(root, "cfg.json")
    with open(cfg, "w") as fh:
        json.dump({"data": DATES}, fh)
    return root, cfg


def _cap_fits(monkeypatch, maxiter):
    """Both packages' MultiInputGPR at `maxiter`."""
    for mod in (jpipelines, tpipelines):
        real = mod.MultiInputGPR

        class Short(real):
            def __init__(self, *a, **kw):
                kw["maxiter"] = maxiter
                super().__init__(*a, **kw)

        monkeypatch.setattr(mod, "MultiInputGPR", Short)


@pytest.fixture
def short_fits(monkeypatch):
    """Both packages' MultiInputGPR at maxiter MI_MAXITER."""
    _cap_fits(monkeypatch, MI_MAXITER)


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


def test_torch_cli_print_config_and_help_match_jax(capsys):
    """print-config prints the JAX CLI's text; --help lists the same
    commands with the same help; each command takes the JAX CLI's options
    plus --device. Through `python -m` as well."""
    assert _run(tcli.main, ["print-config"], capsys) == _run(jcli.main, ["print-config"], capsys)

    def usage(main, argv, prog):
        with pytest.raises(SystemExit):
            main(argv)
        return " ".join(capsys.readouterr().out.replace(prog, "PROG").split())

    assert (usage(tcli.main, ["--help"], "portfoliooptgp_tpu_torch")
            == usage(jcli.main, ["--help"], "portfoliooptgp_tpu"))
    for cmd in COMMANDS:
        opts = [set(re.findall(r"--[a-z0-9-]+", usage(m, [cmd, "--help"], p)))
                for m, p in ((tcli.main, "portfoliooptgp_tpu_torch"),
                             (jcli.main, "portfoliooptgp_tpu"))]
        assert opts[0] == opts[1] | ({"--device"} if cmd != "print-config" else set()), cmd
    out = subprocess.run([sys.executable, "-m", "portfoliooptgp_tpu_torch", "print-config"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and json.loads(out.stdout) == json.loads(
        jconfig.RunConfig().to_json())


def test_torch_config_round_trips_with_jax(tmp_path):
    """RunConfig JSON written by either package loads in the other with
    every field equal; DTypePolicy.dtype is a torch dtype."""
    cfg = tconfig.RunConfig()
    cfg.train.maxiter, cfg.data.train_start_date, cfg.dtype.mode = 7, "2021-06-14", "fast"
    cfg.mesh.axis_names = ("data",)
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    back = tconfig.load(str(path))
    assert back.to_json() == cfg.to_json()
    assert jconfig.load(str(path)).to_json() == cfg.to_json()
    assert (tconfig.RunConfig.from_json(jconfig.RunConfig().to_json()).to_json()
            == tconfig.RunConfig().to_json())
    assert back.dtype.dtype == torch.float32 and tconfig.RunConfig().dtype.dtype == torch.float64


def test_torch_metrics_match_jax(tmp_path):
    """The metric definitions, and MetricsLogger's JSONL records (tensors
    logged as floats) with the JAX package's keys and values."""
    y, p = [1.0, 2.0, 0.5], [1.0, 4.0, 0.0]
    assert tmetrics.mse(y, p) == jmetrics.mse(y, p)
    assert tmetrics.cumulative_return([0.1, -0.05]) == jmetrics.cumulative_return([0.1, -0.05])
    assert tmetrics.daily_sharpe(0.02, 0.0, 0.01) == 2.0
    assert tmetrics.portfolio_sharpe(0.03, 0.01, 0.5) == jmetrics.portfolio_sharpe(0.03, 0.01, 0.5)
    recs = []
    for mod, value in ((tmetrics, torch.tensor([1.25], dtype=torch.float64)),
                       (jmetrics, jnp.asarray(1.25))):
        path = tmp_path / f"{mod.__name__}.jsonl"
        log = mod.MetricsLogger(path=str(path))
        log.log("nll", 1.5, step=3, ticker="AAPL")
        log.log("nll", value, step=4)
        lines = [json.loads(line) for line in path.read_text().splitlines()]
        assert len(log.records) == 2
        recs.append([{k: v for k, v in r.items() if k != "ts"} for r in lines])
    assert recs[0] == recs[1]


def _jax_model():
    return jgpr.GPR.create(jk.SquaredExponential.create(variance=2.5, lengthscales=[1.5, 0.7]),
                           0.07)


def _port_template():
    return tgpr.GPR.create(tk.SquaredExponential.create(
        1.0, [1.0, 1.0], device="cpu", dtype=torch.float64), 1.0)


def test_torch_checkpoint_cross_loads_with_jax(tmp_path):
    """A JAX checkpoint of an ARD GPR loads into a port template, and a port
    checkpoint into a JAX template: the same NLL on both sides; a template
    of another structure is refused."""
    rng = np.random.default_rng(0)
    X, Y = rng.uniform(0, 5, (30, 2)), rng.normal(size=(30, 1))
    jm = _jax_model()
    want = float(jgpr.neg_log_marginal_likelihood(jm, jnp.asarray(X), jnp.asarray(Y)))

    jcheckpoint.save(str(tmp_path / "jax.npz"), jm)
    tm = tcheckpoint.load(str(tmp_path / "jax.npz"), _port_template())
    got = float(tgpr.neg_log_marginal_likelihood(tm, torch.tensor(X), torch.tensor(Y))[0])
    np.testing.assert_allclose(got, want, rtol=1e-12)

    tcheckpoint.save_array_tree(str(tmp_path / "sub" / "port.npz"), tm)
    assert not os.path.exists(tmp_path / "sub" / "port.npz.tmp")
    back = jcheckpoint.load(str(tmp_path / "sub" / "port.npz"), _jax_model())
    back = jax.tree.map(lambda x, t: jnp.reshape(x, jnp.shape(t)), back, jm)
    np.testing.assert_allclose(
        float(jgpr.neg_log_marginal_likelihood(back, jnp.asarray(X), jnp.asarray(Y))), want,
        rtol=1e-12)
    again = tcheckpoint.load(str(tmp_path / "sub" / "port.npz"), _port_template())
    for a, b in zip(tparams.tree_leaves(again), tparams.tree_leaves(tm)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        tcheckpoint.load(str(tmp_path / "jax.npz"), tgpr.GPR.create(
            tk.SquaredExponential.create(device="cpu", dtype=torch.float64)
            + tk.Matern12.create(device="cpu", dtype=torch.float64), 1.0))


def test_torch_visualizer_and_plot_frontier_write_pngs(tmp_path):
    """Every Visualizer plot and plot_frontier write a PNG, as the JAX
    package's do (tests/test_utils_cli.py)."""
    from portfoliooptgp_tpu_torch.portfolio.frontier import efficient_frontier, plot_frontier
    from portfoliooptgp_tpu_torch.viz import Visualizer

    v = Visualizer()
    X = np.linspace(0, 10, 40)[:, None]
    Y = np.sin(X)
    v.plot_data(X, Y, title="t", filename=str(tmp_path / "a.png"))
    v.plot_gp(X, Y, Y, np.full_like(Y, 0.01), filename=str(tmp_path / "b.png"))
    v.plot_gp_with_removed(X, Y, Y, np.full_like(Y, 0.01), X[:3], Y[:3],
                           filename=str(tmp_path / "c.png"))
    v.plot_backtest_cml({"sharpe": [0, 0.01, 0.02], "constant": [0, 0.005, 0.01]},
                        filename=str(tmp_path / "d.png"))
    v.plot_asset_allocations([np.full(5, 0.2)] * 2, list("ABCDE"),
                             filename=str(tmp_path / "e.png"))
    v.plot_pred_data(X, Y, X, Y, Y - 0.1, Y + 0.1, Y, Y - 0.2, Y + 0.2,
                     filename=str(tmp_path / "f.png"))
    v.plot_strategy_returns([0.01, -0.02, 0.005], filename=str(tmp_path / "g.png"))
    v.plot_arima_comparison([1.0, 2.0, 3.0], [1.1, 2.1, 2.9], [0.9, 2.2, 3.1],
                            filename=str(tmp_path / "h.png"))
    f = efficient_frontier([0.01, 0.02, 0.015], np.diag([0.04, 0.09, 0.05]), n_points=8,
                           device="cpu", dtype=torch.float64)
    plot_frontier(f, 0.001, filename=str(tmp_path / "i.png"))
    for name in "abcdefghi":
        assert os.path.getsize(tmp_path / f"{name}.png") > 1000


def test_torch_profiling_trace_and_step_timer(tmp_path, monkeypatch):
    """trace() writes a Chrome trace holding the block's operations;
    StepTimer times each step, waiting once for every CUDA device that
    holds a tensor of the result: a tensor, a tuple `(state, loss)` or a
    model tree (the tensors' devices are stubbed here, where there is no
    card). It takes JAX's `result_getter`."""
    with tprofiling.trace(str(tmp_path / "logdir")):
        torch.linalg.cholesky(torch.eye(8) * 2.0)
    with open(tmp_path / "logdir" / "trace.json") as fh:
        assert "cholesky" in fh.read()
    timer = tprofiling.StepTimer()
    for _ in range(2):
        with timer.step() as out:
            out["result"] = torch.ones(3) * 2
    assert len(timer.times) == 2 and timer.steps_per_s() > 0

    model = tgpr.GPR.create(tk.Exponential.create(device="cpu") + tk.White.create(device="cpu"),
                            1e-3)
    loss, state = torch.ones(()), {"step": torch.zeros(2), "moments": [torch.ones(2)]}
    on = {id(x): torch.device("cuda", 1) for x in tparams.tree_leaves(model)}
    on[id(loss)] = torch.device("cuda", 0)
    real = torch.Tensor.device
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: on.get(id(t), real.__get__(t))))
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    for result, want in (((state, loss), ["cuda:0"]), ((model, loss), ["cuda:0", "cuda:1"]),
                         (model, ["cuda:1"]), (state, []), (None, [])):
        synced.clear()
        with timer.step(result_getter=lambda r: r) as out:
            out["result"] = result
        assert [str(d) for d in synced] == want
    with timer.step():
        pass  # no result: nothing to wait for
    assert synced == [] and len(timer.times) == 8


def test_torch_cli_portfolio_matches_jax(market, short_fits, capsys, tmp_path):
    """`portfolio` over the five assets of make_market: the metrics JSONL
    of both CLIs, each strategy's cumulative return and Sharpe ratio
    within 1e-4 (tests/test_torch_e2e.py's float64 tolerance), and the
    allocation and backtest plots."""
    root, cfg = market
    args = ["portfolio", "--config", cfg, "--data-root", root, "--assets", *ASSETS,
            "--features", *FEATURES]
    out = {}
    for name, main, extra in (("jax", jcli.main, ["--x64"]), ("port", tcli.main, PORT)):
        metrics = str(tmp_path / f"{name}.jsonl")
        plots = tmp_path / f"plots_{name}"
        plots.mkdir()
        _run(main, args + ["--metrics", metrics, "--plots", str(plots), *extra], capsys)
        with open(metrics) as fh:
            out[name] = [json.loads(line) for line in fh]
        assert sorted(os.listdir(plots)) == sorted(
            [f"asset_allocations_{s}.png" for s in
             ("constant", "sharpe", "max_return", "min_volatility", "dynamic")]
            + ["portfolio_comparison.png", "trx_costs_comparison.png"])
    assert len(out["port"]) == len(out["jax"]) == 10
    for got, want in zip(out["port"], out["jax"]):
        assert (got["metric"], got["strategy"]) == (want["metric"], want["strategy"])
        assert abs(got["value"] - want["value"]) < 1e-4, (got, want)


def _tail(text, label):
    m = re.search(re.escape(label) + r"\s*\[([^\]]*)\]", text)
    return np.array([float(x) for x in m.group(1).split()])


def test_torch_cli_multi_input_step_4_matches_jax(market, capsys, monkeypatch):
    """`multi-input --step 4` on one asset. At MI_STEP4_MAXITER iterations:
    the printed next-day means at rtol 1e-4 (tests/test_torch_walk_forward.py's
    run_step_4 tolerance). Converged, at MI_MAXITER: each day's final loss
    at MI_STEP4_LOSS_RTOL of JAX's, the printed means at rtol 1e-4 of the
    JAX CLI's when its walk-forward takes the port's fitted models (JAX's
    `masked_predict_next` on them), and the actuals at rtol 1e-12."""
    root, cfg = market
    args = ["multi-input", "--config", cfg, "--data-root", root, "--ticker", ASSETS[2],
            "--features", *FEATURES, "--step", "4"]
    with monkeypatch.context() as mp:
        _cap_fits(mp, MI_STEP4_MAXITER)
        want = _run(jcli.main, args + ["--x64"], capsys)
        got = _run(tcli.main, args + PORT, capsys)
    np.testing.assert_allclose(_tail(got, "f_mean tail:"), _tail(want, "f_mean tail:"),
                               rtol=1e-4, atol=1e-8)

    runs = {}
    for name, wf in (("jax", jwalk_forward), ("port", twalk_forward)):
        def spy(*a, real=wf.batched_walk_forward, name=name, **kw):
            runs[name] = real(*a, **kw)
            return runs[name]

        monkeypatch.setattr(wf, "batched_walk_forward", spy)
    _cap_fits(monkeypatch, MI_MAXITER)
    want = _run(jcli.main, args + ["--x64"], capsys)
    got = _run(tcli.main, args + PORT, capsys)
    np.testing.assert_allclose(runs["port"].losses.numpy(), np.asarray(runs["jax"].losses),
                               rtol=MI_STEP4_LOSS_RTOL)
    np.testing.assert_allclose(_tail(got, "actual tail:"), _tail(want, "actual tail:"),
                               rtol=1e-12)
    assert "walk-forward day 5" in got

    def at_port_fit(X_full, Y_full, n_train, make_model, **kw):
        ref = runs["jax"]
        models = jax.tree.unflatten(
            jax.tree.structure(ref.models),
            [jnp.asarray(leaf.numpy()) for leaf in tparams.tree_leaves(runs["port"].models)])
        days = jnp.arange(ref.f_mean.shape[0])
        masks = (jnp.arange(X_full.shape[0])[None, :] < (n_train + days)[:, None]).astype(
            X_full.dtype)
        f_mean, f_var = jax.vmap(
            lambda m, msk, ni: jwalk_forward.masked_predict_next(m, X_full, Y_full, msk, ni)
        )(models, masks, n_train + days)
        return ref._replace(models=models, f_mean=f_mean, f_var=f_var)

    monkeypatch.setattr(jwalk_forward, "batched_walk_forward", at_port_fit)
    want = _run(jcli.main, args + ["--x64"], capsys)
    np.testing.assert_allclose(_tail(got, "f_mean tail:"), _tail(want, "f_mean tail:"),
                               rtol=1e-4, atol=1e-8)


def test_torch_cli_svgp_matches_jax(market, capsys, tmp_path):
    """`svgp` (8 inducing points, 60 Adam steps on one asset): every logged
    neg-ELBO and the final one at rtol 1e-8."""
    root, cfg = market
    args = ["svgp", "--config", cfg, "--data-root", root, "--ticker", ASSETS[0],
            "--inducing", "8", "--steps", "60"]
    out = {}
    for name, main, extra in (("jax", jcli.main, ["--x64"]), ("port", tcli.main, PORT)):
        metrics = str(tmp_path / f"{name}.jsonl")
        text = _run(main, args + ["--metrics", metrics, *extra], capsys)
        with open(metrics) as fh:
            logged = [json.loads(line)["value"] for line in fh]
        out[name] = logged + [float(re.search(r"final neg-ELBO (\S+)", text).group(1))]
    assert len(out["port"]) == 3
    np.testing.assert_allclose(out["port"][:2], out["jax"][:2], rtol=1e-8)
    assert out["port"][2] == out["jax"][2]  # printed to 4 decimals


def test_torch_cli_nuts_replays_jax(market, capsys, monkeypatch):
    """`nuts` (2 chains, 5 + 5 transitions) with the port's sampler drawing
    the JAX CLI's keys (jax.random.PRNGKey(seed), split per chain): the
    samples at rtol 1e-8 and the same printed summary."""
    root, cfg = market
    runs = {}
    for name, mod in (("jax", jinference), ("port", tinference)):
        real = mod.sample_nuts

        def recording(logp, model, key, *a, real=real, name=name, **kw):
            if name == "port":
                key = JaxKeys.split_from(jax.random.PRNGKey(0), kw["num_chains"])
            runs[name] = real(logp, model, key, *a, **kw)
            return runs[name]

        monkeypatch.setattr(mod, "sample_nuts", recording)
    args = ["nuts", "--config", cfg, "--data-root", root, "--ticker", ASSETS[1], "--warmup",
            "5", "--samples", "5", "--chains", "2"]
    want = _run(jcli.main, args + ["--x64"], capsys)
    got = _run(tcli.main, args + PORT, capsys)
    assert got == want
    for g, w in zip(tparams.tree_leaves(runs["port"][0]), jax.tree.leaves(runs["jax"][0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape), rtol=1e-8)


def test_torch_cli_single_asset_and_frontier_run(tmp_path, capsys):
    """`single-asset` (with --metrics, --plots, --profile and --debug-nans)
    and `frontier` (with --plots) on small markets in float64: their lines,
    records, PNGs and the trace; `--device cuda` raises without a GPU."""
    import chip_smoke as cs

    root = str(tmp_path)
    cs.make_single_asset_market(root, first="2023-01-02")
    names, _ = cs.make_frontier_market(root, "2023-06-01", "2024-05-31")
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"train": {"maxiter": 3}, "data": dict(
        train_start_date="2023-01-02", train_end_date="2024-05-10",
        test_start_date="2024-05-13", test_end_date="2024-05-17")}))
    plots = tmp_path / "plots"
    plots.mkdir()
    args = ["--config", str(cfg), "--data-root", root, *PORT]
    try:
        out = _run(tcli.main, ["single-asset", "--tickers", cs.SINGLE_ASSET_TICKER, "--horizon",
                               "5", "--metrics", str(tmp_path / "m.jsonl"), "--plots",
                               str(plots), "--profile", str(tmp_path / "trace"), "--debug-nans",
                               *args], capsys)
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert re.match(rf"{cs.SINGLE_ASSET_TICKER}: best kernel #\d train-MSE=", out)
    metrics = [json.loads(line)["metric"] for line in open(tmp_path / "m.jsonl")]
    assert metrics == ["ticker_train_time_s", "train_mse", "blend_alpha", "blend_beta"]
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 1000
    cfg.write_text(json.dumps({"train": {"maxiter": 3}, "data": cs.frontier_dates("1y")}))
    out = _run(tcli.main, ["frontier", "--assets", *names[:3], "--plots", str(plots), *args],
               capsys)
    assert "tangency weights:" in out and "tangency return=" in out
    assert sorted(os.listdir(plots)) == [f"{cs.SINGLE_ASSET_TICKER}_GPR_predict_combined.png",
                                         "efficient_frontier.png"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cuda'"):
            tcli.main(["multi-input", "--data-root", root])
