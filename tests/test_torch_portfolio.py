"""Port parity: the portfolio layer vs the JAX package, in float64.

Weights come from the same simplex solver on both sides (augmented
Lagrangian around L-BFGS with a zoom line search), held to atol 1e-4:
the inner solves stop at gtol/ftol, and the host-side line-search
arithmetic of the port rounds differently. Backtests of given weights are
numpy on both sides and agree to rounding. The Monte-Carlo estimate is
fed the JAX package's own draws (`jax.random` with its key schedule), so
both see the same samples and agree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portfoliooptgp_tpu.portfolio import Portfolio as JPortfolio
from portfoliooptgp_tpu.portfolio import PortfolioOptimizer as JOptimizer
from portfoliooptgp_tpu.portfolio import montecarlo as jmc
from portfoliooptgp_tpu_torch.portfolio import Portfolio as TPortfolio
from portfoliooptgp_tpu_torch.portfolio import PortfolioOptimizer as TOptimizer
from portfoliooptgp_tpu_torch.portfolio import montecarlo as tmc

# tiny matrices: one intra-op thread per test worker avoids oversubscribing the
# CPU when pytest-xdist runs several workers
torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64)
ASSETS = ["A", "B", "C", "D", "E"]
STRATEGIES = ["constant", "sharpe", "max_return", "min_volatility", "dynamic"]


def _predictions(seed=3):
    rng = np.random.default_rng(seed)
    preds = [rng.normal(0.001, 0.01, 5) for _ in ASSETS]
    pvars = [rng.uniform(2e-5, 2e-4, 5) for _ in ASSETS]
    actuals = [p + rng.normal(0, 0.005, 5) for p in preds]
    A = rng.normal(size=(5, 5))
    corr = np.corrcoef(A @ A.T + 5 * np.eye(5))
    return preds, pvars, actuals, corr


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_torch_strategy_evaluate_and_backtest_match_jax(strategy):
    preds, pvars, actuals, corr = _predictions()
    kw = dict(n_assets=5, lambda_l1=0.001, lambda_l2=0.001, lambda_tx=1e-5, if_tx_penalty=True)
    jport = JPortfolio(ASSETS, preds, pvars, JOptimizer(**kw), broker_fee=1e-5)
    tport = TPortfolio(ASSETS, preds, pvars, TOptimizer(**kw, **CPU64), broker_fee=1e-5, **CPU64)
    ev = dict(strategy_name=strategy, max_volatility=0.02, min_return=0.001,
              prob_threshold=0.55, isLogReturn=False, cov=corr)
    jw, jv = jport.evaluate_portfolio(**ev)
    tw, tv = tport.evaluate_portfolio(**ev)
    np.testing.assert_allclose(np.asarray(tw), np.asarray(jw), atol=1e-4)
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-8)

    jcml, jtrx = jport.backtest_portfolio(actuals, strategy, jw, jv)
    tcml, ttrx = tport.backtest_portfolio(actuals, strategy, jw, jv)
    np.testing.assert_allclose(tcml, jcml, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(ttrx, jtrx, rtol=1e-12, atol=1e-15)
    for key in ("cumulative_return", "cumulative_transaction_costs", "sharpe_ratio"):
        np.testing.assert_allclose(tport.last_summary[key], jport.last_summary[key], rtol=1e-12)
    np.testing.assert_allclose(tport.optimizer.previous_weights,
                               jport.optimizer.previous_weights, atol=1e-4)


def test_torch_sequential_and_batched_static_strategy_agree():
    """The per-day loop and the horizon solver give the same weights."""
    preds, pvars, _, _ = _predictions(seed=4)
    kw = dict(n_assets=5, lambda_l1=0.001, lambda_l2=0.001, lambda_tx=1e-5, **CPU64)
    out = []
    for batched in (True, False):
        port = TPortfolio(ASSETS, preds, pvars, TOptimizer(**kw), **CPU64)
        out.append(port.evaluate_portfolio("sharpe", isLogReturn=True, batched=batched)[0])
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(out[1]), atol=1e-6)


def test_torch_montecarlo_matches_jax_with_shared_draws():
    rng = np.random.default_rng(5)
    mu_a, mu_b = rng.normal(0, 0.01, 3), rng.normal(0.002, 0.01, 3)
    A = rng.normal(size=(3, 3)) * 0.01
    cov_a, cov_b = A @ A.T + 1e-5 * np.eye(3), np.diag(rng.uniform(1e-5, 1e-4, 3))
    n, seed = 4000, 7
    key_a, key_b = jax.random.split(jax.random.PRNGKey(seed))
    draws = (np.asarray(jax.random.normal(key_a, (n, 3), dtype=jnp.float64)),
             np.asarray(jax.random.normal(key_b, (n, 3), dtype=jnp.float64)))
    want = jmc.probability_a_greater_than_b_mvnorm(mu_a, cov_a, mu_b, cov_b, n, seed)
    got = tmc.probability_a_greater_than_b_mvnorm(mu_a, cov_a, mu_b, cov_b, n, seed,
                                                  draws=draws, **CPU64)
    assert got == want
    # its own generator: a different sample, the same probability within MC error
    own = tmc.probability_a_greater_than_b_mvnorm(mu_a, cov_a, mu_b, cov_b, n, seed, **CPU64)
    assert abs(own - want) < 4 * np.sqrt(want * (1 - want) / n) + 1e-3

    f64 = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    p = tmc.probability_a_greater_than_b_cdf(f64(0.01), f64(0.02), f64(0.0), f64(0.03))
    np.testing.assert_allclose(float(p), float(jmc.probability_a_greater_than_b_cdf(
        0.01, 0.02, 0.0, 0.03)), rtol=1e-12)


def test_torch_simplex_project_matches_jax(rng):
    from portfoliooptgp_tpu.portfolio.solver import simplex_project as jproject
    from portfoliooptgp_tpu_torch.portfolio.solver import simplex_project as tproject

    W = np.concatenate([rng.normal(0.2, 0.5, (6, 5)), np.full((1, 5), 0.2),
                        [[1.0, 0, 0, 0, 0], [3.0, -1.0, 0.5, 0.5, 2.0]]])
    for w in (W, W[0]):
        got = tproject(torch.as_tensor(w)).numpy()
        np.testing.assert_allclose(got, np.asarray(jproject(jnp.asarray(w))), rtol=1e-12,
                                   atol=1e-15)
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-12)
        assert got.min() >= 0.0


def test_torch_volatility_and_daily_getters_match_jax(rng):
    from portfoliooptgp_tpu.portfolio import returns as jreturns
    from portfoliooptgp_tpu_torch.portfolio import returns as treturns

    vols, w = rng.uniform(0.01, 0.05, (4, 5)), rng.dirichlet(np.ones(5), 4)
    np.testing.assert_allclose(
        treturns.Volatility(vols, w).calculate_portfolio_volatility(),
        jreturns.Volatility(vols, w).calculate_portfolio_volatility(), rtol=1e-15)
    actual = [list(rng.normal(0, 0.01, 4)) for _ in range(5)]
    jr, tr = jreturns.Return(actual, w, 1e-3), treturns.Return(actual, w, 1e-3)
    for name in ("get_daily_transaction_costs", "get_daily_portfolio_returns"):
        np.testing.assert_array_equal(getattr(tr, name)(), getattr(jr, name)())
        given = list(rng.normal(size=4))
        np.testing.assert_array_equal(getattr(tr, name)(given), getattr(jr, name)(given))


def test_torch_dynamic_strategy_probability_matches_jax_with_shared_draws():
    """The strategy's method on the JAX package's draws gives its estimate;
    with a mesh of one rank, the sharded estimate on the same draws gives
    it too."""
    from portfoliooptgp_tpu.portfolio.strategies import DynamicStrategy as JDynamic
    from portfoliooptgp_tpu_torch.portfolio.strategies import DynamicStrategy as TDynamic

    rng = np.random.default_rng(9)
    mu_a, mu_b = rng.normal(0.003, 0.01, 4), rng.normal(0, 0.01, 4)
    A, B = rng.normal(size=(4, 4)) * 0.01, rng.normal(size=(4, 4)) * 0.01
    cov_a, cov_b = A @ A.T, B @ B.T
    n, seed = 4000, 3
    key_a, key_b = jax.random.split(jax.random.PRNGKey(seed))
    draws = (np.asarray(jax.random.normal(key_a, (n, 4), dtype=jnp.float64)),
             np.asarray(jax.random.normal(key_b, (n, 4), dtype=jnp.float64)))
    want = JDynamic(decision="prob_threshold").probability_a_greater_than_b_mvnorm(
        mu_a, cov_a, mu_b, cov_b, n, seed)
    got = TDynamic(decision="prob_threshold").probability_a_greater_than_b_mvnorm(
        mu_a, cov_a, mu_b, cov_b, n, seed, draws=draws, **CPU64)
    # the same hits of the same draws (JAX averages them in float32 here)
    assert got * n == round(want * n) and 0.0 < got < 1.0
    from portfoliooptgp_tpu_torch.parallel.mesh import make_mesh

    sharded = TDynamic(decision="prob_threshold", mesh=make_mesh(device="cpu"))
    assert sharded.probability_a_greater_than_b_mvnorm(mu_a, cov_a, mu_b, cov_b, n, seed,
                                                       draws=draws, **CPU64) == got
