"""The port's config-5 frontier pipeline (`run_frontier_pipeline`) against
the JAX package's, end to end in float64 on the CPU, on a small slice of
`chip_smoke.make_frontier_market`: 4 assets over 2024-03-01..2024-05-31
(66 return rows), rank 3, maxiter 30, from JAX's W₀ (carried by
`params.from_jax_leaves`: torch cannot repeat `jax.random.normal`).

Rank 3 of 4 outputs leaves B = WWᵀ + I with no tied eigenvalues at the
start, so safe_eigh's VJP does not depend on the eigenbasis (at tied
eigenvalues it does, in both packages: tests/test_torch_icm.py) and the
two L-BFGS runs follow the same path up to rounding. Tolerances: the final
NLL rtol 1e-8, the fitted leaves, μ and Σ rtol 1e-4 (L-BFGS stops at ftol,
and the lengthscale is weakly identified), the frontier's returns and
volatilities atol 1e-6 and its weights atol 1e-3 (each point an L-BFGS
solve stopped at ftol). With `use_nuts=True` the port's NUTS replays the
JAX keys (tests/jax_replay.py) and the averaged moments agree at rtol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import make_frontier_market
from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.data.handler import DataHandler as JDataHandler
from portfoliooptgp_tpu.models import icm as jicm
from portfoliooptgp_tpu.pipelines.frontier_pipeline import run_frontier_pipeline as jrun
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.data.handler import DataHandler as TDataHandler
from portfoliooptgp_tpu_torch.models import icm as ticm
from portfoliooptgp_tpu_torch.pipelines import run_frontier_pipeline as trun

torch.set_num_threads(1)

FIRST, LAST = "2024-03-01", "2024-05-31"
DATES = dict(train_start_date=FIRST, train_end_date=LAST, test_start_date=LAST,
             test_end_date=LAST)
ARGS = dict(rank=3, maxiter=30, noise_variance=1e-2, seed=0)


@pytest.fixture(scope="module")
def market(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frontier"))
    names, _ = make_frontier_market(root, FIRST, LAST)
    return root, names[:4]


def test_torch_process_data_unnormalized_matches_jax(market):
    root, names = market
    jX, jY, *_ = JDataHandler(data_root=root, **DATES).process_data(
        "Stocks", names[1], "d", normalize=False, normalize_x=False)
    tX, tY, *_ = TDataHandler(data_root=root, device="cpu", dtype=torch.float64,
                              **DATES).process_data("Stocks", names[1], "d", normalize=False,
                                                    normalize_x=False)
    assert tX.shape == jX.shape == (66, 1)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=1e-15)
    np.testing.assert_allclose(tY.numpy(), np.asarray(jY), rtol=1e-12)


def test_torch_frontier_pipeline_float64_matches_jax(market):
    root, names = market
    want = jrun(names, JDataHandler(data_root=root, **DATES), **ARGS)
    jm0 = jicm.ICMGPR.create(jk.SquaredExponential.create(), num_outputs=4, rank=3,
                             noise_variance=1e-2, seed=0)
    m0 = tparams.from_jax_leaves(
        ticm.ICMGPR.create(tk.SquaredExponential.create(device="cpu", dtype=torch.float64), 4,
                           rank=3),
        [np.asarray(x) for x in jax.tree.leaves(jm0)])
    got = trun(names, TDataHandler(data_root=root, device="cpu", dtype=torch.float64, **DATES),
               model0=m0, device="cpu", dtype=torch.float64, **ARGS)
    jnll = float(jicm.neg_log_marginal_likelihood_chol(
        want.model, *_scaled_inputs(root, names)))
    np.testing.assert_allclose(got.fit.loss, jnll, rtol=1e-8)
    for g, w in zip(tparams.tree_leaves(got.model), jax.tree.leaves(want.model)):
        np.testing.assert_allclose(g.numpy().reshape(np.shape(w)), w, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.mu, want.mu, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(got.Sigma, want.Sigma, rtol=1e-4, atol=1e-12)
    f, fw = got.frontier, want.frontier
    np.testing.assert_allclose(f.target_returns, fw.target_returns, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(f.returns, fw.returns, atol=1e-6)
    np.testing.assert_allclose(f.volatilities, fw.volatilities, atol=1e-6)
    np.testing.assert_allclose(f.weights, fw.weights, atol=1e-3)
    np.testing.assert_allclose(f.tangency_weights, fw.tangency_weights, atol=1e-3)
    np.testing.assert_allclose(f.tangency_return, fw.tangency_return, atol=1e-6)
    np.testing.assert_allclose(f.tangency_volatility, fw.tangency_volatility, atol=1e-6)


def _scaled_inputs(root, names):
    """The JAX pipeline's (Xs, Y) on this market."""
    dh = JDataHandler(data_root=root, **DATES)
    cols = [np.asarray(dh.process_data("Stocks", a, "d", normalize=False,
                                       normalize_x=False)[1]).reshape(-1) for a in names]
    X = np.asarray(dh.process_data("Stocks", names[0], "d", normalize=False,
                                   normalize_x=False)[0])
    return (X - X.mean()) / (X.std() + 1e-12), np.column_stack(cols)


def test_torch_frontier_pipeline_nuts_matches_jax(market):
    """`use_nuts=True` against the JAX package: 2 chains, 10 + 10
    transitions, depth 4, NUTS drawing from JAX's PRNGKey(0) replayed
    (tests/jax_replay.JaxKeys), float64. maxiter 5: the two short L-BFGS
    runs agree to ~1e-10 (at maxiter 30 they stop at ftol 1e-4 apart, see
    above), so the chains start from the same point. μ and Σ, averaged over
    the thinned draws, at rtol 1e-6."""
    from jax_replay import JaxKeys

    root, names = market
    args = dict(ARGS, maxiter=5, use_nuts=True, nuts_warmup=10, nuts_samples=10,
                nuts_chains=2, nuts_max_depth=4)
    want = jrun(names, JDataHandler(data_root=root, **DATES), **args)
    jm0 = jicm.ICMGPR.create(jk.SquaredExponential.create(), num_outputs=4, rank=3,
                             noise_variance=1e-2, seed=0)
    m0 = tparams.from_jax_leaves(
        ticm.ICMGPR.create(tk.SquaredExponential.create(device="cpu", dtype=torch.float64), 4,
                           rank=3),
        [np.asarray(x) for x in jax.tree.leaves(jm0)])
    got = trun(names, TDataHandler(data_root=root, device="cpu", dtype=torch.float64, **DATES),
               model0=m0, nuts_source=JaxKeys.split_from(jax.random.PRNGKey(0), 2),
               device="cpu", dtype=torch.float64, **args)
    assert got.nuts_draws == want.nuts_draws == 20
    np.testing.assert_allclose(got.mu, want.mu, rtol=1e-6)
    np.testing.assert_allclose(got.Sigma, want.Sigma, rtol=1e-6)
