"""The port's single-asset slice against the JAX package: the Periodic,
Linear and Polynomial kernels, the three mean functions, the router's tier
names and values for the 8-entry menu, the blend, and the pipeline's
float32 routing. The menu trainer and `StockPredictor.run_ticker` end to
end are held against JAX in tests/test_torch_trainer.py and
tests/test_torch_single_asset_pipeline.py (each costs the JAX side a
compile of its L-BFGS loop per menu entry, so they get files of their own).

Inputs come from numpy seeds or from `chip_smoke.make_single_asset_market`;
parameters cross over with `params.from_jax_leaves`. Tolerances, with
their reasons:
- kernels and means, float64: rtol 1e-12 (the same formulas);
- the router on the fused_general_sum and blocked tiers, float32: values
  rtol 3e-3 and gradients normalized atol 2e-2, the tolerances of the JAX
  package's own router checks (tools/smoke_tpu.py);
- the blend fit, float64: the two L-BFGS runs follow the same rules but
  round differently and stop at ftol, so α and β agree to atol 1e-6;
  the upsampling to rtol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import make_single_asset_market
from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.models import gpr as jgpr
from portfoliooptgp_tpu.pipelines import blend as jblend
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.models import gpr as tgpr
from portfoliooptgp_tpu_torch.pipelines import StockPredictor as TStockPredictor
from portfoliooptgp_tpu_torch.pipelines import blend as tblend

# one intra-op thread per test worker avoids oversubscribing the CPU when
# pytest-xdist runs several workers
torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# name -> make(kernel module, create kwargs); identical structure in both
KERNELS = {
    "periodic_se": lambda k, o: k.Periodic.create(k.SquaredExponential.create(1.3, 0.7, **o),
                                                 period=5.0, **o),
    "periodic_matern12": lambda k, o: k.Periodic.create(k.Matern12.create(0.8, 1.9, **o),
                                                       period=3.0, **o),
    "periodic_ard": lambda k, o: k.Periodic.create(
        k.SquaredExponential.create(1.1, [0.6, 1.4], **o), period=2.5, **o),
    "linear": lambda k, o: k.Linear.create(0.4, **o),
    "polynomial": lambda k, o: k.Polynomial.create(2.0, 0.3, 1.5, **o),
    "menu_6": lambda k, o: (k.Exponential.create(**o)
                            + k.Periodic.create(k.SquaredExponential.create(**o), **o)
                            + k.Linear.create(**o)),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_torch_periodic_linear_kernels_match_jax(name):
    rng = np.random.default_rng(0)
    D = 2 if name == "periodic_ard" else 1
    X = rng.uniform(0, 20, (30, D))
    X2 = rng.uniform(0, 20, (11, D))
    jker = KERNELS[name](jk, {})
    tker = tparams.from_jax_leaves(KERNELS[name](tk, CPU64), _leaves(jker))
    tX, tX2 = torch.tensor(X), torch.tensor(X2)
    np.testing.assert_allclose(tker.K(tX)[0].numpy(), np.asarray(jker.K(X)), rtol=1e-12)
    np.testing.assert_allclose(tker.K(tX, tX2)[0].numpy(), np.asarray(jker.K(X, X2)),
                               rtol=1e-12)
    np.testing.assert_allclose(tker.Kdiag(tX)[0].numpy(), np.asarray(jker.Kdiag(X)),
                               rtol=1e-12)


MEANS = {
    "constant": (lambda m, o: m.ConstantMean.create(0.7, **o), 1),
    "linear": (lambda m, o: m.LinearMean.create([0.5, -1.2], 0.3, **o), 2),
    "polynomial": (lambda m, o: m.PolynomialMean.create(2, [0.1, -0.4, 0.02], **o), 2),
}


@pytest.mark.parametrize("name", sorted(MEANS))
def test_torch_mean_functions_match_jax(name):
    build, D = MEANS[name]
    X = np.random.default_rng(1).uniform(-3, 3, (25, D))
    jmean = build(jk, {})
    tmean = tparams.from_jax_leaves(build(tk, CPU64), _leaves(jmean))
    got = tmean(torch.tensor(X))
    assert got.shape == (1, 25, 1)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jmean(X)), rtol=1e-12)


def _stacked_menu_pair(i, dtype):
    jm = jgpr.GPR.create(jk.default_kernel_menu()[i], 1e-5)
    jm = jax.tree.map(lambda x: jnp.asarray(x, dtype)[None], jm)
    tdt = torch.float32 if dtype == jnp.float32 else torch.float64
    tm = tparams.from_jax_leaves(
        tgpr.GPR.create(tk.default_kernel_menu(device="cpu", dtype=tdt)[i], 1e-5),
        _leaves(jm))
    return jm, tm


@pytest.mark.parametrize("n", [40, 174, 600])
def test_torch_menu_tiers_match_jax(n):
    """All 8 menu entries at the monthly, weekly and a blocked-window N,
    float32: the port's router names the JAX router's tier."""
    X = np.arange(n, dtype=np.float32)[:, None] * 1.4
    Y = np.random.default_rng(n).normal(size=(n, 1)).astype(np.float32)
    for i in range(8):
        jm, tm = _stacked_menu_pair(i, jnp.float32)
        want = jgpr.nll_tier(jm, jnp.asarray(X), jnp.asarray(Y))
        got = tgpr.nll_tier(tm, torch.tensor(X), torch.tensor(Y))
        assert got == want, (i, got, want)


def _assert_grads(got, want, atol):
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = max(float(np.max(np.abs(w))), 1.0)
        np.testing.assert_allclose(np.asarray(g) / scale, w / scale, rtol=0, atol=atol)


@pytest.mark.parametrize("i,n,tier", [(5, 40, "fused_general_sum"),
                                      (6, 40, "fused_general_sum"),
                                      (4, 600, "blocked")])
def test_torch_router_menu_tiers_match_jax_xla(i, n, tier):
    """Value and gradients of every raw leaf through the port's router
    (float32, CPU: the plain versions of the kernels) against the JAX
    router's XLA tier in float32. Menu entries 6 and 7 carry the Periodic(SE)
    and Linear atoms; the inputs are scaled day indices."""
    rng = np.random.default_rng(i)
    X = (np.arange(n, dtype=np.float32)[:, None] * (30.0 / n)).astype(np.float32)
    Y = rng.normal(size=(n, 1)).astype(np.float32)
    jm, tm = _stacked_menu_pair(i, jnp.float32)
    jm = jax.tree.map(lambda x: x + jnp.asarray(rng.normal(0, 0.3, x.shape), x.dtype), jm)
    jm = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.full_like(x, -2.0) if "likelihood" in jax.tree_util.keystr(p) else x, jm)
    tm = tparams.from_jax_leaves(tm, _leaves(jm))
    jX, jY = jnp.asarray(X), jnp.asarray(Y)
    jval = jgpr.batched_neg_log_marginal_likelihood(jm, jX, jY, fast=False)
    jgrad = jax.tree.leaves(jax.grad(lambda m: jnp.sum(
        jgpr.batched_neg_log_marginal_likelihood(m, jX, jY, fast=False)))(jm))
    tm = tparams.tree_map(lambda x: x.requires_grad_(True), tm)
    assert tgpr.nll_tier(tm, torch.tensor(X), torch.tensor(Y)) == tier
    tval = tgpr.batched_neg_log_marginal_likelihood(tm, X, Y, device="cpu")
    tval.sum().backward()
    assert tgpr.DISPATCH_EVENTS[-1]["tier"] == tier
    np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval), rtol=3e-3)
    _assert_grads([x.grad.numpy() for x in tparams.tree_leaves(tm)], jgrad, atol=2e-2)


def test_torch_optimize_blend_weights_matches_jax():
    rng = np.random.default_rng(5)
    y = rng.normal(size=60)
    d = y + 0.3 * rng.normal(size=60)
    w = y + 0.6 * rng.normal(size=60)
    m = rng.normal(size=60)
    want = jblend.optimize_blend_weights(y, d, w, m, lambda_=0.01)
    got = tblend.optimize_blend_weights(*(torch.tensor(v) for v in (y, d, w, m)), lambda_=0.01)
    np.testing.assert_allclose([got.alpha, got.beta], [want.alpha, want.beta], atol=1e-6)
    assert 0.0 < got.alpha < 1.0 and got.alpha + got.beta <= 1.0


def test_torch_upsample_matches_jax():
    """Coarse dates off the daily grid (Sunday labels) stay NaN in both."""
    xd = np.arange(0.0, 40.0)
    xd = xd[(xd % 7) < 5]
    for xc in (xd[4::5], xd[4::5] + 2.0):
        v = np.cos(xc)
        want = np.asarray(jblend.upsample_predictions(xd[:, None], xc[:, None], v[:, None]))
        got = tblend.upsample_predictions(torch.tensor(xd[:, None]), torch.tensor(xc[:, None]),
                                          torch.tensor(v[:, None]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_torch_run_ticker_float32_daily_takes_blocked_tier(tmp_path):
    """Float32 on the CPU with `fast=True`: a daily history of 593 rows
    (padded 640) goes through the blocked tier (the plain panel factor
    here, the CUDA kernel on a card), weekly and monthly through the fused
    tiers. Two menu entries, maxiter 3."""
    root = make_single_asset_market(str(tmp_path), seed=5)
    dates = dict(train_start_date="2022-01-03", train_end_date="2024-05-10",
                 test_start_date="2024-05-13", test_end_date="2024-05-17")
    menu = [tk.default_kernel_menu(device="cpu")[i] for i in (0, 5)]
    tgpr.DISPATCH_EVENTS.clear()
    res = TStockPredictor(["TGT"], kernel_menu=menu, data_root=root, maxiter=3,
                          device="cpu", dtype=torch.float32, fast=True,
                          **dates).run_ticker("TGT")
    n_daily = res.timeframes["d"].X.shape[0]
    assert 512 < n_daily <= 640
    assert res.timeframes["d"].menu.tiers == ["blocked", "blocked"]
    assert res.timeframes["w"].menu.tiers == ["fused_stationary", "fused_general_sum"]
    assert res.timeframes["m"].menu.tiers == ["fused_stationary", "fused_general_sum"]
    assert {"tier": "blocked", "n": n_daily, "batch": 1} in tgpr.DISPATCH_EVENTS
    assert res.f_mean.dtype == torch.float32
    assert np.all(np.isfinite(res.f_mean.numpy()))
