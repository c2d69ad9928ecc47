"""Port parity: the multi-input pipeline's steps 1–4 and the restart trainers.

Float64 on the CPU. The pipeline's steps are held against the JAX
package's float64 run of `MultiInputGPR` on the `make_market` market
(tests/goldens_torch/multi_input_poly.json, written by
tools/make_torch_goldens.py --multi-input with `trainer._fast_default`
patched to True, the branch a GPU takes; the port takes it here with the
same patch): the default pair and (Polynomial, Exponential), fixed and
trained likelihood, steps 1, 2, 3 and run_step_4(batched=False). One case
also runs live against `JMultiInputGPR` on the CPU's plain branch. The
trainers (`lbfgs.fit_batched`, `train_likelihood`, `train_restarts`,
`train_restarts_fused`) run live against JAX on a 30-row series.

Tolerances: the two packages run the same L-BFGS rules on the same
float64 losses, so final losses agree to rtol 1e-6 and means, variances
and MSEs to rtol 1e-4, as tests/test_torch_walk_forward.py holds the
walk-forward (the runs stop at ftol; rounding-level gradient differences
move the last step). Where restarts tie (final losses within
chip_smoke.MI_TIE_RTOL), the winner is held to the tied set only: step 3
with the default pair and trained likelihood has restarts 0 and 1 within
4e-9 of each other, and the port picks the other one."""

import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from benchmarks.bench_portfolio_e2e import DATES, FEATURES, make_market
from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.models import gpr as jgpr
from portfoliooptgp_tpu.params import positive as j_positive
from portfoliooptgp_tpu.pipelines import MultiInputGPR as JMultiInputGPR
from portfoliooptgp_tpu.pipelines.multi_input import remove_random_points as jremove
from portfoliooptgp_tpu.train import lbfgs as jlbfgs
from portfoliooptgp_tpu.train import trainer as jtrainer
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.models import gpr as tgpr
from portfoliooptgp_tpu_torch.pipelines import MultiInputGPR as TMultiInputGPR
from portfoliooptgp_tpu_torch.pipelines.multi_input import remove_random_points as tremove
from portfoliooptgp_tpu_torch.train import lbfgs as tlbfgs
from portfoliooptgp_tpu_torch.train import trainer as ttrainer

# tiny matrices: one intra-op thread per test worker avoids oversubscribing the
# CPU when pytest-xdist runs several workers
torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def market():
    with tempfile.TemporaryDirectory() as root:
        make_market(root)
        yield root


@pytest.fixture(scope="module")
def goldens():
    with open(cs.multi_input_goldens_path()) as fh:
        return json.load(fh)


def _series(n=30, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 6, n)
    X = np.column_stack([np.sin(t) + 0.1 * rng.normal(size=n), t])
    Y = (np.sin(t) + 0.1 * rng.normal(size=n))[:, None]
    return X, Y


def _close_constrained(tmodel, jmodel, rtol=1e-4):
    for got, want in zip(tparams.tree_leaves(tmodel), jax.tree.leaves(jmodel)):
        np.testing.assert_allclose(tparams.positive(got).detach().numpy().reshape(-1),
                                   np.asarray(j_positive(want)).reshape(-1),
                                   rtol=rtol, atol=1e-9)


def test_torch_remove_random_points_matches_jax():
    rng = np.random.default_rng(1)
    X, Y = rng.normal(size=(57, 3)), rng.normal(size=(57, 1))
    for frac, seed in ((0.2, 0), (0.1, 5), (0.0, 2)):
        for got, want in zip(tremove(X, Y, frac, seed), jremove(X, Y, frac, seed)):
            np.testing.assert_array_equal(got, np.asarray(want))


def test_torch_polynomial_on_empty_slice_matches_jax():
    """composite_kernel(1, Polynomial, Exponential): the Polynomial acts on
    no columns, so its factor is offset**degree (X[:, 0:0] @ X2[:, 0:0].T
    is zero) — steps 1–2's kernel on a market whose covariates all fail
    the gate."""
    X = np.linspace(0.0, 3.0, 9)[:, None]
    jK = jk.composite_kernel(1, jk.Polynomial, jk.Exponential).K(jnp.asarray(X))
    tkern = tk.composite_kernel(1, tk.Polynomial, tk.Exponential, **CPU64)
    tK = tkern.K(torch.tensor(X))[0]
    np.testing.assert_allclose(tK.numpy(), np.asarray(jK), rtol=1e-14, atol=0)
    poly = tkern.terms[0]
    torch.testing.assert_close(poly.K(torch.tensor(X))[0],
                               torch.full((9, 9), float(poly.offset) ** poly.degree,
                                          dtype=torch.float64), rtol=1e-15, atol=0)


def _restart_models(pkg, v0s, **o):
    return [pkg[0].GPR.create(pkg[1].composite_kernel(2, **o), noise_variance=v) for v in v0s]


def test_torch_fit_batched_matches_jax():
    """Each restart its own L-BFGS run with its own stopping rule."""
    X, Y = _series()
    v0s = (1e-3, 1e-1, 1.0)
    jm = jlbfgs.stack_pytrees(_restart_models((jgpr, jk), v0s))
    jres = jlbfgs.fit_batched(lambda m: jgpr.neg_log_marginal_likelihood(m, jnp.asarray(X),
                                                                         jnp.asarray(Y)),
                              jm, maxiter=40)
    tm = tlbfgs.stack_pytrees(_restart_models((tgpr, tk), v0s, **CPU64))
    tX, tY = torch.tensor(X), torch.tensor(Y)
    tres = tlbfgs.fit_batched(lambda m: tgpr.neg_log_marginal_likelihood(m, tX, tY)[0], tm,
                              maxiter=40)
    np.testing.assert_allclose(tres.loss.numpy(), np.asarray(jres.loss), rtol=1e-6)
    np.testing.assert_array_equal(tres.iters.numpy(), np.asarray(jres.iters))
    np.testing.assert_array_equal(tres.converged.numpy(), np.asarray(jres.converged))
    _close_constrained(tres.params, jres.params)


@pytest.mark.parametrize("fast", [True, False], ids=["fused", "plain"])
def test_torch_train_likelihood_matches_jax(fast):
    """Both branches: the batched L-BFGS on the routed NLL (fast) and the
    restart-by-restart fit_batched (plain); the winner by final loss."""
    X, Y = _series(seed=1)
    jt = jtrainer.train_likelihood(jnp.asarray(X), jnp.asarray(Y), jk.composite_kernel(2),
                                   maxiter=50, fast=fast)
    tt = ttrainer.train_likelihood(torch.tensor(X), torch.tensor(Y),
                                   tk.composite_kernel(2, **CPU64), maxiter=50, fast=fast)
    np.testing.assert_allclose(tt.loss, float(jt.loss), rtol=1e-6)
    np.testing.assert_allclose(tt.mse, float(jt.mse), rtol=1e-4)
    assert int(tt.iters) == int(jt.iters)
    _close_constrained(tt.model, jt.model)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_torch_train_restarts_matches_jax(fused):
    X, Y = _series(seed=1)
    v0s = (1e-3, 1e-1, 1.0)
    jX, jY, tX, tY = jnp.asarray(X), jnp.asarray(Y), torch.tensor(X), torch.tensor(Y)
    jm = jlbfgs.stack_pytrees(_restart_models((jgpr, jk), v0s))
    tm = tlbfgs.stack_pytrees(_restart_models((tgpr, tk), v0s, **CPU64))
    if fused:
        jbest, jloss, jlosses = jtrainer.train_restarts_fused(jX, jY, jm, maxiter=100)
        tbest, tloss, tlosses = ttrainer.train_restarts_fused(tX, tY, tm, maxiter=100)
    else:
        jbest, jloss, jlosses = jtrainer.train_restarts(
            lambda m: jgpr.neg_log_marginal_likelihood(m, jX, jY), jm, maxiter=100)
        tbest, tloss, tlosses = ttrainer.train_restarts(
            lambda m: tgpr.neg_log_marginal_likelihood(m, tX, tY)[0], tm, maxiter=100)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=1e-6)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    _close_constrained(tbest, jbest)


F_MEAN_ATOL = 1e-8


def _mse_atol(mse):
    """The MSE's absolute tolerance that f_mean's atol allows: residuals that
    each move by at most F_MEAN_ATOL move their mean square by at most
    2·√mse·F_MEAN_ATOL + F_MEAN_ATOL² (Cauchy–Schwarz). An interpolating fit
    (step 3, trained likelihood: MSE ~7e-12) has only rounding noise there."""
    return 2 * np.sqrt(np.max(mse)) * F_MEAN_ATOL + F_MEAN_ATOL ** 2


def _assert_case_matches(c, g):
    if "kept" in g:
        assert c["kept"] == g["kept"]
    assert [f["n"] for f in c["fits"]] == [f["n"] for f in g["fits"]]
    for f, gf in zip(c["fits"], g["fits"]):
        np.testing.assert_allclose(f["loss"], gf["loss"], rtol=1e-6)
        np.testing.assert_allclose(f["noise_variance"], gf["noise_variance"], rtol=1e-4)
        np.testing.assert_allclose(f["mse"], gf["mse"], rtol=1e-4, atol=_mse_atol(gf["mse"]))
        if gf["restart_losses"] is not None:
            assert f["winner"] in cs._tie_set(gf)
            np.testing.assert_allclose(f["restart_losses"], gf["restart_losses"], rtol=1e-6)
    for key in ("f_mean", "f_var", "mse", "mse_all", "mse_removed"):
        if key in g:
            atol = (F_MEAN_ATOL if key == "f_mean" else _mse_atol(g[key]) if key == "mse"
                    else 1e-12)
            np.testing.assert_allclose(c[key], g[key], rtol=1e-4, atol=atol)


@pytest.mark.parametrize("name", list(cs.MULTI_INPUT_CASES))
def test_torch_multi_input_step_matches_jax(name, market, goldens, monkeypatch):
    monkeypatch.setattr(ttrainer, "_fast_default", lambda X: True)
    _, q = cs.run_multi_input(market, [name], **CPU64)
    _assert_case_matches(q["cases"][name], goldens["cases"][name])


def test_torch_multi_input_step_1_matches_live_jax(market):
    """Step 1, Polynomial pair, σ² fixed, on both packages' CPU default
    (the plain NLL), live."""
    kw = dict(ticker=cs.MULTI_INPUT_TICKER, features=FEATURES, data_root=market,
              threshold=0.30, removal_percentage=0.2, maxiter=cs.MULTI_INPUT_MAXITER,
              isFixedLikelihood=True, **DATES)
    jr = JMultiInputGPR(kernel_pairs=[(jk.Polynomial, jk.Exponential)], **kw).run_step_1()
    tr = TMultiInputGPR(kernel_pairs=cs.multi_input_pairs()["poly"], **kw, **CPU64).run_step_1()
    assert tr["kept_features"] == jr["kept_features"] and tr["X"].shape == jr["X"].shape
    np.testing.assert_allclose(tr["f_mean"].numpy(), np.asarray(jr["f_mean"]), rtol=1e-4,
                               atol=1e-8)
    np.testing.assert_allclose(tr["f_var"].numpy(), np.asarray(jr["f_var"]), rtol=1e-4)
    np.testing.assert_allclose(tr["mse"], jr["mse"], rtol=1e-4)
    _close_constrained(tr["model"], jr["model"])
