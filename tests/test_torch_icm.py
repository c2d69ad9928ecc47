"""The port's ICM model (models/icm.py), `safe_eigh` (ops/linalg.py) and the
efficient frontier (portfolio/frontier.py) against the JAX package, on the
CPU with numpy-seeded inputs; parameters cross over with
`params.from_jax_leaves`.

Tolerances, with their reasons:
- float64 (n = 30, p = 3, tests/test_icm_frontier.py's data): NLLs,
  predictions and moments rtol 1e-9, gradients with respect to every model
  leaf rtol 1e-7 (the same formulas; eigh and Cholesky round differently
  in the last digits, and only basis-free quantities are compared, since
  torch and JAX may return eigenvectors of opposite sign);
- `safe_eigh` in float64 at a B with tied eigenvalues: eigenvalues and the
  VJP of basis-free functions rtol 1e-10;
- the Cholesky NLL in float32, fused tier (N = 200) and hinv tier
  (N = 1100, where JAX joins its inverse at Precision.HIGH and the port in
  full fp32): values rtol 2e-5; leaf gradients normalized atol 2e-2, the
  float32 gradient tolerance of tools/smoke_tpu.py (the lengthscale
  gradient is a float32 sum that cancels: at N = 1100 each float32 side
  lies ~0.2% from the float64 value, on opposite sides);
- the efficient frontier in float64: each point is an L-BFGS solve that
  stops at ftol, so returns and volatilities atol 1e-6 and weights atol
  1e-3 (the problem is flat along the frontier's weights near the ends).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.models import icm as jicm
from portfoliooptgp_tpu.ops.linalg import safe_eigh as jsafe_eigh
from portfoliooptgp_tpu.params import positive_inv as jpositive_inv
from portfoliooptgp_tpu.portfolio.frontier import efficient_frontier as jfrontier
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.models import icm as ticm
from portfoliooptgp_tpu_torch.ops.linalg import safe_eigh as tsafe_eigh
from portfoliooptgp_tpu_torch.portfolio.frontier import efficient_frontier as tfrontier

torch.set_num_threads(1)


def _data(n, p, seed):
    """tests/test_icm_frontier.make_mo_data: a shared sine with loadings."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, (n, 1)), 0)
    loadings = rng.normal(size=(1, p)) * 0.8 + 1.0
    return X, np.sin(X) @ loadings + 0.1 * rng.normal(size=(n, p))


def _models(p, rank, dtype, distinct=True, kernel="SquaredExponential", **create):
    """The same ICM model in both packages (κ spread when `distinct`)."""
    jm = jicm.ICMGPR.create(getattr(jk, kernel).create(1.2, 0.8), num_outputs=p, rank=rank,
                            noise_variance=0.1, w_scale=0.5, **create)
    if distinct:
        jm = dataclasses.replace(jm, raw_kappa=jpositive_inv(jnp.linspace(0.5, 2.0, p)))
    jm = jax.tree.map(lambda x: jnp.asarray(x, dtype), jm)
    tdt = torch.float32 if dtype == jnp.float32 else torch.float64
    tm = tparams.from_jax_leaves(
        ticm.ICMGPR.create(getattr(tk, kernel).create(device="cpu", dtype=tdt), p, rank=rank),
        [np.asarray(x) for x in jax.tree.leaves(jm)])
    return jm, tm


def _grads(fn, tm, *args):
    leaves = [x.detach().clone().requires_grad_(True) for x in tparams.tree_leaves(tm)]
    value = fn(tparams.tree_replace(tm, leaves), *args)
    return value.detach(), [g.numpy() for g in torch.autograd.grad(value, leaves)]


def test_torch_icm_leaf_order():
    """from_jax_leaves carries the ICM model leaf for leaf: kernel,
    likelihood, W, raw_kappa (the module docstring's order)."""
    jm, tm = _models(4, 2, jnp.float64)
    shapes = [tuple(x.shape) for x in tparams.tree_leaves(tm)]
    assert shapes == [(1,), (1,), (1,), (1, 4, 2), (1, 4)]
    np.testing.assert_array_equal(tm.W[0].numpy(), np.asarray(jm.W))
    np.testing.assert_allclose(tm.B.numpy(), np.asarray(jm.B), rtol=1e-15)


@pytest.mark.parametrize("name", ["neg_log_marginal_likelihood",
                                  "neg_log_marginal_likelihood_chol"])
def test_torch_icm_nll_float64_matches_jax(name):
    X, Y = _data(30, 3, 0)
    jm, tm = _models(3, 2, jnp.float64)
    jval, jgrad = jax.value_and_grad(lambda m: getattr(jicm, name)(m, X, Y))(jm)
    tval, tgrads = _grads(getattr(ticm, name), tm, torch.tensor(X), torch.tensor(Y))
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-9)
    for g, w in zip(tgrads, jax.tree.leaves(jgrad)):
        np.testing.assert_allclose(g.reshape(np.shape(w)), w, rtol=1e-7, atol=1e-10)


def test_torch_icm_nll_gradients_finite_at_degenerate_b():
    """At the uniform-κ start B has p − rank tied eigenvalues: both NLLs'
    gradients stay finite, and those of the kernel and likelihood leaves
    equal JAX's. The W and κ gradients pass through safe_eigh's VJP, which
    zeroes the tied block's 1/(λ_j − λ_i) terms: there the result depends on
    the basis eigh picks inside the tied eigenspace, in the JAX package as
    in the port (both lie ~10% from a finite difference at this point), so
    they are only held finite (ROADMAP.md queue 3)."""
    X, Y = _data(30, 5, 1)
    jm, tm = _models(5, 2, jnp.float64, distinct=False)
    for name in ("neg_log_marginal_likelihood", "neg_log_marginal_likelihood_chol"):
        jgrad = jax.grad(lambda m: getattr(jicm, name)(m, X, Y))(jm)
        _, tgrads = _grads(getattr(ticm, name), tm, torch.tensor(X), torch.tensor(Y))
        assert all(np.all(np.isfinite(g)) for g in tgrads), name
        for g, w in list(zip(tgrads, jax.tree.leaves(jgrad)))[:3]:
            np.testing.assert_allclose(g.reshape(np.shape(w)), w, rtol=1e-7, atol=1e-10)


def test_torch_safe_eigh_float64_degenerate():
    """λ and the VJP of basis-free functions (Σ log λ and yᵀ A⁻¹ y through
    E diag(1/λ) Eᵀ) at B = WWᵀ + I with four eigenvalues exactly 1."""
    rng = np.random.default_rng(5)
    w0, y = rng.normal(size=(6, 2)), rng.normal(size=6)

    def f_jax(w):
        lam, E = jsafe_eigh(w @ w.T + jnp.eye(6))
        return jnp.sum(jnp.log(lam)) + (y @ E) ** 2 @ (1.0 / lam)

    def f_torch(w):
        lam, E = tsafe_eigh(w @ w.T + torch.eye(6, dtype=w.dtype))
        return torch.sum(torch.log(lam)) + (torch.tensor(y) @ E) ** 2 @ (1.0 / lam)

    np.testing.assert_allclose(tsafe_eigh(torch.tensor(w0 @ w0.T + np.eye(6)))[0].numpy(),
                               np.asarray(jsafe_eigh(jnp.asarray(w0 @ w0.T + np.eye(6)))[0]),
                               rtol=1e-10)
    jval, jgrad = jax.value_and_grad(f_jax)(jnp.asarray(w0))
    wt = torch.tensor(w0, requires_grad=True)
    tval = f_torch(wt)
    (tgrad,) = torch.autograd.grad(tval, wt)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-10)
    assert np.all(np.isfinite(tgrad.numpy()))
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-10, atol=1e-12)


def test_torch_icm_predictions_float64_match_jax():
    X, Y = _data(30, 3, 2)
    Xnew = np.array([[6.1], [6.3]])
    jm, tm = _models(3, 2, jnp.float64)
    tX, tY, tXn = torch.tensor(X), torch.tensor(Y), torch.tensor(Xnew)
    for jf, tf in ((jicm.predict_f, ticm.predict_f), (jicm.predict_y, ticm.predict_y),
                   (jicm.posterior_asset_moments, ticm.posterior_asset_moments),
                   (jicm.posterior_asset_moments_chol, ticm.posterior_asset_moments_chol)):
        for got, want in zip(tf(tm, tX, tY, tXn), jf(jm, X, Y, Xnew)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-9,
                                       atol=1e-13)


@pytest.mark.parametrize("n,tier", [(200, "fused"), (1100, "hinv")])
def test_torch_icm_chol_nll_float32_matches_jax(n, tier):
    """The Cholesky NLL in float32 through the port's fused tier (plain
    forward on the CPU) and hinv tier (plain triangular inverse), against
    JAX's fused and hinv Pallas kernels in interpret mode; p = 4."""
    X, Y = _data(n, 4, 3)
    X = (X * 20.0).astype(np.float32)  # lengthscale 0.8 over a few hundred days
    Y = Y.astype(np.float32)
    jm, tm = _models(4, 2, jnp.float32)
    tX, tY = torch.tensor(X), torch.tensor(Y)
    assert ticm.nll_chol_tier(tm, tX, tY) == tier
    jval, jgrad = jax.value_and_grad(
        lambda m: jicm.neg_log_marginal_likelihood_chol(m, jnp.asarray(X), jnp.asarray(Y)))(jm)
    tval, tgrads = _grads(ticm.neg_log_marginal_likelihood_chol, tm, tX, tY)
    np.testing.assert_allclose(float(tval), float(jval), rtol=2e-5)
    for g, w in zip(tgrads, jax.tree.leaves(jgrad)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.reshape(w.shape), w, atol=2e-2 * max(np.abs(w).max(), 1.0))


def test_torch_icm_chol_nll_dense_float32_matches_jax():
    """The Cholesky NLL's dense branch in float32: a RationalQuadratic kernel
    (which the fused branch refuses) at N = 60, P = 3, through the port's
    dense NLL (its plain version on the CPU) against JAX's dense Pallas
    kernels in interpret mode; tests/test_pallas_nll.py's tolerances
    (value rtol 2e-4, gradients rtol 5e-3 / atol 5e-4)."""
    X, Y = _data(60, 3, 5)
    X, Y = X.astype(np.float32), Y.astype(np.float32)
    jm, tm = _models(3, 2, jnp.float32, kernel="RationalQuadratic")
    tX, tY = torch.tensor(X), torch.tensor(Y)
    assert ticm.nll_chol_tier(tm, tX, tY) == "dense"
    jval, jgrad = jax.value_and_grad(
        lambda m: jicm.neg_log_marginal_likelihood_chol(m, jnp.asarray(X), jnp.asarray(Y)))(jm)
    tval, tgrads = _grads(ticm.neg_log_marginal_likelihood_chol, tm, tX, tY)
    np.testing.assert_allclose(float(tval), float(jval), rtol=2e-4)
    for g, w in zip(tgrads, jax.tree.leaves(jgrad)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.reshape(w.shape), w, rtol=5e-3, atol=5e-4)


def test_torch_efficient_frontier_float64_matches_jax():
    mu = np.array([0.02, 0.05, 0.08, 0.03])
    Sigma = np.array([[0.04, 0.01, 0.0, 0.0], [0.01, 0.09, 0.02, 0.0],
                      [0.0, 0.02, 0.16, 0.01], [0.0, 0.0, 0.01, 0.05]])
    want = jfrontier(mu, Sigma, risk_free_rate=0.01, n_points=8)
    got = tfrontier(mu, Sigma, risk_free_rate=0.01, n_points=8, device="cpu",
                    dtype=torch.float64)
    np.testing.assert_allclose(got.target_returns, want.target_returns, rtol=1e-12)
    np.testing.assert_allclose(got.returns, want.returns, atol=1e-6)
    np.testing.assert_allclose(got.volatilities, want.volatilities, atol=1e-6)
    np.testing.assert_allclose(got.weights, want.weights, atol=1e-3)
    np.testing.assert_allclose(got.tangency_weights, want.tangency_weights, atol=1e-3)
    np.testing.assert_allclose(got.tangency_return, want.tangency_return, atol=1e-6)
    np.testing.assert_allclose(got.tangency_volatility, want.tangency_volatility, atol=1e-6)


def _stacks(jm, tm, C, seed):
    """C models around (jm, tm), the same in both packages: raw leaves
    jittered by 0.1·N(0, 1) in ravel order (a stacked port model, and the
    JAX package's stacked pytree)."""
    import jax.flatten_util

    flat, unravel = jax.flatten_util.ravel_pytree(jm)
    rng = np.random.default_rng(seed)
    flats = np.asarray(flat)[None] + 0.1 * rng.normal(size=(C, flat.size))
    flats = flats.astype(np.asarray(flat).dtype)
    return (jax.vmap(unravel)(jnp.asarray(flats)),
            tparams.unravel(tm, torch.tensor(flats)))


def _batched_grads(tms, X, Y):
    leaves = [x.detach().clone().requires_grad_(True) for x in tparams.tree_leaves(tms)]
    value = ticm.batched_neg_log_marginal_likelihood_chol(tparams.tree_replace(tms, leaves),
                                                          X, Y)
    return value.detach(), [g.numpy() for g in torch.autograd.grad(value.sum(), leaves)]


def test_torch_icm_batched_chol_nll_float64_matches_jax():
    """The chain-batched Cholesky NLL (plain tier) equals per-chain calls of
    the single-model function and JAX's chain vmap, values and gradients."""
    from portfoliooptgp_tpu_torch.train.lbfgs import index_pytree

    X, Y = _data(30, 3, 6)
    jm, tm = _models(3, 2, jnp.float64)
    jms, tms = _stacks(jm, tm, 3, 7)
    tX, tY = torch.tensor(X), torch.tensor(Y)
    assert ticm.nll_chol_tier(tms, tX, tY) == "plain"
    val, grads = _batched_grads(tms, tX, tY)
    for c in range(3):
        v, gs = _grads(ticm.neg_log_marginal_likelihood_chol, index_pytree(tms, c), tX, tY)
        np.testing.assert_allclose(float(val[c]), float(v), rtol=1e-12)
        for g, w in zip(grads, gs):
            np.testing.assert_allclose(g[c], w[0], rtol=1e-10, atol=1e-13)
    jval, jgrad = jax.vmap(jax.value_and_grad(
        lambda m: jicm.neg_log_marginal_likelihood_chol(m, X, Y)))(jms)
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=1e-9)
    for g, w in zip(grads, jax.tree.leaves(jgrad)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-7, atol=1e-10)


def test_torch_icm_batched_chol_nll_float32_fused():
    """The same in float32 on the fused tier (one batch of C·P = 8 models
    through the kernel's plain twin on the CPU): per-chain calls rtol 1e-5,
    JAX's chain vmap (Pallas in interpret mode) at the single-model float32
    test's tolerances."""
    from portfoliooptgp_tpu_torch.train.lbfgs import index_pytree

    X, Y = _data(200, 4, 3)
    X = (X * 20.0).astype(np.float32)
    Y = Y.astype(np.float32)
    jm, tm = _models(4, 2, jnp.float32)
    jms, tms = _stacks(jm, tm, 2, 8)
    tX, tY = torch.tensor(X), torch.tensor(Y)
    assert ticm.nll_chol_tier(tms, tX, tY) == "fused"
    val, grads = _batched_grads(tms, tX, tY)
    for c in range(2):
        v, gs = _grads(ticm.neg_log_marginal_likelihood_chol, index_pytree(tms, c), tX, tY)
        np.testing.assert_allclose(float(val[c]), float(v), rtol=1e-5)
        for g, w in zip(grads, gs):
            np.testing.assert_allclose(g[c], w[0], rtol=1e-4, atol=1e-4 * max(np.abs(w).max(), 1))
    jval, jgrad = jax.vmap(jax.value_and_grad(
        lambda m: jicm.neg_log_marginal_likelihood_chol(m, jnp.asarray(X), jnp.asarray(Y))))(jms)
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=2e-5)
    for g, w in zip(grads, jax.tree.leaves(jgrad)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=2e-2 * max(np.abs(w).max(), 1.0))


def test_torch_safe_eigh_nonfinite_gives_nan():
    """A batch with an infinite and a NaN matrix: those give NaN λ, as
    jnp.linalg.eigh does (JAX's E there is NaN or I; the port's NaN), and
    NaN gradients, the finite one its decomposition (where
    torch.linalg.eigh alone raises)."""
    rng = np.random.default_rng(9)
    w = rng.normal(size=(3, 4, 2))
    A = w @ np.swapaxes(w, 1, 2) + np.eye(4)
    A[1, 0, 0], A[2, 1, 2] = np.inf, np.nan
    lam, E = tsafe_eigh(torch.tensor(A))
    jlam, _ = jax.vmap(jsafe_eigh)(jnp.asarray(A))
    np.testing.assert_array_equal(np.isnan(lam.numpy()), np.isnan(np.asarray(jlam)))
    assert np.all(np.isnan(E[1:].numpy())) and not np.any(np.isnan(E[0].numpy()))
    np.testing.assert_allclose(lam[0].numpy(), np.asarray(jlam[0]), rtol=1e-12)
    At = torch.tensor(A, requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(torch.log(tsafe_eigh(At)[0])), At)
    assert np.all(np.isfinite(g[0].numpy())) and np.all(np.isnan(g[1:].numpy()))
