"""Port parity: the optimizers vs the JAX package, in float64.

`fit_matrix` is a rule-for-rule port, so on the same problem it takes the
same iterations and lands on the same point up to float64 rounding
(atol 1e-8 on parameters). `lbfgs.fit` (optax L-BFGS + zoom line search)
and `minimize_simplex` are held to the JAX optimum by tolerance: the line
search's scalar bookkeeping runs on the host in a different order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.models import gpr as jgpr
from portfoliooptgp_tpu.portfolio import optimizer as jopt
from portfoliooptgp_tpu.portfolio.solver import minimize_simplex as j_minimize_simplex
from portfoliooptgp_tpu.train import batched_lbfgs as jbl
from portfoliooptgp_tpu.train import lbfgs as jlb
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.models import gpr as tgpr
from portfoliooptgp_tpu_torch.portfolio import optimizer as topt
from portfoliooptgp_tpu_torch.portfolio.solver import minimize_simplex as t_minimize_simplex
from portfoliooptgp_tpu_torch.portfolio.solver import minimize_simplex_rows
from portfoliooptgp_tpu_torch.train import batched_lbfgs as tbl
from portfoliooptgp_tpu_torch.train import lbfgs as tlb

# tiny matrices: one intra-op thread per test worker avoids oversubscribing the
# CPU when pytest-xdist runs several workers
torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64)


def test_torch_fit_matrix_matches_jax_on_batched_quadratic(rng):
    B, D = 4, 3
    M = rng.normal(size=(B, D, D))
    A = M @ np.transpose(M, (0, 2, 1)) + 0.5 * np.eye(D)
    c = rng.normal(size=(B, D))
    Z0 = rng.normal(size=(B, D))

    def jloss(Z):
        r = Z - jnp.asarray(c)
        return 0.5 * jnp.einsum("bi,bij,bj->b", r, jnp.asarray(A), r) + jnp.sum(r ** 4, -1)

    def tloss(Z):
        r = Z - torch.as_tensor(c)
        return 0.5 * torch.einsum("bi,bij,bj->b", r, torch.as_tensor(A), r) + torch.sum(r ** 4, -1)

    jr = jbl.fit_matrix(jloss, jnp.asarray(Z0), maxiter=100)
    tr = tbl.fit_matrix(tloss, torch.as_tensor(Z0), maxiter=100)
    assert tr.iters == int(jr.iters)
    np.testing.assert_allclose(tr.params.numpy(), np.asarray(jr.params), atol=1e-8)
    np.testing.assert_allclose(tr.loss.numpy(), np.asarray(jr.loss), rtol=1e-10, atol=1e-12)
    assert np.array_equal(tr.converged.numpy(), np.asarray(jr.converged))


@pytest.mark.parametrize("frozen_likelihood", [False, True])
def test_torch_fit_batched_fused_matches_jax_on_small_gp(frozen_likelihood, rng):
    """Three SE restarts on a 30-point series through the plain batched
    NLL: same trained hyperparameters (rtol 1e-6) and losses; a frozen
    likelihood variance never moves."""
    X = np.linspace(0, 6, 30)[:, None]
    Y = np.sin(X) + 0.1 * rng.normal(size=(30, 1))
    inits = (1e-3, 1e-1, 1.0)
    jms = [jgpr.GPR.create(jk.SquaredExponential.create(), v) for v in inits]
    jstack = jlb.stack_pytrees(jms)
    jfrozen = jlb.freeze_leaves(jms[0], likelihood=True) if frozen_likelihood else None
    jX, jY = jnp.asarray(X), jnp.asarray(Y)
    # compiled as one program (the eager call spends ~10 s compiling its loops)
    jm, jr = jax.jit(lambda s: jbl.fit_batched_fused(
        lambda ms: jax.vmap(lambda m: jgpr.neg_log_marginal_likelihood(m, jX, jY))(ms),
        s, frozen=jfrozen, maxiter=150))(jstack)

    tms = [tgpr.GPR.create(tk.SquaredExponential.create(**CPU64), v) for v in inits]
    tstack = tlb.stack_pytrees(tms)
    tfrozen = tlb.freeze_leaves(tms[0], likelihood=True) if frozen_likelihood else None
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    tm, tr = tbl.fit_batched_fused(
        lambda ms: tgpr.neg_log_marginal_likelihood(ms, tX, tY), tstack,
        frozen=tfrozen, maxiter=150)

    for got, want in zip(tparams.tree_leaves(tm), jax.tree.leaves(jm)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tr.loss.numpy(), np.asarray(jr.loss), rtol=1e-9)
    if frozen_likelihood:
        np.testing.assert_array_equal(tm.likelihood.raw_variance.detach().numpy(),
                                      tstack.likelihood.raw_variance.numpy())


def test_torch_lbfgs_fit_matches_jax_optimum():
    """Rosenbrock from (-1.2, 1): both reach the minimum (1, 1)."""
    def jrosen(p):
        return (1 - p[0]) ** 2 + 100 * (p[1] - p[0] ** 2) ** 2

    def trosen(p):
        return (1 - p[0]) ** 2 + 100 * (p[1] - p[0] ** 2) ** 2

    jr = jlb.fit(jrosen, jnp.asarray([-1.2, 1.0]), maxiter=200)
    tr = tlb.fit(trosen, torch.tensor([-1.2, 1.0], dtype=torch.float64), maxiter=200)
    np.testing.assert_allclose(tr.params.numpy(), np.asarray(jr.params), atol=1e-6)
    np.testing.assert_allclose(tr.params.numpy(), [1.0, 1.0], atol=1e-6)
    assert tr.loss < 1e-12 and tr.converged
    assert abs(tr.iters - int(jr.iters)) <= 3


def test_torch_minimize_simplex_matches_jax(rng):
    """The Sharpe solve (no constraint) and the max-return solve under a
    volatility cap (augmented Lagrangian) land on the JAX weights."""
    n = 5
    mu = rng.normal(0.002, 0.004, n)
    var = rng.uniform(2e-5, 2e-4, n)
    prev = np.full(n, 1.0 / n)
    jS, tS = jnp.diag(jnp.asarray(var)), torch.diag(torch.as_tensor(var))
    jmu, tmu = jnp.asarray(mu), torch.as_tensor(mu)

    jw = j_minimize_simplex(
        lambda w: jopt.sharpe_objective(w, jmu, jS, 1e-4) + jopt.l1_l2_penalty(w, 1e-3, 1e-3)
        + jopt.transaction_penalty(w, jnp.asarray(prev), 1e-5), n).weights
    tw = t_minimize_simplex(
        lambda w: topt.sharpe_objective(w, tmu, tS, 1e-4) + topt.l1_l2_penalty(w, 1e-3, 1e-3)
        + topt.transaction_penalty(w, torch.as_tensor(prev), 1e-5), n, **CPU64).weights
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)

    cap = 0.6 * float(np.sqrt(var.max()))
    jw = j_minimize_simplex(lambda w: -(jmu @ w), n,
                            lambda w: cap - jnp.sqrt(jnp.maximum(w @ jS @ w, 1e-18))).weights
    tw = t_minimize_simplex(lambda w: -(tmu @ w), n,
                            lambda w: cap - torch.sqrt(torch.clamp_min(w @ tS @ w, 1e-18)),
                            **CPU64).weights
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


def _row_problems(kind, rng, R=6, D=4):
    """R independent problems (per-row data) and starts; row 0 starts at
    its minimum, so it stops before its first step."""
    if kind == "quartic":
        M = rng.normal(size=(R, D, D))
        data = (M @ np.transpose(M, (0, 2, 1)) + 0.5 * np.eye(D), rng.normal(size=(R, D)))

        def loss(z, A, c, lib):
            r = z - c
            return 0.5 * lib.sum(r * (A @ r)) + lib.sum(r ** 4)
    else:  # a scaled Rosenbrock valley per row
        data = (rng.uniform(10.0, 100.0, (R, 1)), rng.uniform(0.5, 1.5, (R, D)))

        def loss(z, a, c, lib):
            return lib.sum((c[:-1] - z[:-1]) ** 2 + a[0] * (z[1:] - z[:-1] ** 2) ** 2)
    z0 = rng.normal(size=(R, D))
    if kind == "quartic":
        z0[0] = data[1][0]
    return loss, data, z0


@pytest.mark.parametrize("kind", ["quartic", "rosenbrock"])
def test_torch_fit_rows_matches_scalar_fit_and_jax_vmap(kind, rng):
    """`lbfgs.fit_rows` of R rows in lockstep follows each row solved alone
    (`fit`, its one-row case: iterations within one, parameters at rtol
    1e-8) and JAX's vmap of `lbfgs.fit`."""
    loss, data, z0 = _row_problems(kind, rng)
    tdata = [torch.as_tensor(d) for d in data]

    def rows(Z):
        return torch.stack([loss(Z[r], *(d[r] for d in tdata), torch)
                            for r in range(Z.shape[0])])

    got = tlb.fit_rows(rows, torch.as_tensor(z0), maxiter=200)
    want = jax.jit(jax.vmap(lambda z, *d: jlb.fit(lambda p: loss(p, *d, jnp), z,
                                                  maxiter=200)))(
        jnp.asarray(z0), *(jnp.asarray(d) for d in data))
    if kind == "quartic":
        assert int(got.iters[0]) == 0
    for r in range(z0.shape[0]):
        one = tlb.fit(lambda z, r=r: loss(z, *(d[r] for d in tdata), torch),
                      torch.as_tensor(z0[r]), maxiter=200)
        assert abs(int(got.iters[r]) - one.iters) <= 1
        assert abs(int(got.iters[r]) - int(want.iters[r])) <= 1
        np.testing.assert_allclose(got.params[r].numpy(), one.params.numpy(), rtol=1e-8,
                                   atol=1e-12)
        np.testing.assert_allclose(got.params[r].numpy(), np.asarray(want.params[r]),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(float(got.loss[r]), one.loss, rtol=1e-8, atol=1e-14)
        assert bool(got.converged[r]) == one.converged


@pytest.mark.parametrize("constraint", ["return_floor", "none"])
def test_torch_minimize_simplex_rows_matches_scalar(constraint, rng):
    """The row-batched solve against one `minimize_simplex` (its one-row
    case) a row, weights at atol 1e-8: frontier-like return floors up to
    max μ (whose feasible set is one vertex) on a diagonal Σ, or the Sharpe
    objective per row."""
    n, R = 5, 7
    mu = rng.normal(0.002, 0.004, n)
    var = rng.uniform(2e-5, 2e-4, (R, n))
    tmu, tvar = torch.as_tensor(mu), torch.as_tensor(var)
    floors = torch.linspace(float(mu.min()), float(mu.max()), R, dtype=torch.float64)
    if constraint == "return_floor":
        def obj(W):
            return torch.sqrt(torch.clamp_min(torch.sum(W * tvar * W, dim=-1), 1e-18))

        def ineq(W):
            return torch.sum(tmu * W, dim=-1) - floors
    else:
        def obj(W):
            ret = torch.sum(tmu * W, dim=-1) - 1e-4
            return -ret / torch.sqrt(torch.sum(W * tvar * W, dim=-1))

        ineq = None
    got = minimize_simplex_rows(obj, R, n, ineq, **CPU64)
    for r in range(R):
        def one(w, r=r):
            return obj(w[None].expand(R, n))[r]

        one_ineq = None if ineq is None else (lambda w, r=r: ineq(w[None].expand(R, n))[r])
        want = t_minimize_simplex(one, n, one_ineq, **CPU64)
        np.testing.assert_allclose(got.weights[r].numpy(), want.weights.numpy(), atol=1e-8)
        np.testing.assert_allclose(float(got.constraint_violation[r]),
                                   float(want.constraint_violation), atol=1e-10)
    np.testing.assert_allclose(got.weights.sum(-1).numpy(), 1.0, rtol=1e-12)
