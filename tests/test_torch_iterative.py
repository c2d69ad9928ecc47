"""Port parity: matrix-free GPR inference (ops/iterative.py: CG, PCG, the
pivoted-Cholesky preconditioners, SLQ and the CG NLL with its probe-trace
VJP) against the JAX package, float64 on the CPU.

The probes are the JAX package's own: `tests/jax_replay.jax_probes` draws
them from a `jax.random` key as the JAX package does (Lanczos probes from
the key, CG probes from fold_in(key, 1)) and the port takes them as
`probes=`, so values and gradients are held at rtol 1e-8. The
estimator's accuracy against the dense NLL, with the port's default
`torch.Generator` probes, is held at tests/test_iterative.py's
tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.models import gpr as jgpr
from portfoliooptgp_tpu.ops import iterative as jit_
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.models import gpr as tgpr
from portfoliooptgp_tpu_torch.ops import iterative as tit
from tests.jax_replay import jax_probes

torch.set_num_threads(1)

N = 300


@pytest.fixture(scope="module")
def system():
    """tests/test_iterative.py's system: SE(1.2, 1.5) on 300 sorted points
    in [0, 30], y = sin(x) + noise, σ² = 0.1."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 30, (N, 1)), 0)
    K = np.asarray(jk.SquaredExponential.create(variance=1.2, lengthscales=1.5).K(jnp.asarray(X)))
    y = np.sin(X) + 0.1 * rng.normal(size=(N, 1))
    return K, y, 0.1


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _close(got, want, rtol=1e-8):
    """Elementwise at rtol, and entries near zero within rtol of the
    largest: rounding in a solve moves every entry by about as much."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def test_torch_cg_and_pcg_match_jax(system):
    """batched_cg and batched_pcg (Woodbury on a rank-48 pivoted Cholesky)
    on three right-hand sides: the solutions at rtol 1e-8, the iteration
    counts within one of JAX's (the stopping test compares a residual
    that rounding moves with tol), PCG in fewer iterations than CG."""
    K, y, s2 = system
    Ks = K + s2 * np.eye(N)
    rhs = np.concatenate([y, 2 * y, np.ones_like(y)], axis=1)
    jx, jit_cg = jit_.batched_cg(lambda V: jnp.asarray(Ks) @ V, jnp.asarray(rhs),
                                 tol=1e-10, maxiter=2000)
    tx, tit_cg = tit.batched_cg(lambda V: _t(Ks) @ V, _t(rhs), tol=1e-10, maxiter=2000)
    _close(tx.numpy(), jx)
    np.testing.assert_allclose(tx.numpy(), np.linalg.solve(Ks, rhs), atol=1e-6)
    assert abs(tit_cg - int(jit_cg)) <= 1

    jL = jit_.pivoted_cholesky(jnp.asarray(K), 48)
    jx, jit_p = jit_.batched_pcg(lambda V: jnp.asarray(Ks) @ V,
                                 jit_.woodbury_preconditioner(jL, jnp.asarray(s2)),
                                 jnp.asarray(rhs), tol=1e-8, maxiter=1200)
    tL = tit.pivoted_cholesky(_t(K), 48)
    tx, tit_p = tit.batched_pcg(lambda V: _t(Ks) @ V,
                                tit.woodbury_preconditioner(tL, _t(s2)), _t(rhs),
                                tol=1e-8, maxiter=1200)
    _close(tx.numpy(), jx)
    assert abs(tit_p - int(jit_p)) <= 1 and tit_p < tit_cg


def test_torch_pivoted_cholesky_and_preconditioners_match_jax(system):
    """pivoted_cholesky at ranks 8, 32 and 48 against JAX's, below K's
    numerical rank (past about 56 the remaining diagonal is rounding,
    ~1e-12 of the largest, and the columns amplify it in both packages);
    its error falls with the rank up to 96; the Woodbury preconditioner's
    apply, and split_preconditioner's P^(-1/2) and its exact log-det."""
    K, _, s2 = system
    prev = np.inf
    for rank in (8, 32, 48, 96):
        tL = tit.pivoted_cholesky(_t(K), rank)
        if rank <= 48:
            _close(tL.numpy(), jit_.pivoted_cholesky(jnp.asarray(K), rank))
        err = float(np.linalg.norm(K - tL.numpy() @ tL.numpy().T) / np.linalg.norm(K))
        assert err < prev
        prev = err
    assert prev < 1e-3

    L = np.asarray(jit_.pivoted_cholesky(jnp.asarray(K), 48))
    V = np.random.default_rng(1).normal(size=(N, 3))
    want = np.asarray(jit_.woodbury_preconditioner(jnp.asarray(L), jnp.asarray(s2))(
        jnp.asarray(V)))
    got = tit.woodbury_preconditioner(_t(L), _t(s2))(_t(V)).numpy()
    _close(got, want)

    japp, jld = jit_.split_preconditioner(jnp.asarray(L), jnp.asarray(s2))
    tapp, tld = tit.split_preconditioner(_t(L), _t(s2))
    _close(tapp(_t(V)).numpy(), japp(jnp.asarray(V)))
    np.testing.assert_allclose(float(tld), float(jld), rtol=1e-10)
    # columns below 1e-6 of the largest are dropped (tests/test_iterative.py's 1e-4)
    np.testing.assert_allclose(float(tld), np.linalg.slogdet(L @ L.T + s2 * np.eye(N))[1],
                               rtol=1e-4)
    PinvV = tapp(tapp(_t(V))).numpy()
    np.testing.assert_allclose(L @ (L.T @ PinvV) + s2 * PinvV, V, rtol=1e-4, atol=1e-4)


def test_torch_lanczos_logdet_matches_jax(system):
    """SLQ on replayed probes (32 probes, 48 steps) equals JAX's at rtol
    1e-8, within 5% of the exact log-det."""
    K, _, s2 = system
    Ks = K + s2 * np.eye(N)
    key = jax.random.PRNGKey(0)
    want = float(jit_.lanczos_logdet(lambda V: jnp.asarray(Ks) @ V, N, key, num_probes=32,
                                     num_lanczos=48, dtype=jnp.float64))
    got = float(tit.lanczos_logdet(lambda V: _t(Ks) @ V, N, num_lanczos=48,
                                   dtype=torch.float64, probes=jax_probes(key, N, 32)[1]))
    np.testing.assert_allclose(got, want, rtol=1e-8)
    exact = np.linalg.slogdet(Ks)[1]
    assert abs(got - exact) / abs(exact) < 0.05


@pytest.mark.parametrize("precond_rank", [0, 48])
def test_torch_nll_cg_matches_jax(system, precond_rank):
    """nll_cg on replayed keys: the value and its gradients in K, y and
    noise at rtol 1e-8 (16 probes, 32 Lanczos steps). cg_tol 1e-10, where
    the solves have converged: at 1e-8 the two packages may stop one CG
    iteration apart, which moves α by ~1e-7."""
    K, y, s2 = system
    key = jax.random.PRNGKey(3)
    args = (16, 32, 1e-10, precond_rank)
    jv, (jgK, jgy, jgn) = jax.value_and_grad(
        lambda K, y, s: jit_.nll_cg(K, y, s, key, *args), argnums=(0, 1, 2))(
        jnp.asarray(K), jnp.asarray(y), jnp.asarray(s2))
    tK, ty, ts = (_t(a).requires_grad_(True) for a in (K, y, s2))
    probes = jax_probes(key, N, args[0])
    tv = tit.nll_cg(tK, ty, ts, None, *args, probes=probes)
    gK, gy, gn = torch.autograd.grad(tv, (tK, ty, ts))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-8)
    for got, want in ((gK, jgK), (gy, jgy), (gn, jgn)):
        _close(got.numpy(), want)
    _, aux = tit.nll_cg_forward(_t(K), _t(y), _t(s2), None, *args, probes=probes)
    _, jaux = jit_._nll_cg_fwd_impl(jnp.asarray(K), jnp.asarray(y), jnp.asarray(s2), key,
                                    *args)
    assert abs(aux.cg_iters - int(jaux.cg_iters)) <= 1
    np.testing.assert_array_equal(aux.probes.numpy(), np.asarray(jaux.probes))


@pytest.mark.parametrize("precond_rank", [0, 32])
def test_torch_gpr_nll_cg_matches_jax(precond_rank):
    """gpr.neg_log_marginal_likelihood_cg of an ARD SE model over D = 2,
    N = 200, on replayed keys: the value and the gradient in every raw
    parameter at rtol 1e-8 (cg_tol 1e-10, as above). 16 Lanczos steps:
    on this operator (condition ~970) the two-vector re-orthogonalization
    loses orthogonality past ~20 steps, and the matmuls' rounding (XLA's
    and torch's sum in other orders) then moves the SLQ estimate by up to
    1e-5 relative, in either package alike."""
    rng = np.random.default_rng(4)
    X = rng.uniform(0, 10, (200, 2))
    Y = np.sin(X[:, :1]) + 0.2 * np.cos(X[:, 1:]) + 0.1 * rng.normal(size=(200, 1))
    jm = jgpr.GPR.create(jk.SquaredExponential.create(1.3, np.array([1.5, 2.5])), 0.05)
    key = jax.random.PRNGKey(11)
    args = (24, 16, 1e-10, precond_rank)
    jv, jg = jax.value_and_grad(
        lambda m: jgpr.neg_log_marginal_likelihood_cg(m, jnp.asarray(X), jnp.asarray(Y), key,
                                                      *args))(jm)
    template = tgpr.GPR.create(tk.SquaredExponential.create(
        1.0, [1.0, 1.0], device="cpu", dtype=torch.float64), 1.0)
    tm = tparams.from_jax_leaves(template, [np.asarray(x) for x in jax.tree.leaves(jm)])
    leaves = [x.requires_grad_(True) for x in tparams.tree_leaves(tm)]
    tm = tparams.tree_replace(tm, leaves)
    tv = tgpr.neg_log_marginal_likelihood_cg(tm, _t(X), _t(Y), None, *args,
                                             probes=jax_probes(key, 200, args[0]))
    assert tv.shape == (1,)
    grads = torch.autograd.grad(tv.sum(), leaves)
    np.testing.assert_allclose(float(tv[0].detach()), float(jv), rtol=1e-8)
    for got, want in zip(grads, jax.tree.leaves(jg)):
        _close(got.numpy().reshape(-1), np.asarray(want).reshape(-1))


def test_torch_nll_cg_estimator_matches_dense(system):
    """The estimator with the port's own generator probes, at
    tests/test_iterative.py's tolerances: the NLL within 2% of |log|Ks||
    (32 probes, 48 steps); the split-SLQ NLL (rank 48, 8 steps) within
    1e-3 of the exact one and 20× closer than plain SLQ at 8 steps; the
    y gradient CG-exact; the mean hyperparameter gradient over 8
    generator seeds within 10% of the dense one; the noise gradient
    within 5%."""
    K, y, s2 = system
    Ks = K + s2 * np.eye(N)
    logdet = np.linalg.slogdet(Ks)[1]
    alpha = np.linalg.solve(Ks, y)
    exact = 0.5 * float((y * alpha).sum()) + 0.5 * logdet + 0.5 * N * np.log(2 * np.pi)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    got = float(tit.nll_cg(_t(K), _t(y), s2, gen(0), 32, 48, 1e-8))
    assert abs(got - exact) < 0.02 * abs(logdet)
    plain = float(tit.nll_cg(_t(K), _t(y), s2, gen(0), 16, 8, 1e-8))
    split = float(tit.nll_cg(_t(K), _t(y), s2, gen(0), 16, 8, 1e-8, 48))
    assert abs(split - exact) < 0.05 * max(abs(plain - exact), 1e-10)
    assert abs(split - exact) / max(abs(exact), 1.0) < 1e-3

    ty = _t(y).requires_grad_(True)
    (gy,) = torch.autograd.grad(tit.nll_cg(_t(K), ty, s2, gen(0), 16, 32, 1e-8), ty)
    np.testing.assert_allclose(gy.numpy(), alpha, atol=1e-5)

    X = torch.as_tensor(np.sort(np.random.default_rng(1).uniform(0, 30, (N, 1)), 0))
    d2 = (X - X.T) ** 2

    def hyper(raw, nll):
        v, ls = tparams.positive(raw[0]), tparams.positive(raw[1])
        return nll(v * torch.exp(-0.5 * d2 / (ls * ls)))

    def dense(Kh):
        L = torch.linalg.cholesky(Kh + s2 * torch.eye(N, dtype=torch.float64))
        a = torch.linalg.solve_triangular(L, _t(y), upper=False)
        return 0.5 * torch.sum(a * a) + torch.sum(torch.log(torch.diagonal(L)))

    def grad(nll):
        raw = torch.tensor([0.3, 0.8], dtype=torch.float64, requires_grad=True)
        return torch.autograd.grad(hyper(raw, nll), raw)[0].numpy()

    g_dense = grad(dense)
    g_cg = np.mean([grad(lambda Kh, s=s: tit.nll_cg(Kh, _t(y), s2, gen(s), 64, 48, 1e-8))
                    for s in range(8)], axis=0)
    np.testing.assert_allclose(g_cg, g_dense, rtol=0.1)

    ts = _t(s2).requires_grad_(True)
    (gn,) = torch.autograd.grad(tit.nll_cg(_t(K), _t(y), ts, gen(0), 64, 48, 1e-8), ts)
    tsd = _t(s2).requires_grad_(True)
    Ld = torch.linalg.cholesky(_t(K) + tsd * torch.eye(N, dtype=torch.float64))
    ad = torch.linalg.solve_triangular(Ld, _t(y), upper=False)
    (gnd,) = torch.autograd.grad(0.5 * torch.sum(ad * ad) + torch.sum(torch.log(
        torch.diagonal(Ld))), tsd)
    assert abs(float(gn - gnd)) / abs(float(gnd)) < 0.05
