"""The port's sparse and variational models against the JAX package, on the
CPU with numpy-seeded inputs; parameters cross over with
`params.from_jax_leaves`.

- ops/linalg.py: `cholesky_guarded`, `cholesky_inverse_pair` and
  `safe_cholesky`, values and VJPs in float64 (rtol 1e-10), and zero
  gradients where the factor fails;
- models/svgp.py in float64: `elbo`, `gaussian_elbo_gram`,
  `gaussian_elbo_gram_fused` (both `use_pallas` values; in float64 neither
  package's model is eligible for the kernels), `gram_finish` and the
  predictions, values rtol 1e-10 and gradients normalized atol 1e-8 (the
  same formulas, rounded in another order);
- the `use_pallas=True` route in float32 on smoke_tpu's problem, where the
  port runs the gram kernels' plain versions and JAX its Pallas kernels in
  interpret mode: tests/test_svgp_gram_fused.py's tolerances (values rtol
  2e-4, gradients 3e-3 normalized);
- models/sgpr.py and models/vgp.py with StudentT in float64, rtol 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.kernels.means import ConstantMean as JConstantMean
from portfoliooptgp_tpu.models import sgpr as jsgpr
from portfoliooptgp_tpu.models import svgp as jsvgp
from portfoliooptgp_tpu.models import vgp as jvgp
from portfoliooptgp_tpu.models.likelihoods import Gaussian as JGaussian
from portfoliooptgp_tpu.models.likelihoods import StudentT as JStudentT
from portfoliooptgp_tpu.ops import linalg as jlinalg
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.kernels.means import ConstantMean as TConstantMean
from portfoliooptgp_tpu_torch.models import sgpr as tsgpr
from portfoliooptgp_tpu_torch.models import svgp as tsvgp
from portfoliooptgp_tpu_torch.models import vgp as tvgp
from portfoliooptgp_tpu_torch.models.likelihoods import Gaussian as TGaussian
from portfoliooptgp_tpu_torch.models.likelihoods import StudentT as TStudentT
from portfoliooptgp_tpu_torch.ops import linalg as tlinalg

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _tdtype(dtype):
    return torch.float64 if dtype == np.float64 else torch.float32


def data(n, d=1, seed=0, span=30.0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, span, (n, d)), axis=0)
    Y = np.sin(X.sum(axis=1, keepdims=True) / 3.0) + 0.2 * rng.normal(size=(n, 1))
    return X.astype(dtype), Y.astype(dtype)


def svgp_pair(kernel="SquaredExponential", variance=1.3, lengthscales=4.0, M=16, D=1,
              noise=0.05, dtype=np.float64, seed=1, mean=None, span=30.0, P=1):
    """The same SVGP in both packages: random q_mu and q_sqrt from a numpy
    seed, Z uniform on [0, span]; `mean` a constant or None (Zero)."""
    rng = np.random.default_rng(seed)
    Z = rng.uniform(0, span, (M, D))
    jm = jsvgp.SVGP.create(
        getattr(jk, kernel).create(variance, lengthscales), inducing_points=jnp.asarray(Z),
        likelihood=JGaussian.create(noise), num_latent=P,
        mean_function=None if mean is None else JConstantMean.create(mean))
    jm = dataclasses.replace(
        jm, q_mu=jnp.asarray(rng.normal(size=(M, P))),
        q_sqrt=jnp.asarray(np.tril(rng.normal(size=(P, M, M)) * 0.2) + np.eye(M)))
    jm = jax.tree.map(lambda x: jnp.asarray(x, dtype), jm)
    td = dict(device="cpu", dtype=_tdtype(dtype))
    template = tsvgp.SVGP.create(
        getattr(tk, kernel).create(variance, lengthscales, **td), Z,
        likelihood=TGaussian.create(noise, **td), num_latent=P,
        mean_function=None if mean is None else TConstantMean.create(mean, **td), **td)
    return jm, tparams.from_jax_leaves(template, [np.asarray(x) for x in jax.tree.leaves(jm)])


def value_and_grads(fn, model, *args, **kw):
    """fn(model, *args) and its gradient with respect to every leaf."""
    leaves = [x.detach().clone().requires_grad_(True) for x in tparams.tree_leaves(model)]
    value = fn(tparams.tree_replace(model, leaves), *args, **kw)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return value.detach(), [torch.zeros_like(x) if g is None else g
                            for x, g in zip(leaves, grads)]


def assert_grads(tgrads, jgrads, atol, label=""):
    jl = jax.tree.leaves(jgrads)
    assert len(tgrads) == len(jl)
    for k, (g, w) in enumerate(zip(tgrads, jl)):
        w = np.asarray(w, dtype=np.float64)
        g = g.detach().double().numpy().reshape(w.shape)
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=atol,
                                   err_msg=f"{label} leaf {k}")


def t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


# -- leaf order ----------------------------------------------------------------

def test_torch_svgp_sgpr_vgp_leaf_order():
    """from_jax_leaves carries SVGP, SGPR and VGP trees leaf for leaf: the
    kernel's, the likelihood's, the mean's, then Z, q_mu, q_sqrt (SVGP),
    Z (SGPR), q_mu, q_sqrt (VGP)."""
    jm, tm = svgp_pair("Matern32", lengthscales=np.array([2.0, 3.0, 4.0]), D=3, mean=0.7)
    shapes = [tuple(x.shape) for x in tparams.tree_leaves(tm)]
    assert shapes == [(1,), (1, 3), (1,), (1,), (16, 3), (16, 1), (1, 16, 16)]
    np.testing.assert_array_equal(tm.Z.numpy(), np.asarray(jm.Z))
    np.testing.assert_array_equal(tm.q_sqrt.numpy(), np.asarray(jm.q_sqrt))
    np.testing.assert_allclose(float(tm.kernel.lengthscales[0, 2]), 4.0, rtol=1e-14)
    assert float(tm.mean_function.c[0]) == 0.7

    Z = np.linspace(0, 10, 6)[:, None]
    js = jsgpr.SGPR.create(jk.Matern12.create(0.9, 2.0), Z, noise_variance=0.3)
    ts = tparams.from_jax_leaves(
        tsgpr.SGPR.create(tk.Matern12.create(**CPU, dtype=torch.float64), Z, **CPU,
                          dtype=torch.float64), [np.asarray(x) for x in jax.tree.leaves(js)])
    assert [tuple(x.shape) for x in tparams.tree_leaves(ts)] == [(1,), (1,), (1,), (6, 1)]
    np.testing.assert_allclose(float(ts.likelihood.variance[0]), 0.3, rtol=1e-14)

    jv = jvgp.VGP.create(7, jk.SquaredExponential.create(), likelihood=JStudentT.create(0.4))
    tv = tparams.from_jax_leaves(
        tvgp.VGP.create(7, tk.SquaredExponential.create(**CPU, dtype=torch.float64),
                        **CPU, dtype=torch.float64),
        [np.asarray(x) for x in jax.tree.leaves(jv)])
    assert [tuple(x.shape) for x in tparams.tree_leaves(tv)] == [
        (1,), (1,), (1,), (7, 1), (1, 7, 7)]
    np.testing.assert_allclose(float(tv.likelihood.scale[0]), 0.4, rtol=1e-14)


# -- linear algebra ------------------------------------------------------------

def _spd(n, seed, cond=1e3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return (Q * np.geomspace(1.0, 1.0 / cond, n)) @ Q.T


@pytest.mark.parametrize("name", ["cholesky_guarded", "safe_cholesky", "cholesky_inverse_pair"])
@pytest.mark.parametrize("kind", ["spd", "indefinite", "needs_jitter"])
def test_torch_linalg_factorizations_match_jax(name, kind):
    """Values and VJPs of the three factorizations against JAX in float64:
    a well-conditioned K, an indefinite K (NaN factor, zero gradients) and a
    slightly indefinite K that the jitter ladder rescues."""
    K = _spd(12, 3)
    if kind == "indefinite":
        K = K - 0.5 * np.eye(12)
    elif kind == "needs_jitter":  # smallest eigenvalue −0.003: the 1e-2 rung factors it
        K = K - 0.004 * np.eye(12)
    rng = np.random.default_rng(5)
    cots = [rng.normal(size=(12, 12)) for _ in range(2)]

    def jfn(Kj):
        out = getattr(jlinalg, name)(Kj)
        return out if name == "cholesky_inverse_pair" else out[:1]

    jout, vjp = jax.vjp(jfn, jnp.asarray(K))
    (jK,) = vjp(tuple(jnp.asarray(c) for c in cots[:len(jout)]))
    Kt = t(K).requires_grad_(True)
    out = getattr(tlinalg, name)(Kt)
    tout = out if name == "cholesky_inverse_pair" else out[:1]
    (tK,) = torch.autograd.grad(tout, Kt, [t(c) for c in cots[:len(tout)]])
    for a, b in zip(tout, jout):
        a, b = a.detach().numpy(), np.asarray(b)
        if np.isnan(b).any():  # JAX's failed factor is NaN below the diagonal, 0 above
            a, b = np.tril(a), np.tril(b)
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tK.numpy(), np.asarray(jK), rtol=1e-9, atol=1e-9)
    if kind == "indefinite" and name != "safe_cholesky":
        assert np.all(np.isnan(tout[0].detach().numpy()))
        assert np.all(tK.numpy() == 0.0)
        assert not bool(tlinalg.cholesky_guarded(t(K))[1])
    if name != "cholesky_inverse_pair":
        assert bool(out[1]) == bool(getattr(jlinalg, name)(jnp.asarray(K))[1])


# -- the SVGP ------------------------------------------------------------------

ROUTES = {
    "elbo": (lambda m, X, Y: jsvgp.elbo(m, X, Y, num_data=200),
             lambda m, X, Y: tsvgp.elbo(m, X, Y, num_data=200)),
    "gaussian_elbo_gram": (
        lambda m, X, Y, w=None: jsvgp.gaussian_elbo_gram(m, X, Y, weights=w, num_data=200),
        lambda m, X, Y, w=None: tsvgp.gaussian_elbo_gram(m, X, Y, weights=w, num_data=200)),
    "fused/xla": (
        lambda m, X, Y, w=None: jsvgp.gaussian_elbo_gram_fused(m, X, Y, weights=w, num_data=200),
        lambda m, X, Y, w=None: tsvgp.gaussian_elbo_gram_fused(m, X, Y, weights=w,
                                                               num_data=200)),
    "fused/use_pallas": (
        lambda m, X, Y, w=None: jsvgp.gaussian_elbo_gram_fused(m, X, Y, weights=w, num_data=200,
                                                               use_pallas=True),
        lambda m, X, Y, w=None: tsvgp.gaussian_elbo_gram_fused(m, X, Y, weights=w, num_data=200,
                                                               use_pallas=True)),
    "gram_finish": (
        lambda m, X, Y: jsvgp.gram_finish(
            m, jsvgp.gram_chol(m), jsvgp.gram_partials(m, jsvgp.gram_chol(m), X, Y), None),
        lambda m, X, Y: tsvgp.gram_finish(
            m, tsvgp.gram_chol(m), tsvgp.gram_partials(m, tsvgp.gram_chol(m), X, Y), None)),
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", ["se", "ard_matern52_constant_mean"])
def test_torch_svgp_elbo_routes_float64_match_jax(route, case):
    if case == "se":
        jm, tm = svgp_pair()
        X, Y = data(96)
    else:
        jm, tm = svgp_pair("Matern52", lengthscales=np.array([3.0, 5.0]), D=2, mean=0.3)
        X, Y = data(80, d=2, seed=2)
    jfn, tfn = ROUTES[route]
    jval, jgrad = jax.jit(jax.value_and_grad(jfn))(jm, jnp.asarray(X), jnp.asarray(Y))
    tval, tgrads = value_and_grads(tfn, tm, t(X), t(Y))
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-10)
    assert_grads(tgrads, jgrad, 1e-8, route)


def test_torch_svgp_weighted_gram_routes_match_jax():
    """Weight-0 padding rows, through the three Gram routes, float64."""
    jm, tm = svgp_pair("Matern12")
    X, Y = data(100, seed=3)
    w = (np.arange(100) < 77).astype(np.float64)
    for route in ("gaussian_elbo_gram", "fused/xla", "fused/use_pallas"):
        jfn, tfn = ROUTES[route]
        jval, jgrad = jax.jit(jax.value_and_grad(jfn))(jm, jnp.asarray(X), jnp.asarray(Y),
                                                       jnp.asarray(w))
        tval, tgrads = value_and_grads(tfn, tm, t(X), t(Y), t(w))
        np.testing.assert_allclose(float(tval), float(jval), rtol=1e-10)
        assert_grads(tgrads, jgrad, 1e-8, route)


@pytest.mark.parametrize("full_cov", [False, True])
def test_torch_svgp_predictions_float64_match_jax(full_cov):
    jm, tm = svgp_pair("Matern32", P=2)
    Xs = np.linspace(-2, 32, 40)[:, None]
    jmean, jvar = jax.jit(jsvgp.predict_f, static_argnums=2)(jm, jnp.asarray(Xs), full_cov)
    tmean, tvar = tsvgp.predict_f(tm, t(Xs), full_cov=full_cov)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), rtol=1e-10, atol=1e-12)
    if not full_cov:
        jy = jax.jit(jsvgp.predict_y)(jm, jnp.asarray(Xs))
        ty = tsvgp.predict_y(tm, t(Xs))
        for a, b in zip(ty, jy):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)
        jg = jax.jit(jsvgp.predict_f_guarded)(jm, jnp.asarray(Xs))
        tg = tsvgp.predict_f_guarded(tm, t(Xs))
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(tsvgp.prior_kl(tm)), float(jsvgp.prior_kl(jm)),
                                   rtol=1e-12)


@pytest.mark.parametrize("n,M,vtol,gtol", [(96, 16, 2e-4, 3e-3), (256, 64, 3e-3, 2e-2)],
                         ids=["gram_fused_test", "smoke_tpu"])
def test_torch_svgp_use_pallas_float32_matches_jax_interpret(n, M, vtol, gtol):
    """The opt-in kernel route in float32 (plain gram kernels here, JAX's
    Pallas kernels in interpret mode): on tests/test_svgp_gram_fused.py's
    problem at its tolerances, and on tools/smoke_tpu.py's (N cut to 256)
    at smoke_tpu's, against JAX and against the XLA-form route. At M = 64
    inducing points on [0, 30] with ℓ = 4, Kuu is ill-conditioned and the
    float32 lengthscale gradient moves ~0.8% between the two packages."""
    jm, tm = svgp_pair(M=M, dtype=np.float32, seed=7)
    X, Y = data(n, dtype=np.float32, seed=8)
    Xt, Yt = t(X, torch.float32), t(Y, torch.float32)
    assert jsvgp.svgp_gram_fused_supported(jm, jnp.asarray(X))
    assert tsvgp.svgp_gram_fused_supported(tm, Xt)
    jfn, tfn = ROUTES["fused/use_pallas"]
    jval, jgrad = jax.jit(jax.value_and_grad(jfn))(jm, jnp.asarray(X), jnp.asarray(Y))
    tval, tgrads = value_and_grads(tfn, tm, Xt, Yt)
    np.testing.assert_allclose(float(tval), float(jval), rtol=vtol)
    assert_grads(tgrads, jgrad, gtol, "use_pallas f32")
    xval, xgrads = value_and_grads(ROUTES["gaussian_elbo_gram"][1], tm, Xt, Yt)
    np.testing.assert_allclose(float(tval), float(xval), rtol=3e-3)
    for g, w in zip(tgrads, xgrads):
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) / scale <= 2e-2


# -- SGPR and VGP ------------------------------------------------------------------

def _sgpr_pair(mean=None):
    Z = np.linspace(0, 30, 10)[:, None]
    js = jsgpr.SGPR.create(jk.SquaredExponential.create(1.1, 3.0), Z, noise_variance=0.2,
                           mean_function=None if mean is None else JConstantMean.create(mean))
    td = dict(device="cpu", dtype=torch.float64)
    template = tsgpr.SGPR.create(
        tk.SquaredExponential.create(**td), Z,
        mean_function=None if mean is None else TConstantMean.create(mean, **td), **td)
    return js, tparams.from_jax_leaves(template, [np.asarray(x) for x in jax.tree.leaves(js)])


@pytest.mark.parametrize("mean", [None, 0.4])
def test_torch_sgpr_float64_matches_jax(mean):
    js, ts = _sgpr_pair(mean)
    X, Y = data(90, seed=4)
    jval, jgrad = jax.jit(jax.value_and_grad(jsgpr.elbo))(js, jnp.asarray(X), jnp.asarray(Y))
    tval, tgrads = value_and_grads(tsgpr.elbo, ts, t(X), t(Y))
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-10)
    assert_grads(tgrads, jgrad, 1e-8, "sgpr")
    Xs = np.linspace(-1, 31, 25)[:, None]
    for full_cov in (False, True):
        jo = jax.jit(jsgpr.predict_f, static_argnums=4)(js, jnp.asarray(X), jnp.asarray(Y),
                                                        jnp.asarray(Xs), full_cov)
        to = tsgpr.predict_f(ts, t(X), t(Y), t(Xs), full_cov)
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-11)
    for a, b in zip(tsgpr.predict_y(ts, t(X), t(Y), t(Xs)),
                    jax.jit(jsgpr.predict_y)(js, jnp.asarray(X), jnp.asarray(Y),
                                             jnp.asarray(Xs))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-11)


def test_torch_vgp_studentt_float64_matches_jax():
    """VGP with StudentT: the Gauss–Hermite ELBO, its gradients and the
    predictions, from random q_mu and q_sqrt."""
    X, Y = data(30, seed=6)
    rng = np.random.default_rng(9)
    jv = jvgp.VGP.create(30, jk.Matern32.create(1.2, 4.0), likelihood=JStudentT.create(0.3))
    jv = dataclasses.replace(jv, q_mu=jnp.asarray(rng.normal(size=(30, 1)) * 0.3),
                             q_sqrt=jnp.asarray(np.tril(rng.normal(size=(1, 30, 30)) * 0.05)
                                                + 0.5 * np.eye(30)))
    td = dict(device="cpu", dtype=torch.float64)
    tv = tparams.from_jax_leaves(
        tvgp.VGP.create(30, tk.Matern32.create(**td), likelihood=TStudentT.create(**td), **td),
        [np.asarray(x) for x in jax.tree.leaves(jv)])
    jval, jgrad = jax.jit(jax.value_and_grad(jvgp.elbo))(jv, jnp.asarray(X), jnp.asarray(Y))
    tval, tgrads = value_and_grads(tvgp.elbo, tv, t(X), t(Y))
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-10)
    assert_grads(tgrads, jgrad, 1e-8, "vgp")
    Xs = np.linspace(-1, 31, 20)[:, None]
    for full_cov in (False, True):
        jo = jax.jit(jvgp.predict_f, static_argnums=3)(jv, jnp.asarray(X), jnp.asarray(Xs), full_cov)
        to = tvgp.predict_f(tv, t(X), t(Xs), full_cov)
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-11)
    for a, b in zip(tvgp.predict_y(tv, t(X), t(Xs)),
                    jax.jit(jvgp.predict_y)(jv, jnp.asarray(X), jnp.asarray(Xs))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(
        tv.likelihood.log_prob(t(Y), t(Y) + 0.1).numpy(),
        np.asarray(jv.likelihood.log_prob(jnp.asarray(Y), jnp.asarray(Y) + 0.1)), rtol=1e-12)
