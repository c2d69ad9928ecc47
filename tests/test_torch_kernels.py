"""Port parity: kernels, parameters and mean functions vs the JAX package.

The same JAX model's leaves (numpy, `jax.tree.leaves` order) are carried
into the port with `params.from_jax_leaves`; K and Kdiag must agree in
float64 to rtol 1e-12 (same formulas, same distance expansion) with
atol 1e-7: on the diagonal the expansion leaves r² ~ 1e-16 of rounding
residue whose value depends on the matmul's summation order, and the
Matérn families take its square root (r ~ 1e-8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.models import gpr as jgpr
from portfoliooptgp_tpu.params import positive as j_positive
from portfoliooptgp_tpu.params import positive_inv as j_positive_inv
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.models import gpr as tgpr

# tiny matrices: one intra-op thread per test worker avoids oversubscribing the
# CPU when pytest-xdist runs several workers
torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64)

# name -> builder(kernel module, create kwargs); identical structure in both
CASES = {
    "se": lambda k, o: k.SquaredExponential.create(1.3, 0.7, **o),
    "matern12": lambda k, o: k.Matern12.create(0.8, 1.9, **o),
    "matern32": lambda k, o: k.Matern32.create(1.1, 0.5, **o),
    "matern52": lambda k, o: k.Matern52.create(2.0, 1.2, **o),
    "rq": lambda k, o: k.RationalQuadratic.create(0.9, 0.8, alpha=1.7, **o),
    "se_ard": lambda k, o: k.SquaredExponential.create(1.0, [0.5, 1.0, 2.0], **o),
    "m32_slice": lambda k, o: k.Matern32.create(1.0, 0.9, active_dims=slice(1, 3), **o),
    "rq_idx": lambda k, o: k.RationalQuadratic.create(1.2, 0.6, 2.5, active_dims=[0, 2], **o),
    "sum": lambda k, o: (k.SquaredExponential.create(0.7, 1.1, **o)
                         + k.Matern12.create(0.4, 2.2, **o)),
    "product": lambda k, o: (k.Matern52.create(1.5, 0.9, active_dims=slice(0, 2), **o)
                             * k.Exponential.create(0.6, 1.4, active_dims=slice(2, 3), **o)),
    "composite": lambda k, o: k.composite_kernel(3, k.Matern32, k.RationalQuadratic, **o),
    "constant": lambda k, o: k.Constant.create(0.7, **o),
    "white": lambda k, o: k.White.create(0.3, **o),
    "exp_white": lambda k, o: k.Exponential.create(1.2, 0.8, **o) + k.White.create(0.05, **o),
    "constant_slice_se": lambda k, o: (k.Constant.create(1.5, active_dims=[1], **o)
                                       * k.SquaredExponential.create(0.9, 1.3, **o)),
}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _port(name):
    jax_kern = CASES[name](jk, {})
    template = CASES[name](tk, CPU64)
    return jax_kern, tparams.from_jax_leaves(template, _leaves(jax_kern))


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_kernel_K_Kdiag_match_jax(name, rng):
    X = rng.uniform(-2, 2, (9, 3))
    X2 = rng.uniform(-2, 2, (6, 3))
    jax_kern, port = _port(name)
    tX, tX2 = torch.as_tensor(X), torch.as_tensor(X2)
    for got, want in (
        (port.K(tX)[0], jax_kern.K(jnp.asarray(X))),
        (port.K(tX, tX2)[0], jax_kern.K(jnp.asarray(X), jnp.asarray(X2))),
        (port.Kdiag(tX)[0], jax_kern.Kdiag(jnp.asarray(X))),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-7)


def test_torch_stacked_kernel_batches_models(rng):
    """Three JAX models stacked on the batch axis give three K slices."""
    X = rng.uniform(-2, 2, (7, 3))
    models = [CASES["composite"](jk, {}) for _ in range(3)]
    models = [jax.tree.map(lambda x, s=s: x + 0.1 * s, m) for s, m in enumerate(models)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *models)
    port = tparams.from_jax_leaves(CASES["composite"](tk, CPU64), _leaves(stacked))
    K = port.K(torch.as_tensor(X)).numpy()
    for b, m in enumerate(models):
        np.testing.assert_allclose(K[b], np.asarray(m.K(jnp.asarray(X))),
                                   rtol=1e-12, atol=1e-7)


def test_torch_positive_transform_matches_jax():
    vals = np.array([1e-5, 1e-3, 0.5, 1.0, 30.0])
    raw = tparams.positive_inv(torch.as_tensor(vals))
    np.testing.assert_allclose(raw.numpy(), np.asarray(j_positive_inv(vals)), rtol=1e-12)
    np.testing.assert_allclose(tparams.positive(raw).numpy(),
                               np.asarray(j_positive(jnp.asarray(raw.numpy()))), rtol=1e-12)


def test_torch_leaf_order_and_gpr_create():
    """The port lists leaves in `jax.tree.leaves` order (documented in
    params.py) and GPR.create builds the same tree as the JAX one."""
    jm = jgpr.GPR.create(CASES["composite"](jk, {}), noise_variance=1e-3)
    tm = tgpr.GPR.create(CASES["composite"](tk, CPU64), noise_variance=1e-3)
    jl, tl = _leaves(jm), tparams.tree_leaves(tm)
    assert len(jl) == len(tl) == 6
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy()[0], a, rtol=1e-12)


def test_torch_gpr_lml_and_predictions_match_jax(rng):
    """GPR log marginal likelihood, predict_f (diagonal and full) and
    predict_y of a two-model stack vs the JAX model, float64. Same
    Cholesky and solves on both sides: rtol 1e-10."""
    X, Y = rng.uniform(-2, 2, (12, 3)), rng.normal(size=(12, 1))
    Xnew = rng.uniform(-2, 2, (5, 3))
    jms = [jgpr.GPR.create(CASES["composite"](jk, {}), noise_variance=v) for v in (0.05, 0.2)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jms)
    tm = tparams.from_jax_leaves(tgpr.GPR.create(CASES["composite"](tk, CPU64)),
                                 _leaves(jstack))
    jX, jY, jXn = jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Xnew)

    def jax_outputs(m):
        return (jgpr.log_marginal_likelihood(m, jX, jY), *jgpr.predict_f(m, jX, jY, jXn),
                jgpr.predict_f(m, jX, jY, jXn, full_cov=True)[1],
                *jgpr.predict_y(m, jX, jY, jXn))

    want = jax.jit(jax.vmap(jax_outputs))(jstack)
    tX, tY, tXn = torch.as_tensor(X), torch.as_tensor(Y), torch.as_tensor(Xnew)
    got = (tgpr.log_marginal_likelihood(tm, tX, tY), *tgpr.predict_f(tm, tX, tY, tXn),
           tgpr.predict_f(tm, tX, tY, tXn, full_cov=True)[1], *tgpr.predict_y(tm, tX, tY, tXn))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)


def test_torch_from_jax_leaves_rejects_wrong_structure():
    with pytest.raises(ValueError):
        tparams.from_jax_leaves(CASES["se"](tk, CPU64), [np.ones(())])


def test_torch_white_same_row_count_quirk(rng):
    """White's K(X, X2) is σ²I whenever X2 has as many rows as X, even
    when X2 is not X (as in the JAX package), and zero otherwise."""
    jax_kern, port = _port("white")
    X, X2 = rng.uniform(-2, 2, (6, 3)), rng.uniform(-2, 2, (6, 3))
    got = port.K(torch.as_tensor(X), torch.as_tensor(X2))[0].numpy()
    np.testing.assert_allclose(got, np.asarray(jax_kern.K(jnp.asarray(X), jnp.asarray(X2))),
                               rtol=1e-12)
    np.testing.assert_allclose(got, 0.3 * np.eye(6), rtol=1e-12)
    assert not port.K(torch.as_tensor(X), torch.as_tensor(X2[:4])).any()


def test_torch_constant_white_leaf_order():
    """`from_jax_leaves` carries Constant's and White's variances across, in
    `jax.tree.leaves` order, inside a sum and a GPR."""
    def build(k, o):
        return (k.Exponential.create(1.2, 0.8, **o) + k.White.create(0.05, **o)
                + k.Constant.create(0.4, **o))

    jm = jgpr.GPR.create(build(jk, {}), noise_variance=1e-3)
    tm = tparams.from_jax_leaves(tgpr.GPR.create(build(tk, CPU64)), _leaves(jm))
    jl, tl = _leaves(jm), tparams.tree_leaves(tm)
    assert len(jl) == len(tl) == 5
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy()[0], a, rtol=1e-15)
    np.testing.assert_allclose(tm.kernel.terms[1].variance.numpy(), [0.05], rtol=1e-12)
    np.testing.assert_allclose(tm.kernel.terms[2].variance.numpy(), [0.4], rtol=1e-12)


def _white_stack(N, rng, B=3):
    """B `GPR(Exponential + White)` models (JAX stack and its port) on N
    day indices, with a series."""
    jms = [jgpr.GPR.create(jk.Exponential.create(1.0 + 0.3 * b, 0.5 + 0.4 * b)
                           + jk.White.create(0.02 * (b + 1)), noise_variance=0.01 * (b + 1))
           for b in range(B)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jms)
    tm = tparams.from_jax_leaves(tgpr.GPR.create(CASES["exp_white"](tk, CPU64)),
                                 _leaves(jstack))
    t = np.linspace(-1.7, 1.7, N)[:, None]
    return jstack, tm, t, np.sin(3 * t) + 0.1 * rng.normal(size=(N, 1))


@pytest.mark.parametrize("N,tier", [(77, "pallas_dense"), (300, "blocked")])
def test_torch_white_sum_routes_as_jax(N, tier, rng):
    """White is no fused atom: in float32 `Exponential + White` takes the
    dense tier at padded N ≤ 256 and the blocked tiers above, as JAX's
    router decides."""
    jstack, tm, X, Y = _white_stack(N, rng)
    j32 = jax.tree.map(lambda x: x.astype(jnp.float32), jstack)
    t32 = tparams.tree_to(tm, "cpu", torch.float32)
    want = jgpr.nll_tier(j32, jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32))
    got = tgpr.nll_tier(t32, torch.tensor(X, dtype=torch.float32),
                        torch.tensor(Y, dtype=torch.float32))
    assert got == want == tier
    assert tgpr.fused_stationary_spec(t32, torch.tensor(X, dtype=torch.float32)) is None


def test_torch_white_sum_nll_value_and_grad_match_jax(rng):
    """`batched_neg_log_marginal_likelihood` of `Exponential + White` in
    float64, and the dense tier's function (`ops/nll.batched_nll`, its
    plain version here) on the K it builds, against JAX's value and
    gradient at rtol 1e-8."""
    from portfoliooptgp_tpu_torch.ops import nll as tnll

    jstack, tm, X, Y = _white_stack(77, rng)
    jX, jY = jnp.asarray(X), jnp.asarray(Y)
    jv, jg = jax.value_and_grad(
        lambda m: jgpr.batched_neg_log_marginal_likelihood(m, jX, jY).sum())(jstack)
    jv = np.asarray(jgpr.batched_neg_log_marginal_likelihood(jstack, jX, jY))
    jg = [np.asarray(g) for g in jax.tree.leaves(jg)]
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)

    def dense(m):
        return tnll.batched_nll(m.kernel.K(tX), tY[:, 0].expand(3, -1),
                                m.likelihood.variance)

    def routed(m):
        return tgpr.batched_neg_log_marginal_likelihood(m, tX, tY, **CPU64)

    for fn in (routed, dense):
        leaves = [x.clone().requires_grad_(True) for x in tparams.tree_leaves(tm)]
        value = fn(tparams.tree_replace(tm, leaves))
        grads = torch.autograd.grad(value.sum(), leaves)
        np.testing.assert_allclose(value.detach().numpy(), jv, rtol=1e-8)
        for g, w in zip(grads, jg):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-8, atol=1e-10)
