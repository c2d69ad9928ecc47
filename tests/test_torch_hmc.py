"""The port's HMC building blocks (portfoliooptgp_tpu_torch/inference/hmc.py)
against the JAX package's (portfoliooptgp_tpu/inference/hmc.py), float64
on the CPU with torch on one thread. The port works on a leading chain
axis; the JAX functions are vmapped over it. Random draws replay the JAX
keys (tests/jax_replay.py), so the two follow the same path.

Tolerances: the same formulas in the same order, float64: rtol 1e-12 for
the adaptation arithmetic, 1e-10 where a GPR log-density (a Cholesky
factor, LAPACK against XLA) enters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_replay import JaxKeys, SmallGPRPosterior

from portfoliooptgp_tpu.inference import hmc as jhmc
from portfoliooptgp_tpu_torch.inference import hmc as thmc

torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def post():
    return SmallGPRPosterior()


def test_torch_dual_averaging_matches_jax():
    rng = np.random.default_rng(0)
    eps = np.array([0.5, 0.05, 2.0])
    accepts = rng.uniform(size=(30, 3))
    jda = jax.vmap(jhmc.da_init)(jnp.asarray(eps))
    tda = thmc.da_init(_t(eps))
    for a in accepts:
        jda = jax.vmap(lambda s, x: jhmc.da_update(s, x, target=0.8))(jda, jnp.asarray(a))
        tda = thmc.da_update(tda, _t(a), target=0.8)
    for j, t in zip(jda, tda):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)
    # a float32 step size stays float32; a Python number becomes float64
    assert thmc.da_init(torch.tensor([0.1, 0.2], dtype=torch.float32)).log_step.dtype == torch.float32
    assert thmc.da_init(1.0).mu.dtype == torch.float64


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("regularize", [False, True])
def test_torch_welford_matches_jax(dense, regularize):
    rng = np.random.default_rng(1)
    C, n, d = 3, 40, 4
    xs = rng.normal(size=(n, C, d)) @ np.array([[1.0, 0.6, 0.0, 0.1], [0.0, 0.8, 0.3, 0.0],
                                                [0.0, 0.0, 0.5, 0.2], [0.0, 0.0, 0.0, 2.0]])
    xs += np.arange(C)[None, :, None]  # chains with different means
    jwf = jax.vmap(lambda _: jhmc.welford_init(d, dense=dense))(jnp.arange(C))
    twf = thmc.welford_init(d, torch.float64, dense=dense, chains=C, device="cpu")
    for x in xs:
        jwf = jax.vmap(jhmc.welford_update)(jwf, jnp.asarray(x))
        twf = thmc.welford_update(twf, _t(x))
    want = jax.vmap(lambda s: jhmc.welford_variance(s, regularize=regularize))(jwf)
    got = thmc.welford_variance(twf, regularize=regularize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)
    # pooled over the chains: the JAX package's psum over a vmapped axis
    want = jax.vmap(lambda s: jhmc.welford_variance(s, axis_name="c", regularize=regularize),
                    axis_name="c")(jwf)
    got = thmc.welford_variance(twf, regularize=regularize, pool=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)


def test_torch_welford_axis_name_raises():
    wf = thmc.welford_init(2, chains=2, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        thmc.welford_variance(wf, axis_name="hosts")


@pytest.mark.parametrize("dense", [False, True])
def test_torch_leapfrog_gpr_posterior_matches_jax(post, dense):
    """Eight leapfrog steps from given momenta on the small GPR posterior."""
    C = 3
    rng = np.random.default_rng(2)
    q = post.points(C)
    p = rng.normal(size=(C, post.dim))
    eps = np.array([0.05, 0.1, 0.02])
    if dense:
        A = rng.normal(size=(C, post.dim, post.dim)) * 0.3
        inv_mass = np.eye(post.dim) + A @ np.swapaxes(A, 1, 2)
    else:
        inv_mass = rng.uniform(0.5, 2.0, (C, post.dim))
    want = jax.vmap(lambda q, p, e, m: jhmc.leapfrog(jax.grad(post.jlogp), q, p, e, m, 8))(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(eps), jnp.asarray(inv_mass))
    got = thmc.leapfrog(post.tgrad, _t(q), _t(p), _t(eps), _t(inv_mass), 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(thmc.kinetic(got[1], _t(inv_mass)).numpy(),
                               np.asarray(jax.vmap(jhmc.kinetic)(want[1], jnp.asarray(inv_mass))),
                               rtol=1e-12)


@pytest.mark.parametrize("dense", [False, True])
def test_torch_hmc_step_replays_jax(post, dense):
    """Five HMC transitions of 3 chains, momenta and accept draws replayed
    from the JAX keys."""
    C = 3
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    q = post.points(C)
    inv_mass = (np.tile(np.eye(post.dim) * 0.05, (C, 1, 1)) if dense
                else np.full((C, post.dim), 0.05))
    jstate = jhmc.HMCState(jnp.asarray(q), jax.vmap(post.jlogp)(jnp.asarray(q)), keys)
    tstate = thmc.HMCState(_t(q), post.tlogp(_t(q)), JaxKeys(keys))
    jstep = jax.vmap(lambda s, m: jhmc.hmc_step(post.jlogp, jax.grad(post.jlogp), s, 0.3, m, 4))
    for _ in range(5):
        jstate, jacc = jstep(jstate, jnp.asarray(inv_mass))
        tstate, tacc = thmc.hmc_step(post.tlogp, post.tgrad, tstate, 0.3, _t(inv_mass), 4)
        np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=1e-10)
        np.testing.assert_allclose(tstate.q.numpy(), np.asarray(jstate.q), rtol=1e-10)
        np.testing.assert_allclose(tstate.logp.numpy(), np.asarray(jstate.logp), rtol=1e-10)
        np.testing.assert_array_equal(np.asarray(tstate.key.keys), np.asarray(jstate.key))


def test_torch_find_reasonable_step_size_replays_jax(post):
    """Chains that double and chains that halve, each stopping on its own."""
    C = 4
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    q = post.points(C, scale=0.5)
    inv_mass = np.array([[1.0] * 4, [1e-4] * 4, [0.05] * 4, [10.0] * 4])
    want = jax.vmap(lambda q, m, k: jhmc.find_reasonable_step_size(
        post.jlogp, jax.grad(post.jlogp), q, m, k))(jnp.asarray(q), jnp.asarray(inv_mass), keys)
    got = thmc.find_reasonable_step_size(post.tlogp, post.tgrad, _t(q), _t(inv_mass),
                                         JaxKeys(keys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    assert len(set(np.asarray(want).tolist())) > 1, "every chain stopped at the same step"
