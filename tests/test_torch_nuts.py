"""The port's NUTS (portfoliooptgp_tpu_torch/inference/nuts.py, sampler.py)
against the JAX package's, on the CPU with torch on one thread.

- Key replay (float64): the port draws through tests/jax_replay.JaxKeys,
  which replays the JAX keys of each chain, so one `nuts_step` and a short
  `sample_nuts` run follow the JAX package's trajectories draw for draw:
  tree sizes, depths and divergences equal, positions, log densities and
  gradients at rtol 1e-10 (the Cholesky factors of the GPR posterior
  round differently in LAPACK and XLA), samples at rtol 1e-8 after 20
  transitions with step-size and mass adaptation.
- Torch-generator runs mirror tests/test_nuts.py's fast cases: recovery of
  a correlated Gaussian within Monte Carlo error, mass adaptation on a
  scale mismatch, and a log-density that is -inf on half the space.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_replay import JaxKeys, SmallGPRPosterior

from portfoliooptgp_tpu.inference import nuts as jnuts
from portfoliooptgp_tpu.inference import sample_nuts as jsample
from portfoliooptgp_tpu.inference.fused_logdensity import gpr_logdensity_vg as jvg_of
from portfoliooptgp_tpu_torch.inference import nuts as tnuts
from portfoliooptgp_tpu_torch.inference import sample_nuts as tsample
from portfoliooptgp_tpu_torch.inference.fused_logdensity import gpr_logdensity_vg as tvg_of
from portfoliooptgp_tpu_torch.params import tree_leaves

torch.set_num_threads(1)

COV = np.array([[2.0, 1.2], [1.2, 1.5]])
PREC = np.linalg.inv(COV)


def _t(x):
    return torch.tensor(np.asarray(x))


def _gaussian():
    P = _t(PREC)

    def jlogp(q):
        return -0.5 * q @ jnp.asarray(PREC) @ q

    def tvg(q):
        return -0.5 * torch.einsum("ci,ij,cj->c", q, P, q), -(q @ P)

    return jlogp, tvg


def _nan_region():
    def jlogp(q):
        safe = jnp.where(q[0] > 0, jnp.log(jnp.maximum(q[0], 1e-300)), -jnp.inf)
        return safe - 0.5 * jnp.sum(q**2)

    def tlogp(q):
        safe = torch.where(q[:, 0] > 0, torch.log(torch.clamp_min(q[:, 0], 1e-300)),
                           torch.full_like(q[:, 0], -float("inf")))
        return safe - 0.5 * torch.sum(q**2, dim=-1)

    def tvg(q):
        with torch.enable_grad():
            q = q.detach().requires_grad_(True)
            v = tlogp(q)
            (g,) = torch.autograd.grad(v.sum(), q)
        return v.detach(), g

    return jlogp, tvg, tlogp


@pytest.fixture(scope="module")
def post():
    return SmallGPRPosterior()


@pytest.mark.parametrize("case", ["gaussian", "gaussian-dense", "nan-region", "gpr"])
def test_torch_nuts_step_replays_jax(post, case):
    C, depth = 4, 6
    rng = np.random.default_rng(5)
    if case == "gpr":
        jlogp, tvg, eps = post.jlogp, post.tvg, 0.15
        q = post.points(C)
    elif case == "nan-region":
        jlogp, tvg, _ = _nan_region()
        eps = 1.5  # long steps: some trajectories cross into the -inf half
        q = np.abs(rng.normal(size=(C, 2))) + 0.2
    else:
        jlogp, tvg = _gaussian()
        eps = 0.6
        q = rng.normal(size=(C, 2))
    dim = q.shape[1]
    if case == "gaussian-dense":
        inv_mass = np.tile(COV, (C, 1, 1)) + 0.1 * np.eye(dim)
    else:
        inv_mass = np.ones((C, dim)) * (0.05 if case == "gpr" else 1.0)
    keys = jax.random.split(jax.random.PRNGKey(7), C)
    jvg = jax.value_and_grad(jlogp)
    jq, jl, jg, jinfo = jax.vmap(
        lambda q, k, m: jnuts.nuts_step(jvg, q, jlogp(q), k, eps, m, depth))(
        jnp.asarray(q), keys, jnp.asarray(inv_mass))
    tq = _t(q)
    got_q, got_l, got_g, info = tnuts.nuts_step(tvg, tq, tvg(tq)[0], JaxKeys(keys), eps,
                                                _t(inv_mass), depth)
    for name in ("num_leaves", "depth", "diverging"):
        np.testing.assert_array_equal(getattr(info, name).numpy(), np.asarray(getattr(jinfo, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(jq), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(jl), rtol=1e-10)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(info.accept_prob.numpy(), np.asarray(jinfo.accept_prob),
                               rtol=1e-10)
    assert len(set(np.asarray(jinfo.num_leaves).tolist())) > 1, "the chains stopped together"
    if case == "nan-region":
        assert np.asarray(jinfo.diverging).any()


@pytest.mark.parametrize("dense", [False, True])
def test_torch_sample_nuts_replays_jax(post, dense):
    """2 chains, 10 warmup + 10 samples, shared adaptation, on the small GPR
    posterior through each package's chain-batched `gpr_logdensity_vg`."""
    from portfoliooptgp_tpu.inference.sampler import centered_normal_logprior as jprior
    from portfoliooptgp_tpu_torch.inference import centered_normal_logprior as tprior

    args = dict(num_warmup=10, num_samples=10, num_chains=2, max_depth=6, dense_mass=dense)
    key = jax.random.PRNGKey(11)
    jsamples, jstats = jsample(post.jlogp_model, post.jm0, key,
                               vg_fn=jvg_of(post.jX, post.jY, jprior(post.jm0)), **args)
    tsamples, tstats = tsample(post.tlogp_model, post.tm0, JaxKeys.split_from(key, 2),
                               vg_fn=tvg_of(post.tX, post.tY, tprior(post.tm0)),
                               device="cpu", **args)
    for g, w in zip(tree_leaves(tsamples), jax.tree.leaves(jsamples)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8)
    np.testing.assert_array_equal(tstats.num_leaves.numpy(), np.asarray(jstats.num_leaves))
    np.testing.assert_array_equal(tstats.diverging.numpy(), np.asarray(jstats.diverging))
    for name in ("accept_prob", "step_size", "inv_mass"):
        np.testing.assert_allclose(getattr(tstats, name).numpy(),
                                   np.asarray(getattr(jstats, name)), rtol=1e-8, err_msg=name)


def _batch_mcse(draws, batches=10):
    m = draws[: len(draws) // batches * batches].reshape(batches, -1, draws.shape[-1]).mean(1)
    return m.std(0, ddof=1) / np.sqrt(batches)


@pytest.mark.parametrize("dense", [False, True])
def test_torch_nuts_recovers_gaussian(dense):
    """tests/test_nuts.py's fast recovery case on a torch generator: the
    mean within 4 Monte Carlo standard errors (batch means) of 0, the
    covariance within test_nuts's atol 0.7."""
    _, tvg = _gaussian()
    samples, stats = tsample(lambda m: tvg(m)[0], torch.zeros((1, 2), dtype=torch.float64),
                             torch.Generator().manual_seed(0), num_warmup=150,
                             num_samples=350, num_chains=2, max_depth=6, dense_mass=dense,
                             vg_fn=lambda m: tvg(m), device="cpu")
    draws = samples.numpy().reshape(-1, 2)
    assert np.all(np.abs(draws.mean(0)) <= 4 * _batch_mcse(draws))
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.7)
    assert float(stats.accept_prob.mean()) > 0.5
    assert float(stats.diverging.double().mean()) < 0.05


def test_torch_nuts_scale_mismatch():
    """tests/test_nuts.py's scale-mismatch case: the adapted metric follows
    a 100x scale ratio and both scales mix."""
    scales = torch.tensor([0.1, 10.0], dtype=torch.float64)

    def vg(q):
        return -0.5 * torch.sum((q / scales) ** 2, dim=-1), -q / scales**2

    samples, stats = tsample(lambda q: vg(q)[0], torch.zeros((1, 2), dtype=torch.float64),
                             torch.Generator().manual_seed(1), num_warmup=500,
                             num_samples=1000, num_chains=1, max_depth=9, vg_fn=vg,
                             device="cpu")
    draws = samples.numpy().reshape(-1, 2)
    np.testing.assert_allclose(draws.std(0), scales.numpy(), rtol=0.25)
    inv_mass = stats.inv_mass.numpy().reshape(-1, 2)
    assert inv_mass[0, 1] / inv_mass[0, 0] > 100


def test_torch_nuts_nan_regions():
    """tests/test_nuts.py's -inf region: no NaN draws, every draw in q0 > 0;
    chains that diverge there keep their last state."""
    _, tvg, tlogp = _nan_region()
    samples, stats = tsample(tlogp, torch.tensor([[1.0, 0.0]], dtype=torch.float64),
                             torch.Generator().manual_seed(2), num_warmup=200,
                             num_samples=300, num_chains=2, max_depth=6, device="cpu")
    draws = samples.numpy().reshape(-1, 2)
    assert np.all(np.isfinite(draws))
    assert np.all(draws[:, 0] > 0)


def test_torch_ctz():
    n = torch.arange(1, 1025)
    want = [(int(k) & -int(k)).bit_length() - 1 for k in n]
    assert tnuts._ctz(n).tolist() == want
    assert [tnuts._ctz(int(k)) for k in n] == want


def test_torch_sample_nuts_with_pair_runs(post):
    """`grad_fn` without `vg_fn` (the log-density pair, two evaluations a
    leapfrog): finite draws of the model's leaves, [chain, draw] first."""
    from portfoliooptgp_tpu_torch.inference import centered_normal_logprior, gpr_logdensity_pair

    logp, grad = gpr_logdensity_pair(post.tX, post.tY, centered_normal_logprior(post.tm0))
    samples, stats = tsample(logp, post.tm0, torch.Generator().manual_seed(3), num_warmup=10,
                             num_samples=10, num_chains=3, max_depth=5, grad_fn=grad,
                             device="cpu")
    shapes = [tuple(x.shape) for x in tree_leaves(samples)]
    assert shapes == [(3, 10), (3, 10, 2), (3, 10)]
    assert all(torch.all(torch.isfinite(x)) for x in tree_leaves(samples))
    assert stats.accept_prob.shape == (3, 10) and stats.inv_mass.shape == (3, post.dim)
