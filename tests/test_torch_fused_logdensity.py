"""The port's chain-batched GPR log-densities
(portfoliooptgp_tpu_torch/inference/fused_logdensity.py) against the JAX
package's (portfoliooptgp_tpu/inference/fused_logdensity.py, vmapped over
the chains as its sampler calls them), on the CPU with torch on one thread.

- float64 on a C = 4 stack (the router's plain 'xla' tier in both): values
  and gradients rtol 1e-10 (Cholesky factors from LAPACK against XLA);
- float32 through the kernels' plain twins at tools/smoke_tpu.py's check
  (C = 8, N = 128, SE, the 'fused_stationary' tier): against JAX's float64
  value_and_grad of the dense log-density at smoke_tpu's tolerances, values
  rtol 3e-3 and gradients normalized atol 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.inference.fused_logdensity import gpr_logdensity_pair as jpair
from portfoliooptgp_tpu.inference.fused_logdensity import gpr_logdensity_vg as jvg
from portfoliooptgp_tpu.inference.sampler import centered_normal_logprior as jprior
from portfoliooptgp_tpu.models import gpr as jgpr
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.inference import centered_normal_logprior as tprior
from portfoliooptgp_tpu_torch.inference import gpr_logdensity_pair as tpair
from portfoliooptgp_tpu_torch.inference import gpr_logdensity_vg as tvg
from portfoliooptgp_tpu_torch.models import gpr as tgpr

torch.set_num_threads(1)


def _problem(n, C, dtype, seed=0):
    """tests/test_fused_logdensity.py's stack of C models in both packages."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 60, (n, 1)), axis=0)
    Y = np.sin(X / 8) + 0.1 * rng.normal(size=(n, 1))
    if dtype == torch.float32:
        X, Y = X.astype(np.float32), Y.astype(np.float32)
    m0 = jgpr.GPR.create(jk.SquaredExponential.create(1.0, 5.0), noise_variance=0.1)
    ms = jax.tree.map(lambda x: jnp.stack([x] * C) * jnp.linspace(0.9, 1.1, C), m0)
    template = tgpr.GPR.create(tk.SquaredExponential.create(device="cpu", dtype=dtype))
    tms = tparams.from_jax_leaves(template, [np.asarray(x) for x in jax.tree.leaves(ms)])
    tm0 = tparams.from_jax_leaves(template, [np.asarray(x) for x in jax.tree.leaves(m0)])
    return (jnp.asarray(X, jnp.float64), jnp.asarray(Y, jnp.float64), m0, ms,
            torch.tensor(X), torch.tensor(Y), tm0, tms)


def _leaves(tree):
    return [x.detach().numpy() for x in tparams.tree_leaves(tree)]


@pytest.mark.parametrize("with_prior", [False, True])
def test_torch_logdensity_pair_and_vg_match_jax(with_prior):
    jX, jY, m0, ms, tX, tY, tm0, tms = _problem(40, 4, torch.float64)
    jlp = jprior(m0) if with_prior else None
    tlp = tprior(tm0) if with_prior else None
    jlogp, jgrad = jpair(jX, jY, jlp)
    tlogp, tgrad = tpair(tX, tY, tlp)
    want_v = np.asarray(jax.vmap(jlogp)(ms))
    want_g = [np.asarray(x) for x in jax.tree.leaves(jax.vmap(jgrad)(ms))]
    np.testing.assert_allclose(tlogp(tms).numpy(), want_v, rtol=1e-10)
    for g, w in zip(_leaves(tgrad(tms)), want_g):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)
    v, g = tvg(tX, tY, tlp)(tms)
    jv, jg = jax.vmap(jvg(jX, jY, jlp))(ms)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-10)
    for a, b in zip(_leaves(g), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10, atol=1e-12)
    if with_prior:
        # the prior is added per chain: the difference is the prior alone
        bare = tpair(tX, tY)[0](tms)
        np.testing.assert_allclose((v - bare).numpy(), np.asarray(jax.vmap(jlp)(ms)),
                                   rtol=1e-9)
        assert torch.all(v < bare)  # every chain but the centre is off-centre


def test_torch_logdensity_vg_single_chain_takes_the_router():
    """B = 1 through the router equals JAX's unbatched (dense) call."""
    jX, jY, m0, _, tX, tY, tm0, _ = _problem(40, 4, torch.float64)
    v, g = tvg(tX, tY)(tm0)
    jv, jg = jvg(jX, jY)(m0)
    np.testing.assert_allclose(v.numpy(), [float(jv)], rtol=1e-10)
    for a, b in zip(_leaves(g), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.reshape(np.shape(b)), np.asarray(b), rtol=1e-10)


def test_torch_logdensity_vg_float32_plain_twin():
    """smoke_tpu's fused NUTS log-density check (C = 8, N = 128) in float32
    on the CPU, where the fused tier runs the kernel's plain twin."""
    rng = np.random.default_rng(0)
    n, C = 128, 8
    X = np.sort(rng.uniform(0, 30, (n, 1)), axis=0).astype(np.float32)
    Y = rng.normal(size=(n, 1)).astype(np.float32)
    m0 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                      jgpr.GPR.create(jk.SquaredExponential.create(1.0, 5.0), noise_variance=0.1))
    ms = jax.tree.map(lambda x: jnp.stack([x] * C) * jnp.linspace(0.9, 1.1, C, dtype=x.dtype), m0)
    ms64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), ms)
    dense = jax.value_and_grad(lambda m: jgpr.log_marginal_likelihood(
        m, jnp.asarray(X, jnp.float64), jnp.asarray(Y, jnp.float64)))
    vr, gr = jax.vmap(dense)(ms64)
    template = tgpr.GPR.create(tk.SquaredExponential.create(device="cpu", dtype=torch.float32))
    tms = tparams.from_jax_leaves(template, [np.asarray(x) for x in jax.tree.leaves(ms)])
    tX, tY = torch.tensor(X), torch.tensor(Y)
    assert tgpr.nll_tier(tms, tX, tY) == "fused_stationary"
    v, g = tvg(tX, tY)(tms)
    assert v.dtype == torch.float32 and torch.all(torch.isfinite(v))
    np.testing.assert_allclose(v.numpy(), np.asarray(vr), rtol=3e-3)
    for a, b in zip(_leaves(g), jax.tree.leaves(gr)):
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a / scale, np.asarray(b) / scale, atol=2e-2)
