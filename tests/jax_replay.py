"""A random source for the port's samplers that replays `jax.random` keys.

The port's samplers draw through a source (portfoliooptgp_tpu_torch/
inference/source.py); this one holds C JAX keys, one per chain, and
draws exactly what the JAX package's chain vmap draws from them, so the
port's NUTS and HMC can be held against the JAX package's draw for draw.
CPU tensors only; the tests use it in float64.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

_JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32}


@partial(jax.jit, static_argnums=1)
def _split(keys, n):
    return jax.vmap(lambda k: jax.random.split(k, n))(keys)


@partial(jax.jit, static_argnums=(1, 2))
def _normal(keys, shape, dtype):
    return jax.vmap(lambda k: jax.random.normal(k, shape, dtype))(keys)


@partial(jax.jit, static_argnums=1)
def _uniform(keys, dtype):
    if dtype is None:
        return jax.vmap(lambda k: jax.random.uniform(k))(keys)
    return jax.vmap(lambda k: jax.random.uniform(k, dtype=dtype))(keys)


@jax.jit
def _bernoulli(keys):
    return jax.vmap(jax.random.bernoulli)(keys)


class JaxKeys:
    """C chains' `jax.random` keys, (C, 2) uint32."""

    def __init__(self, keys):
        self.keys = jnp.asarray(keys)

    @classmethod
    def split_from(cls, key, chains):
        """The per-chain keys of `jax.random.split(key, chains)`, as the JAX
        sampler makes them."""
        return cls(jax.random.split(key, chains))

    def split(self, n):
        ks = _split(self.keys, n)
        return [JaxKeys(ks[:, i]) for i in range(n)]

    def normal(self, shape, dtype):
        return torch.from_numpy(np.array(_normal(self.keys, tuple(shape), _JNP[dtype])))

    def uniform(self, dtype=None):
        return torch.from_numpy(np.array(_uniform(self.keys, _JNP.get(dtype))))

    def bernoulli(self):
        return torch.from_numpy(np.array(_bernoulli(self.keys)))

    def where(self, active, old):
        mask = jnp.asarray(active.numpy())[:, None]
        return JaxKeys(jnp.where(mask, self.keys, old.keys))


class SmallGPRPosterior:
    """The hyperposterior of a small GPR in both packages, float64, over the
    flat raw parameters (ravel order: variance, 2 ARD lengthscales, noise):
    N = 32 points in D = 2, SE(1.0, [1.5, 2.0]), noise 0.1, and
    centered_normal_logprior(m0). `jlogp` is one chain's JAX log-density of
    a flat (4,) vector, `tlogp` / `tvg` the port's of (C, 4) flats."""

    def __init__(self, seed=0, n=32):
        import jax.flatten_util

        from portfoliooptgp_tpu import kernels as jk
        from portfoliooptgp_tpu.inference.sampler import centered_normal_logprior as jprior
        from portfoliooptgp_tpu.models import gpr as jgpr
        from portfoliooptgp_tpu_torch import kernels as tk
        from portfoliooptgp_tpu_torch import params as tparams
        from portfoliooptgp_tpu_torch.inference import centered_normal_logprior as tprior
        from portfoliooptgp_tpu_torch.models import gpr as tgpr

        rng = np.random.default_rng(seed)
        X = rng.uniform(0, 6, (n, 2))
        Y = (np.sin(X[:, :1]) + 0.3 * np.cos(X[:, 1:]) + 0.1 * rng.normal(size=(n, 1)))
        self.jm0 = jgpr.GPR.create(jk.SquaredExponential.create(1.0, np.array([1.5, 2.0])),
                                   noise_variance=0.1)
        self.flat0, self.unravel = jax.flatten_util.ravel_pytree(self.jm0)
        self.jX, self.jY = jnp.asarray(X), jnp.asarray(Y)
        prior = jprior(self.jm0)
        self.jlogp_model = lambda m: jgpr.log_marginal_likelihood(m, self.jX, self.jY) + prior(m)
        self.jlogp = lambda z: self.jlogp_model(self.unravel(z))
        template = tgpr.GPR.create(tk.SquaredExponential.create(
            1.0, [1.0, 1.0], device="cpu", dtype=torch.float64), noise_variance=0.1)
        self.tm0 = tparams.from_jax_leaves(template, [np.asarray(x)
                                                      for x in jax.tree.leaves(self.jm0)])
        self.tX, self.tY = torch.tensor(X), torch.tensor(Y)
        tp = tprior(self.tm0)
        self.tlogp_model = lambda m: -tgpr.batched_neg_log_marginal_likelihood(
            m, self.tX, self.tY, device="cpu", dtype=torch.float64) + tp(m)
        self.tlogp = lambda z: self.tlogp_model(tparams.unravel(self.tm0, z))
        self.dim = int(self.flat0.shape[0])

    def tgrad(self, z):
        return self.tvg(z)[1]

    def tvg(self, z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            v = self.tlogp(z)
            (g,) = torch.autograd.grad(v.sum(), z)
        return v.detach(), g

    def points(self, chains, seed=1, scale=0.2):
        """(C, dim) numpy points around m0."""
        rng = np.random.default_rng(seed)
        return np.asarray(self.flat0)[None] + scale * rng.normal(size=(chains, self.dim))
