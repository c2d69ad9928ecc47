"""Monte-Carlo probability estimates for the dynamic strategy.

Port of portfoliooptgp_tpu/portfolio/montecarlo.py. Draws come from a
seeded `torch.Generator` on the target device, which gives other numbers
than `jax.random` from the same seed; `draws=(z_a, z_b)` feeds given
standard-normal draws instead (the tests hand both packages the same
ones). The mesh-sharded estimate splits the budget over the data axis:
each rank draws ceil(n / D) samples from its own stream and one all-reduce
sums the hits.
"""

from __future__ import annotations

import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, as_tensor, resolve_device
from portfoliooptgp_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce_sum, stream_seed


def probability_a_greater_than_b_cdf(mu_a, sigma_a, mu_b, sigma_b):
    """P(A > B) for independent 1-D normals: 1 − Φ(0; μ_A−μ_B, √(σ_A²+σ_B²))."""
    mu_diff = torch.as_tensor(mu_a) - mu_b
    sigma_diff = torch.sqrt(torch.as_tensor(sigma_a) ** 2 + sigma_b ** 2)
    return 1.0 - torch.special.ndtr((0.0 - mu_diff) / sigma_diff)


def _mvn_sample(z, mu, cov):
    # jitter for rank-deficient covariances (correlation-scaled outer products)
    L = torch.linalg.cholesky(cov + 1e-12 * torch.eye(cov.shape[0], dtype=mu.dtype,
                                                      device=mu.device))
    return mu + z @ L.T


def probability_a_greater_than_b_mvnorm(mu_a, cov_a, mu_b, cov_b, num_samples: int = 10_000,
                                        seed: int = 0, *, draws=None,
                                        device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
    """MC estimate of P(A > B in every dimension) for two MVNs."""
    dev = resolve_device(device)
    hits = _hits(mu_a, cov_a, mu_b, cov_b, num_samples, seed, draws, dev, dtype)
    return float(hits.to(dtype) / num_samples)


def _hits(mu_a, cov_a, mu_b, cov_b, num_samples, seed, draws, dev, dtype):
    """The number of draws with A > B in every dimension (a 0-d tensor)."""
    mu_a, cov_a, mu_b, cov_b = (as_tensor(x, dev, dtype) for x in (mu_a, cov_a, mu_b, cov_b))
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        shape = (num_samples, mu_a.shape[0])
        draws = (torch.randn(shape, generator=gen, dtype=dtype, device=dev),
                 torch.randn(shape, generator=gen, dtype=dtype, device=dev))
    za, zb = (as_tensor(z, dev, dtype) for z in draws)
    sa = _mvn_sample(za, mu_a, cov_a)
    sb = _mvn_sample(zb, mu_b, cov_b)
    return torch.sum(torch.all(sa > sb, dim=1))


def probability_a_greater_than_b_mvnorm_sharded(mu_a, cov_a, mu_b, cov_b, mesh,
                                                num_samples: int = 10_000, seed: int = 0, *,
                                                draws=None, dtype=DEFAULT_DTYPE):
    """The MC estimate with the budget split over the mesh's data axis:
    each rank draws ceil(num_samples / D) samples on its device from its
    own stream (a generator seeded by (seed, rank index):
    `mesh.stream_seed`), and one all-reduce sums the hit counts. A valid MC
    probability at every D; from another stream than the one-device
    estimate's, it differs from it by MC error. `draws=(z_a, z_b)`: this
    rank's standard-normal draws, (ceil(n / D), dim) each."""
    n_dev = mesh.shape[DATA_AXIS]
    local = -(-num_samples // n_dev)  # ceil: the total is at least the budget
    hits = _hits(mu_a, cov_a, mu_b, cov_b, local, stream_seed(seed, mesh.index(DATA_AXIS)),
                 draws, mesh.device, dtype)
    hits, = all_reduce_sum([hits], mesh, DATA_AXIS)
    return float(hits) / (local * n_dev)
