"""Hamiltonian Monte Carlo on flat parameters, with warmup adaptation.

Port of portfoliooptgp_tpu/inference/hmc.py. Every function works on a
leading chain axis: positions and momenta are (C, dim), log-densities,
step sizes and counts (C,), an inverse mass (C, dim) when diagonal and
(C, dim, dim) when dense. The JAX package gets that axis from `jax.vmap`;
here it is explicit, and `grad_fn` / `logp_fn` take (C, dim) and return
(C, dim) / (C,).

- leapfrog integration and a fixed-length HMC step;
- dual-averaging step-size adaptation (Nesterov / Hoffman-Gelman) and
  mass-matrix estimation by Welford accumulators;
- the JAX package's cross-chain pooling of the Welford moments (its
  `axis_name` psum) is `welford_variance(..., pool=True)`, a combine over
  the chain axis. Pooling across devices (a real `axis_name`) raises:
  ROADMAP.md queue 1 item 8 (the multi-device paths).

Random draws come from a source (inference/source.py), one stream per
chain.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from portfoliooptgp_tpu_torch.ops import linalg


def _col(x):
    """A per-chain (C,) tensor as (C, 1), to scale (C, dim) rows."""
    return x[..., None] if isinstance(x, torch.Tensor) and x.ndim else x


def _dense(inv_mass) -> bool:
    return inv_mass.ndim == 3


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    gradient_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def da_init(step_size) -> DualAveragingState:
    """Dual averaging from `step_size`: a tensor keeps its floating dtype
    (a float32 chain is not promoted: the step size multiplies positions
    in the leapfrog); a Python number becomes float64."""
    ss = torch.as_tensor(step_size)
    if not (isinstance(step_size, torch.Tensor) and ss.is_floating_point()):
        ss = ss.to(torch.float64)
    return DualAveragingState(
        log_step=torch.log(ss),
        log_step_avg=torch.log(ss),
        gradient_avg=torch.zeros_like(ss),
        t=torch.zeros_like(ss),
        mu=torch.log(10.0 * ss),
    )


def da_update(state: DualAveragingState, accept_prob, target: float = 0.8,
              gamma: float = 0.05, t0: float = 10.0, kappa: float = 0.75):
    t = state.t + 1.0
    g = target - accept_prob
    gradient_avg = (1.0 - 1.0 / (t + t0)) * state.gradient_avg + g / (t + t0)
    log_step = state.mu - torch.sqrt(t) / gamma * gradient_avg
    eta = t ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, gradient_avg, t, state.mu)


class WelfordState(NamedTuple):
    mean: torch.Tensor  # (C, dim)
    m2: torch.Tensor  # (C, dim) diagonal or (C, dim, dim) dense second-moment sum
    count: torch.Tensor  # (C,)


def welford_init(dim: int, dtype=None, dense: bool = False, *, chains: int = 1,
                 device=DEFAULT_DEVICE) -> WelfordState:
    dtype = dtype or torch.float64
    opts = dict(dtype=dtype, device=resolve_device(device))
    m2 = torch.zeros((chains, dim, dim) if dense else (chains, dim), **opts)
    return WelfordState(mean=torch.zeros((chains, dim), **opts), m2=m2,
                        count=torch.zeros((chains,), **opts))


def welford_update(state: WelfordState, x) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[:, None]
    if state.m2.ndim == 3:
        m2 = state.m2 + delta[:, :, None] * (x - mean)[:, None, :]
    else:
        m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_variance(state: WelfordState, axis_name: Optional[str] = None,
                     regularize: bool = True, pool: bool = False):
    """Per-chain variance estimate (C, dim) or covariance (C, dim, dim).
    With `pool`, the chains' moments are combined, Σ m2ᵢ + Σ nᵢ(meanᵢ −
    mean)⊗² over count × C, and every chain gets the pooled estimate (the
    JAX package's psum over a vmapped chain axis)."""
    if axis_name is not None:
        raise NotImplementedError(
            "pooling adaptation statistics across devices is not ported: ROADMAP.md "
            "queue 1 item 8 (the multi-device paths)")
    mean, m2, count = state.mean, state.m2, state.count
    dense = m2.ndim == 3
    if pool:
        total = count * mean.shape[0]
        d = mean - mean.mean(dim=0, keepdim=True)
        between = d[:, :, None] * d[:, None, :] if dense else d * d
        scale = count[:, None, None] if dense else count[:, None]
        m2 = torch.sum(m2 + scale * between, dim=0, keepdim=True).expand_as(m2)
        count = total
    denom = torch.clamp_min(count - 1.0, 1.0)
    var = m2 / (denom[:, None, None] if dense else denom[:, None])
    if regularize:
        # Stan-style shrinkage toward unit scale for small samples
        w = count / (count + 5.0)
        if dense:
            eye = torch.eye(var.shape[-1], dtype=var.dtype, device=var.device)
            var = w[:, None, None] * var + (1.0 - w)[:, None, None] * 1e-3 * eye
        else:
            var = w[:, None] * var + (1.0 - w)[:, None] * 1e-3
    return var


def velocity(inv_mass, p):
    """v = M⁻¹ p for a diagonal (C, dim) or dense (C, dim, dim) inverse mass."""
    return (inv_mass @ p[..., None])[..., 0] if _dense(inv_mass) else inv_mass * p


def mass_chol(inv_mass):
    """Factor used to draw momenta p ~ N(0, M): with Σ = M⁻¹ = L Lᵀ,
    p = L⁻ᵀ ξ. Diagonal metrics give the (C, dim) square roots, dense ones
    the lower Cholesky factor of the symmetrized Σ (as jnp.linalg.cholesky
    symmetrizes its input; NaN if it fails). Computed once when the metric
    is (re)set, not per transition."""
    if _dense(inv_mass):
        return linalg.cholesky(0.5 * (inv_mass + inv_mass.transpose(-1, -2)))
    return torch.sqrt(inv_mass)


def sample_momentum(source, inv_mass, chol=None, *, shape=None, dtype=None):
    """Draw p ~ N(0, M) per chain for the metric M = inv_mass⁻¹; `shape` is
    one chain's (default (dim,))."""
    if chol is None:
        chol = mass_chol(inv_mass)
    dim = inv_mass.shape[1]
    xi = source.normal(shape or (dim,), dtype or inv_mass.dtype)
    if _dense(inv_mass):
        return torch.linalg.solve_triangular(chol.transpose(-1, -2), xi[..., None],
                                             upper=True)[..., 0]
    return xi / chol


def leapfrog(grad_fn: Callable, q, p, step_size, inv_mass, num_steps):
    """Standard velocity-Verlet integration of H = -logp(q) + ½ pᵀ M⁻¹ p."""
    eps = _col(step_size)
    g = grad_fn(q)
    for _ in range(num_steps):
        p_half = p + 0.5 * eps * g  # g = ∇logp
        q = q + eps * velocity(inv_mass, p_half)
        g = grad_fn(q)
        p = p_half + 0.5 * eps * g
    return q, p, g


def kinetic(p, inv_mass):
    return 0.5 * torch.sum(p * velocity(inv_mass, p), dim=-1)


class HMCState(NamedTuple):
    q: torch.Tensor
    logp: torch.Tensor
    key: object  # a random source (inference/source.py)


def hmc_step(logp_fn, grad_fn, state: HMCState, step_size, inv_mass, num_steps):
    key, k_mom, k_acc = state.key.split(3)
    p0 = sample_momentum(k_mom, inv_mass, shape=state.q.shape[1:], dtype=state.q.dtype)
    q_new, p_new, _ = leapfrog(grad_fn, state.q, p0, step_size, inv_mass, num_steps)
    logp_new = logp_fn(q_new)
    h0 = -state.logp + kinetic(p0, inv_mass)
    h1 = -logp_new + kinetic(p_new, inv_mass)
    accept_prob = torch.minimum(torch.ones_like(h1), torch.exp(h0 - h1))
    accept_prob = torch.where(torch.isfinite(h1), accept_prob, torch.zeros_like(h1))
    accept = k_acc.uniform() < accept_prob
    q = torch.where(accept[:, None], q_new, state.q)
    logp = torch.where(accept, logp_new, state.logp)
    return HMCState(q, logp, key), accept_prob


def find_reasonable_step_size(logp_fn, grad_fn, q, inv_mass, key, init=1.0):
    """Double or halve each chain's step until its one-step acceptance
    crosses 0.5 (Hoffman & Gelman Alg. 4), at most 50 times; a chain stops
    on its own, the others go on (the chain vmap of the JAX while_loop)."""
    p = sample_momentum(key, inv_mass, shape=q.shape[1:], dtype=q.dtype)
    h0 = -logp_fn(q) + kinetic(p, inv_mass)

    def energy_at(eps):
        q1, p1, _ = leapfrog(grad_fn, q, p, eps, inv_mass, 1)
        return -logp_fn(q1) + kinetic(p1, inv_mass)

    log_half = math.log(0.5)
    eps = torch.full(q.shape[:1], float(init), dtype=q.dtype, device=q.device)
    delta = h0 - energy_at(eps)
    up = delta > log_half
    factor = torch.where(up, 2.0, 0.5).to(q.dtype)
    active = torch.ones_like(up)
    for it in range(51):
        keep = torch.where(up, delta > log_half, delta < log_half)
        active = active & keep & torch.isfinite(delta) & (it < 50)
        if not bool(active.any()):
            break
        eps = torch.where(active, eps * factor, eps)
        delta = h0 - energy_at(eps)
    return eps
