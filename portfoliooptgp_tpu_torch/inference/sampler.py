"""NUTS sampling driver: warmup adaptation, lockstep chains, model trees.

Port of portfoliooptgp_tpu/inference/sampler.py. `sample_nuts` is the user
API: a log-density over a stacked model tree (C models in, (C,) values
out) and an initial model; it returns posterior samples with leading
[chain, draw] axes. The JAX package vmaps one chain's program over the
chain axis; here the chain axis is the model batch axis, so one
log-density call evaluates every chain (for a GPR, one batched NLL).

Across ranks (the JAX package's `axis_name` inside a `shard_map`), each
rank runs its own chains from its own random source, and `axis_name`
names the mesh axis (parallel/mesh.py) over whose ranks the adaptation is
pooled: the geometric mean of the initial step size, the acceptance
statistic and the Welford moments, one all-reduce each.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from portfoliooptgp_tpu_torch.inference import hmc as hmc_mod
from portfoliooptgp_tpu_torch.inference import nuts as nuts_mod
from portfoliooptgp_tpu_torch.inference.source import GeneratorSource
from portfoliooptgp_tpu_torch.params import ravel, tree_leaves, tree_replace, tree_to, unravel
from portfoliooptgp_tpu_torch.parallel.mesh import stream_seed
from portfoliooptgp_tpu_torch.utils.profiling import span


def centered_normal_logprior(init_params, scale: float = 2.0):
    """Weakly informative N(init, scale²) log-prior over the raw
    (unconstrained) hyperparameters, for use as `logprior_fn`: a function
    of a stacked model, one value per model (C,).

    The bare GPR marginal likelihood (a flat prior on raw softplus
    parameters) targets an improper ridge posterior (variance against
    lengthscale) that forces NUTS into tiny steps and deep trees; a weak
    prior centered at the initialization makes it proper (the JAX
    package's docstring has the measurement)."""
    flat0 = ravel(init_params).detach()
    inv2 = 1.0 / (scale * scale)

    def logprior(m):
        z = ravel(m)
        return -0.5 * inv2 * torch.sum((z - flat0.to(z)) ** 2, dim=-1)

    return logprior


class SampleStats(NamedTuple):
    accept_prob: torch.Tensor  # (C, S)
    num_leaves: torch.Tensor  # (C, S)
    diverging: torch.Tensor  # (C, S)
    step_size: torch.Tensor  # (C,)
    inv_mass: torch.Tensor  # (C, dim) or (C, dim, dim)


def _warmup_and_sample_flat(
    logp_fn: Callable,
    q0: torch.Tensor,
    key,
    num_warmup: int,
    num_samples: int,
    max_depth: int,
    target_accept: float,
    pool: bool,
    grad_fn: Optional[Callable] = None,
    vg_fn: Optional[Callable] = None,
    dense_mass: bool = False,
    mesh=None,
    axis_name: Optional[str] = None,
):
    """Warmup and sampling of C chains from q0 (C, dim); with `pool` the
    adaptation statistics are shared by the chains, with `axis_name` by the
    ranks of that axis of `mesh`."""
    if grad_fn is None:
        grad_fn = lambda z: vg_fn(z)[1]  # noqa: E731
    if vg_fn is None:
        vg_fn = lambda z: (logp_fn(z), grad_fn(z))  # noqa: E731
    dtype, dev = q0.dtype, q0.device
    C, dim = q0.shape

    eye = torch.eye(dim, dtype=dtype, device=dev)
    inv_mass = (eye.expand(C, dim, dim) if dense_mass
                else torch.ones((C, dim), dtype=dtype, device=dev))
    chol = hmc_mod.mass_chol(inv_mass)
    key, k_eps = key.split(2)
    eps0 = hmc_mod.find_reasonable_step_size(logp_fn, grad_fn, q0, inv_mass, k_eps)
    shared = pool or axis_name is not None
    if shared:
        # shared adaptation: the geometric-mean initial step, so every
        # lockstep chain adapts the SAME step size (per-chain steps make
        # every chain pay for the deepest tree in the batch)
        eps0 = torch.exp(hmc_mod.pooled_mean(torch.log(eps0), pool, mesh, axis_name)).expand(C)
    da = hmc_mod.da_init(eps0)
    wf = hmc_mod.welford_init(dim, dtype, dense=dense_mass, chains=C, device=dev)

    mass_start = int(num_warmup * 0.15)
    mass_end = int(num_warmup * 0.9)

    q, (logp, grad) = q0, vg_fn(q0)
    for i in range(num_warmup):
        key, k_step = key.split(2)
        q, logp, grad, info = nuts_mod.nuts_step(
            vg_fn, q, logp, k_step, torch.exp(da.log_step), inv_mass, max_depth,
            grad0=grad, mass_chol_factor=chol)
        accept = info.accept_prob
        if shared:
            accept = hmc_mod.pooled_mean(accept, pool, mesh, axis_name).expand(C)
        da = hmc_mod.da_update(da, accept, target=target_accept)
        if mass_start <= i < mass_end:
            wf = hmc_mod.welford_update(wf, q)
        if i == mass_end:
            inv_mass = hmc_mod.welford_variance(wf, axis_name, pool=pool, mesh=mesh)
            chol = hmc_mod.mass_chol(inv_mass)
            da = hmc_mod.da_init(torch.exp(da.log_step))
    eps_final = torch.exp(da.log_step_avg)

    qs, accepts, leaves, divs = [], [], [], []
    for _ in range(num_samples):
        key, k_step = key.split(2)
        q, logp, grad, info = nuts_mod.nuts_step(
            vg_fn, q, logp, k_step, eps_final, inv_mass, max_depth, grad0=grad,
            mass_chol_factor=chol)
        qs.append(q)
        accepts.append(info.accept_prob)
        leaves.append(info.num_leaves)
        divs.append(info.diverging)

    def stack(xs, like):
        return torch.stack(xs, dim=1) if xs else like.new_empty((C, 0))

    stats = SampleStats(
        accept_prob=stack(accepts, q0), num_leaves=stack(leaves, q0.long()),
        diverging=stack(divs, q0.bool()), step_size=eps_final, inv_mass=inv_mass)
    qs = torch.stack(qs, dim=1) if qs else q0.new_empty((C, 0, dim))
    return qs, stats


def flat_value_and_grad(logdensity_fn: Callable, template):
    """(vg, flat0) of the flat log-density `sample_nuts` samples:
    vg(z (C, dim)) → (logp (C,), grad (C, dim)) of `logdensity_fn` at the
    stacked models `unravel(template, z)`, the gradient by autograd, both
    detached; flat0 = `ravel(template)` (1, dim). `template` is one model
    with detached leaves. An evaluation is the span
    `logdensity.value_and_grad`."""

    def vg(z):
        with span("logdensity.value_and_grad"), torch.enable_grad():
            z = z.detach().requires_grad_(True)
            v = logdensity_fn(unravel(template, z))
            (g,) = torch.autograd.grad(v.sum(), z)
        return v.detach(), g

    return vg, ravel(template)


def _source(source, chains: int, device, seed: int = 0):
    if source is None:
        source = torch.Generator(device=device).manual_seed(seed)
    if isinstance(source, torch.Generator):
        return GeneratorSource(chains, source)
    return source


def sample_nuts(
    logdensity_fn: Callable,
    init_params,
    source=None,
    num_warmup: int = 500,
    num_samples: int = 500,
    num_chains: int = 1,
    max_depth: int = 10,
    target_accept: float = 0.8,
    axis_name: Optional[str] = None,
    grad_fn: Optional[Callable] = None,
    vg_fn: Optional[Callable] = None,
    share_adaptation: bool = True,
    dense_mass: bool = False,
    *,
    mesh=None,
    device=DEFAULT_DEVICE,
):
    """Sample a model's hyperposterior with C = `num_chains` lockstep NUTS
    chains.

    `logdensity_fn` maps a stacked model tree (C models) to (C,) log
    densities; `init_params` is one model (batch 1), moved to `device`. Its
    leaves are raveled in `params.ravel`'s order (the JAX package's
    `ravel_pytree` order) and every chain starts at init + 0.1·N(0, 1).

    `source` draws the random numbers: a random source (inference/source.py),
    a `torch.Generator` on `device`, or None for a generator seeded 0.
    `dense_mass=True` adapts a dense inverse metric (the full Welford
    covariance of the warmup draws, Stan-style shrinkage) instead of the
    diagonal, for the correlated ridges of GP hyperposteriors.

    `grad_fn` (stacked model → gradient tree, optional) replaces autograd of
    `logdensity_fn`; `vg_fn` (stacked model → ((C,), gradient tree),
    optional) evaluates both jointly, one call per leapfrog for all chains:
    pass `inference.fused_logdensity.gpr_logdensity_vg(X, Y)` to run every
    leapfrog through one batched GPR NLL (one fused-kernel launch on a GPU).

    `share_adaptation` (default True) pools the step-size and mass
    statistics over the chains: lockstep chains with per-chain step sizes
    make every chain pay for the deepest tree in the batch. `axis_name`, an
    axis of `mesh` (parallel/mesh.py), pools them over that axis's ranks as
    well, each rank running its own C chains on the mesh's device; the
    default source is then seeded per rank (`mesh.stream_seed(0, index)`).

    Returns (samples: the model tree with leaves of shape (C, S, ...),
    SampleStats)."""
    seed = 0
    if axis_name is not None:
        if mesh is None:
            raise ValueError("axis_name names an axis of a mesh: pass mesh=")
        seed = stream_seed(0, mesh.index(axis_name))
    dev = resolve_device(device) if mesh is None else mesh.device
    template = tree_to(init_params, dev, tree_leaves(init_params)[0].dtype)
    template = tree_replace(template, [x.detach() for x in tree_leaves(template)])
    autograd_vg, flat0 = flat_value_and_grad(logdensity_fn, template)  # flat0 (1, dim)

    def logp_flat(z):
        return logdensity_fn(unravel(template, z))

    grad_flat = None
    if grad_fn is not None:
        def grad_flat(z):
            return ravel(grad_fn(unravel(template, z))).detach()

    vg_flat = None
    if vg_fn is not None:
        def vg_flat(z):
            v, g = vg_fn(unravel(template, z))
            return v.detach(), ravel(g).detach()
    elif grad_fn is None:
        vg_flat = autograd_vg

    key = _source(source, num_chains, dev, seed)
    key, k_init = key.split(2)
    with torch.no_grad():
        # jitter chain inits around the provided point
        q0 = flat0 + 0.1 * k_init.normal(flat0.shape[1:], flat0.dtype)
        qs, stats = _warmup_and_sample_flat(
            logp_flat, q0, key, num_warmup, num_samples, max_depth, target_accept,
            share_adaptation and num_chains > 1, grad_fn=grad_flat, vg_fn=vg_flat,
            dense_mass=dense_mass, mesh=mesh, axis_name=axis_name)
    return unravel(template, qs), stats
