"""Cells of lockstep NUTS over GP hyperparameters (`inference/nuts.py`).

One unit of work is one `nuts_step` transition of every chain, on the flat
log-density that `inference/sampler.py` builds for `sample_nuts` (the
model's raw parameters in `params.ravel` order), with
`fused_logdensity.gpr_logdensity_vg` as the one value and gradient a leaf
and the step size and inverse mass fixed in the configuration, so the
window times sampling-phase transitions and no run pays for adaptation.
The set-up's transition, which warms the shapes, moves chains started from
and driven by a stream drawn from the seed; its draws are checked with the
window's.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from gpbench import market
from gpbench.kinds import stationary_launches
from gpbench.reference import gp as ref
from gpbench.reference.gp import worst_of
from portfoliooptgp_tpu_torch import kernels
from portfoliooptgp_tpu_torch.inference import hmc, nuts
from portfoliooptgp_tpu_torch.inference.fused_logdensity import gpr_logdensity_vg
from portfoliooptgp_tpu_torch.inference.sampler import centered_normal_logprior
from portfoliooptgp_tpu_torch.inference.source import GeneratorSource
from portfoliooptgp_tpu_torch.models import gpr
from portfoliooptgp_tpu_torch.models.gpr import GPR
from portfoliooptgp_tpu_torch.params import ravel, tree_leaves, tree_replace, unravel

UNIT = "draws"
# layer spans of the traced run: (module, attribute, layer)
_PKG = "portfoliooptgp_tpu_torch."
SPANS = ((_PKG + "inference.nuts", "nuts_step", "sampler"),
         (_PKG + "inference.fused_logdensity", "_value_and_grad", "logdensity"),
         (_PKG + "models.gpr", "batched_neg_log_marginal_likelihood", "router"),
         (_PKG + "ops.stationary_nll", "batched_nll_stationary_general", "nll_forward"))
BLOCK = 128  # draws per reference evaluation


def flat_logdensity(X, Y, model0, prior_scale):
    """`sample_nuts`'s flat (logp, grad) of the stacked models that
    `model0`'s raw parameters ravel to, and the flat start (1, dim)."""
    template = tree_replace(model0, [x.detach() for x in tree_leaves(model0)])
    vg = gpr_logdensity_vg(X, Y, centered_normal_logprior(template, prior_scale))

    def vg_flat(z):
        v, g = vg(unravel(template, z))
        return v.detach(), ravel(g).detach()

    return vg_flat, ravel(template)


class PermutedSource:
    """A random source (`inference/source.py`) whose chains are those of
    `base` in the order `perm`: chain i draws what chain perm[i] of
    `base` draws. With one stream for every seed and the seed choosing
    the order, every run does the same trees in another batch order."""

    def __init__(self, base, perm):
        self.base, self.perm = base, perm

    def split(self, n: int):
        return [self] * n

    def normal(self, shape, dtype):
        return self.base.normal(shape, dtype)[self.perm]

    def uniform(self, dtype=None):
        return self.base.uniform(dtype)[self.perm]

    def bernoulli(self):
        return self.base.bernoulli()[self.perm]

    def where(self, active, old):
        return self


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.device = torch.device(device)
        dtype = getattr(torch, config["dtype"])
        n, d = int(config["n"]), int(config["d"])
        X, Y = market.nuts_posterior_data(n, d)
        self.X64, self.Y64 = torch.as_tensor(X), torch.as_tensor(Y)
        X, Y = (torch.as_tensor(a, dtype=dtype, device=self.device) for a in (X, Y))
        self.prior_scale = float(config["prior_scale"])
        self.max_depth = int(config["max_depth"])
        self.start = ([config["kernel_variance"]] + list(config["lengthscales"])
                      + [config["noise_variance"]])
        model0 = GPR.create(kernels.SquaredExponential.create(
            config["kernel_variance"], np.asarray(config["lengthscales"], dtype=float),
            device=self.device, dtype=dtype), noise_variance=config["noise_variance"])
        self.vg, flat0 = flat_logdensity(X, Y, model0, self.prior_scale)
        C = int(traffic["chains"])
        dim = flat0.shape[1]
        self.shape = dict(B=C, N=n, J=1, JD=d, masked=False)
        self.step_size = torch.full((C,), float(config["step_size"]), dtype=dtype,
                                    device=self.device)
        self.inv_mass = torch.as_tensor(config["inv_mass"], dtype=dtype,
                                        device=self.device).expand(C, dim, dim)
        self.chol = hmc.mass_chol(self.inv_mass)
        # warm the cell's shapes with one transition of chains started from
        # and driven by a stream drawn from the seed (checked with the
        # window's draws, so each seed adds draws of its own), and hold the
        # tier the router took on the card
        jitter = float(traffic["init_jitter"])
        self._start(GeneratorSource(C, torch.Generator(device=self.device).manual_seed(seed)),
                    flat0, jitter)
        self.step()
        tier = gpr.DISPATCH_EVENTS[-1]["tier"]
        if self.device.type == "cuda" and not tier.startswith("fused"):
            raise RuntimeError(f"the log-density took the {tier!r} tier, not a fused one")
        self.probe = self.draws
        # the window's chains: one stream for every seed, in the seed's order
        stream = torch.Generator(device=self.device).manual_seed(int(traffic["stream_seed"]))
        perm = torch.randperm(C, generator=torch.Generator().manual_seed(seed)).to(self.device)
        self._start(PermutedSource(GeneratorSource(C, stream), perm), flat0, jitter)

    def _start(self, key, flat0, jitter):
        """Chains at flat0 plus jitter·N(0, 1) from `key`, which then drives them."""
        self.key = key
        self.q = flat0 + jitter * key.normal((flat0.shape[1],), flat0.dtype)
        self.logp, self.grad = self.vg(self.q)
        self.draws = [(self.q, self.logp, self.grad, None)]

    def step(self) -> int:
        """One lockstep transition of every chain; returns the draws made."""
        self.q, self.logp, self.grad, info = nuts.nuts_step(
            self.vg, self.q, self.logp, self.key, self.step_size, self.inv_mass,
            self.max_depth, grad0=self.grad, mass_chol_factor=self.chol)
        self.draws.append((self.q, self.logp, self.grad, info.depth))
        return self.q.shape[0]

    def counters(self) -> dict:
        return stationary_launches(self.device)

    def release(self):
        """Free the program's state; the draws move to the host."""
        self.probe, self.draws = ([tuple(None if t is None else t.detach().double().cpu()
                                         for t in d) for d in ds]
                                  for ds in (self.probe, self.draws))
        del self.vg, self.q, self.logp, self.grad, self.inv_mass, self.chol

    def attempted_failed(self):
        logp = [d[1] for ds in (self.probe, self.draws) for d in ds[1:]]
        return (sum(x.numel() for x in logp),
                sum(int(torch.sum(~torch.isfinite(x))) for x in logp))

    # -- the check -----------------------------------------------------------
    def _reference(self, q, prec):
        z0 = ref.positive_inv(torch.tensor(self.start, dtype=torch.float64))
        X, Y, z0 = (t.to(self.device) for t in (self.X64, self.Y64, z0))
        out = [ref.nuts_logp_and_grad(X, Y, q[i:i + BLOCK].to(self.device), z0, prec,
                                      self.prior_scale) for i in range(0, q.shape[0], BLOCK)]
        return (torch.cat([o[0] for o in out]).double().cpu(),
                torch.cat([o[1] for o in out]).double().cpu())

    def outputs(self):
        """(previous draws, draws, logp, grad, tree depths) of every
        transition: the set-up's on the seed's stream, then the window's,
        flattened over transitions and chains."""
        pairs = [(ds[k - 1][0], ds[k]) for ds in (self.probe, self.draws)
                 for k in range(1, len(ds))]
        if not pairs:
            return (torch.zeros(0),) * 5
        return tuple(torch.cat(x) for x in zip(*[(p,) + d for p, d in pairs]))

    def control_outputs(self, prec):
        prev, q, _, _, depth = self.outputs()
        logp, grad = self._reference(q, prec)
        return prev, q, logp, grad, depth

    def readings(self, outputs, nan=float("inf")) -> dict:
        """The numbers the check compares, over every draw; `nan` is what a
        value that is not a number reads as (see `reference.gp.worst_of`):

        - logp_gap: a returned log-density against the reference's at the
          draw, relative;
        - grad_gap: the returned gradient's distance from the reference's,
          over the larger of the reference's norm and the median norm;
        - stuck_share: the share of draws equal to the chain's previous one
          (a sound transition moves all but a few);
        - depth_gap: the configuration's max_depth less the deepest tree
          that a transition built (the program's own count of doublings):
          over a window some chain's tree reaches depth 7 or 8, and a tree
          cut shallower reads the cut."""
        prev, q, logp, grad, depth = outputs
        if q.shape[0] == 0:
            return dict(logp_gap=float("inf"), grad_gap=float("inf"), stuck_share=1.0,
                        depth_gap=float("inf"))
        ref_logp, ref_grad = self._reference(q, ref.F64)
        norms = torch.linalg.norm(ref_grad, dim=-1)
        floor = statistics.median(norms.tolist())
        return dict(
            logp_gap=worst_of((logp - ref_logp) / torch.clamp_min(torch.abs(ref_logp), 1.0), nan),
            grad_gap=worst_of(torch.linalg.norm(grad - ref_grad, dim=-1)
                              / torch.clamp_min(norms, floor), nan),
            stuck_share=float(torch.mean(torch.all(q == prev, dim=-1).double())),
            depth_gap=float(self.max_depth - depth.max()))
