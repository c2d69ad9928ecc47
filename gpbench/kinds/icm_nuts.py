"""Cells of lockstep NUTS over the ICM hyperposterior: config 5's Bayesian
frontier (`pipelines/frontier_pipeline.py`, `use_nuts=True`).

One unit of work is one `nuts_step` transition of every chain, as for the
`nuts` kind, on the flat log-density that `inference/sampler.py` builds
for `sample_nuts` (`sampler.flat_value_and_grad`: autograd through
`params.unravel`) of the frontier's own target,
`frontier_pipeline.frontier_logdensity`: −`icm.batched_neg_log_marginal_
likelihood_chol` under a standard-normal prior on the raw parameters. A
leaf is one batched eigh of the chains' B matrices and, on the fused tier,
one stationary-kernel launch over the C·P shifted systems. The start (the
program's maximum-likelihood fit), the step size and the diagonal inverse
mass are fixed in the configuration (`gpbench/tools/adapt_icm_nuts.py`),
so the window times sampling-phase transitions.

The set-up's transition, which warms the shapes, moves chains started from
and driven by a stream drawn from the seed; it must record the ICM tier
`icm.fused` at the cell's N and batch C·P and, on the card, launch the
single-family stationary kernel. Its draws are checked with the window's,
against `gpbench/reference/icm.py`.
"""

from __future__ import annotations

import torch

from gpbench import frontier_market
from gpbench.kinds import nuts as nuts_kind
from gpbench.kinds.walk_forward import _recorded_since
from gpbench.reference import icm as ref_icm
from portfoliooptgp_tpu_torch import kernels
from portfoliooptgp_tpu_torch.inference import hmc, nuts
from portfoliooptgp_tpu_torch.inference.sampler import flat_value_and_grad
from portfoliooptgp_tpu_torch.inference.source import GeneratorSource
from portfoliooptgp_tpu_torch.models import gpr, icm
from portfoliooptgp_tpu_torch.ops import stationary_nll as st_mod
from portfoliooptgp_tpu_torch.params import tree_leaves, tree_replace, unravel
from portfoliooptgp_tpu_torch.pipelines import frontier_pipeline

UNIT = "draws"
# layer spans of the traced run: (module, attribute, layer)
_PKG = "portfoliooptgp_tpu_torch."
SPANS = ((_PKG + "inference.nuts", "nuts_step", "sampler"),
         (_PKG + "pipelines.frontier_pipeline", "frontier_logdensity", "logdensity"),
         (_PKG + "models.icm", "batched_neg_log_marginal_likelihood_chol", "ICM model"),
         (_PKG + "ops.stationary_nll", "batched_nll_stationary", "nll_forward"))


def _logdensity(X, Y):
    # looked up on the module at each call, so that the traced run's span
    # (SPANS) wraps every evaluation
    def logdensity(stacked):
        return frontier_pipeline.frontier_logdensity(stacked, X, Y)
    return logdensity


class Cell(nuts_kind.Cell):
    """The `nuts` kind's cell on the ICM posterior: the same transition,
    outputs and readings, with the ICM reference."""

    def __init__(self, config, traffic, seed, device):
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.P, self.rank = int(config["assets"]), int(config["rank"])
        first, last = config["grid"]
        self.X64, self.Y64 = frontier_market.frontier_data(
            first, last, int(config["market_seed"]), self.P)
        X, Y = (t.to(device=self.device, dtype=self.dtype) for t in (self.X64, self.Y64))
        self.max_depth = int(config["max_depth"])
        kern = getattr(kernels, config["kernel"]).create(device=self.device, dtype=self.dtype)
        model0 = icm.ICMGPR.create(kern, self.P, rank=self.rank,
                                   noise_variance=config["noise_variance"])
        start = torch.tensor(config["start"], dtype=self.dtype, device=self.device)[None]
        template = unravel(model0, start)
        template = tree_replace(template, [x.detach() for x in tree_leaves(template)])
        self.vg, flat0 = flat_value_and_grad(_logdensity(X, Y), template)
        C = int(traffic["chains"])
        dim = flat0.shape[1]
        if dim != ref_icm.dim(self.P, self.rank):
            raise RuntimeError(f"the ICM model has {dim} raw parameters, the reference "
                               f"{ref_icm.dim(self.P, self.rank)}")
        N = X.shape[0]
        self.shape = dict(B=C * self.P, N=N, J=1, JD=1, masked=False)
        self.step_size = torch.full((C,), float(config["step_size"]), dtype=self.dtype,
                                    device=self.device)
        self.inv_mass = torch.as_tensor(config["inv_mass"], dtype=self.dtype,
                                        device=self.device).expand(C, dim)
        self.chol = hmc.mass_chol(self.inv_mass)
        # warm the cell's shapes with one transition of chains started from
        # and driven by a stream drawn from the seed (checked with the
        # window's draws), and hold the ICM tier it took
        jitter = float(traffic["init_jitter"])
        launches = st_mod.LAUNCHES["stationary_nll"]
        cluster = self.counters().get("cluster_launches", 0)
        last = gpr.DISPATCH_EVENTS[-1] if gpr.DISPATCH_EVENTS else None
        self._start(GeneratorSource(C, torch.Generator(device=self.device).manual_seed(seed)),
                    flat0, jitter)
        self.step()
        self._hold_tier(_recorded_since(last), st_mod.LAUNCHES["stationary_nll"] - launches,
                        self.counters().get("cluster_launches", 0) - cluster)
        self.probe = self.draws
        # the window's chains: one stream for every seed, in the seed's order
        stream = torch.Generator(device=self.device).manual_seed(int(traffic["stream_seed"]))
        perm = torch.randperm(C, generator=torch.Generator().manual_seed(seed)).to(self.device)
        self._start(nuts_kind.PermutedSource(GeneratorSource(C, stream), perm), flat0, jitter)

    def _hold_tier(self, events, launches, cluster):
        """Raise unless every ICM evaluation of the set-up's transition
        recorded the fused tier (its plain twin in float64 off the card) at
        the cell's N and batch and, on the card, launched the single-family
        stationary kernel, as its cluster form at N > 256."""
        B, N = self.shape["B"], self.shape["N"]
        want = "icm.fused" if self.dtype == torch.float32 else "icm.plain"
        mine = [e for e in events if e["tier"].startswith("icm.")]
        if not mine or any((e["tier"], e["n"], e["batch"]) != (want, N, B) for e in mine):
            raise RuntimeError(f"the ICM log-density at N={N}, batch {B} did not take the "
                               f"tier {want!r}: it recorded {mine[:4]}")
        if self.device.type == "cuda" and (launches <= 0
                                           or (N > st_mod.MAX_TILE_N and cluster <= 0)):
            raise RuntimeError("the ICM log-density recorded the fused tier but did not launch "
                               f"the stationary kernel ({launches} launches, {cluster} cluster)")

    def _reference(self, q, prec):
        X, Y = self.X64.to(self.device), self.Y64.to(self.device)
        logp, grad = ref_icm.logp_and_grad(X, Y, q.to(self.device), self.P, self.rank, prec)
        return logp.double().cpu(), grad.double().cpu()

