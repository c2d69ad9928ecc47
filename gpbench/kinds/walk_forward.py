"""Cells of the multi-input walk-forward (`pipelines/walk_forward.py`).

One unit of work is one `batched_walk_forward` call for one asset: its
days × restarts lockstep L-BFGS rows on the masked product kernel, then the
day-ahead posterior of each day's best restart. The window cycles through
the universe's assets, call after call. The set-up's call, which warms the
shapes, runs on one asset of a market drawn from the seed; its outputs are
checked with the window's.

The traffic may name the NLL tier that the call has to take (`"tier"`:
`fused_general_<combine>`, `blocked` or `blocked_hinv`, as the walk-forward
records it in `gpr.DISPATCH_EVENTS`); the set-up's call must record it at
the cell's N and batch and, on the card, move that tier's launch counter.
Without `"tier"` the call has to run the fused stationary kernel.

`batched_walk_forward` keeps only each day's best restart; the harness
wraps `batched_lbfgs.fit_batched_fused` to keep the whole
`BatchedFitResult` that the call computed (every row's parameters, loss
and gradient norm), which the check compares with the reference.
"""

from __future__ import annotations

import statistics

import torch

from gpbench import market
from gpbench.kinds import stationary_launches
from gpbench.reference import gp as ref
from gpbench.reference.gp import worst_of
from portfoliooptgp_tpu_torch import kernels
from portfoliooptgp_tpu_torch.models import gpr
from portfoliooptgp_tpu_torch.models.gpr import GPR
from portfoliooptgp_tpu_torch.ops import blocked_nll as blocked_mod
from portfoliooptgp_tpu_torch.ops import nll as nll_mod
from portfoliooptgp_tpu_torch.ops import stationary_nll as st_mod
from portfoliooptgp_tpu_torch.params import tree_leaves
from portfoliooptgp_tpu_torch.pipelines import walk_forward as wf_mod
from portfoliooptgp_tpu_torch.train import batched_lbfgs

UNIT = "forecasts"
# ulps of a raw parameter by which the program's start may differ from the
# reference's (the program rounds the configuration's values, then
# inverts softplus, in its own dtype)
_ROUNDING_ULPS = 16
# the tiers a traffic file may name, with the launch counter each moves on
# the card: (module's counter table, key, name in counters())
TIERS = {"fused_general_prod": (st_mod.LAUNCHES, "stationary_nll_general", None),
         "fused_general_sum": (st_mod.LAUNCHES, "stationary_nll_general", None),
         "blocked": (blocked_mod.LAUNCHES, "blocked_panel", "panel_launches"),
         "blocked_hinv": (nll_mod.LAUNCHES, "triangular_inverse", "trinv_launches")}
# layer spans of the traced run: (module, attribute, layer)
_PKG = "portfoliooptgp_tpu_torch."
SPANS = ((_PKG + "train.batched_lbfgs", "fit_matrix", "optimizer"),
         (_PKG + "models.gpr", "fused_stationary_spec", "router"),
         (_PKG + "ops.stationary_nll", "batched_nll_stationary_general", "nll_forward"),
         (_PKG + "ops.blocked_nll", "batched_nll_blocked", "nll_forward"),
         (_PKG + "ops.blocked_nll", "batched_nll_hinv", "nll_forward"),
         (_PKG + "pipelines.walk_forward", "masked_predict_next", "predict"))


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.restarts = tuple(config["restart_noise_inits"])
        self.start = tuple(config["kernel_start"])
        self.maxiter = int(config["maxiter"])
        self.kernel = tuple(getattr(kernels, k) for k in config["kernel"])
        self.n_train, self.days = int(traffic["n_train"]), int(traffic["days"])
        n_full = self.n_train + self.days
        # the window's market is the same for every seed; the seed orders
        # the restarts in the batch, so every run does the same work (each
        # row is computed alone, wherever it sits)
        X, Y = market.walk_forward_universe(int(traffic["market_seed"]), n_full,
                                            int(traffic["assets"]))
        order = torch.randperm(len(self.restarts), generator=torch.Generator().manual_seed(seed))
        self.restarts = tuple(self.restarts[i] for i in order.tolist())
        self.X64, self.Y64 = torch.as_tensor(X), torch.as_tensor(Y)
        self.X = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        self.Y = torch.as_tensor(Y, dtype=self.dtype, device=self.device)[:, :, None]
        # the fused NLL's operands per evaluation, for gpbench/costs.py
        self.shape = dict(B=self.days * len(self.restarts), N=n_full, J=2, JD=2, masked=True)
        self.calls, self._fits, self._next = [], [], 0
        self._fit = batched_lbfgs.fit_batched_fused

        def recorded(*args, **kw):
            out = self._fit(*args, **kw)
            self._fits.append(out[1])
            return out

        batched_lbfgs.fit_batched_fused = recorded
        # warm the cell's shapes with one call on an asset of a market drawn
        # from the seed (checked with the window's calls, so each seed adds
        # data of its own), and hold the tier it ran
        Xp, Yp = (torch.as_tensor(a) for a in market.walk_forward_universe(seed, n_full, 1))
        self.tier = traffic.get("tier")
        if self.tier is None:
            before = st_mod.LAUNCHES["stationary_nll_general"]
            self._call(Xp, Yp[0], "probe")
            fused = st_mod.fused_nll_supported(n_full) and (
                self.device.type != "cuda" or st_mod.LAUNCHES["stationary_nll_general"] > before)
            if not fused:
                raise RuntimeError("the walk-forward did not run the fused stationary NLL")
        else:
            if self.tier not in TIERS:
                raise ValueError(f"unknown tier {self.tier!r}; known: {sorted(TIERS)}")
            table, key, _ = TIERS[self.tier]
            before, last = table[key], gpr.DISPATCH_EVENTS[-1] if gpr.DISPATCH_EVENTS else None
            self._call(Xp, Yp[0], "probe")
            self._hold_tier(_recorded_since(last), table[key] - before)
        self.probe, self.calls = self.calls, []

    def _hold_tier(self, events, launches):
        """Raise unless the probe's fit recorded the traffic's tier at the
        cell's N and batch and, on the card, launched that tier's kernel."""
        B, N = self.shape["B"], self.shape["N"]
        fit = [e for e in events if e["n"] == N and e["batch"] == B]
        if not fit or any(e["tier"] != self.tier for e in fit):
            raise RuntimeError(f"the walk-forward at N={N}, batch {B} did not take the tier "
                               f"{self.tier!r}: it recorded {events}")
        if self.device.type == "cuda" and launches <= 0:
            raise RuntimeError(f"the walk-forward recorded the tier {self.tier!r} but did not "
                               "launch its kernel")

    def _make_model(self, noise_variance):
        kern = kernels.composite_kernel(self.X64.shape[1], *self.kernel, device=self.device,
                                        dtype=self.dtype)
        return GPR.create(kern, noise_variance=noise_variance)

    def step(self) -> int:
        """One asset's walk-forward; returns the forecasts it made."""
        asset = self._next % self.Y64.shape[0]
        self._next += 1
        self._call(self.X64, self.Y64[asset], asset, self.X, self.Y[asset])
        return self.days

    def _call(self, X64, y64, asset, X=None, y=None):
        """One `batched_walk_forward` call on X (n_full, 6) and the target
        y (n_full,), its outputs kept for the check with their inputs."""
        if X is None:
            X = X64.to(self.device, self.dtype)
            y = y64.to(self.device, self.dtype)[:, None]
        self._fits.clear()
        res = wf_mod.batched_walk_forward(
            X, y, self.n_train, self._make_model, n_days=self.days,
            restart_noise_inits=self.restarts, maxiter=self.maxiter,
            train_likelihood_variance=True, device=self.device, dtype=self.dtype)
        fit = self._fits[-1]
        best = torch.cat([x.reshape(self.days, -1) for x in tree_leaves(res.models)], dim=1)
        self.calls.append(dict(
            asset=asset, X=X64, y=y64, params=fit.params.cpu(), loss=fit.loss.cpu(),
            grad_norm=fit.grad_norm.cpu(), iters=int(fit.iters), best=best.cpu(),
            f_mean=res.f_mean.cpu(), f_var=res.f_var.cpu()))

    def counters(self) -> dict:
        out = stationary_launches(self.device)
        if out and self.tier:
            table, key, name = TIERS[self.tier]
            if name:
                out[name] = table[key]
        return out

    def release(self):
        """Free the program's state; the window's outputs stay on the host."""
        batched_lbfgs.fit_batched_fused = self._fit
        del self.X, self.Y
        self._fits.clear()

    def attempted_failed(self):
        calls = self.outputs()
        failed = sum(int(torch.sum(~(torch.isfinite(c["f_mean"]) & torch.isfinite(c["f_var"]))))
                     for c in calls)
        return len(calls) * self.days, failed

    # -- the check -----------------------------------------------------------
    def outputs(self):
        """The set-up's call on the seed's market, then the window's calls."""
        return self.probe + self.calls

    def _rows(self, c):
        return c["params"].double().reshape(self.days, len(self.restarts), -1)

    def control_outputs(self, prec):
        """What the reference in precision `prec` returns in the program's
        place, at the parameters the program's calls returned."""
        dev = self.device
        out = []
        for c in self.outputs():
            X, y = c["X"].to(dev), c["y"].to(dev)
            loss, gnorm, f_mean, f_var, best = [], [], [], [], []
            for d, rows in enumerate(self._rows(c)):
                n = self.n_train + d
                v, g = ref.wf_nll_and_grad(X, y, rows.to(dev), n, prec)
                b = rows[int(torch.argmin(v))][None]
                m, s, _ = ref.wf_predict(X, y, b.to(dev), n, prec)
                for acc, x in ((loss, v), (gnorm, torch.linalg.norm(g, dim=-1)),
                               (f_mean, m), (f_var, s), (best, b)):
                    acc.append(x.double().cpu())
            out.append(dict(c, loss=torch.cat(loss), grad_norm=torch.cat(gnorm),
                            f_mean=torch.cat(f_mean), f_var=torch.cat(f_var),
                            best=torch.cat(best)))
        return out

    def readings(self, outputs, nan=float("inf")) -> dict:
        """The numbers the check compares, each the worst over every call
        (`outputs` as `self.outputs()`); `nan` is what a value that is not
        a number reads as (see `reference.gp.worst_of`):

        - nll_gap: a row's returned loss against the reference NLL at its
          returned parameters, relative;
        - grad_gap: the gap between the returned gradient norm and the
          reference's, over the call's median reference norm at the start
          (at a converged row both norms are rounding, so the scale is the
          problem's own);
        - pick_gap: how far the returned loss of the day's returned model
          lies above the day's least returned loss (exact: 0), inf if the
          model is none of the day's rows;
        - mean_gap, var_gap: the day-ahead mean (in units of the z-scored
          target) and variance (over the prior variance) against the
          reference posterior of the returned model;
        - unmoved_share: the share of rows whose reference NLL did not fall
          below its value at the start by more than the start's rounding
          to the program's dtype can account for (a few ulps of each raw
          parameter, to first order: a float32 row left where it started
          reads a hair below the float64 start);
        - fit_stall: how far the fits stopped short of a stationary point:
          of the ratios of the reference gradient's norm at a row's
          returned parameters to its norm at the row's start, the 90th
          percentile over rows (most rows converge in fewer iterations than
          the slowest tenth, which a cut leaves short first).

        Besides, for the record and not compared: `iters_max`, the most
        L-BFGS iterations a call ran."""
        dev = self.device
        R = len(self.restarts)
        start, noise = (torch.tensor(v, dtype=torch.float64) for v in (self.start, self.restarts))
        z0 = torch.cat([ref.positive_inv(start).expand(R, len(self.start)),
                        ref.positive_inv(noise)[:, None]], dim=1)
        worst = dict(nll_gap=0.0, grad_gap=0.0, pick_gap=0.0, mean_gap=0.0, var_gap=0.0)
        unmoved = rows_seen = 0
        stall = []
        for c in outputs:
            X, y = c["X"].to(dev), c["y"].to(dev)
            loss = c["loss"].double().reshape(self.days, R)
            gnorm = c["grad_norm"].double().reshape(self.days, R)
            gaps, start_norms = [], []
            for d, rows in enumerate(self._rows(c)):
                n = self.n_train + d
                v, g = (t.cpu() for t in ref.wf_nll_and_grad(X, y, rows.to(dev), n, ref.F64))
                v0, g0 = (t.cpu() for t in ref.wf_nll_and_grad(X, y, z0.to(dev), n, ref.F64))
                start_norms.append(torch.linalg.norm(g0, dim=-1))
                stall.append(torch.linalg.norm(g, dim=-1) / start_norms[-1])
                slack = _ROUNDING_ULPS * torch.finfo(self.dtype).eps * torch.sum(
                    torch.abs(g0) * torch.clamp_min(torch.abs(z0), 1.0), dim=-1)
                unmoved += int(torch.sum(~(v < v0 - slack)))
                rows_seen += R
                rel = torch.abs(loss[d] - v) / torch.clamp_min(torch.abs(v), 1.0)
                worst["nll_gap"] = max(worst["nll_gap"], worst_of(rel, nan))
                gaps.append(torch.abs(gnorm[d] - torch.linalg.norm(g, dim=-1)))
                picked = [r for r in range(R) if torch.equal(rows[r], c["best"][d].double())]
                if not picked:
                    worst["pick_gap"] = float("inf")
                    continue
                worst["pick_gap"] = max(worst["pick_gap"],
                                        worst_of(loss[d, picked[0]] - torch.min(loss[d]), nan))
                m, s, prior = ref.wf_predict(X, y, rows[picked[0]][None].to(dev), n, ref.F64)
                worst["mean_gap"] = max(worst["mean_gap"],
                                        worst_of(c["f_mean"][d] - m.cpu(), nan))
                worst["var_gap"] = max(worst["var_gap"],
                                       worst_of((c["f_var"][d] - s.cpu()) / prior.cpu(), nan))
            scale = statistics.median(torch.cat(start_norms).tolist())
            worst["grad_gap"] = max(worst["grad_gap"], worst_of(torch.cat(gaps), nan) / scale)
        stall = torch.nan_to_num(torch.cat(stall), nan=float("inf")) if stall else torch.ones(1)
        return dict(worst, unmoved_share=unmoved / max(rows_seen, 1),
                    fit_stall=float(torch.quantile(stall, 0.9, interpolation="higher")),
                    iters_max=max((c["iters"] for c in outputs), default=0))


def _recorded_since(last):
    """The entries of `gpr.DISPATCH_EVENTS` appended after the entry `last`
    (None: every entry)."""
    events = list(gpr.DISPATCH_EVENTS)
    for i in range(len(events) - 1, -1, -1):
        if events[i] is last:
            return events[i + 1:]
    return events
