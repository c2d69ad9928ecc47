"""Training workflows with GPflow-reference semantics.

Port of portfoliooptgp_tpu/train/trainer.py:

- `train_model(model, X, Y)` — single-model MLE with the likelihood frozen
  (Multi-Input_GPR/models/model_trainer.py:17-24);
- `train_likelihood(X, Y, kernel)` — restarts over the noise inits
  `STARTING_VARIANCES`, likelihood trainable, the restart with the lowest
  final loss kept (models/model_trainer.py:26-54);
- `train_best_model(X, Y, kernel_menu)` — kernel-menu selection: σ² pinned
  at 1e-5 and frozen, L-BFGS maxiter=100, winner by *training* MSE of the
  posterior mean (GPR/model_trainer.py:10-26);
- `train_restarts` / `train_restarts_fused` — generic batched-restart MLE.

Models carry a batch axis (1 for one model). With `fast` (default: the
data lies on a CUDA device, the counterpart of the JAX package's "the
backend is a TPU") the loss goes through
`batched_neg_log_marginal_likelihood`, so training runs the router's
kernel tiers and records their dispatch, and the restarts of
`train_likelihood` train as one batched L-BFGS (`fit_batched_fused`);
without it, through the plain `neg_log_marginal_likelihood`, restart by
restart (`lbfgs.fit_batched`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from portfoliooptgp_tpu_torch.models import gpr as gpr_mod
from portfoliooptgp_tpu_torch.models.gpr import GPR
from portfoliooptgp_tpu_torch.params import tree_to
from portfoliooptgp_tpu_torch.train import batched_lbfgs, lbfgs


class TrainedModel(NamedTuple):
    model: GPR
    loss: float
    mse: float
    iters: int


def _mse(model, X, Y) -> float:
    with torch.no_grad():
        mean, _ = gpr_mod.predict_f(model, X, Y, X)
        return float(torch.mean((mean[0] - Y) ** 2))


def _fast_default(X) -> bool:
    return X.device.type == "cuda"


def _match_dtype(tree, X):
    """Every leaf on the data's device and dtype (GPR.create and the kernel
    constructors may build leaves elsewhere)."""
    return tree_to(tree, X.device, X.dtype)


def train_model(model: GPR, X, Y, *, maxiter: int = 1000,
                train_likelihood_variance: bool = False, fast=None, **fit_kw):
    """MLE-train one model (batch axis 1); the likelihood stays frozen
    unless asked (gpflow.set_trainable(model.likelihood, False),
    models/model_trainer.py:19)."""
    if fast is None:
        fast = _fast_default(X)
    model = _match_dtype(model, X)
    frozen = None if train_likelihood_variance else lbfgs.freeze_leaves(model, likelihood=True)
    if fast:
        def loss(m):
            return gpr_mod.batched_neg_log_marginal_likelihood(
                m, X, Y, device=X.device, dtype=X.dtype)[0]
    else:
        def loss(m):
            return gpr_mod.neg_log_marginal_likelihood(m, X, Y)[0]
    res = lbfgs.fit(loss, model, maxiter=maxiter, frozen=frozen, **fit_kw)
    return TrainedModel(model=res.params, loss=res.loss, mse=_mse(res.params, X, Y),
                        iters=res.iters)


# reference restart grid over noise-variance inits (models/model_trainer.py:26)
STARTING_VARIANCES: Sequence[float] = (1e-5, 1e-3, 1e-1, 1.0)


def _best(losses):
    """(index of the lowest finite loss, losses with non-finite ones as inf)."""
    losses = torch.where(torch.isfinite(losses), losses,
                         torch.full_like(losses, float("inf")))
    return int(torch.argmin(losses)), losses


def train_likelihood(X, Y, kernel, starting_variances: Sequence[float] = STARTING_VARIANCES,
                     *, maxiter: int = 1000, mean_function=None, **fit_kw) -> TrainedModel:
    """Multi-restart over noise inits, winner the lowest final loss
    (models/model_trainer.py:26-54); a diverged restart's non-finite loss is
    left out of the argmin. `iters` is the batched run's iteration count on
    the fast branch and the winner's on the plain one, as in the JAX
    package."""
    models = [GPR.create(kernel, noise_variance=v, mean_function=mean_function)
              for v in starting_variances]
    stacked = _match_dtype(lbfgs.stack_pytrees(models), X)
    fast = fit_kw.pop("fast", None)
    if fast is None:
        fast = _fast_default(X)
    if fast:
        params, bres = batched_lbfgs.fit_batched_fused(
            lambda ms: gpr_mod.batched_neg_log_marginal_likelihood(
                ms, X, Y, device=X.device, dtype=X.dtype),
            stacked, maxiter=maxiter, **fit_kw)
        best, losses = _best(bres.loss)
        model = lbfgs.index_pytree(params, best)
        return TrainedModel(model=model, loss=float(losses[best]), mse=_mse(model, X, Y),
                            iters=bres.iters)
    res = lbfgs.fit_batched(lambda m: gpr_mod.neg_log_marginal_likelihood(m, X, Y)[0],
                            stacked, maxiter=maxiter, **fit_kw)
    best, losses = _best(res.loss)
    model = lbfgs.index_pytree(res.params, best)
    return TrainedModel(model=model, loss=float(losses[best]), mse=_mse(model, X, Y),
                        iters=int(res.iters[best]))


class MenuResult(NamedTuple):
    best_index: int
    best: TrainedModel
    losses: list
    mses: list
    tiers: list  # NLL dispatch tier per menu entry (gpr.nll_tier)


def train_best_model(X, Y, kernel_menu, *, noise_variance: float = 1e-5,
                     maxiter: int = 100, mean_function=None, **fit_kw) -> MenuResult:
    """Kernel-menu selection by training MSE (GPR/model_trainer.py:10-26).
    `mean_function` is trained jointly with the kernel hyperparameters."""
    trained, losses, mses, tiers = [], [], [], []
    fast = fit_kw.get("fast")
    if fast is None:
        fast = _fast_default(X)
    for kernel in kernel_menu:
        model = _match_dtype(GPR.create(kernel, noise_variance=noise_variance,
                                        mean_function=mean_function), X)
        tiers.append(gpr_mod.nll_tier(model, X, Y, fast=fast))
        t = train_model(model, X, Y, maxiter=maxiter, **fit_kw)
        trained.append(t)
        losses.append(float(t.loss))
        mses.append(float(t.mse))
    finite = [m if math.isfinite(m) else float("inf") for m in mses]
    best_index = int(min(range(len(finite)), key=lambda i: finite[i]))
    return MenuResult(best_index=best_index, best=trained[best_index],
                      losses=losses, mses=mses, tiers=tiers)


def train_restarts(loss_fn, stacked_models, *, maxiter: int = 100, frozen=None, **fit_kw):
    """Generic batched-restart MLE, restart by restart (`lbfgs.fit_batched`;
    `loss_fn` takes one model): (best model, best loss, all losses)."""
    res = lbfgs.fit_batched(loss_fn, stacked_models, maxiter=maxiter, frozen=frozen, **fit_kw)
    best, losses = _best(res.loss)
    return lbfgs.index_pytree(res.params, best), losses[best], losses


def train_restarts_fused(X, Y, stacked_models, *, maxiter: int = 100, frozen=None, **fit_kw):
    """Batched-restart GPR MLE as one batched L-BFGS on the routed NLL (one
    batched value+grad per iteration): (best model, best loss, all losses)."""
    models, res = batched_lbfgs.fit_batched_fused(
        lambda ms: gpr_mod.batched_neg_log_marginal_likelihood(
            ms, X, Y, device=X.device, dtype=X.dtype),
        stacked_models, frozen=frozen, maxiter=maxiter, **fit_kw)
    best, losses = _best(res.loss)
    return lbfgs.index_pytree(models, best), losses[best], losses
