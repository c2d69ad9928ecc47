"""SVGP training workflows. Port of portfoliooptgp_tpu/train/svgp_trainer.py.

The reference trains its SVGP with L-BFGS (maxiter 100) over a kernel menu,
the likelihood frozen at 1e-4 and inducing points on a linspace, and picks
the winner by test MSE (test_scripts/SVGP.py:497-553): `train_svgp` and
`train_svgp_menu`. `train_svgp_minibatched` is Adam on the minibatch ELBO
fed by `data.iterator.MinibatchIterator`, for N too large for one batch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from portfoliooptgp_tpu_torch.data.iterator import MinibatchIterator
from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE
from portfoliooptgp_tpu_torch.models import svgp as svgp_mod
from portfoliooptgp_tpu_torch.models.likelihoods import Gaussian
from portfoliooptgp_tpu_torch.models.svgp import SVGP
from portfoliooptgp_tpu_torch.parallel import elbo_sharded
from portfoliooptgp_tpu_torch.train import lbfgs


class SVGPTrainResult(NamedTuple):
    model: SVGP
    elbo: float
    iters: int


def train_svgp(model: SVGP, X, Y, *, maxiter: int = 100, num_data: Optional[int] = None,
               freeze_likelihood: bool = True, **fit_kw) -> SVGPTrainResult:
    """L-BFGS on the negative ELBO (Scipy().minimize parity,
    test_scripts/SVGP.py:530-533)."""
    frozen = lbfgs.freeze_leaves(model, likelihood=True) if freeze_likelihood else None
    res = lbfgs.fit(lambda m: svgp_mod.neg_elbo(m, X, Y, num_data), model,
                    maxiter=maxiter, frozen=frozen, **fit_kw)
    return SVGPTrainResult(model=res.params, elbo=-res.loss, iters=res.iters)


def train_svgp_minibatched(model: SVGP, X, Y, *, batch_size: int, num_epochs: int = 10,
                           mesh=None, optimizer=None, freeze_likelihood: bool = True,
                           shuffle: bool = True, seed: int = 0,
                           inner_steps: int = 8) -> SVGPTrainResult:
    """Adam on the minibatch negative ELBO, fed by the host-staging
    iterator in groups of `inner_steps` batches (the tail group's all-zero
    batches are skipped). X, Y may be arrays or tensors; batches are placed
    on the model's device in its dtype. `iters` counts the real batches.
    With a mesh (parallel/mesh.py) every rank calls this with the same
    arguments: it trains on its row shard of each batch through the
    sharded ELBO, and every rank ends with the same model."""
    frozen = lbfgs.freeze_leaves(model, likelihood=True) if freeze_likelihood else None
    init_fn, step_fn = elbo_sharded.make_elbo_train_step(
        num_data=X.shape[0], mesh=mesh, optimizer=optimizer, frozen=frozen,
        inner_steps=inner_steps)
    state = init_fn(model)
    loss = torch.tensor(math.inf)
    with MinibatchIterator(X, Y, batch_size, mesh=mesh, num_epochs=num_epochs,
                           shuffle=shuffle, seed=seed, inner_steps=inner_steps,
                           device=model.Z.device, dtype=model.Z.dtype) as it:
        steps_per_epoch = it.steps_per_epoch()
        for Xb, Yb, wb in it:
            state, loss = step_fn(state, Xb, Yb, wb)
    return SVGPTrainResult(model=state.model, elbo=-float(loss),
                           iters=num_epochs * steps_per_epoch)


class SVGPMenuResult(NamedTuple):
    best_index: int
    best: SVGPTrainResult
    test_mses: list


def train_svgp_menu(X_train, Y_train, X_test, Y_test, kernel_menu: Sequence, inducing_points,
                    *, noise_variance: float = 1e-4, maxiter: int = 100,
                    device=DEFAULT_DEVICE, dtype=None, **fit_kw) -> SVGPMenuResult:
    """Kernel-menu SVGP selection by test MSE (test_scripts/SVGP.py:497-551:
    Gaussian(1e-4) frozen, linspace inducing points, maxiter 100). `dtype`
    defaults to X_train's."""
    dtype = X_train.dtype if dtype is None else dtype
    results, mses = [], []
    for kernel in kernel_menu:
        model = SVGP.create(kernel, inducing_points=inducing_points,
                            likelihood=Gaussian.create(noise_variance, device=device, dtype=dtype),
                            device=device, dtype=dtype)
        t = train_svgp(model, X_train, Y_train, maxiter=maxiter, num_data=X_train.shape[0],
                       **fit_kw)
        mean, _ = svgp_mod.predict_f(t.model, X_test)
        mse = float(torch.mean((mean - Y_test) ** 2))
        results.append(t)
        mses.append(mse if math.isfinite(mse) else float("inf"))
    best = min(range(len(mses)), key=lambda i: mses[i])
    return SVGPMenuResult(best_index=best, best=results[best], test_mses=mses)
