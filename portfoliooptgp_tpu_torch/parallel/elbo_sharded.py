"""The minibatched SVGP train step on one device.

Port of the one-device part of portfoliooptgp_tpu/parallel/elbo_sharded.py.
The data-parallel ELBO over a mesh (`sharded_neg_elbo`, the psum of the
Gram partials) is ROADMAP.md queue 1 item 8; a mesh raises here.

A Gaussian-likelihood model trains on `-gaussian_elbo_gram_fused(model,
X, Y, weights=w, num_data=N)` with its default batch phase in torch, as the
JAX trainer does (`elbo_sharded.py:121-126`); other likelihoods on the
weighted variational expectations. The optimizer defaults to `Adam(1e-2)`
(optax's `adam(1e-2)`) over the raw leaves; `frozen` zeroes the gradients
of the leaves it marks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from portfoliooptgp_tpu_torch.models import svgp as svgp_mod
from portfoliooptgp_tpu_torch.models.likelihoods import Gaussian
from portfoliooptgp_tpu_torch.train.optim import Adam, make_step


def weighted_expectation_sum(model, X, Y, w):
    """Σ_n w_n E_q[log p(y_n | f_n)]."""
    mean, var = svgp_mod.predict_f_guarded(model, X)
    ve = model.likelihood.variational_expectations(mean, var, Y)
    return torch.sum(ve * w[:, None])


class TrainState(NamedTuple):
    model: svgp_mod.SVGP
    opt_state: object


def make_elbo_train_step(num_data: int, mesh=None, optimizer=None, frozen=None,
                         inner_steps: int = 1):
    """(init_fn, step_fn) for minibatched SVGP training.

    inner_steps = 1: step_fn(state, X, Y, w) → (state, neg_elbo).
    inner_steps = K > 1: step_fn consumes a group (K, batch, ...) and runs
    K Adam steps; inner batches whose weights sum to 0 (the iterator's
    tail padding) are skipped exactly — no moment decay, no update — and
    the loss is carried from the last real batch (inf if there was none)."""
    if mesh is not None:
        raise NotImplementedError(
            "the data-parallel ELBO over a mesh is not ported yet: ROADMAP.md queue 1 item 8")
    optimizer = optimizer or Adam(1e-2)

    def loss_fn(model, X, Y, w):
        if isinstance(model.likelihood, Gaussian):
            return -svgp_mod.gaussian_elbo_gram_fused(model, X, Y, weights=w,
                                                      num_data=num_data)
        ve = weighted_expectation_sum(model, X, Y, w)
        scale = num_data / torch.clamp_min(torch.sum(w), 1.0)
        return -(ve * scale - svgp_mod.prior_kl(model))

    def init_fn(model) -> TrainState:
        return TrainState(model=model, opt_state=optimizer.init(model))

    one_step = make_step(loss_fn, optimizer, frozen)
    return init_fn, one_step if inner_steps == 1 else group_step(one_step)


def group_step(one_step):
    """step_fn(state, Xs, Ys, ws) over a group (K, batch, ...): `one_step`
    on each inner batch whose weights sum above 0, none on the all-zero
    batches of the iterator's tail; the loss of the last real batch (inf if
    there was none)."""

    def step_fn(state, Xs, Ys, ws):
        loss = torch.full((), float("inf"), dtype=Xs.dtype, device=Xs.device)
        real = (torch.sum(ws, dim=1) > 0.0).tolist()  # one sync per group
        for k in range(Xs.shape[0]):
            if real[k]:
                state, loss = one_step(state, Xs[k], Ys[k], ws[k])
        return state, loss

    return step_fn
