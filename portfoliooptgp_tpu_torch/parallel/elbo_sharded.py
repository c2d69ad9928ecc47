"""The data-parallel SVGP ELBO over a mesh, and the minibatched train step.

Port of portfoliooptgp_tpu/parallel/elbo_sharded.py. The observation axis
is split over the mesh's `data` axis: each rank holds its rows (X, Y, w)
as ordinary tensors and the model replicated, reduces its rows into
partial sums, one all-reduce combines them, and the rest of the loss is
computed alike on every rank (parallel/mesh.py's `psum` and
`replicated_input` give it the one-device gradient). Padding rows carry
weight 0 and contribute exactly nothing.

For a Gaussian likelihood the partials are the Gram path's additive tuple
(G, sq_err, kdiag_w, W): each rank runs `gram_chol`, then
`gram_partials_fused` (the hand-written gram kernels, ops/svgp_gram.py)
when `svgp_gram_fused_supported` holds for its rows, else `gram_partials`;
one all-reduce of the ~M² + 3 values, packed into one buffer, whatever the
batch; then `gram_finish`. Other likelihoods all-reduce the weighted
variational expectations and Σw, and add the KL once.

`make_elbo_train_step(mesh=)` takes the sharded loss when `mesh.size > 1`
and the one-device loss otherwise, as in JAX: a Gaussian-likelihood model
trains on `-gaussian_elbo_gram_fused(model, X, Y, weights=w, num_data=N)`
with its batch phase in torch (`elbo_sharded.py:121-126`), others on the
weighted variational expectations. The optimizer defaults to `Adam(1e-2)`
(optax's `adam(1e-2)`) over the raw leaves; `frozen` zeroes the gradients
of the leaves it marks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portfoliooptgp_tpu_torch.models import svgp as svgp_mod
from portfoliooptgp_tpu_torch.models.likelihoods import Gaussian
from portfoliooptgp_tpu_torch.params import tree_leaves, tree_replace
from portfoliooptgp_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    all_reduce_sum,
    pad_to_multiple,
    place,
    psum,
    replicated_input,
    shard_batch,
)
from portfoliooptgp_tpu_torch.train.optim import Adam, make_step


def weighted_expectation_sum(model, X, Y, w):
    """Σ_n w_n E_q[log p(y_n | f_n)] over the given rows."""
    mean, var = svgp_mod.predict_f_guarded(model, X)
    ve = model.likelihood.variational_expectations(mean, var, Y)
    return torch.sum(ve * w[:, None])


def _is_gaussian(model) -> bool:
    return isinstance(model.likelihood, Gaussian)


def _local(model, extra, mesh):
    """The replicated model (and `extra` tensors derived from it) as this
    rank's row computation takes them: their gradients are summed over the
    data axis."""
    leaves = tree_leaves(model)
    local = replicated_input(leaves + list(extra), mesh, DATA_AXIS)
    return tree_replace(model, local[:len(leaves)]), local[len(leaves):]


def sharded_neg_elbo(model, X, Y, w, num_data: int, mesh):
    """Negative ELBO with the data axis split over `mesh`.

    X, Y, w: this rank's rows (`prepare_global_batch`, `shard_batch`, or the
    mesh iterator's); the model equal on every rank. Returns the same
    scalar on every rank, equal (up to the order of the float sums) to the
    one-device `svgp.neg_elbo` of the whole batch, and differentiable: its
    gradient is the one-device gradient."""
    if _is_gaussian(model):
        Luu = svgp_mod.gram_chol(model)
        model_l, (Luu_l,) = _local(model, [Luu], mesh)
        if svgp_mod.svgp_gram_fused_supported(model_l, X):
            partials = svgp_mod.gram_partials_fused(model_l, Luu_l, X, Y, w)
        else:
            partials = svgp_mod.gram_partials(model_l, Luu_l, X, Y, w)
        G, sq_err, kdiag_w, W = psum(partials, mesh, DATA_AXIS)
        return -svgp_mod.gram_finish(model, Luu, (G, sq_err, kdiag_w, W), num_data)
    model_l, _ = _local(model, [], mesh)
    ve_total, = psum([weighted_expectation_sum(model_l, X, Y, w)], mesh, DATA_AXIS)
    n_total, = all_reduce_sum([torch.sum(w)], mesh, DATA_AXIS)
    return -(ve_total * (num_data / n_total) - svgp_mod.prior_kl(model))


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
    the loss is carried from the last real batch (inf if there was none).
    With a mesh of more than one rank the batches are this rank's rows and
    the loss is `sharded_neg_elbo`; a batch is skipped when its weights sum
    to 0 over all ranks."""
    optimizer = optimizer or Adam(1e-2)
    sharded = mesh is not None and mesh.size > 1

    def loss_fn(model, X, Y, w):
        if sharded:
            return sharded_neg_elbo(model, X, Y, w, num_data, mesh)
        if _is_gaussian(model):
            return -svgp_mod.gaussian_elbo_gram_fused(model, X, Y, weights=w,
                                                      num_data=num_data)
        ve = weighted_expectation_sum(model, X, Y, w)
        scale = num_data / torch.clamp_min(torch.sum(w), 1.0)
        return -(ve * scale - svgp_mod.prior_kl(model))

    def init_fn(model) -> TrainState:
        return TrainState(model=model, opt_state=optimizer.init(model))

    one_step = make_step(loss_fn, optimizer, frozen)
    if inner_steps == 1:
        return init_fn, one_step
    return init_fn, group_step(one_step, mesh if sharded else None)


def group_step(one_step, mesh=None):
    """step_fn(state, Xs, Ys, ws) over a group (K, batch, ...): `one_step`
    on each inner batch whose weights sum above 0 (over the data axis of
    `mesh`, if given), none on the all-zero batches of the iterator's tail;
    the loss of the last real batch (inf if there was none)."""

    def step_fn(state, Xs, Ys, ws):
        loss = torch.full((), float("inf"), dtype=Xs.dtype, device=Xs.device)
        sums = torch.sum(ws, dim=1)
        if mesh is not None:
            sums, = all_reduce_sum([sums], mesh, DATA_AXIS)
        real = (sums > 0.0).tolist()  # one sync per group
        for k in range(Xs.shape[0]):
            if real[k]:
                state, loss = one_step(state, Xs[k], Ys[k], ws[k])
        return state, loss

    return step_fn


def prepare_global_batch(mesh, X, Y, dtype=None):
    """Pad the rows of the global batch (X, Y) to a multiple of the data
    axis and give this rank its shard: (X, Y, w) on the rank's device, w 1
    for real rows and 0 for padding."""
    Xp, Yp, w = pad_to_multiple(place(mesh, X, dtype), place(mesh, Y, dtype),
                                mesh.shape[DATA_AXIS])
    return shard_batch(mesh, Xp, Yp, w)
