"""L-BFGS with a zoom line search, and helpers over stacked model trees.

Port of portfoliooptgp_tpu/train/lbfgs.py. The JAX `fit` is optax's
`lbfgs` (the L-BFGS direction of `scale_by_lbfgs`, negated, then
`scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')`) inside a `lax.while_loop` with the
scipy-like gtol / ftol / maxiter stopping rules. This module ports those
pieces rule for rule (optax/_src/transform.py `scale_by_lbfgs`,
optax/_src/linesearch.py `zoom_linesearch`) as Python loops over R
independent rows in lockstep (`fit_rows`, the counterpart of the JAX
package's `vmap` of `fit`): parameters and gradients stay on their
device; the line search's bookkeeping runs on the host in float64, one
(R,) array a quantity, with one host copy per trial for all rows.
`torch.optim.LBFGS` stops by other rules, so it is not used.

`fit` is `fit_rows` of one row. It takes one parameter tensor (the blend
fit's) or a model tree (the trainers'): a tree's leaves are flattened into
one vector in `tree_leaves` order, and a frozen tree (`freeze_leaves`)
becomes a mask over it. Frozen coordinates enter the loss detached, so
their gradient, and the L-BFGS direction, is exactly zero on them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from portfoliooptgp_tpu_torch.params import batch_size, tree_leaves, tree_map, tree_replace


class FitResult(NamedTuple):
    params: object  # a tensor, or a model tree, like the input
    loss: float
    grad_norm: float
    iters: int
    converged: bool  # True if gtol/ftol hit before maxiter


class BatchedFitResult(NamedTuple):
    params: object  # a stacked model tree (batch B)
    loss: torch.Tensor  # (B,)
    grad_norm: torch.Tensor  # (B,)
    iters: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,)


# -- optax.scale_by_zoom_linesearch, ported --------------------------------

_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5
_INCREASE_FACTOR = 2.0
_MAX_LINESEARCH_STEPS = 20
_TOL = 0.0


def _rows_value_and_grad(loss_rows, x):
    """(R,) values and (R, D) gradients of independent rows."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        value = loss_rows(xr)
        (grad,) = torch.autograd.grad(value.sum(), xr)
    return value.detach(), grad


def _host(*rows):
    """Several (R,) device tensors as float64 numpy arrays, in one copy."""
    return torch.stack(rows).to("cpu", torch.float64).numpy()


def _device(values, like, dtype=None):
    """A host numpy array as a tensor on `like`'s device, of `like`'s dtype
    or `dtype`. A card gets it through pinned memory, so the copy does not
    wait for the kernels queued before it."""
    t = torch.tensor(values, dtype=like.dtype if dtype is None else dtype)
    if like.is_cuda:
        t = t.pin_memory().to(like.device, non_blocking=True)
    return t


def _pick(rows, new, old):
    """Rows of `new` where the (R,) numpy bool `rows` holds, else of `old`."""
    if rows.all():
        return new
    if not rows.any():
        return old
    keep = _device(rows, new, torch.bool).reshape(-1, *(1,) * (new.ndim - 1))
    return torch.where(keep, new, old)


# The helpers below run inside `zoom_linesearch`'s np.errstate(all="ignore"):
# a NaN error counts as infinite, and a degenerate interpolation gives a
# NaN or infinite step that the interval tests then refuse.

def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    dec = value_step - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * _SLOPE_RTOL - 1.0) * slope_init
    delta_values = value_step - value_init - _APPROX_DEC_RTOL * np.abs(value_init)
    approx = np.maximum(approx, delta_values)
    dec = np.maximum(np.minimum(approx, dec), 0.0)
    return np.where(np.isnan(dec), np.inf, dec)


def _curvature_error(slope_step, slope_init):
    curv = np.maximum(np.abs(slope_step) - _CURV_RTOL * np.abs(slope_init), 0.0)
    return np.where(np.isnan(curv), np.inf, curv)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    rb = fb - fa - C * db
    rc = fc - fa - C * dc
    A = (dc ** 2 * rb - db ** 2 * rc) / denom
    B = (-(dc ** 3) * rb + db ** 3 * rc) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


def zoom_linesearch(loss_rows, x, d, value, grad, active):
    """Stepsize along `d` from `x` satisfying sufficient decrease and small
    curvature (Nocedal & Wright algorithms 3.5/3.6 as optax implements
    them, initial guess 1), for R independent rows in lockstep: one batched
    value+grad of all rows per trial and one host copy of their values and
    slopes. `x`, `d`, `grad` (R, D); `value` (R,) float64 numpy; `active`
    (R,) bool: the other rows keep stepsize 0 and their value and gradient,
    as does each row from the trial its search ends. Returns (stepsize (R,)
    numpy, value (R,) numpy, grad (R, D))."""
    R = value.shape[0]
    value_init = value.copy()
    slope_init = _host(torch.sum(d * grad, dim=-1))[0]
    count = np.zeros(R, dtype=np.int64)
    stepsize, slope = np.zeros(R), slope_init.copy()
    value = value.copy()
    dec_err = np.full(R, np.inf)
    interval_found = np.zeros(R, dtype=bool)
    done = ~np.asarray(active, dtype=bool)
    failed = np.zeros(R, dtype=bool)
    low, value_low, slope_low = np.zeros(R), value.copy(), slope_init.copy()
    high, value_high, slope_high = np.zeros(R), value.copy(), slope_init.copy()
    cubic_ref, value_cubic_ref = np.zeros(R), value.copy()
    safe_stepsize, safe_value = np.zeros(R), value.copy()
    safe_grad = grad

    with np.errstate(all="ignore"):
        while not np.all(done | failed):
            run = ~(done | failed)
            search = run & ~interval_found
            zoom = run & interval_found
            searching, zooming = search.any(), zoom.any()
            # trial steps: _search_interval's doubling, _zoom_into_interval's
            # cubic, quadratic or bisection choice
            new_step = np.where(search, np.where(count == 0, 1.0, _INCREASE_FACTOR * stepsize),
                                0.0)
            if zooming:
                delta = np.abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                too_small = delta <= _INTERVAL_THRESHOLD
                mc = _cubicmin(low, value_low, slope_low, high, value_high, cubic_ref,
                               value_cubic_ref)
                use_cubic = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
                mq = _quadmin(low, value_low, slope_low, high, value_high)
                use_quad = ~use_cubic & (mq > left + 0.1 * delta) & (mq < right - 0.1 * delta)
                new_step = np.where(zoom, np.where(use_cubic, mc,
                                                   np.where(use_quad, mq, (low + high) / 2.0)),
                                    new_step)

            v_t, g = _rows_value_and_grad(loss_rows, x + _device(new_step, x)[:, None] * d)
            v, sl = _host(v_t, torch.sum(g * d, dim=-1))
            dec = _decrease_error(new_step, v, sl, value_init, slope_init)
            err = np.maximum(dec, _curvature_error(sl, slope_init))
            it = count

            safe = search & (dec <= _TOL)
            if zooming:
                # _zoom_into_interval's updates, from the interval the trial
                # was taken in
                safe |= zoom & (dec <= _TOL) & (v < safe_value)
                set_high_mid = (dec > 0.0) | (v >= value_low)
                set_high_low = (sl * (high - low) >= 0.0) & ~set_high_mid
                to_high = set_high_mid | set_high_low
                z_mid, z_low = zoom & set_high_mid, zoom & set_high_low
                z_new_low = zoom & ~set_high_mid
                cubic_ref = np.where(zoom, np.where(to_high, high, low), cubic_ref)
                value_cubic_ref = np.where(zoom, np.where(to_high, value_high, value_low),
                                           value_cubic_ref)
                high = np.where(z_mid, new_step, np.where(z_low, low, high))
                value_high = np.where(z_mid, v, np.where(z_low, value_low, value_high))
                slope_high = np.where(z_mid, sl, np.where(z_low, slope_low, slope_high))
                low = np.where(z_new_low, new_step, low)
                value_low = np.where(z_new_low, v, value_low)
                slope_low = np.where(z_new_low, sl, slope_low)
            if searching:
                # _search_interval's updates: the new step becomes the low
                # end or the high one, the previous step the other
                set_high = (dec > 0.0) | ((v >= value) & (it > 0))
                set_low = (sl >= 0.0) & ~set_high
                low = np.where(search, np.where(set_low, new_step, stepsize), low)
                value_low = np.where(search, np.where(set_low, v, value), value_low)
                slope_low = np.where(search, np.where(set_low, sl, slope), slope_low)
                high = np.where(search, np.where(set_low, stepsize, new_step), high)
                value_high = np.where(search, np.where(set_low, value, v), value_high)
                slope_high = np.where(search, np.where(set_low, slope, sl), slope_high)
                cubic_ref = np.where(search, low, cubic_ref)
                value_cubic_ref = np.where(search, value_low, value_cubic_ref)
                interval_found = interval_found | (search & (set_high | set_low | (err <= _TOL)))

            safe_stepsize = np.where(safe, new_step, safe_stepsize)
            safe_value = np.where(safe, v, safe_value)
            safe_grad = _pick(safe, g, safe_grad)

            presumably_failed = it + 1 >= _MAX_LINESEARCH_STEPS
            if zooming:
                presumably_failed = presumably_failed | (
                    zoom & too_small & (safe_stepsize > 0.0))
            now_done = run & (err <= _TOL)
            now_failed = run & presumably_failed & ~now_done
            done = done | now_done
            failed = failed | now_failed

            count = np.where(run, it + 1, count)
            stepsize = np.where(run, new_step, stepsize)
            value = np.where(run, v, value)
            slope = np.where(run, sl, slope)
            dec_err = np.where(run, dec, dec_err)
            grad = _pick(run, g, grad)
            # _try_safe_step on the rows that failed in this trial
            to_safe = now_failed & ((safe_stepsize > 0.0) | np.isinf(dec_err))
            if to_safe.any():
                stepsize = np.where(to_safe, safe_stepsize, stepsize)
                value = np.where(to_safe, safe_value, value)
                grad = _pick(to_safe, safe_grad, grad)
    return stepsize, value, grad


# -- optax.scale_by_lbfgs, ported ------------------------------------------

def fit_rows(loss_rows: Callable, x0, *, maxiter: int = 100, gtol: float = 1e-8,
             ftol: float = 1e-11, memory_size: int = 10) -> BatchedFitResult:
    """Minimize R independent problems at once, the counterpart of the JAX
    package's `vmap` of `lbfgs.fit`: `loss_rows` maps (R, D) to (R,), row r
    depending on row r only. Each row keeps its own memory, scale,
    two-loop direction, zoom line search and gtol / ftol / maxiter test,
    in lockstep: one batched value+grad per line-search trial, and a row
    that has stopped keeps its state. Returns a `BatchedFitResult` whose
    `params` is the (R, D) tensor."""
    x = x0.detach().clone()
    R, n = x.shape
    opts = dict(dtype=x.dtype, device=x.device)
    value_t, grad = _rows_value_and_grad(loss_rows, x)
    value = _host(value_t)[0]
    prev_value = np.full(R, np.inf)
    iters = np.zeros(R, dtype=np.int64)
    last_params = torch.zeros_like(x)
    last_updates = torch.zeros_like(x)
    dW = torch.zeros((R, memory_size, n), **opts)
    dU = torch.zeros((R, memory_size, n), **opts)
    rhos = torch.zeros((R, memory_size), **opts)
    count = 0  # every running row has made `count` steps

    while True:
        gn = _host(torch.linalg.vector_norm(grad, dim=-1))[0]
        with np.errstate(invalid="ignore"):
            running = (iters < maxiter) & (gn > gtol) & (
                np.abs(prev_value - value) > ftol * np.maximum(1.0, np.abs(value)))
        if not running.any():
            break
        # 1. memory update from the fresh params and gradients
        mem_idx = count % memory_size
        prev_idx = (count - 1) % memory_size
        if count > 0:
            dp = x - last_params
            du = grad - last_updates
            vd, den = _host(torch.sum(du * dp, dim=-1), torch.sum(du * du, dim=-1))
            with np.errstate(divide="ignore", invalid="ignore"):
                rho_new = np.where(vd == 0.0, 0.0, 1.0 / vd)
                scale = np.where(den > 0.0, vd / den, 1.0)
        else:
            dp = du = torch.zeros_like(x)
            rho_new = np.zeros(R)
            with np.errstate(divide="ignore"):
                scale = np.minimum(1.0, 1.0 / gn)
        dW[:, prev_idx] = _pick(running, dp, dW[:, prev_idx])
        dU[:, prev_idx] = _pick(running, du, dU[:, prev_idx])
        rhos[:, prev_idx] = _pick(running, _device(rho_new, x), rhos[:, prev_idx])
        # 2. two-loop product with the inverse-Hessian approximation, oldest
        # pair first; the slots not yet filled hold zeros and are skipped
        indices = [(mem_idx + i) % memory_size
                   for i in range(memory_size - min(count, memory_size), memory_size)]
        vec = grad
        alphas = {}
        for idx in reversed(indices):
            alphas[idx] = rhos[:, idx] * torch.sum(dW[:, idx] * vec, dim=-1)
            vec = vec - alphas[idx][:, None] * dU[:, idx]
        vec = vec * _device(scale, x)[:, None]
        for idx in indices:
            beta = rhos[:, idx] * torch.sum(dU[:, idx] * vec, dim=-1)
            vec = vec + (alphas[idx] - beta)[:, None] * dW[:, idx]
        last_params = _pick(running, x, last_params)
        last_updates = _pick(running, grad, last_updates)
        count += 1
        # 3. negate, then the line search scales the direction
        direction = -vec
        stepsize, new_value, new_grad = zoom_linesearch(
            loss_rows, x, direction, value, grad, running)
        x = _pick(running, x + _device(stepsize, x)[:, None] * direction, x)
        prev_value = np.where(running, value, prev_value)
        value = np.where(running, new_value, value)
        grad = _pick(running, new_grad, grad)
        iters = iters + running

    gn = _host(torch.linalg.vector_norm(grad, dim=-1))[0]
    with np.errstate(invalid="ignore"):
        converged = (gn <= gtol) | (np.abs(prev_value - value)
                                    <= ftol * np.maximum(1.0, np.abs(value)))
    return BatchedFitResult(
        params=x, loss=torch.as_tensor(value, dtype=value_t.dtype, device=x.device),
        grad_norm=torch.as_tensor(gn, **opts),
        iters=torch.as_tensor(iters, device=x.device),
        converged=torch.as_tensor(converged, device=x.device))


def _flatten(params, frozen):
    """(flat vector, unflatten(z) → params, flat frozen mask or None)."""
    if isinstance(params, torch.Tensor):
        shape = params.shape
        mask = (None if frozen is None
                else torch.as_tensor(frozen, device=params.device).reshape(-1))
        return params.detach().reshape(-1).clone(), lambda z: z.reshape(shape), mask
    leaves = tree_leaves(params)
    sizes = [leaf.numel() for leaf in leaves]
    flat = torch.cat([leaf.detach().reshape(-1) for leaf in leaves])

    def unflatten(z):
        parts = torch.split(z, sizes)
        return tree_replace(params, [p.reshape(leaf.shape) for p, leaf in zip(parts, leaves)])

    mask = None
    if frozen is not None:
        mask = torch.cat([torch.full((n,), bool(f), device=flat.device)
                          for n, f in zip(sizes, tree_leaves(frozen))])
    return flat, unflatten, mask


def fit(
    loss_fn: Callable,
    params,
    *,
    maxiter: int = 100,
    gtol: float = 1e-8,
    ftol: float = 1e-11,
    memory_size: int = 10,
    frozen=None,
) -> FitResult:
    """Minimize scalar `loss_fn(params)` with L-BFGS + zoom line search;
    `params` a tensor or a model tree, `frozen` a boolean tensor of its
    shape or a tree of booleans. It is `fit_rows` of one row."""
    x, unflatten, mask = _flatten(params, frozen)

    def loss_rows(Z):
        # frozen coordinates enter the loss detached, so their gradient is 0
        z = Z[0] if mask is None else torch.where(mask, Z[0].detach(), Z[0])
        return loss_fn(unflatten(z)).reshape(1)

    res = fit_rows(loss_rows, x[None], maxiter=maxiter, gtol=gtol, ftol=ftol,
                   memory_size=memory_size)
    return FitResult(params=unflatten(res.params[0]), loss=float(res.loss[0]),
                     grad_norm=float(res.grad_norm[0]), iters=int(res.iters[0]),
                     converged=bool(res.converged[0]))


def fit_batched(loss_fn: Callable, stacked_params, **kwargs) -> BatchedFitResult:
    """`fit` of every model of a stacked tree (batch B), each with its own
    iterations and stopping rule, as the JAX package's vmap of `fit` runs
    them. `loss_fn` takes one model (batch 1) and returns its scalar loss;
    `frozen`, if given, is the mask tree of one model."""
    results = [fit(loss_fn, index_pytree(stacked_params, i), **kwargs)
               for i in range(batch_size(stacked_params))]
    leaf = tree_leaves(stacked_params)[0]
    opts = dict(dtype=leaf.dtype, device=leaf.device)
    return BatchedFitResult(
        params=stack_pytrees([r.params for r in results]),
        loss=torch.tensor([r.loss for r in results], **opts),
        grad_norm=torch.tensor([r.grad_norm for r in results], **opts),
        iters=torch.tensor([r.iters for r in results], device=leaf.device),
        converged=torch.tensor([r.converged for r in results], device=leaf.device))


# -- stacked model trees -----------------------------------------------------

def stack_pytrees(trees):
    """Concatenate identically structured models along the batch axis."""
    leaves = [tree_leaves(t) for t in trees]
    return tree_replace(trees[0], [torch.cat(ls, dim=0) for ls in zip(*leaves)])


def index_pytree(tree, i):
    """Model `i` of a stacked tree, keeping a batch axis of 1."""
    return tree_map(lambda x: x[i:i + 1], tree)


def freeze_leaves(template, **replacements):
    """Frozen-mask tree: False everywhere, with named dataclass fields
    replaced by all-True subtrees, e.g. `freeze_leaves(model,
    likelihood=True)` pins the likelihood variance."""
    mask = tree_map(lambda _: False, template)
    updates = {name: tree_map(lambda _: bool(val), getattr(template, name))
               for name, val in replacements.items()}
    return dataclasses.replace(mask, **updates)
