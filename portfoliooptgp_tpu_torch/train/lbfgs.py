"""L-BFGS with a zoom line search, and helpers over stacked model trees.

Port of portfoliooptgp_tpu/train/lbfgs.py. The JAX `fit` is optax's
`lbfgs` (the L-BFGS direction of `scale_by_lbfgs`, negated, then
`scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')`) inside a `lax.while_loop` with the
scipy-like gtol / ftol / maxiter stopping rules. This module ports those
pieces rule for rule (optax/_src/transform.py `scale_by_lbfgs`,
optax/_src/linesearch.py `zoom_linesearch`) as Python loops: parameters
and gradients stay on their device; the line search's scalar bookkeeping
runs on the host in float64. `torch.optim.LBFGS` stops by other rules, so
it is not used.

`fit` takes one parameter tensor (the portfolio solver's, the blend
fit's) or a model tree (the trainers'): a tree's leaves are flattened into
one vector in `tree_leaves` order, and a frozen tree (`freeze_leaves`)
becomes a mask over it. Frozen coordinates are masked out of every
gradient, so the L-BFGS direction is exactly zero on them.
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


def _value_and_grad(loss_fn, x):
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        value = loss_fn(xr)
        (grad,) = torch.autograd.grad(value, xr)
    return float(value.detach()), grad


def _dot(a, b) -> float:
    return float(torch.sum(a * b))


# -- optax.scale_by_zoom_linesearch, ported --------------------------------

_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5
_INCREASE_FACTOR = 2.0
_MAX_LINESEARCH_STEPS = 20
_TOL = 0.0


def _nan_to_inf(x):
    return np.inf if np.isnan(x) else x


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    dec = value_step - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * _SLOPE_RTOL - 1.0) * slope_init
    delta_values = value_step - value_init - _APPROX_DEC_RTOL * abs(value_init)
    approx = np.maximum(approx, delta_values)
    dec = np.minimum(approx, dec)
    return _nan_to_inf(np.maximum(dec, 0.0))


def _curvature_error(slope_step, slope_init):
    return _nan_to_inf(np.maximum(abs(slope_step) - _CURV_RTOL * abs(slope_init), 0.0))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    with np.errstate(all="ignore"):
        C = fpa
        db = b - a
        dc = c - a
        denom = (db * dc) ** 2 * (db - dc)
        d1 = np.array([[dc ** 2, -(db ** 2)], [-(dc ** 3), db ** 3]])
        A, B = d1 @ np.array([fb - fa - C * db, fc - fa - C * dc]) / denom
        radical = B * B - 3.0 * A * C
        return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    with np.errstate(all="ignore"):
        D = fa
        C = fpa
        db = b - a
        B = (fb - D - C * db) / (db ** 2)
        return a - C / (2.0 * B)


@dataclasses.dataclass
class _LS:
    count: int
    stepsize: float
    value: float
    grad: torch.Tensor
    slope: float
    decrease_error: float = np.inf
    curvature_error: float = np.inf
    interval_found: bool = False
    done: bool = False
    failed: bool = False
    low: float = 0.0
    value_low: float = 0.0
    slope_low: float = 0.0
    high: float = 0.0
    value_high: float = 0.0
    slope_high: float = 0.0
    cubic_ref: float = 0.0
    value_cubic_ref: float = 0.0
    safe_stepsize: float = 0.0
    safe_value: float = 0.0
    safe_grad: torch.Tensor = None


def zoom_linesearch(loss_fn, x, d, value, grad):
    """Stepsize along `d` from `x` satisfying sufficient decrease and small
    curvature (Nocedal & Wright algorithms 3.5/3.6 as optax implements
    them, initial guess 1). Returns (stepsize, value, grad) at the step."""
    value_init = value
    slope_init = _dot(d, grad)
    s = _LS(count=0, stepsize=0.0, value=value, grad=grad, slope=slope_init,
            value_low=value, slope_low=slope_init, value_high=value,
            slope_high=slope_init, value_cubic_ref=value, safe_value=value,
            safe_grad=grad)

    def on_line(stepsize):
        v, g = _value_and_grad(loss_fn, x + stepsize * d)
        return v, g, _dot(g, d)

    while not (s.done or s.failed):
        it = s.count
        if not s.interval_found:
            # _search_interval
            prev_step, prev_value, prev_slope = s.stepsize, s.value, s.slope
            new_step = 1.0 if it == 0 else _INCREASE_FACTOR * prev_step
            v, g, sl = on_line(new_step)
            dec = _decrease_error(new_step, v, sl, value_init, slope_init)
            curv = _curvature_error(sl, slope_init)
            err = max(dec, curv)
            if dec <= _TOL:
                s.safe_stepsize, s.safe_value, s.safe_grad = new_step, v, g
            set_high = (dec > 0.0) or ((v >= prev_value) and it > 0)
            set_low = (sl >= 0.0) and not set_high
            if set_low:
                lo = (new_step, v, sl)
                hi = (prev_step, prev_value, prev_slope)
            else:
                lo = (prev_step, prev_value, prev_slope)
                hi = (new_step, v, sl)
            s.low, s.value_low, s.slope_low = lo
            s.high, s.value_high, s.slope_high = hi
            s.cubic_ref, s.value_cubic_ref = s.low, s.value_low
            s.interval_found = set_high or set_low or err <= _TOL
            s.done = err <= _TOL
            s.failed = (it + 1 >= _MAX_LINESEARCH_STEPS) and not s.done
        else:
            # _zoom_into_interval
            low, high = s.low, s.high
            delta = abs(high - low)
            left, right = min(high, low), max(high, low)
            too_small = delta <= _INTERVAL_THRESHOLD
            mc = _cubicmin(low, s.value_low, s.slope_low, high, s.value_high,
                           s.cubic_ref, s.value_cubic_ref)
            use_cubic = (mc > left + 0.2 * delta) and (mc < right - 0.2 * delta)
            mq = _quadmin(low, s.value_low, s.slope_low, high, s.value_high)
            use_quad = (not use_cubic) and (mq > left + 0.1 * delta) and (
                mq < right - 0.1 * delta)
            if use_cubic:
                new_step = float(mc)
            elif use_quad:
                new_step = float(mq)
            else:
                new_step = (low + high) / 2.0
            v, g, sl = on_line(new_step)
            dec = _decrease_error(new_step, v, sl, value_init, slope_init)
            curv = _curvature_error(sl, slope_init)
            err = max(dec, curv)
            if dec <= _TOL and v < s.safe_value:
                s.safe_stepsize, s.safe_value, s.safe_grad = new_step, v, g
            s.done = err <= _TOL
            set_high_mid = (dec > 0.0) or (v >= s.value_low)
            set_high_low = (sl * (high - low) >= 0.0) and not set_high_mid
            old = (low, s.value_low, s.slope_low, high, s.value_high, s.slope_high)
            if set_high_mid:
                s.high, s.value_high, s.slope_high = new_step, v, sl
            if set_high_low:
                s.high, s.value_high, s.slope_high = old[0], old[1], old[2]
            if not set_high_mid:
                s.low, s.value_low, s.slope_low = new_step, v, sl
            if set_high_mid or set_high_low:
                s.cubic_ref, s.value_cubic_ref = old[3], old[4]
            else:
                s.cubic_ref, s.value_cubic_ref = old[0], old[1]
            presumably_failed = (it + 1 >= _MAX_LINESEARCH_STEPS) or (
                too_small and s.safe_stepsize > 0.0)
            s.failed = presumably_failed and not s.done
        s.count = it + 1
        s.stepsize, s.value, s.grad, s.slope = new_step, v, g, sl
        s.decrease_error, s.curvature_error = dec, curv
        if s.failed:
            # _try_safe_step
            if s.safe_stepsize > 0.0 or np.isinf(s.decrease_error):
                s.stepsize, s.value, s.grad = s.safe_stepsize, s.safe_value, s.safe_grad
    return s.stepsize, s.value, s.grad


# -- optax.scale_by_lbfgs, ported ------------------------------------------

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
    shape or a tree of booleans."""
    x, unflatten, mask = _flatten(params, frozen)

    def masked(g):
        g = g.reshape(-1)
        return torch.where(mask, torch.zeros_like(g), g) if mask is not None else g

    def flat_loss(z):
        return loss_fn(unflatten(z))
    n = x.numel()
    opts = dict(dtype=x.dtype, device=x.device)
    value, grad = _value_and_grad(flat_loss, x)
    grad = masked(grad)
    prev_value = np.inf
    it = 0
    # scale_by_lbfgs state
    count = 0
    last_params = torch.zeros_like(x)
    last_updates = torch.zeros_like(x)
    dW = torch.zeros((memory_size, n), **opts)
    dU = torch.zeros((memory_size, n), **opts)
    rhos = torch.zeros((memory_size,), **opts)

    def gnorm(g):
        return float(torch.linalg.norm(g))

    while (it < maxiter and gnorm(grad) > gtol
           and abs(prev_value - value) > ftol * max(1.0, abs(value))):
        # 1. memory update from the fresh params and gradients
        mem_idx = count % memory_size
        prev_idx = (count - 1) % memory_size
        if count > 0:
            dp = x - last_params
            du = grad - last_updates
            vd = _dot(du, dp)
            dW[prev_idx] = dp
            dU[prev_idx] = du
            rhos[prev_idx] = 0.0 if vd == 0.0 else 1.0 / vd
            den = _dot(du, du)
            scale = vd / den if den > 0.0 else 1.0
        else:
            dW[prev_idx] = 0.0
            dU[prev_idx] = 0.0
            rhos[prev_idx] = 0.0
            scale = min(1.0, 1.0 / gnorm(grad))
        # 2. two-loop product with the inverse-Hessian approximation
        indices = [(mem_idx + i) % memory_size for i in range(memory_size)]
        vec = grad
        alphas = {}
        for idx in reversed(indices):
            alphas[idx] = rhos[idx] * torch.sum(dW[idx] * vec)
            vec = vec - alphas[idx] * dU[idx]
        vec = vec * scale
        for idx in indices:
            beta = rhos[idx] * torch.sum(dU[idx] * vec)
            vec = vec + (alphas[idx] - beta) * dW[idx]
        last_params, last_updates = x, grad
        count += 1
        # 3. negate, then the line search scales the direction
        direction = -vec
        stepsize, new_value, new_grad = zoom_linesearch(flat_loss, x, direction,
                                                        value, grad)
        x = x + stepsize * direction
        prev_value, value, grad = value, new_value, masked(new_grad)
        it += 1

    gn = gnorm(grad)
    return FitResult(
        params=unflatten(x), loss=value, grad_norm=gn, iters=it,
        converged=bool(gn <= gtol or abs(prev_value - value)
                       <= ftol * max(1.0, abs(value))))


class BatchedFitResult(NamedTuple):
    params: object  # a stacked model tree (batch B)
    loss: torch.Tensor  # (B,)
    grad_norm: torch.Tensor  # (B,)
    iters: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,)


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
