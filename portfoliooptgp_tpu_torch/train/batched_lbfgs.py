"""Batched L-BFGS: one optimizer per batch row, one batched loss per trial.

Port of portfoliooptgp_tpu/train/batched_lbfgs.py, rule for rule: the
per-row two-loop recursion over a ring of `memory_size` pairs, the
vectorized backtracking-Armijo line search (each trial one batched loss
WITHOUT gradient, so the fused kernel runs without forming L⁻¹; rows that
accepted keep their step while the rest halve), pairs with sy ≤ 1e-10
skipped per row, steepest descent where the direction is not a descent
direction, and the same gtol/ftol/maxiter stopping rules. One gradient per
iteration comes from one backward of the summed loss (rows are
independent models). `lax.while_loop`s are Python loops.

Spans (utils/profiling.py): `lbfgs.iteration` a pass of the loop,
`lbfgs.value` a value-only evaluation (the first and each line-search
trial), `lbfgs.gradient` one with gradient, `lbfgs.sync` each host read
of whether a row is still active or has yet to accept a step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from portfoliooptgp_tpu_torch.params import tree_leaves, tree_replace
from portfoliooptgp_tpu_torch.utils.profiling import span


class BatchedFitResult(NamedTuple):
    params: torch.Tensor  # (B, D) final parameters (flat)
    loss: torch.Tensor  # (B,)
    grad_norm: torch.Tensor  # (B,)
    iters: int
    converged: torch.Tensor  # (B,)


def _rowdot(a, b):
    return torch.sum(a * b, dim=-1)


def fit_matrix(
    batched_loss: Callable,  # (B, D) -> (B,)
    Z0: torch.Tensor,
    *,
    maxiter: int = 100,
    gtol: float = 1e-8,
    ftol: float = 1e-11,
    memory_size: int = 10,
    max_backtracks: int = 25,
    armijo_c: float = 1e-4,
    frozen_mask=None,  # (D,) bool: True leaves never move
) -> BatchedFitResult:
    B, D = Z0.shape
    opts = dict(dtype=Z0.dtype, device=Z0.device)
    fm = None if frozen_mask is None else frozen_mask[None, :].to(torch.bool)

    def loss_of(Z):
        with span("lbfgs.value"), torch.no_grad():
            return batched_loss(Z)

    def grad_of(Z):
        with span("lbfgs.gradient"), torch.enable_grad():
            Zr = Z.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(torch.sum(batched_loss(Zr)), Zr)
        return torch.where(fm, torch.zeros_like(g), g) if fm is not None else g

    Z = Z0.detach()
    f = loss_of(Z)
    g = grad_of(Z)
    S = torch.zeros((memory_size, B, D), **opts)
    Y = torch.zeros((memory_size, B, D), **opts)
    rho = torch.zeros((memory_size, B), **opts)  # 0 marks an empty/skipped slot
    head = 0
    step0 = torch.ones((B,), **opts)
    active = torch.isfinite(f)
    it = 0

    def direction():
        """Two-loop recursion, vectorized over rows."""
        q = g
        alphas = torch.zeros((memory_size, B), **opts)
        for i in range(memory_size):
            idx = (head - 1 - i) % memory_size
            alpha = rho[idx] * _rowdot(S[idx], q)  # zero where slot empty
            q = q - alpha[:, None] * Y[idx]
            alphas[idx] = alpha
        newest = (head - 1) % memory_size
        sy = _rowdot(S[newest], Y[newest])
        yy = _rowdot(Y[newest], Y[newest])
        ok = (rho[newest] > 0) & (yy > 0)
        gamma = torch.where(ok, sy / torch.where(ok, yy, torch.ones_like(yy)),
                            torch.ones_like(yy))
        r = q * gamma[:, None]
        for i in range(memory_size):
            idx = (head + i) % memory_size
            beta = rho[idx] * _rowdot(Y[idx], r)
            r = r + (alphas[idx] - beta)[:, None] * S[idx]
        return -r

    def any_(mask):
        with span("lbfgs.sync"):
            return bool(mask.any())

    while it < maxiter and any_(active):
        with span("lbfgs.iteration"):
            d = direction()
            # fall back to steepest descent where the direction is not a descent
            gd = _rowdot(g, d)
            bad = (gd >= 0) | ~torch.isfinite(gd)
            d = torch.where(bad[:, None], -g, d)
            gd = torch.where(bad, -_rowdot(g, g), gd)
            d = torch.where(active[:, None], d, torch.zeros_like(d))
            gd = torch.where(active, gd, torch.zeros_like(gd))

            # vectorized backtracking-Armijo with early exit once every row has
            # accepted
            step = step0
            accepted = ~active
            f_new, Z_new = f, Z
            for _ in range(max_backtracks):
                if not any_(~accepted):
                    break
                trial = Z + step[:, None] * d
                f_t = loss_of(trial)
                ok = (f_t <= f + armijo_c * step * gd) & torch.isfinite(f_t)
                newly = ok & ~accepted
                f_new = torch.where(newly, f_t, f_new)
                Z_new = torch.where(newly[:, None], trial, Z_new)
                accepted = accepted | ok
                step = torch.where(accepted, step, step * 0.5)
            # rows whose line search failed keep their point this iteration
            moved = accepted & active

            g_new = grad_of(Z_new)
            s = Z_new - Z
            y = g_new - g
            sy = _rowdot(s, y)
            good_pair = moved & (sy > 1e-10) & torch.all(torch.isfinite(y), dim=-1)
            rho_new = torch.where(good_pair, 1.0 / torch.where(good_pair, sy, torch.ones_like(sy)),
                                  torch.zeros_like(sy))
            S[head] = torch.where(good_pair[:, None], s, torch.zeros_like(s))
            Y[head] = torch.where(good_pair[:, None], y, torch.zeros_like(y))
            rho[head] = rho_new

            gnorm = torch.linalg.norm(g_new, dim=-1)
            f_small = torch.abs(f - f_new) <= ftol * torch.clamp_min(torch.abs(f_new), 1.0)
            # a row stops when converged (gtol/ftol) or when its line search
            # cannot find any acceptable step
            active = active & moved & (gnorm > gtol) & ~f_small
            # grow the next initial step where we accepted at full step
            step0 = torch.where(moved, torch.clamp_max(step * 2.0, 1.0), step0)
            Z, f, g = Z_new, f_new, g_new
            head = (head + 1) % memory_size
            it += 1

    return BatchedFitResult(params=Z, loss=f, grad_norm=torch.linalg.norm(g, dim=-1),
                            iters=it, converged=~active)


def fit_batched_fused(batched_loss_models: Callable, stacked_models, frozen=None,
                      **kwargs):
    """Batched L-BFGS over a stacked model (leaves with a leading batch
    axis B) and a model-batched loss (e.g.
    `gpr.batched_neg_log_marginal_likelihood`). `frozen` is an optional
    tree of bools of the same structure (see `lbfgs.freeze_leaves`).
    Returns (stacked_models', BatchedFitResult)."""
    leaves = tree_leaves(stacked_models)
    B = leaves[0].shape[0]
    shapes = [leaf.shape for leaf in leaves]
    sizes = [leaf[0].numel() for leaf in leaves]
    Z0 = torch.cat([leaf.detach().reshape(B, -1) for leaf in leaves], dim=1)

    def unravel(Z):
        cols = torch.split(Z, sizes, dim=1)
        return tree_replace(stacked_models,
                            [c.reshape(s) for c, s in zip(cols, shapes)])

    frozen_mask = None
    if frozen is not None:
        flags = tree_leaves(frozen)
        frozen_mask = torch.cat([torch.full((n,), bool(fl), device=Z0.device)
                                 for n, fl in zip(sizes, flags)])

    res = fit_matrix(lambda Z: batched_loss_models(unravel(Z)), Z0,
                     frozen_mask=frozen_mask, **kwargs)
    return unravel(res.params), res
