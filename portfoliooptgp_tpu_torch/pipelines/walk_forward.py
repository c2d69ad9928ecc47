"""Batched walk-forward retraining — pad-and-mask over growing prefixes.

Port of portfoliooptgp_tpu/pipelines/walk_forward.py. Every test day is a
row of one batched training problem over the full design matrix:

    K_day = M K Mᵀ + (I − M),   y_day = M y   (M = the day's prefix mask)

so the whole walk-forward trains as one batched L-BFGS
(train/batched_lbfgs.py) and predicts all next-day targets in one batched
solve. In float32 the loss is the masked fused NLL kernel
(ops/stationary_nll.py) for a fusable kernel at padded N ≤ 512; else the
masked system goes through the dense NLL kernel (ops/nll.py) at padded
N ≤ 256, the blocked tier's panel kernel (ops/blocked_nll.py) at padded
N ≤ 1024, or the hinv tier's triangular-inverse kernel up to padded
N = 4096 (and D·R·N² ≤ HINV_MAX_ELEMS). In float64, and past those
windows, it is the plain masked NLL, as in the JAX package.

With a mesh the D·R day×restart rows are split over one of its axes
(`mesh_axis`, "restart" by default): each rank trains its rows with the
same batched L-BFGS (rows are independent problems, so a row's result does
not depend on which rows share its batch), and one all-gather returns every
row, day-major, to every rank before the best restart per day is picked.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, as_tensor, resolve_device
from portfoliooptgp_tpu_torch.models import gpr as gpr_mod
from portfoliooptgp_tpu_torch.models.gpr import GPR
from portfoliooptgp_tpu_torch.ops import linalg
from portfoliooptgp_tpu_torch.params import batch_size, ravel, tree_map, tree_to, unravel
from portfoliooptgp_tpu_torch.parallel import mesh as mesh_mod
from portfoliooptgp_tpu_torch.train import batched_lbfgs, lbfgs

LOG_2PI = math.log(2.0 * math.pi)


def mean_rows(model: GPR, X, B: int):
    """μ(X) as (B, N) for B models: `Zero` returns (N, 1), shared by the
    batch; the other means return (B, N, 1), a row per model."""
    return model.mean_function(X)[..., 0].expand(B, X.shape[0])


def masked_system(model: GPR, X, Y, mask):
    """(Ks (B,N,N), err (B,N,1)) for B models and their masks (B, N):
    rows/cols outside the prefix become identity with zero targets."""
    K = model.kernel.K(X)
    m = mask[:, :, None]
    Km = K * (m * mask[:, None, :])
    Ks = Km + torch.diag_embed(mask * model.likelihood.variance[:, None] + (1.0 - mask))
    err = (Y - model.mean_function(X)) * m
    return Ks, err


def masked_nll(model: GPR, X, Y, mask):
    """(B,) NLLs over the rows where mask==1, at full static shape."""
    Ks, err = masked_system(model, X, Y, mask)
    L = linalg.cholesky(Ks)
    quad = linalg.mahalanobis_from_chol(L, err)
    logdet = linalg.logdet_from_chol(L)
    n_eff = torch.sum(mask, dim=-1)
    return 0.5 * quad + 0.5 * logdet + 0.5 * n_eff * LOG_2PI


def masked_predict_next(model: GPR, X, Y, mask, next_index):
    """Posterior mean/var (B,) at row next_index[b] given each masked prefix."""
    K = model.kernel.K(X)
    B = K.shape[0]
    rows = torch.arange(B, device=X.device)
    Ks = K * (mask[:, :, None] * mask[:, None, :]) + torch.diag_embed(
        mask * model.likelihood.variance[:, None] + (1.0 - mask))
    err = (Y - model.mean_function(X)) * mask[:, :, None]
    L = linalg.cholesky(Ks)
    kstar = (K[rows, :, next_index] * mask)[:, :, None]  # (B, N, 1)
    A = linalg.solve_lower(L, kstar)
    alpha = linalg.chol_solve(L, err)
    mean = (torch.sum(kstar[:, :, 0] * alpha[:, :, 0], dim=-1)
            + mean_rows(model, X, B)[rows, next_index])
    var = K[rows, next_index, next_index] - torch.sum(A * A, dim=(-2, -1))
    return mean, torch.clamp_min(var, 0.0)


class WalkForwardResult(NamedTuple):
    models: GPR  # stacked, one per day
    losses: torch.Tensor  # (D,)
    f_mean: torch.Tensor  # (D,) next-day posterior means
    f_var: torch.Tensor  # (D,) next-day posterior variances


def batched_walk_forward(
    X_full,
    Y_full,
    n_train: int,
    make_model,
    *,
    n_days: Optional[int] = None,
    restart_noise_inits: Sequence[float] = (1e-3,),
    maxiter: int = 200,
    train_likelihood_variance: bool = True,
    warm_start: bool = False,
    warm_maxiter: Optional[int] = None,
    mesh=None,
    mesh_axis: str = "restart",
    device=DEFAULT_DEVICE,
    dtype=DEFAULT_DTYPE,
    **fit_kw,
) -> WalkForwardResult:
    """Train all walk-forward days at once.

    make_model(noise_variance) -> fresh GPR (batch 1) on (device, dtype).
    Day d trains on rows [: n_train + d] and predicts row n_train + d.
    With R restart noise inits the batch is D×R rows (day-major) and the
    best restart per day is picked by final loss.

    warm_start=True first trains day 0's R restarts to convergence on its
    prefix, then starts every day's row from the matching day-0 optimum and
    polishes the whole D×R batch for `warm_maxiter` iterations (default
    max(maxiter // 4, 10)).

    mesh (parallel/mesh.py): split the D·R rows over `mesh_axis`, whose size
    must divide D·R; the device is the mesh's."""
    dev = resolve_device(device) if mesh is None else mesh.device
    X_full = as_tensor(X_full, dev, dtype)
    Y_full = as_tensor(Y_full, dev, dtype)
    n_full = X_full.shape[0]
    if n_days is None:
        n_days = n_full - n_train
    D = n_days
    R = len(restart_noise_inits)

    row = torch.arange(n_full, device=dev)
    masks = (row[None, :] < (n_train + torch.arange(D, device=dev))[:, None]).to(dtype)
    models = [tree_to(make_model(v), dev, dtype) for v in restart_noise_inits]
    stacked_r = lbfgs.stack_pytrees(models)  # batch R
    masks_dr = torch.repeat_interleave(masks, R, dim=0)  # (D*R, n)
    frozen = (None if train_likelihood_variance
              else lbfgs.freeze_leaves(models[0], likelihood=True))

    if warm_start:
        masks_r0 = masks[:1].expand(R, n_full)
        stacked_r, _ = batched_lbfgs.fit_batched_fused(
            lambda ms: masked_nll(ms, X_full, Y_full, masks_r0), stacked_r,
            frozen=frozen, maxiter=maxiter, **fit_kw)
        maxiter = warm_maxiter if warm_maxiter is not None else max(maxiter // 4, 10)

    # tile to (D*R, ...): day-major so reshape recovers (D, R)
    stacked = tree_map(lambda x: x.repeat((D,) + (1,) * (x.ndim - 1)), stacked_r)
    if mesh is not None:
        n_shards = mesh.shape[mesh_axis]
        if (D * R) % n_shards:
            raise ValueError(f"the '{mesh_axis}' axis size {n_shards} must divide the "
                             f"walk-forward batch D*R={D * R}")
        stacked = tree_map(lambda x: mesh_mod.shard_rows(mesh, x, mesh_axis), stacked)
        masks_dr = mesh_mod.shard_rows(mesh, masks_dr, mesh_axis)

    from portfoliooptgp_tpu_torch.ops import blocked_nll as blocked_mod
    from portfoliooptgp_tpu_torch.ops import nll as nll_mod
    from portfoliooptgp_tpu_torch.ops import stationary_nll as st_mod

    f32 = dtype == torch.float32
    use_fused = f32 and st_mod.fused_nll_supported(n_full)
    n_eff_dr = torch.sum(masks_dr, dim=1)
    spec_probe = gpr_mod.fused_stationary_spec(stacked, X_full) if use_fused else None

    if spec_probe is not None:
        # fused masked path: K is built inside the kernel from the shared
        # per-atom distance matrices and each day's prefix mask
        def batched_loss(ms):
            spec = gpr_mod.fused_stationary_spec(ms, X_full)
            err = (Y_full[None, :, 0] - mean_rows(ms, X_full, masks_dr.shape[0])) * masks_dr
            fused = (st_mod.batched_nll_stationary_sum if spec.combine == "sum"
                     else st_mod.batched_nll_stationary_general)
            nll = fused(spec.families, spec.d2s, err, spec.vs, spec.ls, spec.als,
                        ms.likelihood.variance, masks_dr, dims=spec.dims)
            # the kernel's 2π constant uses the full N; restate it for n_eff
            return nll - 0.5 * (n_full - n_eff_dr) * LOG_2PI
    elif f32 and nll_mod.pallas_nll_supported(n_full):
        # the dense kernel on the masked system, which carries its own
        # diagonal (mask·σ² + 1 − mask): zero added noise
        def batched_loss(ms):
            Kb, errb = masked_system(ms, X_full, Y_full, masks_dr)
            nll = nll_mod.batched_nll(Kb, errb[:, :, 0],
                                      torch.zeros_like(n_eff_dr))
            # the kernel's 2π constant uses the full N; restate it for n_eff
            return nll - 0.5 * (n_full - n_eff_dr) * LOG_2PI
    elif f32 and (blocked_mod.blocked_nll_preferred(n_full)
                  or blocked_mod.hinv_nll_preferred(n_full, D * R)):
        # large-N masked rows through the blocked tiers (the panel kernel,
        # or the hinv tier's triangular-inverse kernel), at zero added noise
        # as above; the same tier windows as the router
        tier_fn = (blocked_mod.batched_nll_blocked
                   if blocked_mod.blocked_nll_preferred(n_full)
                   else blocked_mod.batched_nll_hinv)  # gated on D·R above

        def batched_loss(ms):
            Kb, errb = masked_system(ms, X_full, Y_full, masks_dr)
            nll = tier_fn(Kb, errb[:, :, 0], torch.zeros_like(n_eff_dr))
            return nll - 0.5 * (n_full - n_eff_dr) * LOG_2PI
    else:
        def batched_loss(ms):
            return masked_nll(ms, X_full, Y_full, masks_dr)

    trained, res = batched_lbfgs.fit_batched_fused(
        batched_loss, stacked, frozen=frozen, maxiter=maxiter, **fit_kw)
    loss = res.loss
    if mesh is not None:
        trained = unravel(trained, mesh_mod.all_gather(ravel(trained), mesh, mesh_axis))
        loss = mesh_mod.all_gather(loss, mesh, mesh_axis)

    losses = torch.where(torch.isfinite(loss), loss,
                         torch.full_like(loss, float("inf"))).reshape(D, R)
    best_r = torch.argmin(losses, dim=1)
    flat_idx = torch.arange(D, device=dev) * R + best_r
    best_models = tree_map(lambda x: x[flat_idx].detach(), trained)
    assert batch_size(best_models) == D

    next_idx = n_train + torch.arange(D, device=dev)
    with torch.no_grad():
        f_mean, f_var = masked_predict_next(best_models, X_full, Y_full, masks, next_idx)
    return WalkForwardResult(models=best_models, losses=torch.min(losses, dim=1).values,
                             f_mean=f_mean, f_var=f_var)
