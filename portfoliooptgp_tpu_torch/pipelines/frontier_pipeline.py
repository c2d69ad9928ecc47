"""Config-5 workflow: an n-asset multi-output GP posterior → efficient frontier.

Port of portfoliooptgp_tpu/pipelines/frontier_pipeline.py:

1. load every asset's return series on the shared trading-day grid;
2. fit one ICM multi-output GP by L-BFGS on
   `icm.neg_log_marginal_likelihood_chol` (the P outputs as P shifted GPR
   problems: the fused stationary kernel at padded N ≤ 512, the
   `blocked_hinv` tier with the triangular-inverse kernel at
   1024 < padded N ≤ 4096);
3. optionally (`use_nuts=True`) NUTS over the ICM hyperposterior, chains
   in lockstep, every evaluation one batch of C·P shifted problems
   (`icm.batched_neg_log_marginal_likelihood_chol`), and the predictive
   moments averaged over the thinned draws (Bayesian model averaging);
4. the posterior (μ, Σ) of next-period returns → the long-only efficient
   frontier and the tangency portfolio.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from portfoliooptgp_tpu_torch import kernels as km
from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, as_tensor
from portfoliooptgp_tpu_torch.models import icm
from portfoliooptgp_tpu_torch.params import ravel, tree_map, tree_to
from portfoliooptgp_tpu_torch.portfolio.frontier import Frontier, efficient_frontier
from portfoliooptgp_tpu_torch.train import lbfgs


@dataclass
class FrontierResult:
    assets: list
    mu: np.ndarray
    Sigma: np.ndarray
    frontier: Frontier
    model: object
    nuts_draws: Optional[int] = None
    fit: Optional[lbfgs.FitResult] = None  # the ICM fit: final NLL, iterations


def frontier_inputs(assets: Sequence[str], data_handler, *, predict_y: str = "return",
                    horizon_rows: int = 1, device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
    """(Xs (N, 1), Y (N, P), Xnew (1, 1)): the day index scaled to zero mean
    and unit population std, every asset's returns on the shared grid, and
    the horizon input `horizon_rows` steps past the end of the grid."""
    columns, X_ref = [], None
    for asset in assets:
        X, Y, *_ = data_handler.process_data(
            "Stocks", asset, "d", predict_Y=predict_y, normalize=False, normalize_x=False)
        if X_ref is None:
            X_ref = X
        elif X.shape != X_ref.shape:
            raise ValueError(f"{asset} is not on the shared trading grid "
                             f"({X.shape[0]} vs {X_ref.shape[0]} rows)")
        columns.append(as_tensor(Y, device, dtype).reshape(-1))
    X_ref = as_tensor(X_ref, device, dtype)
    # scale the day index for a well-conditioned kernel (ddof 0, as np.std)
    Xs = (X_ref - X_ref.mean()) / (X_ref.std(correction=0) + 1e-12)
    step = float(Xs[-1, 0] - Xs[-2, 0]) if Xs.shape[0] > 1 else 1.0
    return Xs, torch.stack(columns, dim=1), Xs[-1:] + step * horizon_rows


def frontier_logdensity(stacked, X, Y):
    """(C,) log-densities of C stacked ICM models, the frontier's NUTS
    target: −`icm.batched_neg_log_marginal_likelihood_chol` under a
    standard-normal prior on the raw parameters, −½‖z‖² of each model's
    flat raw vector (`params.ravel` order)."""
    flat = ravel(stacked)
    return (-icm.batched_neg_log_marginal_likelihood_chol(stacked, X, Y)
            - 0.5 * torch.sum(flat ** 2, dim=-1))


def run_frontier_pipeline(
    assets: Sequence[str],
    data_handler,
    *,
    predict_y: str = "return",
    rank: int = 2,
    noise_variance: float = 1e-2,
    maxiter: int = 300,
    horizon_rows: int = 1,
    use_nuts: bool = False,
    nuts_warmup: int = 200,
    nuts_samples: int = 200,
    nuts_chains: int = 2,
    nuts_max_depth: int = 8,
    risk_free_rate: float = 0.01 / 252,
    seed: int = 0,
    model0: Optional[icm.ICMGPR] = None,
    nuts_source=None,
    device=DEFAULT_DEVICE,
    dtype=DEFAULT_DTYPE,
) -> FrontierResult:
    """The JAX package's `run_frontier_pipeline` on (device, dtype). The fit
    starts from `model0` when given (moved to device and dtype), else from
    `ICMGPR.create(SquaredExponential, ...)` with W drawn from a
    `torch.Generator` seeded by `seed`. With `use_nuts`, NUTS draws from
    `nuts_source` (a random source of inference/source.py) or, by default,
    a `torch.Generator` on the device seeded by `seed`."""
    # 1. shared-grid multi-output target matrix
    Xs, Ymat, Xnew = frontier_inputs(assets, data_handler, predict_y=predict_y,
                                     horizon_rows=horizon_rows, device=device, dtype=dtype)
    p = len(assets)

    # 2. MLE fit of the ICM model
    if model0 is None:
        model0 = icm.ICMGPR.create(
            km.SquaredExponential.create(device=device, dtype=dtype), num_outputs=p,
            rank=rank, noise_variance=noise_variance,
            generator=torch.Generator().manual_seed(seed))
    else:
        model0 = tree_to(model0, Xs.device, dtype)
    res = lbfgs.fit(lambda m: icm.neg_log_marginal_likelihood_chol(m, Xs, Ymat), model0,
                    maxiter=maxiter)
    model = res.params

    draws = None
    if use_nuts:
        # 3. Bayesian averaging of the predictive moments over the hyperposterior
        from portfoliooptgp_tpu_torch.inference import sample_nuts

        def logdensity(m):
            return frontier_logdensity(m, Xs, Ymat)

        source = (nuts_source if nuts_source is not None
                  else torch.Generator(device=Xs.device).manual_seed(seed))
        samples, _ = sample_nuts(logdensity, model, source, num_warmup=nuts_warmup,
                                 num_samples=nuts_samples, num_chains=nuts_chains,
                                 max_depth=nuts_max_depth, device=Xs.device)
        flat_samples = tree_map(lambda x: x.reshape((-1,) + x.shape[2:]), samples)
        draws = nuts_chains * nuts_samples
        thin = max(draws // 64, 1)
        with torch.no_grad():
            moments = [icm.posterior_asset_moments_chol(lbfgs.index_pytree(flat_samples, i), Xs,
                                                        Ymat, Xnew)
                       for i in range(0, draws, thin)]
        mus = torch.stack([m for m, _ in moments])
        mu = torch.mean(mus, dim=0)
        # law of total (co)variance: E[Σ] + Cov[μ]
        mu_dev = mus - mu
        Sigma = (torch.mean(torch.stack([S for _, S in moments]), dim=0)
                 + mu_dev.T @ mu_dev / mus.shape[0])
    else:
        with torch.no_grad():
            mu, Sigma = icm.posterior_asset_moments_chol(model, Xs, Ymat, Xnew)

    # 4. frontier
    mu, Sigma = mu.cpu().numpy(), Sigma.cpu().numpy()
    frontier = efficient_frontier(mu, Sigma, risk_free_rate=risk_free_rate, device=device,
                                  dtype=dtype)
    return FrontierResult(assets=list(assets), mu=mu, Sigma=Sigma, frontier=frontier,
                          model=model, nuts_draws=draws, fit=res)
