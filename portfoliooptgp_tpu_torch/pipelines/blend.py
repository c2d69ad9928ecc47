"""Multi-timescale prediction blending (GPR/predictor.py + GPR/optimizer.py).

Port of portfoliooptgp_tpu/pipelines/blend.py, with the reference's
semantics kept exactly:

- weekly/monthly posterior means AND variances are linearly interpolated
  onto the daily day-index grid (pandas reindex + interpolate, on the host);
- the blend is convex with weights (α, β, 1−α−β) applied to means and
  variances alike;
- (α, β) minimize MSE + λ(|α|+|β|) over the simplex, solved by L-BFGS on
  the logits of a 3-way softmax (the third logit is the slack 1−α−β).

Predictions come back as (M, 1) tensors on the data's device, as the JAX
package returns (M, 1) arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import pandas as pd
import torch

from portfoliooptgp_tpu_torch.models import gpr as gpr_mod
from portfoliooptgp_tpu_torch.train import lbfgs


def predict_single(model, X, Y, Xnew):
    """(f_mean, f_var, y_mean, y_var) of a model with batch axis 1, each
    (M, 1), like Predictor.predict_single (GPR/predictor.py:5-8), with one
    shared posterior."""
    with torch.no_grad():
        cache = gpr_mod.posterior(model, X, Y)
        f_mean, f_var = gpr_mod.predict_f(model, X, Y, Xnew, cache=cache)
        y_mean, y_var = gpr_mod.predict_y(model, X, Y, Xnew, cache=cache)
    return f_mean[0], f_var[0], y_mean[0], y_var[0]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=float).reshape(-1)


def upsample_predictions(x_daily, x_coarse, values, period="w"):
    """Linear interpolation of coarse-timescale values onto the daily grid
    (GPR/predictor.py:35-51); `period='d'` passes through unchanged. The
    result lies on `values`' device and dtype when it is a tensor."""
    ref = values if isinstance(values, torch.Tensor) else torch.as_tensor(
        np.asarray(values, dtype=float))
    if period == "d":
        return ref
    s = pd.Series(_host(values), index=_host(x_coarse)).reindex(_host(x_daily))
    s = s.interpolate(method="linear").ffill().bfill()
    return torch.tensor(s.to_numpy().reshape(-1, 1), dtype=ref.dtype, device=ref.device)


class BlendWeights(NamedTuple):
    alpha: float
    beta: float


def blend(alpha, beta, daily, weekly_upsampled, monthly_upsampled):
    return alpha * daily + beta * weekly_upsampled + (1.0 - alpha - beta) * monthly_upsampled


def optimize_blend_weights(Y, f_daily, f_weekly_up, f_monthly_up, lambda_=0.01,
                           maxiter=300) -> BlendWeights:
    """Fit (α, β) (GPR/optimizer.py:20-27) by L-BFGS on the softmax logits."""
    Y = torch.as_tensor(Y).reshape(-1)
    d, w, m = (torch.as_tensor(v).reshape(-1).to(Y) for v in (f_daily, f_weekly_up, f_monthly_up))

    def loss(z):
        abc = torch.softmax(z, dim=0)
        alpha, beta = abc[0], abc[1]
        mse = torch.mean((Y - blend(alpha, beta, d, w, m)) ** 2)
        return mse + lambda_ * (torch.abs(alpha) + torch.abs(beta))

    z0 = torch.log(torch.tensor([0.33, 0.33, 0.34], dtype=Y.dtype, device=Y.device))
    res = lbfgs.fit(loss, z0, maxiter=maxiter)
    abc = torch.softmax(res.params, dim=0)
    return BlendWeights(alpha=float(abc[0]), beta=float(abc[1]))


def predict_combined(alpha, beta, daily_model, weekly_model, monthly_model,
                     data_daily, data_weekly, data_monthly,
                     X_daily, X_weekly, X_monthly):
    """Predictor.predict_combined (GPR/predictor.py:10-33): predict per
    timescale, upsample weekly/monthly means and variances (f and y), blend
    convexly. `data_*` are the (X_train, Y_train) pairs per timescale.
    Returns (f_mean, f_var, y_mean, y_var), each (M, 1)."""
    out = {}
    for tag, model, (Xt, Yt), Xn in (
        ("d", daily_model, data_daily, X_daily),
        ("w", weekly_model, data_weekly, X_weekly),
        ("m", monthly_model, data_monthly, X_monthly),
    ):
        out[tag] = predict_single(model, Xt, Yt, Xn)
    coarse = {"w": X_weekly, "m": X_monthly}
    up = {tag: tuple(upsample_predictions(X_daily, coarse[tag], v, period=tag)
                     for v in out[tag]) for tag in ("w", "m")}
    return tuple(blend(alpha, beta, out["d"][i], up["w"][i], up["m"][i]) for i in range(4))
