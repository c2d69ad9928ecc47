"""Plain GP reference of the benchmark's cells, in PyTorch.

It imports nothing of the program: it gets the inputs the benchmark made and
the raw (unconstrained) parameters the program returned, and works out the
rest itself: the constrained hyperparameters (softplus plus the 1e-6 floor),
the kernel matrices, the masked prefix systems (a day's system is the
exact GP on its prefix rows), the flat parameter order of the NUTS cell,
its prior, and every gradient by autograd.

`F64` is the reference. `TF32` is the control of a float32 configuration:
the same arithmetic in float32 with the operands of every matrix product,
forward and backward, rounded to TF32's 10-bit mantissa, as tensor cores
do with TF32 on. Factorisations and triangular solves stay in float32,
as cuSOLVER runs them with TF32 on. The rounding is explicit, so the
control reads the same on the CPU as on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

LOG_2PI = math.log(2.0 * math.pi)
SHIFT = 1e-6  # the lower floor of every positive hyperparameter


def tf32_round(x):
    """x (float32) rounded to the nearest TF32 value, ties to even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (0x0FFF + ((bits >> 13) & 1))) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).transpose(-1, -2), tf32_round(a).transpose(-1, -2) @ g


class Precision(NamedTuple):
    name: str
    dtype: torch.dtype
    tf32: bool

    def mm(self, a, b):
        return _TF32MatMul.apply(a, b) if self.tf32 else a @ b


F64 = Precision("float64", torch.float64, False)
TF32 = Precision("tf32", torch.float32, True)


def worst_of(x, nan: float = float("inf")) -> float:
    """The largest |x|, with any NaN read as `nan`: +inf by default, so that
    no comparison passes on a value that is not a number (a system that did
    not factor is not a number); 0 reads the finite part alone."""
    x = torch.abs(torch.as_tensor(x, dtype=torch.float64))
    return float(torch.max(torch.nan_to_num(x, nan=nan)))


def _cholesky(K):
    """The lower factor of each K, NaN where K does not factor."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))


def positive(raw):
    return torch.nn.functional.softplus(raw) + SHIFT


def positive_inv(value):
    v = torch.as_tensor(value, dtype=torch.float64) - SHIFT
    return v + torch.log(-torch.expm1(-v))


def sq_dist(X, prec: Precision):
    """Pairwise squared distances of the rows of X (..., N, D) by the
    ‖x‖² + ‖x'‖² − 2⟨x, x'⟩ expansion, clamped at zero."""
    xx = torch.sum(X * X, dim=-1)
    r2 = xx[..., :, None] + xx[..., None, :] - 2.0 * prec.mm(X, X.transpose(-1, -2))
    return torch.clamp_min(r2, 0.0)


def gauss_nll(K, y, prec: Precision):
    """(B,) −log N(y | 0, K) for K (B, n, n) and y (n,) or (B, n)."""
    L = _cholesky(K)
    yb = y.expand(K.shape[0], K.shape[-1])[..., None]
    a = torch.linalg.solve_triangular(L, yb, upper=False)
    n = K.shape[-1]
    logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return 0.5 * torch.sum(a * a, dim=(-2, -1)) + logdet + 0.5 * n * LOG_2PI


# -- the multi-input walk-forward: Exponential(covariates) × Exponential(time)
WF_LEAVES = ("k1.variance", "k1.lengthscale", "k2.variance", "k2.lengthscale", "noise")


def wf_kernel(d_cov, d_time, theta):
    """K (B, n, n) without noise from the unit distances of the covariate
    and time columns (n, n) and theta (B, 5) in WF_LEAVES order."""
    v1, l1, v2, l2 = (theta[:, i, None, None] for i in range(4))
    return v1 * torch.exp(-d_cov / l1) * v2 * torch.exp(-d_time / l2)


def wf_distances(X, prec: Precision):
    """Unit (not length-scaled) Euclidean distances of the covariate
    columns X[:, :-1] and of the time column X[:, -1:]."""
    X = X.to(prec.dtype)
    return (torch.sqrt(sq_dist(X[:, :-1], prec)), torch.sqrt(sq_dist(X[:, -1:], prec)))


def wf_nll_and_grad(X, y, raw, n, prec: Precision):
    """NLL (B,) of the GP on the first n rows and its gradient (B, 5) with
    respect to the raw parameters raw (B, 5)."""
    d_cov, d_time = wf_distances(X[:n], prec)
    y = y[:n].to(prec.dtype)
    with torch.enable_grad():
        z = raw.to(prec.dtype).detach().requires_grad_(True)
        theta = positive(z)
        K = wf_kernel(d_cov, d_time, theta)
        K = K + theta[:, 4, None, None] * torch.eye(n, dtype=K.dtype, device=K.device)
        nll = gauss_nll(K, y, prec)
        (g,) = torch.autograd.grad(nll.sum(), z)
    return nll.detach(), g


def wf_predict(X, y, raw, n, prec: Precision):
    """Posterior mean, variance and prior variance (B,) of f at row n given
    rows [:n], for raw (B, 5)."""
    d_cov, d_time = wf_distances(X[:n + 1], prec)
    theta = positive(raw.to(prec.dtype))
    K = wf_kernel(d_cov, d_time, theta)
    Kn = K[:, :n, :n] + theta[:, 4, None, None] * torch.eye(n, dtype=K.dtype, device=K.device)
    kstar = K[:, :n, n:n + 1]
    L = _cholesky(Kn)
    alpha = torch.cholesky_solve(y[:n].to(prec.dtype).expand(K.shape[0], n)[..., None], L)
    mean = prec.mm(kstar.transpose(-1, -2), alpha)[:, 0, 0]
    A = torch.linalg.solve_triangular(L, kstar, upper=False)
    prior = K[:, n, n]
    return mean, prior - torch.sum(A * A, dim=(-2, -1)), prior


# -- the NUTS posterior: GPR with ARD SE, flat raw parameters
#    [variance, lengthscale_1 .. lengthscale_D, noise] and N(z0, 2²) prior
def nuts_logp_and_grad(X, Y, z, z0, prec: Precision, prior_scale: float = 2.0):
    """log p (M,) and its gradient (M, D + 2) at flat raw parameters z."""
    X = X.to(prec.dtype)
    y = Y[:, 0].to(prec.dtype)
    D = X.shape[1]
    d2s = torch.stack([sq_dist(X[:, d:d + 1], prec) for d in range(D)])  # (D, n, n)
    n = X.shape[0]
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    with torch.enable_grad():
        zz = z.to(prec.dtype).detach().requires_grad_(True)
        theta = positive(zz)
        inv_l2 = 1.0 / theta[:, 1:D + 1] ** 2
        r2 = sum(inv_l2[:, d, None, None] * d2s[d] for d in range(D))
        K = theta[:, 0, None, None] * torch.exp(-0.5 * r2) + theta[:, D + 1, None, None] * eye
        prior = -0.5 / prior_scale ** 2 * torch.sum((zz - z0.to(zz)) ** 2, dim=-1)
        logp = -gauss_nll(K, y, prec) + prior
        (g,) = torch.autograd.grad(logp.sum(), zz)
    return logp.detach(), g
