"""The plain reference against the program's plain path, float64 on the
CPU at a tiny size, and the TF32 rounding of the control."""

import numpy as np
import torch

from gpbench import market
from gpbench.kinds import nuts as nuts_kind
from gpbench.reference import gp as ref
from portfoliooptgp_tpu_torch import kernels
from portfoliooptgp_tpu_torch.models.gpr import GPR
from portfoliooptgp_tpu_torch.params import ravel, tree_leaves, tree_replace
from portfoliooptgp_tpu_torch.pipelines import walk_forward as wf

F64 = dict(device="cpu", dtype=torch.float64)


def _wf_rows(B, seed):
    g = torch.Generator().manual_seed(seed)
    raw = torch.randn((B, 5), generator=g, dtype=torch.float64) * 0.5
    kern = kernels.composite_kernel(6, kernels.Exponential, kernels.Exponential, **F64)
    model = GPR.create(kern, noise_variance=0.1)
    leaves = [raw[:, i].clone().requires_grad_(True) for i in range(5)]
    return raw, tree_replace(model, leaves), leaves


def test_walk_forward_nll_gradient_and_posterior_match_the_program():
    X, Y = market.walk_forward_universe(11, 30, 1)
    X, y = torch.as_tensor(X), torch.as_tensor(Y[0])
    raw, model, leaves = _wf_rows(3, 0)
    n = 24
    mask = (torch.arange(30) < n).to(torch.float64).expand(3, 30)
    nll = wf.masked_nll(model, X, y[:, None], mask)
    grads = torch.autograd.grad(nll.sum(), leaves)
    v, g = ref.wf_nll_and_grad(X, y, raw, n, ref.F64)
    # the program takes √ of its expanded r², a few ulps off zero on the
    # diagonal: the two float64 forms part by ~1e-9
    torch.testing.assert_close(nll.detach(), v, rtol=1e-7, atol=1e-10)
    torch.testing.assert_close(torch.stack(grads, dim=1), g, rtol=1e-6, atol=1e-8)
    with torch.no_grad():
        mean, var = wf.masked_predict_next(model, X, y[:, None], mask,
                                           torch.full((3,), n, dtype=torch.long))
    m, s, prior = ref.wf_predict(X, y, raw, n, ref.F64)
    torch.testing.assert_close(mean, m, rtol=1e-7, atol=1e-9)
    torch.testing.assert_close(var, s, rtol=1e-7, atol=1e-9)
    assert torch.all(prior >= s)


def test_nuts_log_density_matches_the_program():
    X, Y = (torch.as_tensor(a) for a in market.nuts_posterior_data(40, 4))
    m0 = GPR.create(kernels.SquaredExponential.create(1.0, np.full(4, 8.0), **F64),
                    noise_variance=0.1)
    vg, flat0 = nuts_kind.flat_logdensity(X, Y, m0, 2.0)
    q = flat0 + 0.3 * torch.randn((5, 6), generator=torch.Generator().manual_seed(1),
                                  dtype=torch.float64)
    logp, grad = vg(q)
    z0 = ref.positive_inv(torch.tensor([1.0, 8.0, 8.0, 8.0, 8.0, 0.1], dtype=torch.float64))
    torch.testing.assert_close(z0[None], ravel(tree_replace(m0, tree_leaves(m0))))
    v, g = ref.nuts_logp_and_grad(X, Y, q, z0, ref.F64)
    torch.testing.assert_close(logp, v, rtol=1e-10, atol=1e-9)
    torch.testing.assert_close(grad, g, rtol=1e-8, atol=1e-9)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -12],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0], dtype=torch.float32)
    assert torch.equal(ref.tf32_round(x), want)
    a = torch.randn(64, 64)
    err = (ref.TF32.mm(a, a) - (a.double() @ a.double())).abs().max()
    assert 1e-4 < float(err) < 1e-1  # TF32 products: far from float32, near 2^-11 relative
