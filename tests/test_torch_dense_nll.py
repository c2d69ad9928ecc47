"""Port parity: the dense NLL tier (ops/nll.batched_nll).

On CPU tensors the port's dense NLL runs its plain version (the kernel's
column loop in torch) and the closed-form backward. Float32 reference: the
JAX package's `nll.batched_nll`, whose Pallas kernels (`_nll_kernel`,
`_nll_inv_kernel`) run in interpret mode on the CPU as in
tests/test_pallas_nll.py, with that file's tolerances (values rtol 2e-4,
gradients rtol 5e-3 / atol 5e-4). Float64 reference: the JAX router's XLA
path, the same arithmetic in another order (rtol 1e-10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.models import gpr as jgpr
from portfoliooptgp_tpu.ops.pallas import nll as jnll
from portfoliooptgp_tpu_torch.ops import nll as tnll

# tiny matrices: one intra-op thread per test worker avoids oversubscribing the
# CPU when pytest-xdist runs several workers
torch.set_num_threads(1)


def _operands(B, N, seed, dtype=np.float32):
    """(K, y, noise): SPD K = AAᵀ/N + SE Gram, noise in [0.05, 0.3]."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, N, N))
    x = np.sort(rng.uniform(0, 10, N))
    K = np.einsum("bij,bkj->bik", A, A) / N + np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2)
    return (K.astype(dtype), rng.normal(size=(B, N)).astype(dtype),
            rng.uniform(0.05, 0.3, B).astype(dtype))


@pytest.mark.parametrize("B,N", [(3, 77), (4, 100), (2, 131)])
def test_torch_dense_nll_float32_matches_jax_pallas(B, N):
    K, y, noise = _operands(B, N, B + N)
    jv, jg = jax.value_and_grad(lambda *a: jnp.sum(jnll.batched_nll(*a)), argnums=(0, 1, 2))(
        jnp.asarray(K), jnp.asarray(y), jnp.asarray(noise))
    jvals = jnll.batched_nll(jnp.asarray(K), jnp.asarray(y), jnp.asarray(noise))
    leaves = [torch.tensor(x, requires_grad=True) for x in (K, y, noise)]
    tv = tnll.batched_nll(*leaves)
    grads = torch.autograd.grad(tv.sum(), leaves)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jvals), rtol=2e-4)
    np.testing.assert_allclose(float(tv.detach().sum()), float(jv), rtol=2e-4)
    for g, w in zip(grads, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-3, atol=5e-4)
    value_only = tnll.batched_nll_pallas(*(torch.tensor(x) for x in (K, y, noise)))
    np.testing.assert_allclose(value_only.numpy(), tv.detach().numpy(), rtol=1e-6)


def test_torch_dense_nll_float64_matches_jax_xla():
    """A batch of GPR models (SE + Matern12 sum, so the JAX router's float64
    path is its vmapped XLA NLL): K and the residuals built by JAX, the NLL
    and its gradients by the port's dense tier against the router's."""
    rng = np.random.default_rng(3)
    N = 50
    X = jnp.asarray(np.sort(rng.uniform(0, 10, (N, 1)), axis=0), jnp.float64)
    Y = jnp.asarray(rng.normal(size=(N, 1)), jnp.float64)
    ms = [jgpr.GPR.create(jk.SquaredExponential.create(v, 1.5) + jk.Matern12.create(0.5, 2.0),
                          noise_variance=0.05 * (1 + v)) for v in (0.5, 1.0, 2.0)]
    jm = jax.tree.map(lambda *xs: jnp.stack(xs).astype(jnp.float64), *ms)
    want = jgpr.batched_neg_log_marginal_likelihood(jm, X, Y, fast=False)
    K = np.asarray(jax.vmap(lambda m: m.kernel.K(X))(jm))
    noise = np.asarray(jax.vmap(lambda m: m.likelihood.variance)(jm))
    err = np.broadcast_to(np.asarray(Y)[:, 0], (3, N)).copy()
    Kinv = np.linalg.inv(K + noise[:, None, None] * np.eye(N))
    assert K.dtype == np.float64
    leaves = [torch.tensor(x, requires_grad=True) for x in (K, err, noise)]
    got = tnll.batched_nll(*leaves)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-10)
    dK, dy, dn = torch.autograd.grad(got.sum(), leaves)
    alpha = np.einsum("bij,bj->bi", Kinv, err)
    np.testing.assert_allclose(dK.numpy(), 0.5 * (Kinv - alpha[:, :, None] * alpha[:, None, :]),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(dy.numpy(), alpha, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(
        dn.numpy(), 0.5 * (np.trace(Kinv, axis1=1, axis2=2) - np.sum(alpha ** 2, axis=1)),
        rtol=1e-8)


@pytest.mark.parametrize("N", [40, 300])
def test_torch_dense_factor_inverse_and_log_det(N):
    """W·L = I and Σ log diag L of the plain column loop, float64, inside the
    dense tier's window and past it (N = 300: the loop takes any N; it is
    the NaN-pattern reference of the stationary cluster kernel's checks)."""
    K, y, noise = (torch.tensor(x) for x in _operands(3, N, 1, np.float64))
    a, logdet, W = tnll.factor_solve_inv_plain(K, y, noise)
    L = torch.linalg.cholesky(K + torch.diag_embed(noise[:, None].expand(3, N)))
    torch.testing.assert_close(W @ L, torch.eye(N, dtype=torch.float64).expand(3, N, N),
                               rtol=0, atol=1e-12)
    torch.testing.assert_close(logdet, torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1))
    torch.testing.assert_close(a, torch.linalg.solve_triangular(L, y[..., None],
                                                                upper=False)[..., 0])
    a2, logdet2 = tnll.factor_solve_plain(K, y, noise)
    torch.testing.assert_close(a2, a, rtol=0, atol=0)
    torch.testing.assert_close(logdet2, logdet, rtol=0, atol=0)


def test_torch_dense_nll_indefinite_gives_nan():
    """An indefinite model gives NaN, its neighbours in the batch stay finite."""
    K, y, noise = (torch.tensor(x) for x in _operands(3, 30, 2))
    K[1] -= 5.0 * torch.eye(30)
    nll = tnll.batched_nll(K, y, noise)
    assert torch.isnan(nll[1]) and torch.all(torch.isfinite(nll[[0, 2]]))
    a, logdet = tnll.factor_solve_plain(K, y, noise)
    assert torch.isnan(logdet[1]) and torch.all(torch.isfinite(a[[0, 2]]))


def test_torch_dense_nll_rejects_bad_input():
    K, y, noise = (torch.tensor(x) for x in _operands(2, 257, 4))
    with pytest.raises(ValueError, match="N ≤ 256"):
        tnll.batched_nll(K, y, noise)
    with pytest.raises(ValueError, match="not \\(B, N, N\\)"):
        tnll.batched_nll(K[:, :10, :10], y, noise)
