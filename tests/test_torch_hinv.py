"""The port's `blocked_hinv` tier (ops/nll.py triangular inverse, plain on the
CPU; ops/blocked_nll.py joins and NLL) and the GPR router's hinv tier,
against the JAX package, whose Pallas `_trinv_kernel` runs in interpret
mode on the CPU as tests/test_blocked_nll.py runs it.

Float32 on both sides, numpy-seeded inputs, unless stated. The JAX package
joins the power-of-two levels at Precision.HIGH (3-pass bf16) and the
port in full fp32, so the two inverses differ by ~1e-6 of max |W| on these
well-conditioned factors; the tolerances below allow ten times that:
W atol 1e-5·max|W|, NLL values rtol 2e-5 (the blocked tier's), gradients
atol 2e-4 of their largest entry. In float64 the port must equal numpy's
dense inverse and NLL to 1e-10 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.models import gpr as jgpr
from portfoliooptgp_tpu.ops.pallas import blocked_nll as jbn
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.models import gpr as tgpr
from portfoliooptgp_tpu_torch.ops import blocked_nll as tbn
from portfoliooptgp_tpu_torch.ops import nll as tnll

torch.set_num_threads(1)

LOG2PI = np.log(2 * np.pi)
W_ATOL = 1e-5  # of max |W|
VALUE_RTOL = 2e-5
GRAD_ATOL = 2e-4  # of the largest |gradient entry|


def _spd(B, N, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, N, N))
    return (A @ np.swapaxes(A, 1, 2) / N + 0.5 * np.eye(N)).astype(dtype)


def _factor(B, Np, seed, dtype=np.float32):
    return np.linalg.cholesky(_spd(B, Np, seed, np.float64)).astype(dtype)


@pytest.mark.parametrize("Np", [384, 1408])
def test_torch_triangular_inverse_plain_matches_jax(Np):
    """The plain diagonal-block inverse (the kernel's oracle) against the
    diagonal blocks of the JAX package's hierarchical inverse, whose
    diagonal blocks are `_trinv_kernel`'s output (P = 3 and 11, B = 2)."""
    L = _factor(2, Np, Np)
    want = np.asarray(jbn.triangular_inverse_uneven(jnp.asarray(L)))
    got = tnll.triangular_inverse_plain(torch.tensor(L)).numpy()
    assert got.shape == (2, Np // 128, 128, 128)
    for p in range(Np // 128):
        blk = want[:, p * 128:(p + 1) * 128, p * 128:(p + 1) * 128]
        np.testing.assert_allclose(got[:, p], blk, atol=W_ATOL * np.abs(blk).max())
        assert np.all(np.triu(got[:, p], 1) == 0.0)


@pytest.mark.parametrize("fn", ["blocked_triangular_inverse", "triangular_inverse_uneven"])
@pytest.mark.parametrize("Np", [384, 1408])
def test_torch_hierarchical_inverse_matches_jax(fn, Np):
    """W = L⁻¹ at P = 3 (JAX pads it to 4 in `blocked_triangular_inverse`)
    and P = 11 (8 + (2 + 1) in the uneven split), B = 2."""
    L = _factor(2, Np, Np + 1)
    want = np.asarray(getattr(jbn, fn)(jnp.asarray(L)))
    got = getattr(tbn, fn)(torch.tensor(L)).numpy()
    assert got.shape == want.shape == (2, Np, Np)
    np.testing.assert_allclose(got, want, atol=W_ATOL * np.abs(want).max())


def test_torch_hierarchical_inverse_float64_is_the_inverse():
    L = _factor(2, 1408, 5, np.float64)
    got = tbn.triangular_inverse_uneven(torch.tensor(L)).numpy()
    np.testing.assert_allclose(got, np.linalg.inv(L), rtol=1e-10, atol=1e-10)


def _hinv_problem(B, N, seed):
    rng = np.random.default_rng(seed)
    K = _spd(B, N, seed) - 0.4 * np.eye(N, dtype=np.float32)
    y = rng.normal(size=(B, N)).astype(np.float32)
    noise = np.linspace(0.3, 0.8, B).astype(np.float32)
    return K, y, noise


def _torch_value_and_grads(fn, *arrays):
    args = [torch.tensor(x, requires_grad=True) for x in arrays]
    nll = fn(*args)
    grads = torch.autograd.grad(nll.sum(), args)
    return nll.detach().numpy(), [g.numpy() for g in grads]


def test_torch_batched_nll_hinv_matches_jax():
    """N = 1100 (9 panels after padding to 1152), B = 3."""
    K, y, noise = _hinv_problem(3, 1100, 7)
    assert tbn.hinv_nll_preferred(1100, 3) and jbn.hinv_nll_preferred(1100, 3)
    jargs = tuple(jnp.asarray(x) for x in (K, y, noise))
    jval = jbn.batched_nll_hinv(*jargs)
    jgrads = jax.grad(lambda *a: jnp.sum(jbn.batched_nll_hinv(*a)), argnums=(0, 1, 2))(*jargs)
    tval, tgrads = _torch_value_and_grads(tbn.batched_nll_hinv, K, y, noise)
    np.testing.assert_allclose(tval, np.asarray(jval), rtol=VALUE_RTOL)
    for g, w in zip(tgrads, jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL * np.abs(w).max())


def test_torch_batched_nll_hinv_float64_matches_dense():
    K, y, noise = (x.astype(np.float64) for x in _hinv_problem(2, 1100, 8))
    Ks = K + noise[:, None, None] * np.eye(1100)
    want = [0.5 * y[b] @ np.linalg.solve(Ks[b], y[b])
            + np.log(np.diag(np.linalg.cholesky(Ks[b]))).sum() + 550 * LOG2PI
            for b in range(2)]
    got, (gK, gy, gn) = _torch_value_and_grads(tbn.batched_nll_hinv, K, y, noise)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    Kinv = np.linalg.inv(Ks)
    alpha = np.einsum("bij,bj->bi", Kinv, y)
    np.testing.assert_allclose(gy, alpha, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(
        gK, 0.5 * (Kinv - alpha[:, :, None] * alpha[:, None, :]), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(
        gn, 0.5 * (np.trace(Kinv, axis1=1, axis2=2) - np.sum(alpha * alpha, -1)), rtol=1e-8)


def test_torch_batched_nll_hinv_nan_when_indefinite():
    """An indefinite K gives NaN, as jnp.linalg.cholesky does, not an error."""
    K, y, noise = _hinv_problem(2, 1100, 9)
    K[1] -= 3.0 * np.eye(1100, dtype=np.float32)
    jval = np.asarray(jbn.batched_nll_hinv(*(jnp.asarray(x) for x in (K, y, noise))))
    tval = tbn.batched_nll_hinv(*(torch.tensor(x) for x in (K, y, noise))).numpy()
    assert np.isnan(jval[1]) and np.isnan(tval[1])
    np.testing.assert_allclose(tval[0], jval[0], rtol=VALUE_RTOL)


def test_torch_triangular_inverse_keeps_nan():
    """NaN in a block reaches every entry of its inverse that depends on it;
    the other blocks are untouched."""
    L = _factor(3, 128, 3)
    L[1, 40, 17] = np.nan
    got = tnll.triangular_inverse_plain(torch.tensor(L)).numpy()[:, 0]
    assert np.all(np.isfinite(got[[0, 2]]))
    assert np.all(np.isnan(got[1, 40:, :18])) and np.all(np.isfinite(got[1, :40]))


def test_torch_router_hinv_tier_matches_jax():
    """The GPR router at N = 1100, float32: both name 'blocked_hinv', and
    the port's NLLs (rtol 2e-5) and raw-leaf gradients match the JAX
    router's. The kernel-leaf gradients are float32 sums that cancel
    (tr(Ks⁻¹∂K) − αᵀ∂Kα): each float32 router lies up to 1% from the float64
    one there, so they are held with the normalized atol 2e-2 of the fused
    router test (test_torch_stationary_nll.py)."""
    rng = np.random.default_rng(11)
    N = 1100
    X = np.sort(rng.uniform(0, 30, (N, 2)), axis=0).astype(np.float32)
    Y = rng.normal(size=(N, 1)).astype(np.float32)
    ms = [jgpr.GPR.create(jk.SquaredExponential.create(v, [3.0, 5.0]), noise_variance=0.2 * v)
          for v in (0.5, 1.5)]
    jm = jax.tree.map(lambda *xs: jnp.stack(xs).astype(jnp.float32), *ms)
    jX, jY = jnp.asarray(X), jnp.asarray(Y)
    assert jgpr.nll_tier(jm, jX, jY) == "blocked_hinv"
    jval = jgpr.batched_neg_log_marginal_likelihood(jm, jX, jY)
    jgrads = jax.grad(lambda m: jnp.sum(jgpr.batched_neg_log_marginal_likelihood(m, jX, jY)))(jm)
    tm = tparams.from_jax_leaves(
        tgpr.GPR.create(tk.SquaredExponential.create(1.0, [1.0, 1.0], device="cpu"), 0.1),
        [np.asarray(x) for x in jax.tree.leaves(jm)])
    tX, tY = torch.tensor(X), torch.tensor(Y)
    assert tgpr.nll_tier(tm, tX, tY) == "blocked_hinv"
    leaves = tparams.tree_leaves(tm)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tval = tgpr.batched_neg_log_marginal_likelihood(tm, tX, tY, device="cpu")
    tgrads = torch.autograd.grad(tval.sum(), leaves)
    assert tgpr.DISPATCH_EVENTS[-1]["tier"] == "blocked_hinv"
    np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval), rtol=VALUE_RTOL)
    for g, w in zip(tgrads, jax.tree.leaves(jgrads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=2e-2 * max(np.abs(w).max(), 1.0))
