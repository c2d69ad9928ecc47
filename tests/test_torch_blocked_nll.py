"""The port's blocked NLL tier (ops/blocked_nll.py, plain panel factor on
the CPU) against the JAX package's `batched_nll_blocked`, whose Pallas
panel kernel runs in interpret mode on the CPU as tests/test_blocked_nll.py
runs it.

Float32 on both sides, numpy-seeded inputs. Tolerances: values rtol 2e-5
and gradients atol 2e-4, those of tests/test_blocked_nll.py against its
dense references (the two float32 factorizations round differently, the
JAX one over a 128-padded N). In float64 the port must equal a dense
numpy reference to rtol 1e-10. Shapes: B=8, N=320 (the JAX test's) and
B=1, N=600 (the batch of one that the trainer runs, and an N that is not a
multiple of 128, which the JAX package pads and the port does not)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portfoliooptgp_tpu.ops.pallas import blocked_nll as jbn
from portfoliooptgp_tpu_torch.ops import blocked_nll as tbn

# one intra-op thread per test worker avoids oversubscribing the CPU when
# pytest-xdist runs several workers
torch.set_num_threads(1)

LOG2PI = np.log(2 * np.pi)


def _problem(B, N, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, N, N))
    K = (A @ np.swapaxes(A, 1, 2) / N).astype(dtype)
    y = rng.normal(size=(B, N)).astype(dtype)
    noise = np.linspace(0.3, 0.8, B).astype(dtype)
    return K, y, noise


def _torch_value_and_grads(K, y, noise):
    args = [torch.tensor(x, requires_grad=True) for x in (K, y, noise)]
    nll = tbn.batched_nll_blocked(*args)
    grads = torch.autograd.grad(nll.sum(), args)
    return nll.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("B,N", [(8, 320), (1, 600)])
def test_torch_blocked_nll_matches_jax(B, N):
    K, y, noise = _problem(B, N, seed=N)
    jargs = tuple(jnp.asarray(x) for x in (K, y, noise))
    jval = jbn.batched_nll_blocked(*jargs)
    jgrads = jax.grad(lambda *a: jnp.sum(jbn.batched_nll_blocked(*a)),
                      argnums=(0, 1, 2))(*jargs)
    tval, tgrads = _torch_value_and_grads(K, y, noise)
    np.testing.assert_allclose(tval, np.asarray(jval), rtol=2e-5)
    for g, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4)


def test_torch_blocked_nll_float64_matches_dense():
    """N = 300: three panels, the last 44 columns wide."""
    K, y, noise = _problem(3, 300, seed=1, dtype=np.float64)
    Ks = K + noise[:, None, None] * np.eye(300)
    want = [0.5 * y[b] @ np.linalg.solve(Ks[b], y[b])
            + np.log(np.diag(np.linalg.cholesky(Ks[b]))).sum() + 150 * LOG2PI
            for b in range(3)]
    got, (gK, gy, gn) = _torch_value_and_grads(K, y, noise)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    Kinv = np.linalg.inv(Ks)
    alpha = np.einsum("bij,bj->bi", Kinv, y)
    np.testing.assert_allclose(gy, alpha, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(
        gK, 0.5 * (Kinv - alpha[:, :, None] * alpha[:, None, :]), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(
        gn, 0.5 * (np.trace(Kinv, axis1=1, axis2=2) - np.sum(alpha * alpha, -1)), rtol=1e-8)


def test_torch_blocked_cholesky_matches_jax():
    """L and Σ log diag L of the port's blocked factor against the JAX
    package's (B=8, N=256, the shape of its own factor test): rtol/atol
    1e-4 on L and rtol 1e-5 on the log sum, as tests/test_blocked_nll.py
    holds the JAX factor against numpy."""
    K, _, noise = _problem(8, 256, seed=2)
    Ks = K + noise[:, None, None] * np.eye(256, dtype=np.float32)
    jL, jld = jbn.blocked_cholesky(jnp.asarray(Ks))
    tL, tld = tbn.blocked_cholesky(torch.tensor(Ks))
    np.testing.assert_allclose(tL.numpy(), np.asarray(jL), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tld.numpy(), np.asarray(jld), rtol=1e-5)
    assert np.all(np.triu(tL.numpy(), 1) == 0)


def test_torch_factor_panel_plain_ragged_panel():
    """A panel shorter than 128 rows is its own diagonal block; a taller
    one gives L21 with L11 L21ᵀ = A21ᵀ (float64, rtol 1e-12)."""
    K, _, noise = _problem(2, 200, seed=3, dtype=np.float64)
    Ks = torch.tensor(K + noise[:, None, None] * np.eye(200))
    Lp, ld = tbn.factor_panel_plain(Ks[:, :, :128])
    L11, L21 = Lp[:, :128], Lp[:, 128:]
    torch.testing.assert_close(L11 @ L11.mT, torch.tril(Ks[:, :128, :128])
                               + torch.tril(Ks[:, :128, :128], -1).mT, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(L21 @ L11.mT, Ks[:, 128:, :128], rtol=1e-12, atol=1e-12)
    small, ld_small = tbn.factor_panel_plain(Ks[:, :72, :72])
    assert small.shape == (2, 72, 72)
    torch.testing.assert_close(ld_small, torch.log(torch.diagonal(
        torch.linalg.cholesky(Ks[:, :72, :72]), dim1=-2, dim2=-1)).sum(-1))


def test_torch_factor_panel_plain_writes_into_out():
    """With `out`, the plain panel factor writes the L panel into that view
    of a larger factor and returns it, as the kernel does on the card, and
    leaves the rest of the buffer alone; blocked_cholesky, which passes its
    view of L, gives the dense factor (float64, rtol 1e-12)."""
    K, _, noise = _problem(2, 300, seed=5, dtype=np.float64)
    Ks = torch.tensor(K + noise[:, None, None] * np.eye(300))
    buf = torch.full((2, 428, 428), 7.0, dtype=torch.float64)
    view = buf[:, 128:, 128:256]
    Lo, ldo = tbn.factor_panel_plain(Ks[:, :, :128], out=view)
    Lp, ldp = tbn.factor_panel_plain(Ks[:, :, :128])
    assert Lo.data_ptr() == view.data_ptr()
    assert torch.equal(view, Lp) and torch.equal(ldo, ldp)
    rest = torch.ones_like(buf, dtype=torch.bool)
    rest[:, 128:, 128:256] = False
    assert torch.all(buf[rest] == 7.0)
    L, ld = tbn.blocked_cholesky(Ks)
    torch.testing.assert_close(L, torch.linalg.cholesky(Ks), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ld, torch.logdet(Ks) / 2, rtol=1e-12, atol=0)


def test_torch_blocked_nll_indefinite_gives_nan():
    """An indefinite K + σ²I: NaN in both packages, never a clamp."""
    K, y, noise = _problem(8, 320, seed=4)
    noise = noise - 5.0  # pushes the smallest eigenvalues below zero
    jval = np.asarray(jbn.batched_nll_blocked(*(jnp.asarray(x) for x in (K, y, noise))))
    with torch.no_grad():
        tval = tbn.batched_nll_blocked(*(torch.tensor(x) for x in (K, y, noise))).numpy()
    assert np.all(np.isnan(jval))
    assert np.all(np.isnan(tval))
