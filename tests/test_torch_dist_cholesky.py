"""The port's distributed Cholesky NLL (portfoliooptgp_tpu_torch/parallel/
dist_cholesky.py) against the JAX package's dense NLL and its gradients,
at world sizes 2 and 4 (gloo on the CPU, float64), mirroring
tests/test_dist_cholesky.py.

The ranks run once per world size (a module fixture; their body is
tests/torch_ranks.dist_cholesky_checks, which imports no JAX); each holds
its rows of K and y in the layout's order, and rank results are gathered
back to global order. The NLL is held to JAX's dense value at rtol 1e-9,
the gradients dK, dy and dσ² to JAX's dense autodiff at rtol 1e-8, and one
gradient through K(X; θ) with θ replicated to JAX's at its test's 1e-7.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks

from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.models import gpr as jgpr
from portfoliooptgp_tpu.parallel.dist_cholesky import cyclic_row_permutation as jperm
from portfoliooptgp_tpu_torch.parallel import dist_cholesky as tdc
from portfoliooptgp_tpu_torch.parallel import distributed

torch.set_num_threads(1)

WORLDS = (2, 4)
NOISE = 0.05


def _dense_nll(K, Y, noise):
    n = K.shape[0]
    L = jnp.linalg.cholesky(K + noise * jnp.eye(n, dtype=K.dtype))
    a = jax.scipy.linalg.solve_triangular(L, Y, lower=True)
    return 0.5 * jnp.sum(a * a) + jnp.sum(jnp.log(jnp.diagonal(L))) + 0.5 * n * jnp.log(2 * jnp.pi)


_dense_vg = jax.jit(jax.value_and_grad(_dense_nll, argnums=(0, 1, 2)))


def _problem(n, span):
    """tests/test_dist_cholesky.py's problem (its `rng` fixture's seed)."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, span, (n, 1)), 0)
    Y = np.sin(X) + 0.1 * rng.normal(size=(n, 1))
    kern = jk.SquaredExponential.create(variance=1.3, lengthscales=1.7)
    return X, Y, kern, np.asarray(kern.K(jnp.asarray(X)))


@pytest.fixture(scope="module")
def refs():
    X, Y, kern, K = _problem(512, 30)
    X64, Y64, _, K64 = _problem(64, 10)
    model = jgpr.GPR.create(kern, noise_variance=NOISE)
    out = dict(X=X, Y=Y, K=K, K64=K64, Y64=Y64,
               kernel_leaves=[np.asarray(x) for x in jax.tree.leaves(kern)])
    out["nll"] = float(jax.jit(jgpr.neg_log_marginal_likelihood)(model, jnp.asarray(X),
                                                                jnp.asarray(Y)))
    for name, (K_, Y_) in (("dense", (K, Y)), ("dense64", (K64, Y64))):
        value, grads = _dense_vg(jnp.asarray(K_), jnp.asarray(Y_), jnp.asarray(NOISE))
        out[name] = (float(value), *[np.asarray(g) for g in grads])

    def loss_dense(kern):
        return _dense_nll(kern.K(jnp.asarray(X)), jnp.asarray(Y), jnp.asarray(NOISE))

    out["theta_grads"] = [np.asarray(g) for g in jax.tree.leaves(jax.jit(jax.grad(loss_dense))(
        kern))]
    return out


@pytest.fixture(scope="module")
def runs(refs, tmp_path_factory):
    out = {}
    inputs = dict(X=torch.tensor(refs["X"]), Y=torch.tensor(refs["Y"]), K=torch.tensor(refs["K"]),
                  K64=torch.tensor(refs["K64"]), Y64=torch.tensor(refs["Y64"]), noise=NOISE,
                  kernel_leaves=refs["kernel_leaves"])
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"dist_cholesky{world}")
        torch.save(inputs, d / "in.pt")
        distributed.spawn(torch_ranks.dist_cholesky_checks, world, str(d / "in.pt"), str(d),
                          device="cpu", timeout_s=300)
        out[world] = torch_ranks.load_ranks(str(d), world)
    return out


def _grads_match(got, want):
    value, dK, dy, dn = got
    np.testing.assert_allclose(value, want[0], rtol=1e-9)
    np.testing.assert_allclose(dK.numpy(), want[1], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(dy.numpy(), want[2], rtol=1e-8)
    np.testing.assert_allclose(dn, float(want[3]), rtol=1e-8)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("layout", tdc.LAYOUTS)
@pytest.mark.parametrize("nb", [16, 32, 64])
def test_torch_sharded_nll_matches_dense(refs, runs, world, layout, nb):
    """Every block size and both layouts: the NLL on every rank is the
    dense GPR NLL of the JAX package, rtol 1e-9."""
    for r in runs[world]:
        got = r[f"value_{layout}_{nb}"]
        np.testing.assert_allclose(got[0] if isinstance(got, tuple) else got, refs["nll"],
                                   rtol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_torch_sharded_nll_fewer_ranks(refs, runs, world):
    """The data axis of a (world/2, 2) mesh: half the ranks hold rows, the
    restart axis replicates them."""
    for r in runs[world]:
        np.testing.assert_allclose(r["value_half"], refs["nll"], rtol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("layout", tdc.LAYOUTS)
def test_torch_sharded_nll_grads_match_dense(refs, runs, world, layout):
    """The closed-form backward (two sweeps over panels with collectives):
    dK, dy and dσ² as JAX's dense autodiff, gathered from the ranks' rows."""
    for r in runs[world]:
        _grads_match(r[f"value_{layout}_32"], refs["dense"])


@pytest.mark.parametrize("world", WORLDS)
def test_torch_sharded_nll_grads_match_dense_fast(refs, runs, world):
    """tests/test_dist_cholesky.py's fast case: N = 64, block size 8."""
    for r in runs[world]:
        _grads_match(r["fast"], refs["dense64"])


@pytest.mark.parametrize("world", WORLDS)
def test_torch_sharded_nll_trains_hyperparameters(refs, runs, world):
    """A gradient through each rank's rows K(X_rows, X; θ), θ entering the
    ranks through `mesh.replicated_input`: the dense gradient of JAX,
    rtol 1e-7 (its test's)."""
    for r in runs[world]:
        for got, want in zip(r["theta_grads"], refs["theta_grads"]):
            np.testing.assert_allclose(got.numpy().reshape(want.shape), want, rtol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_torch_shape_validation(runs, world):
    """N that leaves a rank a row count the block size does not divide, and
    a block size that does not divide N / D, raise ValueError."""
    for r in runs[world]:
        assert all(e is not None and "divide" in e for e in r["shape_errors"])


def test_torch_cyclic_permutation_is_jax_permutation():
    perm = tdc.cyclic_row_permutation(512, 8, 32)
    assert sorted(perm.tolist()) == list(range(512))
    assert perm[0] == 0 and perm[64] == 32
    np.testing.assert_array_equal(perm, jperm(512, 8, 32))
    for d in range(4):
        np.testing.assert_array_equal(tdc.local_rows(512, 4, 16, d, True),
                                      perm_rows(512, 4, 16, d))
        np.testing.assert_array_equal(tdc.local_rows(512, 4, 16, d, False),
                                      np.arange(128 * d, 128 * (d + 1)))


def perm_rows(N, D, nb, d):
    """Rank d's rows in the JAX package's cyclic layout: the d-th contiguous
    shard of K[perm]."""
    return jperm(N, D, nb)[d * (N // D):(d + 1) * (N // D)]


def test_torch_sharded_nll_on_one_process():
    """Without a process group the mesh is one rank: the panel loop alone,
    still the dense value and gradients."""
    from portfoliooptgp_tpu_torch.parallel import mesh as tmesh

    _, Y, _, K = _problem(64, 10)
    m = tmesh.make_mesh(device="cpu")
    Kt = torch.tensor(K, requires_grad=True)
    yt = torch.tensor(Y, requires_grad=True)
    nll = tdc.sharded_gpr_nll(Kt, yt, NOISE, m, block_size=16, layout="cyclic")
    want = _dense_vg(jnp.asarray(K), jnp.asarray(Y), jnp.asarray(NOISE))
    np.testing.assert_allclose(float(nll), float(want[0]), rtol=1e-12)
    dK, dy = torch.autograd.grad(nll, (Kt, yt))
    np.testing.assert_allclose(dK.numpy(), np.asarray(want[1][0]), rtol=1e-9, atol=1e-12)
    assert math.isfinite(float(nll))
