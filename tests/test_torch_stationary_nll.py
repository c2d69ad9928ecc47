"""Port parity: the fused stationary NLL and the NLL router.

The port's stationary NLL on CPU tensors runs its plain forward and the
closed-form backward; the reference is the JAX package's Pallas kernel in
interpret mode (its own custom VJP), on the same numpy-seeded float64
operands. Both are the same arithmetic in a different order, so values
agree to rtol 1e-9 and gradients, normalized by max(|ref|, 1), to 1e-8.
One product and one sum call cover all seven families, an ARD atom
(dims 2) and partial masks at once, to keep interpret-mode time small."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.models import gpr as jgpr
from portfoliooptgp_tpu.ops.pallas import stationary_nll as jst
from portfoliooptgp_tpu.pipelines import walk_forward as jwf
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.models import gpr as tgpr
from portfoliooptgp_tpu_torch.ops import nll as tnll
from portfoliooptgp_tpu_torch.ops import stationary_nll as tst
from portfoliooptgp_tpu_torch.pipelines import walk_forward as twf

# tiny matrices: one intra-op thread per test worker avoids oversubscribing the
# CPU when pytest-xdist runs several workers
torch.set_num_threads(1)

ALL_FAMILIES = ("se", "matern12", "matern32", "matern52", "rq", "periodic_se", "linear")
ALL_DIMS = (2, 1, 1, 1, 1, 1, 1)


def _operands(B=3, N=12, seed=0):
    """(d2s, err, vs, ls, als, noise, mask) as float64 numpy: per-dim
    squared distances for the stationary atoms, a Gram matrix for
    'linear' (its ls slot pinned to 1), prefix masks of 7, 10 and 12 rows."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 3, (N, 4)), axis=0)
    d2s, col = [], 0
    for fam, dj in zip(ALL_FAMILIES, ALL_DIMS):
        for _ in range(dj):
            x = X[:, col % 4]
            col += 1
            d2s.append(np.outer(x, x) / 9.0 if fam == "linear"
                       else (x[:, None] - x[None, :]) ** 2)
    mask = (np.arange(N)[None, :] < np.array([7, 10, 12])[:, None]).astype(float)
    err = rng.normal(size=(B, N)) * mask
    J, JD = len(ALL_FAMILIES), len(d2s)
    vs = [rng.uniform(0.7, 1.3, B) for _ in range(J)]
    ls = [rng.uniform(1.0, 3.0, B) for _ in range(JD)]
    ls[-1] = np.ones(B)
    als = [rng.uniform(1.0, 2.5, B) for _ in range(J)]
    noise = rng.uniform(0.1, 0.3, B)
    return d2s, err, vs, ls, als, noise, mask


def _assert_grads(got, want, atol=1e-8):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert np.all(np.isfinite(g))
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(g / scale, w / scale, atol=atol)


@pytest.mark.parametrize("combine", ["prod", "sum"])
def test_torch_general_nll_matches_pallas_interpret(combine):
    d2s, err, vs, ls, als, noise, mask = _operands()
    jfn = (jst.batched_nll_stationary_general if combine == "prod"
           else jst.batched_nll_stationary_sum)
    tfn = (tst.batched_nll_stationary_general if combine == "prod"
           else tst.batched_nll_stationary_sum)

    def jloss(d2s, err, vs, ls, als, noise):
        return jnp.sum(jfn(ALL_FAMILIES, d2s, err, vs, ls, als, noise,
                           jnp.asarray(mask), dims=ALL_DIMS))

    jargs = (tuple(map(jnp.asarray, d2s)), jnp.asarray(err), tuple(map(jnp.asarray, vs)),
             tuple(map(jnp.asarray, ls)), tuple(map(jnp.asarray, als)), jnp.asarray(noise))
    jval, jgrads = jax.value_and_grad(jloss, argnums=tuple(range(6)))(*jargs)
    jnll = jfn(ALL_FAMILIES, *jargs, jnp.asarray(mask), dims=ALL_DIMS)

    def leaf(x):
        return torch.tensor(x, dtype=torch.float64, requires_grad=True)

    targs = ([leaf(d) for d in d2s], leaf(err), [leaf(v) for v in vs],
             [leaf(l) for l in ls], [leaf(a) for a in als], leaf(noise))
    tnll = tfn(ALL_FAMILIES, *targs, torch.as_tensor(mask), dims=ALL_DIMS)
    tnll.sum().backward()
    np.testing.assert_allclose(tnll.detach().numpy(), np.asarray(jnll), rtol=1e-9)
    flat_t = (targs[0] + [targs[1]] + targs[2] + targs[3] + targs[4] + [targs[5]])
    flat_j = (list(jgrads[0]) + [jgrads[1]] + list(jgrads[2]) + list(jgrads[3])
              + list(jgrads[4]) + [jgrads[5]])
    _assert_grads([t.grad.numpy() for t in flat_t], flat_j)


@pytest.mark.parametrize("family", tst.FAMILIES)
def test_torch_single_family_nll_matches_pallas_interpret(family):
    d2s, err, vs, ls, _, noise, _ = _operands(seed=1)
    args = (d2s[0], err, vs[0], ls[0], noise)
    jvals = jax.value_and_grad(
        lambda *a: jnp.sum(jst.batched_nll_stationary(*a, family)),
        argnums=tuple(range(5)))(*map(jnp.asarray, args))
    jnll = jst.batched_nll_stationary(*map(jnp.asarray, args), family)
    targs = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in args]
    tnll = tst.batched_nll_stationary(*targs, family)
    tnll.sum().backward()
    np.testing.assert_allclose(tnll.detach().numpy(), np.asarray(jnll), rtol=1e-9)
    _assert_grads([t.grad.numpy() for t in targs], jvals[1])


def test_torch_plain_siblings_equal_wrapper_on_cpu():
    """On CPU tensors the wrapper IS the plain version: identical bits."""
    d2s, err, vs, ls, als, noise, mask = _operands(seed=2)
    T = lambda xs: [torch.as_tensor(x) for x in xs]  # noqa: E731
    args = (ALL_FAMILIES, T(d2s), torch.as_tensor(err), T(vs), T(ls), T(als),
            torch.as_tensor(noise), torch.as_tensor(mask))
    a = tst.batched_nll_stationary_sum(*args, dims=ALL_DIMS)
    b = tst.batched_nll_stationary_sum_plain(*args, dims=ALL_DIMS)
    assert torch.equal(a, b)
    before = dict(tst.LAUNCHES)
    tst.batched_nll_stationary_general(*args, dims=ALL_DIMS)
    assert tst.LAUNCHES == before  # CPU tensors never count as kernel launches


def test_torch_indefinite_factor_gives_nan():
    """A negative noise makes K indefinite: NaN, not an exception or a
    clamp (the line search rejects such steps by their non-finite loss)."""
    d2s, err, vs, ls, _, noise, _ = _operands(seed=3)
    nll = tst.batched_nll_stationary(
        torch.as_tensor(d2s[0]), torch.as_tensor(err), torch.as_tensor(vs[0]),
        torch.as_tensor(ls[0]), torch.as_tensor(-5.0 * noise - 3.0), "se")
    assert torch.all(torch.isnan(nll))


@pytest.mark.parametrize("case", ["se", "matern12*matern12 masked"])
def test_torch_fused_plain_above_256_matches_jax_xla(case):
    """The port's fused tiers above N = 256 on CPU tensors, the plain forward
    and the closed-form backward (the CPU route of every fused caller there:
    frontier grid A, a walk-forward on a long window, the NUTS posterior),
    against the JAX package's XLA path (its router with the fused tier off,
    fast=False) in float64 at B = 2, N = 300: values rtol 1e-9, gradients of
    every raw leaf normalized by max(|ref|, 1) atol 1e-8. Masked, model b
    keeps its first keep[b] rows: the reference is the XLA NLL of those rows
    plus ½ (N − keep[b]) log 2π (the fused tiers carry 2π at the full N).
    The two sides build the squared distances in other orders (the fused
    spec at unit lengthscale, XLA on X / ℓ), a difference far below 1e-9."""
    B, N = 2, 300
    rng = np.random.default_rng(7)
    if case == "se":
        X = np.sort(rng.uniform(0, 30, (N, 1)), axis=0)
        keep = (N, N)

        def build(k, o, v):
            return k.SquaredExponential.create(v, 3.0, **o)
    else:  # the walk-forward's composite: a covariate column, then time
        X = np.column_stack([rng.normal(size=N), np.sort(rng.uniform(0, 30, N))])
        keep = (N, 230)

        def build(k, o, v):
            return (k.Matern12.create(v, 1.5, active_dims=slice(0, 1), **o)
                    * k.Matern12.create(1.0, 6.0, active_dims=slice(1, 2), **o))
    Y = rng.normal(size=(N, 1))
    jm = _stack([jgpr.GPR.create(build(jk, {}, v), noise_variance=nz)
                 for v, nz in ((0.7, 0.1), (1.4, 0.25))], jnp.float64)
    jX, jY = jnp.asarray(X), jnp.asarray(Y)

    def jnll(m):
        if keep == (N, N):
            return jgpr.batched_neg_log_marginal_likelihood(m, jX, jY, fast=False)
        return jnp.stack([
            jgpr.neg_log_marginal_likelihood(jax.tree.map(lambda x: x[b], m), jX[:n], jY[:n])
            + 0.5 * (N - n) * tst.LOG2PI for b, n in enumerate(keep)])

    jval = jnll(jm)
    jgrad = jax.tree.leaves(jax.grad(lambda m: jnp.sum(jnll(m)))(jm))

    o = dict(device="cpu", dtype=torch.float64)
    tm = tparams.from_jax_leaves(tgpr.GPR.create(build(tk, o, 1.0)),
                                 [np.asarray(x) for x in jax.tree.leaves(jm)])
    tm = tparams.tree_map(lambda x: x.requires_grad_(True), tm)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    spec = tgpr.fused_stationary_spec(tm, tX)
    err = tgpr._err(tm, tX, tY)[:, :, 0]
    noise = tm.likelihood.variance
    if case == "se":
        assert spec.families == ("se",) and spec.dims == (1,)
        tval = tst.batched_nll_stationary(spec.d2s[0], err, spec.vs[0], spec.ls[0], noise, "se")
    else:
        assert spec.families == ("matern12", "matern12") and spec.combine == "prod"
        mask = (torch.arange(N)[None, :] < torch.tensor(keep)[:, None]).double()
        tval = tst.batched_nll_stationary_general(spec.families, spec.d2s, err * mask, spec.vs,
                                                  spec.ls, spec.als, noise, mask, dims=spec.dims)
    tval.sum().backward()
    np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval), rtol=1e-9)
    _assert_grads([x.grad.numpy() for x in tparams.tree_leaves(tm)], jgrad)


def test_torch_stationary_kernel_wrapper_raises_past_window(monkeypatch):
    """The kernel's wrapper refuses N = 513, one past MAX_FUSED_N, with a
    ValueError naming the window, before it loads (and builds) the library:
    the source has no kernel past 512."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(tst, "_lib", no_library)
    B, N = 2, tst.MAX_FUSED_N + 1
    z = torch.zeros
    with pytest.raises(ValueError, match="MAX_FUSED_N"):
        tst.stationary_nll_forward_cuda(("se",), "prod", (1,), z(1, N, N), z(B, N), z(1, B),
                                        z(1, B), z(1, B), z(B), None, False, "stationary_nll")


# -- the router ---------------------------------------------------------------

def _tier_cases():
    """(name, builder(kernel module, create kwargs), N, float32?)."""
    return [
        ("se", lambda k, o: k.SquaredExponential.create(1.0, 2.0, **o), 64, True),
        ("composite", lambda k, o: k.composite_kernel(3, **o), 64, True),
        ("sum", lambda k, o: k.SquaredExponential.create(**o) + k.Matern12.create(**o), 64, True),
        ("ard", lambda k, o: k.Matern32.create(1.0, [1.0, 2.0], **o), 64, True),
        ("f64", lambda k, o: k.SquaredExponential.create(**o), 64, False),
        ("nested", lambda k, o: (k.SquaredExponential.create(**o) + k.Matern12.create(**o))
         * k.Matern32.create(**o), 64, True),
        ("nested_600", lambda k, o: (k.SquaredExponential.create(**o) + k.Matern12.create(**o))
         * k.Matern32.create(**o), 600, True),
        ("se_2000", lambda k, o: k.SquaredExponential.create(**o), 2000, True),
    ]


def _stack(models, dtype):
    s = jax.tree.map(lambda *xs: jnp.stack(xs), *models)
    return jax.tree.map(lambda x: x.astype(dtype), s)


@pytest.mark.parametrize("case", _tier_cases(), ids=lambda c: c[0])
def test_torch_nll_tier_names_match_jax(case):
    name, build, n, f32 = case
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 5, (n, 2 if name == "ard" else 3))
    Y = rng.normal(size=(n, 1))
    jdt, tdt = (jnp.float32, torch.float32) if f32 else (jnp.float64, torch.float64)
    jm = _stack([jgpr.GPR.create(build(jk, {}), 0.1) for _ in range(2)], jdt)
    tm = tparams.from_jax_leaves(
        tgpr.GPR.create(build(tk, dict(device="cpu", dtype=tdt)), 0.1),
        [np.asarray(x) for x in jax.tree.leaves(jm)])
    want = jgpr.nll_tier(jm, jnp.asarray(X, jdt), jnp.asarray(Y, jdt))
    got = tgpr.nll_tier(tm, torch.as_tensor(X, dtype=tdt), torch.as_tensor(Y, dtype=tdt))
    assert got == want
    if got == "pallas_dense":
        # the dense tier against JAX's (its Pallas kernels in interpret mode),
        # values and gradients of every raw leaf, at tests/test_pallas_nll.py's
        # tolerances
        jX, jY = jnp.asarray(X, jdt), jnp.asarray(Y, jdt)
        jval, jgrad = jax.value_and_grad(lambda m: jnp.sum(
            jgpr.batched_neg_log_marginal_likelihood(m, jX, jY)))(jm)
        tm = tparams.tree_map(lambda x: x.requires_grad_(True), tm)
        tval = tgpr.batched_neg_log_marginal_likelihood(tm, X, Y, device="cpu", dtype=tdt)
        tval.sum().backward()
        assert tgpr.DISPATCH_EVENTS[-1]["tier"] == "pallas_dense"
        np.testing.assert_allclose(float(tval.detach().sum()), float(jval), rtol=2e-4)
        for g, w in zip(tparams.tree_leaves(tm), jax.tree.leaves(jgrad)):
            np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("kind", ["fused_stationary", "fused_general_prod", "fused_general_sum"])
def test_torch_router_fused_tiers_match_jax_xla(kind):
    """Port router on its fused tiers (float32, CPU → plain forward +
    closed-form backward) vs the JAX router's XLA tier in float32, values
    and gradients w.r.t. every raw leaf. Float32 tolerances as in the JAX
    package's own router checks (tools/smoke_tpu.py: rtol 3e-3, normalized
    2e-2); observed errors are far smaller."""
    builders = {
        "fused_stationary": lambda k, o, v: k.SquaredExponential.create(v, 3.0, **o),
        "fused_general_prod": lambda k, o, v: k.composite_kernel(3, **o),
        "fused_general_sum": lambda k, o, v: (k.SquaredExponential.create(v, 3.0, **o)
                                              + k.Matern12.create(0.5, 2.0, **o)),
    }
    rng = np.random.default_rng(4)
    N = 40
    X = np.sort(rng.uniform(0, 20, (N, 3)), axis=0).astype(np.float32)
    Y = rng.normal(size=(N, 1)).astype(np.float32)
    ms = [jgpr.GPR.create(builders[kind](jk, {}, v), noise_variance=0.1 * (1 + v))
          for v in (0.5, 1.0, 2.0)]
    jm = _stack(ms, jnp.float32)
    jX, jY = jnp.asarray(X), jnp.asarray(Y)
    jloss = lambda m: jnp.sum(jgpr.batched_neg_log_marginal_likelihood(m, jX, jY, fast=False))  # noqa: E731
    jval = jgpr.batched_neg_log_marginal_likelihood(jm, jX, jY, fast=False)
    jgrad = jax.tree.leaves(jax.grad(jloss)(jm))

    tm = tparams.from_jax_leaves(
        tgpr.GPR.create(builders[kind](tk, dict(device="cpu", dtype=torch.float32), 1.0)),
        [np.asarray(x) for x in jax.tree.leaves(jm)])
    tm = tparams.tree_map(lambda x: x.requires_grad_(True), tm)
    assert tgpr.nll_tier(tm, torch.as_tensor(X), torch.as_tensor(Y)) == kind
    tval = tgpr.batched_neg_log_marginal_likelihood(tm, X, Y, device="cpu")
    tval.sum().backward()
    assert tgpr.DISPATCH_EVENTS[-1]["tier"] == kind
    np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval), rtol=3e-3)
    _assert_grads([x.grad.numpy() for x in tparams.tree_leaves(tm)], jgrad, atol=2e-2)


def test_torch_walk_forward_dense_branch_raises():
    """Float32 with a kernel the fused tier cannot take: the walk-forward's
    dense branch (the masked system through the dense NLL, its plain version
    on the CPU) against JAX's, whose dense Pallas kernel runs in interpret
    mode, over 3 days × 2 restarts. The two L-BFGS runs take float32 steps
    from gradients that differ in the last digits, so the fit is held at
    float32 optimizer accuracy: losses rtol 1e-4, next-day means atol 2e-3,
    variances rtol 2e-2 (tests/test_torch_walk_forward.py's float32 limits)."""
    rng = np.random.default_rng(5)
    t = np.linspace(0, 4, 20)
    X = np.column_stack([np.sin(t) + 0.1 * rng.normal(size=20), t]).astype(np.float32)
    Y = (np.sin(t) + 0.1 * rng.normal(size=20))[:, None].astype(np.float32)
    o = dict(device="cpu", dtype=torch.float32)

    def tmodel(v):
        kern = (tk.SquaredExponential.create(**o) + tk.Matern12.create(**o)) * tk.Matern32.create(**o)
        return tgpr.GPR.create(kern, v)

    def jmodel(v):
        kern = (jk.SquaredExponential.create() + jk.Matern12.create()) * jk.Matern32.create()
        return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), jgpr.GPR.create(kern, v))

    kw = dict(restart_noise_inits=(1e-2, 1e-1), maxiter=30)
    jres = jax.jit(lambda X, Y: jwf.batched_walk_forward(X, Y, 17, jmodel, **kw))(
        jnp.asarray(X), jnp.asarray(Y))
    calls = []
    real = tnll.factor_solve

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    tnll.factor_solve = spy
    try:
        tres = twf.batched_walk_forward(X, Y, 17, tmodel, device="cpu", dtype=torch.float32,
                                        **kw)
    finally:
        tnll.factor_solve = real
    assert calls and all(c == (6, 20, 20) for c in calls)
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses), rtol=1e-4)
    np.testing.assert_allclose(tres.f_mean.numpy(), np.asarray(jres.f_mean), atol=2e-3)
    np.testing.assert_allclose(tres.f_var.numpy(), np.asarray(jres.f_var), rtol=2e-2)


def test_torch_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    m = tgpr.GPR.create(tk.SquaredExponential.create(device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        tgpr.batched_neg_log_marginal_likelihood(m, np.zeros((4, 1)), np.zeros((4, 1)))
    with pytest.raises(RuntimeError, match="cuda"):
        tk.SquaredExponential.create()
