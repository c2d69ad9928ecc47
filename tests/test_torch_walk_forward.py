"""Port parity: the batched walk-forward and step 4 vs the JAX package.

Float64 on CPU, where both packages take the plain masked NLL. The port's
batched L-BFGS is a rule-for-rule port: losses agree to rtol 1e-8, while
hyperparameters and next-day moments agree to rtol 1e-4 — both runs stop
at the optimizer's ftol, and rounding-level differences in the gradients
move the last accepted steps by ~1e-5 relative. Hyperparameters are
compared constrained: a raw value pinned at the positive floor (softplus
of ~-27) is flat and undetermined. The float32 test drives the
fused-kernel branch (its plain version on CPU) and holds it to the
float64 result at float32 accuracy."""

import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from benchmarks.bench_portfolio_e2e import ASSETS, DATES, FEATURES, make_market
from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.models import gpr as jgpr
from portfoliooptgp_tpu.params import positive as j_positive
from portfoliooptgp_tpu.pipelines import MultiInputGPR as JMultiInputGPR
from portfoliooptgp_tpu.pipelines import walk_forward as jwf
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.models import gpr as tgpr
from portfoliooptgp_tpu_torch.ops import stationary_nll as tst
from portfoliooptgp_tpu_torch.pipelines import MultiInputGPR as TMultiInputGPR
from portfoliooptgp_tpu_torch.pipelines import walk_forward as twf

# tiny matrices: one intra-op thread per test worker avoids oversubscribing the
# CPU when pytest-xdist runs several workers
torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64)


def _series(n=40, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 8, n)
    X = np.column_stack([np.sin(t) + 0.1 * rng.normal(size=n), t])
    Y = (np.sin(t) + 0.08 * rng.normal(size=n))[:, None]
    return X, Y


def test_torch_masked_system_nll_predict_match_jax():
    X, Y = _series()
    jms = [jgpr.GPR.create(jk.composite_kernel(2, jk.Matern32, jk.SquaredExponential), v)
           for v in (0.05, 0.1, 0.2)]
    jms = [jax.tree.map(lambda x, i=i: x + 0.1 * i, m) for i, m in enumerate(jms)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jms)
    tm = tparams.from_jax_leaves(
        tgpr.GPR.create(tk.composite_kernel(2, tk.Matern32, tk.SquaredExponential, **CPU64)),
        [np.asarray(x) for x in jax.tree.leaves(jstack)])
    masks = (np.arange(40)[None, :] < np.array([25, 33, 40])[:, None]).astype(float)
    nxt = np.array([25, 33, 39])
    jX, jY = jnp.asarray(X), jnp.asarray(Y)
    tX, tY, tmask = torch.as_tensor(X), torch.as_tensor(Y), torch.as_tensor(masks)

    Ks, err = twf.masked_system(tm, tX, tY, tmask)
    jKs, jerr = jax.vmap(lambda m, k: jwf.masked_system(m, jX, jY, k))(jstack, jnp.asarray(masks))
    np.testing.assert_allclose(Ks.numpy(), np.asarray(jKs), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=1e-12, atol=1e-15)

    nll = twf.masked_nll(tm, tX, tY, tmask)
    jnll = jax.vmap(lambda m, k: jwf.masked_nll(m, jX, jY, k))(jstack, jnp.asarray(masks))
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), rtol=1e-10)

    mean, var = twf.masked_predict_next(tm, tX, tY, tmask, torch.as_tensor(nxt))
    jmean, jvar = jax.vmap(lambda m, k, i: jwf.masked_predict_next(m, jX, jY, k, i))(
        jstack, jnp.asarray(masks), jnp.asarray(nxt))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-8, atol=1e-12)


def _jitted_walk_forward(X, Y, n_train, make_model, **kw):
    """The JAX walk-forward compiled as one program: the same computation
    as its eager call, and seconds instead of tens of seconds to compile."""
    return jax.jit(lambda X, Y: _JAX_WALK_FORWARD(X, Y, n_train, make_model, **kw))(X, Y)


_JAX_WALK_FORWARD = jwf.batched_walk_forward


def test_torch_batched_walk_forward_matches_jax():
    """4 days × 2 restarts on a 40-row series, composite kernel."""
    X, Y = _series()
    kw = dict(restart_noise_inits=(1e-3, 1e-1), maxiter=100)
    jres = _jitted_walk_forward(
        jnp.asarray(X), jnp.asarray(Y), 36,
        lambda v: jgpr.GPR.create(jk.composite_kernel(2), v), **kw)
    tres = twf.batched_walk_forward(
        X, Y, 36, lambda v: tgpr.GPR.create(tk.composite_kernel(2, **CPU64), v),
        device="cpu", dtype=torch.float64, **kw)
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses), rtol=1e-8)
    np.testing.assert_allclose(tres.f_mean.numpy(), np.asarray(jres.f_mean), rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(tres.f_var.numpy(), np.asarray(jres.f_var), rtol=1e-4, atol=1e-12)
    for got, want in zip(tparams.tree_leaves(tres.models), jax.tree.leaves(jres.models)):
        np.testing.assert_allclose(tparams.positive(got).numpy(),
                                   np.asarray(j_positive(want)), rtol=1e-4, atol=1e-9)


def test_torch_walk_forward_float32_takes_fused_branch(monkeypatch):
    """Float32: the loss goes through the fused NLL wrapper (plain version
    on CPU), and lands on the float64 answer at float32 accuracy."""
    X, Y = _series(seed=1)
    calls = []
    real = tst.stationary_nll_forward

    def spy(*args):
        calls.append(args[0])
        return real(*args)

    monkeypatch.setattr(tst, "stationary_nll_forward", spy)
    res = {}
    for dtype in (torch.float32, torch.float64):
        o = dict(device="cpu", dtype=dtype)
        res[dtype] = twf.batched_walk_forward(
            X, Y, 37, lambda v, o=o: tgpr.GPR.create(tk.composite_kernel(2, **o), v),
            maxiter=100, **o)
        if dtype == torch.float32:
            assert calls and all(c == ("matern12", "matern12") for c in calls)
            n32 = len(calls)
    assert len(calls) == n32  # float64 takes the plain masked NLL
    np.testing.assert_allclose(res[torch.float32].f_mean.numpy(),
                               res[torch.float64].f_mean.numpy(), rtol=2e-2, atol=2e-3)


# A mean function other than Zero returns (B, N, 1), a row per model; Zero
# returns (N, 1). Each case: the port's mean and the JAX package's, built
# from the same numbers.
MEANS = {
    "constant": (lambda o: tk.ConstantMean.create(1.5, **o),
                 lambda: jk.ConstantMean.create(1.5)),
    "linear": (lambda o: tk.LinearMean.create(A=[0.3, -0.2], b=0.5, **o),
               lambda: jk.LinearMean.create(A=np.array([[0.3], [-0.2]]), b=0.5)),
    "polynomial": (lambda o: tk.PolynomialMean.create(2, w=[0.5, 0.2, -0.05], **o),
                   lambda: jk.PolynomialMean.create(2, w=np.array([0.5, 0.2, -0.05]))),
}


def _mean_models(mean, o, jdtype=jnp.float64):
    """make_model for each package: composite_kernel(2, Matern32,
    SquaredExponential) with the given mean, at the given precision."""
    tmean, jmean = MEANS[mean]
    return (lambda v: tgpr.GPR.create(
                tk.composite_kernel(2, tk.Matern32, tk.SquaredExponential, **o), v,
                mean_function=tmean(o)),
            lambda v: jax.tree.map(lambda x: x.astype(jdtype), jgpr.GPR.create(
                jk.composite_kernel(2, jk.Matern32, jk.SquaredExponential), v,
                mean_function=jmean())))


@pytest.mark.parametrize("mean", list(MEANS))
def test_torch_masked_predict_next_with_mean_matches_jax(mean):
    """Three stacked models with a non-Zero mean, float64: the masked
    system, NLL and next-row prediction against JAX's under vmap, at the
    tolerances of the Zero-mean test above."""
    X, Y = _series()
    tmake, jmake = _mean_models(mean, CPU64)
    jms = [jax.tree.map(lambda x, i=i: x + 0.1 * i, jmake(v))
           for i, v in enumerate((0.05, 0.1, 0.2))]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jms)
    tm = tparams.from_jax_leaves(tmake(1.0), [np.asarray(x) for x in jax.tree.leaves(jstack)])
    masks = (np.arange(40)[None, :] < np.array([25, 33, 39])[:, None]).astype(float)
    nxt = np.array([25, 33, 39])
    jX, jY, jmasks = jnp.asarray(X), jnp.asarray(Y), jnp.asarray(masks)
    tX, tY, tmask = torch.as_tensor(X), torch.as_tensor(Y), torch.as_tensor(masks)

    _, err = twf.masked_system(tm, tX, tY, tmask)
    _, jerr = jax.vmap(lambda m, k: jwf.masked_system(m, jX, jY, k))(jstack, jmasks)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=1e-12, atol=1e-15)
    nll = twf.masked_nll(tm, tX, tY, tmask)
    jnll = jax.vmap(lambda m, k: jwf.masked_nll(m, jX, jY, k))(jstack, jmasks)
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), rtol=1e-10)
    mean_, var = twf.masked_predict_next(tm, tX, tY, tmask, torch.as_tensor(nxt))
    jmean, jvar = jax.vmap(lambda m, k, i: jwf.masked_predict_next(m, jX, jY, k, i))(
        jstack, jmasks, jnp.asarray(nxt))
    np.testing.assert_allclose(mean_.numpy(), np.asarray(jmean), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("mean", list(MEANS))
def test_torch_batched_walk_forward_with_mean_matches_jax(mean):
    """The walk-forward with a non-Zero mean, float64: 40 rows, 30 training
    rows, 3 days, 5 L-BFGS iterations; the mean's leaves train with the
    rest. Losses rtol 1e-8, next-day moments rtol 1e-4, as in the cold
    test above."""
    X, Y = _series()
    tmake, jmake = _mean_models(mean, CPU64)
    kw = dict(n_days=3, maxiter=5)
    jres = _jitted_walk_forward(jnp.asarray(X), jnp.asarray(Y), 30, jmake, **kw)
    tres = twf.batched_walk_forward(X, Y, 30, tmake, **CPU64, **kw)
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses), rtol=1e-8)
    np.testing.assert_allclose(tres.f_mean.numpy(), np.asarray(jres.f_mean), rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(tres.f_var.numpy(), np.asarray(jres.f_var), rtol=1e-4, atol=1e-12)


# The float32 walk-forward with a non-Zero mean against JAX's float32 run.
# Five float32 L-BFGS iterations stop where rounding takes them: JAX's own
# float32 run lies up to 1.7e-2 (of the largest value) from its float64
# run in the next-day means of the polynomial case, 3e-3 in the constant
# case. The port's float32 run is another sample of that rounding, so each
# of its outputs is held to JAX's float32 one within F32_SPREAD times JAX's
# own float32-to-float64 distance of that output, the rule of
# chip_smoke.MI_SPREAD, and never closer than F32_FLOOR (about a hundred
# float32 roundings of values of order one).
F32_SPREAD = 4.0
F32_FLOOR = 1e-5


@pytest.mark.parametrize("mean", list(MEANS))
def test_torch_walk_forward_float32_fused_with_mean_matches_jax(mean, monkeypatch):
    """Float32 with a non-Zero mean takes the fused branch (its plain
    version on the CPU; JAX's Pallas kernel in interpret mode) and lands on
    JAX's float32 result within F32_SPREAD times JAX's own float32 spread."""
    X, Y = _series()
    calls = []
    real = tst.stationary_nll_forward

    def spy(*args):
        calls.append(args[0])
        return real(*args)

    monkeypatch.setattr(tst, "stationary_nll_forward", spy)
    kw = dict(n_days=3, maxiter=5)
    o32 = dict(device="cpu", dtype=torch.float32)
    tmake, jmake32 = _mean_models(mean, o32, jnp.float32)
    tres = twf.batched_walk_forward(X, Y, 30, tmake, **o32, **kw)
    assert calls and all(c == ("matern32", "se") for c in calls)
    j32 = _jitted_walk_forward(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32), 30,
                               jmake32, **kw)
    j64 = _jitted_walk_forward(jnp.asarray(X), jnp.asarray(Y), 30,
                               _mean_models(mean, CPU64)[1], **kw)
    for name in ("losses", "f_mean", "f_var"):
        got = getattr(tres, name).double().numpy()
        want, ref64 = (np.asarray(getattr(r, name), dtype=np.float64) for r in (j32, j64))
        scale = np.max(np.abs(ref64))
        spread = np.max(np.abs(want - ref64)) / scale
        err = np.max(np.abs(got - want)) / scale
        assert err <= max(F32_SPREAD * spread, F32_FLOOR), (name, err, spread)


@pytest.fixture(scope="module")
def market():
    with tempfile.TemporaryDirectory() as root:
        make_market(root)
        yield root


def test_torch_run_step_4_matches_jax_one_asset(market, monkeypatch):
    """One asset of the flagship workflow, float64: covariate gating, the
    batched walk-forward and the de-normalized next-day moments."""
    monkeypatch.setattr(jwf, "batched_walk_forward", _jitted_walk_forward)
    kw = dict(ticker=ASSETS[0], features=FEATURES, data_root=market, threshold=0.30,
              removal_percentage=0.2, maxiter=200, isFixedLikelihood=True, **DATES)
    jp = JMultiInputGPR(**kw).run_step_4()
    tp = TMultiInputGPR(**kw, **CPU64).run_step_4()
    np.testing.assert_allclose(tp.f_mean, np.asarray(jp.f_mean), rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(tp.f_var, np.asarray(jp.f_var), rtol=1e-4, atol=1e-12)
    # the JAX package may parse the CSVs with its C++ reader: last-digit
    # differences from pandas' float parser
    np.testing.assert_allclose(tp.actual, np.asarray(jp.actual), rtol=1e-12)
    np.testing.assert_allclose(tp.Y_train, np.asarray(jp.Y_train), rtol=1e-12, atol=1e-14)


def test_torch_run_arima_and_sequential_step_4(market):
    """ARIMA against JAX, and the literal day-by-day step 4 with the
    Polynomial pair on the CPU's plain branch against the JAX package's
    float64 run (tests/goldens_torch/multi_input_poly.json, case
    step4/poly/fixed; JAX's fast branch, which in float64 takes the same
    loss and optimizer for a fixed likelihood): rtol 1e-4 as above."""
    kw = dict(ticker=ASSETS[1], features=FEATURES, data_root=market, **DATES)
    tp = TMultiInputGPR(**kw, **CPU64)
    got = tp.run_arima()
    want = JMultiInputGPR(**kw).run_arima()
    np.testing.assert_allclose(got["forecast"], want["forecast"], rtol=1e-12)
    with open(cs.multi_input_goldens_path()) as fh:
        golden = json.load(fh)["cases"]["step4/poly/fixed"]
    seq = TMultiInputGPR(ticker=cs.MULTI_INPUT_TICKER, features=FEATURES, data_root=market,
                         maxiter=cs.MULTI_INPUT_MAXITER, removal_percentage=0.2,
                         kernel_pairs=cs.multi_input_pairs()["poly"], **DATES,
                         **CPU64).run_step_4(batched=False)
    np.testing.assert_allclose(seq.f_mean, golden["f_mean"], rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(seq.f_var, golden["f_var"], rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(seq.actual, golden["actual"], rtol=1e-12)


def test_torch_walk_forward_warm_start_matches_jax():
    """warm_start: day 0's restarts trained to convergence, then every day
    polished from them (warm_maxiter default max(maxiter // 4, 10)); 4 days
    × 2 restarts, float64. The polish stops at its 15-iteration cap short of
    convergence, where the two L-BFGS implementations part at rounding
    level, so the losses are held at rtol 1e-6, the repo's tolerance for
    L-BFGS-trained losses; the means and variances as in the cold test."""
    X, Y = _series(seed=2)
    kw = dict(restart_noise_inits=(1e-3, 1e-1), maxiter=60, warm_start=True)
    jres = _jitted_walk_forward(
        jnp.asarray(X), jnp.asarray(Y), 36,
        lambda v: jgpr.GPR.create(jk.composite_kernel(2), v), **kw)
    tres = twf.batched_walk_forward(
        X, Y, 36, lambda v: tgpr.GPR.create(tk.composite_kernel(2, **CPU64), v),
        device="cpu", dtype=torch.float64, **kw)
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses), rtol=1e-6)
    np.testing.assert_allclose(tres.f_mean.numpy(), np.asarray(jres.f_mean), rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(tres.f_var.numpy(), np.asarray(jres.f_var), rtol=1e-4, atol=1e-12)


def test_torch_walk_forward_blocked_branch_raises():
    """Float32 with 512 < padded N ≤ 1024 and a kernel the fused tier
    cannot take: the walk-forward's blocked branch raises, naming its
    ROADMAP.md item, before any training."""
    n = 560
    rng = np.random.default_rng(6)
    t = np.linspace(0, 20, n)
    X = np.column_stack([np.sin(t) + 0.1 * rng.normal(size=n), t])
    Y = (np.sin(t) + 0.08 * rng.normal(size=n))[:, None]
    o = dict(device="cpu", dtype=torch.float32)

    def make_model(v):
        kern = (tk.SquaredExponential.create(**o) + tk.Matern12.create(**o)) * tk.Matern32.create(**o)
        return tgpr.GPR.create(kern, v)

    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1: the walk-forward's "
                       "float32 blocked and blocked_hinv branches"):
        twf.batched_walk_forward(X, Y, n - 2, make_model, maxiter=3,
                                 device="cpu", dtype=torch.float32)


def test_torch_walk_forward_hinv_branch_raises():
    """Float32 with 1024 < padded N ≤ 4096 and a kernel the fused tier
    cannot take: the walk-forward's blocked_hinv branch raises, naming its
    ROADMAP.md item, though the hinv tier itself is ported."""
    n = 1100
    rng = np.random.default_rng(7)
    t = np.linspace(0, 40, n)
    X = np.column_stack([np.sin(t) + 0.1 * rng.normal(size=n), t])
    Y = (np.sin(t) + 0.08 * rng.normal(size=n))[:, None]
    o = dict(device="cpu", dtype=torch.float32)

    def make_model(v):
        kern = (tk.SquaredExponential.create(**o) + tk.Matern12.create(**o)) * tk.Matern32.create(**o)
        return tgpr.GPR.create(kern, v)

    with pytest.raises(NotImplementedError,
                       match="blocked_hinv branch.*queue 1: the walk-forward's float32"):
        twf.batched_walk_forward(X, Y, n - 2, make_model, maxiter=3,
                                 device="cpu", dtype=torch.float32)
