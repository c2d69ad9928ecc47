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
from portfoliooptgp_tpu.ops.pallas import blocked_nll as jbn
from portfoliooptgp_tpu.params import positive as j_positive
from portfoliooptgp_tpu.pipelines import MultiInputGPR as JMultiInputGPR
from portfoliooptgp_tpu.pipelines import walk_forward as jwf
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.models import gpr as tgpr
from portfoliooptgp_tpu_torch.ops import blocked_nll as tblocked
from portfoliooptgp_tpu_torch.ops import stationary_nll as tst
from portfoliooptgp_tpu_torch.pipelines import MultiInputGPR as TMultiInputGPR
from portfoliooptgp_tpu_torch.pipelines import walk_forward as twf
from portfoliooptgp_tpu_torch.train import batched_lbfgs as tbatched

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


def _long_models(case, o, jdtype):
    """make_model of WALK_LONG_CASES[case]'s kernel for each package."""
    kernel = cs.WALK_LONG_CASES[case][3]
    return (lambda v: tgpr.GPR.create(cs.walk_long_kernel(tk, kernel, **o), v),
            lambda v: jax.tree.map(lambda x: x.astype(jdtype),
                                   jgpr.GPR.create(cs.walk_long_kernel(jk, kernel), v)))


def _long_tier(case):
    return "batched_nll_hinv" if case.startswith("hinv") else "batched_nll_blocked"


def _spy_tiers(monkeypatch):
    """Record the calls of ops/blocked_nll's two tier functions, by name
    and shape (the walk-forward picks its tier function there when it is
    called)."""
    calls = []
    for name in ("batched_nll_blocked", "batched_nll_hinv"):
        def spy(K, y, noise, real=getattr(tblocked, name), name=name):
            calls.append((name, tuple(K.shape)))
            return real(K, y, noise)

        monkeypatch.setattr(tblocked, name, spy)
    return calls


@pytest.fixture(scope="module")
def walk_long_goldens():
    with open(cs.WALK_LONG_GOLDENS) as fh:
        return json.load(fh)["cases"]


LONG_LOSS_RTOL = 2e-3  # the float32 large-N branches' losses, against float64
LONG_VAR_RTOL = 0.15  # ... and their next-day variances


@pytest.mark.parametrize("case", list(cs.WALK_LONG_CASES))
def test_torch_walk_forward_float32_blocked_tiers_match_jax(case, monkeypatch,
                                                             walk_long_goldens):
    """Float32 past the fused and dense windows: the walk-forward trains on
    the masked system through the blocked tier (the panel factor's plain
    version on the CPU) or the hinv tier (the triangular inverse's); JAX's
    run (tests/goldens_torch/walk_forward_long.json, its Pallas kernels in
    interpret mode) takes the same tier. 3 days, 30 L-BFGS iterations:
    after 3 the float32 runs of either package still part from float64 by
    rounding-driven line-search steps. Each output lies within F32_SPREAD
    times JAX's own float32-to-float64 spread of JAX's float32 one (at
    least F32_FLOOR). JAX's float32 run ends far from float64 at N = 560
    and 1100 (ROADMAP.md queue 3: its jitted float32 gradient in a
    lengthscale blows up and its L-BFGS stops), which widens those limits
    to no use there, so every output is also held to JAX's float64 run:
    the next-day means at the fused branch's float32 tolerance (rtol 2e-2,
    atol 2e-3, as in test_torch_walk_forward_float32_takes_fused_branch),
    the losses within LONG_LOSS_RTOL and the variances within
    LONG_VAR_RTOL of it (the port's float32 lay at most 8.0e-4 and 6.4e-2
    off, relative, in the three cases)."""
    n, seed, span, _ = cs.WALK_LONG_CASES[case]
    X, Y = cs.long_series(n, seed, span)
    calls = _spy_tiers(monkeypatch)
    o32 = dict(device="cpu", dtype=torch.float32)
    tres = twf.batched_walk_forward(X, Y, n - 3, _long_models(case, o32, jnp.float32)[0], **o32,
                                    **cs.WALK_LONG_KW)
    assert calls and all(c == (_long_tier(case), (3, n, n)) for c in calls)
    golden = walk_long_goldens[case]
    for name in ("losses", "f_mean", "f_var"):
        got = getattr(tres, name).double().numpy()
        want, ref64 = (np.asarray(golden[p][name]) for p in ("f32", "f64"))
        scale = np.max(np.abs(ref64))
        spread = np.max(np.abs(want - ref64)) / scale
        err = np.max(np.abs(got - want)) / scale
        assert err <= max(F32_SPREAD * spread, F32_FLOOR), (name, err, spread)
    np.testing.assert_allclose(tres.f_mean.double().numpy(), golden["f64"]["f_mean"],
                               rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(tres.losses.double().numpy(), golden["f64"]["losses"],
                               rtol=LONG_LOSS_RTOL)
    np.testing.assert_allclose(tres.f_var.double().numpy(), golden["f64"]["f_var"],
                               rtol=LONG_VAR_RTOL)


@pytest.mark.parametrize("case", list(cs.WALK_LONG_CASES))
def test_torch_walk_forward_blocked_tier_loss_value_and_grad(case, monkeypatch):
    """Each large-N branch's batched loss (the masked system through the
    blocked or hinv tier at zero added noise, the 2π constant restated for
    each day's rows) in float32 at fixed parameters: three days, noise 0.1
    (the conditioning of JAX's own check) and raw leaves 0.1 apart. Its
    value and gradient in every raw leaf against the JAX walk-forward's
    float32 branch at the same leaves (its masked system through the same
    tier, the Pallas kernels in interpret mode), at the rtol 3e-4 of JAX's
    own check of that branch
    (tests/test_walk_forward.py::test_masked_system_through_blocked_tiers),
    gradients within 3e-4 of their largest entry. (Against float64 the
    float32 values lie up to 5e-3 off here, in either package: K itself is
    built in float32, and the systems' condition numbers reach ~3e3.)"""
    n, seed, span, _ = cs.WALK_LONG_CASES[case]
    X, Y = cs.long_series(n, seed, span)
    calls = _spy_tiers(monkeypatch)
    captured = {}

    def capture(loss, stacked, **kw):
        captured.update(loss=loss, stacked=stacked)
        raise StopIteration

    monkeypatch.setattr(tbatched, "fit_batched_fused", capture)
    o32 = dict(device="cpu", dtype=torch.float32)
    tmake, _ = _long_models(case, o32, jnp.float32)
    with pytest.raises(StopIteration):
        twf.batched_walk_forward(X, Y, n - 3, tmake, restart_noise_inits=(0.1,), **o32,
                                 **cs.WALK_LONG_KW)
    leaves = [(x + 0.1 * torch.arange(3, dtype=x.dtype).reshape(-1, *[1] * (x.ndim - 1)))
              .requires_grad_(True) for x in tparams.tree_leaves(captured["stacked"])]
    value = captured["loss"](tparams.tree_replace(captured["stacked"], leaves))
    grads = torch.autograd.grad(value.sum(), leaves)
    assert calls == [(_long_tier(case), (3, n, n))]

    jm = _long_models(case, CPU64, jnp.float32)[1](0.1)
    jstack = jax.tree.unflatten(jax.tree.structure(jm),
                                [jnp.asarray(x.detach().numpy()) for x in leaves])
    masks = jnp.asarray(np.arange(n)[None, :] < (n - 3 + np.arange(3))[:, None], jnp.float32)
    jX, jY = jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32)

    tier_fn = getattr(jbn, _long_tier(case))

    def jloss(stack):
        Kb, errb = jax.vmap(lambda m, k: jwf.masked_system(m, jX, jY, k))(stack, masks)
        nll = tier_fn(Kb, errb[:, :, 0], jnp.zeros((3,), jnp.float32))
        return nll - 0.5 * (n - jnp.sum(masks, axis=1)) * jnp.log(2.0 * jnp.pi)

    jvalue, jvjp = jax.vjp(jloss, jstack)
    (jgrads,) = jvjp(jnp.ones(3, jnp.float32))
    np.testing.assert_allclose(value.detach().double().numpy(), np.asarray(jvalue), rtol=3e-4)
    for got, want in zip(grads, jax.tree.leaves(jgrads)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.double().numpy(), want, rtol=3e-4,
                                   atol=3e-4 * np.max(np.abs(want)))
