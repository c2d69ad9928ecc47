"""The fused tiers' X-only operands (`gpr.fused_operands`), built once by a
caller that holds X fixed, give the same bits as operands built on every
evaluation: NLL values and the whole gradient tree, through the router,
the fused spec, the walk-forward's loss and the log-density closure,
compared with `torch.equal`."""

import pytest
import torch

from portfoliooptgp_tpu_torch import kernels
from portfoliooptgp_tpu_torch.inference import fused_logdensity
from portfoliooptgp_tpu_torch.kernels import stationary as st_kernels
from portfoliooptgp_tpu_torch.models import gpr
from portfoliooptgp_tpu_torch.models.gpr import GPR
from portfoliooptgp_tpu_torch.ops import stationary_nll as st_mod
from portfoliooptgp_tpu_torch.params import tree_leaves, tree_map, tree_replace
from portfoliooptgp_tpu_torch.pipelines import walk_forward as wf

torch.set_num_threads(1)

N_TRAIN, DAYS, RESTARTS = 26, 4, (1e-2, 1e-1)
N = N_TRAIN + DAYS


def _kernel(case, dtype, device="cpu"):
    o = dict(device=device, dtype=dtype)
    if case == "wf_expexp":  # the walk-forward's composite on column slices
        return kernels.composite_kernel(3, kernels.Exponential, kernels.Exponential, **o)
    if case == "ard_se4":  # the NUTS posterior's kernel
        return kernels.SquaredExponential.create(1.0, torch.tensor([0.8, 1.2, 1.0, 0.6]), **o)
    if case == "sum":
        return (kernels.SquaredExponential.create(1.0, 0.7, active_dims=slice(0, 2), **o)
                + kernels.Matern32.create(0.5, 1.3, active_dims=slice(2, 4), **o))
    if case == "periodic":
        return kernels.Periodic.create(kernels.SquaredExponential.create(1.0, 0.9, **o),
                                       period=0.4, active_dims=slice(3, 4), **o)
    if case == "linear":
        return (kernels.Linear.create(0.3, active_dims=(0, 2), **o)
                + kernels.SquaredExponential.create(1.0, 0.8, active_dims=slice(1, 4), **o))
    raise ValueError(case)


def _data(dtype, device="cpu", n=N, d=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(n, d, generator=g, dtype=torch.float64)
    Y = torch.sin(4.0 * X[:, :1]) + 0.1 * torch.randn(n, 1, generator=g, dtype=torch.float64)
    return X.to(device, dtype), Y.to(device, dtype)


def _stacked(model, B, seed=1):
    """B rows of `model`, each raw leaf moved off the start."""
    g = torch.Generator().manual_seed(seed)

    def spread(x):
        x = x.repeat((B,) + (1,) * (x.ndim - 1))
        return x + 0.2 * torch.rand(x.shape, generator=g, dtype=torch.float64).to(x)

    return tree_map(spread, model)


def _value_and_grads(fn, model):
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(model)]
    val = fn(tree_replace(model, leaves))
    grads = torch.autograd.grad(val.sum(), leaves)
    return [val.detach(), *grads]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (a, b)


def _wf_loss(case, dtype, X, Y):
    """The walk-forward's batched loss and its stacked start, as the call
    hands them to L-BFGS."""
    captured = {}
    real = wf.batched_lbfgs.fit_batched_fused

    def capture(loss, stacked, *a, **k):
        captured.update(loss=loss, stacked=stacked)
        return real(loss, stacked, *a, **k)

    def make_model(v):
        return GPR.create(_kernel(case, dtype), noise_variance=v)

    wf.batched_lbfgs.fit_batched_fused = capture
    try:
        wf.batched_walk_forward(X, Y, N_TRAIN, make_model, n_days=DAYS,
                                restart_noise_inits=RESTARTS, maxiter=1, device="cpu",
                                dtype=dtype)
    finally:
        wf.batched_lbfgs.fit_batched_fused = real
    return captured["loss"], captured["stacked"]


def _wf_loss_per_evaluation(ms, X, Y):
    """The walk-forward's loss with every operand built at the evaluation."""
    masks = (torch.arange(N)[None, :] < (N_TRAIN + torch.arange(DAYS))[:, None]).to(X.dtype)
    masks_dr = torch.repeat_interleave(masks, len(RESTARTS), dim=0)
    if X.dtype != torch.float32:
        return wf.masked_nll(ms, X, Y, masks_dr)
    n_eff_dr = torch.sum(masks_dr, dim=1)
    spec = gpr.fused_stationary_spec(ms, X)
    err = (Y[None, :, 0] - wf.mean_rows(ms, X, masks_dr.shape[0])) * masks_dr
    fused = (st_mod.batched_nll_stationary_sum if spec.combine == "sum"
             else st_mod.batched_nll_stationary_general)
    nll = fused(spec.families, spec.d2s, err, spec.vs, spec.ls, spec.als,
                ms.likelihood.variance, masks_dr, dims=spec.dims)
    return nll - 0.5 * (N - n_eff_dr) * wf.LOG_2PI


@pytest.mark.parametrize("route", ["router", "spec", "walk_forward", "logdensity"])
@pytest.mark.parametrize("case", ["wf_expexp", "ard_se4", "sum", "periodic", "linear"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_torch_prepared_operands_give_the_same_bits(dtype, case, route):
    X, Y = _data(dtype)
    model = _stacked(GPR.create(_kernel(case, dtype), noise_variance=0.1), 5)
    if route == "walk_forward":
        loss, start = _wf_loss(case, dtype, X, Y)
        model = _stacked(start, 1)
        got = _value_and_grads(loss, model)
        assert loss(model).shape == (DAYS * len(RESTARTS),)
        want = _value_and_grads(lambda m: _wf_loss_per_evaluation(m, X, Y), model)
        _assert_equal(got, want)
        _assert_equal(_value_and_grads(loss, model), want)  # the held operands again
        return
    operands = gpr.fused_operands(model, X)
    assert operands is not None and operands.d2_stack.shape[1:] == (N, N)
    if route == "router":
        def fresh(m):
            return gpr.batched_neg_log_marginal_likelihood(m, X, Y, device="cpu", dtype=dtype)

        def held(m):
            return gpr.batched_neg_log_marginal_likelihood(m, X, Y, device="cpu", dtype=dtype,
                                                           operands=operands)
    elif route == "spec":
        def run(m, ops):
            spec = gpr.fused_stationary_spec(m, X, operands=ops)
            err = gpr._err(m, X, Y)[:, :, 0]
            mask = torch.ones(err.shape, dtype=dtype)
            fn = (st_mod.batched_nll_stationary_sum_plain if spec.combine == "sum"
                  else st_mod.batched_nll_stationary_general_plain)
            d2s = spec.d2s if ops is None else spec.d2_stack
            return fn(spec.families, d2s, err, spec.vs, spec.ls, spec.als,
                      m.likelihood.variance, mask, dims=spec.dims)

        def fresh(m):
            return run(m, None)

        def held(m):
            return run(m, operands)
    else:
        vg = fused_logdensity.gpr_logdensity_vg(X, Y)

        def fresh(m):
            return -gpr.batched_neg_log_marginal_likelihood(m, X, Y, device="cpu", dtype=dtype)

        def held(m):
            lp, grads = vg(m)
            held.grads = tree_leaves(grads)
            return lp

        want = _value_and_grads(fresh, model)
        for _ in range(2):  # the closure's first call builds, the second reuses
            lp = held(model)
            _assert_equal([lp, *held.grads], want)
        return
    want = _value_and_grads(fresh, model)
    _assert_equal(_value_and_grads(held, model), want)
    _assert_equal(_value_and_grads(held, model), want)


def test_torch_nll_tier_builds_no_distance_matrix(monkeypatch):
    """Choosing a tier reads the kernel's structure and builds no tensor
    from X; the router then builds the fused operands once a call."""
    calls = []
    real = st_kernels.scaled_squared_distance

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(st_kernels, "scaled_squared_distance", counted)
    X, Y = _data(torch.float32)
    model = _stacked(GPR.create(_kernel("ard_se4", torch.float32), noise_variance=0.1), 3)
    assert gpr.nll_tier(model, X, Y) == "fused_general_prod"
    X_big, Y_big = _data(torch.float32, n=768, seed=2)
    assert gpr.nll_tier(model, X_big, Y_big) == "blocked"
    assert calls == []
    gpr.batched_neg_log_marginal_likelihood(model, X, Y, device="cpu", dtype=torch.float32)
    assert len(calls) == 4  # one ARD atom of 4 dims, built once, not twice
    structure = gpr.fused_structure(model.kernel, 4)
    assert structure.families == ("se",) and structure.dims == (4,)
    assert structure.atoms == (("ard", None),)
    assert gpr.fused_operands(model, X_big) is None  # past the fused window


def test_torch_held_operands_that_do_not_fit_are_refused():
    X, _ = _data(torch.float32)
    se = _stacked(GPR.create(_kernel("ard_se4", torch.float32), noise_variance=0.1), 2)
    other = _stacked(GPR.create(_kernel("sum", torch.float32), noise_variance=0.1), 2)
    with pytest.raises(ValueError, match="another kernel structure"):
        gpr.fused_stationary_spec(other, X, operands=gpr.fused_operands(se, X))
    with pytest.raises(ValueError, match="another kernel structure"):
        gpr.fused_stationary_spec(se, X[:-1], operands=gpr.fused_operands(se, X))


def test_torch_logdensity_closure_rebuilds_on_a_new_structure_or_a_differentiable_x(
        monkeypatch):
    builds = []
    real = gpr._build_operands

    def counted(*a, **k):
        builds.append(1)
        return real(*a, **k)

    monkeypatch.setattr(gpr, "_build_operands", counted)
    X, Y = _data(torch.float32)
    se = _stacked(GPR.create(_kernel("ard_se4", torch.float32), noise_variance=0.1), 3)
    mat = _stacked(GPR.create(kernels.Matern52.create(1.0, torch.tensor([1.0] * 4),
                                                      device="cpu", dtype=torch.float32),
                              noise_variance=0.1), 3)
    vg = fused_logdensity.gpr_logdensity_vg(X, Y)
    for _ in range(3):
        vg(se)
    assert len(builds) == 1
    lp_mat, _ = vg(mat)  # another family: another structure
    assert len(builds) == 2
    vg(se)
    assert len(builds) == 3
    want = -gpr.batched_neg_log_marginal_likelihood(mat, X, Y, device="cpu",
                                                    dtype=torch.float32)
    assert torch.equal(lp_mat, want.detach())

    Xg = X.clone().requires_grad_(True)
    vg_x = fused_logdensity.gpr_logdensity_vg(Xg, Y)
    builds.clear()
    for _ in range(3):
        lp, _ = vg_x(se)
    assert len(builds) == 3  # one a call: a differentiable X is never held
    lp_ref, _ = vg(se)
    assert torch.equal(lp, lp_ref)


@pytest.mark.cuda
def test_torch_prepared_operands_give_the_same_bits_on_the_cluster_kernel():
    """(8, 512), the NUTS posterior's ARD SE: one launch of the cluster
    kernel with W each way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    X, Y = _data(torch.float32, device=dev, n=512, seed=3)
    model = _stacked(GPR.create(_kernel("ard_se4", torch.float32, device=dev),
                                noise_variance=0.1), 8)
    operands = gpr.fused_operands(model, X)
    before = st_mod.LAUNCHES["stationary_nll_general"]

    def nll(ops):
        return lambda m: gpr.batched_neg_log_marginal_likelihood(
            m, X, Y, device=dev, dtype=torch.float32, operands=ops)

    want = _value_and_grads(nll(None), model)
    _assert_equal(_value_and_grads(nll(operands), model), want)
    assert st_mod.LAUNCHES["stationary_nll_general"] == before + 2
    assert gpr.DISPATCH_EVENTS[-1] == {"tier": "fused_general_prod", "n": 512, "batch": 8}
