"""The port's spans (utils/profiling.py): nothing is recorded without a
profiler; under one, the optimizer's and the sampler's spans count exactly
the evaluations they wrap, self times exclude the spans opened inside on
the same thread and only those, and every span is a range of the profiler's
own trace."""

import threading
import time

import pytest
import torch

from portfoliooptgp_tpu_torch import kernels
from portfoliooptgp_tpu_torch.inference import nuts
from portfoliooptgp_tpu_torch.inference.fused_logdensity import gpr_logdensity_vg
from portfoliooptgp_tpu_torch.inference.source import GeneratorSource
from portfoliooptgp_tpu_torch.models import gpr
from portfoliooptgp_tpu_torch.models.gpr import GPR
from portfoliooptgp_tpu_torch.params import ravel, unravel
from portfoliooptgp_tpu_torch.train import batched_lbfgs
from portfoliooptgp_tpu_torch.utils import profiling

torch.set_num_threads(1)

LBFGS = ("lbfgs.iteration", "lbfgs.value", "lbfgs.gradient", "lbfgs.sync")


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _host_names(prof):
    return {e.name() for e in prof.profiler.kineto_results.events()}


def _quadratic(calls):
    """A counting batched loss (4 rows of 3) with a minimum off the start."""
    g = torch.Generator().manual_seed(0)
    A = torch.randn(4, 3, 3, dtype=torch.float64, generator=g)
    A = A @ A.transpose(-1, -2) + torch.eye(3, dtype=torch.float64)

    def loss(Z):
        calls.append(Z.shape)
        return 0.5 * torch.einsum("bi,bij,bj->b", Z, A, Z) + torch.sum(torch.cos(Z), dim=-1)

    return loss, torch.ones(4, 3, dtype=torch.float64)


def test_torch_spans_record_nothing_without_a_profiler():
    profiling.reset_spans()
    calls = []
    loss, Z0 = _quadratic(calls)
    res = batched_lbfgs.fit_matrix(loss, Z0, maxiter=30)
    assert res.iters > 0 and calls
    assert profiling.SPANS == {}
    assert profiling.span("lbfgs.value") is profiling.span("nuts.leaf")  # one shared null


def test_torch_fit_matrix_spans_count_its_evaluations():
    profiling.reset_spans()
    calls = []
    loss, Z0 = _quadratic(calls)
    with _profiled() as prof:
        res = batched_lbfgs.fit_matrix(loss, Z0, maxiter=30)
    spans = dict(profiling.SPANS)
    assert set(spans) == set(LBFGS)
    assert spans["lbfgs.iteration"][0] == res.iters > 1
    assert spans["lbfgs.value"][0] + spans["lbfgs.gradient"][0] == len(calls)
    assert spans["lbfgs.gradient"][0] == res.iters + 1  # one an iteration and the start's
    for count, total, self_ns in spans.values():
        assert count > 0 and 0 < self_ns <= total
    # an iteration's children are its trials, its gradient and its syncs:
    # its self time leaves their time out, and no more than theirs
    it_total, it_self = spans["lbfgs.iteration"][1:]
    children = sum(spans[k][1] for k in LBFGS[1:])
    assert 0 < it_total - it_self <= children
    assert set(LBFGS) <= _host_names(prof)
    table = profiling.spans_table()
    assert table["lbfgs.value"]["count"] == spans["lbfgs.value"][0]
    assert table["lbfgs.value"]["total_ms"] == pytest.approx(spans["lbfgs.value"][1] * 1e-6)


def test_torch_span_self_time_excludes_its_children_exactly():
    profiling.reset_spans()
    with _profiled() as prof:
        with profiling.span("test.parent"):
            time.sleep(0.01)
            with profiling.span("test.child"):
                time.sleep(0.02)
    parent, child = profiling.SPANS["test.parent"], profiling.SPANS["test.child"]
    assert parent[0] == child[0] == 1
    assert child[1] == child[2] >= 20_000_000
    assert parent[2] == parent[1] - child[1] >= 10_000_000
    assert {"test.parent", "test.child"} <= _host_names(prof)


def test_torch_span_on_another_thread_does_not_nest_under_the_callers(monkeypatch):
    """A span of another thread (autograd's backward on a CUDA device runs
    on one) counts on its own and takes nothing from the caller's self
    time. A Python thread does not see the caller's profiler, so the gate
    is held open here."""
    monkeypatch.setattr(profiling, "_enabled", lambda: True)
    profiling.reset_spans()

    def worker():
        with profiling.span("test.worker"):
            time.sleep(0.02)

    with profiling.span("test.caller"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    caller, other = profiling.SPANS["test.caller"], profiling.SPANS["test.worker"]
    assert other[0] == 1 and other[1] >= 20_000_000
    assert caller[2] == caller[1] >= other[1]


def test_torch_nuts_step_spans_count_its_leaves():
    """One transition of 4 chains on a float32 GPR posterior on the CPU:
    every leaf is one evaluation of the log-density and, through the fused
    tier's plain version, one closed-form backward."""
    dtype = torch.float32
    g = torch.Generator().manual_seed(3)
    X = torch.rand(24, 2, generator=g, dtype=dtype)
    Y = torch.sin(6.0 * X[:, :1]) + 0.1 * torch.randn(24, 1, generator=g, dtype=dtype)
    model0 = GPR.create(kernels.SquaredExponential.create(1.0, torch.tensor([0.5, 0.5]),
                                                          device="cpu", dtype=dtype),
                        noise_variance=0.1)
    vg = gpr_logdensity_vg(X, Y)
    calls = []

    def vg_flat(z):
        calls.append(z.shape)
        v, grad = vg(unravel(model0, z))
        return v.detach(), ravel(grad).detach()

    C = 4
    q = ravel(model0).expand(C, -1) + 0.05 * torch.randn(C, 4, generator=g, dtype=dtype)
    profiling.reset_spans()
    with _profiled():
        logp, grad = vg_flat(q)
    # the closure's first call builds X's operands, once for its whole life
    assert profiling.SPANS["router.operands"][0] == 1
    calls.clear()
    key = GeneratorSource(C, torch.Generator().manual_seed(5))
    inv_mass = torch.ones(C, 4, dtype=dtype)
    profiling.reset_spans()
    with _profiled() as prof:
        q1, _, _, info = nuts.nuts_step(vg_flat, q, logp, key, 0.2, inv_mass, 5, grad0=grad)
    assert gpr.DISPATCH_EVENTS[-1]["tier"] == "fused_general_prod"
    spans = dict(profiling.SPANS)
    assert "router.operands" not in spans  # no leaf rebuilt them
    leaves = spans["nuts.leaf"][0]
    assert leaves == spans["logdensity.value_and_grad"][0] == len(calls) > 1
    assert spans["nll.backward"][0] == spans["router.dispatch"][0] == leaves
    assert leaves == int(info.num_leaves.max())
    assert spans["nuts.transition"][0] == 1
    assert spans["nuts.sync"][0] > leaves
    for count, total, self_ns in spans.values():
        assert count > 0 and 0 < self_ns <= total
    assert set(spans) <= _host_names(prof)


def test_torch_walk_forward_records_its_tier_and_spans():
    """The walk-forward records the tier its loss runs by the router's
    names, once a call; its fused loss builds the shared matrices once a
    call and the per-model operands once an evaluation, each a span."""
    from portfoliooptgp_tpu_torch.pipelines import walk_forward as wf

    g = torch.Generator().manual_seed(1)
    X = torch.rand(30, 2, generator=g, dtype=torch.float32)
    Y = torch.sin(5.0 * X[:, :1]) + 0.1 * torch.randn(30, 1, generator=g)

    def make_model(v):
        return GPR.create(kernels.composite_kernel(2, kernels.Exponential, kernels.Exponential,
                                                   device="cpu", dtype=torch.float32),
                          noise_variance=v)

    calls = []
    real = wf.batched_lbfgs.fit_batched_fused

    def counting(loss, *a, **k):
        def counted(ms):
            calls.append(1)
            return loss(ms)
        return real(counted, *a, **k)

    gpr.DISPATCH_EVENTS.clear()
    profiling.reset_spans()
    wf.batched_lbfgs.fit_batched_fused = counting
    try:
        with _profiled():
            wf.batched_walk_forward(X, Y, 27, make_model, restart_noise_inits=(1e-2, 1e-1),
                                    maxiter=5, device="cpu", dtype=torch.float32)
    finally:
        wf.batched_lbfgs.fit_batched_fused = real
    assert list(gpr.DISPATCH_EVENTS) == [{"tier": "fused_general_prod", "n": 30, "batch": 6}]
    spans = dict(profiling.SPANS)
    assert spans["walk_forward.call"][0] == 1
    assert spans["router.operands"][0] == 1  # X's operands, once a call
    assert spans["router.dispatch"][0] == len(calls)
    assert spans["lbfgs.value"][0] + spans["lbfgs.gradient"][0] == len(calls)
    assert spans["walk_forward.call"][1] >= spans["lbfgs.iteration"][1]


def test_torch_dispatch_events_keep_the_last_256():
    gpr.DISPATCH_EVENTS.clear()
    for i in range(600):
        gpr._record_tier("xla", i, 1)
    assert len(gpr.DISPATCH_EVENTS) == 256
    assert gpr.DISPATCH_EVENTS[-1]["n"] == 599 and gpr.DISPATCH_EVENTS[0]["n"] == 344
    assert {"tier": "xla", "n": 599, "batch": 1} in gpr.DISPATCH_EVENTS
    gpr.DISPATCH_EVENTS.clear()
    assert len(gpr.DISPATCH_EVENTS) == 0
