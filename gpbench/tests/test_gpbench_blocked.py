"""A walk-forward cell that names its tier: a blocked stand-in on the CPU
(n_full 513, past the fused kernels' N ≤ 512) runs from files alone,
records the `blocked` tier and reads `correct`, and a planted fault reads
not correct; a tier the call does not take stops the set-up; and the
readers of the blocked cell's per-layer metrics, on runs made by hand.

The stand-in is float32, the tier's dtype, with one restart (1.0) and the
configuration's own `maxiter`: a fit cut short reads `fit_stall` above its
limit, so the sound stand-in has to converge (it does in ~35 iterations)."""

import json
import os
import time

import pytest
import torch

from gpbench import costs, harness, readers, trace
from gpbench.reference import gp as ref
from gpbench.tests.test_gpbench_harness import tiny_root
from portfoliooptgp_tpu_torch.models import gpr
from portfoliooptgp_tpu_torch.pipelines import walk_forward as wf
from portfoliooptgp_tpu_torch.train import batched_lbfgs
from portfoliooptgp_tpu_torch.utils import profiling


def _add_cell(root, name, n_train, tier, maxiter=None):
    """A walk-forward cell of 2 days × 1 restart on 1 asset, as files and
    an entry of BENCHMARK.json, with wf3y_d20r4's traffic, limits and
    metrics."""
    g = os.path.join(root, "gpbench")
    with open(os.path.join(g, "configs", "mi_wf_expexp.json")) as f:
        cfg = dict(json.load(f), restart_noise_inits=[1.0])
    if maxiter is not None:
        cfg["maxiter"] = maxiter
    with open(os.path.join(g, "workloads", "wf3y_d20r4.json")) as f:
        traffic = dict(json.load(f), n_train=n_train, days=2, assets=1)
    if tier is None:
        del traffic["tier"]
    for sub, data in (("configs", cfg), ("workloads", traffic)):
        with open(os.path.join(g, sub, name + ".json"), "w") as f:
            json.dump(data, f)
    with open(os.path.join(g, "limits", "wf3y_d20r4.json")) as f:
        limits = f.read()
    with open(os.path.join(g, "limits", name + ".json"), "w") as f:
        f.write(limits)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": name, "source": "test", "file": f"gpbench/configs/{name}.json",
                             "reduced": ["restart_noise_inits", "maxiter"], "why": "test"})
    bench["workloads"].append({"name": name, "config": name, "traffic": name, "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "wf3y_d20r4" in m.get("workloads", ()):
            m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    root = tiny_root(tmp_path_factory.mktemp("blocked"))
    _add_cell(root, "tiny_blocked", 511, "blocked")
    _add_cell(root, "fused_named_blocked", 502, "blocked", maxiter=2)
    _add_cell(root, "blocked_unnamed", 520, None, maxiter=2)
    return root


_fit_matrix = batched_lbfgs.fit_matrix
_predict = wf.masked_predict_next


def _cut_fit(loss, Z0, **kw):
    return _fit_matrix(loss, Z0, **dict(kw, maxiter=3))


def _unchanged_fit(loss, Z0, **kw):
    return _fit_matrix(loss, Z0, **dict(kw, maxiter=0))


def _altered_predict(*args):
    mean, var = _predict(*args)
    return mean + 0.05, var


@pytest.mark.parametrize("attr, fault", [(None, None), ("fit_matrix", _cut_fit),
                                         ("fit_matrix", _unchanged_fit),
                                         ("masked_predict_next", _altered_predict)],
                         ids=["sound", "maxiter-cut", "unchanged-state", "altered-answer"])
def test_blocked_stand_in_runs_from_files_and_is_checked(root, monkeypatch, attr, fault):
    if fault is not None:
        monkeypatch.setattr(batched_lbfgs if attr == "fit_matrix" else wf, attr, fault)
    n = len(gpr.DISPATCH_EVENTS)
    res = harness.run_cell(root, "tiny_blocked", 2 ** 41 + 3, 0.2, False, "cpu",
                           time.perf_counter())
    assert res["correct"] == (fault is None), res["checks"]
    if fault is _unchanged_fit:
        # float32 rows left at their start count as unmoved, though the
        # reference's NLL there lies a rounding below its float64 start
        assert res["checks"]["unmoved_share"]["value"] == 1.0
    assert set(res["metrics"]) == {"wf_forecasts_per_s", "setup_s"}
    # the set-up's call and the window's, each at the cell's N and batch
    events = list(gpr.DISPATCH_EVENTS)[n:]
    assert len(events) >= 2
    assert all(e == {"tier": "blocked", "n": 513, "batch": 2} for e in events), events


def test_a_row_left_a_rounding_downhill_of_its_start_counts_unmoved(root, monkeypatch):
    # on the card a float32 row that never moved reads the reference's NLL a
    # hair below the float64 start: 4 ulps downhill of it stay unmoved
    monkeypatch.setattr(batched_lbfgs, "fit_matrix", _unchanged_fit)
    spec = harness.load_spec(root, "tiny_blocked", False)
    cell = harness.kind_module(spec).Cell(spec.config, spec.traffic, 9, "cpu")
    cell.release()
    c = cell.outputs()[0]
    z0 = torch.cat([ref.positive_inv(torch.tensor(cell.start, dtype=torch.float64)),
                    ref.positive_inv(torch.tensor(cell.restarts, dtype=torch.float64))])[None]
    nudged = []
    for d in range(cell.days):
        v0, g0 = ref.wf_nll_and_grad(c["X"], c["y"], z0, cell.n_train + d, ref.F64)
        step = 4 * torch.finfo(torch.float32).eps * torch.clamp_min(z0.abs(), 1.0)
        nudged.append(z0 - step * torch.sign(g0))
        v, _ = ref.wf_nll_and_grad(c["X"], c["y"], nudged[-1], cell.n_train + d, ref.F64)
        assert float(v) < float(v0)
    c = dict(c, params=torch.cat(nudged))
    assert cell.readings([c])["unmoved_share"] == 1.0


def test_traced_stand_in_counts_the_window_s_evaluations_alone(root):
    # spans left by an earlier profiler in the process are not the window's
    profiling.SPANS["lbfgs.value"] = [10 ** 6, 0, 0]
    res = harness.run_cell(root, "tiny_blocked", 2 ** 41 + 5, 0.2, True, "cpu",
                           time.perf_counter())
    assert res["correct"], res["checks"]
    value, grad = profiling.SPANS["lbfgs.value"][0], profiling.SPANS["lbfgs.gradient"][0]
    assert 0 < grad < value < 10 ** 4
    got = res["metrics"]["lbfgs_evals_per_forecast.wf3y"]["value"]
    # the window's calls (the last one whole) made `attempted` forecasts
    assert got == pytest.approx((value + grad) / (res["attempted"] - 2))
    # off the card: no panel launch and no device activity to read
    assert not {"panel_kernel_roofline_pct.wf3y", "step_mfu_pct.wf3y"} & set(res["metrics"])


@pytest.mark.parametrize("cell, n_full", [("fused_named_blocked", 504),
                                          ("blocked_unnamed", 522)])
def test_a_tier_the_call_does_not_take_stops_the_set_up(root, monkeypatch, cell, n_full):
    # a set-up that raises leaves the fit wrapped, as a process that ends
    monkeypatch.setattr(batched_lbfgs, "fit_batched_fused", batched_lbfgs.fit_batched_fused)
    spec = harness.load_spec(root, cell, False)
    kind = harness.kind_module(spec)
    with pytest.raises(RuntimeError, match="did not take the tier 'blocked'"
                       if cell == "fused_named_blocked" else "did not run the fused stationary"):
        kind.Cell(spec.config, spec.traffic, 5, "cpu")
    assert gpr.DISPATCH_EVENTS[-1]["n"] == n_full


def _run(kernels=None, window_s=2.0, busy_s=1.0, units=40, shape=None):
    summary = trace.Summary(window_s=window_s, busy_s=busy_s, kernels=kernels or {},
                            idle_by_host={})
    return harness.Run("x", 0.0, window_s, {"forecasts": units}, {"forecasts": units, "steps": 2},
                       {}, summary, shape or dict(B=80, N=780, J=2, JD=2, masked=True))


def test_panel_roofline_counts_evaluations_by_panels():
    # 14 launches of the panel kernel at N = 780 are 2 evaluations of 7
    # panels (heights 780, 652, ..., 12) at B = 80, in 3 ms of kernel time
    name = "void blocked_panel_kernel<float>(float const*, long, long, float*)"
    run = _run({name: [10, 0.002], name + " ": [4, 0.001], "other": [5, 1.0]})
    per_eval = sum(costs.panel_bound_ms(nt, 80)[0] for nt in (780, 652, 524, 396, 268, 140, 12))
    assert readers.panel_roofline_pct(run) == pytest.approx(100 * 2 * per_eval * 1e-3 / 0.003)
    assert readers.panel_roofline_pct(_run({"other": [5, 1.0]})) is None
    assert readers.panel_roofline_pct(run._replace(trace=None)) is None


def test_span_readers_count_the_optimizer_evaluations():
    spans = {"lbfgs.value": [300, 0, 0], "lbfgs.gradient": [40, 0, 0], "other": [9, 0, 0]}
    run = _run(units=20)
    assert readers.evaluations(spans) == (300, 40)
    assert readers.evals_per(run, spans, "forecasts") == pytest.approx(340 / 20)
    flops = (300 * costs.nll_flops(80, 780, 2, 2, False)
             + 40 * costs.nll_flops(80, 780, 2, 2, True))
    assert readers.span_mfu_pct(run, spans) == pytest.approx(100 * flops / 2.0 / 67e12)
    # nothing to read: no spans, no unit done, no trace, no device activity
    assert readers.evaluations({"other": [1, 0, 0]}) is None
    assert readers.evals_per(run, {}, "forecasts") is None
    assert readers.evals_per(_run(units=0), spans, "forecasts") is None
    assert readers.span_mfu_pct(run, {}) is None
    assert readers.span_mfu_pct(_run(busy_s=0.0), spans) is None
    assert readers.span_mfu_pct(run._replace(trace=None), spans) is None
