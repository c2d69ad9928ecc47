"""The ICM frontier cell (`kinds/icm_nuts.py`) on the CPU at a tiny market:
3 assets over two months (N = 41), rank 3, 4 chains, started at the
program's own fit with a step size and mass from its own warmup
(`tools/adapt_icm_nuts.adapt`). The cell sets up, holds its tier, runs and
reads `correct` against the reference; a tree cut shallow, half the chains
left at their start, an altered log-density and the TF32 control each read
`correct` false under the cell's own limits. A traced run reports the
cell's program-span metrics. A `cuda`-marked test runs the real cell
briefly on a card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from gpbench import harness
from gpbench.reference import gp as ref
from gpbench.tests.test_gpbench_harness import tiny_root
from gpbench.tools.adapt_icm_nuts import adapt
from portfoliooptgp_tpu_torch.inference import nuts
from portfoliooptgp_tpu_torch.models import gpr
from portfoliooptgp_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SPAN_METRICS = ("icm_host_ms_per_eval.icm", "eigh_ms_per_eval.icm", "nll_backward_ms.icm")


def tiny_icm_root(tmp_path, dtype="float64"):
    """`tiny_root` with a tiny ICM cell added as files only, in the real
    cell's traffic and limits."""
    root = tiny_root(tmp_path)
    g = os.path.join(root, "gpbench")
    with open(os.path.join(g, "configs", "icm_frontier_p20r3.json")) as f:
        cfg = dict(json.load(f), assets=3, grid=["2024-03-01", "2024-04-26"], max_depth=5,
                   dtype=dtype, fit=dict(maxiter=100, seed=0))
    cfg.update({k: adapt(cfg, 4, 10, 0, "cpu")[k] for k in ("start", "step_size", "inv_mass")})
    with open(os.path.join(g, "workloads", "icm1y_p20_c128.json")) as f:
        traffic = dict(json.load(f), chains=4)
    for sub, data in (("configs", cfg), ("workloads", traffic)):
        with open(os.path.join(g, sub, "tiny_icm.json"), "w") as f:
            json.dump(data, f)
    with open(os.path.join(g, "limits", "icm1y_p20_c128.json")) as f:
        limits = f.read()
    with open(os.path.join(g, "limits", "tiny_icm.json"), "w") as f:
        f.write(limits)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_icm", "source": "test",
                             "file": "gpbench/configs/tiny_icm.json",
                             "reduced": ["assets", "grid", "max_depth", "dtype"], "why": "test"})
    bench["workloads"].append({"name": "tiny_icm", "config": "tiny_icm", "traffic": "tiny_icm",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "icm1y_p20_c128" in m.get("workloads", ()):
            m["workloads"].append("tiny_icm")
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_icm_root(tmp_path_factory.mktemp("icm"))


def run(root, seed=123456789012, traced=False):
    return harness.run_cell(root, "tiny_icm", seed, 0.3, traced, "cpu", time.perf_counter())


_nuts_step = nuts.nuts_step


def _shallow_step(vg, q, logp, key, step_size, inv_mass, max_depth, **kw):
    return _nuts_step(vg, q, logp, key, step_size, inv_mass, 1, **kw)


def _half_chains_step(vg, q, logp, key, *args, grad0=None, **kw):
    q2, logp2, g2, info = _nuts_step(vg, q, logp, key, *args, grad0=grad0, **kw)
    h = q.shape[0] // 2
    return (torch.cat([q2[:h], q[h:]]), torch.cat([logp2[:h], logp[h:]]),
            torch.cat([g2[:h], grad0[h:]]), info)


def _altered_step(*args, **kw):
    """Chain 0's log-density returned 10% off."""
    q, logp, g, info = _nuts_step(*args, **kw)
    off = torch.where(torch.arange(logp.shape[0]) == 0, 0.1, 0.0).to(logp)
    return q, logp + off * torch.clamp_min(torch.abs(logp), 1.0), g, info


def test_tiny_cell_sets_up_holds_its_tier_and_reads_correct(root):
    gpr.DISPATCH_EVENTS.clear()
    res = run(root)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"nuts_draws_per_s", "setup_s"}
    assert res["attempted"] > 0 and res["attempted"] % 4 == 0 and res["failed"] == 0
    # every evaluation recorded the ICM tier at N = 41 and batch C·P = 12
    icm = [e for e in gpr.DISPATCH_EVENTS if e["tier"].startswith("icm.")]
    assert icm and all(e == {"tier": "icm.plain", "n": 41, "batch": 12} for e in icm)


@pytest.mark.parametrize("fault", [_shallow_step, _half_chains_step, _altered_step],
                         ids=["depth-cut", "half-chains-unmoved", "altered-logp"])
def test_a_planted_fault_reads_not_correct(root, monkeypatch, fault):
    monkeypatch.setattr(nuts, "nuts_step", fault)
    res = run(root)
    assert not res["correct"], res["checks"]


def test_the_control_reads_not_correct(root):
    spec = harness.load_spec(root, "tiny_icm", False)
    c = harness.kind_module(spec).Cell(spec.config, spec.traffic, 5, "cpu")
    harness.measure(c, "cpu", 0.3, False)
    c.release()
    assert harness.passed(harness.check(c, spec.limits))
    assert not harness.passed(harness.check(c, spec.limits, ref.TF32))


def test_a_tier_the_evaluation_does_not_take_stops_the_set_up(root, monkeypatch):
    from portfoliooptgp_tpu_torch.models import icm

    monkeypatch.setattr(icm, "nll_chol_tier", lambda *a: "blocked")
    spec = harness.load_spec(root, "tiny_icm", False)
    with pytest.raises(RuntimeError, match="did not take the tier"):
        harness.kind_module(spec).Cell(spec.config, spec.traffic, 5, "cpu")


def test_traced_float32_run_reports_the_program_span_metrics(tmp_path):
    """In float32 the evaluation takes the fused tier's plain twin, whose
    closed-form backward is the span nll.backward."""
    torch.set_num_threads(2)
    root = tiny_icm_root(tmp_path, dtype="float32")
    profiling.reset_spans()
    res = run(root, seed=2 ** 40 + 5, traced=True)
    got = {name: m["value"] for name, m in res["metrics"].items()}
    assert set(SPAN_METRICS) <= set(got), got
    for name in SPAN_METRICS:
        assert 0 < got[name] < 1e4, (name, got[name])
    # off the card no kernel counter and no device activity: those readers find nothing
    assert not {"st_kernel_roofline_pct.icm", "step_mfu_pct.icm",
                "nuts_leaves_per_transition.icm"} & set(got)


@pytest.mark.cuda
def test_icm_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, "gpbench/run.py", "--workload", "icm1y_p20_c128",
                          "--seed", "3000000019", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["attempted"] > 0


def test_the_icm_reference_imports_no_program_and_the_kind_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import gpbench.reference.icm; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'portfoliooptgp_tpu_torch', 'portfoliooptgp_tpu', 'jax'}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
    code = ("import sys; sys.path.insert(0, %r); from gpbench.kinds import icm_nuts; "
            "import gpbench.tools.adapt_icm_nuts; from gpbench import harness; "
            "print(harness.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
