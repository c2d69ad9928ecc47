"""The harness on the CPU: cells, traffic and metrics found by name, the
rate over the whole window, the result line, and the import guard."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from gpbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def tiny_root(tmp_path):
    """A checkout's benchmark with two throwaway cells added as files only:
    a tiny walk-forward and a tiny NUTS cell, their configurations,
    traffic and limits, and a throwaway metric read in the first. The
    tiny cells run in float64, where the program's plain path meets the
    real cells' limits at any size."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "gpbench"), root / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    g = root / "gpbench"
    wf_cfg = json.loads((g / "configs" / "mi_wf_expexp.json").read_text())
    (g / "configs" / "tiny_wf.json").write_text(json.dumps(dict(wf_cfg, maxiter=100,
                                                                dtype="float64")))
    wf_traffic = json.loads((g / "workloads" / "wf2y_d20r4.json").read_text())
    (g / "workloads" / "tiny_wf.json").write_text(json.dumps(
        dict(wf_traffic, n_train=40, days=2, assets=2)))
    nuts_cfg = dict(json.loads((g / "configs" / "nuts_ard_se512.json").read_text()), n=48)
    (g / "configs" / "tiny_nuts.json").write_text(json.dumps(dict(nuts_cfg, max_depth=4, dtype="float64")))
    nuts_traffic = json.loads((g / "workloads" / "nuts512_c128.json").read_text())
    (g / "workloads" / "tiny_nuts.json").write_text(json.dumps(dict(nuts_traffic, chains=4)))
    for cell, like in (("tiny_wf", "wf2y_d20r4"), ("tiny_nuts", "nuts512_c128")):
        shutil.copy(g / "limits" / f"{like}.json", g / "limits" / f"{cell}.json")
    (g / "metrics" / "calls_per_s.tiny.py").write_text(
        "def read(run):\n    return run.units['steps'] / run.seconds\n")
    bench["configs"] += [
        {"name": "tiny_wf", "source": "test", "file": "gpbench/configs/tiny_wf.json",
         "reduced": ["maxiter", "dtype"], "why": "test"},
        {"name": "tiny_nuts", "source": "test", "file": "gpbench/configs/tiny_nuts.json",
         "reduced": ["n", "max_depth", "dtype"], "why": "test"}]
    bench["workloads"] += [
        {"name": "tiny_wf", "config": "tiny_wf", "traffic": "tiny_wf", "chips": 1, "why": "t"},
        {"name": "tiny_nuts", "config": "tiny_nuts", "traffic": "tiny_nuts", "chips": 1,
         "why": "t"}]
    for m in bench["end_to_end"]:
        if m["name"] == "wf_forecasts_per_s":
            m["workloads"].append("tiny_wf")
        if m["name"] == "nuts_draws_per_s":
            m["workloads"].append("tiny_nuts")
    bench["end_to_end"].append({"name": "calls_per_s.tiny", "unit": "calls/s",
                                "better": "higher", "bound": 0.1, "source": "host_clock",
                                "workloads": ["tiny_wf"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


@pytest.fixture
def root(tmp_path):
    torch.set_num_threads(2)
    return tiny_root(tmp_path)


def test_added_cell_and_metric_run_from_files_only(root):
    res = harness.run_cell(root, "tiny_wf", 2 ** 40 + 3, 0.5, False, "cpu", time.perf_counter())
    assert list(res) == KEYS  # the checks come last
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"wf_forecasts_per_s", "setup_s", "calls_per_s.tiny"}
    assert res["metrics"]["calls_per_s.tiny"]["unit"] == "calls/s"
    assert res["attempted"] > 0 and res["attempted"] % 2 == 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_nuts_cell_runs_and_traced_run_reports_per_layer_metrics(root):
    res = harness.run_cell(root, "tiny_nuts", 7, 0.5, False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"nuts_draws_per_s", "setup_s"}
    assert res["attempted"] % 4 == 0 and res["attempted"] > 0
    traced = harness.run_cell(root, "tiny_nuts", 7, 0.5, True, "cpu", time.perf_counter())
    assert traced["correct"]
    # off the card there is no device activity and no kernel counter: every
    # per-layer reader finds nothing, and no metric is made up
    assert traced["metrics"] == {}
    assert traced["device"]["window_s"] > 0 and "breakdown" in traced


class _Slow:
    """A cell whose units take the given seconds."""

    UNIT = "forecasts"

    def __init__(self, seconds):
        self.seconds = list(seconds)

    def step(self):
        time.sleep(self.seconds.pop(0))
        return 10

    def counters(self):
        return {}


def test_rate_counts_the_stall_of_the_last_unit():
    from gpbench import readers

    def rate(seconds):
        work, units, steps, _, _ = harness.measure(_Slow(seconds), "cpu", 0.3, False)
        assert units == 10 * steps
        run = harness.Run("x", 0.0, 0.3, {"forecasts": work}, {"forecasts": units, "steps": steps},
                          {}, None, {})
        return readers.rate(run, "forecasts"), steps

    steady, n = rate([0.1] * 4)
    stalled, m = rate([0.1, 0.1, 0.5])
    assert n == m == 3  # the unit in progress at the close is finished
    # of the stalled last unit only its first 0.1 s of 0.5 lies in the window
    assert steady == pytest.approx(100, rel=0.1)
    assert stalled == pytest.approx(10 * (2 + 0.1 / 0.5) / 0.3, rel=0.1)


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("portfoliooptgp_tpu_torch", "portfoliooptgp_tpu_torchx", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    for name in ("portfoliooptgp_tpu", "jaxlib.xla_client"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == ["jaxlib", "portfoliooptgp_tpu"]


def test_what_a_run_imports_holds_no_jax_and_the_reference_no_program():
    code = ("import sys; sys.path.insert(0, %r); import gpbench.run, gpbench.harness, "
            "gpbench.control, gpbench.readers; from gpbench.kinds import walk_forward, nuts; "
            "from gpbench import harness; print(harness.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
    code = ("import sys; sys.path.insert(0, %r); import gpbench.reference.gp; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'portfoliooptgp_tpu_torch', 'portfoliooptgp_tpu', 'jax'}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result_and_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "gpbench", "run.py"), "--workload",
                          "wf2y_d20r4", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
