"""The per-layer metrics read from the program's own spans: a traced tiny
run of each cell kind on the CPU reports all of them, finite and positive.
The tiny cells run in float32 here, so that the loss takes the fused tier
whose operand build and closed-form backward the spans mark."""

import json
import math
import os
import time

import pytest
import torch

from gpbench import harness
from gpbench.tests.test_gpbench_harness import tiny_root
from portfoliooptgp_tpu_torch.utils import profiling

WF = ("lbfgs_value_evals_per_grad.wf", "lbfgs_self_ms_per_iter.wf", "router_ms_per_eval.wf")
NUTS = ("sampler_self_ms_per_leaf.nuts", "router_ms_per_eval.nuts", "nll_backward_ms.nuts")


def _edit(path, fn):
    with open(path) as f:
        data = json.load(f)
    fn(data)
    with open(path, "w") as f:
        json.dump(data, f)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    root = tiny_root(tmp_path_factory.mktemp("spans"))
    for cfg in ("tiny_wf", "tiny_nuts"):
        _edit(os.path.join(root, "gpbench", "configs", cfg + ".json"),
              lambda c: c.update(dtype="float32"))

    def add_cells(bench):
        for m in bench["per_layer"]:
            if m["name"] in WF:
                m["workloads"].append("tiny_wf")
            if m["name"] in NUTS:
                m["workloads"].append("tiny_nuts")

    _edit(os.path.join(root, "BENCHMARK.json"), add_cells)
    return root


@pytest.mark.parametrize("cell, names", [("tiny_wf", WF), ("tiny_nuts", NUTS)])
def test_traced_run_reports_the_program_span_metrics(root, cell, names):
    profiling.reset_spans()
    res = harness.run_cell(root, cell, 2 ** 40 + 5, 0.5, True, "cpu", time.perf_counter())
    got = {name: m["value"] for name, m in res["metrics"].items()}
    assert set(names) <= set(got), got
    for name in names:
        assert math.isfinite(got[name]) and got[name] > 0, (name, got[name])
    assert res["metrics"][names[-1]]["unit"] == "ms"


def test_untraced_run_records_no_spans(root):
    profiling.reset_spans()
    res = harness.run_cell(root, "tiny_nuts", 11, 0.3, False, "cpu", time.perf_counter())
    assert profiling.SPANS == {}
    assert not set(res["metrics"]) & set(WF + NUTS)
