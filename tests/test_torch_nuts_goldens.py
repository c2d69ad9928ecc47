"""The NUTS goldens and the gates `chip_smoke.py` phase 11 holds the port
to: tests/goldens_torch/nuts_bench.json (bench.py's workload in the JAX
package, float64 over three keys and float32 once, written by
`tools/make_torch_goldens.py --nuts`) and frontier_1y_nuts.json (the
frontier's NUTS block, `--frontier 1y --nuts`).

JAX's own float32 run passes `compare_nuts`; runs with planted faults fail
it: a posterior mean shifted by 10 standard deviations, a halved standard
deviation, and the mass-matrix switch skipped (the metric left at the
identity). `compare_frontier_nuts` passes JAX's own frontier runs, each
against the others, and fails planted faults. No JAX runs here: the
files hold the summaries.
"""

import copy
import json

import numpy as np
import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def goldens():
    with open(cs.NUTS_GOLDENS) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def frontier_goldens():
    with open(cs.FRONTIER_NUTS_GOLDENS) as fh:
        return json.load(fh)


def test_torch_nuts_goldens_record_the_workload(goldens, frontier_goldens):
    assert goldens["config"] == cs.NUTS_BENCH
    assert (goldens["n"], goldens["d"]) == (cs.NUTS_N, cs.NUTS_D)
    assert goldens["seeds"] == list(cs.NUTS_SEEDS) == [r["seed"] for r in goldens["runs"]]
    assert frontier_goldens["config"] == cs.FRONTIER_NUTS
    assert [r["seed"] for r in frontier_goldens["runs"]] == list(cs.FRONTIER_NUTS_SEEDS)
    for r in goldens["runs"] + [goldens["f32"]]:
        assert len(r["mean"]) == len(r["sd"]) == len(r["inv_mass_diag"]) == 6
        assert 0.5 < r["accept"] < 1.0 and r["divergences"] == 0


def test_torch_nuts_goldens_jax_float32_passes(goldens):
    assert cs.compare_nuts(goldens["f32"], goldens) == []


@pytest.mark.parametrize("fault", ["mean shifted 10 sd", "sd halved", "mass switch skipped"])
def test_torch_nuts_goldens_planted_faults_fail(goldens, fault):
    q = copy.deepcopy(goldens["f32"])
    if fault == "mean shifted 10 sd":
        q["mean"][0] += 10 * q["sd"][0]
    elif fault == "sd halved":
        q["sd"] = [0.5 * s for s in q["sd"]]
    else:
        q["inv_mass_diag"] = [1.0] * len(q["inv_mass_diag"])
    assert cs.compare_nuts(q, goldens)


def test_torch_frontier_nuts_goldens_compare(frontier_goldens):
    """Each JAX run passes against all eight and, left out, against the
    other seven; μ 10 standard deviations (over the runs) from their mean,
    Σ scaled by 3, and weights off the simplex fail."""
    runs = frontier_goldens["runs"]
    for i, r in enumerate(runs):
        assert cs.compare_frontier_nuts(r, frontier_goldens) == []
        assert cs.compare_frontier_nuts(r, dict(frontier_goldens,
                                                runs=runs[:i] + runs[i + 1:])) == []
        assert r["draws"] == cs.FRONTIER_NUTS["nuts_chains"] * cs.FRONTIER_NUTS["nuts_samples"]
    mu = np.array([r["mu"] for r in runs])
    for fault in ("mu", "Sigma", "weights"):
        q = copy.deepcopy(runs[0])
        if fault == "mu":
            q["mu"] = (mu.mean(0) + 10 * mu.std(0, ddof=1)).tolist()
        elif fault == "Sigma":
            q["Sigma"] = (3 * np.array(q["Sigma"])).tolist()
        else:
            q["tangency_weights"] = (np.array(q["tangency_weights"]) * 0.9).tolist()
        assert cs.compare_frontier_nuts(q, frontier_goldens), fault
