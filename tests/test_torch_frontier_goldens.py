"""`chip_smoke.compare_frontier`, the check of the frontier run on the card
against the JAX goldens (tests/goldens_torch/frontier_*.json), on the CPU.

The JAX package's own float32 run, as a quality dict, meets it on both
grids. Each fault it is there to catch fails it on the five-year grid: a
doubled noise variance, Σ with its assets out of order on one axis (Σ is
symmetric, so a plain transpose is no fault; a transposed index is), the
tangency weights off the simplex, the fit left at its start (where a wrong
hinv gradient leaves L-BFGS), and a wrong NLL at W₀.
"""

import copy
import json

import numpy as np
import pytest

import chip_smoke as cs


def _goldens(grid):
    with open(cs.frontier_goldens_path(grid)) as fh, \
            open(cs.frontier_goldens_path(grid, True)) as fh32:
        return json.load(fh), json.load(fh32)


def _as_quality(g, g32):
    """JAX's float32 run in run_frontier's quality format; its replays are
    each golden's own values."""
    q = copy.deepcopy(g32)
    q.update(tier=g32["tier_f32"], launches={},
             kvB=(np.asarray(g32["B"]) * g32["kernel_variance"]).tolist(),
             replay={"f64": dict(nll=g["final_nll"], mu=g["mu"], Sigma=g["Sigma"],
                                 frontier=g["frontier"]),
                     "f32": dict(nll=g32["final_nll"], mu=g32["mu"], Sigma=g32["Sigma"])})
    return q


@pytest.mark.parametrize("grid", ["1y", "5y"])
def test_torch_compare_frontier_accepts_jax_float32(grid):
    g, g32 = _goldens(grid)
    assert g["n"] == g32["n"] and g32["tier_f32"] == {"1y": "fused", "5y": "hinv"}[grid]
    ok, bad = cs.compare_frontier(_as_quality(g, g32), g, g32)
    assert ok, bad


def _wrong_noise(q):
    q["noise_variance"] *= 2.0


def _sigma_index_transposed(q):
    q["Sigma"] = np.asarray(q["Sigma"])[:, ::-1].tolist()


def _off_simplex(q):
    q["frontier"]["tangency_weights"] = (1.1 * np.asarray(q["frontier"]["tangency_weights"])
                                         ).tolist()


def _stalled_fit(q):
    q["final_nll"], q["iters"] = q["start_nll"], 1


def _wrong_start_nll(q):
    q["start_nll"] += 10.0


@pytest.mark.parametrize("fault", [_wrong_noise, _sigma_index_transposed, _off_simplex,
                                   _stalled_fit, _wrong_start_nll],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_torch_compare_frontier_catches(fault):
    g, g32 = _goldens("5y")
    q = _as_quality(g, g32)
    fault(q)
    ok, bad = cs.compare_frontier(q, g, g32)
    assert not ok and bad
