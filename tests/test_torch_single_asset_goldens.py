"""`chip_smoke.compare_single_asset`, the check of the single-asset run on
the card against the JAX goldens (tests/goldens_torch/), on the CPU.

The JAX package's own float32 run, as a quality dict, meets it. Each
fault it is there to catch fails it: a menu entry left at its start (the
loss of the SE entry before training, 1946.4, as a wrong gradient would
leave it), a NaN on an entry JAX trains well in float32, a float32-unstable
entry (Exp + Periodic(SE)) below the optimum or above its start, another
winner where the float32 winner is clear, the float64 horizon mean (whose
Linear trend float32 cannot reproduce), and a doubled posterior variance.
"""

import copy
import json

import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def goldens():
    with open(cs.SINGLE_ASSET_GOLDENS) as fh, open(cs.SINGLE_ASSET_GOLDENS_F32) as fh32:
        return json.load(fh), json.load(fh32)


def _as_quality(g):
    """A goldens file in run_single_asset's quality format."""
    q = copy.deepcopy(g)
    for t in q["timescales"].values():
        t["tiers"] = t["tiers_f32"]
        t["dispatched"] = [(tier, t["n"]) for tier in sorted(set(t["tiers_f32"]))]
    return q


def test_torch_compare_single_asset_accepts_jax_float32(goldens):
    g, g32 = goldens
    ok, bad = cs.compare_single_asset(_as_quality(g32), g, g32)
    assert ok, bad


def _stalled(q):
    q["timescales"]["d"]["losses"][0] = 1946.4


def _nan_entry(q):
    q["timescales"]["w"]["losses"][1] = float("nan")


def _unstable_below_optimum(q):
    q["timescales"]["d"]["losses"][6] = 1230.0


def _unstable_above_start(q):
    q["timescales"]["d"]["losses"][6] = 1310.0


def _other_winner(q):
    q["timescales"]["m"]["best_index"] = 2


def _float64_horizon(q, g):
    n = g["n_daily"]
    q["f_mean"][n:] = g["f_mean"][n:]


def _doubled_variance(q):
    q["f_var"] = [2 * v for v in q["f_var"]]


@pytest.mark.parametrize("fault,expect", [
    (_stalled, "d: index 0 loss"),
    (_nan_entry, "w: index 1 loss"),
    (_unstable_below_optimum, "d: index 6 loss"),
    (_unstable_above_start, "d: index 6 loss"),
    (_other_winner, "m: winner 2"),
    (_float64_horizon, "horizon f_mean"),
    (_doubled_variance, "f_var rel err"),
])
def test_torch_compare_single_asset_rejects(goldens, fault, expect):
    g, g32 = goldens
    q = _as_quality(g32)
    if fault is _float64_horizon:
        fault(q, g)
    else:
        fault(q)
    ok, bad = cs.compare_single_asset(q, g, g32)
    assert not ok
    assert any(expect in b for b in bad), bad
