"""`chip_smoke.compare_multi_input`, the check of the multi-input run on the
card against the JAX goldens (tests/goldens_torch/multi_input_poly*.json),
on the CPU.

The JAX package's own float32 run, as a quality dict, meets it. Each fault
it is there to catch fails it: a wrong winning restart (one outside the
goldens' tied best), shifted next-day means, a fit that took the wrong NLL
tier, an NLL at the goldens' leaves that the kernel got wrong, and a
workflow whose backtest moved.
"""

import copy
import json

import numpy as np
import pytest

import chip_smoke as cs


def _goldens():
    with open(cs.multi_input_goldens_path()) as fh, \
            open(cs.multi_input_goldens_path(True)) as fh32:
        return json.load(fh), json.load(fh32)


def _outputs(c):
    return {k: c[k] for k in ("kept", "f_mean", "f_var", "mse", "mse_all", "mse_removed")
            if k in c}


def _as_quality(g, g32):
    """JAX's float32 run in run_multi_input's quality format; the replays
    are JAX's float32 NLLs at each golden's leaves and each golden's own
    outputs."""
    q = dict(dtype="float32", cases={}, workflow=copy.deepcopy(g32["workflow"]))
    for name, c32 in g32["cases"].items():
        c = copy.deepcopy(c32)
        for f in c["fits"]:
            f["tiers"] = [f["tier_f32"]]
        c["replay"] = {
            "f64": dict(nll=[f["loss_at_f64_leaves"] for f in c32["fits"]],
                        **_outputs(g["cases"][name])),
            "f32": dict(nll=[f["loss"] for f in c32["fits"]], **_outputs(c32))}
        q["cases"][name] = c
    return q


def test_torch_compare_multi_input_accepts_jax_float32():
    g, g32 = _goldens()
    assert set(g["cases"]) == set(g32["cases"]) == set(cs.MULTI_INPUT_CASES)
    for name, (_, pair, _) in cs.MULTI_INPUT_CASES.items():
        tiers = {f["tier_f32"] for f in g32["cases"][name]["fits"]}
        assert tiers == {"pallas_dense" if pair == "poly" else "fused_general_prod"}
    ok, bad = cs.compare_multi_input(_as_quality(g, g32), g, g32)
    assert ok, bad


def _wrong_winner(q):
    q["cases"]["step1/poly/trained"]["fits"][0]["winner"] = 0


def _shifted_means(q):
    c = q["cases"]["step3/poly/fixed"]
    c["f_mean"] = (np.asarray(c["f_mean"]) + 0.02 * np.abs(c["f_mean"]).max()).tolist()


def _wrong_tier(q):
    q["cases"]["step4/poly/fixed"]["fits"][2]["tiers"] = ["fused_general_prod"]


def _wrong_kernel_nll(q):
    q["cases"]["step2/poly/trained"]["replay"]["f64"]["nll"][0] *= 1.001


def _moved_backtest(q):
    q["workflow"]["strategies"]["sharpe"]["cumulative_return"] += 0.05


@pytest.mark.parametrize("fault", [_wrong_winner, _shifted_means, _wrong_tier,
                                   _wrong_kernel_nll, _moved_backtest],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_torch_compare_multi_input_catches(fault):
    g, g32 = _goldens()
    q = _as_quality(g, g32)
    fault(q)
    ok, bad = cs.compare_multi_input(q, g, g32)
    assert not ok and bad
