"""`chip_smoke.compare_svgp`, the check of phase 10d's SVGP runs against the
JAX goldens (tests/goldens_torch/svgp_full_aapl*.json), on the CPU.

JAX's own float32 run, as a quality dict, meets it, and so does the port's
float32 run of both routes here (the gram kernels' plain versions). Each
fault it is there to catch fails it: a shifted posterior mean, a wrong
ELBO, a run that took the wrong route, one that trained on other batches,
and one whose kernel route trained on a wrong gradient.
The problem `chip_smoke` trains is bench.py's, copied; a test holds the
copy equal to it.
"""

import copy
import json

import numpy as np
import pytest
import torch

import bench
import chip_smoke as cs
from portfoliooptgp_tpu_torch.ops import svgp_gram as sg

torch.set_num_threads(1)


def _goldens():
    with open(cs.svgp_goldens_path()) as fh, open(cs.svgp_goldens_path(True)) as fh32:
        return json.load(fh), json.load(fh32)


def _as_quality(g32):
    """JAX's float32 run in run_svgp's format, as a card's run would give it."""
    q = dict(device="cuda", routes={})
    for route, r in g32["routes"].items():
        n = r["iters"] if route == "kernel" else 0
        q["routes"][route] = dict(
            copy.deepcopy(r), use_pallas=route == "kernel", eligible=True,
            launches={"svgp_gram_fwd": n, "svgp_gram_bwd": n},
            replay=dict(elbo_final=r["elbo_final"], batch_elbo_final=r["batch_elbo_final"],
                        f_mean=list(r["f_mean"]), f_var=list(r["f_var"])))
    return q


def test_torch_svgp_problem_is_bench_problem():
    for a, b in zip(cs.svgp_problem(), bench._svgp_problem()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (cs.SVGP_N, cs.SVGP_M, cs.SVGP_BATCH) == (bench.SVGP_N, bench.SVGP_M, bench.SVGP_BATCH)


def test_torch_compare_svgp_accepts_jax_float32():
    g, g32 = _goldens()
    assert set(g["routes"]) == {"xla"} and set(g32["routes"]) == set(cs.SVGP_ROUTES)
    assert g32["train"] == g["train"] == cs.SVGP_TRAIN
    assert all(r["iters"] == 60 for r in (*g["routes"].values(), *g32["routes"].values()))
    ok, bad = cs.compare_svgp(_as_quality(g32), g, g32)
    assert ok, bad


def _shifted_mean(q):
    r = q["routes"]["kernel"]
    for d in (r, r["replay"]):
        d["f_mean"] = list(np.asarray(d["f_mean"]) + 0.01 * np.abs(d["f_mean"]).max())


def _wrong_elbo(q):
    q["routes"]["xla"]["replay"]["elbo_final"] *= 1.0 + 5e-4


def _wrong_batch_elbo(q):
    q["routes"]["kernel"]["batch_elbo_start"] *= 1.0 - 5e-4


def _kernels_not_launched(q):
    q["routes"]["kernel"]["launches"] = {"svgp_gram_fwd": 0, "svgp_gram_bwd": 0}


def _kernels_on_default_route(q):
    q["routes"]["xla"]["launches"] = {"svgp_gram_fwd": 60, "svgp_gram_bwd": 60}


def _not_asking_for_kernels(q):
    q["routes"]["kernel"]["use_pallas"] = False


def _other_batches(q):
    q["routes"]["xla"]["iters"] = 59


def _moved_leaf(q):
    leaf = q["routes"]["xla"]["leaves_final"][1]  # the raw lengthscale
    q["routes"]["xla"]["leaves_final"][1] = [x + 1.0 for x in leaf]


@pytest.mark.parametrize("fault", [_shifted_mean, _wrong_elbo, _wrong_batch_elbo,
                                   _kernels_not_launched, _kernels_on_default_route,
                                   _not_asking_for_kernels, _other_batches, _moved_leaf],
                         ids=lambda f: f.__name__.strip("_"))
def test_torch_compare_svgp_rejects(fault):
    g, g32 = _goldens()
    q = _as_quality(g32)
    fault(q)
    ok, bad = cs.compare_svgp(q, g, g32)
    assert not ok and bad


def test_torch_svgp_full_aapl_cpu_run_matches_goldens():
    """The port's float32 run of both routes on the CPU, at full size (the
    kernel route on the gram kernels' plain versions), meets compare_svgp."""
    g, g32 = _goldens()
    q = cs.run_svgp(g32, device="cpu")
    assert q["device"] == "cpu"
    ok, bad = cs.compare_svgp(q, g, g32)
    assert ok, bad


def test_torch_compare_svgp_rejects_wrong_kernel_route_trajectory(monkeypatch):
    """A kernel route whose Z̄ is 0.9 of the right one while it trains (and
    only then: its gradient at the start is right) ends about 7 times the
    limit away from JAX float32's run of the route on Z (the limit is 4
    times JAX's own float32 route-to-route difference). Only the check
    against that run sees it: against the float64 golden it stays within 4
    times JAX's float32-to-float64 spread."""
    g, g32 = _goldens()
    train, bwd = cs.train_kernel_route, sg.gram_bwd

    def scaled_zbar(*args):
        zbar, *rest = bwd(*args)
        return (0.9 * zbar, *rest)

    def faulty_train(*args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(sg, "gram_bwd", scaled_zbar)
            return train(*args, **kwargs)

    monkeypatch.setattr(cs, "train_kernel_route", faulty_train)
    q = cs.run_svgp(g32, device="cpu")
    ok, bad = cs.compare_svgp(q, g, g32)
    assert not ok and bad
    assert all(b.startswith("route kernel: ") and "JAX float32's run of the route" in b
               for b in bad), bad
