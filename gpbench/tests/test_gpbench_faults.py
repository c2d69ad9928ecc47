"""The check catches a broken timed path: a run on the CPU at a tiny size
(the harness's look for a card skipped), with a fault planted in the
program underneath, reads `correct` false; so does the control, the
reference in TF32 put in the program's place. The sound run reads true.
Besides the contract's faults, each cell's own short cut is planted: fits
stopped after a few L-BFGS iterations, NUTS trees cut shallow.

One cell on one chip has no exchange between chips, so that fault is not
planted."""

import time

import pytest
import torch

from gpbench import harness
from gpbench.reference import gp as ref
from gpbench.tests.test_gpbench_harness import tiny_root
from portfoliooptgp_tpu_torch.inference import nuts
from portfoliooptgp_tpu_torch.pipelines import walk_forward as wf
from portfoliooptgp_tpu_torch.train import batched_lbfgs


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("faults"))


def run(root, cell):
    return harness.run_cell(root, cell, 123456789012, 0.3, False, "cpu", time.perf_counter())


def _unchanged_fit(loss, Z0, **kw):
    return batched_lbfgs_fit_matrix(loss, Z0, **dict(kw, maxiter=0))


batched_lbfgs_fit_matrix = batched_lbfgs.fit_matrix


def _half_batch_fit(loss, Z0, **kw):
    def half(Z):
        f = loss(Z)
        h = f.shape[0] // 2
        return torch.cat([f[:h], f[:h].mean().expand(f.shape[0] - h)])
    return batched_lbfgs_fit_matrix(half, Z0, **kw)


def _cut_fit(loss, Z0, **kw):
    return batched_lbfgs_fit_matrix(loss, Z0, **dict(kw, maxiter=3))


_predict = wf.masked_predict_next


def _altered_predict(*args):
    mean, var = _predict(*args)
    return mean + 0.05, var


_nuts_step = nuts.nuts_step


def _unchanged_step(vg, q, logp, key, *args, grad0=None, **kw):
    _, _, _, info = _nuts_step(vg, q, logp, key, *args, grad0=grad0, **kw)
    return q, logp, grad0, info


def _half_chains_step(vg, q, logp, key, *args, grad0=None, **kw):
    q2, logp2, g2, info = _nuts_step(vg, q, logp, key, *args, grad0=grad0, **kw)
    h = q.shape[0] // 2
    return (torch.cat([q2[:h], q[h:]]), torch.cat([logp2[:h], logp[h:]]),
            torch.cat([g2[:h], grad0[h:]]), info)


def _altered_step(*args, **kw):
    """Chain 0's log-density returned 10% off (float32's own error at the
    cell's size reaches 0.4%)."""
    q, logp, g, info = _nuts_step(*args, **kw)
    off = torch.where(torch.arange(logp.shape[0]) == 0, 0.1, 0.0).to(logp)
    return q, logp + off * torch.clamp_min(torch.abs(logp), 1.0), g, info


def _shallow_step(vg, q, logp, key, step_size, inv_mass, max_depth, **kw):
    return _nuts_step(vg, q, logp, key, step_size, inv_mass, 1, **kw)


@pytest.mark.parametrize("cell, module, attr, fault", [
    ("tiny_wf", None, None, None),
    ("tiny_wf", batched_lbfgs, "fit_matrix", _unchanged_fit),
    ("tiny_wf", batched_lbfgs, "fit_matrix", _half_batch_fit),
    ("tiny_wf", wf, "masked_predict_next", _altered_predict),
    ("tiny_wf", batched_lbfgs, "fit_matrix", _cut_fit),
    ("tiny_nuts", None, None, None),
    ("tiny_nuts", nuts, "nuts_step", _unchanged_step),
    ("tiny_nuts", nuts, "nuts_step", _half_chains_step),
    ("tiny_nuts", nuts, "nuts_step", _altered_step),
    ("tiny_nuts", nuts, "nuts_step", _shallow_step),
], ids=["wf-sound", "wf-unchanged-state", "wf-half-batch", "wf-altered-answer",
        "wf-maxiter-cut", "nuts-sound", "nuts-unchanged-state", "nuts-half-batch",
        "nuts-altered-answer", "nuts-shallow-tree"])
def test_a_planted_fault_reads_not_correct(root, monkeypatch, cell, module, attr, fault):
    if fault is not None:
        monkeypatch.setattr(module, attr, fault)
    res = run(root, cell)
    assert res["correct"] == (fault is None), res["checks"]


@pytest.mark.parametrize("cell", ["tiny_wf", "tiny_nuts"])
def test_the_control_reads_not_correct(root, cell):
    spec = harness.load_spec(root, cell, False)
    c = harness.kind_module(spec).Cell(spec.config, spec.traffic, 5, "cpu")
    harness.measure(c, "cpu", 0.3, False)
    c.release()
    assert harness.passed(harness.check(c, spec.limits))
    assert not harness.passed(harness.check(c, spec.limits, ref.TF32))
