"""The frontier's NUTS target on its normal path, held to the benchmark's
plain ICM reference (`gpbench/reference/icm.py`), and that reference's two
forms held to each other; the spans and the tier record of an ICM
evaluation; and `sample_nuts` through the exposed flat value-and-grad,
held bit for bit to the flat log-density it built inline before."""

import pytest
import torch

from gpbench.reference import icm as ref_icm
from portfoliooptgp_tpu_torch import kernels
from portfoliooptgp_tpu_torch.inference import sampler
from portfoliooptgp_tpu_torch.inference.sampler import flat_value_and_grad, sample_nuts
from portfoliooptgp_tpu_torch.inference.source import GeneratorSource
from portfoliooptgp_tpu_torch.models import gpr, icm
from portfoliooptgp_tpu_torch.params import ravel, tree_leaves, tree_replace, unravel
from portfoliooptgp_tpu_torch.pipelines.frontier_pipeline import frontier_logdensity
from portfoliooptgp_tpu_torch.utils import profiling

P, RANK, N, C = 4, 2, 24, 3


def _data(dtype, seed=0):
    """X (N, 1) a scaled day grid, Y (N, P) returns-sized noise with a shared factor."""
    g = torch.Generator().manual_seed(seed)
    X = torch.linspace(-1.7, 1.7, N, dtype=torch.float64)[:, None]
    f = torch.sin(2.0 * X)
    Y = 0.01 * (f * torch.randn(1, P, generator=g, dtype=torch.float64)
                + torch.randn(N, P, generator=g, dtype=torch.float64))
    return X.to(dtype), Y.to(dtype)


def _template(dtype):
    kern = kernels.SquaredExponential.create(device="cpu", dtype=dtype)
    m = icm.ICMGPR.create(kern, P, rank=RANK, noise_variance=1e-2,
                          generator=torch.Generator().manual_seed(0))
    return tree_replace(m, [x.detach() for x in tree_leaves(m)])


def _raw(seed, dtype=torch.float64):
    """Seeded raw parameters (C, dim) around a sound start: kernel variance
    and lengthscale near 1, noise near returns' variance."""
    g = torch.Generator().manual_seed(seed)
    z = 0.5 * torch.randn(C, ref_icm.dim(P, RANK), generator=g, dtype=torch.float64)
    z[:, 2] += -6.0  # σ² ≈ 2.5e-3
    z[:, 3:3 + P * RANK] *= 0.05
    z[:, 3 + P * RANK:] += -8.0  # κ ≈ 3e-4
    return z.to(dtype)


def test_reference_blocked_form_matches_dense_kronecker():
    X, Y = _data(torch.float64)
    z = _raw(1)
    dense = ref_icm.logp_and_grad(X, Y, z, P, RANK, form="dense")
    blocked = ref_icm.logp_and_grad(X, Y, z, P, RANK, form="blocked", block=2)
    torch.testing.assert_close(blocked[0], dense[0], rtol=1e-10, atol=0)
    torch.testing.assert_close(blocked[1], dense[1], rtol=1e-10,
                               atol=1e-10 * float(dense[1].abs().max()))


def _program_vg(dtype):
    X, Y = _data(dtype)
    template = _template(dtype)
    vg, flat0 = flat_value_and_grad(lambda m: frontier_logdensity(m, X, Y), template)
    assert flat0.shape == (1, ref_icm.dim(P, RANK))
    return vg, X, Y


@pytest.mark.parametrize("seed", [2, 3])
def test_frontier_logdensity_float64_matches_reference(seed):
    vg, X, Y = _program_vg(torch.float64)
    z = _raw(seed)
    gpr.DISPATCH_EVENTS.clear()
    logp, grad = vg(z)
    assert [e["tier"] for e in gpr.DISPATCH_EVENTS] == ["icm.plain"]
    ref_logp, ref_grad = ref_icm.logp_and_grad(X, Y, z, P, RANK)
    torch.testing.assert_close(logp, ref_logp, rtol=1e-10, atol=0)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-8,
                               atol=1e-8 * float(ref_grad.abs().max()))


@pytest.mark.parametrize("seed", [2, 3])
def test_frontier_logdensity_float32_fused_twin_matches_reference(seed):
    """In float32 the evaluation takes the fused tier (on the CPU its plain
    twin: the single-family forward and its closed-form backward). The
    log-density is a sum of P·N terms of order one that can nearly cancel
    (1.7 at one of these draws), each rounded to a few float32 ulps
    (ε = 1.2e-7): it reads 0.5–1.8e-6 of the total on four seeds, so 2e-5;
    the gradient reads 4–7e-7 of its largest entry, so 1e-5."""
    vg, X, Y = _program_vg(torch.float32)
    z = _raw(seed, torch.float32)
    gpr.DISPATCH_EVENTS.clear()
    logp, grad = vg(z)
    assert gpr.DISPATCH_EVENTS[-1] == {"tier": "icm.fused", "n": N, "batch": C * P}
    ref_logp, ref_grad = ref_icm.logp_and_grad(X.double(), Y.double(), z.double(), P, RANK)
    assert float(((logp.double() - ref_logp).abs() / ref_logp.abs()).max()) < 2e-5
    assert float((grad.double() - ref_grad).abs().max() / ref_grad.abs().max()) < 1e-5


def _evaluate(dtype):
    X, Y = _data(dtype)
    stacked = unravel(_template(dtype), _raw(4, dtype).requires_grad_(True))
    nll = icm.batched_neg_log_marginal_likelihood_chol(stacked, X, Y)
    return nll, tree_leaves(stacked)


def test_icm_evaluation_spans_and_tier():
    profiling.reset_spans()
    nll, leaves = _evaluate(torch.float32)
    torch.autograd.grad(nll.sum(), leaves, allow_unused=True)
    assert profiling.SPANS == {}
    gpr.DISPATCH_EVENTS.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        nll, leaves = _evaluate(torch.float32)
        forward = {k: v[0] for k, v in profiling.SPANS.items()}
        torch.autograd.grad(nll.sum(), leaves, allow_unused=True)
    assert forward == {"icm.nll": 1, "linalg.eigh": 1}
    assert {k: v[0] for k, v in profiling.SPANS.items()} == {
        "icm.nll": 1, "linalg.eigh": 1, "linalg.eigh_backward": 1, "nll.backward": 1}
    # eigh runs inside the ICM model's host part
    assert profiling.SPANS["icm.nll"][1] >= profiling.SPANS["linalg.eigh"][1]
    assert list(gpr.DISPATCH_EVENTS) == [{"tier": "icm.fused", "n": N, "batch": C * P}]


def test_sample_nuts_draws_what_its_inline_flat_logdensity_drew():
    X, Y = _data(torch.float64)
    m0 = unravel(_template(torch.float64), _raw(5)[:1])

    def logdensity(m):
        return frontier_logdensity(m, X, Y)

    kw = dict(num_warmup=4, num_samples=3, max_depth=4)
    samples, stats = sample_nuts(logdensity, m0, torch.Generator().manual_seed(7),
                                 num_chains=2, device="cpu", **kw)
    # the flat log-density as sample_nuts built it inline
    template = tree_replace(m0, [x.detach() for x in tree_leaves(m0)])

    def logp_flat(z):
        return logdensity(unravel(template, z))

    def autograd_vg(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            v = logp_flat(z)
            (g,) = torch.autograd.grad(v.sum(), z)
        return v.detach(), g

    key, k_init = GeneratorSource(2, torch.Generator().manual_seed(7)).split(2)
    with torch.no_grad():
        flat0 = ravel(template)
        q0 = flat0 + 0.1 * k_init.normal(flat0.shape[1:], flat0.dtype)
        qs, old = sampler._warmup_and_sample_flat(
            logp_flat, q0, key, kw["num_warmup"], kw["num_samples"], kw["max_depth"], 0.8,
            True, vg_fn=autograd_vg)
    for new_leaf, old_leaf in zip(tree_leaves(samples), tree_leaves(unravel(template, qs))):
        assert torch.equal(new_leaf, old_leaf)
    for a, b in zip(stats, old):
        assert torch.equal(a, b)
