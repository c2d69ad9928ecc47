"""The gram kernels' plain versions (ops/svgp_gram.py) against the JAX
package's Pallas kernels in interpret mode (`svgp_gram.gram_reduce(...,
interpret=True)`), and the eligibility rule of the kernel route.

Operands are `chip_smoke.gram_operands` at a small size: X on the
benchmark's 16k-day scale, a weight-0 tail, random t, y, Ḡ and s̄q.
Tolerances: float32, each output relative to its largest entry, values
2e-4 and gradients 3e-3 (5e-3 for ARD Matern), tests/test_svgp_gram_fused.py's,
against JAX's float64 run of the same inputs and against JAX's float32 run
within the larger of that and 4× JAX's own float32 error. The second rule
matters for s̄ alone: the TPU kernel expands it into z²·rW + x²·cW − 2z·WX,
which cancels at day coordinates (isotropic s̄ lies up to 9.2e-3 from
float64 in JAX's float32 run; the port takes it by differences, ~5e-7).
Float64: rtol 1e-9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.models import svgp as jsvgp
from portfoliooptgp_tpu.ops.pallas import svgp_gram as jgram
from portfoliooptgp_tpu_torch.models import svgp as tsvgp
from portfoliooptgp_tpu_torch.ops import svgp_gram as tgram
from test_torch_svgp import svgp_pair

torch.set_num_threads(1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


def _jax_gram(ops, family):
    """JAX's forward and VJP at the same operands (isotropic s as a scalar)."""
    Z, X, y, w, t, v, s, Gbar, sqbar = [jnp.asarray(a.numpy()) for a in ops]
    v = v.reshape(())
    s = s.reshape(()) if s.size == 1 else s.reshape(-1)

    def f(Z, y, t, v, s):
        return jgram.gram_reduce(Z, X, y, w, t, v, s, family, True)

    (G, sq), vjp = jax.vjp(f, Z, y, t, v, s)
    return (G, sq), vjp((Gbar, sqbar.reshape(())))


@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("family", tgram.FAMILIES)
def test_torch_gram_reduce_plain_matches_jax_interpret(family, D):
    """Forward and VJP of `gram_reduce` (the port's autograd binding, plain
    versions on the CPU) against JAX's interpret-mode kernels, float32."""
    ops = cs.gram_operands(32, 300, D, seed=40 + D, device="cpu")
    (jG, jsq), (jZ, jy, jt, jv, js) = _jax_gram(ops, family)
    _, jbars64 = _jax_gram([a.double() for a in ops], family)
    Z, X, y, w, t, v, s, Gbar, sqbar = ops
    leaves = [a.clone().requires_grad_(True) for a in (Z, y, t, v, s)]
    G, sq = tgram.gram_reduce(leaves[0], X, leaves[1], w, leaves[2], leaves[3], leaves[4],
                              family)
    assert _rel(G.detach(), jG) <= 2e-4 and _rel(sq.detach(), jsq) <= 2e-4
    grads = torch.autograd.grad((G, sq), leaves, (Gbar, sqbar))
    gtol = 5e-3 if (D > 1 and family != "se") else 3e-3
    for name, g, want, want64, leaf in zip(("Z", "y", "t", "v", "s"), grads,
                                           (jZ, jy, jt, jv, js), jbars64, leaves):
        assert g.shape == leaf.shape
        g = g.reshape(np.shape(want))
        assert _rel(g, want64) <= gtol, name
        assert _rel(g, want) <= max(gtol, 4 * _rel(want, want64)), name
    assert torch.all(grads[1][int(w.sum()):] == 0)  # weight-0 rows: exactly zero ȳ


@pytest.mark.parametrize("family", ["se", "matern12"])
def test_torch_gram_reduce_plain_float64_matches_jax(family):
    ops = cs.gram_operands(16, 200, 2, seed=50, device="cpu", dtype=torch.float64)
    (jG, jsq), jbars = _jax_gram(ops, family)
    Z, X, y, w, t, v, s, Gbar, sqbar = ops
    G, sq = tgram.gram_fwd_plain(Z, X, y, w, t, v, s, family)
    np.testing.assert_allclose(G.numpy(), np.asarray(jG), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(sq), float(jsq), rtol=1e-12)
    zbar, ybar, tbar, vbar, sbar = tgram.gram_bwd_plain(Z, X, y, w, t, v, s, family, Gbar, sqbar)
    for got, want in zip((zbar, ybar, tbar, vbar, sbar), jbars):
        assert _rel(got.numpy().reshape(np.shape(want)), want) <= 1e-9


def test_torch_gram_zero_weight_rows_contribute_nothing():
    """Changing X and y on weight-0 rows changes neither output nor any
    parameter gradient (the iterator pads every epoch's last batch so)."""
    Z, X, y, w, t, v, s, Gbar, sqbar = cs.gram_operands(24, 256, 1, seed=3, device="cpu")
    X2, y2 = X.clone(), y.clone()
    X2[w == 0] = 0.0
    y2[w == 0] = 0.0
    a = tgram.gram_fwd_plain(Z, X, y, w, t, v, s, "matern32")
    b = tgram.gram_fwd_plain(Z, X2, y2, w, t, v, s, "matern32")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    ga = tgram.gram_bwd_plain(Z, X, y, w, t, v, s, "matern32", Gbar, sqbar)
    gb = tgram.gram_bwd_plain(Z, X2, y2, w, t, v, s, "matern32", Gbar, sqbar)
    for p, q in zip(ga, gb):
        assert torch.equal(p, q)


def test_torch_gram_operands_shapes_and_checks():
    ops = cs.gram_operands(16, 2048, 3, seed=0, device="cpu")
    assert [tuple(a.shape) for a in ops] == [(16, 3), (2048, 3), (2048,), (2048,), (16,), (1,),
                                             (1, 3), (16, 16), ()]
    assert int(ops[3].sum()) == 2048 - 1325
    Z, X, y, w, t, v, s, _, _ = ops
    with pytest.raises(ValueError, match="M % 8"):
        tgram.gram_fwd_plain(Z[:12], X, y, w, t[:12], v, s, "se")
    with pytest.raises(ValueError, match="family"):
        tgram.gram_fwd_plain(Z, X, y, w, t, v, s, "rq")
    with pytest.raises(TypeError):  # a CPU tensor never reaches the kernel
        tgram.gram_fwd_cuda(Z, X, y, w, t, v, s, "se")
    assert tgram.tile_width(128) == 64 and tgram.tile_width(512) % 4 == 0


def _eligibility_cases():
    """(label, kernel name, create kwargs, model edits, n, dtype): the cases
    of tests/test_svgp_gram_fused.py and the ineligible variants."""
    return [
        ("se", "SquaredExponential", {}, {}, 96, np.float32),
        ("weighted_padding_n100", "SquaredExponential", {}, {}, 100, np.float32),
        ("ard_matern32", "Matern32", dict(lengthscales=np.linspace(2.0, 5.0, 3)), {"D": 3}, 96,
         np.float32),
        ("constant_mean", "SquaredExponential", {}, {"mean": 0.7}, 96, np.float32),
        ("matern12", "Matern12", {}, {}, 96, np.float32),
        ("matern52", "Matern52", {}, {}, 96, np.float32),
        ("rational_quadratic", "RationalQuadratic", {}, {}, 96, np.float32),
        ("float64", "SquaredExponential", {}, {}, 96, np.float64),
        ("cli_default_m20", "SquaredExponential", {}, {"M": 20}, 96, np.float32),
        ("b_8192", "SquaredExponential", {}, {}, 8192, np.float32),
        ("b_8193", "SquaredExponential", {}, {}, 8193, np.float32),
        ("two_latents", "SquaredExponential", {}, {"P": 2}, 96, np.float32),
    ]


@pytest.mark.parametrize("case", _eligibility_cases(), ids=lambda c: c[0])
def test_torch_svgp_gram_fused_supported_matches_jax(case):
    _, kernel, create, edits, n, dtype = case
    jm, tm = svgp_pair(kernel, dtype=dtype, **create, **edits)
    X = np.zeros((n, edits.get("D", 1)), dtype)
    want = jsvgp.svgp_gram_fused_supported(jm, jnp.asarray(X))
    assert tsvgp.svgp_gram_fused_supported(tm, torch.tensor(X)) == want


def test_torch_svgp_gram_fused_unsupported_kernels_match_jax():
    """A sum kernel and a kernel with active_dims are ineligible in both."""
    jm, tm = svgp_pair(dtype=np.float32)
    X = np.zeros((96, 1), np.float32)
    from portfoliooptgp_tpu_torch import kernels as tk

    for jkern, tkern in (
            (jk.SquaredExponential.create() + jk.Matern12.create(),
             tk.SquaredExponential.create(device="cpu") + tk.Matern12.create(device="cpu")),
            (jk.SquaredExponential.create(active_dims=[0]),
             tk.SquaredExponential.create(active_dims=[0], device="cpu"))):
        want = jsvgp.svgp_gram_fused_supported(dataclasses.replace(jm, kernel=jkern),
                                               jnp.asarray(X))
        got = tsvgp.svgp_gram_fused_supported(dataclasses.replace(tm, kernel=tkern),
                                              torch.tensor(X))
        assert got == want is False
