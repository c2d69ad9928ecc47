"""The stationary NLL backward's plain twin (`stationary_nll_grad_plain`)
against autograd through the plain forward.

The twin walks the backward kernel's algorithm (α from W's lower triangle,
the lower-triangular 32 × 32 tile pairs of K⁻¹ = WᵀW from the rows at and
below each tile's row, the tiles below the diagonal counted twice, the mask,
each family's φ' and ∂φ/∂α, the sum and product rules). In float64 it must
give the gradient that autograd takes through `stationary_nll_forward_plain`
(Cholesky, triangular solves) for a random cotangent of the NLLs, to
normalized 1e-9: the same gradient summed in another order. Last, both
the port's float64 gradient and the twin's against jax.grad of the JAX
package's NLL (tests/goldens_torch/stationary_grad.json), the golden that
the card's kernel is held to in tests/test_torch_cuda.py.
"""

import functools
import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
from portfoliooptgp_tpu_torch.ops import stationary_nll as st

torch.set_num_threads(1)

B = 2


def _inputs(families, dims, N, masked, seed):
    """float64 operands: per-dim squared distances (a Gram matrix for
    'linear') of sorted inputs, the last model keeping N − 5 rows when
    masked, and a cotangent g. The distances carry 1e-300 on their
    diagonal, so that autograd's derivative of √u exists there (at 0 it
    is 0 · ∞); that moves no gradient by more than ~1e-150."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 6, (N, 4)), axis=0)
    d2s = []
    for fam, dj in zip(families, dims):
        for d in range(dj):
            x = X[:, 0 if fam == "periodic_se" else d]  # periodic: PSD on one input only
            d2s.append(np.outer(x, x) / 36.0 if fam == "linear"
                       else (x[:, None] - x[None, :]) ** 2 + 1e-300 * np.eye(N))
    keep = np.array([N, N - 5 if masked else N])
    mask = (np.arange(N)[None, :] < keep[:, None]).astype(float)
    J, JD = len(families), len(d2s)

    def t(x):
        return torch.tensor(np.asarray(x), dtype=torch.float64)

    return dict(d2s=t(np.stack(d2s)), err=t(rng.normal(size=(B, N)) * mask),
                vs=t(rng.uniform(0.5, 1.5, (J, B))), ls=t(rng.uniform(1.0, 3.0, (JD, B))),
                als=t(rng.uniform(1.0, 2.5, (J, B))), noise=t(rng.uniform(0.3, 0.6, B)),
                mask=t(mask) if masked else None, g=t(rng.normal(size=B)))


def _autograd(families, combine, dims, x):
    """The forward's W, a and autograd's gradients of Σ g·nll with respect
    to (vs, ls, als, noise, err), zeros where α-free families leave als
    unused."""
    leaves = [x[k].clone().requires_grad_(True) for k in ("vs", "ls", "als", "noise", "err")]
    vs, ls, als, noise, err = leaves
    nll, W, a = st.stationary_nll_forward_plain(families, combine, dims, x["d2s"], err, vs,
                                                1.0 / (ls * ls), als, noise, x["mask"], True)
    assert torch.all(torch.isfinite(nll))
    grads = torch.autograd.grad(torch.sum(x["g"] * nll), leaves, allow_unused=True)
    return W.detach(), a.detach(), [torch.zeros_like(v) if d is None else d
                                    for v, d in zip(leaves, grads)]


def _assert_close(got, want, names=("dv", "dl", "dal", "dnoise", "derr"), atol=1e-9):
    for name, g, w in zip(names, got, want):
        scale = max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=atol, msg=name)


@pytest.mark.parametrize("N", [40, 77, 130, 262])
@pytest.mark.parametrize("dims", [(1, 1), (4,)], ids=["pair", "ard4"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("combine", ["prod", "sum"])
@pytest.mark.parametrize("family", st.GENERAL_FAMILIES)
def test_torch_stationary_grad_plain_matches_autograd(family, combine, masked, dims, N):
    """Each family (beside an SE atom, or alone as an ARD atom over 4 d2
    matrices), summed and multiplied, masked and not, at N from one tile
    row to grid A's 262 (T = 2, 3, 5, 9 tile rows)."""
    families = (family, "se") if dims == (1, 1) else (family,)
    seed = 31 * st.GENERAL_FAMILIES.index(family) + 7 * len(dims) + N + (3 if masked else 0)
    x = _inputs(families, dims, N, masked, seed)
    W, a, want = _autograd(families, combine, dims, x)
    got = st.stationary_nll_grad_plain(families, combine, dims, x["d2s"], W, a, x["g"],
                                       x["vs"], x["ls"], x["als"], x["mask"])
    dv, dl, dal, dnoise, derr = want
    if family not in ("rq", "periodic_se"):
        assert torch.all(got[2][0] == 0)
    _assert_close(got, (dv, dl, dal, dnoise, derr))


@pytest.mark.parametrize("N", [40, 262])
@pytest.mark.parametrize("family", st.FAMILIES)
def test_torch_stationary_grad_plain_single_family(family, N):
    """The single-family path's operands (one atom, one d2 matrix, no mask,
    α none): the twin against autograd through `batched_nll_stationary_plain`
    (the `_SingleNLL` forward) for v, ℓ, σ² and err."""
    x = _inputs((family,), (1,), N, False, 500 + N + st.FAMILIES.index(family))
    leaves = [x["vs"][0].clone().requires_grad_(True), x["ls"][0].clone().requires_grad_(True),
              x["noise"].clone().requires_grad_(True), x["err"].clone().requires_grad_(True)]
    v, l, noise, err = leaves
    nll = st.batched_nll_stationary_plain(x["d2s"][0], err, v, l, noise, family)
    dv, dl, dnoise, derr = torch.autograd.grad(torch.sum(x["g"] * nll), leaves)
    _, W, a = st.stationary_nll_forward_plain(
        (family,), "prod", (1,), x["d2s"], x["err"], x["vs"], 1.0 / x["ls"] ** 2,
        torch.ones_like(x["vs"]), x["noise"], None, True)
    got = st.stationary_nll_grad_plain((family,), "prod", (1,), x["d2s"], W, a, x["g"],
                                       x["vs"], x["ls"], None, None)
    _assert_close([got[0][0], got[1][0], got[3], got[4]], [dv, dl, dnoise, derr],
                  ("dv", "dl", "dnoise", "derr"))


# -- against the JAX package's gradient (tests/goldens_torch/stationary_grad.json) --

@functools.lru_cache(maxsize=1)
def _jax_golden():
    with open(cs.GRAD_GOLDENS) as fh:
        return json.load(fh)["cases"]


@pytest.mark.parametrize("label", list(cs.GRAD_GOLDEN_CASES))
def test_torch_stationary_grad_matches_jax_golden(label):
    """The golden that the card's backward kernel is held to: jax.grad of
    the JAX package's NLL in float64 on `chip_smoke.grad_golden_operands`.
    On the same operands in float64 on the CPU, the port's gradient through
    autograd (the plain forward and the torch closed form) and the twin on
    that forward's W and a both match it to normalized 1e-8."""
    families, dims, combine, _, N, masked, single = cs.GRAD_GOLDEN_CASES[label]
    want = _jax_golden()[label]
    ops = cs.grad_golden_operands(label)
    assert cs.grad_golden_checksum(ops) == pytest.approx(want["checksum"], rel=1e-12)
    d2s, err, vs, ls, als, noise, mask, g = (
        torch.tensor(np.stack(x) if isinstance(x, list) else x, dtype=torch.float64) for x in ops)
    leaves = [x.clone().requires_grad_(True) for x in (err, noise, vs, ls, als)]
    e, nz, v, l, al = leaves
    if single:
        nll = st.batched_nll_stationary(d2s[0], e, v[0], l[0], nz, families[0])
    else:
        fn = {"prod": st.batched_nll_stationary_general, "sum": st.batched_nll_stationary_sum}
        nll = fn[combine](families, d2s, e, list(v), list(l), list(al), nz, mask, dims=dims)
    got = torch.autograd.grad(torch.sum(g * nll), leaves, allow_unused=True)
    got = [torch.zeros_like(x) if d is None else d for x, d in zip(leaves, got)]
    ref = [torch.tensor(want[k], dtype=torch.float64)
           for k in ("derr", "dnoise", "dv", "dl", "dal")]
    torch.testing.assert_close(nll.detach(), torch.tensor(want["nll"], dtype=torch.float64),
                               rtol=1e-9, atol=0)
    _assert_close(got, ref, ("derr", "dnoise", "dv", "dl", "dal"), atol=1e-8)
    _, W, a = st.stationary_nll_forward_plain(families, combine, dims, d2s, err, vs,
                                              1.0 / (ls * ls), als, noise,
                                              None if single else mask, True)
    dv, dl, dal, dnoise, derr = st.stationary_nll_grad_plain(
        families, combine, dims, d2s, W, a, g, vs, ls, None if single else als,
        None if single else mask)
    _assert_close([derr, dnoise, dv, dl, dal], ref, ("derr", "dnoise", "dv", "dl", "dal"),
                  atol=1e-8)
