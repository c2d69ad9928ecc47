"""The CUDA kernels (stationary NLL, blocked panel factor, triangular
inverse, dense NLL, SVGP gram) against their plain PyTorch versions.

Needs an NVIDIA GPU and nvcc (marker `cuda`); skipped elsewhere. Float32
on the card with the tolerances of the matching checks in
tools/smoke_tpu.py: values rtol 3e-3, gradients normalized atol 2e-2.
Run on the card with
`python -m pytest --noconftest tests/test_torch_cuda.py -m cuda`.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
from portfoliooptgp_tpu_torch.ops import stationary_nll as st

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(cuda, families, dims, B, N, seed):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 30, (N, max(dims))), axis=0)
    d2s = [(X[:, d, None] - X[None, :, d]) ** 2 for dj in dims for d in range(dj)]
    mask = (np.arange(N)[None, :] < (N - np.arange(B) * 3)[:, None]).astype(float)

    def t(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=cuda, requires_grad=True)

    J, JD = len(families), len(d2s)
    return ([t(d) for d in d2s], t(rng.normal(size=(B, N)) * mask),
            [t(rng.uniform(0.5, 2.0, B)) for _ in range(J)],
            [t(rng.uniform(3.0, 8.0, B)) for _ in range(JD)],
            [t(rng.uniform(1.0, 3.0, B)) for _ in range(J)], t(rng.uniform(0.05, 0.3, B)),
            torch.tensor(mask, dtype=torch.float32, device=cuda))


@pytest.mark.parametrize("combine", ["prod", "sum"])
@pytest.mark.parametrize("families,dims,N", [
    (("matern12", "matern12"), (1, 1), 77),
    (("se", "rq"), (3, 1), 130),
    (("matern32",), (1,), 400),  # the cluster kernel, C = 4
])
def test_torch_cuda_general_kernel_matches_plain(cuda, combine, families, dims, N):
    d2s, err, vs, ls, als, noise, mask = _operands(cuda, families, dims, 6, N, 0)
    leaves = d2s + [err] + vs + ls + als + [noise]
    fns = {"prod": (st.batched_nll_stationary_general, st.batched_nll_stationary_general_plain),
           "sum": (st.batched_nll_stationary_sum, st.batched_nll_stationary_sum_plain)}[combine]
    before = st.LAUNCHES["stationary_nll_general"]
    outs = []
    for fn in fns:
        nll = fn(families, d2s, err, vs, ls, als, noise, mask, dims=dims)
        outs.append((nll.detach(), torch.autograd.grad(nll.sum(), leaves)))
    torch.cuda.synchronize()
    assert st.LAUNCHES["stationary_nll_general"] == before + 1
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=3e-3, atol=0)
    for g, w in zip(outs[0][1], outs[1][1]):
        scale = max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=2e-2)


@pytest.mark.parametrize("family", st.FAMILIES)
def test_torch_cuda_single_kernel_matches_plain(cuda, family):
    d2s, err, vs, ls, _, noise, _ = _operands(cuda, (family,), (1,), 32, 256, 1)
    args = [d2s[0], err, vs[0], ls[0], noise]
    outs = []
    for fn in (st.batched_nll_stationary, st.batched_nll_stationary_plain):
        nll = fn(*args, family)
        outs.append((nll.detach(), torch.autograd.grad(nll.sum(), args)))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=3e-3, atol=0)
    for g, w in zip(outs[0][1], outs[1][1]):
        scale = max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=2e-2)


def test_torch_cuda_kernel_indefinite_gives_nan(cuda):
    d2s, err, vs, ls, _, noise, _ = _operands(cuda, ("se",), (1,), 4, 50, 2)
    with torch.no_grad():
        nll = st.batched_nll_stationary(d2s[0], err, vs[0], ls[0], -noise - 3.0, "se")
    assert torch.all(torch.isnan(nll))


@pytest.mark.parametrize("kind", ["unmasked", "masked", "indefinite"])
@pytest.mark.parametrize("N", [1, 31, 32, 33, 64, 65, 255, 256, 288, 289, 300, 400, 448, 512])
def test_torch_cuda_stationary_kernel_tile_edges(cuda, N, kind):
    """The stationary kernel, with and without W, at the tile kernel's edges
    and past them on the cluster kernel (clusters of 2, 4 or 8 by N; 288 and
    289 either side of T = 9 .. 10) against the plain version at phase 2b's
    tolerances (chip_smoke.check_stationary): unmasked; masked, the last
    model keeping N // 8 rows (every tile past its first empty from N = 64,
    and every row of whole ranks at 257 .. 263 and from 353 on); and with an indefinite last
    model, NaN where the plain version has it and W's and a's NaN pattern
    the plain column loop's. Each launch runs the kernel its N routes to
    (the tile kernel up to 256)."""
    import chip_smoke as cs

    cases = {"unmasked": (("se", "matern32"), "prod", cs.edge_keeps(N, 3, False)),
             "masked": (("matern12", "matern12"), "prod", cs.edge_keeps(N, 3, True)),
             "indefinite": (("se", "linear"), "sum", cs.edge_keeps(N, 3, False))}
    families, combine, keeps = cases[kind]
    err = cs.check_stationary(f"stationary {kind} N={N}", families, (1, 1), combine, N, keeps,
                              600 + N, indefinite=kind == "indefinite")
    assert np.isfinite(err)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("N", [1, 31, 32, 33, 64, 65, 255, 256])
def test_torch_cuda_stationary_tile_kernel_gradients(cuda, N, masked):
    """Values and gradients of every operand through the tile kernel against
    the plain version at the tile edges (chip_smoke.check_general: values
    rtol 3e-3, gradients normalized atol 2e-2)."""
    import chip_smoke as cs

    cs.check_general(f"tile N={N}", ("matern12", "matern12"), (1, 1), "prod", 3, N, masked,
                     700 + N)


@pytest.mark.parametrize("combine", ["prod", "sum"])
@pytest.mark.parametrize("family", st.GENERAL_FAMILIES)
def test_torch_cuda_stationary_tile_kernel_families(cuda, family, combine):
    """Each of the 7 families beside an SE atom, summed and multiplied,
    masked, at N = 100 on the tile kernel: values and gradients against the
    plain version (chip_smoke.check_general)."""
    import chip_smoke as cs

    before = st.kernel_launches()
    cs.check_general(f"tile {family} {combine} se", (family, "se"), (1, 1), combine, 6, 100,
                     True, 800 + st.GENERAL_FAMILIES.index(family))
    after = st.kernel_launches()
    assert after["tile"] > before["tile"] and after["cluster"] == before["cluster"]


@pytest.mark.parametrize("dims,N", [((4, 1), 96), ((3, 2), 256)])
def test_torch_cuda_stationary_tile_kernel_ard(cuda, dims, N):
    """ARD atoms (several shared d2 matrices per atom) on the tile kernel:
    values and gradients against the plain version."""
    import chip_smoke as cs

    cs.check_general(f"tile ARD {dims} N={N}", ("se", "matern52"), dims, "prod", 4, N, True,
                     900 + N)


@pytest.mark.parametrize("N,route", [(40, "tile"), (175, "tile"), (256, "tile"),
                                     (257, "cluster"), (262, "cluster"), (353, "cluster"),
                                     (480, "cluster"), (512, "cluster")])
def test_torch_cuda_stationary_kernel_routes_by_n(cuda, N, route):
    """batched_nll_stationary's value and value+grad launch the tile kernel at
    N <= 256 (the weekly and monthly menus, the headline) and the cluster
    kernel above (frontier grid A's 262, up to the window's 512 at every
    cluster size), once each, as the C entry point counts."""
    d2s, err, vs, ls, _, noise, _ = _operands(cuda, ("se",), (1,), 2, N, 3)
    before = st.kernel_launches()
    with torch.no_grad():
        st.batched_nll_stationary(d2s[0], err, vs[0], ls[0], noise, "se")
    nll = st.batched_nll_stationary(d2s[0], err, vs[0], ls[0], noise, "se")
    torch.autograd.grad(nll.sum(), [vs[0]])
    torch.cuda.synchronize()
    after = st.kernel_launches()
    other = "cluster" if route == "tile" else "tile"
    assert after[route] == before[route] + 2 and after[other] == before[other]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("N", [257, 288, 289, 352, 353, 448, 449, 512])
def test_torch_cuda_stationary_cluster_kernel_gradients(cuda, N, masked):
    """Values and gradients of every operand through the cluster kernel
    against the plain version, both sides of each step of the tile count's
    and the cluster size's (chip_smoke.check_general: values rtol 3e-3,
    gradients normalized atol 2e-2); only the cluster counter moves."""
    import chip_smoke as cs

    before = st.kernel_launches()
    cs.check_general(f"cluster N={N}", ("matern12", "matern12"), (1, 1), "prod", 3, N, masked,
                     1000 + N)
    after = st.kernel_launches()
    assert after["cluster"] > before["cluster"] and after["tile"] == before["tile"]


@pytest.mark.parametrize("combine", ["prod", "sum"])
@pytest.mark.parametrize("family", st.GENERAL_FAMILIES)
def test_torch_cuda_stationary_cluster_kernel_families(cuda, family, combine):
    """Each of the 7 families beside an SE atom, summed and multiplied,
    masked, at N = 300 on the cluster kernel: values and gradients against
    the plain version (chip_smoke.check_general)."""
    import chip_smoke as cs

    before = st.kernel_launches()
    cs.check_general(f"cluster {family} {combine} se", (family, "se"), (1, 1), combine, 4, 300,
                     True, 1600 + st.GENERAL_FAMILIES.index(family))
    after = st.kernel_launches()
    assert after["cluster"] > before["cluster"] and after["tile"] == before["tile"]


def test_torch_cuda_stationary_cluster_kernel_ard_nuts_shape(cuda):
    """The NUTS posterior's shape, B = 8 chains of an ARD SE kernel over
    D = 4 at N = 512 (C = 8): values and gradients against the plain
    version."""
    import chip_smoke as cs

    cs.check_general("cluster ARD se D=4 (8, 512)", ("se",), (4,), "prod", 8, 512, False, 1700)


@pytest.mark.parametrize("N,C", [(257, 2), (262, 2), (352, 2), (353, 4), (448, 4), (449, 8),
                                 (480, 8), (512, 8)])
def test_torch_cuda_stationary_cluster_sizes(cuda, N, C):
    """The cluster size the entry point picks at N (the smallest of 2, 4
    and 8 that fits, whatever B) and, at that size, both variants against
    the plain version, masked and with an indefinite last model
    (chip_smoke.check_stationary), at B = 3 and at frontier grid A's 20."""
    import chip_smoke as cs

    assert st.cluster_shape(N)["C"] == C
    for B in (3, 20):
        cs.check_stationary(f"C={C} masked N={N} B={B}", ("matern12", "matern12"), (1, 1),
                            "prod", N, cs.edge_keeps(N, B, True), 1800 + N)
        cs.check_stationary(f"C={C} indefinite N={N} B={B}", ("se", "linear"), (1, 1), "sum", N,
                            cs.edge_keeps(N, B, False), 1900 + N, indefinite=True)


@pytest.mark.parametrize("N", [262, 400, 480])
def test_torch_cuda_stationary_cluster_kernel_independent_of_batch(cuda, N):
    """One model's NLL, a and W from the cluster kernel are bitwise the
    same alone and as the first of a batch of 3, 20 or 40 (masked Matern12
    x Matern12, with W): the kernel's arithmetic depends on N alone."""
    families = ("matern12", "matern12")
    d2s, err, vs, ls, als, noise, mask = _operands(cuda, families, (1, 1), 40, N, 2000 + N)
    outs = []
    with torch.no_grad():
        D2, V, S, A = (torch.stack(d2s), torch.stack(vs), 1.0 / torch.stack(ls) ** 2,
                       torch.stack(als))
        for B in (1, 3, 20, 40):
            got = st.stationary_nll_forward_cuda(
                families, "prod", (1, 1), D2, err[:B].contiguous(), V[:, :B].contiguous(),
                S[:, :B].contiguous(), A[:, :B].contiguous(), noise[:B].contiguous(),
                mask[:B].contiguous(), True, "stationary_nll_general")
            outs.append([g[:1] for g in got])
    torch.cuda.synchronize()
    for got in outs[1:]:
        for g, alone in zip(got, outs[0]):
            assert torch.equal(g, alone)


# -- the stationary NLL backward (csrc/stationary_nll.cu: stationary_nll_grad_kernel) --

def _grad_pair(fn, d2s, others, g=None):
    """Gradients of Σ nll·g through `fn(d2s, *others)` for each operand in
    `others`, once on the backward kernel (d2s need no gradient) and once
    on the torch closed form (d2s need one), and g (a ramp unless given);
    the kernel's launch count moves by one, the closed form's by none."""
    out = []
    for d2_grad in (False, True):
        d = [x.detach().clone().requires_grad_(d2_grad) for x in d2s]
        leaves = [x.detach().clone().requires_grad_(True) for x in others]
        before = st.LAUNCHES["stationary_nll_grad"], st.kernel_launches()["grad"]
        nll = fn(d, *leaves)
        if g is None:
            g = torch.linspace(-1.0, 1.5, nll.shape[0], device=nll.device)
        grads = torch.autograd.grad(torch.sum(nll * g), leaves)
        torch.cuda.synchronize()
        moved = 0 if d2_grad else 1
        assert st.LAUNCHES["stationary_nll_grad"] == before[0] + moved
        assert st.kernel_launches()["grad"] == before[1] + moved
        out.append(grads)
    return out[0], out[1], g


def _gap(got, want):
    """The largest gap over the gradients, each normalized by max(|want|, 1)."""
    worst = 0.0
    for x, w in zip(got, want):
        scale = max(float(w.abs().max()), 1.0)
        worst = max(worst, float((x.double() - w).abs().max()) / scale)
    return worst


def _assert_kernel_as_close(label, kernel, closed, truth):
    """The kernel's float32 gradients as close to the float64 closed form on
    the same W and a as the torch closed form's float32 ones are (within 3
    times their gap, or 1e-5)."""
    assert all(torch.all(torch.isfinite(x)) for x in kernel), label
    gk, gt = _gap(kernel, truth), _gap(closed, truth)
    print(f"grad kernel {label}: normalized gap to float64 {gk:.3e}, torch closed form's {gt:.3e}")
    assert gk <= max(3.0 * gt, 1e-5), f"{label}: kernel gap {gk:.3e}, closed form's {gt:.3e}"


def _general_grads(families, dims, combine, B, N, masked, seed):
    d2s, err, vs, ls, als, noise, mask = cs.general_operands(families, dims, B, N, masked, seed)
    fn = {"prod": st.batched_nll_stationary_general, "sum": st.batched_nll_stationary_sum}[combine]
    J, JD = len(vs), len(ls)

    def call(d, e, nz, *rest):
        v, l, a = rest[:J], rest[J:J + JD], rest[J + JD:]
        return fn(families, d, e, v, l, a, nz, mask, dims=dims)

    kernel, closed, g = _grad_pair(call, d2s, [err, noise] + vs + ls + als)
    D2, V, L, A = (torch.stack(x) for x in (d2s, vs, ls, als))
    with torch.no_grad():
        _, W, a = st.stationary_nll_forward_cuda(families, combine, dims, D2, err, V,
                                                 1.0 / (L * L), A, noise, mask, True,
                                                 "stationary_nll_general")
        _, derr, dv, dl, dal, dnoise = st.stationary_nll_grad_torch(
            families, combine, dims, *(x.double() for x in (D2, W, a, g, V, L, A, mask)), False)
    truth = [derr, dnoise, *dv, *dl, *dal]
    _assert_kernel_as_close(f"{families} {dims} {combine} ({B}, {N}) masked={masked}",
                            kernel, closed, truth)


@pytest.mark.parametrize("N", [40, 77, 256, 257, 512])
@pytest.mark.parametrize("case", ["m12xm12 prod masked", "se x rq ARD sum masked",
                                  "periodic + linear sum"])
def test_torch_cuda_stationary_grad_kernel_edges(cuda, case, N):
    """The backward kernel against the torch closed form on the same
    forward's W and a, on both sides of the tile and cluster kernels' edge
    (one, three, eight, nine and sixteen tile rows)."""
    families, dims, combine, masked = {
        "m12xm12 prod masked": (("matern12", "matern12"), (1, 1), "prod", True),
        "se x rq ARD sum masked": (("se", "rq"), (3, 1), "sum", True),
        "periodic + linear sum": (("periodic_se", "linear"), (1, 1), "sum", False)}[case]
    _general_grads(families, dims, combine, 5, N, masked, 2100 + N)


@pytest.mark.parametrize("combine", ["prod", "sum"])
@pytest.mark.parametrize("family", st.GENERAL_FAMILIES)
def test_torch_cuda_stationary_grad_kernel_families(cuda, family, combine):
    """Each of the 7 families beside an SE atom, summed and multiplied,
    masked, on the backward kernel against the torch closed form."""
    _general_grads((family, "se"), (1, 1), combine, 6, 300,
                   True, 2200 + st.GENERAL_FAMILIES.index(family))


@pytest.mark.parametrize("case", ["nuts (128, 512) ARD D=4", "wf2y (80, 504) m12xm12 masked"])
def test_torch_cuda_stationary_grad_kernel_cell_shapes(cuda, case):
    """The benchmark cells' general-path shapes: the NUTS cell's 128
    chains of ARD SE over D = 4 at N = 512, unmasked; the walk-forward's
    80 rows of the masked Matern12 × Matern12 product at N = 504."""
    if case.startswith("nuts"):
        _general_grads(("se",), (4,), "prod", 128, 512, False, 2300)
    else:
        _general_grads(("matern12", "matern12"), (1, 1), "prod", 80, 504, True, 2301)


@pytest.mark.parametrize("B,N", [(32, 256), (2560, 262)])
@pytest.mark.parametrize("family", st.FAMILIES)
def test_torch_cuda_stationary_grad_kernel_single(cuda, family, B, N):
    """The single-family path (`batched_nll_stationary`, the ICM cell's
    (2560, 262) among them) on the backward kernel against its torch closed
    form."""
    d2s, err, vs, ls, _, noise, _ = cs.general_operands((family,), (1,), B, N, False,
                                                        2400 + N + st.FAMILIES.index(family))

    def call(d, e, v, l, nz):
        return st.batched_nll_stationary(d[0], e, v, l, nz, family)

    kernel, closed, g = _grad_pair(call, d2s, [err, vs[0], ls[0], noise])
    one = torch.ones_like(vs[0])[None]
    with torch.no_grad():
        _, W, a = st.stationary_nll_forward_cuda((family,), "prod", (1,), d2s[0][None], err,
                                                 vs[0][None], 1.0 / (ls[0] * ls[0])[None], one,
                                                 noise, None, True, "stationary_nll")
        _, derr, dv, dl, _, dnoise = st.stationary_nll_grad_torch(
            (family,), "prod", (1,), *(x.double() for x in (
                d2s[0][None], W, a, g, vs[0][None], ls[0][None], one, torch.ones_like(err))),
            False)
    _assert_kernel_as_close(f"single {family} ({B}, {N})", kernel, closed,
                            [derr, dv[0], dl[0], dnoise])


@pytest.mark.parametrize("label", list(cs.GRAD_GOLDEN_CASES))
def test_torch_cuda_stationary_grad_kernel_matches_jax(cuda, label):
    """The backward kernel against jax.grad of the JAX package's NLL in
    float64 (tests/goldens_torch/stationary_grad.json, on the same operands:
    the golden's models, float32 values, repeated to the case's B, the
    benchmark cells' shapes among them), through the autograd path the main
    path takes (the d2s need no gradient). Its gradients are as close to
    JAX's as the torch closed form's are on the same float32 operands:
    within 3 times the larger of the closed form's gaps in two orders of
    its float32 sums, on the card (the d2s need a gradient) and on the CPU
    from the card's W and a (the golden's models), or 1e-5. The sums cancel
    far below their terms' scale, so one float32 order can land 2-4 times
    closer than another."""
    families, dims, combine, B, N, masked, single = cs.GRAD_GOLDEN_CASES[label]
    with open(cs.GRAD_GOLDENS) as fh:
        want = json.load(fh)["cases"][label]
    ops = cs.grad_golden_operands(label)
    assert cs.grad_golden_checksum(ops) == pytest.approx(want["checksum"], rel=1e-12)
    rep = -(-B // cs.GRAD_GOLDEN_MODELS)

    def models(x, dtype=torch.float32):  # the golden's models, repeated to B
        x = np.asarray(x)
        return torch.tensor(np.tile(x, (rep,) + (1,) * (x.ndim - 1))[:B], dtype=dtype,
                            device=cuda)

    d2s, err, vs, ls, als, noise, mask, g = ops
    d2s = [torch.tensor(d, dtype=torch.float32, device=cuda) for d in d2s]
    err, noise, mask, g = models(err), models(noise), models(mask), models(g)
    vs, ls, als = ([models(x) for x in xs] for xs in (vs, ls, als))
    derr, dnoise = models(want["derr"], torch.float64), models(want["dnoise"], torch.float64)
    dv, dl, dal = ([models(x, torch.float64) for x in want[k]] for k in ("dv", "dl", "dal"))
    if single:
        def call(d, e, v, l, nz):
            return st.batched_nll_stationary(d[0], e, v, l, nz, families[0])

        others, truth = [err, vs[0], ls[0], noise], [derr, dv[0], dl[0], dnoise]
    else:
        fn = {"prod": st.batched_nll_stationary_general, "sum": st.batched_nll_stationary_sum}
        J, JD = len(vs), len(ls)

        def call(d, e, nz, *rest):
            v, l, a = rest[:J], rest[J:J + JD], rest[J + JD:]
            return fn[combine](families, d, e, v, l, a, nz, mask, dims=dims)

        others, truth = [err, noise] + vs + ls + als, [derr, dnoise, *dv, *dl, *dal]
    kernel, closed, _ = _grad_pair(call, d2s, others, g)
    assert all(torch.all(torch.isfinite(x)) for x in kernel), label
    n, D2 = cs.GRAD_GOLDEN_MODELS, torch.stack(d2s)
    V, L, A = (torch.stack(x) for x in (vs, ls, als))
    A = torch.ones_like(V) if single else A
    with torch.no_grad():
        _, W, a = st.stationary_nll_forward_cuda(
            families, combine, dims, D2, err, V, 1.0 / (L * L), A, noise,
            None if single else mask, True,
            "stationary_nll" if single else "stationary_nll_general")
        _, *cpu = st.stationary_nll_grad_torch(
            families, combine, dims, *(x.cpu() for x in (D2, W[:n], a[:n], g[:n], V[:, :n],
                                                         L[:, :n], A[:, :n], mask[:n])), False)
    derr_c, dv_c, dl_c, dal_c, dnoise_c = cpu
    cpu = ([derr_c, dv_c[0], dl_c[0], dnoise_c] if single
           else [derr_c, dnoise_c, *dv_c, *dl_c, *dal_c])
    gk, gt = _gap(kernel, truth), _gap(closed, truth)
    gc = _gap(cpu, [x[:n].cpu() for x in truth])
    print(f"grad kernel {label}: normalized gap to JAX float64 {gk:.3e}, torch closed form's "
          f"{gt:.3e} on the card, {gc:.3e} on the CPU")
    assert gk <= max(3.0 * max(gt, gc), 1e-5), f"{label}: kernel gap {gk:.3e}, closed form's " \
        f"{gt:.3e} and {gc:.3e}"


@pytest.mark.parametrize("N", [77, 262, 512])
def test_torch_cuda_stationary_grad_kernel_independent_of_batch(cuda, N):
    """A model's gradient from the backward kernel has the same bits alone,
    as the first of a batch of 3, 20 or 40, and in a second run: every
    order of its sums depends on N alone."""
    families, dims = ("matern12", "se"), (1, 1)
    d2s, err, vs, ls, als, noise, mask = cs.general_operands(families, dims, 40, N, True,
                                                             2500 + N)
    D2, V, L, A = (torch.stack(x) for x in (d2s, vs, ls, als))
    with torch.no_grad():
        _, W, a = st.stationary_nll_forward_cuda(families, "prod", dims, D2, err, V,
                                                 1.0 / (L * L), A, noise, mask, True,
                                                 "stationary_nll_general")
    g = torch.linspace(-1.0, 1.5, 40, device=cuda)
    outs = []
    for B in (1, 3, 20, 40, 40):
        got = st.stationary_nll_grad_cuda(
            families, "prod", dims, D2, W[:B].contiguous(), a[:B].contiguous(), g[:B].contiguous(),
            V[:, :B].contiguous(), L[:, :B].contiguous(), A[:, :B].contiguous(),
            mask[:B].contiguous())
        dv, dl, dal, dnoise, derr = got
        outs.append([dv[:, :1], dl[:, :1], dal[:, :1], dnoise[:1], derr[:1]])
    torch.cuda.synchronize()
    for got in outs[1:]:
        for x, alone in zip(got, outs[0]):
            assert torch.equal(x, alone)


# -- the blocked tier's panel kernel (csrc/blocked_panel.cu) ----------------

def _spd(cuda, B, N, seed):
    rng = np.random.default_rng(seed)
    A = torch.tensor(rng.normal(size=(B, N, N)), dtype=torch.float64, device=cuda)
    K = A @ A.mT / N + 0.5 * torch.eye(N, dtype=torch.float64, device=cuda)
    return K.float()


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("nt", [875, 747, 619, 491, 363, 235, 107])
def test_torch_cuda_panel_kernel_matches_plain(cuda, B, nt):
    """Every panel height of the N = 875 path, as a strided view of the
    trailing matrix: L panel within 3e-3 of max |L|, Σ log diag rtol 3e-3."""
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn

    Ks = _spd(cuda, B, nt, nt)
    panel = Ks[:, :, :min(128, nt)]
    before = bn.LAUNCHES["blocked_panel"]
    Lk, ldk = bn.factor_panel(panel)
    Lp, ldp = bn.factor_panel_plain(panel)
    torch.cuda.synchronize()
    assert bn.LAUNCHES["blocked_panel"] == before + 1
    scale = float(Lp.abs().max())
    torch.testing.assert_close(Lk / scale, Lp / scale, rtol=0, atol=3e-3)
    torch.testing.assert_close(ldk, ldp, rtol=3e-3, atol=0)
    assert torch.all(torch.triu(Lk[:, :min(128, nt)], 1) == 0)


@pytest.mark.parametrize("B,N", [(1, 875), (8, 875), (8, 896)])
def test_torch_cuda_blocked_nll_matches_plain(cuda, B, N):
    """Values (rtol 3e-3) and gradients of K, y and noise (normalized atol
    2e-2) of the blocked NLL, on the card (the panel kernel) against the
    same call on CPU copies of the float32 inputs (the plain panel factor)."""
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn

    rng = np.random.default_rng(N + B)
    K = _spd(cuda, B, N, B)
    y = torch.tensor(rng.normal(size=(B, N)), dtype=torch.float32, device=cuda)
    noise = torch.tensor(rng.uniform(0.1, 0.5, B), dtype=torch.float32, device=cuda)
    outs = []
    for dev in (cuda, "cpu"):
        leaves = [x.to(dev).requires_grad_(True) for x in (K, y, noise)]
        nll = bn.batched_nll_blocked(*leaves)
        grads = torch.autograd.grad(nll.sum(), leaves)
        outs.append((nll.detach().cpu(), [g.cpu() for g in grads]))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=3e-3, atol=0)
    for g, w in zip(outs[0][1], outs[1][1]):
        scale = max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=2e-2)


def test_torch_cuda_panel_kernel_indefinite_gives_nan(cuda):
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn

    Ks = _spd(cuda, 2, 300, 9) - 3.0 * torch.eye(300, device=cuda)
    with torch.no_grad():
        _, ld = bn.factor_panel(Ks[:, :, :128])
        nll = bn.batched_nll_blocked(Ks, torch.ones(2, 300, device=cuda),
                                     torch.zeros(2, device=cuda))
    assert torch.all(torch.isnan(ld)) and torch.all(torch.isnan(nll))


def test_torch_cuda_panel_kernel_launch_error_raises(cuda):
    """A grid the kernel refuses (B above 65,535) raises; a CPU-only
    dtype or a wrong width never reaches the kernel."""
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn

    with pytest.raises(RuntimeError, match="launch failed"):
        bn.factor_panel_cuda(torch.ones((70_000, 1, 1), device=cuda))
    with pytest.raises(TypeError):
        bn.factor_panel_cuda(torch.ones((1, 4, 4), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        bn.factor_panel_cuda(torch.ones((1, 300, 100), device=cuda))


def test_torch_cuda_panel_kernel_ill_conditioned(cuda):
    """The first panel of an SE Gram matrix of a daily grid + 1e-5·I
    (N = 875). Two float32 factors of it differ by up to ~6e-3 of max |L|
    (the summation order is amplified by the conditioning), so the kernel is
    held by its backward error instead: at most 4× the plain version's (or
    2e-6 of max |A|, whichever is larger), finite, and Σ log diag within
    rtol 3e-3 of the plain version's (chip_smoke.check_panel_ill_conditioned)."""
    import chip_smoke as cs

    before = _panel_launches()
    cs.check_panel_ill_conditioned(cuda)
    assert _panel_launches() == before + 1


@pytest.mark.parametrize("pivot", [32, 64, 100])
def test_torch_cuda_panel_kernel_indefinite_pivot(cuda, pivot):
    """An indefinite pivot at a sub-panel boundary (32, 64) or inside one
    (100), with A21 rows below: NaN in the log sum and in every entry of
    L on and below the diagonal from column `pivot` on; the earlier columns
    finite and within 3e-3 of max |L| of the plain factor of the same
    columns (chip_smoke.check_panel_indefinite)."""
    import chip_smoke as cs

    before = _panel_launches()
    cs.check_panel_indefinite(pivot, cuda)
    assert _panel_launches() == before + 1


def _panel_launches():
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn

    return bn.LAUNCHES["blocked_panel"]


def test_torch_cuda_panel_kernel_writes_into_out(cuda):
    """With `out`, a strided view of a larger factor, the kernel writes the
    L panel there, bit for bit what it returns without `out`, and nothing
    else of the buffer."""
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn

    Ks = _spd(cuda, 3, 619, 4)
    panel = Ks[:, :, :128]
    buf = torch.full((3, 875, 875), 7.0, device=cuda)
    view = buf[:, 256:, 256:384]
    Lk, ldk = bn.factor_panel(panel)
    Lo, ldo = bn.factor_panel(panel, out=view)
    torch.cuda.synchronize()
    assert Lo.data_ptr() == view.data_ptr()
    assert torch.equal(view, Lk) and torch.equal(ldo, ldk)
    rest = torch.ones_like(buf, dtype=torch.bool)
    rest[:, 256:, 256:384] = False
    assert torch.all(buf[rest] == 7.0)


@pytest.mark.parametrize("B,Np", [(20, 1408), (20, 1024), (20, 256), (20, 128), (8, 128)])
def test_torch_cuda_trinv_kernel_matches_plain(cuda, B, Np):
    """The triangular-inverse kernel against its plain version at the
    five-year grid's 220 blocks and the uneven split's sizes; a NaN in one
    block gives NaN exactly where the plain version has it."""
    from portfoliooptgp_tpu_torch.ops import nll

    L = torch.linalg.cholesky(_spd(cuda, B, Np, Np).double()).float()
    L[B - 1, Np - 60, Np - 100] = float("nan")
    before = nll.LAUNCHES["triangular_inverse"]
    Wk = nll.triangular_inverse(L)
    Wp = nll.triangular_inverse_plain(L)
    torch.cuda.synchronize()
    assert nll.LAUNCHES["triangular_inverse"] == before + 1
    assert Wk.shape == (B, Np // 128, 128, 128)
    assert torch.equal(torch.isnan(Wk), torch.isnan(Wp)) and bool(torch.isnan(Wk).any())
    fin = ~torch.isnan(Wp)
    scale = float(Wp[fin].abs().max())
    torch.testing.assert_close(Wk[fin] / scale, Wp[fin] / scale, rtol=0, atol=3e-3)


@pytest.mark.parametrize("B,N", [(3, 1100), (20, 1304)])
def test_torch_cuda_hinv_nll_matches_cpu(cuda, B, N):
    """batched_nll_hinv on the card (the kernel) against the same call on
    CPU copies (the plain version): values rtol 3e-3, gradients normalized
    atol 2e-2."""
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn
    from portfoliooptgp_tpu_torch.ops import nll

    rng = np.random.default_rng(N)
    K = _spd(cuda, B, N, B)
    y = torch.tensor(rng.normal(size=(B, N)), dtype=torch.float32, device=cuda)
    noise = torch.tensor(rng.uniform(0.1, 0.5, B), dtype=torch.float32, device=cuda)
    before = nll.LAUNCHES["triangular_inverse"]
    outs = []
    for dev in (cuda, "cpu"):
        leaves = [x.detach().to(dev).requires_grad_(True) for x in (K, y, noise)]
        value = bn.batched_nll_hinv(*leaves)
        grads = torch.autograd.grad(value.sum(), leaves)
        outs.append((value.detach().cpu(), [g.cpu() for g in grads]))
    assert nll.LAUNCHES["triangular_inverse"] == before + 1
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=3e-3, atol=0)
    for g, w in zip(outs[0][1], outs[1][1]):
        scale = max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=2e-2)


@pytest.mark.parametrize("layout", ["column-major", "row-major"])
@pytest.mark.parametrize("kind", ["nan_diagonal_block", "nan_offdiagonal_block", "zero_pivot"])
def test_torch_cuda_trinv_kernel_nan_and_inf_pattern(cuda, kind, layout):
    """A NaN inside a diagonal 32-block (row 40, column 35 of a 128-block),
    inside an off-diagonal 32-block (row 100, column 10), or a zero pivot
    (row 50), in two blocks of a (4, 512) batch of column-major factors (as
    torch.linalg.cholesky returns them) or their row-major copies: the
    kernel's NaN and inf entries are exactly the plain version's
    (chip_smoke.check_trinv_pattern)."""
    import chip_smoke as cs
    from portfoliooptgp_tpu_torch.ops import nll

    before = nll.LAUNCHES["triangular_inverse"]
    n_nan, n_inf = cs.check_trinv_pattern(kind, layout, cuda)
    assert nll.LAUNCHES["triangular_inverse"] == before + 1
    assert n_inf > 0 if kind == "zero_pivot" else n_nan > 0


def test_torch_cuda_trinv_kernel_on_uneven_views(cuda):
    """The uneven split's calls on views at non-zero offsets of a (20, 1408)
    factor (its 8 + 2 + 1 panels), one of them holding a NaN: the kernel
    reads each view in place and matches the plain version, NaN and inf
    exactly where it has them."""
    import chip_smoke as cs
    from portfoliooptgp_tpu_torch.ops import nll

    L = torch.linalg.cholesky(_spd(cuda, 20, 1408, 12).double()).float()
    L[7, 1024 + 200, 1024 + 150] = float("nan")
    for lo, hi in cs.UNEVEN_VIEWS:
        view = L[:, lo:hi, lo:hi]
        Wk = nll.triangular_inverse_cuda(view)
        Wp = nll.triangular_inverse_plain(view)
        torch.cuda.synchronize()
        cs.check_trinv_equal(f"view [{lo}:{hi}]", Wk, Wp)


def test_torch_cuda_trinv_kernel_rejects_bad_input(cuda):
    from portfoliooptgp_tpu_torch.ops import nll

    with pytest.raises(TypeError):
        nll.triangular_inverse_cuda(torch.eye(128, dtype=torch.float64, device=cuda)[None])
    with pytest.raises(ValueError):
        nll.triangular_inverse_cuda(torch.eye(100, device=cuda)[None])


@pytest.mark.parametrize("with_w", [False, True], ids=["value", "inverse"])
@pytest.mark.parametrize("B,N", [(1, 72), (4, 72), (20, 77), (5, 77), (8, 224), (128, 256),
                                 (3, 131)])
def test_torch_cuda_dense_kernel_matches_plain(cuda, B, N, with_w):
    """The dense NLL kernel (both variants) against its plain version at the
    multi-input shapes, tools/smoke_tpu.py's N = 224 and the window's top:
    a, Σ log diag L and W within 3e-3 of their largest value; the last
    model made indefinite halfway gives NaN exactly where the plain version
    has it."""
    from portfoliooptgp_tpu_torch.ops import nll

    K = _spd(cuda, B, N, B + N)
    K[-1, N // 2:, N // 2:] -= 5.0 * N * torch.eye(N - N // 2, device=cuda)
    rng = np.random.default_rng(N)
    y = torch.tensor(rng.normal(size=(B, N)), dtype=torch.float32, device=cuda)
    noise = torch.tensor(rng.uniform(0.05, 0.3, B), dtype=torch.float32, device=cuda)
    key = "dense_nll_inv" if with_w else "dense_nll"
    before = nll.LAUNCHES[key]
    nll_k, a, logdet, W = nll.factor_solve_cuda(K, y, noise, with_w)
    want = nll.factor_solve_inv_plain(K, y, noise)
    torch.cuda.synchronize()
    assert nll.LAUNCHES[key] == before + 1
    assert (W is not None) == with_w
    for got, ref in zip((a, logdet, W), want):
        if got is None:
            continue
        assert torch.equal(torch.isnan(got), torch.isnan(ref)) and bool(torch.isnan(got[-1]).any())
        fin = ~torch.isnan(ref)
        if bool(fin.any()):  # B = 1: the one model's log-det is NaN
            scale = float(ref[fin].abs().max())
            torch.testing.assert_close(got[fin] / scale, ref[fin] / scale, rtol=0, atol=3e-3)
    assert torch.isnan(nll_k[-1]) and torch.all(torch.isfinite(nll_k[:-1]))


@pytest.mark.parametrize("B,N", [(20, 77), (128, 256), (3, 131)])
def test_torch_cuda_dense_nll_matches_cpu(cuda, B, N):
    """batched_nll on the card (the kernels) against the same call on CPU
    copies (the plain version): values rtol 3e-3, gradients normalized atol
    2e-2; the value launches the value-only kernel, value+grad the inverse."""
    from portfoliooptgp_tpu_torch.ops import nll

    rng = np.random.default_rng(N)
    K = _spd(cuda, B, N, B)
    y = torch.tensor(rng.normal(size=(B, N)), dtype=torch.float32, device=cuda)
    noise = torch.tensor(rng.uniform(0.1, 0.5, B), dtype=torch.float32, device=cuda)
    before = dict(nll.LAUNCHES)
    with torch.no_grad():
        nll.batched_nll(K, y, noise)
    outs = []
    for dev in (cuda, "cpu"):
        leaves = [x.detach().to(dev).requires_grad_(True) for x in (K, y, noise)]
        value = nll.batched_nll(*leaves)
        grads = torch.autograd.grad(value.sum(), leaves)
        outs.append((value.detach().cpu(), [g.cpu() for g in grads]))
    assert nll.LAUNCHES["dense_nll"] == before["dense_nll"] + 1
    assert nll.LAUNCHES["dense_nll_inv"] == before["dense_nll_inv"] + 1
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=3e-3, atol=0)
    for g, w in zip(outs[0][1], outs[1][1]):
        scale = max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=2e-2)


@pytest.mark.parametrize("with_w", [False, True], ids=["value", "inverse"])
@pytest.mark.parametrize("kind", ["random", "indefinite"])
@pytest.mark.parametrize("N", [1, 31, 32, 33, 64, 65, 255, 256])
def test_torch_cuda_dense_kernel_tile_edges(cuda, N, kind, with_w):
    """The dense kernel at the edges of its 32-column tiles against the plain
    version at phase_dense's tolerances, the NaN pattern equal
    (chip_smoke.check_dense; the indefinite model's trailing half shifted
    by -5 I, so at N = 1 its one pivot is negative)."""
    import chip_smoke as cs

    from portfoliooptgp_tpu_torch.ops import nll

    K, y, noise = cs._dense_problem(kind, 3, N, 500 + N)
    if kind == "indefinite" and N == 1:
        K[-1] -= 10.0
    key = "dense_nll_inv" if with_w else "dense_nll"
    before = nll.LAUNCHES[key]
    errs = cs.check_dense(f"dense {kind} N={N}", K, y, noise, kind == "indefinite")
    assert nll.LAUNCHES[key] >= before + 1 and np.isfinite(errs[with_w])


@pytest.mark.parametrize("view", ["transposed", "sliced"])
def test_torch_cuda_dense_kernel_reads_strided_views(cuda, view):
    """K as a transposed view or a principal slice (row stride 81), read in
    place: both variants match the plain version on the same view, NaN
    pattern included (chip_smoke.check_dense)."""
    import chip_smoke as cs

    K, y, noise = cs._dense_problem("indefinite", 3, 77, 77)
    if view == "transposed":
        K = K.transpose(1, 2)
    else:
        K = cs._dense_problem("indefinite", 3, 81, 81)[0][:, 2:79, 2:79]
    assert not K.is_contiguous()
    cs.check_dense(f"dense {view} view", K, y, noise, True)


def test_torch_cuda_dense_kernel_rejects_bad_input(cuda):
    from portfoliooptgp_tpu_torch.ops import nll

    K = torch.eye(8, device=cuda)[None]
    y, noise = torch.zeros((1, 8), device=cuda), torch.ones(1, device=cuda)
    with pytest.raises(TypeError):
        nll.factor_solve_cuda(K.double(), y, noise, False)
    with pytest.raises(ValueError):
        nll.factor_solve_cuda(torch.eye(257, device=cuda)[None], torch.zeros((1, 257), device=cuda),
                              noise, True)


# -- the SVGP gram kernels (csrc/svgp_gram.cu) ---------------------------------

def _gram_max_err(got, want):
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale


@pytest.mark.parametrize("M,B", [(16, 96), (64, 512), (128, 2048), (128, 8192)])
@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("family", ["se", "matern12", "matern32", "matern52"])
def test_torch_cuda_svgp_gram_kernels_match_plain(cuda, family, D, M, B):
    """Both kernels against their plain versions at phase 10a's shapes,
    each output relative to its largest entry (tests/test_svgp_gram_fused.py's
    tolerances: values 2e-4, gradients 3e-3, 5e-3 for ARD Matern)."""
    import chip_smoke as cs
    from portfoliooptgp_tpu_torch.ops import svgp_gram as sg

    Z, X, y, w, t, v, s, Gbar, sqbar = cs.gram_operands(M, B, D, seed=M + B + D)
    before = dict(sg.LAUNCHES)
    G, sq = sg.gram_fwd(Z, X, y, w, t, v, s, family)
    got = sg.gram_bwd(Z, X, y, w, t, v, s, family, Gbar, sqbar)
    torch.cuda.synchronize()
    assert sg.LAUNCHES["svgp_gram_fwd"] == before["svgp_gram_fwd"] + 1
    assert sg.LAUNCHES["svgp_gram_bwd"] == before["svgp_gram_bwd"] + 1
    Gp, sqp = sg.gram_fwd_plain(Z, X, y, w, t, v, s, family)
    want = sg.gram_bwd_plain(Z, X, y, w, t, v, s, family, Gbar, sqbar)
    assert _gram_max_err(G, Gp) <= 2e-4
    assert _gram_max_err(sq, sqp) <= 2e-4
    gtol = 5e-3 if (D > 1 and family != "se") else 3e-3
    for name, a, b in zip(("Zbar", "ybar", "tbar", "vbar", "sbar"), got, want):
        assert torch.all(torch.isfinite(a)), name
        assert _gram_max_err(a, b) <= gtol, (name, _gram_max_err(a, b))
    n_real = int(w.sum())
    assert torch.all(got[1][n_real:] == 0)  # weight-0 rows get exactly zero ȳ


def test_torch_cuda_svgp_gram_reduce_autograd_round_trip(cuda):
    """gram_reduce's value and every gradient on the card against the same
    call on CPU copies (the plain versions), at the benchmark shape."""
    import chip_smoke as cs
    from portfoliooptgp_tpu_torch.ops import svgp_gram as sg

    Z, X, y, w, t, v, s, _, _ = cs.gram_operands(128, 2048, 1, seed=5)
    outs = []
    for dev in ("cuda", "cpu"):
        leaves = [a.detach().to(dev).requires_grad_(True) for a in (Z, y, t, v, s)]
        Zl, yl, tl, vl, sl = leaves
        G, sq = sg.gram_reduce(Zl, X.to(dev), yl, w.to(dev), tl, vl, sl, "matern32")
        loss = torch.sum(G * torch.linspace(-1, 1, 128 * 128, device=dev).reshape(128, 128)) \
            + 0.3 * sq
        outs.append([loss.detach().cpu()] + [g.cpu() for g in torch.autograd.grad(loss, leaves)])
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=2e-4, atol=0)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert _gram_max_err(a, b) <= 3e-3


def _gram_call(M, B, D, family, seed):
    import chip_smoke as cs
    from portfoliooptgp_tpu_torch.ops import svgp_gram as sg

    ops = cs.gram_operands(M, B, D, seed=seed)
    G, sq = sg.gram_fwd(*ops[:7], family)
    bars = sg.gram_bwd(*ops[:7], family, *ops[7:])
    torch.cuda.synchronize()
    return ops, (G, sq), bars


@pytest.mark.parametrize("M,B,D,family", [(128, 2048, 1, "se"), (128, 8192, 1, "se"),
                                          (136, 1000, 3, "matern12"), (400, 777, 1, "matern52")])
def test_torch_cuda_svgp_gram_reruns_are_bitwise_equal(cuda, M, B, D, family):
    """The reductions across CTAs run in a fixed order (no float atomics,
    whichever CTA arrives last): two calls on the same operands agree bit
    for bit in both directions, and G is exactly symmetric."""
    _, (G1, sq1), bars1 = _gram_call(M, B, D, family, seed=9)
    _, (G2, sq2), bars2 = _gram_call(M, B, D, family, seed=9)
    assert torch.equal(G1, G2) and torch.equal(sq1, sq2)
    for a, b in zip(bars1, bars2):
        assert torch.equal(a, b)
    assert torch.equal(G1, G1.T)


def _gram_edge_cases():
    """(M, B, D, family): B = 1; B one below, at and one above a pass of
    STAGE columns and a change of the forward's rank count at M = 128; B = 8192;
    M = 8 (half a backward block); M = 136 (partial blocks in both
    directions); M = 400, above the 390 where the parent narrowed its tile
    (four backward passes over Kuf's rows); D = 128 (the backward's
    64-row passes)."""
    from portfoliooptgp_tpu_torch.ops import svgp_gram as sg

    fwd_units = sg.launch_shape(128, 2048, 1)[0].units
    boundary = (sg.SMS // fwd_units - 1) * sg.MIN_CHUNK  # the ranks step up past this B
    cases = [(128, 1, 1, "se"), (8, 1, 3, "matern32")]
    cases += [(128, b, 1, "se") for b in (sg.STAGE - 1, sg.STAGE, sg.STAGE + 1,
                                          boundary, boundary + 1, 2047, 2049, 8192)]
    cases += [(8, 300, 1, "matern12"), (136, 2048, 3, "matern52"), (400, 2048, 1, "se"),
              (400, 513, 3, "matern32"), (48, 200, 128, "se")]
    return cases


@pytest.mark.parametrize("M,B,D,family", _gram_edge_cases())
def test_torch_cuda_svgp_gram_edge_shapes_match_plain(cuda, M, B, D, family):
    """Both kernels against their plain versions at the design's edges,
    with the tolerances of test_torch_cuda_svgp_gram_kernels_match_plain."""
    from portfoliooptgp_tpu_torch.ops import svgp_gram as sg

    ops, (G, sq), got = _gram_call(M, B, D, family, seed=M + B + D)
    Gp, sqp = sg.gram_fwd_plain(*ops[:7], family)
    want = sg.gram_bwd_plain(*ops[:7], family, *ops[7:])
    assert _gram_max_err(G, Gp) <= 2e-4
    assert _gram_max_err(sq, sqp) <= 2e-4
    gtol = 5e-3 if (D > 1 and family != "se") else 3e-3
    for name, a, b in zip(("Zbar", "ybar", "tbar", "vbar", "sbar"), got, want):
        assert a.shape == b.shape, name
        assert torch.all(torch.isfinite(a)), name
        assert _gram_max_err(a, b) <= gtol, (name, _gram_max_err(a, b))


@pytest.mark.parametrize("M,B", [(128, 2048), (64, 511)])
def test_torch_cuda_svgp_gram_zero_weight_tail(cuda, M, B):
    """A weight-0 tail (the iterator's padding) gets exactly 0 in ȳ and
    leaves G and sq within 2e-4 of the same batch with the tail cut off."""
    import chip_smoke as cs
    from portfoliooptgp_tpu_torch.ops import svgp_gram as sg

    Z, X, y, w, t, v, s, Gbar, sqbar = cs.gram_operands(M, B, 1, seed=21)
    n = int(w.sum())
    assert 0 < n < B
    G, sq = sg.gram_fwd(Z, X, y, w, t, v, s, "se")
    Gc, sqc = sg.gram_fwd(Z, X[:n], y[:n], w[:n], t, v, s, "se")
    ybar = sg.gram_bwd(Z, X, y, w, t, v, s, "se", Gbar, sqbar)[1]
    torch.cuda.synchronize()
    assert torch.all(ybar[n:] == 0)
    assert _gram_max_err(G, Gc) <= 2e-4
    assert _gram_max_err(sq, sqc) <= 2e-4


def test_torch_cuda_svgp_gram_broken_build_raises(cuda, tmp_path, monkeypatch):
    """No hidden fallback: when the source does not build, a CUDA call
    raises instead of running the plain version, and counts no launch."""
    from portfoliooptgp_tpu_torch.ops import cuda_build
    from portfoliooptgp_tpu_torch.ops import svgp_gram as sg

    (tmp_path / "svgp_gram.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    monkeypatch.setenv("PORTFOLIOOPTGP_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.delitem(cuda_build._LIBS, "svgp_gram", raising=False)
    monkeypatch.setattr(sg, "_LIB", None)
    ops = [torch.ones(8, 1, device=cuda), torch.ones(16, 1, device=cuda),
           torch.ones(16, device=cuda), torch.ones(16, device=cuda), torch.ones(8, device=cuda),
           torch.ones(1, device=cuda), torch.ones(1, device=cuda)]
    before = dict(sg.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sg.gram_fwd(*ops, "se")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sg.gram_reduce(*ops, "se")
    assert sg.LAUNCHES == before


# -- the NUTS slice: the chain-batched GPR log-density on the cluster kernel --

def _nuts_stack(device, dtype, chains=8, seed=1):
    """bench.py's m0 jittered into `chains` models, and its data."""
    from chip_smoke import nuts_bench_data, nuts_bench_model
    from portfoliooptgp_tpu_torch.params import ravel, unravel

    m0 = nuts_bench_model(device, dtype)
    jitter = 0.1 * np.random.default_rng(seed).normal(size=(chains, 6))
    stack = unravel(m0, ravel(m0) + torch.tensor(jitter, device=device, dtype=dtype))
    X, Y = (torch.tensor(a, device=device, dtype=dtype) for a in nuts_bench_data())
    return m0, stack, X, Y


def test_torch_cuda_nuts_vg_bench_shape_matches_cpu(cuda):
    """`gpr_logdensity_vg` at bench.py's (8, 512) ARD posterior: one cluster
    kernel launch, values and gradients against CPU float64."""
    from portfoliooptgp_tpu_torch.inference import centered_normal_logprior, gpr_logdensity_vg
    from portfoliooptgp_tpu_torch.params import tree_leaves

    outs = []
    for dev, dt in ((cuda, torch.float32), ("cpu", torch.float64)):
        m0, stack, X, Y = _nuts_stack(dev, dt)
        before, ran = st.LAUNCHES["stationary_nll_general"], None
        if dev == cuda:
            ran = st.kernel_launches()
        v, g = gpr_logdensity_vg(X, Y, centered_normal_logprior(m0))(stack)
        if dev == cuda:
            torch.cuda.synchronize()
            assert st.LAUNCHES["stationary_nll_general"] == before + 1
            now = st.kernel_launches()
            assert now["cluster"] == ran["cluster"] + 1 and now["tile"] == ran["tile"]
        outs.append((v.double().cpu(), [x.double().cpu() for x in tree_leaves(g)]))
    (v, g), (vr, gr) = outs
    assert torch.all(torch.isfinite(v))
    np.testing.assert_allclose(v.numpy(), vr.numpy(), rtol=3e-3)
    for a, b in zip(g, gr):
        scale = max(float(b.abs().max()), 1.0)
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale, atol=2e-2)


def test_torch_cuda_nuts_leapfrog_matches_cpu(cuda):
    """16 leapfrog steps of the 8 chains on the card (float32, the cluster
    kernel per step) against the same steps on the CPU in float64 from the
    same momenta: positions within 1e-3, momenta within 2e-2 of their
    largest entry (the gradients' tolerance)."""
    from portfoliooptgp_tpu_torch.inference import (centered_normal_logprior,
                                                    gpr_logdensity_vg, hmc)
    from portfoliooptgp_tpu_torch.params import ravel, unravel

    p0 = np.random.default_rng(2).normal(size=(8, 6))
    outs = []
    for dev, dt in ((cuda, torch.float32), ("cpu", torch.float64)):
        m0, stack, X, Y = _nuts_stack(dev, dt)
        vg = gpr_logdensity_vg(X, Y, centered_normal_logprior(m0))

        def grad(z):
            return ravel(vg(unravel(m0, z))[1])

        q, p, _ = hmc.leapfrog(grad, ravel(stack), torch.tensor(p0, device=dev, dtype=dt),
                               0.01, torch.full((8, 6), 0.05, device=dev, dtype=dt), 16)
        outs.append((q.double().cpu().numpy(), p.double().cpu().numpy()))
    (q, p), (qr, pr) = outs
    np.testing.assert_allclose(q, qr, atol=1e-3)
    np.testing.assert_allclose(p / np.abs(pr).max(), pr / np.abs(pr).max(), atol=2e-2)


def test_torch_cuda_sample_nuts_short_run(cuda):
    """A short run of bench.py's workload (40 + 20 transitions): every
    evaluation one stationary kernel launch, acceptance in (0.5, 1)."""
    from chip_smoke import run_nuts_bench

    q = run_nuts_bench(0, device="cuda", num_warmup=40, num_samples=20)
    ev = q["evals"]
    assert q["launches"]["stationary_nll_general"] == ev["vg"] + ev["logp"]
    assert 0.5 < q["accept"] < 1.0
    assert np.all(np.isfinite(q["mean"]))


@pytest.mark.parametrize("B", [5, 20])
def test_torch_cuda_panel_kernel_on_masked_walk_forward_systems(cuda, B):
    """The panel kernel at every panel height of masked walk-forward
    systems (N = 768: the diagonal of ones on the masked rows beside
    σ² = 1e-5 on the kept ones), B = 5 (one restart a day) and 20 (four),
    against its plain version (L within 3e-3 of max |L|, Σ log diag rtol
    3e-3: chip_smoke.check_walk_panel); then the blocked NLL of those
    systems on the card against CPU copies (values rtol 3e-3, gradients
    normalized atol 2e-2)."""
    import chip_smoke as cs
    from portfoliooptgp_tpu_torch.ops import blocked_nll as bn

    before = bn.LAUNCHES["blocked_panel"]
    cs.check_walk_panel(B)
    assert bn.LAUNCHES["blocked_panel"] == before + 6
    K = cs.masked_walk_system(B, 768, noise=1e-5, seed=1)
    y = torch.tensor(np.random.default_rng(B).normal(size=(B, 768)), dtype=torch.float32,
                     device=cuda)
    outs = []
    for dev in (cuda, "cpu"):
        leaves = [x.detach().to(dev).requires_grad_(True)
                  for x in (K, y, torch.zeros(B, device=cuda))]
        nll = bn.batched_nll_blocked(*leaves)
        grads = torch.autograd.grad(nll.sum(), leaves)
        outs.append((nll.detach().cpu(), [g.cpu() for g in grads]))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=3e-3, atol=0)
    for g, w in zip(outs[0][1], outs[1][1]):
        scale = max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=2e-2)


@pytest.mark.parametrize("precond_rank", [0, 64])
def test_torch_cuda_nll_cg_matches_cpu_float64(cuda, precond_rank):
    """nll_cg in float32 on the card against its float64 value on the CPU
    with the same probes (tools/smoke_tpu.py's kernel, N = 1024, 32 probes,
    24 Lanczos steps): the value within smoke_tpu's CG tolerance rtol 2e-3,
    the gradients in the variance, lengthscale and noise finite and within
    its 1e-1 of the largest."""
    from portfoliooptgp_tpu_torch.ops import iterative

    n = 1024
    Y = np.random.default_rng(0).normal(size=(n, 1))
    gen = torch.Generator().manual_seed(3)
    probes = tuple(iterative.rademacher((n, 32), gen, torch.float64) for _ in range(2))
    outs = []
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        x = torch.arange(n, dtype=dtype, device=dev)
        p = [torch.tensor(v, dtype=dtype, device=dev, requires_grad=True)
             for v in (1.3, 30.0, 0.1)]
        K = p[0] * torch.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / (p[1] * p[1]))
        value = iterative.nll_cg(K, torch.tensor(Y, dtype=dtype, device=dev), p[2],
                                 None, 32, 24, 1e-6, precond_rank, probes=probes)
        grads = torch.autograd.grad(value, p)
        outs.append((float(value.detach()), np.array([float(g) for g in grads])))
    (v32, g32), (v64, g64) = outs
    assert np.isfinite(v32) and np.all(np.isfinite(g32))
    assert abs(v32 - v64) <= 2e-3 * abs(v64)
    assert np.max(np.abs(g32 - g64)) <= 1e-1 * max(np.max(np.abs(g64)), 1.0)


def test_torch_cuda_step_timer_waits_for_a_tuple_result(cuda):
    """A step whose result is `(state, loss)` is timed to its end: when the
    step closes, nothing is left on the card's stream."""
    from portfoliooptgp_tpu_torch.utils.profiling import StepTimer

    A = torch.randn(4096, 4096, device=cuda)
    timer = StepTimer()
    torch.cuda.synchronize()
    with timer.step() as out:
        for _ in range(8):
            A = torch.tanh(A @ A) * 0.01
        out["result"] = ({"A": A}, A.sum())
    assert torch.cuda.current_stream().query()
    assert timer.times[0] > 0


@pytest.mark.parametrize("B,N", [(20, 77), (5, 200)])
def test_torch_cuda_white_sum_runs_the_dense_kernel(cuda, B, N):
    """`Exponential + White` at padded N ≤ 256 routes to the dense tier and
    launches the dense kernel (with W, its gradient needs it); value and
    gradients within the smoke tolerances of the same call on the CPU."""
    from portfoliooptgp_tpu_torch import kernels as tk
    from portfoliooptgp_tpu_torch import params
    from portfoliooptgp_tpu_torch.models import gpr
    from portfoliooptgp_tpu_torch.ops import nll
    from portfoliooptgp_tpu_torch.train import lbfgs

    o = dict(device="cpu", dtype=torch.float32)
    model = lbfgs.stack_pytrees([
        gpr.GPR.create(tk.Exponential.create(1.0 + 0.1 * b, 0.5 + 0.2 * b, **o)
                       + tk.White.create(0.01 * (b + 1), **o), 0.02) for b in range(B)])
    t = np.linspace(-1.7, 1.7, N)
    X = torch.tensor(t[:, None], **o)
    Y = torch.tensor(np.sin(3 * t)[:, None], **o)
    assert gpr.nll_tier(model, X, Y) == "pallas_dense"
    outs = []
    for dev in (cuda, "cpu"):
        leaves = [x.to(dev).requires_grad_(True) for x in params.tree_leaves(model)]
        before = nll.LAUNCHES["dense_nll_inv"]
        value = gpr.batched_neg_log_marginal_likelihood(
            params.tree_replace(model, leaves), X, Y, device=dev, dtype=torch.float32)
        grads = torch.autograd.grad(value.sum(), leaves)
        if dev == cuda:
            assert nll.LAUNCHES["dense_nll_inv"] == before + 1
        outs.append((value.detach().cpu(), [g.cpu() for g in grads]))
    (v, g), (vw, gw) = outs
    torch.testing.assert_close(v, vw, rtol=3e-3, atol=0)
    for a, w in zip(g, gw):
        scale = max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(a / scale, w / scale, rtol=0, atol=2e-2)


def test_torch_cuda_native_csv_loader_builds():
    """The CSV loader builds and loads on the card's machine, so the data
    layer parses through it."""
    from portfoliooptgp_tpu_torch import native

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    native.build()
    assert native.available()


def test_torch_cuda_minimize_simplex_rows_matches_cpu(cuda):
    """The row-batched simplex solve on the card, in float64, against the
    same call on the CPU, weights at atol 1e-8 (the CPU test's limit for
    rows against one row): frontier-like return floors up to max μ, whose
    top row's feasible set is one vertex, so rows stop at different trials
    and the row masks reach the card mixed."""
    from portfoliooptgp_tpu_torch.portfolio.solver import minimize_simplex_rows

    rng = np.random.default_rng(7)
    n, R = 5, 7
    mu = rng.normal(0.002, 0.004, n)
    var = rng.uniform(2e-5, 2e-4, (R, n))
    weights = []
    for dev in (cuda, "cpu"):
        tmu, tvar = (torch.tensor(a, dtype=torch.float64, device=dev) for a in (mu, var))
        floors = torch.linspace(float(mu.min()), float(mu.max()), R, dtype=torch.float64,
                                device=dev)
        res = minimize_simplex_rows(
            lambda W: torch.sqrt(torch.clamp_min(torch.sum(W * tvar * W, dim=-1), 1e-18)),
            R, n, lambda W: torch.sum(tmu * W, dim=-1) - floors, device=dev,
            dtype=torch.float64)
        assert res.weights.device.type == torch.device(dev).type
        weights.append(res.weights.cpu().numpy())
    np.testing.assert_allclose(weights[0], weights[1], atol=1e-8)


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-rank mesh on the card over an NCCL process group in this
    process (a file rendezvous), destroyed after the test."""
    import torch.distributed as dist

    from portfoliooptgp_tpu_torch.parallel import distributed
    from portfoliooptgp_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize("file://" + str(tmp_path / "store"), 1, 0, device="cuda",
                           backend="nccl", timeout_s=120)
    try:
        yield make_mesh(device="cuda")
    finally:
        dist.destroy_process_group()


def test_torch_cuda_sharded_elbo_world1_nccl(nccl_mesh):
    """`sharded_neg_elbo` on one NCCL rank (the all-reduce pair on the card)
    against the one-device `gaussian_elbo_gram_fused(use_pallas=True)`:
    value rtol 3e-3, gradients normalized atol 2e-2, and one launch of each
    gram kernel per value+grad."""
    from portfoliooptgp_tpu_torch import kernels as tk
    from portfoliooptgp_tpu_torch.models import svgp
    from portfoliooptgp_tpu_torch.models.likelihoods import Gaussian
    from portfoliooptgp_tpu_torch.ops import svgp_gram as sg
    from portfoliooptgp_tpu_torch.parallel.elbo_sharded import sharded_neg_elbo
    from portfoliooptgp_tpu_torch.params import tree_leaves, tree_replace

    o = dict(device=nccl_mesh.device, dtype=torch.float32)
    rng = np.random.default_rng(3)
    X = torch.tensor(np.sort(rng.uniform(0, 1000, (2048, 1)), axis=0), **o)
    Y = torch.sin(X / 60.0) + 0.1 * torch.tensor(rng.normal(size=(2048, 1)), **o)
    w = torch.ones(2048, **o)
    model = svgp.SVGP.create(tk.SquaredExponential.create(1.0, 50.0, **o),
                             np.linspace(0, 1000, 128)[:, None],
                             likelihood=Gaussian.create(0.1, **o), **o)

    def value_grad(fn):
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(model)]
        v = fn(tree_replace(model, leaves))
        return v.detach(), torch.autograd.grad(v, leaves)

    want = value_grad(lambda m: -svgp.gaussian_elbo_gram_fused(m, X, Y, weights=w,
                                                               num_data=20_000, use_pallas=True))
    before = dict(sg.LAUNCHES)
    got = value_grad(lambda m: sharded_neg_elbo(m, X, Y, w, 20_000, nccl_mesh))
    torch.cuda.synchronize()
    assert {k: sg.LAUNCHES[k] - before[k] for k in before} == {"svgp_gram_fwd": 1,
                                                               "svgp_gram_bwd": 1}
    torch.testing.assert_close(got[0], want[0], rtol=3e-3, atol=0)
    for a, b in zip(got[1], want[1]):
        scale = max(float(b.abs().max()), 1.0)
        torch.testing.assert_close(a / scale, b / scale, rtol=0, atol=2e-2)


@pytest.mark.parametrize("layout", ["contiguous", "cyclic"])
def test_torch_cuda_sharded_gpr_nll_world1_nccl(nccl_mesh, layout):
    """`sharded_gpr_nll` on one NCCL rank against the dense torch.linalg
    value and closed-form gradients on the card (N = 1024, block 128)."""
    from portfoliooptgp_tpu_torch.parallel import dist_cholesky as dc

    N, nb, noise = 1024, 128, 0.1
    g = torch.Generator(device=nccl_mesh.device).manual_seed(1)
    A = torch.randn(N, N, generator=g, device=nccl_mesh.device)
    K = A @ A.T / N + 0.5 * torch.eye(N, device=nccl_mesh.device)
    y = torch.randn(N, 1, generator=g, device=nccl_mesh.device)
    L = torch.linalg.cholesky(K + noise * torch.eye(N, device=K.device))
    a = torch.linalg.solve_triangular(L, y, upper=False)
    want = 0.5 * torch.sum(a * a) + torch.sum(torch.log(torch.diagonal(L))) + 0.5 * N * np.log(
        2 * np.pi)
    W = torch.cholesky_inverse(L)
    alpha = W @ y
    Kl = dc.shard_rows(K, nccl_mesh, nb, layout).requires_grad_(True)
    yl = dc.shard_rows(y, nccl_mesh, nb, layout).requires_grad_(True)
    nz = torch.tensor(noise, device=K.device, requires_grad=True)
    nll = dc.sharded_gpr_nll(Kl, yl, nz, nccl_mesh, nb, layout)
    dK, dy, dn = torch.autograd.grad(nll, (Kl, yl, nz))
    torch.testing.assert_close(nll.detach(), want, rtol=3e-3, atol=0)
    for got, ref in ((dK, dc.shard_rows(0.5 * (W - alpha @ alpha.T), nccl_mesh, nb, layout)),
                     (dy, dc.shard_rows(alpha, nccl_mesh, nb, layout)),
                     (dn, 0.5 * (torch.trace(W) - torch.sum(alpha * alpha)))):
        scale = max(float(ref.abs().max()), 1.0)
        torch.testing.assert_close(got / scale, ref / scale, rtol=0, atol=2e-2)
