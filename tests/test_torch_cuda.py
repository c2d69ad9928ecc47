"""The CUDA kernels (stationary NLL, blocked panel factor, triangular
inverse, dense NLL, SVGP gram) against their plain PyTorch versions.

Needs an NVIDIA GPU and nvcc (marker `cuda`); skipped elsewhere. Float32
on the card with the tolerances of the matching checks in
tools/smoke_tpu.py: values rtol 3e-3, gradients normalized atol 2e-2.
Run on the card with
`python -m pytest --noconftest tests/test_torch_cuda.py -m cuda`.
"""

import numpy as np
import pytest
import torch

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
