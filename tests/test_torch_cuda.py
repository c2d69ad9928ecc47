"""The CUDA kernels (stationary NLL, blocked panel factor, triangular
inverse) against their plain PyTorch versions.

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
    (("matern32",), (1,), 400),  # the packed factor exceeds shared memory: workspace path
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
