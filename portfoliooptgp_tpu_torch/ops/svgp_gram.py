"""The batch phase of the Gaussian SVGP ELBO as one kernel per direction.

Port of portfoliooptgp_tpu/ops/pallas/svgp_gram.py. For a minibatch of B
rows, M inducing points and D input dimensions:

    u[m, b]  = Σ_d s_d (Z[m, d] − X[b, d])²   (built by differences, per dim)
    Kuf      = v φ(u)                          (M, B)
    m_b      = Σ_m t_m Kuf[m, b],  e = y_eff − m
    G        = (Kuf ∘ w) Kufᵀ                  (M, M)
    sq       = Σ_b w_b e_b²

and the closed-form backward from (Ḡ, s̄q):

    K̄uf = (Ḡ + Ḡᵀ) Kuf ∘ w − 2 s̄q t ⊗ (w e),  W2 = K̄uf ∘ v φ′(u)
    t̄ = −2 s̄q Kuf (w e),  v̄ = Σ K̄uf ∘ φ,  ȳ = 2 s̄q w e,
    Z̄[m, d] = 2 s_d Σ_b W2[m, b] (Z[m, d] − X[b, d]),
    s̄_d = Σ_{m,b} W2[m, b] (Z[m, d] − X[b, d])²   (summed over d when s is
    one shared scale).

u is never formed through ‖z‖² + ‖x‖² − 2zx: at day coordinates up to
16,060 and ℓ = 300 that expansion loses ~2e-4 of u in float32, which is
why the TPU kernel builds it by differences too. s̄ and Z̄ are likewise
taken by differences (the TPU kernel expands them into z²·rW + x²·cW −
2z·WX, the same sums in another order). X and w get zero gradients.

On CUDA tensors the two directions are the hand-written kernels of
`csrc/svgp_gram.cu` (the TPU kernels `_fwd_kernel` and `_bwd_kernel`); on
CPU tensors they are `gram_fwd_plain` and `gram_bwd_plain`, the same
arithmetic in torch and the kernels' oracle. A CUDA tensor never takes a
plain version: a failed build or launch raises. `LAUNCHES` counts kernel
launches: "svgp_gram_fwd" and "svgp_gram_bwd" (one each per call, the
two-pass reduction included).
"""

from __future__ import annotations

import ctypes

import torch

from portfoliooptgp_tpu_torch.ops.stationary_nll import _phi, _phi_prime

LANES = 128  # the TPU kernel's lane budget for D, kept as the eligibility rule
MAX_FUSED_B = 8192  # the TPU kernel's single-program budget, kept likewise
FAMILIES = ("se", "matern12", "matern32", "matern52")
_FAMILY_CODE = {f: i for i, f in enumerate(FAMILIES)}

# Columns of X per CTA, and the shared-memory budget that caps them at large M.
TILE_B = 64
_SMEM_BUDGET = 200 * 1024

LAUNCHES = {"svgp_gram_fwd": 0, "svgp_gram_bwd": 0}


def _check(Z, X, y_eff, w, t, family):
    M, D = Z.shape
    B = X.shape[0]
    if family not in _FAMILY_CODE:
        raise ValueError(f"unknown gram family {family!r}; one of {FAMILIES}")
    if D > LANES:
        raise ValueError(f"D={D} exceeds the fused lane budget {LANES}")
    if M % 8:
        raise ValueError("the fused gram path needs M % 8 == 0")
    if X.shape != (B, D) or y_eff.shape != (B,) or w.shape != (B,) or t.shape != (M,):
        raise ValueError(f"gram operands Z {tuple(Z.shape)}, X {tuple(X.shape)}, y "
                         f"{tuple(y_eff.shape)}, w {tuple(w.shape)}, t {tuple(t.shape)} are "
                         "not (M, D), (B, D), (B,), (B,), (M,)")


def _scales(s, D):
    """s (any shape holding 1 or D values) → (D,)."""
    return s.reshape(-1).expand(D) if s.numel() == 1 else s.reshape(D)


def _build(Z, X, v, s, family):
    """(u, Kuf) of shape (M, B), u by differences one dimension at a time."""
    sv = _scales(s, Z.shape[1])
    u = None
    for d in range(Z.shape[1]):
        diff = Z[:, d, None] - X[None, :, d]
        term = sv[d] * (diff * diff)
        u = term if u is None else u + term
    return u, v.reshape(()) * _phi(family, u)


# -- plain versions ----------------------------------------------------------

def gram_fwd_plain(Z, X, y_eff, w, t, v, s, family):
    """(G (M, M), sq ()) in torch."""
    _check(Z, X, y_eff, w, t, family)
    _, Kuf = _build(Z, X, v, s, family)
    e = y_eff - t @ Kuf
    sq = torch.sum(w * e * e)
    G = (Kuf * w) @ Kuf.T
    return G, sq


def gram_bwd_plain(Z, X, y_eff, w, t, v, s, family, Gbar, sqbar):
    """(Z̄ (M, D), ȳ (B,), t̄ (M,), v̄ (), s̄ (D,) per dimension) in torch."""
    _check(Z, X, y_eff, w, t, family)
    u, Kuf = _build(Z, X, v, s, family)
    vs = v.reshape(())
    sqbar = sqbar.reshape(())
    we = w * (y_eff - t @ Kuf)
    tbar = -2.0 * sqbar * (Kuf @ we)
    ybar = 2.0 * sqbar * we
    kbar = ((Gbar + Gbar.T) @ Kuf) * w - 2.0 * sqbar * t[:, None] * we[None, :]
    vbar = torch.sum(kbar * _phi(family, u))
    W2 = kbar * (vs * _phi_prime(family, u))
    sv = _scales(s, Z.shape[1])
    zbar, sbar = [], []
    for d in range(Z.shape[1]):
        diff = Z[:, d, None] - X[None, :, d]
        zbar.append(2.0 * sv[d] * torch.sum(W2 * diff, dim=1))
        sbar.append(torch.sum(W2 * diff * diff))
    return torch.stack(zbar, dim=1), ybar, tbar, vbar, torch.stack(sbar)


# -- the CUDA kernels ---------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from portfoliooptgp_tpu_torch.ops import cuda_build

        lib = cuda_build.load("svgp_gram")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.svgp_gram_fwd_launch.restype = i32
        lib.svgp_gram_fwd_launch.argtypes = [ptr] * 7 + [ptr] * 4 + [i32] * 5 + [ptr]
        lib.svgp_gram_bwd_launch.restype = i32
        lib.svgp_gram_bwd_launch.argtypes = ([ptr] * 9 + [ptr] * 6 + [ptr] * 4
                                             + [i32] * 5 + [ptr])
        _LIB = lib
    return _LIB


def tile_width(M: int) -> int:
    """Columns per CTA: TILE_B, fewer where the backward's two (M, TILE_B)
    tiles would pass the shared-memory budget (M above ~390); a multiple
    of 4."""
    bt = min(TILE_B, (_SMEM_BUDGET // 4 - M - 32) // (2 * M + 3))
    bt -= bt % 4
    if bt < 4:
        raise ValueError(f"M={M} inducing points exceed the gram kernel's shared memory")
    return bt


def _cuda_operands(Z, X, y_eff, w, t, v, s, family):
    _check(Z, X, y_eff, w, t, family)
    for a in (Z, X, y_eff, w, t, v, s):
        if a.device.type != "cuda" or a.dtype != torch.float32:
            raise TypeError("the gram kernels take float32 CUDA tensors, got "
                            f"{a.dtype} on {a.device}")
    D = Z.shape[1]
    return [a.contiguous() for a in (Z, X, y_eff, w, t, v.reshape(1), _scales(s, D))]


def _p(a):
    return ctypes.c_void_p(a.data_ptr())


def gram_fwd_cuda(Z, X, y_eff, w, t, v, s, family):
    """Launch the forward kernel (tile pass + reduction): (G, sq)."""
    ops = _cuda_operands(Z, X, y_eff, w, t, v, s, family)
    (M, D), B = Z.shape, X.shape[0]
    bt = tile_width(M)
    T = max(1, -(-B // bt))
    opts = dict(dtype=torch.float32, device=Z.device)
    G = torch.empty((M, M), **opts)
    sq = torch.empty((), **opts)
    gpart = torch.empty((T, M, M), **opts)
    sqpart = torch.empty((T,), **opts)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        rc = _lib().svgp_gram_fwd_launch(*map(_p, ops), _p(G), _p(sq), _p(gpart), _p(sqpart),
                                         M, B, D, bt, _FAMILY_CODE[family],
                                         ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"svgp_gram_fwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["svgp_gram_fwd"] += 1
    return G, sq


def gram_bwd_cuda(Z, X, y_eff, w, t, v, s, family, Gbar, sqbar):
    """Launch the backward kernel (tile pass + reduction): (Z̄, ȳ, t̄, v̄, s̄
    per dimension)."""
    ops = _cuda_operands(Z, X, y_eff, w, t, v, s, family)
    (M, D), B = Z.shape, X.shape[0]
    if Gbar.shape != (M, M) or Gbar.device != Z.device or sqbar.numel() != 1:
        raise ValueError(f"Ḡ {tuple(Gbar.shape)} / s̄q do not fit M={M}")
    Gbar = Gbar.to(torch.float32).contiguous()
    sqbar = sqbar.to(torch.float32).reshape(1).contiguous()
    bt = tile_width(M)
    T = max(1, -(-B // bt))
    opts = dict(dtype=torch.float32, device=Z.device)
    zbar = torch.empty((M, D), **opts)
    ybar = torch.empty((B,), **opts)
    tbar = torch.empty((M,), **opts)
    vbar = torch.empty((), **opts)
    sbar = torch.empty((D,), **opts)
    H = torch.empty((M, M), **opts)
    zpart = torch.empty((T, M, D), **opts)
    tpart = torch.empty((T, M), **opts)
    spart = torch.empty((T, D), **opts)
    vpart = torch.empty((T,), **opts)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        rc = _lib().svgp_gram_bwd_launch(
            *map(_p, ops), _p(Gbar), _p(sqbar),
            _p(zbar), _p(ybar), _p(tbar), _p(vbar), _p(sbar), _p(H),
            _p(zpart), _p(tpart), _p(spart), _p(vpart),
            M, B, D, bt, _FAMILY_CODE[family], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"svgp_gram_bwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["svgp_gram_bwd"] += 1
    return zbar, ybar, tbar, vbar, sbar


def gram_fwd(Z, X, y_eff, w, t, v, s, family):
    """The forward kernel's wrapper: CUDA tensors launch it, CPU tensors
    take the plain version."""
    if Z.device.type == "cuda":
        return gram_fwd_cuda(Z, X, y_eff, w, t, v, s, family)
    if Z.device.type == "cpu":
        return gram_fwd_plain(Z, X, y_eff, w, t, v, s, family)
    raise ValueError(f"unsupported device {Z.device}")


def gram_bwd(Z, X, y_eff, w, t, v, s, family, Gbar, sqbar):
    """The backward kernel's wrapper, dispatched like `gram_fwd`."""
    if Z.device.type == "cuda":
        return gram_bwd_cuda(Z, X, y_eff, w, t, v, s, family, Gbar, sqbar)
    if Z.device.type == "cpu":
        return gram_bwd_plain(Z, X, y_eff, w, t, v, s, family, Gbar, sqbar)
    raise ValueError(f"unsupported device {Z.device}")


class _GramReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Z, X, y_eff, w, t, v, s, family):
        ctx.family = family
        ctx.save_for_backward(Z, X, y_eff, w, t, v, s)
        return gram_fwd(Z, X, y_eff, w, t, v, s, family)

    @staticmethod
    def backward(ctx, Gbar, sqbar):
        Z, X, y_eff, w, t, v, s = ctx.saved_tensors
        if Gbar is None:
            Gbar = torch.zeros((Z.shape[0],) * 2, dtype=Z.dtype, device=Z.device)
        if sqbar is None:
            sqbar = torch.zeros((), dtype=Z.dtype, device=Z.device)
        zbar, ybar, tbar, vbar, sbar = gram_bwd(Z, X, y_eff, w, t, v, s, ctx.family,
                                                Gbar.contiguous(), sqbar)
        if s.numel() == 1:  # one shared scale: sum the per-dimension bars
            sbar = torch.sum(sbar)
        need = ctx.needs_input_grad
        return (zbar if need[0] else None,
                torch.zeros_like(X) if need[1] else None,
                ybar if need[2] else None,
                torch.zeros_like(w) if need[3] else None,
                tbar if need[4] else None,
                vbar.reshape(v.shape) if need[5] else None,
                sbar.reshape(s.shape) if need[6] else None,
                None)


def gram_reduce(Z, X, y_eff, w, t, v, s, family="se"):
    """Differentiable (G, sq) of the Gaussian SVGP ELBO's batch phase.

    Z (M, D) inducing inputs, X (B, D) rows, y_eff (B,) targets less the
    mean, w (B,) row weights (0 for padding rows, which then contribute
    exactly nothing), t (M,) = Luu⁻ᵀ q_mu, v the variance and s = 1/ℓ²
    (one value, shared, or D values, ARD). Differentiable in Z, y_eff, t, v
    and s; X and w get zero gradients. M must be a multiple of 8 and D at
    most 128. φ families: se, matern12, matern32, matern52."""
    return _GramReduce.apply(Z, X, y_eff, w, t, v, s, family)
