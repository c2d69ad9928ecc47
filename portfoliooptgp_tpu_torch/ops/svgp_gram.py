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
launches: "svgp_gram_fwd" and "svgp_gram_bwd" (one each per call; each
direction is one launch, its reduction across CTAs inside). The grids come
from `launch_shape(M, B, D)`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from portfoliooptgp_tpu_torch.ops import cuda_build
from portfoliooptgp_tpu_torch.ops.stationary_nll import _phi, _phi_prime

LANES = 128  # the TPU kernel's lane budget for D, kept as the eligibility rule
MAX_FUSED_B = 8192  # the TPU kernel's single-program budget, kept likewise
FAMILIES = ("se", "matern12", "matern32", "matern52")
_FAMILY_CODE = {f: i for i, f in enumerate(FAMILIES)}

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

# The kernels' fixed shapes (csrc/svgp_gram.cu): columns of X per pass of a
# CTA, G's blocks, the backward's rows per CTA, the most CTAs a unit splits
# the batch over.
STAGE = 128
FWD_BLOCK = 32
BWD_ROWS = 16
MAX_RANKS = 16
SMS = 132  # the H100's SMs: a grid aims at this many CTAs, one an SM
MIN_CHUNK = 32  # columns of X a rank takes at least, below which C shrinks
SMEM_LIMIT = 232_448  # shared memory a block may opt into on Hopper
# The largest M the parent design took (its backward's two (M, 4) tiles
# filled the shared memory above it); kept so that the kernels take the
# same shapes as before.
MAX_M = 5680


class Launch(NamedTuple):
    """One kernel's grid: `units` units of work of `ranks` CTAs each, rank
    r taking columns r·chunk .. (r + 1)·chunk − 1 of X; `kc` rows of Kuf
    per backward pass (0 in the forward); `smem` bytes of shared memory per
    CTA."""
    units: int
    ranks: int
    chunk: int
    kc: int
    smem: int


def _fwd_smem(D):
    return 4 * (2 * STAGE * FWD_BLOCK + FWD_BLOCK ** 2 + 2 * FWD_BLOCK * D + STAGE * D
                + 2 * STAGE + D + 32 + 1)


def _bwd_smem(D, kc):
    return 4 * (kc * STAGE + kc * BWD_ROWS + D * kc + kc + D * STAGE + D * BWD_ROWS + BWD_ROWS
                + BWD_ROWS * STAGE + 5 * STAGE + BWD_ROWS * D + 8 * D + 8 * BWD_ROWS
                + BWD_ROWS + BWD_ROWS * D + D + 1 + D + 32 + 1)


def _split(units, B):
    """C ranks of `chunk` columns: as many as keep the grid within SMS CTAs
    and each rank at MIN_CHUNK columns or more, at most MAX_RANKS."""
    C = max(1, min(MAX_RANKS, SMS // units, -(-B // MIN_CHUNK)))
    return C, -(-B // C)


@functools.lru_cache(maxsize=None)
def launch_shape(M: int, B: int, D: int):
    """(forward, backward) `Launch` of the gram kernels at (M, B, D), from
    the shape alone, so that a given input always rounds the same way. The
    forward's units are one for sq and the 32 × 32 blocks of G's lower
    triangle, the backward's the 16-row blocks of Z; both split B into
    their ranks' chunks. The C entry points check what they are given. Raises
    ValueError where the kernels take no such shape (the parent's rule)."""
    if M % 8 or M < 8:
        raise ValueError("the fused gram path needs M % 8 == 0")
    if not 1 <= D <= LANES:
        raise ValueError(f"D={D} exceeds the fused lane budget {LANES}")
    if M > MAX_M:
        raise ValueError(f"M={M} inducing points exceed the gram kernels' largest M, {MAX_M}")
    T = -(-M // FWD_BLOCK)
    units = T * (T + 1) // 2 + 1
    fwd = Launch(units, *_split(units, B), 0, _fwd_smem(D))
    units = -(-M // BWD_ROWS)
    kc = 128 if _bwd_smem(D, 128) <= SMEM_LIMIT else 64
    bwd = Launch(units, *_split(units, B), kc, _bwd_smem(D, kc))
    return fwd, bwd


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("svgp_gram")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.svgp_gram_fwd_launch.restype = i32
        lib.svgp_gram_fwd_launch.argtypes = ([ptr] * 7 + [i32] + [ptr] * 4 + [i32] * 7
                                             + [ptr])
        lib.svgp_gram_bwd_launch.restype = i32
        lib.svgp_gram_bwd_launch.argtypes = ([ptr] * 7 + [i32] + [ptr] * 9 + [i32] * 8
                                             + [ptr])
        lib.svgp_gram_blocks_per_sm.restype = i32
        lib.svgp_gram_blocks_per_sm.argtypes = [i32] * 3 + [ptr]
        _LIB = lib
    return _LIB


def blocks_per_sm(backward: bool, launch: Launch, D: int) -> int:
    """How many of `launch`'s CTAs (at D input dimensions) an SM holds at
    once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = ctypes.c_int()
    rc = _lib().svgp_gram_blocks_per_sm(int(backward), D, launch.smem, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"svgp_gram_blocks_per_sm failed: CUDA error {rc}")
    return out.value


def _cuda_operands(Z, X, y_eff, w, t, v, s, family):
    _check(Z, X, y_eff, w, t, family)
    for a in (Z, X, y_eff, w, t, v, s):
        if a.device.type != "cuda" or a.dtype != torch.float32:
            raise TypeError("the gram kernels take float32 CUDA tensors, got "
                            f"{a.dtype} on {a.device}")
    D = Z.shape[1]
    if v.numel() != 1 or s.numel() not in (1, D):
        raise ValueError(f"v holds {v.numel()} values and s {s.numel()}; want 1 and 1 or {D}")
    return [a.contiguous() for a in (Z, X, y_eff, w, t, v, s)]


def _p(a):
    return ctypes.c_void_p(a.data_ptr())


def gram_fwd_cuda(Z, X, y_eff, w, t, v, s, family):
    """Launch the forward kernel (one launch, the reduction inside): (G, sq)."""
    ops = _cuda_operands(Z, X, y_eff, w, t, v, s, family)
    (M, D), B = Z.shape, X.shape[0]
    fwd, _ = launch_shape(M, B, D)
    opts = dict(dtype=torch.float32, device=Z.device)
    G = torch.empty((M, M), **opts)
    sq = torch.empty((), **opts)
    slots = fwd.units * fwd.ranks * FWD_BLOCK ** 2 if fwd.ranks > 1 else 1
    scratch = torch.empty((slots,), **opts)  # the units' partials
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        rc = _lib().svgp_gram_fwd_launch(
            *map(_p, ops), ops[6].numel(), _p(G), _p(sq), _p(scratch),
            _p(cuda_build.tickets(Z.device, stream, fwd.units)), M, B, D, _FAMILY_CODE[family],
            fwd.ranks, fwd.chunk, fwd.smem, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"svgp_gram_fwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["svgp_gram_fwd"] += 1
    return G, sq


def gram_bwd_cuda(Z, X, y_eff, w, t, v, s, family, Gbar, sqbar):
    """Launch the backward kernel (one launch, the reduction inside): (Z̄,
    ȳ, t̄, v̄, s̄ per dimension)."""
    ops = _cuda_operands(Z, X, y_eff, w, t, v, s, family)
    (M, D), B = Z.shape, X.shape[0]
    if Gbar.shape != (M, M) or Gbar.device != Z.device or sqbar.numel() != 1:
        raise ValueError(f"Ḡ {tuple(Gbar.shape)} / s̄q do not fit M={M}")
    if Gbar.dtype != torch.float32:
        Gbar = Gbar.to(torch.float32)
    if sqbar.dtype != torch.float32:
        sqbar = sqbar.to(torch.float32)
    Gbar, sqbar = Gbar.contiguous(), sqbar.contiguous()
    _, bwd = launch_shape(M, B, D)
    opts = dict(dtype=torch.float32, device=Z.device)
    zbar = torch.empty((M, D), **opts)
    ybar = torch.empty((B,), **opts)
    tbar = torch.empty((M,), **opts)
    vbar = torch.empty((), **opts)
    sbar = torch.empty((D,), **opts)
    parts = BWD_ROWS * (D + 1) + D + 1  # a CTA's partial t̄, Z̄, s̄ and v̄
    slots = bwd.units * bwd.ranks * parts if bwd.ranks > 1 else 0
    scratch = torch.empty((bwd.units * (D + 1) + slots,), **opts)  # the units' s̄, v̄; partials
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        rc = _lib().svgp_gram_bwd_launch(
            *map(_p, ops), ops[6].numel(), _p(Gbar), _p(sqbar),
            _p(zbar), _p(ybar), _p(tbar), _p(vbar), _p(sbar), _p(scratch),
            _p(cuda_build.tickets(Z.device, stream, bwd.units + 1)), M, B, D, _FAMILY_CODE[family],
            bwd.ranks, bwd.chunk, bwd.kc, bwd.smem, ctypes.c_void_p(stream))
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
