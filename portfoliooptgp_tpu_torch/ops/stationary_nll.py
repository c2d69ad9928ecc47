"""Fused batched GPR NLL for stationary kernel atoms — CUDA kernel + VJP.

Port of portfoliooptgp_tpu/ops/pallas/stationary_nll.py. For each model b

    K_b = (m⊗m) ∘ ⊕_j v_j φ_j(Σ_d s_{j,d} d2_{j,d}) + diag(m σ² + (1−m)),

⊕ ∈ {Σ, Π} over J atoms, s = 1/ℓ², d2 batch-shared (N, N) matrices. The
forward (factor, a = L⁻¹ err, Σ log diag L and, for the gradient,
W = L⁻¹) is the hand-written kernel `csrc/stationary_nll.cu` on CUDA
tensors and its plain PyTorch version (`stationary_nll_forward_plain`) on
CPU tensors; a CUDA tensor never takes the plain path. The backward is the
closed-form GPML 5.9 gradient, a line-for-line port of `_stg_bwd` and
`_st_bwd`, in torch.matmul (the JAX package leaves it to XLA):

    Kinv = WᵀW,  α = Wᵀa,  dK̄ = ½ g (Kinv − ααᵀ)

NLLs carry the 2π constant at the full N; callers restate it for the rows
a mask keeps. The mask cotangent is zero. The forward runs without W when
no input needs a gradient (the L-BFGS line-search trials) and with W when
one does (one gradient per iteration).

`LAUNCHES` counts kernel launches per wrapper: "stationary_nll_general"
for the masked sum/product path (`_stg_kernel`'s role) and
"stationary_nll" for the single-family path (`_st_kernel`/`_st_inv_kernel`).
The source holds two kernels, chosen by N: the tile kernel for N ≤ 256
(`MAX_TILE_N`) and the cluster kernel (a thread-block cluster of 2, 4 or 8
CTAs per model) up to `MAX_FUSED_N`; larger N is refused.
`kernel_launches()` reads how often each was launched, as the C entry point
counts them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from portfoliooptgp_tpu_torch.ops import linalg
from portfoliooptgp_tpu_torch.utils.profiling import span

LOG2PI = 1.8378770664093453
SQRT3 = 1.7320508075688772
SQRT5 = 2.23606797749979

# Build-in-shared-memory routing window, kept equal to the JAX package's
# fused window (stationary_nll.MAX_FUSED_N) so the router names the same
# tiers; the kernel's largest N (csrc/stationary_nll.cu: MAX_N).
MAX_FUSED_N = 512

# The tile kernel's largest N (csrc/stationary_nll.cu: MAX_TILE_N); the
# cluster kernel takes larger N.
MAX_TILE_N = 256

FAMILIES = ("se", "matern12", "matern32", "matern52")
GENERAL_FAMILIES = FAMILIES + ("rq", "periodic_se", "linear")
_FAMILY_CODE = {f: i for i, f in enumerate(GENERAL_FAMILIES)}

LAUNCHES = {"stationary_nll_general": 0, "stationary_nll": 0}


def fused_nll_supported(n: int) -> bool:
    """Is N inside the fused window (after the TPU's 128-padding)?"""
    return n + ((-n) % 128) <= MAX_FUSED_N


# -- φ and its derivatives (port of _phi, _phi_prime, _phi_dalpha) ---------

def _phi(family: str, u, alpha=None):
    if family == "se":
        return torch.exp(-0.5 * u)
    if family == "rq":
        return torch.exp(-alpha * torch.log1p(u / (2.0 * alpha)))
    if family == "linear":
        return u
    if family == "periodic_se":
        sine = torch.sin(math.pi * torch.sqrt(torch.clamp_min(u, 0.0)))
        return torch.exp(-0.5 * sine * sine / (alpha * alpha))
    r = torch.sqrt(torch.clamp_min(u, 0.0))
    if family == "matern12":
        return torch.exp(-r)
    if family == "matern32":
        return (1.0 + SQRT3 * r) * torch.exp(-SQRT3 * r)
    if family == "matern52":
        return (1.0 + SQRT5 * r + 5.0 / 3.0 * u) * torch.exp(-SQRT5 * r)
    raise ValueError(f"unknown stationary family: {family}")


def _phi_prime(family: str, u, alpha=None):
    """dφ/du, safe at u = 0 (masked where singular)."""
    if family == "se":
        return -0.5 * torch.exp(-0.5 * u)
    if family == "rq":
        w = u / (2.0 * alpha)
        return -0.5 * torch.exp(-(alpha + 1.0) * torch.log1p(w))
    if family == "linear":
        return torch.ones_like(u)
    if family == "periodic_se":
        # dφ/du = -φ·π·sin(2π√u) / (4α²√u); u→0 limit is -π²φ/(2α²)
        r = torch.sqrt(torch.clamp_min(u, 1e-20))
        phi = _phi(family, u, alpha)
        a2 = alpha * alpha
        grad = -phi * math.pi * torch.sin(2.0 * math.pi * r) / (4.0 * a2 * r)
        limit = -(math.pi * math.pi) * phi / (2.0 * a2)
        return torch.where(u > 1e-12, grad, limit)
    r = torch.sqrt(torch.clamp_min(u, 1e-20))
    if family == "matern12":
        # singular at 0; the diagonal's ℓ-gradient is exactly 0, mask it
        return torch.where(u > 1e-12, -torch.exp(-r) / (2.0 * r),
                           torch.zeros_like(u))
    if family == "matern32":
        return -1.5 * torch.exp(-SQRT3 * r)
    if family == "matern52":
        return -(5.0 / 6.0) * (1.0 + SQRT5 * r) * torch.exp(-SQRT5 * r)
    raise ValueError(f"unknown stationary family: {family}")


def _phi_dalpha(family: str, u, alpha):
    """dφ/dα; zero for the α-free families."""
    if family == "rq":
        w = u / (2.0 * alpha)
        return _phi(family, u, alpha) * (w / (1.0 + w) - torch.log1p(w))
    if family == "periodic_se":
        sine = torch.sin(math.pi * torch.sqrt(torch.clamp_min(u, 0.0)))
        return _phi(family, u, alpha) * sine * sine / (alpha ** 3)
    return torch.zeros_like(u)


# -- forward: plain version and kernel wrapper -----------------------------

def build_general_plain(families, combine, dims, d2s, vs, ss, als, noise, mask):
    """K (B, N, N) from stacked d2s (JD, N, N), vs/als (J, B), ss (JD, B),
    noise (B,) and mask (B, N) or None (all ones)."""
    E = None
    off = 0
    for j, (fam, dj) in enumerate(zip(families, dims)):
        U = None
        for d in range(dj):
            Ud = ss[off + d][:, None, None] * d2s[off + d][None]
            U = Ud if U is None else U + Ud
        off += dj
        term = vs[j][:, None, None] * _phi(fam, U, als[j][:, None, None])
        if E is None:
            E = term
        else:
            E = E + term if combine == "sum" else E * term
    if mask is None:
        mask = torch.ones(E.shape[:2], dtype=E.dtype, device=E.device)
    diag_vals = mask * noise[:, None] + (1.0 - mask)
    return mask[:, :, None] * mask[:, None, :] * E + torch.diag_embed(diag_vals)


def stationary_nll_forward_plain(families, combine, dims, d2s, err, vs, ss,
                                 als, noise, mask, with_inverse):
    """Plain PyTorch version of the kernel: (nll (B,), W (B,N,N) or None,
    a (B,N)). A factor that goes indefinite gives NaN."""
    N = err.shape[1]
    K = build_general_plain(families, combine, dims, d2s, vs, ss, als, noise,
                            mask)
    L = linalg.cholesky(K)
    a = linalg.solve_lower(L, err[..., None])[..., 0]
    logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    nll = 0.5 * torch.sum(a * a, dim=-1) + logdet + 0.5 * N * LOG2PI
    W = None
    if with_inverse:
        eye = torch.eye(N, dtype=L.dtype, device=L.device).expand_as(L)
        W = linalg.solve_lower(L, eye)
    return nll, W, a


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from portfoliooptgp_tpu_torch.ops import cuda_build

        lib = cuda_build.load("stationary_nll")
        lib.stationary_nll_launch.restype = ctypes.c_int
        lib.stationary_nll_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        lib.stationary_nll_cluster_shape.restype = ctypes.c_int
        lib.stationary_nll_cluster_shape.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.stationary_nll_kernel_launches.restype = None
        lib.stationary_nll_kernel_launches.argtypes = [ctypes.c_void_p]
        lib.stationary_nll_ctas_per_sm.restype = ctypes.c_int
        lib.stationary_nll_ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
        _LIB = lib
    return _LIB


def kernel_launches() -> dict:
    """{"tile": n, "cluster": n}: launches of the tile kernel (N ≤ 256) and
    of the cluster kernel since the library was loaded, counted by the C
    entry point where it launches each. Loads (and builds) the library."""
    out = (ctypes.c_longlong * 2)()
    _lib().stationary_nll_kernel_launches(out)
    return {"tile": out[0], "cluster": out[1]}


def ctas_per_sm(n: int, with_inverse: bool) -> int:
    """CTAs of the kernel that runs at N resident on one SM (occupancy)."""
    return _lib().stationary_nll_ctas_per_sm(n, 1 if with_inverse else 0)


def cluster_shape(n: int) -> dict:
    """The cluster kernel at 256 < N ≤ 512: its cluster size C (the
    smallest that fits; it depends on N alone), the warps G that share a
    tile column of W, the shared bytes a CTA and the clusters of that shape
    resident on the card at once."""
    out = (ctypes.c_int * 4)()
    rc = _lib().stationary_nll_cluster_shape(n, out)
    if rc != 0:
        raise RuntimeError(f"stationary_nll_cluster_shape({n}) failed: CUDA error {rc}")
    return {"C": out[0], "G": out[1], "smem_bytes": out[2], "clusters": out[3]}


def stationary_nll_forward_cuda(families, combine, dims, d2s, err, vs, ss, als,
                                noise, mask, with_inverse, counter):
    """Launch the CUDA kernel; same contract as the plain version. N past
    MAX_FUSED_N raises ValueError before the library is loaded."""
    if err.shape[-1] > MAX_FUSED_N:
        raise ValueError(f"the stationary NLL kernel takes N <= MAX_FUSED_N = {MAX_FUSED_N}, "
                         f"got N = {err.shape[-1]}")
    tensors = [d2s, err, vs, ss, als, noise] + ([] if mask is None else [mask])
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError("the stationary NLL kernel takes float32 CUDA "
                            f"tensors, got {t.dtype} on {t.device}")
    B, N = err.shape
    J = len(families)
    if (d2s.shape != (sum(dims), N, N) or vs.shape != (J, B)
            or ss.shape != (sum(dims), B) or als.shape != (J, B)
            or noise.shape != (B,)
            or (mask is not None and mask.shape != (B, N))):
        raise ValueError("stationary NLL operand shapes do not agree")
    d2s, err, vs, ss, als, noise = (t.contiguous() for t in
                                    (d2s, err, vs, ss, als, noise))
    mask = None if mask is None else mask.contiguous()
    lib = _lib()
    dev = err.device
    opts = dict(dtype=torch.float32, device=dev)
    nll = torch.empty((B,), **opts)
    a = torch.empty((B, N), **opts)
    W = torch.empty((B, N, N), **opts) if with_inverse else None
    fam = (ctypes.c_int * J)(*[_FAMILY_CODE[f] for f in families])
    dim = (ctypes.c_int * J)(*dims)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.stationary_nll_launch(
            _ptr(d2s), _ptr(err), _ptr(mask), _ptr(vs), _ptr(ss), _ptr(als),
            _ptr(noise), _ptr(nll), _ptr(a), _ptr(W), B, N, J,
            fam, dim, 1 if combine == "prod" else 0, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"stationary_nll kernel launch failed: CUDA error {rc}")
    LAUNCHES[counter] += 1
    return nll, W, a


def stationary_nll_forward(families, combine, dims, d2s, err, vs, ss, als,
                           noise, mask, with_inverse, counter):
    """The kernel's wrapper: CUDA tensors launch the kernel, CPU tensors
    take the plain version."""
    if err.device.type == "cuda":
        return stationary_nll_forward_cuda(families, combine, dims, d2s, err,
                                           vs, ss, als, noise, mask,
                                           with_inverse, counter)
    if err.device.type == "cpu":
        return stationary_nll_forward_plain(families, combine, dims, d2s, err,
                                            vs, ss, als, noise, mask,
                                            with_inverse)
    raise ValueError(f"unsupported device {err.device}")


# -- autograd: the masked sum/product path (_stg_fwd / _stg_bwd) ------------

class _GeneralNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, families, combine, dims, plain, d2s, err, vs, ls, als,
                noise, mask):
        with_inverse = any(ctx.needs_input_grad[4:10])
        ss = 1.0 / (ls * ls)
        fwd = stationary_nll_forward_plain if plain else stationary_nll_forward
        args = (families, combine, dims, d2s, err, vs, ss, als, noise, mask,
                with_inverse)
        nll, W, a = fwd(*args) if plain else fwd(*args, "stationary_nll_general")
        ctx.meta = (families, combine, dims)
        if with_inverse:
            ctx.save_for_backward(d2s, err, vs, ls, als, noise, mask, W, a)
        return nll

    @staticmethod
    def backward(ctx, g):
        with span("nll.backward"):
            families, combine, dims = ctx.meta
            d2s, err, vs, ls, als, noise, mask, W, a = ctx.saved_tensors
            need = ctx.needs_input_grad
            Wt = W.transpose(-1, -2)
            Kinv = Wt @ W
            alpha = (Wt @ a[..., None])[..., 0]
            dKbar = g[:, None, None] * 0.5 * (
                Kinv - alpha[:, :, None] * alpha[:, None, :])
            T = dKbar * (mask[:, :, None] * mask[:, None, :])
            ss = 1.0 / (ls * ls)
            offs, o = [], 0  # atom-major offsets into the flat d2s/ls stacks
            for dj in dims:
                offs.append(o)
                o += dj
            us = []  # per-atom φ argument u_j = Σ_d s_{j,d} d2_{j,d}
            for j, dj in enumerate(dims):
                u = 0.0
                for d in range(dj):
                    k = offs[j] + d
                    u = u + ss[k][:, None, None] * d2s[k][None]
                us.append(u)
            abc = [al[:, None, None] for al in als]
            phis = [_phi(fam, u, ab) for fam, u, ab in zip(families, us, abc)]
            P = 1.0
            for v in vs:
                P = P * v
            dvs, dals = [], []
            dls = [None] * ls.shape[0]
            dd2s = [None] * d2s.shape[0]
            for j, fam in enumerate(families):
                if combine == "sum":
                    # K = Σ_k v_k φ_k: ∂K/∂v_j = φ_j, ∂K/∂u_j = v_j φ'_j
                    dv_j = torch.sum(T * phis[j], dim=(1, 2))
                    wj = vs[j][:, None, None]
                else:
                    # K = Π_k v_k φ_k: ∂K/∂v_j = (Π v) φ_j Π_{k≠j} φ_k / v_j
                    other = 1.0
                    for k2 in range(len(families)):
                        if k2 != j:
                            other = other * phis[k2]
                    dv_j = torch.sum(T * other * phis[j], dim=(1, 2)) * (P / vs[j])
                    wj = P[:, None, None] * other
                du_j = wj * T * _phi_prime(fam, us[j], abc[j])
                for d in range(dims[j]):
                    k = offs[j] + d
                    ds_k = torch.sum(du_j * d2s[k][None], dim=(1, 2))
                    dls[k] = ds_k * (-2.0 / (ls[k] ** 3))
                    dd2s[k] = torch.sum(ss[k][:, None, None] * du_j, dim=0)
                if fam in ("rq", "periodic_se"):
                    dal_pre = wj * T * _phi_dalpha(fam, us[j], abc[j])
                    dal_j = torch.sum(dal_pre, dim=(1, 2))
                else:
                    dal_j = torch.zeros_like(als[j])
                dvs.append(dv_j)
                dals.append(dal_j)
            diag_dK = torch.diagonal(dKbar, dim1=-2, dim2=-1)
            dnoise = torch.sum(diag_dK * mask, dim=-1)
            derr = g[:, None] * alpha
            return (None, None, None, None,
                    torch.stack(dd2s) if need[4] else None,
                    derr, torch.stack(dvs), torch.stack(dls), torch.stack(dals),
                    dnoise, None)


def _general(families, combine, dims, d2s, err, vs, ls, als, noise, mask,
             plain):
    families = tuple(families)
    if dims is None:
        dims = (1,) * len(families)
    dims = tuple(int(d) for d in dims)
    for f in families:
        if f not in GENERAL_FAMILIES:
            raise ValueError(f"unknown stationary family: {f}")
    if len(d2s) != sum(dims) or len(ls) != sum(dims):
        raise ValueError("d2s and ls need sum(dims) entries")
    if not isinstance(d2s, torch.Tensor):
        d2s = torch.stack(tuple(d2s))
    return _GeneralNLL.apply(
        families, combine, dims, plain, d2s, err,
        torch.stack(tuple(vs)), torch.stack(tuple(ls)), torch.stack(tuple(als)),
        noise, mask)


def batched_nll_stationary_general(families, d2s, err, vs, ls, als, noise,
                                   mask, dims=None):
    """Masked / product NLL of B models (the JAX package's operand
    contract): families a tuple of J names from GENERAL_FAMILIES; dims the
    per-atom count of shared (N, N) matrices (default all 1); d2s/ls
    atom-major flat tuples of Σ dims (N, N) matrices and (B,) constrained
    lengthscales (periods for 'periodic_se', ones for 'linear'); vs/als J
    tuples of (B,) variances and second shape parameters (RQ α, the
    periodic base lengthscale, ones elsewhere); noise (B,); mask (B, N) of
    1/0 (rows with mask 0 are identity rows). d2s may also come stacked,
    one (Σ dims, N, N) tensor, taken as it is. Returns (B,) NLLs with the
    2π constant at the full N."""
    return _general(families, "prod", dims, d2s, err, vs, ls, als, noise,
                    mask, plain=False)


def batched_nll_stationary_sum(families, d2s, err, vs, ls, als, noise, mask,
                               dims=None):
    """SUM-combined variant of `batched_nll_stationary_general`."""
    return _general(families, "sum", dims, d2s, err, vs, ls, als, noise,
                    mask, plain=False)


def batched_nll_stationary_general_plain(families, d2s, err, vs, ls, als,
                                         noise, mask, dims=None):
    """`batched_nll_stationary_general` through the plain forward on any
    device (the oracle the kernel is held against)."""
    return _general(families, "prod", dims, d2s, err, vs, ls, als, noise,
                    mask, plain=True)


def batched_nll_stationary_sum_plain(families, d2s, err, vs, ls, als, noise,
                                     mask, dims=None):
    return _general(families, "sum", dims, d2s, err, vs, ls, als, noise,
                    mask, plain=True)


# -- autograd: the single-family path (_st_fwd / _st_bwd) ------------------

class _SingleNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, family, plain, d2, err, v, l, nz):
        with_inverse = any(ctx.needs_input_grad[2:7])
        s = 1.0 / (l * l)
        one = torch.ones_like(v)[None]
        args = ((family,), "prod", (1,), d2[None], err, v[None], s[None], one,
                nz, None, with_inverse)
        if plain:
            nll, W, a = stationary_nll_forward_plain(*args)
        else:
            nll, W, a = stationary_nll_forward(*args, "stationary_nll")
        ctx.family = family
        if with_inverse:
            ctx.save_for_backward(d2, err, v, l, nz, W, a)
        return nll

    @staticmethod
    def backward(ctx, g):
        with span("nll.backward"):
            family = ctx.family
            d2, err, v, l, nz, W, a = ctx.saved_tensors
            Wt = W.transpose(-1, -2)
            Kinv = Wt @ W
            alpha = (Wt @ a[..., None])[..., 0]
            dKbar = g[:, None, None] * 0.5 * (
                Kinv - alpha[:, :, None] * alpha[:, None, :])
            s = 1.0 / (l * l)
            u = s[:, None, None] * d2[None]
            E = _phi(family, u)
            dphi = _phi_prime(family, u)
            dv = torch.sum(dKbar * E, dim=(1, 2))
            darg = v[:, None, None] * dKbar * dphi  # ∂NLL/∂u elementwise
            ds = torch.sum(darg * d2[None], dim=(1, 2))
            dl = ds * (-2.0 / (l * l * l))
            dd2 = (torch.sum(s[:, None, None] * darg, dim=0)
                   if ctx.needs_input_grad[2] else None)
            dnoise = g * 0.5 * (torch.diagonal(Kinv, dim1=-2, dim2=-1).sum(-1)
                                - torch.sum(alpha * alpha, dim=-1))
            derr = g[:, None] * alpha
            return None, None, dd2, derr, dv, dl, dnoise


def batched_nll_stationary(d2, err, variance, lengthscale, noise, family):
    """NLL of B single-family isotropic models sharing inputs: d2 (N, N)
    unit-lengthscale squared distances, err (B, N), variance/lengthscale/
    noise (B,), family in FAMILIES. Returns (B,) NLLs."""
    if family not in FAMILIES:
        raise ValueError(f"unknown stationary family: {family}")
    return _SingleNLL.apply(family, False, d2, err, variance, lengthscale, noise)


def batched_nll_stationary_plain(d2, err, variance, lengthscale, noise, family):
    """`batched_nll_stationary` through the plain forward on any device."""
    if family not in FAMILIES:
        raise ValueError(f"unknown stationary family: {family}")
    return _SingleNLL.apply(family, True, d2, err, variance, lengthscale, noise)
