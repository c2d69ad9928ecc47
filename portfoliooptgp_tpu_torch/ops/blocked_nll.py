"""Batched GPR NLL by a blocked Cholesky with a CUDA panel kernel.

Port of the `blocked` tier of portfoliooptgp_tpu/ops/pallas/blocked_nll.py
(`_factor_panel`, `blocked_cholesky`, `_blocked_factor_solve`,
`batched_nll_blocked` and its VJP). The right-looking blocked factor walks
128-column panels of Ks = K + σ²I:

- the panel factor (L11 = chol(A11), L21 = A21 L11⁻ᵀ and Σ log diag L11)
  is the hand-written kernel `csrc/blocked_panel.cu` on CUDA tensors and
  `factor_panel_plain` on CPU tensors; a CUDA tensor never takes the plain
  version;
- the trailing update `work − L21 L21ᵀ` between panels, the forward solve
  a = L⁻¹y and the backward's W = L⁻¹ are torch.matmul and
  torch.linalg.solve_triangular in full fp32 (TF32 is off), as the JAX
  package leaves them to XLA at precision="highest".

Unlike the JAX package, nothing is padded: N needs not be a multiple of
128 (the last panel is N mod 128 columns wide) and B needs not be a
multiple of 8. The NLL, its 2π constant, the log-determinant and every
gradient are those of the real N. An indefinite pivot gives NaN.

The `blocked_hinv` tier (1024 < padded N ≤ 4096, `hinv_nll_preferred`)
is the JAX module's second half (`_hinv_factor`, `batched_nll_hinv`,
`blocked_triangular_inverse`, `triangular_inverse_uneven`):

- L = chol(Ks) is torch.linalg.cholesky (NaN on failure, ops/linalg), as
  the JAX package leaves it to XLA;
- W = L⁻¹ is hierarchical: the 128×128 diagonal blocks of all B factors
  are inverted in one launch of the CUDA kernel of ops/nll.py
  (`triangular_inverse`, the TPU kernel `_trinv_kernel`), then joined by
  [[A, 0], [C, D]]⁻¹ = [[A⁻¹, 0], [−D⁻¹CA⁻¹, D⁻¹]] in batched
  torch.matmul at full fp32 (the JAX package runs its power-of-two levels
  at Precision.HIGH, 3-pass bf16, and its uneven join at HIGHEST);
- a = W y, and the backward is the closed form Ks⁻¹ = WᵀW, α = Wᵀa.

The tier pads N to a multiple of 128 with an identity tail (the inverse
works on 128-blocks) but not the batch; the NLL, its 2π constant, the
log-determinant and every gradient are those of the real N.

`LAUNCHES["blocked_panel"]` counts panel-kernel launches, one per panel;
the hinv tier's launches are counted in ops/nll.LAUNCHES, one per NLL
evaluation.
"""

from __future__ import annotations

import ctypes

import torch

from portfoliooptgp_tpu_torch.ops import linalg
from portfoliooptgp_tpu_torch.ops import nll as nll_mod

LOG2PI = 1.8378770664093453

PW = 128  # panel width, as the TPU kernel's

# Upper end of the tier's routing window, kept equal to the JAX package's
# (blocked_nll.BLOCKED_PREFERRED_N) so that the router names the same tiers.
BLOCKED_PREFERRED_N = 1024

LAUNCHES = {"blocked_panel": 0}


def blocked_nll_preferred(n: int) -> bool:
    return n + ((-n) % 128) <= BLOCKED_PREFERRED_N


# -- the panel factor: plain version and kernel wrapper ---------------------

def factor_panel_plain(panel, out=None):
    """panel (B, nt, pw), pw = min(128, nt), the diagonal block on top →
    (L panel (B, nt, pw) with zeros above the diagonal, Σ log diag L11 (B,)).
    With `out` (a (B, nt, pw) view, e.g. of the whole factor) the L panel is
    written there and `out` is returned."""
    pw = panel.shape[2]
    L11 = linalg.cholesky(panel[:, :pw, :])
    L21 = torch.linalg.solve_triangular(L11.transpose(-1, -2), panel[:, pw:, :],
                                        upper=True, left=False)
    logdet = torch.sum(torch.log(torch.diagonal(L11, dim1=-2, dim2=-1)), dim=-1)
    Lp = torch.cat([L11, L21], dim=1)
    if out is None:
        return Lp, logdet
    out.copy_(Lp)
    return out, logdet


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from portfoliooptgp_tpu_torch.ops import cuda_build

        lib = cuda_build.load("blocked_panel")
        lib.blocked_panel_launch.restype = ctypes.c_int
        lib.blocked_panel_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.blocked_panel_ctas_per_sm.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def factor_panel_cuda(panel, out=None):
    """Launch the CUDA panel kernel; same contract as the plain version.
    The panel may be a strided view (unit column stride) of the trailing
    matrix: the kernel reads it in place. `out`, if given, is a float32
    (B, nt, pw) view with unit column stride that does not overlap the
    panel: the kernel writes the L panel straight into it."""
    if panel.device.type != "cuda" or panel.dtype != torch.float32:
        raise TypeError("the panel kernel takes a float32 CUDA tensor, got "
                        f"{panel.dtype} on {panel.device}")
    if panel.ndim != 3 or panel.shape[2] != min(PW, panel.shape[1]):
        raise ValueError(f"panel shape {tuple(panel.shape)} is not (B, nt, min(128, nt))")
    if panel.stride(2) != 1:
        panel = panel.contiguous()
    B, nt, pw = panel.shape
    if out is None:
        out = torch.empty((B, nt, pw), dtype=torch.float32, device=panel.device)
    elif (out.shape != panel.shape or out.dtype != torch.float32
          or out.device != panel.device or out.stride(2) != 1):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on {out.device} with strides "
                         f"{out.stride()} is not a float32 (B, nt, pw) view of unit column "
                         "stride beside the panel")
    logdet = torch.empty((B,), dtype=torch.float32, device=panel.device)
    with torch.cuda.device(panel.device):
        stream = torch.cuda.current_stream(panel.device).cuda_stream
        rc = _lib().blocked_panel_launch(
            ctypes.c_void_p(panel.data_ptr()), panel.stride(0), panel.stride(1),
            ctypes.c_void_p(out.data_ptr()), out.stride(0), out.stride(1),
            ctypes.c_void_p(logdet.data_ptr()), B, nt, pw, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"blocked_panel kernel launch failed: CUDA error {rc}")
    LAUNCHES["blocked_panel"] += 1
    return out, logdet


def factor_panel(panel, out=None):
    """The kernel's wrapper: CUDA tensors launch the kernel, CPU tensors
    take the plain version."""
    if panel.device.type == "cuda":
        return factor_panel_cuda(panel, out)
    if panel.device.type == "cpu":
        return factor_panel_plain(panel, out)
    raise ValueError(f"unsupported device {panel.device}")


# -- the blocked factor, the NLL and its VJP --------------------------------

def blocked_cholesky(Ks):
    """Lower Cholesky factor of (B, N, N) SPD matrices by 128-column panels
    (the panel factor, written straight into L, then a full-fp32 trailing
    matmul) and Σ log diag L."""
    B, N, _ = Ks.shape
    L = torch.zeros_like(Ks)
    logdet = torch.zeros((B,), dtype=Ks.dtype, device=Ks.device)
    work = Ks  # trailing submatrix, shrinks by PW rows and columns per panel
    for p0 in range(0, N, PW):
        nt = N - p0
        pw = min(PW, nt)
        Lp, ld = factor_panel(work[:, :, :pw], out=L[:, p0:, p0:p0 + pw])
        logdet = logdet + ld
        if nt > pw:
            L21 = Lp[:, pw:, :]
            work = work[:, pw:, pw:] - L21 @ L21.transpose(-1, -2)
    return L, logdet


def _factor_solve(K, y, noise):
    N = K.shape[1]
    L, logdet = blocked_cholesky(linalg.add_diag(K, noise))
    a = linalg.solve_lower(L, y[..., None])[..., 0]
    nll = 0.5 * torch.sum(a * a, dim=-1) + logdet + 0.5 * N * LOG2PI
    return nll, L, a


def _grads_from_inverse(W, a, g):
    """The closed-form VJP of both tiers from W = L⁻¹ and a = W y:
    ∂/∂K = ½(Ks⁻¹ − ααᵀ), ∂/∂y = α, ∂/∂σ² = ½ tr Ks⁻¹ − ½‖α‖², with
    Ks⁻¹ = WᵀW and α = Wᵀa."""
    Wt = W.transpose(-1, -2)
    Kinv = Wt @ W
    alpha = (Wt @ a[..., None])[..., 0]
    dK = 0.5 * (Kinv - alpha[:, :, None] * alpha[:, None, :])
    dnoise = 0.5 * (torch.diagonal(Kinv, dim1=-2, dim2=-1).sum(-1)
                    - torch.sum(alpha * alpha, dim=-1))
    return g[:, None, None] * dK, g[:, None] * alpha, g * dnoise


class _BlockedNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, y, noise):
        nll, L, a = _factor_solve(K, y, noise)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(L, a)
        return nll

    @staticmethod
    def backward(ctx, g):
        # _bwd: W = L⁻¹ from a triangular solve against I
        L, a = ctx.saved_tensors
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
        return _grads_from_inverse(linalg.solve_lower(L, eye), a, g)


def batched_nll_blocked(K, y, noise):
    """Differentiable (B,) NLLs of K (B, N, N), y (B, N), noise (B,):
    ½‖L⁻¹y‖² + Σ log diag L + ½ N log 2π with L L ᵀ = K + σ²I. The
    contract of the JAX package's `batched_nll_blocked`."""
    return _BlockedNLL.apply(K, y, noise)


# -- the blocked_hinv tier ----------------------------------------------------

# Routing window of the tier, kept equal to the JAX package's
# (blocked_nll.HINV_MAX_N, HINV_MAX_ELEMS) so that the router names the same
# tiers: padded N up to 4096 and B·Np² up to 6·10⁸ elements.
HINV_MAX_N = 4096
HINV_MAX_ELEMS = 600_000_000


def hinv_nll_preferred(n: int, b: int = 1) -> bool:
    np_ = n + ((-n) % 128)
    return BLOCKED_PREFERRED_N < np_ <= HINV_MAX_N and b * np_ * np_ <= HINV_MAX_ELEMS


def _diag_blocks_below(L, w, nb2):
    """(B, nb2, w, w): block (2k+1, 2k) of L in w×w blocks, for each pair k."""
    return torch.stack([L[:, (2 * k + 1) * w:(2 * k + 2) * w, 2 * k * w:(2 * k + 1) * w]
                        for k in range(nb2)], dim=1)


def _join_levels(L, cur):
    """L⁻¹ (B, Np, Np) from the inverses `cur` (B, P, 128, 128) of its P
    diagonal blocks, P a power of two: log₂P levels, each joining every
    pair of neighbouring blocks at once."""
    B = L.shape[0]
    w = PW
    while cur.shape[1] > 1:
        nb2 = cur.shape[1] // 2
        WA, WC = cur[:, 0::2], cur[:, 1::2]
        W21 = -(WC @ (_diag_blocks_below(L, w, nb2) @ WA))
        zero = torch.zeros((B, nb2, w, w), dtype=L.dtype, device=L.device)
        cur = torch.cat([torch.cat([WA, zero], dim=-1), torch.cat([W21, WC], dim=-1)],
                        dim=-2)
        w *= 2
    return cur[:, 0]


def _join_uneven(L, cur):
    """L⁻¹ for any panel count P: the largest power-of-two prefix of panels
    by `_join_levels`, the rest recursively, joined by one more level."""
    B, Np, _ = L.shape
    P = cur.shape[1]
    if P & (P - 1) == 0:
        return _join_levels(L, cur)
    P1 = 1 << (P.bit_length() - 1)
    n1 = P1 * PW
    WA = _join_levels(L[:, :n1, :n1], cur[:, :P1])
    WD = _join_uneven(L[:, n1:, n1:], cur[:, P1:])
    W21 = -(WD @ (L[:, n1:, :n1] @ WA))
    top = torch.cat([WA, torch.zeros((B, n1, Np - n1), dtype=L.dtype, device=L.device)],
                    dim=2)
    return torch.cat([top, torch.cat([W21, WD], dim=2)], dim=1)


def blocked_triangular_inverse(L):
    """W = L⁻¹ for (B, Np, Np) lower factors, Np a multiple of 128: the
    diagonal blocks by `ops/nll.triangular_inverse` (one launch), then the
    pairwise levels. As in the JAX package, a panel count that is not a
    power of two is padded up to one with identity blocks."""
    B, Np, _ = L.shape
    P = Np // PW
    P2 = 1 << (P - 1).bit_length()
    if P2 != P:
        pad = (P2 - P) * PW
        L = torch.nn.functional.pad(L, (0, pad, 0, pad))
        L.diagonal(dim1=-2, dim2=-1)[:, Np:] = 1.0
    return _join_levels(L, nll_mod.triangular_inverse(L))[:, :Np, :Np]


def triangular_inverse_uneven(L):
    """W = L⁻¹ for (B, Np, Np) lower factors with Np any multiple of 128,
    at its true size: every diagonal block of every factor inverted in one
    launch, then the prefix split of the JAX package (11 panels run as
    8 + (2 + 1))."""
    return _join_uneven(L, nll_mod.triangular_inverse(L))


def _hinv_factor(K, y, noise):
    B, N, _ = K.shape
    Ks = linalg.add_diag(K, noise)
    pad = (-N) % PW
    if pad:
        Ks = torch.nn.functional.pad(Ks, (0, pad, 0, pad))
        Ks.diagonal(dim1=-2, dim2=-1)[:, N:] = 1.0
    L = linalg.cholesky(Ks)
    W = triangular_inverse_uneven(L)[:, :N, :N]
    a = (W @ y[..., None])[..., 0]
    logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)[:, :N]), dim=-1)
    return 0.5 * torch.sum(a * a, dim=-1) + logdet + 0.5 * N * LOG2PI, W, a


class _HinvNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, y, noise):
        value, W, a = _hinv_factor(K, y, noise)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(W, a)
        return value

    @staticmethod
    def backward(ctx, g):
        W, a = ctx.saved_tensors
        return _grads_from_inverse(W, a, g)


def batched_nll_hinv(K, y, noise):
    """Differentiable (B,) NLLs of K (B, N, N), y (B, N), noise (B,) for
    the large-N window: the contract of the JAX package's
    `batched_nll_hinv`."""
    return _HinvNLL.apply(K, y, noise)
