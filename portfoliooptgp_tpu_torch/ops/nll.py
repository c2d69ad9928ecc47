"""The dense NLL tier, and the triangular inverse of 128×128 diagonal blocks.

Port of portfoliooptgp_tpu/ops/pallas/nll.py.

The dense tier (the router's `pallas_dense`, padded N ≤ 256): `batched_nll`
factors a prebuilt K + σ²I of B models, solves against the targets and
takes Σ log diag L. On CUDA tensors the forward is the hand-written kernel
`csrc/dense_nll.cu` — the TPU kernel `_nll_kernel` when no input needs a
gradient (the line-search trials), `_nll_inv_kernel`, which also forms
W = L⁻¹, when one does (32-column sub-panels, W formed once after the
factor); on CPU tensors it is `factor_solve_plain` /
`factor_solve_inv_plain`, the column loop in torch. The backward is
the closed form of `_batched_nll_bwd` in full-fp32 torch.matmul (the JAX
package leaves it to XLA):

    Ks⁻¹ = WᵀW,  α = Wᵀa,  ∂K = ½(Ks⁻¹ − ααᵀ),  ∂y = α,
    ∂σ² = ½(tr Ks⁻¹ − ‖α‖²).

Nothing is padded (the TPU pads N to 128 with an identity tail and B to 8,
which changes no result); the 2π constant is the real N's. An indefinite
pivot gives NaN. `batched_nll_pallas` is the value-only entry of the same
name.

`triangular_inverse` inverts every 128×128 diagonal block of a batch of
lower-triangular factors, the first stage of the `blocked_hinv` tier's
hierarchical inverse (ops/blocked_nll.triangular_inverse_uneven). On CUDA
tensors it launches `csrc/trinv.cu` (the TPU kernel `_trinv_kernel`), all
B·P blocks in one launch; on CPU tensors it runs
`triangular_inverse_plain`.

A CUDA tensor never takes a plain version. `LAUNCHES` counts kernel
launches: "dense_nll" (value only), "dense_nll_inv" (with W) and
"triangular_inverse".
"""

from __future__ import annotations

import ctypes

import torch

LOG2PI = 1.8378770664093453

PW = 128  # block width, as the TPU kernel's

# Upper end of the dense tier's window (portfoliooptgp_tpu/ops/pallas/nll.py:188).
MAX_PALLAS_N = 256

LAUNCHES = {"dense_nll": 0, "dense_nll_inv": 0, "triangular_inverse": 0}


def pallas_nll_supported(n: int) -> bool:
    return n + ((-n) % 128) <= MAX_PALLAS_N


# -- the dense tier ---------------------------------------------------------

def _check_dense(K, y, noise, window=True):
    """Operand shapes, and with `window` the dense tier's N ≤ MAX_PALLAS_N
    (the plain column loop takes any N)."""
    if K.ndim != 3 or K.shape[1] != K.shape[2] or y.shape != K.shape[:2] \
            or noise.shape != K.shape[:1]:
        raise ValueError(f"dense NLL operands K {tuple(K.shape)}, y {tuple(y.shape)}, "
                         f"noise {tuple(noise.shape)} are not (B, N, N), (B, N), (B,)")
    if window and K.shape[1] > MAX_PALLAS_N:
        raise ValueError(f"the dense NLL takes N ≤ {MAX_PALLAS_N}, got {K.shape[1]}")


def _factor_solve_loop(K, y, noise, with_inverse):
    """The column loop in torch: (a, Σ log diag L, W or None), at any N."""
    _check_dense(K, y, noise, window=False)
    B, N, _ = K.shape
    A = torch.tril(K) + torch.diag_embed(noise[:, None].expand(B, N))
    a = y.clone()
    logdet = torch.zeros_like(noise)
    W = torch.eye(N, dtype=K.dtype, device=K.device).expand(B, N, N).clone() \
        if with_inverse else None
    for k in range(N):
        d = torch.sqrt(A[:, k, k])
        ak = a[:, k] / d
        col = A[:, k + 1:, k] / d[:, None]
        a[:, k + 1:] -= col * ak[:, None]
        a[:, k] = ak
        logdet = logdet + torch.log(d)
        if with_inverse:
            W[:, k, :k + 1] /= d[:, None]
            W[:, k + 1:, :k + 1] -= col[:, :, None] * W[:, k, None, :k + 1]
        A[:, k + 1:, k + 1:] -= col[:, :, None] * col[:, None, :]
    return a, logdet, W


def factor_solve_plain(K, y, noise):
    """K (B, N, N), y (B, N), noise (B,) → (a = L⁻¹y (B, N), Σ log diag L
    (B,)) with L L^T = K + σ²I, column by column.
    Only the lower triangle of K is read; an indefinite pivot gives NaN."""
    a, logdet, _ = _factor_solve_loop(K, y, noise, False)
    return a, logdet


def factor_solve_inv_plain(K, y, noise):
    """`factor_solve_plain` plus W = L⁻¹ (B, N, N), formed in the same
    column loop: (a, Σ log diag L, W)."""
    return _factor_solve_loop(K, y, noise, True)


_DENSE_LIB = None


def _dense_lib():
    global _DENSE_LIB
    if _DENSE_LIB is None:
        from portfoliooptgp_tpu_torch.ops import cuda_build

        lib = cuda_build.load("dense_nll")
        lib.dense_nll_launch.restype = ctypes.c_int
        lib.dense_nll_launch.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.dense_nll_ctas_per_sm.restype = ctypes.c_int
        lib.dense_nll_ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
        _DENSE_LIB = lib
    return _DENSE_LIB


def factor_solve_cuda(K, y, noise, with_inverse):
    """Launch the CUDA kernel: (nll (B,), a (B, N), Σ log diag L (B,),
    W (B, N, N) or None). K is read in place through its strides."""
    for t in (K, y, noise):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError("the dense NLL kernel takes float32 CUDA tensors, got "
                            f"{t.dtype} on {t.device}")
    _check_dense(K, y, noise)
    y, noise = y.contiguous(), noise.contiguous()
    B, N, _ = K.shape
    opts = dict(dtype=torch.float32, device=K.device)
    nll = torch.empty((B,), **opts)
    logdet = torch.empty((B,), **opts)
    a = torch.empty((B, N), **opts)
    W = torch.empty((B, N, N), **opts) if with_inverse else None
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        rc = _dense_lib().dense_nll_launch(
            ctypes.c_void_p(K.data_ptr()), K.stride(0), K.stride(1), K.stride(2),
            ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(noise.data_ptr()),
            ctypes.c_void_p(nll.data_ptr()), ctypes.c_void_p(logdet.data_ptr()),
            ctypes.c_void_p(a.data_ptr()),
            ctypes.c_void_p(0 if W is None else W.data_ptr()), B, N,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"dense_nll kernel launch failed: CUDA error {rc}")
    LAUNCHES["dense_nll_inv" if with_inverse else "dense_nll"] += 1
    return nll, a, logdet, W


def factor_solve(K, y, noise, with_inverse):
    """The kernel's wrapper: (nll (B,), a, Σ log diag L, W or None). CUDA
    tensors launch the kernel, CPU tensors take the plain version."""
    if K.device.type == "cuda":
        return factor_solve_cuda(K, y, noise, with_inverse)
    if K.device.type == "cpu":
        _check_dense(K, y, noise)
        a, logdet, W = _factor_solve_loop(K, y, noise, with_inverse)
        nll = 0.5 * torch.sum(a * a, dim=-1) + logdet + 0.5 * K.shape[1] * LOG2PI
        return nll, a, logdet, W
    raise ValueError(f"unsupported device {K.device}")


class _DenseNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, y, noise):
        with_inverse = any(ctx.needs_input_grad)
        nll, a, _, W = factor_solve(K, y, noise, with_inverse)
        if with_inverse:
            ctx.save_for_backward(W, a)
        return nll

    @staticmethod
    def backward(ctx, g):
        W, a = ctx.saved_tensors
        Wt = W.transpose(-1, -2)
        Kinv = Wt @ W
        alpha = (Wt @ a[..., None])[..., 0]
        dK = 0.5 * (Kinv - alpha[:, :, None] * alpha[:, None, :])
        dnoise = 0.5 * (torch.diagonal(Kinv, dim1=-2, dim2=-1).sum(-1)
                        - torch.sum(alpha * alpha, dim=-1))
        return g[:, None, None] * dK, g[:, None] * alpha, g * dnoise


def batched_nll(K, y, noise):
    """Differentiable NLL of B GPR models: K (B, N, N) kernel matrices
    (lower triangle read), y (B, N) targets, noise (B,) variances added to
    the diagonal; N ≤ 256. Returns (B,) NLLs with the 2π constant at N."""
    return _DenseNLL.apply(K, y, noise)


def batched_nll_pallas(K, y, noise):
    """Value-only NLL of B models (no gradient; never forms W)."""
    with torch.no_grad():
        return factor_solve(K, y, noise, False)[0]


# -- the triangular inverse of the blocked_hinv tier ------------------------


def _check(L):
    if L.ndim != 3 or L.shape[1] != L.shape[2] or L.shape[1] % PW:
        raise ValueError(f"L shape {tuple(L.shape)} is not (B, Np, Np) with Np a "
                         f"multiple of {PW}")


def triangular_inverse_plain(L):
    """L (B, Np, Np) lower-triangular, Np = 128·P → (B, P, 128, 128): the
    inverse of each diagonal block, zeros above its diagonal. Only the lower
    triangle of each block is read. Forward substitution against I, row by
    row as the kernel runs it; nothing is clamped, so NaN in L stays NaN."""
    _check(L)
    B, Np, _ = L.shape
    P = Np // PW
    A = torch.tril(torch.stack([L[:, p * PW:(p + 1) * PW, p * PW:(p + 1) * PW]
                                for p in range(P)], dim=1))
    W = torch.eye(PW, dtype=L.dtype, device=L.device).expand(B, P, PW, PW).clone()
    for i in range(PW):
        w = W[:, :, i, :i + 1] / A[:, :, i, i, None]
        W[:, :, i, :i + 1] = w
        W[:, :, i + 1:, :i + 1] -= A[:, :, i + 1:, i, None] * w[:, :, None, :]
    return W


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from portfoliooptgp_tpu_torch.ops import cuda_build

        lib = cuda_build.load("trinv")
        lib.trinv_launch.restype = ctypes.c_int
        lib.trinv_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.trinv_ctas_per_sm.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def triangular_inverse_cuda(L):
    """Launch the CUDA kernel; same contract as the plain version. L may be
    any strided view (the column-major factors of torch.linalg.cholesky
    included): the kernel reads it in place."""
    if L.device.type != "cuda" or L.dtype != torch.float32:
        raise TypeError("the triangular-inverse kernel takes a float32 CUDA tensor, got "
                        f"{L.dtype} on {L.device}")
    _check(L)
    B, Np, _ = L.shape
    P = Np // PW
    W = torch.empty((B, P, PW, PW), dtype=torch.float32, device=L.device)
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        rc = _lib().trinv_launch(ctypes.c_void_p(L.data_ptr()), L.stride(0), L.stride(1),
                                 L.stride(2), ctypes.c_void_p(W.data_ptr()), B, P,
                                 ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"triangular_inverse kernel launch failed: CUDA error {rc}")
    LAUNCHES["triangular_inverse"] += 1
    return W


def triangular_inverse(L):
    """The kernel's wrapper: CUDA tensors launch the kernel, CPU tensors
    take the plain version."""
    if L.device.type == "cuda":
        return triangular_inverse_cuda(L)
    if L.device.type == "cpu":
        return triangular_inverse_plain(L)
    raise ValueError(f"unsupported device {L.device}")
