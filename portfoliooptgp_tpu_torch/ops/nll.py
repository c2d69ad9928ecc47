"""Triangular inverse of 128×128 diagonal blocks, and the dense tier's window.

Port of portfoliooptgp_tpu/ops/pallas/nll.py, the part the ported tiers
use: `triangular_inverse` inverts every 128×128 diagonal block of a batch
of lower-triangular factors, the first stage of the `blocked_hinv` tier's
hierarchical inverse (ops/blocked_nll.triangular_inverse_uneven). On CUDA
tensors it launches the hand-written kernel `csrc/trinv.cu` (the TPU
kernel `_trinv_kernel`), all B·P blocks in one launch; on CPU tensors it
runs `triangular_inverse_plain`, the same forward substitution in torch. A
CUDA tensor never takes the plain version.

The dense tier's fused factor kernels (`_nll_kernel`, `_nll_inv_kernel`)
are not ported: `batched_nll` raises. `pallas_nll_supported` keeps the
JAX package's routing window so that the routers name the same tiers.

`LAUNCHES["triangular_inverse"]` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

PW = 128  # block width, as the TPU kernel's

# Upper end of the dense tier's window (portfoliooptgp_tpu/ops/pallas/nll.py:188).
MAX_PALLAS_N = 256

LAUNCHES = {"triangular_inverse": 0}


def pallas_nll_supported(n: int) -> bool:
    return n + ((-n) % 128) <= MAX_PALLAS_N


def batched_nll(K, y, noise):
    raise NotImplementedError(
        "the dense NLL tier's kernels (nll._nll_kernel / _nll_inv_kernel) are not "
        "ported yet: ROADMAP.md queue 2, items 1-2")


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
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _LIB = lib
    return _LIB


def triangular_inverse_cuda(L):
    """Launch the CUDA kernel; same contract as the plain version. L may be
    a strided view with unit column stride: the kernel reads it in place."""
    if L.device.type != "cuda" or L.dtype != torch.float32:
        raise TypeError("the triangular-inverse kernel takes a float32 CUDA tensor, got "
                        f"{L.dtype} on {L.device}")
    _check(L)
    if L.stride(2) != 1:
        L = L.contiguous()
    B, Np, _ = L.shape
    P = Np // PW
    W = torch.empty((B, P, PW, PW), dtype=torch.float32, device=L.device)
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        rc = _lib().trinv_launch(ctypes.c_void_p(L.data_ptr()), L.stride(0), L.stride(1),
                                 ctypes.c_void_p(W.data_ptr()), B, P,
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
