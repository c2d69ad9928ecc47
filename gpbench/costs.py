"""The yardstick's arithmetic: peaks of one H100 and the least work of a
fused stationary NLL evaluation, counted from its shape.

`nll_bound_ms` and `panel_bound_ms` are frozen copies of the program's
kernel bounds (`chip_smoke.nll_bound_ms`, `panel_bound_ms`): inputs read
once and outputs written once, against the data-sheet peaks. `nll_flops`
counts the operations one evaluation of the fused NLL needs, with or
without the gradient, for `step_mfu_pct.*`.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores (the program runs
# float32 with TF32 off) and HBM3 bandwidth, at the full 700 W.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _build_flops(N, J, JD):
    """The lower triangle of K from the shared distance matrices: a scale
    and a sum per distance matrix and atom, φ and the combine per atom."""
    return N * (N + 1) / 2 * (2 * JD + 2 * J)


def nll_bound_ms(B, N, J, JD, masked, with_inverse):
    """Least time for the fused NLL on an H100: the larger of the bytes it
    must move (inputs read once, outputs written once) over HBM bandwidth
    and its fp32 operations over the fp32 peak. Only the lower triangle of
    each shared d2 matrix is read, N(N+1)/2 entries. Operations per model:
    factor N³/3, inverse N³/3 (when W is formed), the forward solve N²,
    ‖a‖² 2N, and the build of the lower triangle, N(N+1)/2 × (2·JD + 2·J).
    Returns (ms, "operations" or "bytes", whichever bounds it)."""
    flops = B * (N ** 3 / 3 + (N ** 3 / 3 if with_inverse else 0) + N * N + 2 * N
                 + _build_flops(N, J, JD))
    nbytes = 4 * (JD * N * (N + 1) / 2 + B * N * (2 if masked else 1) + B * (2 * J + JD + 1)
                  + B + B * N + (B * N * N if with_inverse else 0))
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def panel_bound_ms(nt, B=1):
    """Least time for one panel factor of the blocked tier on an H100: the
    larger of its bytes over HBM bandwidth and its fp32 operations (pw³/3
    for the diagonal block, pw² (nt − pw) for the row solve, pw =
    min(128, nt)) over the fp32 peak. The bytes are the lower triangle of
    A11 and the rows of A21 read once, and the same entries of L written
    once."""
    pw = min(128, nt)
    nbytes = B * 2 * 4 * (pw * (pw + 1) // 2 + pw * (nt - pw))
    flops = B * (pw ** 3 / 3 + pw * pw * (nt - pw))
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nll_flops(B, N, J, JD, with_gradient):
    """Operations that one evaluation of B fused NLLs needs. Value: the
    build of K, the factor N³/3, the forward solve N², ‖a‖² and log det
    3N. With the gradient, besides: the inverse W = L⁻¹, N³/3; the
    closed-form backward's K⁻¹ = WᵀW, N³/3 (a triangular product), α = Wᵀa,
    N², the cotangent ½(K⁻¹ − ααᵀ), 2N²; and one contraction of it with
    ∂K/∂θ, 2N², per variance and distance scale (J + JD); the noise's is
    its trace, N."""
    value = N ** 3 / 3 + N * N + 3 * N + _build_flops(N, J, JD)
    grad = 2 * N ** 3 / 3 + 3 * N * N + 2 * N * N * (J + JD) + N
    return B * (value + (grad if with_gradient else 0))
