"""Where the time goes inside the panel-factor, triangular-inverse, dense NLL,
stationary NLL and SVGP gram kernels.

Builds a copy of `csrc/blocked_panel.cu`, `csrc/trinv.cu`,
`csrc/dense_nll.cu`, `csrc/stationary_nll.cu` and `csrc/svgp_gram.cu`, and
of the headers they include, with clock64() marks inserted at the
boundaries of their phases (the copies go to build/timeline/<source>/; the
sources are not touched), launches each at its main path's shape, and
prints, for CTA 0 (and for the stationary cluster kernel also the last CTA
of cluster 0, for the gram kernels the grid's last CTA), the SM cycles from
the CTA's start to each mark, per warp:

- panel (nt = 875, B = 1): `issued` (every cp.async of the staging issued),
  `staged` (the first sub-panel's columns landed), then for each sub-panel
  s `a<s>` (diagonal factor), `b<s>` (row solves) and `c<s>` (update), and
  `end`;
- trinv (220 blocks): `staged`, then for each row block R `R<R>` (its
  product done; the first row block of a warp has none) and `S<R>` (its
  solve done), and `end`;
- dense NLL at (20, 77) and (128, 256), value only and with W: `staged`,
  then for each sub-panel k the warp's own work of `a<k>` (diagonal
  factor: warp 0), `b<k>` (row solves) and `c<k>` (updates), each taken
  before the barrier that ends its phase, then for each row block J of W
  `W<J>` (the warp's columns computed), and `end`;
- the stationary NLL's tile kernel at the walk-forward's (5, 77), masked,
  Matern12 × Matern12, and the headline's (128, 256), SE, value only and
  with W: `built` (the warp's entries of K written), then `a<k>`, `b<k>`,
  `c<k>` and `W<J>` as in the dense kernel (the tile core, in
  csrc/nll_tile.cuh, is the same), and `end`;
- the stationary NLL's cluster kernel at frontier grid A's (20, 262), SE,
  and the NUTS posterior's (8, 512), ARD SE over D = 4, value only and with
  W: `built` (the warp's entries of K written), `go` (every rank's built:
  the first cluster barrier passed), then for each sub-panel k `a<k>` (the
  diagonal factor and its transpose written to every rank: the owner's
  warp 0), `s<k>` (the warp's row solves), `b<k>` (their rows written to
  every rank's panel through the cluster's shared memory), `c<k>` (the
  warp's trailing updates, local memory only), each taken before the
  barrier that ends its phase (so the gap to the next phase's first mark
  is the barrier's wait), then for each row block J of W `W<J>` (the row
  block's tiles copied from their owner and the warp's columns computed),
  and `end` (rank 0's NLL written).

- the SVGP gram kernels (`csrc/svgp_gram.cu`) at chip_smoke.GRAM_TIMED's
  (128, 2048, 1) and (128, 8192, 1), SE, CTA 0 (unit 0, rank 0: the
  forward's sq unit, the backward's first 16 rows) and the grid's last CTA
  (the forward's last diagonal block, the backward's last 16 rows), per
  pass p of STAGE columns: in the forward's sq unit `m<p>` (m = tᵀKuf of
  the pass), in its blocks `built<p>` (the pass's Kuf rows built, the
  barrier passed), then `products` (the warp's last product), `summed`
  (the CTA's partial in shared memory), `gathered` (its partial written
  and its ticket taken; in the unit's last CTA, the unit's partials summed
  too) and `end` (that CTA's block of G written); in the backward
  `built<p>`, `product<p>` (H·Kuf), `residual<p>` (w e), `W2<p>` (the
  epilogue's entries), then `summed`, `gathered`, `rows` (the unit's t̄
  and Z̄ written), `units` (its s̄ and v̄ handed to the second ticket) and
  `end` (the last unit's CTA: s̄ and v̄ written). Before the marks, one
  line a kernel says where every CTA ran and when: the SMs (%smid), the
  CTAs an SM held, and the spread of the CTAs' starts and their durations
  on the global timer (%globaltimer, ns), up to `gathered`.

Run on a machine with an NVIDIA GPU and nvcc, from the repository root:

    python tools/kernel_timeline.py [panel|trinv|dense|stationary|gram ...]

(all five by default).

The marks cost a few cycles each. A kernel edit that moves an anchor makes
the script stop with the anchor it did not find.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from portfoliooptgp_tpu_torch.ops import cuda_build  # noqa: E402
from portfoliooptgp_tpu_torch.ops import stationary_nll as st  # noqa: E402

SLOTS = 128  # marks per warp
MAX_CTAS = 4096  # CTAs whose SM and span the gram kernels record


def marks(cta):
    """The mark buffer and CLK(n), which records clock64() in lane 0 of each
    warp of two CTAs: the one whose id (`cta`, an expression) is 0 and the
    one whose id is g_last_cta."""
    return f'''
__device__ long long g_clk[2 * 32 * {SLOTS}];
__device__ int g_last_cta;  // the second CTA marked (0: CTA 0 alone)
#define CTA_ID ({cta})
#define CLK(n) if ((threadIdx.x & 31) == 0 && (CTA_ID == 0 || CTA_ID == g_last_cta)) \\
    g_clk[((CTA_ID != 0) * 32 + (threadIdx.x >> 5)) * {SLOTS} + (n)] = clock64();
extern "C" int read_clk(long long* host) {{
  return (int)cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk));
}}
extern "C" int clear_clk(int last_cta) {{
  static const long long zeros[2 * 32 * {SLOTS}] = {{}};
  int e = (int)cudaMemcpyToSymbol(g_clk, zeros, sizeof(g_clk));
  return e ? e : (int)cudaMemcpyToSymbol(g_last_cta, &last_cta, sizeof(int));
}}
'''


MARKS = marks("blockIdx.y == 0 ? (int)blockIdx.x : -1")  # CTAs of the first row of the grid
START = 63  # the mark taken as the CTA starts

# (anchor, text, after the anchor?) for each source
PANEL = [
    ('#include "hopper_async.cuh"\n', MARKS, True),
    ("  const int mrows = ncols + ((nrows + 3) & ~3);", "\n  CLK(63);", True),
    ("  cp_async_wait<1>();  // the first sub-panel's columns", "  CLK(61);\n", False),
    ("  float ld = 0.0f;  // Σ log diag L11, kept by warp 0\n", "  CLK(62);\n", True),
    ("    // (b) Rows below the diagonal block", "    CLK(3 * (c0 / SP));\n", False),
    ("    cp_async_wait<0>();  // the later columns, before the first update reads them\n"
     "    __syncthreads();\n", "    CLK(3 * (c0 / SP) + 1);\n", True),
    ("  }\n\n  // Write L21 (every CTA)", "    CLK(3 * (c0 / SP) + 2);\n", False),
    ("}\n\nstatic size_t smem_bytes", "  CLK(60);\n", False),
]
PANEL_LABELS = {61: "issued", 62: "staged", 60: "end",
                **{3 * s + k: f"{'abc'[k]}{s}" for s in range(4) for k in range(3)}}
TRINV = [
    ('#include "hopper_async.cuh"\n', MARKS, True),
    ("  const float* Lb = L + (size_t)b * sb + (size_t)p * PW * (sr + sc);\n", "  CLK(63);\n",
     True),
    ("  cp_async_wait<0>();\n  __syncthreads();\n", "  CLK(62);\n", True),
    ("      solve<false>(x, M, dg, dy, r0, j);", "      CLK(2 * R + 1);\n", False),
    ("    // Column j of the row block", "    CLK(2 * R + 2);\n", False),
    ("}\n\nstatic size_t smem_bytes", "  CLK(60);\n", False),
]
TRINV_LABELS = {62: "staged", 60: "end",
                **{2 * R + k + 1: f"{'RS'[k]}{R}" for R in range(4) for k in range(2)}}

DENSE = [
    ('#include "hopper_async.cuh"\n', MARKS, True),
    ("  const float* Kb = K + (size_t)b * sb;\n", "  CLK(63);\n", True),
    ("(a) and (b) of step 0\n  add_noise(tiles, nz, N, 0, 1);\n  __syncthreads();\n",
     "  CLK(62);\n", True),
    ("    if (warp == 0) factor_step(tiles, Lt(k), dg, yd, lt, k, N, ld);  // (a)\n",
     "    CLK(3 * k);\n", True),
    ("    if (k == 0) {  // the later tile columns", "    CLK(3 * k + 1);\n", False),
    ("    __syncthreads();\n  }\n\n  // W = L^{-1}", "    CLK(3 * k + 2);\n", False),
    ("    __syncthreads();  // every read of L's row block J is done",  # nll_tile.cuh
     "    CLK(24 + J);\n", False),
    ("}\n\ntemplate <bool WITH_W>\nstatic cudaError_t configure()", "  CLK(60);\n", False),
]
STATIONARY = [
    ('#include "nll_tile.cuh"\n', MARKS, False),  # CLK is defined before the header
    ("  float* prm = lt + MAX_TILE_N;", "\n  CLK(63);", True),
    ("  build_tiles(tiles, d2s, mk, prm, noise[b], N, 0, 1, T * (T + 1) / 2, atoms.J, "
     "atoms.combine);\n", "  CLK(62);\n", True),
    ("    if (warp == 0) factor_step(tiles, Lt(k), dg, yd, lt, k, N, ld);  // (a)\n",
     "    CLK(3 * k);\n", True),
    ("    __syncthreads();\n\n    // (c): two units", "    CLK(3 * k + 1);\n", False),
    ("    __syncthreads();\n  }\n\n  // W = L^{-1}", "    CLK(3 * k + 2);\n", False),
    ("    __syncthreads();  // every read of L's row block J is done",  # nll_tile.cuh
     "    CLK(24 + J);\n", False),
    ("}\n\ntemplate <bool WITH_W>\nstatic cudaError_t configure_tiles()", "  CLK(60);\n",
     False),
    # the cluster kernel
    ("  auto at = [&](float* p, int q) { return cluster.map_shared_rank(p, (unsigned)q); };\n",
     "  CLK(63);\n", True),
    ("  cluster.sync();  // every rank has started and built its tiles\n", "  CLK(62);\n", False),
    ("  cluster.sync();  // every rank has started and built its tiles\n", "  CLK(61);\n", True),
    ("      if (lane == 0) at(lds, 0)[k] = s;\n    }\n", "    CLK(64 + 4 * k);\n", True),
    ("      for (int q = 0; q < C; ++q) {\n        if (!e)", "      CLK(64 + 4 * k + 1);\n", False),
    ("    cluster.sync();\n\n    // (c): two units a pair", "    CLK(64 + 4 * k + 2);\n", False),
    ("    // the next diagonal tile's owner factors it", "    CLK(64 + 4 * k + 3);\n", False),
    ("      __syncthreads();  // the panel, ltc and part are read before the next row block's",
     "      CLK(J);\n", False),
    ("}\n\nstatic int smem_optin()", "  CLK(60);\n", False),
]

# The gram kernels' grids are (C ranks, U units): the second CTA marked is
# the grid's last (linear id g_last_cta), the last unit's last rank.
GRAM_MARKS = marks("(int)(blockIdx.y * gridDim.x + blockIdx.x)") + f'''
// Every CTA's SM and its start and end on the global timer (ns).
__device__ int g_sm[{MAX_CTAS}];
__device__ unsigned long long g_span[2 * {MAX_CTAS}];
__device__ __forceinline__ void cta_mark(int end) {{
  if (threadIdx.x != 0 || CTA_ID >= {MAX_CTAS}) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_span[2 * CTA_ID + end] = t;
  if (!end) {{
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_sm[CTA_ID] = (int)sm;
  }}
}}
extern "C" int read_spans(int* sm, unsigned long long* span) {{
  int e = (int)cudaMemcpyFromSymbol(sm, g_sm, sizeof(g_sm));
  return e ? e : (int)cudaMemcpyFromSymbol(span, g_span, sizeof(g_span));
}}
'''
GRAM = [
    ("#include <stddef.h>\n", GRAM_MARKS, True),
    # the forward
    ("  const float v = vp[0];\n", "  CLK(63);\n  cta_mark(0);\n", True),
    ("      part[h * STAGE + j] = p;\n", "      CLK(2 * ((c0 - b0) / STAGE) + 1);\n", True),
    ("    const bool last = gather(part, 1,", "    CLK(41);\n", False),
    ("    if (last && tid == 0) *sq = part[0];\n", "    CLK(42);\n    cta_mark(1);\n", False),
    ("#pragma unroll 4\n    for (int j = warp; j < nc; j += WARPS) {",
     "    CLK(2 * ((c0 - b0) / STAGE));\n", False),
    ("  __syncthreads();  // kI and kw become the warps' tiles", "  CLK(40);\n", False),
    ("  const bool last = gather(part, FWD_BLOCK * FWD_BLOCK,", "  CLK(41);\n", False),
    ("  if (!last) return;\n  for (int e = tid;", "  CLK(42);\n  cta_mark(1);\n", False),
    ("      G[(size_t)gk * M + gi] = part[e];\n    }\n  }\n", "  CLK(60);\n", True),
    # the backward
    ("  const float v = vp[0], sqbar = sqbarp[0];\n", "  CLK(63);\n  cta_mark(0);\n", True),
    ("      const float4* h4 = reinterpret_cast<const float4*>(hT);",
     "      CLK(4 * ((c0 - b0) / STAGE));\n", False),
    ("    __syncthreads();  // every product is done with Kc", "    CLK(4 * ((c0 - b0) / STAGE) + 1);\n",
     False),
    ("    // Kbar, phi and phi' at the thread's", "    CLK(4 * ((c0 - b0) / STAGE) + 2);\n", False),
    ("    // Z-bar and s-bar: warp w takes rows", "    CLK(4 * ((c0 - b0) / STAGE) + 3);\n", False),
    ("  const bool last = gather(part, NP,", "  CLK(41);\n", False),
    ("  if (!last) return;\n  for (int i = tid; i < BWD_ROWS + BWD_ROWS * Dk;",
     "  CLK(42);\n  cta_mark(1);\n", False),
    ("  const bool last_unit = gather(", "  CLK(43);\n", False),
    ("  if (!last_unit) return;\n", "  CLK(44);\n", False),
    ("    else *vbar = sv[i];\n  }\n", "  CLK(60);\n", True),
]
GRAM_FWD_LABELS = {40: "products", 41: "summed", 42: "gathered", 60: "end",
                   **{2 * p + i: f"{('built', 'm')[i]}{p}" for p in range(8) for i in range(2)}}
GRAM_BWD_LABELS = {41: "summed", 42: "gathered", 43: "rows", 44: "units", 60: "end",
                   **{4 * p + i: f"{('built', 'product', 'residual', 'W2')[i]}{p}"
                      for p in range(8) for i in range(4)}}

DENSE_LABELS = {62: "staged", 60: "end",
                **{3 * k + i: f"{'abc'[i]}{k}" for k in range(8) for i in range(3)},
                **{24 + J: f"W{J}" for J in range(8)}}
STATIONARY_LABELS = {**DENSE_LABELS, 62: "built"}
CLUSTER_LABELS = {63: "start", 62: "built", 61: "go", 60: "end",
                  **{64 + 4 * k + i: f"{'asbc'[i]}{k}" for k in range(16) for i in range(4)},
                  **{J: f"W{J}" for J in range(16)}}


def instrumented(name, edits):
    """Build source `name` with the marks: each edit goes into the source
    or, where the source does not hold its anchor, into the first header
    of its own that does."""
    src_dir = os.path.join(REPO, "build", "timeline", name)
    os.makedirs(src_dir, exist_ok=True)
    files = cuda_build._source_files(name)
    texts = {}
    for f in files:
        with open(os.path.join(cuda_build.CSRC, f)) as fh:
            texts[f] = fh.read()
    for anchor, text, after in edits:
        f = next((f for f in files if anchor in texts[f]), None)
        if f is None:
            raise SystemExit(f"{name}: anchor not found: {anchor!r}")
        texts[f] = texts[f].replace(anchor, anchor + text if after else text + anchor, 1)
    for f, text in texts.items():
        with open(os.path.join(src_dir, f), "w") as fh:
            fh.write(text)
    out = os.path.join(src_dir, f"lib{name}_timeline.so")
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out,
                    os.path.join(src_dir, files[0])], check=True)
    return ctypes.CDLL(out)


def show(lib, title, labels, nwarps, cta=0):
    """Print the marks of CTA 0 (cta 0) or of the second CTA marked (cta 1)."""
    buf = (ctypes.c_longlong * (2 * 32 * SLOTS))()
    torch.cuda.synchronize()
    if lib.read_clk(buf) != 0:
        raise SystemExit("reading the marks failed")
    print(title, flush=True)
    for w in range(nwarps):
        row = [buf[(cta * 32 + w) * SLOTS + n] for n in range(SLOTS)]
        marks = sorted((row[n] - row[START], labels[n]) for n in labels if row[n])
        print(f"  warp {w}: " + " ".join(f"{lab}={t}" for t, lab in marks), flush=True)


def show_spans(lib, title, n):
    """Where the gram kernel's n CTAs ran and when: SMs used, CTAs per SM,
    the spread of their starts and their durations on the global timer."""
    sm = (ctypes.c_int * MAX_CTAS)()
    span = (ctypes.c_ulonglong * (2 * MAX_CTAS))()
    torch.cuda.synchronize()
    if lib.read_spans(sm, span) != 0:
        raise SystemExit("reading the spans failed")
    sms = [sm[i] for i in range(n)]
    start = [span[2 * i] for i in range(n)]
    dur = sorted((span[2 * i + 1] - span[2 * i]) / 1e3 for i in range(n))
    per_sm = sorted({sms.count(x) for x in sms})
    first = min(start)
    late = sorted((s - first) / 1e3 for s in start)
    print(f"{title}: {n} CTAs on {len(set(sms))} SMs (CTAs an SM: {per_sm}); starts "
          f"spread over {late[-1]:.2f} us (median {late[n // 2]:.2f}); CTA durations "
          f"{dur[0]:.2f} / {dur[n // 2]:.2f} / {dur[-1]:.2f} us (min / median / max); "
          f"first start to last end {(max(span[2 * i + 1] for i in range(n)) - first) / 1e3:.2f}"
          " us", flush=True)


def timeline_panel(rng, stream):
    panel = instrumented("blocked_panel", PANEL)
    panel.blocked_panel_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    A = torch.randn(875, 875, device="cuda", generator=rng, dtype=torch.float64)
    Ks = (A @ A.T / 875 + 0.5 * torch.eye(875, device="cuda", dtype=torch.float64)).float()
    out = torch.empty(875, 128, device="cuda")
    ld = torch.empty(1, device="cuda")
    for _ in range(3):  # warm: the last launch is the one read
        rc = panel.blocked_panel_launch(Ks.data_ptr(), Ks.numel(), 875, out.data_ptr(),
                                        out.numel(), 128, ld.data_ptr(), 1, 875, 128, stream())
        if rc != 0:
            raise SystemExit(f"panel launch failed: CUDA error {rc}")
    show(panel, "panel nt=875 B=1, CTA 0, SM cycles from its start:", PANEL_LABELS, 8)


def timeline_trinv(rng, stream):
    trinv = instrumented("trinv", TRINV)
    trinv.trinv_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    A = torch.randn(20, 1408, 1408, device="cuda", generator=rng, dtype=torch.float64)
    L = torch.linalg.cholesky(A @ A.mT / 1408 + 0.5 * torch.eye(1408, device="cuda",
                                                                dtype=torch.float64)).float()
    W = torch.empty(20, 11, 128, 128, device="cuda")
    for _ in range(3):
        rc = trinv.trinv_launch(L.data_ptr(), L.stride(0), L.stride(1), L.stride(2),
                                W.data_ptr(), 20, 11, stream())
        if rc != 0:
            raise SystemExit(f"trinv launch failed: CUDA error {rc}")
    show(trinv, "trinv 220 blocks (column-major factors), CTA 0, SM cycles from its start:",
         TRINV_LABELS, 4)


def timeline_dense(rng, stream):
    dense = instrumented("dense_nll", DENSE)
    dense.dense_nll_launch.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    for B, N in ((20, 77), (128, 256)):
        A = torch.randn(B, N, N, device="cuda", generator=rng, dtype=torch.float64)
        K = (A @ A.mT / N + 0.5 * torch.eye(N, device="cuda", dtype=torch.float64)).float()
        y = torch.randn(B, N, device="cuda", generator=rng)
        noise = torch.full((B,), 0.1, device="cuda")
        outs = [torch.empty(B, device="cuda"), torch.empty(B, device="cuda"),
                torch.empty(B, N, device="cuda")]
        W = torch.empty(B, N, N, device="cuda")
        for with_w in (False, True):
            if dense.clear_clk(0) != 0:
                raise SystemExit("clearing the marks failed")
            for _ in range(3):
                rc = dense.dense_nll_launch(K.data_ptr(), K.stride(0), K.stride(1), K.stride(2),
                                            y.data_ptr(), noise.data_ptr(),
                                            *(t.data_ptr() for t in outs),
                                            W.data_ptr() if with_w else None, B, N, stream())
                if rc != 0:
                    raise SystemExit(f"dense launch failed: CUDA error {rc}")
            show(dense, f"dense NLL ({B}, {N}) {'with W' if with_w else 'value only'}, CTA 0, "
                 "SM cycles from its start:", DENSE_LABELS, 8)


def timeline_stationary(rng, stream):
    stationary = instrumented("stationary_nll", STATIONARY)
    stationary.stationary_nll_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    stationary.stationary_nll_cluster_shape.argtypes = [ctypes.c_int, ctypes.c_void_p]
    # (families, dims, B, N, masked): the tile kernel's two shapes, then the cluster kernel's
    for families, dims, B, N, masked in ((("matern12", "matern12"), (1, 1), 5, 77, True),
                                         (("se",), (1,), 128, 256, False),
                                         (("se",), (1,), 20, 262, False),
                                         (("se",), (4,), 8, 512, False)):
        J, JD = len(families), sum(dims)
        x = torch.sort(30 * torch.rand(N, device="cuda", generator=rng)).values
        d2s = ((x[:, None] - x[None, :]) ** 2).expand(JD, N, N).contiguous()
        keep = N - torch.arange(B, device="cuda") * N // (4 * B)
        mask = (torch.arange(N, device="cuda")[None, :] < keep[:, None]).float()
        err = torch.randn(B, N, device="cuda", generator=rng) * mask
        vs, ss, als = torch.ones(J, B, device="cuda"), torch.full((JD, B), 0.04 / JD,
                                                                  device="cuda"), \
            torch.ones(J, B, device="cuda")
        noise = torch.full((B,), 0.1, device="cuda")
        nll_out, a = torch.empty(B, device="cuda"), torch.empty(B, N, device="cuda")
        W = torch.empty(B, N, N, device="cuda")
        codes = (ctypes.c_int * J)(*[st.GENERAL_FAMILIES.index(f) for f in families])
        dim = (ctypes.c_int * J)(*dims)
        cluster = N > st.MAX_TILE_N
        C = 1
        if cluster:
            shape = (ctypes.c_int * 4)()
            if stationary.stationary_nll_cluster_shape(N, shape) != 0:
                raise SystemExit("stationary_nll_cluster_shape failed")
            C = shape[0]
        for with_w in (False, True):
            if stationary.clear_clk(C - 1) != 0:
                raise SystemExit("clearing the marks failed")
            for _ in range(3):
                rc = stationary.stationary_nll_launch(
                    d2s.data_ptr(), err.data_ptr(), mask.data_ptr() if masked else None,
                    vs.data_ptr(), ss.data_ptr(), als.data_ptr(), noise.data_ptr(),
                    nll_out.data_ptr(), a.data_ptr(), W.data_ptr() if with_w else None,
                    B, N, J, codes, dim, 1, stream())
                if rc != 0:
                    raise SystemExit(f"stationary launch failed: CUDA error {rc}")
            what = (f"({B}, {N}) {'*'.join(families)}{f' dims {dims}' if JD > J else ''}"
                    f"{' masked' if masked else ''} {'with W' if with_w else 'value only'}")
            if not cluster:
                show(stationary, f"stationary NLL tile kernel {what}, CTA 0, SM cycles from its "
                     "start:", STATIONARY_LABELS, 8)
                continue
            for cta, name in ((0, "CTA 0 (rank 0)"), (1, f"CTA {C - 1} (rank {C - 1})")):
                show(stationary, f"stationary NLL cluster kernel {what}, C = {C}, {name} of "
                     "cluster 0, SM cycles from its start:", CLUSTER_LABELS, 8, cta)


def timeline_gram(rng, stream):
    gram = instrumented("svgp_gram", GRAM)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    gram.svgp_gram_fwd_launch.argtypes = [ptr] * 7 + [i32] + [ptr] * 4 + [i32] * 7 + [ptr]
    gram.svgp_gram_bwd_launch.argtypes = [ptr] * 7 + [i32] + [ptr] * 9 + [i32] * 8 + [ptr]
    import chip_smoke as cs
    from portfoliooptgp_tpu_torch.ops import svgp_gram as sg

    for M, B, D in cs.GRAM_TIMED:
        Z, X, y, w, t, v, s, Gbar, sqbar = cs.gram_operands(M, B, D, seed=77)
        ops = [a.data_ptr() for a in (Z, X, y, w, t, v, s)]
        fwd, bwd = sg.launch_shape(M, B, D)
        G, sq = torch.empty(M, M, device="cuda"), torch.empty((), device="cuda")
        fwd_scratch = torch.empty(fwd.units * fwd.ranks * sg.FWD_BLOCK ** 2, device="cuda")
        parts = sg.BWD_ROWS * (D + 1) + D + 1
        outs = [torch.empty(n, device="cuda") for n in (
            M * D, B, M, 1, D, bwd.units * (D + 1) + bwd.units * bwd.ranks * parts)]
        tickets = torch.zeros(max(fwd.units, bwd.units + 1), dtype=torch.int32, device="cuda")
        for name, launch, labels in (("forward", fwd, GRAM_FWD_LABELS),
                                     ("backward", bwd, GRAM_BWD_LABELS)):
            if gram.clear_clk(launch.units * launch.ranks - 1) != 0:
                raise SystemExit("clearing the marks failed")
            for _ in range(3):
                if launch is fwd:
                    rc = gram.svgp_gram_fwd_launch(
                        *ops, s.numel(), G.data_ptr(), sq.data_ptr(), fwd_scratch.data_ptr(),
                        tickets.data_ptr(), M, B, D, 0, fwd.ranks, fwd.chunk, fwd.smem, stream())
                else:
                    rc = gram.svgp_gram_bwd_launch(
                        *ops, s.numel(), Gbar.data_ptr(), sqbar.data_ptr(),
                        *(o.data_ptr() for o in outs), tickets.data_ptr(), M, B, D, 0,
                        bwd.ranks, bwd.chunk, bwd.kc, bwd.smem, stream())
                if rc != 0:
                    raise SystemExit(f"gram {name} launch failed: CUDA error {rc}")
            last = launch.units * launch.ranks - 1
            show_spans(gram, f"gram {name} ({M}, {B}, {D})", last + 1)
            for cta, which in ((0, "CTA 0 (unit 0, rank 0)"),
                               (1, f"CTA {last} (unit {launch.units - 1}, rank "
                                   f"{launch.ranks - 1})")):
                show(gram, f"gram {name} ({M}, {B}, {D}) SE, {launch.units} units × C = "
                     f"{launch.ranks}, {which}, SM cycles from its start:", labels, 8, cta)


TIMELINES = {"panel": timeline_panel, "trinv": timeline_trinv, "dense": timeline_dense,
             "stationary": timeline_stationary, "gram": timeline_gram}


def main(argv) -> int:
    names = argv or list(TIMELINES)
    if not set(names) <= set(TIMELINES):
        print(f"kernel_timeline: kernels are {', '.join(TIMELINES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_timeline: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rng = torch.Generator(device="cuda").manual_seed(0)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    for name in names:
        TIMELINES[name](rng, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
