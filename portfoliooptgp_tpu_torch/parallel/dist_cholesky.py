"""Distributed blocked Cholesky + NLL for row-sharded Gram matrices.

Port of portfoliooptgp_tpu/parallel/dist_cholesky.py. When N is too large
for one device, the rows of K + σ²I are split over the mesh's `data` axis
and a right-looking blocked factorization runs with collective panel
exchanges. Per panel k (block size nb; panels never straddle ranks):

  1. the owner of the diagonal block broadcasts it, with its rows of the
     forward-substitution right-hand side y_k − acc_k, and every rank
     factors it (L_kk, the same on every rank);
  2. every rank solves its rows of the panel column below the block,
     L[i, k] = A[i, k] L_kkᵀ⁻¹ (the owner's rows of the block are L_kk);
  3. one all-gather shares the panel column (N × nb); each rank applies
     the trailing update to its rows and the columns still to come,
     A_local −= P_local · P_gatheredᵀ;
  4. a_k = L_kk⁻¹(y_k − acc_k) on every rank, and each accumulates its
     rows below the block, acc += P_local a_k.

  NLL = ½ Σ a_k² + Σ log diag L_kk + N/2 log 2π, the same on every rank.

Panel owners and offsets are Python integers, so nothing waits on the
device to learn them. Two row layouts, as in the JAX package:
`contiguous` (rank d owns rows [d·N/D, (d+1)·N/D)) and `cyclic` (1-D
block-cyclic: rank d owns the row blocks b with b mod D = d, so every rank
keeps rows in every trailing region). A rank holds its own rows of K and y
(`shard_rows` gives them from a global tensor); the columns keep the
global order.

`sharded_gpr_nll` is a `torch.autograd.Function` with the JAX package's
closed-form backward (GPML eq. 5.9):

  dNLL/dK  = ct · ½ (W − ααᵀ)   (this rank's rows; W = (K+σ²I)⁻¹, α = W y)
  dNLL/dy  = ct · α             (this rank's rows)
  dNLL/dσ² = ct · ½ (tr W − αᵀα)  (the whole value, on every rank)

W's rows come from the two-sweep solve on the identity's column blocks,
nothing denser than a row shard on any rank: the forward sweep U = L⁻¹ by
panels (the owner of block j solves it, one broadcast shares it), then the
back sweep W = L⁻ᵀ U from the last panel to the first (one all-reduce of
the panel's contributions, nb × N, per panel). The JAX package runs the
sweeps one identity column block at a time (nblocks² steps, each with a
collective); here each sweep takes every column block at once, 2·nblocks
steps with the same arithmetic per entry. Gradients of values that every
rank holds alike (say kernel hyperparameters, from which each rank builds
its rows of K) are this rank's share: pass them through
`mesh.replicated_input` to sum the shares.

The panels' work is `torch.linalg.cholesky`, `solve_triangular` and
`torch.matmul`, as the JAX package's is XLA's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portfoliooptgp_tpu_torch.parallel import mesh as mesh_mod
from portfoliooptgp_tpu_torch.parallel.mesh import DATA_AXIS

LAYOUTS = ("contiguous", "cyclic")


class _Plan:
    """Row ownership of one rank: block `b` of the global rows lives on rank
    `owner(b)` at local offset `offset(b)`; `first_row(b)` is the first
    local row of a block ≥ b (local blocks are in global order)."""

    def __init__(self, mesh, N: int, nb: int, cyclic: bool):
        self.mesh = mesh
        self.D = mesh.shape[DATA_AXIS]
        self.d = mesh.index(DATA_AXIS)
        self.N, self.nb, self.cyclic = N, nb, cyclic
        self.n_local = N // self.D
        self.nblocks = N // nb
        self.nbl = self.n_local // nb  # blocks per rank
        self.row_g = torch.as_tensor(local_rows(N, self.D, nb, self.d, cyclic),
                                     device=mesh.device)

    def owner(self, b: int) -> int:
        return b % self.D if self.cyclic else b // self.nbl

    def offset(self, b: int) -> int:
        return (b // self.D if self.cyclic else b % self.nbl) * self.nb

    def first_row(self, b: int) -> int:
        if self.cyclic:
            j = -(-(b - self.d) // self.D)
        else:
            j = b - self.d * self.nbl
        return min(max(j, 0), self.nbl) * self.nb

    def assemble(self, x):
        """All ranks' (n_local, ...) rows → (N, ...) in global order."""
        g = mesh_mod.all_gather(x, self.mesh, DATA_AXIS)
        if not self.cyclic:
            return g
        tail = tuple(g.shape[1:])
        g = g.reshape((self.D, self.nbl, self.nb) + tail).transpose(0, 1)
        return g.reshape((self.N,) + tail)

    def broadcast(self, x, b: int):
        return mesh_mod.broadcast(x, self.mesh, DATA_AXIS, self.owner(b))

    def all_reduce(self, xs):
        return mesh_mod.all_reduce_sum(xs, self.mesh, DATA_AXIS)


def local_rows(N: int, n_dev: int, block_size: int, index: int, cyclic: bool):
    """The global row numbers that rank `index` of `n_dev` holds."""
    n_local = N // n_dev
    if cyclic:
        return cyclic_row_permutation(N, n_dev, block_size)[index * n_local:(index + 1) * n_local]
    return np.arange(index * n_local, (index + 1) * n_local)


def cyclic_row_permutation(N: int, n_dev: int, block_size: int):
    """Row permutation placing 1-D block-cyclic shards contiguously: shard d
    holds global blocks {b : b mod D = d} in order. perm[new] = old."""
    blocks = np.arange(N // block_size)
    order = np.concatenate([blocks[blocks % n_dev == d] for d in range(n_dev)])
    return (order[:, None] * block_size + np.arange(block_size)[None, :]).reshape(-1)


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def _factor(K, y, noise, p: _Plan, store_l: bool):
    """The panel loop: (nll, local rows of L or None, [L_kk])."""
    nb, N = p.nb, p.N
    rows = torch.arange(p.n_local, device=K.device)
    A = K.clone()
    A[rows, p.row_g] += noise
    Ll = torch.zeros_like(K) if store_l else None
    acc = torch.zeros(p.n_local, dtype=K.dtype, device=K.device)
    quad = torch.zeros((), dtype=K.dtype, device=K.device)
    logdet = torch.zeros((), dtype=K.dtype, device=K.device)
    diag = []
    for k in range(p.nblocks):
        kb, off, mine = k * nb, p.offset(k), p.owner(k) == p.d
        # 1. the diagonal block and the right-hand side, from the owner
        buf = torch.empty((nb, nb + 1), dtype=K.dtype, device=K.device)
        if mine:
            buf[:, :nb] = A[off:off + nb, kb:kb + nb]
            buf[:, nb] = y[off:off + nb, 0] - acc[off:off + nb]
        p.broadcast(buf, k)
        Lkk = torch.linalg.cholesky(buf[:, :nb])
        diag.append(Lkk)
        # 2. this rank's rows of the panel column
        t = p.first_row(k + 1)
        Pl = torch.zeros((p.n_local, nb), dtype=K.dtype, device=K.device)
        Pl[t:] = torch.linalg.solve_triangular(Lkk.T, A[t:, kb:kb + nb], upper=True,
                                               left=False)
        if mine:
            Pl[off:off + nb] = Lkk
        # 3. share the panel; trailing update of the columns still to come
        panel = p.assemble(Pl)
        A[t:, kb + nb:] -= Pl[t:] @ panel[kb + nb:].T
        if store_l:
            Ll[:, kb:kb + nb] = Pl
        # 4. forward substitution on y
        ak = _solve_lower(Lkk, buf[:, nb:])[:, 0]
        acc[t:] += Pl[t:] @ ak
        quad = quad + torch.sum(ak * ak)
        logdet = logdet + torch.sum(torch.log(torch.diagonal(Lkk)))
    nll = 0.5 * quad + logdet + 0.5 * N * math.log(2.0 * math.pi)
    return nll, Ll, diag


def _inverse_rows(Ll, diag, p: _Plan):
    """This rank's rows of W = (L Lᵀ)⁻¹ by the two sweeps."""
    nb, N = p.nb, p.N
    opts = dict(dtype=Ll.dtype, device=Ll.device)
    # forward sweep: U = L⁻¹, by row blocks; block j's columns end at (j+1)·nb
    U = torch.zeros((p.n_local, N), **opts)
    acc = torch.zeros((p.n_local, N), **opts)
    eye = torch.eye(nb, **opts)
    for j in range(p.nblocks):
        jb, off, cols = j * nb, p.offset(j), (j + 1) * nb
        u = torch.empty((nb, cols), **opts)
        if p.owner(j) == p.d:
            rhs = -acc[off:off + nb, :cols]
            rhs[:, jb:cols] += eye
            u = _solve_lower(diag[j], rhs)
            U[off:off + nb, :cols] = u
        p.broadcast(u, j)
        t = p.first_row(j + 1)
        acc[t:, :cols] += Ll[t:, jb:jb + nb] @ u
    # back sweep: W = L⁻ᵀ U, from the last panel to the first
    W = torch.zeros((p.n_local, N), **opts)
    for k in reversed(range(p.nblocks)):
        kb, off = k * nb, p.offset(k)
        t = p.first_row(k + 1)
        c, = p.all_reduce([Ll[t:, kb:kb + nb].T @ W[t:]])
        if p.owner(k) == p.d:
            W[off:off + nb] = torch.linalg.solve_triangular(diag[k].T, U[off:off + nb] - c,
                                                            upper=True)
    return W


def _local_vjp(Ll, diag, y, ct, p: _Plan):
    """(dK rows, dy rows, dσ²) of the NLL."""
    W = _inverse_rows(Ll, diag, p)
    alpha = W @ p.assemble(y)  # this rank's rows of α = (K+σ²I)⁻¹ y
    alpha_full = p.assemble(alpha)
    rows = torch.arange(p.n_local, device=W.device)
    trW, ata = p.all_reduce([torch.sum(W[rows, p.row_g]), torch.sum(alpha * alpha)])
    dK = ct * 0.5 * (W - alpha @ alpha_full.T)
    return dK, ct * alpha, ct * 0.5 * (trW - ata)


class _ShardedNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, y, noise, plan):
        store = any(ctx.needs_input_grad[:3])
        nll, Ll, diag = _factor(K, y, noise, plan, store)
        if store:
            ctx.save_for_backward(Ll, y)
            ctx.diag, ctx.plan = diag, plan
        return nll

    @staticmethod
    def backward(ctx, ct):
        Ll, y = ctx.saved_tensors
        dK, dy, dnoise = _local_vjp(Ll, ctx.diag, y, ct, ctx.plan)
        need = ctx.needs_input_grad
        return (dK if need[0] else None, dy if need[1] else None,
                dnoise if need[2] else None, None)


def shard_rows(A, mesh, block_size: int = 64, layout: str = "contiguous"):
    """This rank's rows of a global (N, ...) tensor in `layout`'s order."""
    rows = local_rows(A.shape[0], mesh.shape[DATA_AXIS], block_size, mesh.index(DATA_AXIS),
                      layout == "cyclic")
    return A[torch.as_tensor(rows, device=A.device)]


def gather_rows(A_local, mesh, block_size: int = 64, layout: str = "contiguous"):
    """The global (N, ...) tensor from every rank's rows (`shard_rows`'s
    inverse), on every rank; no gradient."""
    N = A_local.shape[0] * mesh.shape[DATA_AXIS]
    return _Plan(mesh, N, block_size, layout == "cyclic").assemble(A_local)


def sharded_gpr_nll(K, y, noise, mesh, block_size: int = 64, layout: str = "contiguous"):
    """Exact-GPR NLL with K's rows split over the mesh's data axis.

    K: (N / D, N), this rank's rows of the kernel matrix in `layout`'s
    order (`shard_rows`), columns in global order; y: (N / D, 1), the same
    rows of the targets; noise: σ² (a tensor or a number), equal on every
    rank. N must divide by the data axis D and the block size by N / D.
    Returns the NLL, the same on every rank; differentiable in K, y and
    noise (see the module docstring for what each rank's gradients are).

    layout: 'contiguous' or 'cyclic' (1-D block-cyclic: rank d owns the
    row blocks b with b mod D = d, so every rank stays busy through the
    whole factorization)."""
    n_dev = mesh.shape[DATA_AXIS]
    N = K.shape[1]
    if N % n_dev:
        raise ValueError(f"N={N} must divide the data axis ({n_dev})")
    n_local = N // n_dev
    if K.shape[0] != n_local or tuple(y.shape) != (n_local, 1):
        raise ValueError(f"K must hold this rank's {n_local} rows of {N} and y (n_local, 1); "
                         f"got {tuple(K.shape)} and {tuple(y.shape)}")
    if n_local % block_size:
        raise ValueError(f"block_size={block_size} must divide N/devices={n_local}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout: {layout!r}")
    noise = torch.as_tensor(noise, dtype=K.dtype, device=K.device)
    plan = _Plan(mesh, N, block_size, layout == "cyclic")
    return _ShardedNLL.apply(K, y, noise, plan)
