"""The process mesh, sharding helpers and the axis collectives.

Port of portfoliooptgp_tpu/parallel/mesh.py on `torch.distributed`. A mesh
has two named axes, as in the JAX package:

- `data`: shards the observation / minibatch axis (SVGP ELBO terms, MC
  samples, the rows of a distributed Cholesky);
- `restart`: shards the batched-restart axis (walk-forward day×restart
  rows).

One process is one rank and holds one device; ranks are laid out row-major
over (data, restart), as JAX reshapes its device list. The JAX package
writes a `shard_map` body and lets XLA place collectives; here a rank holds
its local rows as ordinary tensors and the collectives are explicit calls
on the axis's process group (`init_device_mesh`'s groups). A one-process
run without a process group is the 1×1 mesh, whose collectives are the
identity.

Gradients through the collectives come from a conjugate pair of functions:
`psum` (all-reduce sum forward, identity backward) for partial sums that a
replicated finish consumes, and `replicated_input` (identity forward,
all-reduce sum of the gradient backward) for replicated values entering a
rank's local computation. A loss `finish(θ, Σᵣ partialᵣ(θ))` then has the
gradient of the one-device loss on every rank, the finish's term once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from portfoliooptgp_tpu_torch.params import tree_map

DATA_AXIS = "data"
RESTART_AXIS = "restart"
AXES = (DATA_AXIS, RESTART_AXIS)


class Mesh:
    """A (data, restart) mesh of ranks. `shape[axis]` is an axis's size,
    `size` the number of ranks, `device` this rank's device."""

    def __init__(self, data: int, restart: int, device: torch.device, device_mesh=None):
        self.shape = {DATA_AXIS: int(data), RESTART_AXIS: int(restart)}
        self.axis_names = AXES
        self.size = int(data) * int(restart)
        self.device = device
        self.device_mesh = device_mesh

    def group(self, axis: str):
        """The process group of `axis` that holds this rank (None on the
        one-process mesh)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (jax.lax.axis_index)."""
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(data: Optional[int] = None, restart: int = 1, device=DEFAULT_DEVICE) -> Mesh:
    """A (data, restart) mesh over every rank of the default process group
    (all ranks on the data axis by default). Without a process group the
    world is this one process. `device`: "cuda" (this rank's current card)
    or "cpu"."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = n // restart
    if data * restart != n:
        raise ValueError(f"mesh {data}x{restart} != {n} ranks")
    if not dist.is_initialized():
        return Mesh(1, 1, dev)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (data, restart), mesh_dim_names=AXES)
    return Mesh(data, restart, dev, dm)


# -- collectives over one axis -------------------------------------------------

def _pack(xs):
    dtypes = {x.dtype for x in xs}
    if len(dtypes) != 1:
        raise ValueError(f"packed collectives need one dtype, got {sorted(map(str, dtypes))}")
    return torch.cat([x.reshape(-1) for x in xs])


def _unpack(flat, shapes):
    sizes = [int(np.prod(s, dtype=int)) for s in shapes]
    return [p.reshape(s) for p, s in zip(torch.split(flat, sizes), shapes)]


def all_reduce_sum(xs, mesh: Mesh, axis: str = DATA_AXIS):
    """Σ over the ranks of `axis` of each tensor of `xs`, one all-reduce of
    one packed buffer; no gradient. Returns a list."""
    xs = list(xs)
    group = mesh.group(axis)
    if group is None:
        return [x.detach() for x in xs]
    flat = _pack([x.detach() for x in xs]).clone()
    dist.all_reduce(flat, group=group)
    return _unpack(flat, [x.shape for x in xs])


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        flat = _pack(xs).clone()
        dist.all_reduce(flat, group=group)
        return tuple(_unpack(flat, [x.shape for x in xs]))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.shapes = [x.shape for x in xs]
        ctx.opts = dict(dtype=xs[0].dtype, device=xs[0].device)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, **ctx.opts) if g is None else g
                 for g, s in zip(grads, ctx.shapes)]
        flat = _pack(grads).clone()
        dist.all_reduce(flat, group=ctx.group)
        return (None, *_unpack(flat, ctx.shapes))


def psum(xs, mesh: Mesh, axis: str = DATA_AXIS):
    """Σ over the ranks of `axis` of each tensor of `xs` (one dtype), as one
    all-reduce of one packed buffer: sum forward, identity backward. For
    partial sums that every rank then finishes alike. Returns a list."""
    xs = list(xs)
    group = mesh.group(axis)
    return xs if group is None else list(_Psum.apply(group, *xs))


def replicated_input(xs, mesh: Mesh, axis: str = DATA_AXIS):
    """`xs` (one dtype, equal on every rank of `axis`) as a rank's local
    computation takes them: identity forward, all-reduce sum of their
    gradients (one packed buffer) backward. Returns a list."""
    xs = list(xs)
    group = mesh.group(axis)
    return xs if group is None else list(_ReplicatedInput.apply(group, *xs))


def all_gather(x, mesh: Mesh, axis: str = DATA_AXIS):
    """The ranks' `x` along `axis`, concatenated on dim 0 in axis order; no
    gradient."""
    group = mesh.group(axis)
    if group is None:
        return x.detach()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return torch.cat(parts, dim=0)


def broadcast(x, mesh: Mesh, axis: str, src: int):
    """`x` of the rank at coordinate `src` of `axis`, on every rank of it
    (in place on the others' `x`, which must have its shape and dtype)."""
    group = mesh.group(axis)
    if group is not None:
        # a collective moves storage: a column-major view would arrive transposed
        y = x.contiguous()
        dist.broadcast(y, src=dist.get_global_rank(group, src), group=group)
        if y is not x:
            x.copy_(y)
    return x


# -- placement -------------------------------------------------------------------

def place(mesh: Mesh, a, dtype=None):
    """An array or tensor on this rank's device, in `dtype` (default: its
    own)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=mesh.device, dtype=dtype or a.dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=mesh.device)


def shard_rows(mesh: Mesh, a, axis: str = DATA_AXIS, dim: int = 0):
    """This rank's block of `a` along `dim` over `axis`: block i of
    mesh.shape[axis] equal blocks (JAX's P(axis) placement). The size must
    divide."""
    n, parts = a.shape[dim], mesh.shape[axis]
    if n % parts:
        raise ValueError(f"{n} rows do not divide the '{axis}' axis ({parts})")
    local = n // parts
    return a.narrow(dim, mesh.index(axis) * local, local)


def shard_batch(mesh: Mesh, *arrays, dtype=None):
    """This rank's rows of (X, Y, ...) over the data axis, on its device;
    the row counts must divide the data-axis size (pad upstream if not)."""
    out = tuple(shard_rows(mesh, place(mesh, a, dtype)) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, tree):
    """Every leaf of a model tree on this rank's device, equal to rank 0's
    (one broadcast per leaf over all ranks)."""
    def leaf(x):
        x = x.detach().to(mesh.device).contiguous()
        if mesh.device_mesh is not None:
            x = x.clone()
            dist.broadcast(x, src=0)
        return x

    return tree_map(leaf, tree)


def pad_to_multiple(X, Y, multiple: int):
    """Pad rows so the batch divides the mesh data axis; returns (X_pad,
    Y_pad, weights), weights 1 for real rows and 0 for padding (copies of
    the last row), so weighted losses get exactly nothing from padding."""
    n = X.shape[0]
    rem = (-n) % multiple
    w = torch.cat([torch.ones((n,), dtype=X.dtype, device=X.device),
                   torch.zeros((rem,), dtype=X.dtype, device=X.device)])
    if rem == 0:
        return X, Y, w
    Xp = torch.cat([X, X[-1:].expand((rem,) + tuple(X.shape[1:]))])
    Yp = torch.cat([Y, Y[-1:].expand((rem,) + tuple(Y.shape[1:]))])
    return Xp, Yp, w


def stream_seed(seed: int, index: int) -> int:
    """The seed of rank `index`'s random stream under a run's `seed`: each
    rank draws its own numbers (numpy's SeedSequence of (seed, index))."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
               & 0x7FFF_FFFF_FFFF_FFFF)
