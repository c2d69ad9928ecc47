"""Constrained parameters and the parameter tree of a model.

Port of portfoliooptgp_tpu/params.py: raw (unconstrained) tensors are
stored, `positive()` maps them through softplus plus a 1e-6 shift at use
sites. Torch has no pytrees, so models are frozen dataclasses and the
helpers below walk them: `tree_leaves` lists the raw tensors in the JAX
package's `jax.tree.leaves` order, `tree_replace` rebuilds a model from a
new list. The order is the dataclass field order, depth first, skipping
each class's static `_meta` fields (e.g. `active_dims`). For the
walk-forward model `GPR(Product(Matern12, Matern12), Gaussian, Zero)`:

    [k1.raw_variance, k1.raw_lengthscales,
     k2.raw_variance, k2.raw_lengthscales,
     likelihood.raw_variance]

Every leaf carries a leading batch axis (B models); a lengthscale leaf is
(B,) when isotropic and (B, D) when ARD. The leaf orders of `Periodic`,
`Linear`/`Polynomial` and the mean functions are in the docstrings of
kernels/periodic.py, kernels/linear.py and kernels/means.py; menu entry 6,
`GPR(Exponential + Periodic(SE) + Linear, Gaussian, Zero)`, gives

    [exp.raw_variance, exp.raw_lengthscales,
     se.raw_variance, se.raw_lengthscales, periodic.raw_period,
     linear.raw_variance, likelihood.raw_variance]

The sparse and variational models are one model each: their kernel and
likelihood leaves keep the batch axis of 1, the variational leaves keep
the JAX package's shapes. `SVGP(SE, Gaussian, Zero)` gives

    [kernel.raw_variance (1,), kernel.raw_lengthscales (1,) or (1, D),
     likelihood.raw_variance (1,), Z (M, D), q_mu (M, P), q_sqrt (P, M, M)]

SGPR ends at Z; VGP has q_mu (N, P), q_sqrt (P, N, N) after the
likelihood (StudentT: raw_scale (1,)).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Lower shift for the positive bijector (GPflow's positive_minimum analogue).
POSITIVE_SHIFT = 1e-6


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def softplus_inv(y):
    # inverse of log(1+exp(x)) computed stably: x = y + log(1 - exp(-y))
    return y + torch.log(-torch.expm1(-y))


def positive(raw):
    """Map unconstrained raw value -> positive constrained value."""
    return softplus(raw) + POSITIVE_SHIFT


def positive_inv(value):
    """Map positive constrained value -> unconstrained raw value."""
    return softplus_inv(torch.clamp_min(value - POSITIVE_SHIFT, 1e-300))


def as_param(value, device, dtype):
    """Python scalar / array-like → raw-parameter tensor with a leading
    batch axis of 1."""
    from portfoliooptgp_tpu_torch.device import as_tensor

    return as_tensor(np.asarray(value, dtype=float), device, dtype)[None]


# -- the parameter tree ----------------------------------------------------

def _data_fields(obj):
    meta = getattr(obj, "_meta", ())
    return [f.name for f in dataclasses.fields(obj) if f.name not in meta]


def tree_leaves(tree) -> list:
    """Leaves in `jax.tree.leaves` order (tensors, or whatever stands in
    their place in a mask tree)."""
    if tree is None:
        return []
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in _data_fields(tree)
                for leaf in tree_leaves(getattr(tree, f))]
    return [tree]


def tree_replace(tree, leaves):
    """`tree` with its leaves replaced, in order, by `leaves`."""
    it = iter(leaves)

    def rebuild(t):
        if t is None:
            return None
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(x) for x in t)
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(
                t, **{f: rebuild(getattr(t, f)) for f in _data_fields(t)})
        return next(it)

    out = rebuild(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree):
    return tree_replace(tree, [fn(leaf) for leaf in tree_leaves(tree)])


def tree_to(tree, device, dtype):
    """Every leaf moved to (device, dtype); differentiable."""
    return tree_map(lambda x: x.to(device=device, dtype=dtype), tree)


def batch_size(tree) -> int:
    return int(tree_leaves(tree)[0].shape[0])


def ravel(tree):
    """(B, dim): each model of a stacked tree as one flat vector, the
    counterpart of `jax.flatten_util.ravel_pytree` with the batch axis
    first. Leaves go in `tree_leaves` order, each flattened in C order
    without its batch axis, so the flat order is the JAX package's for one
    model (the GPR model `GPR(SE(ARD D=4), Gaussian, Zero)` has dim 6:
    variance, 4 lengthscales, noise)."""
    leaves = tree_leaves(tree)
    b = leaves[0].shape[0]
    return torch.cat([leaf.reshape(b, -1) for leaf in leaves], dim=1)


def unravel(template, flat):
    """`template`'s structure with its leaves cut from `flat` (..., dim):
    leading axes of `flat` replace the template's batch axis, so (C, dim)
    gives a stacked tree of C models and (C, S, dim) leaves of shape
    (C, S, ...). Differentiable in `flat`."""
    shapes = [leaf.shape[1:] for leaf in tree_leaves(template)]
    sizes = [int(np.prod(s, dtype=int)) for s in shapes]
    if sum(sizes) != flat.shape[-1]:
        raise ValueError(f"template has {sum(sizes)} entries, got {flat.shape[-1]}")
    lead = flat.shape[:-1]
    pieces = torch.split(flat, sizes, dim=-1)
    return tree_replace(template, [x.reshape(*lead, *s) for x, s in zip(pieces, shapes)])


def from_jax_leaves(template, leaves):
    """The port's model with the parameters of a JAX model.

    `template`: a port model of the same structure (e.g. built with the
    same `create` calls); its device and dtype are kept. `leaves`: numpy
    arrays in `jax.tree.leaves` order of the JAX model (see the module
    docstring). A leaf of one JAX model (no batch axis) gets a batch axis
    of 1; leaves of a stacked JAX model keep theirs."""
    ref = tree_leaves(template)
    if len(ref) != len(leaves):
        raise ValueError(
            f"template has {len(ref)} leaves, got {len(leaves)}")
    new = []
    for t, x in zip(ref, leaves):
        x = torch.as_tensor(np.array(x), dtype=t.dtype, device=t.device)
        if x.ndim == t.ndim - 1:
            x = x[None]
        if x.shape[1:] != t.shape[1:]:
            raise ValueError(
                f"leaf shape {tuple(x.shape)} does not fit {tuple(t.shape)}")
        new.append(x)
    return tree_replace(template, new)
