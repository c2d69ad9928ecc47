"""Checkpoint and resume for model trees.

Port of portfoliooptgp_tpu/utils/checkpoint.py. A model (any tree that
`params.tree_leaves` walks) is written as an .npz of its leaves,
`leaf_0`, `leaf_1`, ..., in the JAX package's `jax.tree.leaves` order,
and loaded into the structure, device and dtype of a template. So the two
packages read each other's files:

- a JAX checkpoint of one model has leaves without the port's batch axis;
  `load` gives each such leaf the template's batch axis of 1;
- a port checkpoint of one model holds that axis of 1, and the JAX
  package's `load` keeps it (its scalars become shape (1,), which
  broadcast as scalars do).
"""

from __future__ import annotations

import io
import os

import numpy as np

from portfoliooptgp_tpu_torch.params import from_jax_leaves, tree_leaves


def save(path: str, tree) -> None:
    """Write a tree's leaves atomically (a crash never leaves a torn file)."""
    arrays = {f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(tree_leaves(tree))}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def load(path: str, template):
    """Restore into the structure, device and dtype of `template` (a tree
    of the same leaves); raises if the leaf count or a shape differs."""
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    n = len(tree_leaves(template))
    if n != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves but template expects {n}")
    return from_jax_leaves(template, leaves)


# Alias kept from the JAX package.
save_array_tree = save
