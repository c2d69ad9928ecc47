"""Adam over a model tree, with optax's `adam` formula.

The JAX package trains the SVGP with `optax.adam(1e-2)`: per leaf

    μ ← b1 μ + (1 − b1) g,  ν ← b2 ν + (1 − b2) g²,  t ← t + 1
    update = −lr · (μ / (1 − b1ᵗ)) / (√(ν / (1 − b2ᵗ)) + ε)

applied to the raw (unconstrained) leaves. This is that transformation in
the functional form of the reference (`init` / `update` on trees, the state
held by the caller), so that a train step can skip a batch without touching
the moments. `torch.optim.Adam` computes the same formula with the bias
corrections distributed differently, which moves the last bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portfoliooptgp_tpu_torch.params import tree_leaves, tree_replace


class AdamState(NamedTuple):
    count: int
    mu: list
    nu: list


class Adam:
    def __init__(self, learning_rate: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params) -> AdamState:
        leaves = tree_leaves(params)
        return AdamState(0, [torch.zeros_like(x) for x in leaves],
                         [torch.zeros_like(x) for x in leaves])

    def update(self, grads, state: AdamState, params=None):
        """(updates, new state); `grads` a tree like the parameters."""
        g = tree_leaves(grads)
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        mu = [b1 * m + (1.0 - b1) * x for m, x in zip(state.mu, g)]
        nu = [b2 * n + (1.0 - b2) * x * x for n, x in zip(state.nu, g)]
        c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        upd = [-self.learning_rate * ((m / c1) / (torch.sqrt(n / c2) + self.eps))
               for m, n in zip(mu, nu)]
        return tree_replace(grads, upd), AdamState(count, mu, nu)


def apply_updates(params, updates):
    return tree_replace(params, [p + u for p, u in zip(tree_leaves(params),
                                                       tree_leaves(updates))])


def make_step(loss_fn, optimizer, frozen=None):
    """step(state, *batch) → (state, loss): one `optimizer` step on
    `loss_fn(state.model, *batch)` over every leaf of the model. `state` is
    a NamedTuple with `model` and `opt_state`; `frozen`, a tree of booleans
    like the model, gives its True leaves zero gradients (they are not
    differentiated at all)."""

    def step(state, *batch):
        leaves = tree_leaves(state.model)
        flags = ([False] * len(leaves) if frozen is None
                 else [bool(f) for f in tree_leaves(frozen)])
        live = [x.detach().requires_grad_(not f) for x, f in zip(leaves, flags)]
        with torch.enable_grad():
            loss = loss_fn(tree_replace(state.model, live), *batch)
            got = iter(torch.autograd.grad(loss, [x for x, f in zip(live, flags) if not f]))
        grads = [torch.zeros_like(x) if f else next(got) for x, f in zip(leaves, flags)]
        updates, opt_state = optimizer.update(tree_replace(state.model, grads),
                                              state.opt_state, state.model)
        model = apply_updates(tree_replace(state.model, [x.detach() for x in leaves]), updates)
        return state._replace(model=model, opt_state=opt_state), loss.detach()

    return step
