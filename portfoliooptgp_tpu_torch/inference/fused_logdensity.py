"""Chain-batched GPR log-densities for NUTS.

Port of portfoliooptgp_tpu/inference/fused_logdensity.py. The JAX package
vmaps one chain's log-density over the chains and uses `custom_vmap` to
send the chain batch into one fused NLL call. In the port the chain axis
is the model batch axis, so a log-density of C stacked models is one call
of `gpr.batched_neg_log_marginal_likelihood`: on a GPU in float32, for a
fusable kernel, one launch of the stationary NLL kernel for all chains.
A single chain (B = 1) takes the same router; the JAX package's unbatched
call takes its dense XLA path instead, and the two agree in float64.

`logprior_fn`, if given, maps a stacked model to (C,) log-priors (e.g.
`sampler.centered_normal_logprior`) and is added per chain.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from portfoliooptgp_tpu_torch.models import gpr
from portfoliooptgp_tpu_torch.params import tree_leaves, tree_replace
from portfoliooptgp_tpu_torch.utils.profiling import span


def _logp(X, Y, logprior_fn):
    """The closure holds X fixed: the fused tiers' operands that depend on
    X alone are built on its first call and kept while the model's
    structure (`gpr.fused_structure`) stays the same. An X that requires
    grad is never served kept operands: every call builds its own."""
    held = None  # (structure, gpr.fused_operands or None)

    def logp(stacked):
        nonlocal held
        operands = None
        if not X.requires_grad:
            key = gpr.fused_structure(stacked.kernel, X.shape[1])
            if held is None or held[0] != key:
                held = (key, gpr.fused_operands(stacked, X))
            operands = held[1]
        lp = -gpr.batched_neg_log_marginal_likelihood(stacked, X, Y, device=X.device,
                                                      dtype=X.dtype, operands=operands)
        if logprior_fn is not None:
            lp = lp + logprior_fn(stacked)
        return lp
    return logp


def _value_and_grad(logp, stacked):
    """(C,) values and the gradient tree of their sum, from detached leaves:
    one forward (the kernel with W, for the closed-form backward) and one
    backward; no graph outlives the call. The span
    `logdensity.value_and_grad`."""
    with span("logdensity.value_and_grad"), torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(stacked)]
        lp = logp(tree_replace(stacked, leaves))
        grads = torch.autograd.grad(lp.sum(), leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        return lp.detach(), tree_replace(stacked, grads)


def gpr_logdensity_pair(X, Y, logprior_fn: Optional[Callable] = None):
    """(logp_fn, grad_fn) over stacked GPR models for `sample_nuts`:
    logp_fn(stacked) → (C,) log densities (value only: the kernel without W
    on a GPU), grad_fn(stacked) → the gradient tree."""
    logp = _logp(X, Y, logprior_fn)

    def value(stacked):
        with torch.no_grad():
            return logp(stacked)

    def grad(stacked):
        return _value_and_grad(logp, stacked)[1]

    return value, grad


def gpr_logdensity_vg(X, Y, logprior_fn: Optional[Callable] = None):
    """Joint (logp (C,), gradient tree) of stacked GPR models in ONE batched
    evaluation: one NLL forward with W and its closed-form backward, half
    the kernel launches of calling the pair's two functions."""
    logp = _logp(X, Y, logprior_fn)
    return lambda stacked: _value_and_grad(logp, stacked)
