"""Natural-gradient updates of the SVGP's variational parameters.

Port of portfoliooptgp_tpu/train/natgrad.py. With ξ = (m, L) per latent,
S = L Lᵀ, g_m = dELBO/dm and g_S = dELBO/dS (from the gradient in L
through the Cholesky VJP), one step in precision space is

    P' = S⁻¹ − 2γ g_S,  S' = P'⁻¹,  m' = m + γ S' g_m,

algebraically the natural-parameter step θ ← θ + γ dELBO/dη without
forming η₂ = S + m mᵀ (whose float32 cancellation goes non-PSD once the
posterior tightens). With a Gaussian likelihood γ = 1 lands on the optimal
q(u) for the current hyperparameters. `make_natgrad_train_step` alternates
it with an Adam step on everything else (GPflow's NaturalGradient + Adam).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from portfoliooptgp_tpu_torch.models import svgp as svgp_mod
from portfoliooptgp_tpu_torch.ops import linalg
from portfoliooptgp_tpu_torch.params import tree_leaves, tree_replace
from portfoliooptgp_tpu_torch.train.lbfgs import freeze_leaves
from portfoliooptgp_tpu_torch.train.optim import make_step


def _sym(A):
    return 0.5 * (A + A.T)


def natgrad_step(model, X, Y, *, num_data: Optional[int] = None, gamma: float = 1.0,
                 weights=None):
    """One natural-gradient step on (q_mu, q_sqrt), hyperparameters fixed.
    Returns the updated model."""
    q_mu = model.q_mu.detach().requires_grad_(True)
    q_sqrt = model.q_sqrt.detach().requires_grad_(True)
    with torch.enable_grad():
        m = dataclasses.replace(model, q_mu=q_mu, q_sqrt=q_sqrt)
        if weights is not None:
            mean, var = svgp_mod.predict_f_guarded(m, X)
            lp = m.likelihood.variational_expectations(mean, var, Y)
            scale = 1.0 if num_data is None else num_data / torch.sum(weights)
            value = torch.sum(lp * weights[:, None]) * scale - svgp_mod.prior_kl(m)
        else:
            value = svgp_mod.elbo(m, X, Y, num_data)
        dmu, dsqrt = torch.autograd.grad(value, (q_mu, q_sqrt))

    new_mu, new_L = [], []
    for p in range(model.q_sqrt.shape[0]):
        m_p, dmu_p = model.q_mu[:, p].detach(), dmu[:, p]
        L_p, dL_p = torch.tril(model.q_sqrt[p].detach()), torch.tril(dsqrt[p])
        eye = torch.eye(m_p.shape[0], dtype=m_p.dtype, device=m_p.device)
        Linv = torch.linalg.solve_triangular(L_p, eye, upper=False)
        Sinv = Linv.T @ Linv
        # g_S from the gradient in L through the Cholesky VJP
        S = _sym(L_p @ L_p.T).requires_grad_(True)
        with torch.enable_grad():
            (gS,) = torch.autograd.grad(linalg.cholesky_guarded(S)[0], S, dL_p)
        P_new = _sym(Sinv - 2.0 * gamma * _sym(gS)) + 1e-12 * eye
        S_new = _sym(torch.cholesky_solve(eye, linalg.cholesky(P_new)))
        new_mu.append(m_p + gamma * (S_new @ dmu_p))
        new_L.append(linalg.cholesky(S_new))
    return dataclasses.replace(model, q_mu=torch.stack(new_mu, dim=1),
                               q_sqrt=torch.stack(new_L))


class NatGradState(NamedTuple):
    model: object
    opt_state: object


def make_natgrad_train_step(num_data, hyper_optimizer, gamma: float = 0.1, frozen_hyper=None):
    """(init_fn, step_fn): each step is a natural-gradient update of the
    variational parameters, then a `hyper_optimizer` step (e.g.
    `train.optim.Adam`) on everything else (q_mu and q_sqrt get zero
    gradients, as do the leaves `frozen_hyper` marks)."""

    def init_fn(model):
        return NatGradState(model=model, opt_state=hyper_optimizer.init(model))

    def hyper_step(state, X, Y):
        frozen = freeze_leaves(state.model, q_mu=True, q_sqrt=True)
        if frozen_hyper is not None:
            frozen = tree_replace(frozen, [a or bool(b) for a, b in
                                           zip(tree_leaves(frozen), tree_leaves(frozen_hyper))])
        step = make_step(lambda m, X, Y: svgp_mod.neg_elbo(m, X, Y, num_data), hyper_optimizer,
                         frozen)
        return step(state, X, Y)

    def step_fn(state: NatGradState, X, Y):
        model = natgrad_step(state.model, X, Y, num_data=num_data, gamma=gamma)
        return hyper_step(state._replace(model=model), X, Y)

    return init_fn, step_fn
