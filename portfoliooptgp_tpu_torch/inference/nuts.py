"""No-U-Turn Sampler (iterative, multinomial) on flat parameters.

Port of portfoliooptgp_tpu/inference/nuts.py (Hoffman & Gelman 2014 with
the Stan / numpyro refinements):

- multinomial sampling of the proposal among the trajectory's leaves,
  with biased progressive acceptance of clean subtrees;
- iterative tree building: a depth-d subtree is 2^d single leapfrog steps
  with max_depth + 1 checkpoint slots for the U-turn checks inside it. A
  subtree of size 2^k ends at leaf j iff 2^k | j; its first leaf,
  j − 2^k + 1, is parked in slot ctz(j − 2^k), the subtree's first leaf in
  the top slot;
- the generalized U-turn criterion on velocities, checked for every
  aligned power-of-two subtree and for the merged tree after each
  doubling;
- divergence at ΔH > 1000, a non-finite energy taken as +inf.

All C chains run in lockstep, as under the JAX package's `jax.vmap` of its
two `while_loop`s: the loops over depths and over a subtree's leaves are
Python loops over a per-chain `active` mask, and a chain that has stopped
keeps its state (position, momentum, proposal, ρ, checkpoints and random
key) by `torch.where`, as vmap's select does. Depth and leaf index are
shared by the chains that are still running, so the checkpoint slots are
Python integers. Every leaf evaluates all C chains in one `vg_fn` call;
the loops end when no chain is active, read by one `.any()` on the host
per leaf (and one per depth): `SYNCS` counts them.

Spans (utils/profiling.py): `nuts.transition` a `nuts_step`, `nuts.leaf` a
leaf after its host read (leapfrog and tree bookkeeping), `nuts.sync` each
host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portfoliooptgp_tpu_torch.inference.hmc import _col, kinetic, sample_momentum, velocity
from portfoliooptgp_tpu_torch.utils.profiling import span

MAX_DELTA_ENERGY = 1000.0

#: Host reads of the active mask: {"leaf": n, "depth": n}.
SYNCS = {"leaf": 0, "depth": 0}


def _any(mask, kind: str) -> bool:
    """The host's read of whether any chain is live, counted in SYNCS[kind]."""
    SYNCS[kind] += 1
    with span("nuts.sync"):
        return bool(mask.any())


def _ctz(n):
    """Trailing zeros of a positive int, or of each entry of an integer
    tensor (entries < 2^53): the exponent of its lowest set bit."""
    if isinstance(n, torch.Tensor):
        return torch.frexp((n & -n).to(torch.float64)).exponent - 1
    return (n & -n).bit_length() - 1


def _where(mask, new, old):
    """Per-chain select of two (nested) NamedTuples of (C, ...) tensors."""
    if isinstance(new, tuple):
        return type(new)(*(_where(mask, a, b) for a, b in zip(new, old)))
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


class _Leaf(NamedTuple):
    q: torch.Tensor
    p: torch.Tensor
    grad: torch.Tensor
    logp: torch.Tensor
    energy: torch.Tensor


class _SubtreeState(NamedTuple):
    leaf: _Leaf  # integration frontier (last leaf)
    prop_q: torch.Tensor
    prop_logp: torch.Tensor
    prop_grad: torch.Tensor
    log_w: torch.Tensor  # logsumexp of the leaf weights in the subtree
    rho: torch.Tensor  # momentum sum over the subtree
    first_p: torch.Tensor  # momentum of the subtree's first leaf
    sum_accept: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    # checkpoints, (C, max_depth + 1, dim)
    ck_q: torch.Tensor
    ck_p: torch.Tensor
    ck_rho_before: torch.Tensor


def _single_leapfrog(vg_fn, leaf: _Leaf, eps, inv_mass):
    e = _col(eps)
    p_half = leaf.p + 0.5 * e * leaf.grad
    q_new = leaf.q + e * velocity(inv_mass, p_half)
    logp_new, g_new = vg_fn(q_new)  # ONE evaluation for value and gradient
    p_new = p_half + 0.5 * e * g_new
    energy = -logp_new + kinetic(p_new, inv_mass)
    energy = torch.where(torch.isfinite(energy), energy, torch.full_like(energy, float("inf")))
    return _Leaf(q_new, p_new, g_new, logp_new, energy)


def _row_velocity(p, inv_mass):
    """pᵀ M⁻¹ as rows, for (C, K, dim) or (C, dim) momenta (the JAX
    package's `p @ inv_mass`)."""
    if inv_mass.ndim == 3:
        return p @ inv_mass if p.ndim == 3 else (p[:, None, :] @ inv_mass)[:, 0]
    return p * (inv_mass[:, None, :] if p.ndim == 3 else inv_mass)


def _build_subtree(vg_fn, start: _Leaf, depth: int, eps, inv_mass, h0, max_depth: int,
                   key, active):
    """Integrate 2^depth leaves from `start` (exclusive) in the direction of
    the sign of eps, with the streaming multinomial proposal and the
    iterative U-turn checks, for the chains where `active` holds."""
    C, dim = start.q.shape
    dtype, dev = start.q.dtype, start.q.device
    zeros = torch.zeros((C, dim), dtype=dtype, device=dev)
    ck = torch.zeros((C, max_depth + 1, dim), dtype=dtype, device=dev)
    false = torch.zeros((C,), dtype=torch.bool, device=dev)
    st = _SubtreeState(
        leaf=start, prop_q=start.q, prop_logp=start.logp, prop_grad=start.grad,
        log_w=torch.full((C,), float("-inf"), dtype=dtype, device=dev),
        rho=zeros, first_p=zeros, sum_accept=torch.zeros((C,), dtype=dtype, device=dev),
        turning=false, diverging=false, ck_q=ck, ck_p=ck, ck_rho_before=ck)

    for i in range(1 << depth):
        live = active & ~st.turning & ~st.diverging
        if not _any(live, "leaf"):
            break
        with span("nuts.leaf"):
            j = i + 1  # 1-based leaf index within the subtree
            leaf = _single_leapfrog(vg_fn, st.leaf, eps, inv_mass)
            log_w_leaf = h0 - leaf.energy
            diverging = (leaf.energy - h0) > MAX_DELTA_ENERGY
            accept_stat = torch.minimum(torch.ones_like(log_w_leaf), torch.exp(log_w_leaf))

            # this leaf may be the first of a later aligned subtree: park it in
            # slot ctz(j - 1), the subtree's first leaf in the top slot
            slot = max_depth if i == 0 else _ctz(i)
            ck_q, ck_p, ck_rho_before = st.ck_q.clone(), st.ck_p.clone(), st.ck_rho_before.clone()
            ck_q[:, slot] = leaf.q
            ck_p[:, slot] = leaf.p
            ck_rho_before[:, slot] = st.rho

            rho = st.rho + leaf.p
            first_p = leaf.p if i == 0 else st.first_p

            # streaming multinomial proposal
            new_key, k_u = key.split(2)
            log_w_new = torch.logaddexp(st.log_w, log_w_leaf)
            take = torch.log(k_u.uniform(dtype)) < (log_w_leaf - log_w_new)
            prop_q = torch.where(take[:, None], leaf.q, st.prop_q)
            prop_logp = torch.where(take, leaf.logp, st.prop_logp)
            prop_grad = torch.where(take[:, None], leaf.grad, st.prop_grad)

            # U-turn checks of the aligned subtrees ending here, of sizes 2^k
            # for k = 1 .. ctz(j): the first leaf of size 2^k (k < ctz(j)) sits
            # in slot k; that of size 2^ctz(j) in slot ctz(j - 2^ctz(j)), or in
            # the top slot when it is the subtree's first leaf (whose ρ before
            # is 0 and whose p is first_p). The pre-write checkpoints are read.
            tz = min(_ctz(j), max_depth)
            turning = st.turning
            if tz:
                s_last = j - (1 << tz)
                last = max_depth if s_last == 0 else _ctz(s_last)
                rho_before = torch.cat([st.ck_rho_before[:, 1:tz],
                                        st.ck_rho_before[:, last:last + 1]], dim=1)
                p_left = torch.cat([st.ck_p[:, 1:tz], st.ck_p[:, last:last + 1]], dim=1)
                rho_sub = rho[:, None, :] - rho_before  # (C, K, dim)
                v_left = _row_velocity(p_left, inv_mass)
                v_right = _row_velocity(leaf.p, inv_mass)[:, None, :]
                turn_k = ((torch.sum(rho_sub * v_left, dim=-1) < 0)
                          | (torch.sum(rho_sub * v_right, dim=-1) < 0))
                turning = turning | torch.any(turn_k, dim=-1)

            new = _SubtreeState(
                leaf=leaf, prop_q=prop_q, prop_logp=prop_logp, prop_grad=prop_grad,
                log_w=log_w_new, rho=rho, first_p=first_p,
                sum_accept=st.sum_accept + accept_stat,
                turning=turning, diverging=st.diverging | diverging,
                ck_q=ck_q, ck_p=ck_p, ck_rho_before=ck_rho_before)
            st = _where(live, new, st)
            key = new_key.where(live, key)
    return st


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor
    num_leaves: torch.Tensor
    diverging: torch.Tensor
    depth: torch.Tensor


class _Carry(NamedTuple):
    depth: torch.Tensor
    rho: torch.Tensor
    prop_q: torch.Tensor
    prop_logp: torch.Tensor
    prop_grad: torch.Tensor
    log_w: torch.Tensor
    sum_accept: torch.Tensor
    num_leaves: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor


def nuts_step(vg_fn, q, logp, key, step_size, inv_mass, max_depth: int = 10,
              grad0=None, mass_chol_factor=None):
    """One NUTS transition of C chains on flat parameters q (C, dim).
    `vg_fn(q) -> (logp (C,), grad (C, dim))` evaluates value and gradient
    jointly (one call per leapfrog, all chains at once). `key` is a random
    source (inference/source.py); `step_size` a number or (C,). `grad0`
    (optional) is the gradient at q, carried over from the previous
    transition's final leaf so the root needs no evaluation. `inv_mass` is
    a (C, dim) diagonal or (C, dim, dim) dense inverse metric;
    `mass_chol_factor` (optional) caches hmc.mass_chol(inv_mass).
    Returns (q', logp', grad', info)."""
    with span("nuts.transition"):
        C, dim = q.shape
        dtype, dev = q.dtype, q.device
        step = torch.as_tensor(step_size, dtype=dtype, device=dev).expand(C)
        key, k_mom = key.split(2)
        p0 = sample_momentum(k_mom, inv_mass, chol=mass_chol_factor, shape=(dim,), dtype=dtype)
        g0 = grad0 if grad0 is not None else vg_fn(q)[1]
        h0 = -logp + kinetic(p0, inv_mass)
        left = right = _Leaf(q=q, p=p0, grad=g0, logp=logp, energy=h0)
        false = torch.zeros((C,), dtype=torch.bool, device=dev)
        zero = torch.zeros((C,), dtype=dtype, device=dev)
        c = _Carry(depth=torch.zeros((C,), dtype=torch.int64, device=dev), rho=p0, prop_q=q,
                   prop_logp=logp, prop_grad=g0, log_w=zero, sum_accept=zero,
                   num_leaves=torch.zeros((C,), dtype=torch.int64, device=dev),
                   turning=false, diverging=false)

        for depth in range(max_depth):
            active = ~c.turning & ~c.diverging
            if not _any(active, "depth"):
                break
            new_key, k_dir, k_sub, k_merge = key.split(4)
            go_right = k_dir.bernoulli()
            eps = torch.where(go_right, step, -step)
            start = _where(go_right, right, left)
            st = _build_subtree(vg_fn, start, depth, eps, inv_mass, h0, max_depth, k_sub, active)
            bad = st.turning | st.diverging

            # biased progressive merge (only when the subtree is clean)
            take = (torch.log(k_merge.uniform(dtype)) < (st.log_w - c.log_w)) & ~bad
            new_right = _where(go_right & ~bad, st.leaf, right)
            new_left = _where(~go_right & ~bad, st.leaf, left)
            rho = torch.where(bad[:, None], c.rho, c.rho + st.rho)
            full_turn = ((torch.sum(rho * velocity(inv_mass, new_left.p), dim=-1) < 0)
                         | (torch.sum(rho * velocity(inv_mass, new_right.p), dim=-1) < 0))
            new = _Carry(
                depth=c.depth + 1, rho=rho,
                prop_q=torch.where(take[:, None], st.prop_q, c.prop_q),
                prop_logp=torch.where(take, st.prop_logp, c.prop_logp),
                prop_grad=torch.where(take[:, None], st.prop_grad, c.prop_grad),
                log_w=torch.where(bad, c.log_w, torch.logaddexp(c.log_w, st.log_w)),
                sum_accept=c.sum_accept + st.sum_accept,
                num_leaves=c.num_leaves + (1 << depth),
                turning=c.turning | bad | (full_turn & ~bad),
                diverging=c.diverging | st.diverging)
            c = _where(active, new, c)
            left = _where(active, new_left, left)
            right = _where(active, new_right, right)
            key = new_key.where(active, key)

        accept_prob = c.sum_accept / torch.clamp_min(c.num_leaves, 1).to(dtype)
        info = NUTSInfo(accept_prob=accept_prob, num_leaves=c.num_leaves,
                        diverging=c.diverging, depth=c.depth)
        return c.prop_q, c.prop_logp, c.prop_grad, info
