"""Rank bodies of the port's multi-rank tests (tests/test_torch_parallel.py
and test_torch_dist_cholesky.py).

The tests start ranks with `parallel.distributed.spawn` on the CPU (gloo,
float64, one thread a rank): the children import this module by name, so
it imports torch, numpy and the port only (no JAX, no conftest). Inputs
come in one `torch.save` file that the test writes, with the JAX package's
parameters; each rank writes what it computed to `rank<r>.pt` in the
output directory, and the test holds that against the JAX package.

`RemoteKeys` is a random source (portfoliooptgp_tpu_torch/inference/
source.py) whose `jax.random` keys live in the test process: each draw is
a request over a pipe, answered there by tests/jax_replay.JaxKeys, so a
rank draws exactly what the JAX package's shard draws from the same key.
"""

import contextlib
import os

import numpy as np
import torch

from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.models import gpr as tgpr
from portfoliooptgp_tpu_torch.models.likelihoods import Gaussian
from portfoliooptgp_tpu_torch.models.svgp import SVGP
from portfoliooptgp_tpu_torch.parallel import mesh as mesh_mod

CPU64 = dict(device="cpu", dtype=torch.float64)


class RemoteKeys:
    """C chains' keys, held as `key_id` by the test process at the other end
    of `conn` (the source interface of inference/source.py)."""

    def __init__(self, conn, key_id=0):
        self.conn, self.key_id = conn, key_id

    def _ask(self, *msg):
        self.conn.send(msg)
        return self.conn.recv()

    def split(self, n):
        return [RemoteKeys(self.conn, k) for k in self._ask("split", self.key_id, n)]

    def normal(self, shape, dtype):
        return torch.from_numpy(self._ask("normal", self.key_id, tuple(shape), str(dtype)))

    def uniform(self, dtype=None):
        return torch.from_numpy(self._ask("uniform", self.key_id,
                                          None if dtype is None else str(dtype)))

    def bernoulli(self):
        return torch.from_numpy(self._ask("bernoulli", self.key_id))

    def where(self, active, old):
        return RemoteKeys(self.conn, self._ask("where", self.key_id, active.numpy(), old.key_id))


def _save(out_dir, rank, result):
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def _leaves(model):
    return [x.detach().clone() for x in tparams.tree_leaves(model)]


def svgp_model(Z, leaves, noise=0.05):
    """The port's SVGP(SE, Gaussian, Zero) on inducing inputs Z with the JAX
    model's leaves."""
    template = SVGP.create(tk.SquaredExponential.create(**CPU64), Z,
                           likelihood=Gaussian.create(noise, **CPU64), **CPU64)
    return tparams.from_jax_leaves(template, leaves)


def _value_and_grads(fn, model):
    live = [x.detach().requires_grad_(True) for x in tparams.tree_leaves(model)]
    value = fn(tparams.tree_replace(model, live))
    return float(value.detach()), [g.detach() for g in torch.autograd.grad(value, live)]


def parallel_checks(rank, world, in_path, out_dir, conns):
    """tests/test_torch_parallel.py's checks at one world size."""
    from portfoliooptgp_tpu_torch.data.iterator import MinibatchIterator
    from portfoliooptgp_tpu_torch.inference import hmc, sample_nuts
    from portfoliooptgp_tpu_torch.inference import centered_normal_logprior
    from portfoliooptgp_tpu_torch.parallel import elbo_sharded
    from portfoliooptgp_tpu_torch.pipelines import walk_forward as twf
    from portfoliooptgp_tpu_torch.portfolio.montecarlo import (
        probability_a_greater_than_b_mvnorm_sharded,
    )
    from portfoliooptgp_tpu_torch.train import lbfgs, svgp_trainer
    from portfoliooptgp_tpu_torch.train.optim import Adam

    torch.set_num_threads(1)
    inp = torch.load(in_path, weights_only=False)
    out = {}
    mesh = mesh_mod.make_mesh(device="cpu")  # every rank on the data axis
    d = mesh.index(mesh_mod.DATA_AXIS)

    # the sharded ELBO: value, padding, gradients
    s = inp["svgp"]
    model = mesh_mod.replicate(mesh, svgp_model(s["Z"], s["leaves"]))
    for n in (64, 63):
        Xs, Ys, w = elbo_sharded.prepare_global_batch(mesh, s["X"][:n], s["Y"][:n])
        out[f"elbo{n}_rows"] = (Xs.shape[0], float(torch.sum(w)))
        out[f"elbo{n}"], grads = _value_and_grads(
            lambda m: elbo_sharded.sharded_neg_elbo(m, Xs, Ys, w, n, mesh), model)
        if n == 64:
            out["elbo_grads"] = grads

    # train steps: one step, a loss that falls, 60 steps equal on every rank
    Xs, Ys, w = elbo_sharded.prepare_global_batch(mesh, s["X"], s["Y"])
    init_fn, step_fn = elbo_sharded.make_elbo_train_step(64, mesh=mesh)
    state, loss = step_fn(init_fn(model), Xs, Ys, w)
    out["step1"] = (float(loss), _leaves(state.model))
    init_fn, step_fn = elbo_sharded.make_elbo_train_step(64, mesh=mesh, optimizer=Adam(5e-2))
    state, first = step_fn(init_fn(model), Xs, Ys, w)
    for _ in range(59):
        state, loss = step_fn(state, Xs, Ys, w)
        if _ == 29:
            out["loss_after_31"] = (float(first), float(loss))
    out["step60"] = _leaves(state.model)

    # the mesh feed and minibatched training on it
    f = inp["feed"]
    for k in (1, 3):
        with MinibatchIterator(f["X"], f["Y"], 40, mesh=mesh, num_epochs=1, seed=1,
                               inner_steps=k, dtype=torch.float64) as it:
            out[f"feed{k}"] = [tuple(a.clone() for a in b) for b in it]
    try:
        MinibatchIterator(f["X"], f["Y"], 4 * world + 1, mesh=mesh)
        out["feed_raises"] = False
    except ValueError:
        out["feed_raises"] = True
    fm = svgp_model(f["Z"], f["leaves"], noise=1e-2)
    res = svgp_trainer.train_svgp_minibatched(fm, f["X"], f["Y"], batch_size=40, num_epochs=2,
                                              mesh=mesh, seed=3)
    out["minibatched"] = (res.elbo, res.iters, _leaves(res.model))

    # the sharded MC estimate: JAX's fold-in draws, then the rank's own stream
    mc = inp["mc"]
    args = (mc["mu_a"], mc["cov"], mc["mu_b"], mc["cov"], mesh, mc["n"])
    out["mc_replay"] = probability_a_greater_than_b_mvnorm_sharded(
        *args, draws=mc["draws"][d], dtype=torch.float64)
    out["mc_stream"] = [probability_a_greater_than_b_mvnorm_sharded(*args, dtype=torch.float64)
                        for _ in range(2)]

    # Welford moments pooled across ranks (and chains)
    wf = inp["welford"]
    for dense in (False, True):
        st = hmc.welford_init(wf["xs"].shape[-1], torch.float64, dense=dense,
                              chains=wf["xs"].shape[2], device="cpu")
        for x in wf["xs"][d]:
            st = hmc.welford_update(st, x)
        for pool in (False, True):
            out[f"welford_{dense}_{pool}"] = hmc.welford_variance(
                st, mesh_mod.DATA_AXIS, pool=pool, mesh=mesh)

    # cross-rank NUTS, each rank on its JAX shard key (held by the test)
    nu = inp["nuts"]
    tm0 = tparams.from_jax_leaves(
        tgpr.GPR.create(tk.SquaredExponential.create(1.0, [1.0, 1.0], **CPU64),
                        noise_variance=0.1), nu["leaves"])
    prior = centered_normal_logprior(tm0)

    def logp(m):
        return -tgpr.batched_neg_log_marginal_likelihood(m, nu["X"], nu["Y"], **CPU64) + prior(m)

    samples, stats = sample_nuts(logp, tm0, RemoteKeys(conns[rank]), axis_name=mesh_mod.DATA_AXIS,
                                 mesh=mesh, **nu["args"])
    conns[rank].send(("close",))
    out["nuts"] = ([x.clone() for x in tparams.tree_leaves(samples)], stats._asdict())

    # the restart axis: batched L-BFGS restarts and the walk-forward
    rmesh = mesh_mod.make_mesh(data=1, restart=world, device="cpu")
    r = inp["restarts"]
    stacked = lbfgs.stack_pytrees([
        tgpr.GPR.create(tk.SquaredExponential.create(variance=v, **CPU64), noise_variance=0.05)
        for v in r["variances"]])
    local = tparams.tree_map(lambda x: mesh_mod.shard_rows(rmesh, x, mesh_mod.RESTART_AXIS),
                             stacked)
    fit = lbfgs.fit_batched(lambda mo: tgpr.neg_log_marginal_likelihood(mo, r["X"], r["Y"]),
                            local, maxiter=r["maxiter"])
    out["restart_losses"] = mesh_mod.all_gather(fit.loss, rmesh, mesh_mod.RESTART_AXIS)
    w = inp["walk"]
    res = twf.batched_walk_forward(
        w["X"], w["Y"], w["n_train"], lambda v: tgpr.GPR.create(tk.composite_kernel(2, **CPU64), v),
        mesh=rmesh, mesh_axis=mesh_mod.RESTART_AXIS, dtype=torch.float64, **w["kw"])
    out["walk"] = dict(losses=res.losses, f_mean=res.f_mean, f_var=res.f_var,
                       leaves=_leaves(res.models))
    try:
        twf.batched_walk_forward(
            w["X"], w["Y"], w["n_train"],
            lambda v: tgpr.GPR.create(tk.composite_kernel(2, **CPU64), v), n_days=3,
            mesh=rmesh, dtype=torch.float64, maxiter=1)
        out["walk_raises"] = False
    except ValueError:
        out["walk_raises"] = True
    _save(out_dir, rank, out)


def dist_cholesky_checks(rank, world, in_path, out_dir):
    """tests/test_torch_dist_cholesky.py's checks at one world size."""
    from portfoliooptgp_tpu_torch.parallel import dist_cholesky as dc

    torch.set_num_threads(1)
    inp = torch.load(in_path, weights_only=False)
    out = {}
    mesh = mesh_mod.make_mesh(device="cpu")
    half = mesh_mod.make_mesh(data=world // 2, restart=2, device="cpu")

    def run(K, y, m, nb, layout, grads):
        Kl = dc.shard_rows(K, m, nb, layout).requires_grad_(grads)
        yl = dc.shard_rows(y, m, nb, layout).requires_grad_(grads)
        noise = torch.tensor(inp["noise"], dtype=torch.float64, requires_grad=grads)
        nll = dc.sharded_gpr_nll(Kl, yl, noise, m, block_size=nb, layout=layout)
        if not grads:
            return float(nll)
        dK, dy, dn = torch.autograd.grad(nll, (Kl, yl, noise))
        return (float(nll.detach()), dc.gather_rows(dK, m, nb, layout),
                dc.gather_rows(dy, m, nb, layout), float(dn))

    K, y = inp["K"], inp["Y"]
    for layout in dc.LAYOUTS:
        for nb in (16, 32, 64):
            out[f"value_{layout}_{nb}"] = run(K, y, mesh, nb, layout, nb == 32)
    out["value_half"] = run(K, y, half, 64, "contiguous", False)
    out["fast"] = run(inp["K64"], inp["Y64"], mesh, 8, "contiguous", True)

    # one gradient through K(X; θ): each rank builds its rows, θ replicated
    kern = tparams.from_jax_leaves(tk.SquaredExponential.create(**CPU64), inp["kernel_leaves"])
    live = [x.detach().requires_grad_(True) for x in tparams.tree_leaves(kern)]
    local = tparams.tree_replace(kern, mesh_mod.replicated_input(live, half))
    X = inp["X"]
    Xl = dc.shard_rows(X, half, 64)
    nll = dc.sharded_gpr_nll(local.K(Xl, X)[0], dc.shard_rows(y, half, 64), inp["noise"], half,
                             block_size=64)
    out["theta_grads"] = [g.detach() for g in torch.autograd.grad(nll, live)]

    errors = []
    for K_, y_, nb in ((K[:500, :500], y[:500], 32), (K, y, 48)):
        try:
            dc.sharded_gpr_nll(dc.shard_rows(K_, mesh, 1), dc.shard_rows(y_, mesh, 1), 0.05,
                               mesh, block_size=nb)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["shape_errors"] = errors
    _save(out_dir, rank, out)


def cli_main(rank, world, argv, out_dir):
    """The port's CLI on every rank, its standard output to rank<r>.txt."""
    from portfoliooptgp_tpu_torch import cli

    torch.set_num_threads(1)
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as fh, \
            contextlib.redirect_stdout(fh):
        cli.main(list(argv))


def load_ranks(out_dir, world):
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def as_numpy(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)
