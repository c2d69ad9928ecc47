"""A dry run of every multi-rank path on tiny shapes.

Port of `dryrun_multichip` (the JAX package's `__graft_entry__.py:54-200`).
`dryrun_multichip(n)` spawns n ranks (parallel/distributed.py's `spawn`)
on a (data, restart) mesh — restart 2 when n is even and above 1 — and
runs its six checks as the ranks' code:

  1. one Adam step of the data-sharded SVGP ELBO (`make_elbo_train_step`
     with the mesh) on the flagship SE + Periodic(SE) model;
  2. batched GPR restarts split over the restart axis (`lbfgs.fit_batched`
     on each rank's rows);
  3. the block-cyclic distributed Cholesky NLL and its closed-form
     gradients (`sharded_gpr_nll`, layout "cyclic");
  4. NUTS with one chain per data shard, the warmup adaptation pooled
     over the data axis (`sample_nuts(axis_name="data", mesh=...)`);
  5. the walk-forward refit with its day×restart rows split over the
     restart axis (`batched_walk_forward(mesh=..., mesh_axis="restart")`);
  6. the portfolio horizon solve, replicated (`batched_eval.solve_horizon`).

Each check asserts finite results; rank 0 prints one summary line and the
call returns its numbers. `checks` is the ranks' code, for a caller whose
ranks already run (chip_smoke.py's phase 13).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE


def _flagship(n, m, device, dtype):
    from portfoliooptgp_tpu_torch import kernels as km
    from portfoliooptgp_tpu_torch.models import svgp
    from portfoliooptgp_tpu_torch.models.likelihoods import Gaussian

    o = dict(device=device, dtype=dtype)
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 360, size=(n, 1)), axis=0)
    Y = np.sin(X / 30.0) + 0.1 * rng.normal(size=(n, 1))
    kern = km.SquaredExponential.create(**o) + km.Periodic.create(
        km.SquaredExponential.create(**o), period=30.0, **o)
    model = svgp.SVGP.create(kern, np.linspace(0, 360, m)[:, None],
                             likelihood=Gaussian.create(1e-2, **o), **o)
    return model, torch.tensor(X, **o), torch.tensor(Y, **o)


def _finite(*xs) -> bool:
    return all(bool(torch.all(torch.isfinite(torch.as_tensor(x)))) for x in xs)


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def checks(rank, world, out_dir=None, dtype=DEFAULT_DTYPE, device=DEFAULT_DEVICE) -> dict:
    """The six checks as one rank's code, in a process whose default group
    is initialized (`world` ranks); returns the summary, which rank 0 also
    writes to `out_dir`/dryrun.json when `out_dir` is given."""
    from portfoliooptgp_tpu_torch import kernels as km
    from portfoliooptgp_tpu_torch.inference import centered_normal_logprior, sample_nuts
    from portfoliooptgp_tpu_torch.models import gpr as gpr_mod
    from portfoliooptgp_tpu_torch.params import tree_map
    from portfoliooptgp_tpu_torch.parallel import dist_cholesky, elbo_sharded
    from portfoliooptgp_tpu_torch.parallel import mesh as mesh_mod
    from portfoliooptgp_tpu_torch.pipelines import walk_forward as wf
    from portfoliooptgp_tpu_torch.portfolio import batched_eval
    from portfoliooptgp_tpu_torch.train import lbfgs
    from portfoliooptgp_tpu_torch.train.optim import Adam

    restart = 2 if world % 2 == 0 and world > 1 else 1
    mesh = mesh_mod.make_mesh(data=world // restart, restart=restart, device=device)
    dev = mesh.device
    o = dict(device=dev, dtype=dtype)

    # 1. the data-sharded ELBO step (8 rows a rank, at least the 24 that
    # the checks below read)
    model, X, Y = _flagship(8 * max(world, 3), 8, dev, dtype)
    model = mesh_mod.replicate(mesh, model)
    Xs, Ys, w = elbo_sharded.prepare_global_batch(mesh, X, Y)
    init_fn, step_fn = elbo_sharded.make_elbo_train_step(num_data=X.shape[0], mesh=mesh,
                                                        optimizer=Adam(1e-2))
    _, loss = step_fn(init_fn(model), Xs, Ys, w)
    _check(_finite(loss), "distributed step produced non-finite loss")

    # 2. restart-axis batched GPR fits
    models = [gpr_mod.GPR.create(km.SquaredExponential.create(variance=v, **o),
                                 noise_variance=0.1) for v in np.geomspace(0.3, 3.0, 2 * restart)]
    local = tree_map(lambda x: mesh_mod.shard_rows(mesh, x, mesh_mod.RESTART_AXIS),
                     lbfgs.stack_pytrees(models))
    res = lbfgs.fit_batched(lambda mo: gpr_mod.neg_log_marginal_likelihood(mo, X[:16], Y[:16]),
                            local, maxiter=3)
    restart_losses = mesh_mod.all_gather(res.loss, mesh, mesh_mod.RESTART_AXIS)
    _check(_finite(restart_losses), "restart batch non-finite")

    # 3. the block-cyclic distributed Cholesky NLL and its gradients
    n_data, bs = mesh.shape[mesh_mod.DATA_AXIS], 8
    Ng = 2 * bs * n_data
    rng = np.random.default_rng(1)
    A = torch.tensor(rng.normal(size=(Ng, Ng)) / np.sqrt(Ng), **o)
    Kg = A @ A.T + 0.5 * torch.eye(Ng, **o)
    yg = torch.tensor(rng.normal(size=(Ng, 1)), **o)
    Kl = dist_cholesky.shard_rows(Kg, mesh, bs, "cyclic").requires_grad_(True)
    yl = dist_cholesky.shard_rows(yg, mesh, bs, "cyclic").requires_grad_(True)
    noise = torch.tensor(0.1, **o).requires_grad_(True)
    nll = dist_cholesky.sharded_gpr_nll(Kl, yl, noise, mesh, block_size=bs, layout="cyclic")
    grads = torch.autograd.grad(nll, (Kl, yl, noise))
    _check(_finite(nll.detach(), *grads), "dist_cholesky NLL/grad non-finite")

    # 4. NUTS, one chain per data shard, adaptation pooled over the data axis
    X16, Y16 = X[:16], Y[:16]
    init = gpr_mod.GPR.create(km.SquaredExponential.create(**o), noise_variance=0.1)
    prior = centered_normal_logprior(init)

    def logdensity(m):
        return -gpr_mod.batched_neg_log_marginal_likelihood(m, X16, Y16, **o) + prior(m)

    gen = torch.Generator(device=dev).manual_seed(
        mesh_mod.stream_seed(0, mesh.index(mesh_mod.DATA_AXIS)))
    samples, stats = sample_nuts(logdensity, init, gen, num_warmup=4, num_samples=2,
                                 num_chains=1, max_depth=4, axis_name=mesh_mod.DATA_AXIS,
                                 mesh=mesh)
    lv_draws = mesh_mod.all_gather(samples.kernel.raw_variance, mesh, mesh_mod.DATA_AXIS)
    accepts = mesh_mod.all_gather(stats.accept_prob, mesh, mesh_mod.DATA_AXIS)
    _check(lv_draws.shape[0] == n_data and _finite(lv_draws), "sharded NUTS draws non-finite")

    # 5. the walk-forward refit, day×restart rows over the restart axis
    n_restart = mesh.shape[mesh_mod.RESTART_AXIS]
    wf_res = wf.batched_walk_forward(
        X[:24], Y[:24], n_train=20, n_days=2 * n_restart,
        make_model=lambda v: gpr_mod.GPR.create(km.SquaredExponential.create(**o),
                                                noise_variance=v),
        restart_noise_inits=(1e-3,), maxiter=3, mesh=mesh, mesh_axis=mesh_mod.RESTART_AXIS,
        dtype=dtype)
    _check(_finite(wf_res.f_mean, wf_res.losses), "sharded walk-forward non-finite")

    # 6. the horizon solve, replicated
    Dh, Ah = 5, 5
    rngp = np.random.default_rng(2)
    Wh, _, _ = batched_eval.solve_horizon(
        "sharpe", rngp.normal(0.003, 0.01, size=(Dh, Ah)), rngp.uniform(1e-4, 4e-4, size=(Dh, Ah)),
        np.full((Ah,), 1.0 / Ah), 0.0, 0.0, 0.0, 5e-4, 0.02, 0.001, **o)
    _check(_finite(Wh) and bool(torch.all(torch.abs(torch.sum(Wh, dim=1) - 1.0) < 1e-4)),
           "mesh horizon solve invalid weights")

    summary = dict(mesh=dict(mesh.shape), elbo_step_loss=float(loss),
                   restart_losses=restart_losses.tolist(), dist_chol_nll=float(nll.detach()),
                   nuts_chains=int(n_data), mean_accept=float(torch.mean(accepts)),
                   walk_forward_days=int(wf_res.f_mean.shape[0]), horizon_weights_ok=True,
                   device=str(dev))
    if rank == 0 and out_dir is not None:
        with open(os.path.join(out_dir, "dryrun.json"), "w") as fh:
            json.dump(summary, fh)
    return summary


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE, backend=None,
                     dtype=DEFAULT_DTYPE) -> dict:
    """Spawn `n_devices` ranks on `device` ("cuda": rank i on card i mod the
    card count; "cpu") with `backend` (nccl on a card, gloo on the CPU by
    default; two ranks on one card need "gloo") and run the six checks.
    On a card, the CUDA kernels are built here first, once for all ranks.
    Returns rank 0's summary; raises if a rank fails."""
    from portfoliooptgp_tpu_torch.device import resolve_device
    from portfoliooptgp_tpu_torch.parallel.distributed import spawn

    if resolve_device(device).type == "cuda":
        from portfoliooptgp_tpu_torch.ops import cuda_build

        cuda_build.build()
    out_dir = tempfile.mkdtemp(prefix="pgp-dryrun-")
    try:
        spawn(checks, n_devices, out_dir, dtype, torch.device(device).type, device=device,
              backend=backend)
        with open(os.path.join(out_dir, "dryrun.json")) as fh:
            summary = json.load(fh)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"dryrun_multichip({n_devices}): mesh={summary['mesh']} "
          f"elbo_step_loss={summary['elbo_step_loss']:.4f} restart_losses_finite=True "
          f"dist_chol_nll={summary['dist_chol_nll']:.4f} "
          f"nuts_chains={summary['nuts_chains']} mean_accept={summary['mean_accept']:.2f} "
          f"walk_forward_days={summary['walk_forward_days']} horizon_weights_ok=True")
    return summary
