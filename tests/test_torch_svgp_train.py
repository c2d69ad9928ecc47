"""The SVGP trainers of the port against the JAX package, float64 on the CPU:
`MinibatchIterator` (data/iterator.py), `make_elbo_train_step`
(parallel/elbo_sharded.py) with the port's `Adam` against optax's `adam`,
`train_svgp_minibatched`, `train_svgp_menu` (over `train_svgp`)
(train/svgp_trainer.py) and the natural-gradient step (train/natgrad.py).

Tolerances: the iterator's batches are equal; Adam trajectories rtol 1e-8
(the same formula, rounded in another order, over ~10 steps); the L-BFGS
menu at maxiter 5, before rounding differences move the line search,
rtol 1e-7; natural-gradient steps rtol 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.data.iterator import MinibatchIterator as JIterator
from portfoliooptgp_tpu.parallel import elbo_sharded as jes
from portfoliooptgp_tpu.train import natgrad as jng
from portfoliooptgp_tpu.train import svgp_trainer as jtr
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.data.iterator import MinibatchIterator as TIterator
from portfoliooptgp_tpu_torch.parallel import elbo_sharded as tes
from portfoliooptgp_tpu_torch.train import lbfgs as tlbfgs
from portfoliooptgp_tpu_torch.train import natgrad as tng
from portfoliooptgp_tpu_torch.train import svgp_trainer as ttr
from portfoliooptgp_tpu_torch.train.optim import Adam
from test_torch_svgp import data, svgp_pair, t

torch.set_num_threads(1)


def assert_leaves(tmodel, jmodel, rtol, atol=1e-12):
    jl = jax.tree.leaves(jmodel)
    tl = tparams.tree_leaves(tmodel)
    assert len(tl) == len(jl)
    for k, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a.detach().numpy().reshape(np.shape(b)), np.asarray(b),
                                   rtol=rtol, atol=atol, err_msg=f"leaf {k}")


@pytest.mark.parametrize("inner_steps,drop", [(1, False), (8, False), (1, True), (3, True)])
def test_torch_minibatch_iterator_matches_jax(inner_steps, drop):
    """Same seed, same batches: order, padding, weights and tail groups."""
    X = np.arange(100, dtype=np.float64)[:, None]
    Y = np.stack([-X[:, 0], 2 * X[:, 0]], axis=1)
    kw = dict(num_epochs=3, seed=5, inner_steps=inner_steps, drop_remainder=drop)
    with JIterator(X, Y, 16, **kw) as jit_, TIterator(X, Y, 16, device="cpu",
                                                       dtype=torch.float64, **kw) as tit:
        jb, tb = list(jit_), list(tit)
        assert jit_.steps_per_epoch() == tit.steps_per_epoch() and tit.num_data == 100
    assert len(jb) == len(tb) > 0
    for a, b in zip(tb, jb):
        for x, y in zip(a, b):
            assert x.dtype == torch.float64
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_torch_minibatch_iterator_full_aapl_group_tail():
    """The benchmark's stream: N = 10,963 at batch 2048 gives 6 batches per
    epoch (the last with 1,325 weight-0 rows); 10 epochs in groups of 8 are
    7 full groups and a tail of 4 real and 4 all-zero batches."""
    X = np.zeros((10963, 1), np.float32)
    with TIterator(X, X, 2048, num_epochs=10, seed=0, inner_steps=8, device="cpu") as it:
        groups = [w for _, _, w in it]
    assert len(groups) == 8 and all(g.shape == (8, 2048) for g in groups)
    sums = torch.cat([g.sum(dim=1) for g in groups]).tolist()
    assert sums == ([2048.0] * 5 + [10963 - 5 * 2048]) * 10 + [0.0] * 4


@pytest.mark.parametrize("inner_steps", [1, 3])
def test_torch_train_svgp_minibatched_float64_matches_jax(inner_steps):
    """2 epochs of 4 batches (the last partial), Adam(1e-2) from the same
    leaves with the likelihood frozen; inner_steps 3 runs a tail group with
    one all-zero batch, which both skip."""
    jm, tm = svgp_pair("Matern32", M=16, noise=0.1)
    X, Y = data(500, seed=11)
    kw = dict(batch_size=128, num_epochs=2, seed=3, inner_steps=inner_steps)
    jres = jtr.train_svgp_minibatched(jm, jnp.asarray(X), jnp.asarray(Y), **kw)
    tres = ttr.train_svgp_minibatched(tm, X, Y, **kw)
    assert tres.iters == int(jres.iters) == 8
    np.testing.assert_allclose(tres.elbo, float(jres.elbo), rtol=1e-9)
    assert_leaves(tres.model, jres.model, rtol=1e-8)
    assert torch.equal(tres.model.likelihood.raw_variance, tm.likelihood.raw_variance)


def test_torch_make_elbo_train_step_matches_optax():
    """Three single steps of `make_elbo_train_step` with nothing frozen, the
    second on an all-zero-weight batch (still a step at inner_steps = 1, as
    in JAX), against optax's adam; with a mesh of one rank the step is the
    one-device step (JAX's `mesh.size > 1` rule)."""
    jm, tm = svgp_pair(M=8)
    X, Y = data(64, seed=12)
    ws = [np.ones(64), np.zeros(64), (np.arange(64) < 40).astype(float)]
    jinit, jstep = jes.make_elbo_train_step(num_data=300, optimizer=optax.adam(1e-2))
    tinit, tstep = tes.make_elbo_train_step(num_data=300, optimizer=Adam(1e-2))
    js, ts = jinit(jm), tinit(tm)
    for w in ws:
        js, jloss = jstep(js, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(w))
        ts, tloss = tstep(ts, t(X), t(Y), t(w))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-10)
    assert_leaves(ts.model, js.model, rtol=1e-9)
    from portfoliooptgp_tpu_torch.parallel.mesh import make_mesh

    minit, mstep = tes.make_elbo_train_step(num_data=300, mesh=make_mesh(device="cpu"),
                                            optimizer=Adam(1e-2))
    ms = minit(tm)
    for w in ws:
        ms, mloss = mstep(ms, t(X), t(Y), t(w))
    assert float(mloss) == float(tloss)
    assert all(torch.equal(a, b) for a, b in zip(tparams.tree_leaves(ms.model),
                                                 tparams.tree_leaves(ts.model)))


def test_torch_train_svgp_menu_matches_jax():
    """`train_svgp_menu` over two kernels at maxiter 5: each entry is
    `train_svgp` (L-BFGS on the ELBO, likelihood frozen at 1e-4)."""
    _, tm = svgp_pair("SquaredExponential", M=8, noise=0.1)
    X, Y = data(80, seed=13)
    Xs, Ys = data(20, seed=14)
    Z = np.linspace(0, 30, 8)[:, None]
    jmenu = jtr.train_svgp_menu(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Xs), jnp.asarray(Ys),
                                [jk.SquaredExponential.create(1.0, 3.0), jk.Matern12.create()],
                                jnp.asarray(Z), maxiter=5)
    td = dict(device="cpu", dtype=torch.float64)
    tmenu = ttr.train_svgp_menu(t(X), t(Y), t(Xs), t(Ys),
                                [tk.SquaredExponential.create(1.0, 3.0, **td),
                                 tk.Matern12.create(**td)], Z, maxiter=5, device="cpu")
    assert tmenu.best_index == jmenu.best_index
    np.testing.assert_allclose(tmenu.test_mses, jmenu.test_mses, rtol=1e-7)
    assert tmenu.best.iters == int(jmenu.best.iters)
    np.testing.assert_allclose(tmenu.best.elbo, float(jmenu.best.elbo), rtol=1e-9)
    assert_leaves(tmenu.best.model, jmenu.best.model, rtol=1e-7, atol=1e-10)
    frozen = tlbfgs.freeze_leaves(tm, likelihood=True)
    assert tparams.tree_leaves(frozen) == [False, False, True, False, False, False]


@pytest.mark.parametrize("gamma,weighted", [(1.0, False), (0.5, True)])
def test_torch_natgrad_step_float64_matches_jax(gamma, weighted):
    jm, tm = svgp_pair("Matern52", M=12, noise=0.2)
    X, Y = data(60, seed=15)
    w = (np.arange(60) < 50).astype(float) if weighted else None
    kw = dict(num_data=120, gamma=gamma)
    jnew = jax.jit(jng.natgrad_step, static_argnames=("num_data", "gamma"))(
        jm, jnp.asarray(X), jnp.asarray(Y), weights=None if w is None else jnp.asarray(w), **kw)
    tnew = tng.natgrad_step(tm, t(X), t(Y), weights=None if w is None else t(w), **kw)
    np.testing.assert_allclose(tnew.q_mu.numpy(), np.asarray(jnew.q_mu), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(tnew.q_sqrt.numpy(), np.asarray(jnew.q_sqrt), rtol=1e-8,
                               atol=1e-10)


def test_torch_natgrad_train_step_matches_jax():
    """Two steps of natural gradient + Adam on the hyperparameters."""
    jm, tm = svgp_pair(M=8, noise=0.2)
    X, Y = data(50, seed=16)
    jinit, jstep = jng.make_natgrad_train_step(50, optax.adam(1e-2), gamma=0.1)
    tinit, tstep = tng.make_natgrad_train_step(50, Adam(1e-2), gamma=0.1)
    js, ts = jinit(jm), tinit(tm)
    for _ in range(2):
        js, jloss = jstep(js, jnp.asarray(X), jnp.asarray(Y))
        ts, tloss = tstep(ts, t(X), t(Y))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-9)
    assert_leaves(ts.model, js.model, rtol=1e-8, atol=1e-10)
