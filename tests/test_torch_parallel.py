"""The port's parallel/ (mesh, sharded ELBO, train step, mesh feed, restart
sharding, sharded MC, cross-rank NUTS and Welford, `svgp --mesh`) against
the JAX package on the virtual CPU mesh, at world sizes 2 and 4, float64.

The port's ranks are processes (gloo on the CPU, one thread each) started
once per world size by a module fixture; their bodies are in
tests/torch_ranks.py, which imports no JAX. The JAX references run here on
a mesh of the same number of virtual devices. Random streams differ by
design (each rank draws from its own source), so parity comes from
replaying JAX's keys: the sharded MC takes each shard's
`fold_in(PRNGKey(seed), index)` draws through `draws=`, and each rank's
NUTS draws through a source whose keys this process holds
(torch_ranks.RemoteKeys, served by tests/jax_replay.JaxKeys).

Tolerances: the sharded ELBO value rtol 1e-10 and its gradients 1e-9; one
step on the mesh against one step on one device rtol 1e-10 (loss) and
JAX's 1e-7 (leaves); the mesh feed exact; minibatched training rtol 1e-8;
restart fits and the walk-forward equal to the port's unsharded run at
rtol 1e-12 and to JAX at the walk-forward tests' tolerances; MC hits
exact; NUTS samples and adapted metric rtol 1e-8; Welford rtol 1e-12.
"""

import json
import math
import multiprocessing
import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks
from jax.sharding import PartitionSpec as P
from jax_replay import JaxKeys, SmallGPRPosterior

from benchmarks.bench_portfolio_e2e import ASSETS, DATES, make_market
from portfoliooptgp_tpu import cli as jcli
from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.data.iterator import MinibatchIterator as JIterator
from portfoliooptgp_tpu.inference import hmc as jhmc
from portfoliooptgp_tpu.inference import sample_nuts as jsample
from portfoliooptgp_tpu.models import gpr as jgpr
from portfoliooptgp_tpu.models import svgp as jsvgp
from portfoliooptgp_tpu.models.likelihoods import Gaussian as JGaussian
from portfoliooptgp_tpu.parallel import elbo_sharded as jes
from portfoliooptgp_tpu.parallel import mesh as jmesh_mod
from portfoliooptgp_tpu.params import positive as j_positive
from portfoliooptgp_tpu.pipelines import walk_forward as jwf
from portfoliooptgp_tpu.portfolio import montecarlo as jmc
from portfoliooptgp_tpu.train import lbfgs as jlbfgs
from portfoliooptgp_tpu.train import svgp_trainer as jtr
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.models import gpr as tgpr
from portfoliooptgp_tpu_torch.models import svgp as tsvgp
from portfoliooptgp_tpu_torch.parallel import distributed, elbo_sharded as tes
from portfoliooptgp_tpu_torch.parallel import mesh as tmesh
from portfoliooptgp_tpu_torch.pipelines import walk_forward as twf
from portfoliooptgp_tpu_torch.portfolio import montecarlo as tmc
from portfoliooptgp_tpu_torch.train import lbfgs as tlbfgs

torch.set_num_threads(1)

WORLDS = (2, 4)
CPU64 = torch_ranks.CPU64
NUTS_ARGS = dict(num_warmup=10, num_samples=10, num_chains=2, max_depth=6)
MC = dict(mu_a=np.array([0.01, 0.012, 0.008]), mu_b=np.array([0.008, 0.009, 0.007]),
          cov=1e-4 * (0.5 * np.eye(3) + 0.5), n=40_000)
WALK_KW = dict(restart_noise_inits=(1e-3, 1e-1), maxiter=100)
RESTART_VARIANCES = np.geomspace(0.1, 10.0, 8)
RESTART_MAXITER = 20


def _jmesh(data, restart=1):
    return jmesh_mod.make_mesh(data=data, restart=restart,
                               devices=jax.devices()[:data * restart])


def _leaves(jmodel):
    return [np.asarray(x) for x in jax.tree.leaves(jmodel)]


def _svgp_problem():
    """tests/test_parallel.py's setup: 64 rows, SE, 12 inducing points."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 6, size=(64, 1)), axis=0)
    Y = np.sin(X) + 0.1 * rng.normal(size=(64, 1))
    jm = jsvgp.SVGP.create(jk.SquaredExponential.create(),
                           inducing_points=np.linspace(0, 6, 12)[:, None],
                           likelihood=JGaussian.create(0.05))
    return X, Y, jm


def _feed_problem():
    """tests/test_iterator.py's data and model: 100 rows, 12 inducing points."""
    rng = np.random.default_rng(0)
    X = np.linspace(0, 10, 100)[:, None]
    Y = np.sin(X) + 0.1 * rng.normal(size=(100, 1))
    jm = jsvgp.SVGP.create(jk.SquaredExponential.create(),
                           inducing_points=jnp.asarray(np.linspace(0, 10, 12)[:, None]),
                           likelihood=JGaussian.create(1e-2))
    return X, Y, jm


def _series(n=40, seed=0):
    """tests/test_torch_walk_forward.py's series."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 8, n)
    X = np.column_stack([np.sin(t) + 0.1 * rng.normal(size=n), t])
    Y = (np.sin(t) + 0.08 * rng.normal(size=n))[:, None]
    return X, Y


def _serve(conn, keys):
    """Answer one rank's RemoteKeys requests from `keys` (id → JaxKeys)."""
    dtypes = {"torch.float64": torch.float64, "torch.float32": torch.float32}
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        op = msg[0]
        if op == "close":
            return
        k = keys[msg[1]]
        if op == "split":
            ids = []
            for sub in k.split(msg[2]):
                keys[len(keys)] = sub
                ids.append(len(keys) - 1)
            conn.send(ids)
        elif op == "normal":
            conn.send(k.normal(msg[2], dtypes[msg[3]]).numpy())
        elif op == "uniform":
            conn.send(k.uniform(None if msg[2] is None else dtypes[msg[2]]).numpy())
        elif op == "bernoulli":
            conn.send(k.bernoulli().numpy())
        elif op == "where":
            keys[len(keys)] = k.where(torch.from_numpy(msg[2]), keys[msg[3]])
            conn.send(len(keys) - 1)


def _inputs(world):
    """(what the ranks read, the JAX keys each rank's NUTS replays)."""
    X, Y, jm = _svgp_problem()
    Xf, Yf, jmf = _feed_problem()
    local = -(-MC["n"] // world)
    draws = []
    for d in range(world):
        ka, kb = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), d))
        draws.append(tuple(np.asarray(jax.random.normal(k, (local, 3), jnp.float64))
                           for k in (ka, kb)))
    post = SmallGPRPosterior()
    keys = jax.random.split(jax.random.PRNGKey(11), world)
    Xw, Yw = _series()
    inputs = dict(
        svgp=dict(X=X, Y=Y, Z=np.linspace(0, 6, 12)[:, None], leaves=_leaves(jm)),
        feed=dict(X=Xf, Y=Yf, Z=np.linspace(0, 10, 12)[:, None], leaves=_leaves(jmf)),
        mc=dict(MC, draws=draws),
        welford=dict(xs=torch.tensor(_welford_draws(world))),
        nuts=dict(X=post.tX, Y=post.tY, leaves=_leaves(post.jm0), args=NUTS_ARGS),
        restarts=dict(X=torch.tensor(X), Y=torch.tensor(Y), variances=RESTART_VARIANCES,
                      maxiter=RESTART_MAXITER),
        walk=dict(X=Xw, Y=Yw, n_train=36, kw=WALK_KW))
    return inputs, [JaxKeys.split_from(keys[d], NUTS_ARGS["num_chains"]) for d in range(world)]


def _welford_draws(world):
    """(world, 7 draws, 3 chains, dim 2)."""
    return np.random.default_rng(4).normal(size=(world, 7, 3, 2)) * np.array([1.0, 3.0])


def _references(world, shared):
    """JAX's results on a mesh of `world` virtual devices. The restart fits
    and the walk-forward of JAX do not depend on how many devices its
    restart axis has (tests/test_parallel.py holds its sharded fit to its
    unsharded one): they run once, on the first world's mesh, and are kept
    in `shared`."""
    jm_ = _jmesh(world)
    refs = {}
    X, Y, jm = _svgp_problem()
    for n in (64, 63):
        Xs, Ys, w = jes.prepare_global_batch(jm_, jnp.asarray(X[:n]), jnp.asarray(Y[:n]))
        value, grads = jax.jit(jax.value_and_grad(
            lambda m, Xs, Ys, w: jes.sharded_neg_elbo(m, Xs, Ys, w, n, jm_)))(jm, Xs, Ys, w)
        refs[f"jax_elbo{n}"] = float(value)
        if n == 64:
            refs["jax_grads"] = _leaves(grads)
    Xs, Ys, w = jes.prepare_global_batch(jm_, jnp.asarray(X), jnp.asarray(Y))
    init_fn, step_fn = jes.make_elbo_train_step(64, mesh=jm_)
    state, loss = step_fn(init_fn(jm), Xs, Ys, w)
    refs["jax_step1"] = (float(loss), _leaves(state.model))

    Xf, Yf, jmf = _feed_problem()
    for k in (1, 3):
        with JIterator(Xf, Yf, 40, mesh=jm_, num_epochs=1, seed=1, inner_steps=k) as it:
            refs[f"jax_feed{k}"] = [tuple(np.asarray(a) for a in b) for b in it]
    res = jtr.train_svgp_minibatched(jmf, jnp.asarray(Xf), jnp.asarray(Yf), batch_size=40,
                                     num_epochs=2, mesh=jm_, seed=3)
    refs["jax_minibatched"] = (float(res.elbo), int(res.iters), _leaves(res.model))

    refs["jax_mc"] = jmc.probability_a_greater_than_b_mvnorm_sharded(
        MC["mu_a"], MC["cov"], MC["mu_b"], MC["cov"], jm_, num_samples=MC["n"])

    xs = jnp.asarray(_welford_draws(world))
    for dense in (False, True):
        for pool in (False, True):
            axes = ("c", "data") if pool else "data"

            def shard(x, dense=dense, axes=axes):
                wf = jax.vmap(lambda _: jhmc.welford_init(2, jnp.float64, dense=dense))(
                    jnp.arange(3))
                for t in range(7):
                    wf = jax.vmap(jhmc.welford_update)(wf, x[0, t])
                var = jax.vmap(lambda s: jhmc.welford_variance(s, axis_name=axes),
                               axis_name="c")(wf)
                return var[None]

            refs[f"jax_welford_{dense}_{pool}"] = np.asarray(jax.jit(jax.shard_map(
                shard, mesh=jm_, in_specs=P("data"), out_specs=P("data"),
                check_vma=False))(xs))

    post = SmallGPRPosterior()
    keys = jax.random.split(jax.random.PRNGKey(11), world)

    def one_shard(k):
        s, st = jsample(post.jlogp_model, post.jm0, k[0], axis_name="data", **NUTS_ARGS)
        return jax.tree.map(lambda x: x[None], (s, st))

    refs["jax_nuts"] = jax.jit(jax.shard_map(one_shard, mesh=jm_, in_specs=P("data"),
                                             out_specs=P("data"), check_vma=False))(keys)
    if not shared:
        shared.update(_restart_references(world, X, Y, *_series()))
    refs.update(shared)
    return refs


def _restart_references(world, X, Y, Xw, Yw):
    refs = {}
    rm = _jmesh(1, world)
    stacked = jlbfgs.stack_pytrees([
        jgpr.GPR.create(jk.SquaredExponential.create(variance=v), noise_variance=0.05)
        for v in RESTART_VARIANCES])
    stacked = jax.tree.map(lambda x: jax.device_put(x, jax.NamedSharding(rm, P("restart"))),
                           stacked)
    refs["jax_restart_losses"] = np.asarray(jlbfgs.fit_batched(
        lambda mo: jgpr.neg_log_marginal_likelihood(mo, jnp.asarray(X), jnp.asarray(Y)),
        stacked, maxiter=RESTART_MAXITER).loss)
    refs["jax_walk"] = jax.jit(lambda X, Y: jwf.batched_walk_forward(
        X, Y, 36, lambda v: jgpr.GPR.create(jk.composite_kernel(2), v), mesh=rm,
        mesh_axis="restart", **WALK_KW))(jnp.asarray(Xw), jnp.asarray(Yw))
    return refs


class _Ranks:
    """One world's ranks, started on a thread (so that JAX's references are
    computed meanwhile), each rank's NUTS keys served from here."""

    def __init__(self, world, out_dir):
        inputs, keys = _inputs(world)
        torch.save(inputs, out_dir / "in.pt")
        ctx = multiprocessing.get_context("spawn")
        self.world, self.out_dir, self.error = world, out_dir, None
        self.pipes = [ctx.Pipe() for _ in range(world)]
        self.servers = [threading.Thread(target=_serve, args=(ours, {0: k}), daemon=True)
                        for (ours, _), k in zip(self.pipes, keys)]
        self.thread = threading.Thread(target=self._run, daemon=True)
        for t in self.servers + [self.thread]:
            t.start()

    def _run(self):
        try:
            distributed.spawn(torch_ranks.parallel_checks, self.world,
                              str(self.out_dir / "in.pt"), str(self.out_dir),
                              [theirs for _, theirs in self.pipes], device="cpu",
                              timeout_s=300)
        except Exception as e:  # re-raised by `results` in the test's thread
            self.error = e

    def results(self):
        self.thread.join(timeout=600)
        for ours, theirs in self.pipes:
            theirs.close()
        for t in self.servers:
            t.join(timeout=10)
        if self.thread.is_alive():
            raise TimeoutError(f"the world-{self.world} ranks did not finish")
        if self.error is not None:
            raise self.error
        return torch_ranks.load_ranks(str(self.out_dir), self.world)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world → (JAX references, every rank's results)."""
    ranks = {world: _Ranks(world, tmp_path_factory.mktemp(f"parallel{world}"))
             for world in WORLDS}
    shared = {}
    refs = {world: _references(world, shared) for world in WORLDS}
    return {world: (refs[world], ranks[world].results()) for world in WORLDS}


def _one_device():
    X, Y, jm = _svgp_problem()
    tm = torch_ranks.svgp_model(np.linspace(0, 6, 12)[:, None], _leaves(jm))
    return X, Y, tm


def _assert_leaves(got, want, rtol, atol=0.0, scaled_atol=0.0):
    """Leaf by leaf; `scaled_atol` adds that much of each leaf's largest
    |entry| to `atol`."""
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        np.testing.assert_allclose(torch_ranks.as_numpy(a).reshape(np.shape(b)), b, rtol=rtol,
                                   atol=atol + scaled_atol * np.max(np.abs(b)),
                                   err_msg=f"leaf {k}")


def test_torch_mesh_construction():
    """A one-process mesh is 1×1 and its collectives are the identity;
    (data, restart) shapes read as in JAX; a wrong shape raises."""
    m = tmesh.make_mesh(device="cpu")
    assert m.size == 1 and set(m.axis_names) == {"data", "restart"}
    assert m.shape["data"] == 1 and m.shape["restart"] == 1 and m.index("data") == 0
    x = torch.arange(3.0)
    assert torch.equal(tmesh.psum([x], m)[0], x) and torch.equal(tmesh.all_gather(x, m), x)
    with pytest.raises(ValueError):
        tmesh.make_mesh(data=2, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):  # no silent CPU fallback
        tmesh.make_mesh(device="cuda")


def test_torch_pad_to_multiple_matches_jax():
    X, Y, _ = _svgp_problem()
    got = tmesh.pad_to_multiple(torch.tensor(X[:60]), torch.tensor(Y[:60]), 8)
    want = jmesh_mod.pad_to_multiple(jnp.asarray(X[:60]), jnp.asarray(Y[:60]), 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n", [64, 63])
def test_torch_sharded_elbo_matches_single_device_and_jax(runs, world, n):
    """The sharded ELBO on every rank: the one-device ELBO of the port and
    JAX's sharded value, rtol 1e-10; 63 rows pad to a multiple of the data
    axis with weight-0 rows that contribute nothing."""
    refs, ranks = runs[world]
    X, Y, tm = _one_device()
    want = float(tsvgp.neg_elbo(tm, torch.tensor(X[:n]), torch.tensor(Y[:n]), num_data=n))
    padded = n + (-n) % world
    assert [r[f"elbo{n}_rows"][0] for r in ranks] == [padded // world] * world
    assert sum(r[f"elbo{n}_rows"][1] for r in ranks) == n
    for r in ranks:
        np.testing.assert_allclose(r[f"elbo{n}"], want, rtol=1e-10)
        np.testing.assert_allclose(r[f"elbo{n}"], refs[f"jax_elbo{n}"], rtol=1e-10)


def _one_device_grads(elbo):
    X, Y, tm = _one_device()
    leaves = [x.detach().requires_grad_(True) for x in tparams.tree_leaves(tm)]
    value = -elbo(tparams.tree_replace(tm, leaves), torch.tensor(X), torch.tensor(Y),
                  num_data=64)
    return [g.numpy() for g in torch.autograd.grad(value, leaves)]


@pytest.mark.parametrize("world", WORLDS)
def test_torch_sharded_elbo_gradients_match(runs, world):
    """Gradients through the all-reduce pair, on every rank: the one-device
    gradient of the same (Gram) formula and JAX's sharded gradient, rtol
    1e-9 (and 1e-11 of each leaf's largest entry: the ill-conditioned Kuu
    of 12 inducing points on [0, 6] moves the small entries of q_sqrt's
    gradient, ~1e-2 against a largest of ~2e2, by ~1e-9 when the partial
    sums are added in another order); the one-device gradient of the plain
    ELBO at JAX's own tolerance for it (rtol 1e-8, atol 1e-10)."""
    refs, ranks = runs[world]
    gram = _one_device_grads(tsvgp.gaussian_elbo_gram)
    plain = _one_device_grads(tsvgp.elbo)
    for r in ranks:
        _assert_leaves(r["elbo_grads"], gram, rtol=1e-9, scaled_atol=1e-11)
        _assert_leaves(r["elbo_grads"], refs["jax_grads"], rtol=1e-9, scaled_atol=1e-11)
        _assert_leaves(r["elbo_grads"], plain, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_torch_sharded_step_matches_single_device_step(runs, world):
    """One Adam step on the mesh equals one on one device (port) and JAX's
    step on its mesh: the loss rtol 1e-10, the leaves JAX's 1e-7."""
    refs, ranks = runs[world]
    X, Y, tm = _one_device()
    init_fn, step_fn = tes.make_elbo_train_step(64)
    state, loss = step_fn(init_fn(tm), torch.tensor(X), torch.tensor(Y),
                          torch.ones(64, dtype=torch.float64))
    for r in ranks:
        got_loss, got_leaves = r["step1"]
        np.testing.assert_allclose(got_loss, float(loss), rtol=1e-10)
        np.testing.assert_allclose(got_loss, refs["jax_step1"][0], rtol=1e-10)
        _assert_leaves(got_leaves, [x.numpy() for x in tparams.tree_leaves(state.model)],
                       rtol=1e-7, atol=1e-9)
        _assert_leaves(got_leaves, refs["jax_step1"][1], rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_torch_distributed_train_step_reduces_loss_and_ranks_agree(runs, world):
    """31 sharded Adam steps lower the loss; after 60 every rank's leaves
    are bitwise equal."""
    _, ranks = runs[world]
    first, last = ranks[0]["loss_after_31"]
    assert last < first
    for r in ranks[1:]:
        assert r["loss_after_31"] == ranks[0]["loss_after_31"]
        assert all(torch.equal(a, b) for a, b in zip(r["step60"], ranks[0]["step60"]))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("inner_steps", [1, 3])
def test_torch_mesh_feed_matches_jax_global_batches(runs, world, inner_steps):
    """Every rank runs the same stream; the rank shards, in data-axis order,
    make up JAX's global batch row for row (a batch that does not divide
    the data axis raises, as 12 % 8 does in JAX)."""
    refs, ranks = runs[world]
    want = refs[f"jax_feed{inner_steps}"]
    axis = 0 if inner_steps == 1 else 1
    assert all(len(r[f"feed{inner_steps}"]) == len(want) for r in ranks)
    for b, batch in enumerate(want):
        for part, w in enumerate(batch):
            got = np.concatenate([r[f"feed{inner_steps}"][b][part].numpy() for r in ranks],
                                 axis=axis)
            np.testing.assert_array_equal(got, w)
    assert all(r["feed_raises"] for r in ranks)


def test_torch_mesh_feed_rejects_a_batch_that_does_not_divide():
    """JAX's 12 % 8 check, on a mesh whose data axis has 8 ranks."""
    from portfoliooptgp_tpu_torch.data.iterator import MinibatchIterator

    X = np.zeros((100, 1))
    with pytest.raises(ValueError, match="divide"):
        MinibatchIterator(X, X, 12, mesh=tmesh.Mesh(8, 1, torch.device("cpu")))


@pytest.mark.parametrize("world", WORLDS)
def test_torch_minibatched_training_on_mesh_matches_jax(runs, world):
    """`train_svgp_minibatched(mesh=...)`: 2 epochs of 3 batches in one
    group of 8 (2 all-zero batches skipped over all ranks), the same
    trajectory as JAX's on its mesh, rtol 1e-8."""
    refs, ranks = runs[world]
    elbo, iters, leaves = refs["jax_minibatched"]
    for r in ranks:
        got_elbo, got_iters, got_leaves = r["minibatched"]
        assert got_iters == iters == 6
        np.testing.assert_allclose(got_elbo, elbo, rtol=1e-8)
        _assert_leaves(got_leaves, leaves, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_torch_sharded_mc_replays_jax_hits(runs, world):
    """On JAX's per-shard fold-in draws the hit count is JAX's exactly; on
    the ranks' own streams the estimate is deterministic and within MC
    error of the one-device estimate."""
    refs, ranks = runs[world]
    local = -(-MC["n"] // world)
    single = tmc.probability_a_greater_than_b_mvnorm(MC["mu_a"], MC["cov"], MC["mu_b"],
                                                     MC["cov"], MC["n"], **CPU64)
    for r in ranks:
        assert round(r["mc_replay"] * local * world) == round(refs["jax_mc"] * local * world)
        assert r["mc_replay"] == refs["jax_mc"]
        a, b = r["mc_stream"]
        assert a == b == ranks[0]["mc_stream"][0]
        assert abs(a - single) < 0.02 and 0.0 < a < 1.0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("pool", [False, True])
def test_torch_welford_across_ranks_matches_jax(runs, world, dense, pool):
    """Welford moments combined over the data axis (and, pooled, over the
    chains too): JAX's psum over ('c', 'data'), rtol 1e-12."""
    refs, ranks = runs[world]
    want = refs[f"jax_welford_{dense}_{pool}"]
    for d, r in enumerate(ranks):
        np.testing.assert_allclose(r[f"welford_{dense}_{pool}"].numpy(), want[d], rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("world", WORLDS)
def test_torch_cross_rank_nuts_replays_jax_shards(runs, world):
    """2 chains a rank, 10 warmup + 10 samples, adaptation pooled over the
    chains and the data axis, each rank on its JAX shard's key: samples,
    tree sizes, step size and metric as JAX's shard_map run, rtol 1e-8
    (samples also atol 1e-9: a draw near 0 of a posterior of scale 1)."""
    refs, ranks = runs[world]
    jsamples, jstats = refs["jax_nuts"]
    jleaves = jax.tree.leaves(jsamples)
    for d, r in enumerate(ranks):
        samples, stats = r["nuts"]
        for g, w in zip(samples, jleaves):
            np.testing.assert_allclose(g.numpy(), np.asarray(w[d]), rtol=1e-8, atol=1e-9)
        np.testing.assert_array_equal(stats["num_leaves"].numpy(), np.asarray(jstats.num_leaves[d]))
        for name in ("accept_prob", "step_size", "inv_mass"):
            np.testing.assert_allclose(stats[name].numpy(),
                                       np.asarray(getattr(jstats, name)[d]), rtol=1e-8,
                                       err_msg=name)
    # the adapted step size and metric are the same on every rank
    for r in ranks[1:]:
        for name in ("step_size", "inv_mass"):
            assert torch.equal(r["nuts"][1][name], ranks[0]["nuts"][1][name])


@pytest.mark.parametrize("world", WORLDS)
def test_torch_restart_axis_sharding(runs, world):
    """Batched L-BFGS restarts split over the restart axis: every row as
    the unsharded port batch (rtol 1e-12) and as JAX's restart-sharded fit
    (rtol 1e-6, JAX's own tolerance between its sharded and unsharded)."""
    refs, ranks = runs[world]
    X, Y, _ = _svgp_problem()
    stacked = tlbfgs.stack_pytrees([
        tgpr.GPR.create(tk.SquaredExponential.create(variance=v, **CPU64), noise_variance=0.05)
        for v in RESTART_VARIANCES])
    want = tlbfgs.fit_batched(
        lambda mo: tgpr.neg_log_marginal_likelihood(mo, torch.tensor(X), torch.tensor(Y)),
        stacked, maxiter=RESTART_MAXITER).loss
    for r in ranks:
        np.testing.assert_allclose(r["restart_losses"].numpy(), want.numpy(), rtol=1e-12)
        np.testing.assert_allclose(r["restart_losses"].numpy(), refs["jax_restart_losses"],
                                   rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_torch_restart_sharded_walk_forward(runs, world):
    """4 days × 2 restarts with the 8 rows split over the restart axis:
    every row as the port's unsharded run (rtol 1e-12), and as JAX's
    restart-sharded run at tests/test_torch_walk_forward.py's tolerances;
    an axis that does not divide D·R raises."""
    refs, ranks = runs[world]
    Xw, Yw = _series()
    want = twf.batched_walk_forward(
        Xw, Yw, 36, lambda v: tgpr.GPR.create(tk.composite_kernel(2, **CPU64), v), **CPU64,
        **WALK_KW)
    jres = refs["jax_walk"]
    for r in ranks:
        got = r["walk"]
        for name in ("losses", "f_mean", "f_var"):
            np.testing.assert_allclose(got[name].numpy(), getattr(want, name).numpy(),
                                       rtol=1e-12, atol=1e-15, err_msg=name)
        _assert_leaves(got["leaves"], [x.numpy() for x in tparams.tree_leaves(want.models)],
                       rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(got["losses"].numpy(), np.asarray(jres.losses), rtol=1e-8)
        np.testing.assert_allclose(got["f_mean"].numpy(), np.asarray(jres.f_mean), rtol=1e-4,
                                   atol=1e-8)
        np.testing.assert_allclose(got["f_var"].numpy(), np.asarray(jres.f_var), rtol=1e-4,
                                   atol=1e-12)
        for g, w in zip(got["leaves"], jax.tree.leaves(jres.models)):
            np.testing.assert_allclose(tparams.positive(g).numpy(), np.asarray(j_positive(w)),
                                       rtol=1e-4, atol=1e-9)
        assert r["walk_raises"]


@pytest.mark.parametrize("world", WORLDS)
def test_torch_dryrun_multichip_cpu(world, monkeypatch):
    """`dryrun_multichip(n)`'s six checks on n gloo ranks (one thread each)."""
    from portfoliooptgp_tpu_torch.parallel.dryrun import dryrun_multichip

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    summary = dryrun_multichip(world, device="cpu", dtype=torch.float64)
    assert summary["mesh"] == {"data": world // 2, "restart": 2}
    assert summary["walk_forward_days"] == 4 and summary["nuts_chains"] == world // 2
    assert all(math.isfinite(x) for x in summary["restart_losses"])
    assert math.isfinite(summary["elbo_step_loss"]) and math.isfinite(summary["dist_chol_nll"])


@pytest.fixture(scope="module")
def market(tmp_path_factory):
    """tests/test_torch_cli.py's market: `make_market` and a config with
    its dates."""
    root = str(tmp_path_factory.mktemp("market"))
    make_market(root)
    cfg = os.path.join(root, "cfg.json")
    with open(cfg, "w") as fh:
        json.dump({"data": DATES}, fh)
    return root, cfg


def test_torch_cli_svgp_mesh_matches_jax(market, capsys, tmp_path, monkeypatch):
    """`svgp --mesh` on 2 gloo ranks (the port's rows split over the process
    group, as torchrun launches it) against the JAX CLI's `--mesh` on its 8
    virtual devices: the logged neg-ELBOs at rtol 1e-8 and the final one as
    printed; only rank 0 prints and writes the metrics."""
    # the JAX CLI turns on its persistent compile cache; keep it out of the tree
    monkeypatch.setenv("PORTFOLIOOPTGP_JAX_CACHE", "0")
    root, cfg = market
    args = ["svgp", "--config", cfg, "--data-root", root, "--ticker", ASSETS[0],
            "--inducing", "8", "--steps", "60", "--mesh"]
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jcli.main(args + ["--x64", "--metrics", jpath])
    text = capsys.readouterr().out
    want = [json.loads(line)["value"] for line in open(jpath)]
    want.append(float(re.search(r"final neg-ELBO (\S+)", text).group(1)))
    ranks = tmp_path / "ranks"
    ranks.mkdir()
    distributed.spawn(torch_ranks.cli_main, 2, args + ["--x64", "--device", "cpu", "--metrics",
                                                       tpath],
                      str(ranks), device="cpu", timeout_s=300)
    printed = [(ranks / f"rank{r}.txt").read_text() for r in range(2)]
    assert printed[1] == "" and "final neg-ELBO" in printed[0]
    got = [json.loads(line)["value"] for line in open(tpath)]
    got.append(float(re.search(r"final neg-ELBO (\S+)", printed[0]).group(1)))
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-8)
    assert got[2] == want[2]
