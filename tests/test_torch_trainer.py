"""The port's menu trainer (train/trainer.py) against the JAX package's
`train_best_model`, float64 on the CPU on both sides.

Tolerances: the two L-BFGS runs follow the same rules but round
differently and stop at ftol, so losses agree to rtol 1e-6, train MSEs
and the winner's constrained parameters to rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from portfoliooptgp_tpu import kernels as jk
from portfoliooptgp_tpu.train import trainer as jtrainer
from portfoliooptgp_tpu_torch import kernels as tk
from portfoliooptgp_tpu_torch import params as tparams
from portfoliooptgp_tpu_torch.train import trainer as ttrainer

# one intra-op thread per test worker avoids oversubscribing the CPU when
# pytest-xdist runs several workers
torch.set_num_threads(1)

CPU64 = dict(device="cpu", dtype=torch.float64)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_torch_train_best_model_matches_jax():
    """Three menu entries (SE, the Periodic(SE)+Linear sum, SE×M12) on 40
    z-scored points of day-index inputs, float64 on both sides, maxiter 10:
    the two L-BFGS runs agree to ~1e-9 there, while the periodic entry's
    loss surface amplifies rounding until the runs part near iteration 40
    (37.21 in the port against 37.31 in JAX after 100 iterations, both
    still short of convergence)."""
    rng = np.random.default_rng(3)
    X = np.sort(rng.choice(np.arange(120.0), 40, replace=False))[:, None]
    Y = np.sin(X / 9.0) + 0.3 * rng.normal(size=X.shape)
    Y = (Y - Y.mean()) / Y.std()
    picks = (0, 5, 7)
    jres = jtrainer.train_best_model(jnp.asarray(X), jnp.asarray(Y),
                                     [jk.default_kernel_menu()[i] for i in picks], maxiter=10)
    tres = ttrainer.train_best_model(torch.tensor(X), torch.tensor(Y),
                                     [tk.default_kernel_menu(**CPU64)[i] for i in picks],
                                     maxiter=10)
    assert tres.best_index == jres.best_index
    assert tres.tiers == jres.tiers == ["xla"] * 3
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-6)
    np.testing.assert_allclose(tres.mses, jres.mses, rtol=1e-3)
    jbest = _leaves(jres.best.model)
    for got, want in zip(tparams.tree_leaves(tres.best.model), jbest):
        np.testing.assert_allclose(tparams.positive(got)[0].numpy(),
                                   np.asarray(jgpr_positive(want)), rtol=1e-3)


def jgpr_positive(raw):
    from portfoliooptgp_tpu.params import positive

    return positive(jnp.asarray(raw))
