"""Why the JAX package's float32 walk-forward stops far from float64 on
the long-window cases (chip_smoke.WALK_LONG_CASES), on the CPU.

Runs JAX's batched_walk_forward in float64 and in float32 on one case,
capturing each L-BFGS fit, then prints: each fit's iterations, losses,
gradient norms and flags; JAX's float32 loss at the float64 optimum and
along the segment from its own end point to it; and the float32 gradient
at its end point, eager and jitted, of the whole loss and of the kernel
matrix alone (sum(K * R) for a fixed random R).

    python tools/trace_jax_float32_walk.py blocked_composite_560
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from portfoliooptgp_tpu import kernels as jk  # noqa: E402
from portfoliooptgp_tpu.models import gpr  # noqa: E402
from portfoliooptgp_tpu.pipelines import walk_forward as jwf  # noqa: E402
from portfoliooptgp_tpu.train import batched_lbfgs  # noqa: E402


def main(case: str) -> int:
    n, seed, span, kernel = cs.WALK_LONG_CASES[case]
    X, Y = cs.long_series(n, seed, span)
    fits = []
    real = batched_lbfgs.fit_batched_fused

    def spy(loss, stacked, **kw):
        out = real(loss, stacked, **kw)
        fits.append((loss, stacked, out))
        return out

    batched_lbfgs.fit_batched_fused = spy
    for dtype in (jnp.float64, jnp.float32):
        def make_model(v, dtype=dtype):
            return jax.tree.map(lambda x: x.astype(dtype),
                                gpr.GPR.create(cs.walk_long_kernel(jk, kernel), v))

        res = jwf.batched_walk_forward(jnp.asarray(X, dtype), jnp.asarray(Y, dtype), n - 3,
                                       make_model, **cs.WALK_LONG_KW)
        print(f"{dtype.__name__} losses {np.asarray(res.losses)}")
    (l64, _, (m64, r64)), (l32, s32, (m32, r32)) = fits
    for name, r in (("float64", r64), ("float32", r32)):
        print(f"{name} fit: {int(r.iters)} iterations, loss {np.asarray(r.loss)}, gradient "
              f"norm {np.asarray(r.grad_norm)}, converged {np.asarray(r.converged)}")

    one = jax.tree.map(lambda x: x[0], s32)
    _, unravel32 = ravel_pytree(one)
    _, unravel64 = ravel_pytree(jax.tree.map(lambda x: x[0], m64))
    z32, z64 = np.asarray(r32.params, np.float64), np.asarray(r64.params)
    print("along the segment from float32's end (t = 0) to the float64 optimum (t = 1):")
    for t in (0.0, 0.25, 0.5, 0.75, 1.0):
        z = (1 - t) * z32 + t * z64
        f32 = l32(jax.vmap(unravel32)(jnp.asarray(z, jnp.float32)))
        f64 = l64(jax.vmap(unravel64)(jnp.asarray(z)))
        print(f"  t {t}: float32 loss {np.asarray(f32)}, float64 loss {np.asarray(f64)}")

    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(one)]
    print("leaves:", paths)

    def total(Z):
        return jnp.sum(l32(jax.vmap(unravel32)(Z)))

    for how, fn in (("eager", jax.grad(total)), ("jit", jax.jit(jax.grad(total)))):
        g = np.asarray(fn(r32.params))
        print(f"float32 gradient at its end, {how}: norm {np.linalg.norm(g, axis=-1)}\n{g}")

    Xf = jnp.asarray(X, jnp.float32)
    R = jnp.asarray(np.random.default_rng(0).normal(size=(n, n)), jnp.float32)
    m_end = jax.tree.map(lambda x: x[0], m32)

    def kpart(m):
        return jnp.sum(m.kernel.K(Xf) * R)

    for how, fn in (("eager", jax.grad(kpart)), ("jit", jax.jit(jax.grad(kpart)))):
        print(f"gradient of sum(K * R), {how}: "
              f"{[float(x) for x in jax.tree.leaves(fn(m_end))]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "blocked_composite_560"))
