"""Why the port's float32 `multi-input --step 4` on the five-year window
(chip_smoke phase 12b: padded N = 1280, the walk-forward's blocked_hinv
tier) lands where it does against the JAX CLI's float64 run, on the CPU.

Runs both CLIs in this process on chip_smoke.make_long_market, the port in
float32 and float64 (`--device cpu`), the JAX package in float32 and
float64, recording each walk-forward's batched L-BFGS fit. Prints:
- each fit's iterations, final losses and gradient norms, and how far its
  next-day means lie from the JAX float64 run's (as chip_smoke.compare_cli_means
  measures them);
- at the port's float64 optimum θ*: the float32 value and gradient of the
  port's hinv loss, of the port's hinv loss evaluated in float64 on the
  same masked systems, of the plain float64 loss and of JAX's float32 loss;
- the same values with K and the targets built in float64 and rounded to
  float32, so that only the factorization runs in float32 (the port's
  `batched_nll_hinv` and JAX's);
- each float32 run's loss at its own end point and at θ* (its own
  arithmetic), which says whether it stopped short of a lower point its
  rounding can see.
Gradients are compared on the trained coordinates only (the likelihood
variance is frozen).

    JAX_PLATFORMS=cpu python tools/trace_hinv_walk.py [--threads 4]

About 15 minutes on four CPU threads, most of it the two JAX runs.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def run(main, argv):
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue(), time.perf_counter() - t0


def port_leaves_grad(loss, model):
    """(per-model losses (B,), gradient (B, dim)) of a port model-batched loss."""
    from portfoliooptgp_tpu_torch import params

    leaves = [x.detach().clone().requires_grad_(True) for x in params.tree_leaves(model)]
    with torch.enable_grad():
        value = loss(params.tree_replace(model, leaves))
        grads = torch.autograd.grad(value.sum(), leaves, allow_unused=True)
    B = value.shape[0]
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    return (value.detach().double().numpy(),
            torch.cat([g.reshape(B, -1) for g in grads], 1).double().numpy())


def free_columns(model, frozen):
    """Columns of the flat gradient that the fit trains."""
    from portfoliooptgp_tpu_torch import params

    if frozen is None:
        return slice(None)
    flags = [np.full(x[0].numel(), bool(f)) for x, f in
             zip(params.tree_leaves(model), params.tree_leaves(frozen))]
    return ~np.concatenate(flags)


def rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    os.environ["PORTFOLIOOPTGP_JAX_CACHE"] = "0"

    import jax

    jax.config.update("jax_platforms", "cpu")
    from benchmarks.bench_portfolio_e2e import FEATURES
    from portfoliooptgp_tpu import cli as jcli
    from portfoliooptgp_tpu.train import batched_lbfgs as jbl
    from portfoliooptgp_tpu_torch import cli as tcli
    from portfoliooptgp_tpu_torch import params
    from portfoliooptgp_tpu_torch.ops import blocked_nll
    from portfoliooptgp_tpu_torch.pipelines import walk_forward as twf
    from portfoliooptgp_tpu_torch.train import batched_lbfgs as tbl

    with open(cs.cli_goldens_path()) as fh:
        golden = json.load(fh)["runs"]["5y"]["walks"][0]["f_mean_tail"]
    with open(cs.cli_goldens_path(True)) as fh:
        golden32 = json.load(fh)["runs"]["5y"]["walks"][0]["f_mean_tail"]

    fits, systems = {}, {}
    real_t, real_j, real_ms = tbl.fit_batched_fused, jbl.fit_batched_fused, twf.masked_system

    def spy(real, key):
        def fit(loss, stacked, **kw):
            out = real(loss, stacked, **kw)
            fits[key[0]] = (loss, stacked, out, kw.get("frozen"))
            return out
        return fit

    def system_spy(model, X, Y, mask):
        systems.setdefault("args", (X, Y, mask))
        return real_ms(model, X, Y, mask)

    key = [None]
    tbl.fit_batched_fused = spy(real_t, key)
    jbl.fit_batched_fused = spy(real_j, key)
    twf.masked_system = system_spy
    means = {}
    with tempfile.TemporaryDirectory() as root:
        cs.make_long_market(root)
        cfg = os.path.join(root, "5y.json")
        with open(cfg, "w") as fh:
            json.dump(cs.cli_config("5y"), fh)
        argv = ["multi-input", "--config", cfg, "--ticker", cs.CLI_TICKER, "--step", "4",
                "--data-root", root, "--features", *FEATURES]
        for name, main_fn, extra in (
                ("port32", tcli.main, ["--device", "cpu"]),
                ("port64", tcli.main, ["--device", "cpu", "--x64"]),
                ("jax32", jcli.main, []),
                ("jax64", jcli.main, ["--x64"])):
            key[0] = name
            if name == "jax32":
                jax.config.update("jax_enable_x64", False)
            if name == "jax64":
                jax.config.update("jax_enable_x64", True)
            out, sec = run(main_fn, argv + extra)
            means[name] = cs.parse_tail(out, "f_mean tail:")
            dist, lim = cs.compare_cli_means(means[name], golden, golden32)
            _, _, (_, res), _ = fits[name]
            print(f"{name}: {sec:.1f} s; fit iterations {np.asarray(res.iters).tolist()}, "
                  f"losses {np.round(np.asarray(res.loss, dtype=float), 6).tolist()}, gradient "
                  f"norms {np.asarray(res.grad_norm, dtype=float).tolist()}, converged "
                  f"{np.asarray(res.converged).tolist()}; next-day means distance {dist:.4g} "
                  f"of max |mean| (limit {lim:.4g})", flush=True)

    loss32, _, (m32, _), frozen = fits["port32"]
    loss64, _, (m64, _), _ = fits["port64"]
    free = free_columns(m64, frozen)
    theta32 = params.tree_to(m64, "cpu", torch.float32)
    v64, g64 = port_leaves_grad(loss64, m64)
    v32, g32 = port_leaves_grad(loss32, theta32)
    X, Y, mask = (x.double() for x in systems["args"])
    n_full = X.shape[0]
    const = 0.5 * (n_full - mask.sum(1)) * np.log(2 * np.pi)

    def hinv64(ms):
        Kb, errb = real_ms(ms, X, Y, mask)
        return blocked_nll.batched_nll_hinv(Kb, errb[:, :, 0],
                                            torch.zeros_like(mask[:, 0])) - const

    vh, gh = port_leaves_grad(hinv64, m64)
    jloss, jstack, _, _ = fits["jax32"]
    jleaves = [jax.numpy.asarray(x.detach().numpy(), dtype=jax.numpy.float32)
               for x in params.tree_leaves(theta32)]
    jtheta = jax.tree.unflatten(jax.tree.structure(jstack), jleaves)
    _, jg = jax.value_and_grad(lambda m: jloss(m).sum())(jtheta)
    jv = np.asarray(jloss(jtheta), dtype=float)
    jg = np.concatenate([np.asarray(x, dtype=float).reshape(len(jv), -1)
                         for x in jax.tree.leaves(jg)], 1)
    g64, g32, gh, jg = (g[:, free] for g in (g64, g32, gh, jg))
    print(f"at the port's float64 optimum θ*: float64 losses {v64.tolist()}, gradient norms "
          f"{np.linalg.norm(g64, axis=1).tolist()} (trained coordinates)")
    print(f"  port hinv in float64: value rel err {rel(vh, v64):.3e}, gradient "
          f"{rel(gh, g64):.3e} (of max |g|)")
    print(f"  port hinv in float32: value rel err {rel(v32, v64):.3e} (abs "
          f"{np.abs(v32 - v64).max():.4g}), gradient norms "
          f"{np.linalg.norm(g32, axis=1).tolist()}")
    print(f"  JAX hinv in float32: value rel err {rel(jv, v64):.3e} (abs "
          f"{np.abs(jv - v64).max():.4g}), gradient norms {np.linalg.norm(jg, axis=1).tolist()}")
    print(f"  port float32 against JAX float32: value {np.abs(v32 - jv).max():.4g}, gradient "
          f"{rel(g32, jg):.3e} of max |g|")

    # the factorization alone in float32: K and targets built in float64
    from portfoliooptgp_tpu.ops.pallas import blocked_nll as jblocked

    with torch.no_grad():
        Kb, errb = real_ms(m64, X, Y, mask)
        zero = torch.zeros_like(mask[:, 0])
        vf = (blocked_nll.batched_nll_hinv(Kb.float(), errb[:, :, 0].float(),
                                           zero.float()).double() - const).numpy()
    jf = np.asarray(jblocked.batched_nll_hinv(
        jax.numpy.asarray(Kb.float().numpy()), jax.numpy.asarray(errb[:, :, 0].float().numpy()),
        jax.numpy.asarray(zero.float().numpy())), dtype=float) - const.numpy()
    print(f"  K built in float64, factored in float32: port value abs err "
          f"{np.abs(vf - v64).max():.4g}, JAX {np.abs(jf - v64).max():.4g}")
    e32, _ = port_leaves_grad(loss32, m32)
    print(f"port float32 loss at its end {e32.tolist()}, at θ* {v32.tolist()} "
          f"(lower at θ* by {(e32 - v32).tolist()})")
    je = np.asarray(jloss(fits["jax32"][2][0]), dtype=float)
    print(f"JAX float32 loss at its end {je.tolist()}, at θ* {jv.tolist()}")
    tbl.fit_batched_fused, jbl.fit_batched_fused, twf.masked_system = real_t, real_j, real_ms
    return 0


if __name__ == "__main__":
    sys.exit(main())
