"""Work out the ICM frontier cell's start, fixed step size and diagonal
inverse mass.

    python3 gpbench/tools/adapt_icm_nuts.py [--chains 128] [--warmup 100] [--seed 0]
        [--device cuda] [--config gpbench/configs/icm_frontier_p20r3.json]

runs, on the configuration's market (`gpbench/frontier_market.py`), what
`run_frontier_pipeline(use_nuts=True)` runs before it samples: the maximum-
likelihood fit, `lbfgs.fit` of `icm.neg_log_marginal_likelihood_chol` from
`ICMGPR.create` with W drawn from a `torch.Generator` seeded by the
configuration's fit seed, for its `maxiter` iterations; then `sample_nuts`'s
warmup on `frontier_pipeline.frontier_logdensity` from that fit: a diagonal
mass, the configuration's `max_depth`, `--warmup` transitions, `--chains`
chains pooled (one step size and one inverse mass for all), a
`torch.Generator` seeded `--seed`. It prints, as one JSON line, the fit's
raw parameters (the configuration's `start`, in `params.ravel` order), the
step size and the inverse mass's diagonal the warmup ends with (`step_size`,
`inv_mass`), and what the warmup's last transition read.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def adapt(cfg: dict, chains: int, warmup: int, seed: int, device: str) -> dict:
    """The fit and the warmup on the configuration `cfg` (its `start`,
    `step_size` and `inv_mass` are not read); returns what `main` prints."""
    import torch

    from gpbench import frontier_market
    from portfoliooptgp_tpu_torch import kernels
    from portfoliooptgp_tpu_torch.inference import sample_nuts
    from portfoliooptgp_tpu_torch.models import icm
    from portfoliooptgp_tpu_torch.params import ravel
    from portfoliooptgp_tpu_torch.pipelines.frontier_pipeline import frontier_logdensity
    from portfoliooptgp_tpu_torch.train import lbfgs

    dtype = getattr(torch, cfg["dtype"])
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    X, Y = (t.to(device=device, dtype=dtype) for t in frontier_market.frontier_data(
        *cfg["grid"], int(cfg["market_seed"]), int(cfg["assets"])))
    kern = getattr(kernels, cfg["kernel"]).create(device=device, dtype=dtype)
    model0 = icm.ICMGPR.create(kern, int(cfg["assets"]), rank=int(cfg["rank"]),
                               noise_variance=cfg["noise_variance"],
                               generator=torch.Generator().manual_seed(int(cfg["fit"]["seed"])))
    t0 = time.perf_counter()
    res = lbfgs.fit(lambda m: icm.neg_log_marginal_likelihood_chol(m, X, Y), model0,
                    maxiter=int(cfg["fit"]["maxiter"]))
    sync()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, stats = sample_nuts(lambda m: frontier_logdensity(m, X, Y), res.params,
                           torch.Generator(device=device).manual_seed(seed),
                           num_warmup=warmup, num_samples=1, num_chains=chains,
                           max_depth=int(cfg["max_depth"]), dense_mass=bool(cfg["dense_mass"]),
                           device=device)
    sync()
    step = stats.step_size.double().cpu()
    inv_mass = stats.inv_mass.double().cpu()
    return {
        "start": ravel(res.params)[0].double().cpu().tolist(),
        "fit_loss": float(res.loss), "fit_iters": int(res.iters), "fit_seconds": fit_s,
        "step_size": float(step[0]), "step_size_spread": float(step.max() - step.min()),
        "inv_mass": inv_mass[0].tolist(),
        "inv_mass_spread": float((inv_mass - inv_mass[0]).abs().max()),
        "accept_last": float(stats.accept_prob.mean()),
        "leaves_last": float(stats.num_leaves.double().mean()),
        "chains": chains, "num_warmup": warmup, "seed": seed,
        "seconds": time.perf_counter() - t0,
        "card": torch.cuda.get_device_name(0) if cuda else "cpu"}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--chains", type=int, default=128)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--config", default=os.path.join("gpbench", "configs",
                                                    "icm_frontier_p20r3.json"))
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(ROOT, args.config)) as f:
        cfg = json.load(f)
    print(json.dumps(adapt(cfg, args.chains, args.warmup, args.seed, args.device)))


if __name__ == "__main__":
    main()
