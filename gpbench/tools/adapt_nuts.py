"""Work out the NUTS cell's fixed step size and dense inverse mass.

    python3 gpbench/tools/adapt_nuts.py [--chains 128] [--warmup 100] [--seed 0]

runs the program's own `sample_nuts` warmup on bench.py's posterior (the
configuration `gpbench/configs/nuts_ard_se512.json` without its adapted
values) on the card: dense mass, `max_depth` 8, bench.py's 100 warmup
transitions, a `torch.Generator` seeded `--seed`, the chains pooled as
`sample_nuts` pools them. It prints, as one JSON line, the step size and
inverse mass the warmup ends with (one for all chains: the adaptation is
pooled), for the configuration's `step_size` and `inv_mass`.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--chains", type=int, default=128)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from gpbench import market
    from portfoliooptgp_tpu_torch import kernels
    from portfoliooptgp_tpu_torch.inference import (centered_normal_logprior,
                                                    gpr_logdensity_pair, gpr_logdensity_vg,
                                                    sample_nuts)
    from portfoliooptgp_tpu_torch.models.gpr import GPR

    with open(os.path.join(ROOT, "gpbench", "configs", "nuts_ard_se512.json")) as f:
        cfg = json.load(f)
    dev, dtype = "cuda", getattr(torch, cfg["dtype"])
    X, Y = (torch.as_tensor(a, dtype=dtype, device=dev)
            for a in market.nuts_posterior_data(cfg["n"], cfg["d"]))
    m0 = GPR.create(kernels.SquaredExponential.create(
        cfg["kernel_variance"], np.asarray(cfg["lengthscales"], dtype=float), device=dev,
        dtype=dtype), noise_variance=cfg["noise_variance"])
    prior = centered_normal_logprior(m0, cfg["prior_scale"])
    logp, _ = gpr_logdensity_pair(X, Y, prior)
    t0 = time.perf_counter()
    samples, stats = sample_nuts(logp, m0, torch.Generator(device=dev).manual_seed(args.seed),
                                 num_warmup=args.warmup, num_samples=1, num_chains=args.chains,
                                 max_depth=cfg["max_depth"], dense_mass=cfg["dense_mass"],
                                 vg_fn=gpr_logdensity_vg(X, Y, prior), device=dev)
    torch.cuda.synchronize()
    step = stats.step_size.double().cpu()
    inv_mass = stats.inv_mass.double().cpu()
    print(json.dumps({
        "step_size": float(step[0]), "step_size_spread": float(step.max() - step.min()),
        "inv_mass": inv_mass[0].tolist(),
        "inv_mass_spread": float((inv_mass - inv_mass[0]).abs().max()),
        "accept_last": float(stats.accept_prob.mean()),
        "leaves_last": float(stats.num_leaves.double().mean()),
        "chains": args.chains, "num_warmup": args.warmup, "seed": args.seed,
        "seconds": time.perf_counter() - t0, "card": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
