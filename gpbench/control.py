"""The readings that each cell's limits are set from, on the card.

    python3 gpbench/control.py --workload <cell> --seconds <s> --seeds <n> ... \
        [--control-seeds <n> ...] [--fault <name>=<n>]

For each seed, in this one process: the cell is set up, its work runs for
`--seconds` as in a run, and every number its check reads is read for the
program's outputs; for a seed also in `--control-seeds`, besides, for the
control: the reference in the precision below the configuration's (TF32
for float32), put in the program's place at the same inputs and
parameters. `--fault` plants a fault in the program, the configuration
unchanged: `maxiter=20` stops every L-BFGS fit after 20 iterations,
`depth=3` cuts every NUTS tree at depth 3, `half=1` leaves half of the
L-BFGS batch out (the second half's losses replaced by the mean of the
first's), `alter=50` moves every day-ahead mean by 50/1000 of the target's
std. One JSON line per seed, then the largest
program reading and the smallest control reading of each number, beside
the cell's limits. The benchmark's runs do not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plant(name, n):
    """Plant the fault `name` with the bound n in the program."""
    n = int(n)
    if name == "maxiter":
        from portfoliooptgp_tpu_torch.train import batched_lbfgs as mod

        fit = mod.fit_matrix
        mod.fit_matrix = lambda *a, **kw: fit(
            *a, **dict(kw, maxiter=min(kw.get("maxiter", 100), n)))
    elif name == "depth":
        from portfoliooptgp_tpu_torch.inference import nuts as mod

        step = mod.nuts_step
        mod.nuts_step = lambda vg, q, logp, key, eps, inv_mass, _, **kw: step(
            vg, q, logp, key, eps, inv_mass, n, **kw)
    elif name == "half":
        import torch

        from portfoliooptgp_tpu_torch.train import batched_lbfgs as mod

        fit = mod.fit_matrix

        def half_fit(loss, Z0, **kw):
            def half(Z):
                f = loss(Z)
                h = f.shape[0] // 2
                return torch.cat([f[:h], f[:h].mean().expand(f.shape[0] - h)])
            return fit(half, Z0, **kw)

        mod.fit_matrix = half_fit
    elif name == "alter":
        from portfoliooptgp_tpu_torch.pipelines import walk_forward as mod

        predict = mod.masked_predict_next

        def altered(*args):
            mean, var = predict(*args)
            return mean + n * 1e-3, var

        mod.masked_predict_next = altered
    else:
        raise SystemExit(f"unknown fault {name!r}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=())
    p.add_argument("--fault", default=None, metavar="NAME=N")
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from gpbench import harness
    from gpbench.reference import gp as ref

    if not torch.cuda.is_available():
        print("gpbench.control: needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.load_spec(ROOT, args.workload, False)
    if args.fault:
        plant(*args.fault.split("="))
    kind = harness.kind_module(spec)
    program, control = {}, {}
    for seed in args.seeds:
        cell = kind.Cell(spec.config, spec.traffic, seed % (1 << 63), "cuda:0")
        _, units, steps, _, _ = harness.measure(cell, "cuda:0", args.seconds, False)
        cell.release()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        line = {"seed": seed, "units": units, "steps": steps,
                "program": harness.all_readings(cell)}
        line["check_s"] = time.perf_counter() - t0
        if seed in args.control_seeds:
            line["control"] = harness.all_readings(cell, ref.TF32)
            # where the control's systems do not all factor, its readings
            # of those that do
            line["control_factored"] = harness.all_readings(cell, ref.TF32, nan=0.0)
        print(json.dumps(line), flush=True)
        for name, v in line["program"].items():
            program[name] = max(program.get(name, 0.0), v)
        for name, v in line.get("control_factored", {}).items():
            control[name] = min(control.get(name, float("inf")), v)
        del cell
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                      "fault": args.fault, "lower": program, "upper_control_factored": control,
                      "limits": spec.limits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
