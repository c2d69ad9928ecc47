"""Run one cell of the benchmark of `portfoliooptgp_tpu_torch` on one card.

    python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is set up (inputs from the seed, the
program's kernels built or loaded from `build/kernels/` inside the checkout,
the cell's shapes warmed), its work runs back to back for `--seconds`, and
the outputs of the window are checked against the plain reference. The
last line of standard output is the result as one JSON object; the checks,
each number beside its limit, are the last lines of standard error. With
`--trace 1` the window runs under `torch.profiler` and the result holds
the per-layer metrics instead of the end-to-end ones.

A machine without a CUDA card, or a process that has loaded JAX or the JAX
package, gets no result and a non-zero exit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one process, few threads: the program's host side is one Python thread
# that launches work on the card; idle CPU thread pools only add jitter on
# a host shared with others
os.environ.setdefault("OMP_NUM_THREADS", "1")


def _card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"(nvidia-smi failed: {e})"
    return out.stdout.strip() or f"(nvidia-smi: {out.stderr.strip()[:200]})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if args.workload not in cells:
        print(f"gpbench: unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from gpbench import harness

    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda:0", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"gpbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    print(f"gpbench: card {_card_line()}; roofline and mfu shares are against the data "
          "sheet's fp32 peak at 700 W", flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        if not math.isfinite(c["value"]):
            c["value"] = repr(c["value"])  # JSON has no inf or nan
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
