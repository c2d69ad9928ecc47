"""Time the dense NLL kernel of one or more checkouts on the card, in turns.

    python tools/dense_compare.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of the repository: `.`, or another
commit unpacked by `git archive` into a directory that .gitignore lists
(`build/parent`, say). Each ROOT runs in a process of its own, with that
checkout's `portfoliooptgp_tpu_torch` first on the path, so its
`csrc/dense_nll.cu` is built into its own `build/kernels/`. The times are
taken by this checkout's `chip_smoke.dense_times` at
`chip_smoke.DENSE_TIMED`: both variants of the kernel, the plain version and
the torch.linalg chain by CUDA-graph replay, the kernel and the chain eager,
and the bound. Name the roots in turns (parent, change, change, parent) to
compare two commits on one card. Prints one JSON line per ROOT, then the
card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def times_of(root: str) -> dict:
    """This process: put `root`'s package first on the path and time its
    kernel with this checkout's chip_smoke."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # puts this checkout on the path: `root` goes before it
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from portfoliooptgp_tpu_torch.ops import nll

    if not torch.cuda.is_available():
        raise SystemExit("dense_compare: needs a CUDA device")
    if not os.path.abspath(nll.__file__).startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"dense_compare: imported {nll.__file__}, not {root}'s")
    return {f"{B}x{N}": cs.dense_times(nll, B, N) for B, N in cs.DENSE_TIMED}


def run_in_turns(script: str, times_of, argv) -> int:
    """The command line of this tool and of tools/stationary_compare.py:
    `--one ROOT` times one checkout in this process (times_of(ROOT)); a
    list of roots runs `script --one ROOT` for each in a process of its own,
    in the order given, and prints one JSON line per root and then the
    card's name and power limit."""
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(times_of(argv[1])), flush=True)
        return 0
    if not argv:
        print(sys.modules["__main__"].__doc__, file=sys.stderr)
        return 2
    for root in argv:
        out = subprocess.run([sys.executable, os.path.abspath(script), "--one", root],
                             capture_output=True, text=True, cwd=HERE)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        times = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": root, "times": times}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run_in_turns(__file__, times_of, sys.argv[1:]))
