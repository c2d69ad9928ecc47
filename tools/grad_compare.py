"""Time the stationary NLL backward kernel of one or more checkouts on the card, in turns.

    python tools/grad_compare.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of the repository that holds the
backward kernel (`stationary_nll_grad_kernel`): `.`, or another commit
unpacked by `git archive` into a directory that .gitignore lists
(`build/parent`, say). Each ROOT runs in a process of its own, with that
checkout's `portfoliooptgp_tpu_torch` first on the path, so its
`csrc/stationary_nll.cu` is built into its own `build/kernels/`. The times
are taken by this checkout's `chip_smoke.grad_times` at every shape of
`chip_smoke.GRAD_TIMED` (the main path's, the headline's, the cluster
kernel's and the benchmark cells' (2560, 262), (128, 512) and (80, 504)):
the kernel, its plain twin and the torch closed form by CUDA-graph replay,
the kernel eager, and the bound. Name the roots in turns (parent, change,
change, parent) to compare two commits on one card. Prints one JSON line
per ROOT, then the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dense_compare import HERE, run_in_turns  # noqa: E402


def times_of(root: str) -> dict:
    """This process: put `root`'s package first on the path and time its
    backward with this checkout's chip_smoke."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # puts this checkout on the path: `root` goes before it
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    if not torch.cuda.is_available():
        raise SystemExit("grad_compare: needs a CUDA device")
    if not os.path.abspath(st.__file__).startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"grad_compare: imported {st.__file__}, not {root}'s")
    return {label: cs.grad_times(st, *shape) for label, shape in cs.GRAD_TIMED.items()}


if __name__ == "__main__":
    sys.exit(run_in_turns(__file__, times_of, sys.argv[1:]))
