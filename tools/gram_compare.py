"""Time the SVGP gram kernels of one or more checkouts on the card, in turns.

    python tools/gram_compare.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of the repository: `.`, or another
commit unpacked by `git archive` into a directory that .gitignore lists
(`build/parent`, say). Each ROOT runs in a process of its own, with that
checkout's `portfoliooptgp_tpu_torch` first on the path, so its
`csrc/svgp_gram.cu` is built into its own `build/kernels/`. The times are
taken by this checkout's `chip_smoke.gram_times` at every shape of
`chip_smoke.GRAM_TIMED` (the SVGP path's (M, B, D) = (128, 2048, 1) and the
TPU kernel's largest batch, (128, 8192, 1)): both kernels by CUDA-graph
replay (one call and 16 calls a replay) and eager, their plain versions
and the PyTorch chain by graph replay, and the bounds. Name the roots in
turns (parent, change, change, parent) to compare two commits on one card.
Prints one JSON line per ROOT, then the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dense_compare import HERE, run_in_turns  # noqa: E402


def times_of(root: str) -> dict:
    """This process: put `root`'s package first on the path and time its
    gram kernels with this checkout's chip_smoke."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # puts this checkout on the path: `root` goes before it
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from portfoliooptgp_tpu_torch.ops import svgp_gram as sg

    if not torch.cuda.is_available():
        raise SystemExit("gram_compare: needs a CUDA device")
    if not os.path.abspath(sg.__file__).startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"gram_compare: imported {sg.__file__}, not {root}'s")
    return {f"{M}x{B}x{D}": cs.gram_times(sg, M, B, D) for M, B, D in cs.GRAM_TIMED}


if __name__ == "__main__":
    sys.exit(run_in_turns(__file__, times_of, sys.argv[1:]))
